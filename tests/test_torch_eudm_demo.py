"""Three ticks of the port's urban demo with --behavior eudm (float64, CPU)
beside JAX's tick functions in EUDM mode (examples/urban_demo.py's
plan_tick with use_eudm, agent_tick and the ego update, written out here
in float64): EUDM's decision in MPDM's form (behaviour 0, the best policy's
trajectory, the reference lane of EUDM's behaviour), validity, SSC
feasibility and iterations equal, states to 1e-8; the logged behaviour
stays 0, so the demo counts no lane change."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from dftpav_tpu.ssc import bezier_eval as jbezier_eval, ssc_plan as jssc_plan
from dftpav_tpu.ssc.planner import SSCConfig as JSSCConfig
from dftpav_tpu.urban import eudm as jeudm
from dftpav_tpu.urban import forward_sim as jfsim
from dftpav_tpu.urban import lane as jlane
from dftpav_tpu.urban import mpdm as jmpdm
from dftpav_tpu.urban import semantic_map as jsm

torch.set_num_threads(1)
F64 = torch.float64


def test_demo_eudm_three_ticks_match_jax():
    from examples import urban_demo_torch as demo

    w = demo.setup(seed=0, agents=5, device="cpu", dtype=F64,
                   behavior="eudm")
    jls = jlane.build_lane_set(
        [jlane.build_lane(np.stack([np.linspace(0, 600.0, 31),
                                    i * 3.5 * np.ones(31)], 1),
                          ds=1.0, P=1024, dtype=np.float64)
         for i in range(3)], [1, 2, -1], [-1, 0, 1])
    A = w.states.shape[0]
    ones = jnp.ones(A)
    jg = jfsim.AgentGeom(length=4.88 * ones, width=1.9 * ones,
                         d_cr=1.015 * ones, wheel_base=2.85 * ones)
    jp = jfsim.SimParam()
    jcfg = jeudm.EUDMConfig(desired_velocity=8.0, step=0.4, tree_height=5,
                            layer_time=0.8)
    assert tuple(w.cfg_eudm) == tuple(jcfg)
    times = np.linspace(0.0, 4.0, 11)

    @jax.jit
    def plan_tick(states):
        lane_ids = jnp.maximum(jsm.associate_lanes(jls, states), 0)
        eres = jeudm.eudm_plan(jls, states, lane_ids, jg, 0, jp, jcfg)
        lanes3 = jmpdm.behavior_lane_ids(jls, lane_ids[0])
        ego_traj = eres.trajs[eres.best_policy]
        ref_id = lanes3[eres.behavior]
        ref_lane = jmpdm._gather_lane(jls, jnp.maximum(ref_id, 0))
        res = jssc_plan(ref_lane, states[0], ego_traj[:, 0], times,
                        jnp.moveaxis(ego_traj[:, 1:], 0, 1),
                        jnp.ones(A - 1, bool), jg.length[1:] / 2,
                        jg.width[1:] / 2, JSSCConfig(M=5),
                        dtype=jnp.float64)
        pos_sd, vel_sd, _ = jbezier_eval(res.spline, jnp.asarray([0.4]))
        pos_w, heading_w = jlane.state_of_frenet(ref_lane, pos_sd[0, 0:1],
                                                 pos_sd[0, 1:2])
        ego_next = jnp.where(
            res.feasible,
            jnp.concatenate([pos_w[0], heading_w[0:1],
                             jnp.linalg.norm(vel_sd[0])[None],
                             states[0, 4:6]]),
            ego_traj[1, 0])
        lanes = jmpdm._gather_lane(jls, lane_ids)
        agents = jfsim.multi_agent_step(lanes, states, jg,
                                        jnp.clip(states[:, 3], 2.0, 8.0),
                                        jp, 0.4)
        return (jnp.concatenate([ego_next[None], agents[1:]]), ref_id,
                eres.valid[:3], res.feasible, res.qp.n_iters)

    states = w.states
    jstates = jnp.asarray(states.numpy())
    for tick in range(3):
        out = demo.tick(w, states)
        jnext, jref, jvalid, jfeas, jiters = plan_tick(jstates)
        assert int(out.dec.behavior) == 0, tick
        assert int(out.dec.ref_lane_id) == int(jref), tick
        np.testing.assert_array_equal(out.dec.valid.numpy(),
                                      np.asarray(jvalid))
        assert bool(out.ssc.feasible) == bool(jfeas), tick
        np.testing.assert_array_equal(out.ssc.qp.n_iters.numpy(),
                                      np.asarray(jiters))
        np.testing.assert_allclose(out.states.numpy(), np.asarray(jnext),
                                   rtol=1e-8, atol=1e-8)
        states, jstates = out.states, jnext
