"""The port's urban stack against the JAX package on the CPU, in float64.

The same numpy inputs, made from seeds, go through the JAX functions (one
scene at a time, batched with jax.vmap where JAX batches) and the port's
batch-first functions. Exact: the lane build, the Frenet maps, lane
association, route choice, MPDM's behaviour, reference lane and validity,
collision and raster booleans. To 1e-9 relative: forward-simulation
rollouts over the full 10-step horizon, MPDM's scores and trajectories,
MOBIL's probabilities, the arena's burst. Also: the lane-net conversion
`lane_set_from_numpy`, the device default (the card, which raises here),
and 5 ticks of the port's urban demo beside JAX's tick functions
(examples/urban_demo.py's plan_tick / agent_tick), states to 1e-8.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dftpav_tpu.sim import arena as jarena
from dftpav_tpu.ssc import bezier_eval as jbezier_eval, ssc_plan as jssc_plan
from dftpav_tpu.ssc.planner import SSCConfig as JSSCConfig
from dftpav_tpu.urban import forward_sim as jfsim
from dftpav_tpu.urban import geometry as jgeometry
from dftpav_tpu.urban import idm as jidm
from dftpav_tpu.urban import lane as jlane
from dftpav_tpu.urban import mobil as jmobil
from dftpav_tpu.urban import mpdm as jmpdm
from dftpav_tpu.urban import rss as jrss
from dftpav_tpu.urban import semantic_map as jsm
from dftpav_tpu.urban import steer as jsteer
from dftpav_tpu.urban.route import LaneGraph as JLaneGraph
from dftpav_tpu.urban.route import RoutePlanner as JRoutePlanner

from dftpav_tpu_torch.sim import arena
from dftpav_tpu_torch.urban import forward_sim as fsim
from dftpav_tpu_torch.urban import geometry, idm, lane as lane_mod, mobil
from dftpav_tpu_torch.urban import mpdm, rss, semantic_map as sm, steer
from dftpav_tpu_torch.urban.route import LaneGraph, RoutePlanner

torch.set_num_threads(1)
F64 = torch.float64
REL = 1e-9


def t64(a):
    return torch.from_numpy(np.array(np.asarray(a), np.float64))


def close(ours, theirs, rel=REL):
    ours = ours.numpy() if torch.is_tensor(ours) else np.asarray(ours)
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape, (ours.shape, theirs.shape)
    np.testing.assert_allclose(ours, theirs, rtol=rel,
                               atol=rel * max(1.0, np.abs(theirs).max()))


def same(ours, theirs):
    ours = ours.numpy() if torch.is_tensor(ours) else np.asarray(ours)
    np.testing.assert_array_equal(ours, np.asarray(theirs))


def to_set(jls):
    """The port's LaneSet from a JAX LaneSet, through lane_set_from_numpy."""
    return lane_mod.lane_set_from_numpy(
        [np.asarray(f) for f in jls.lanes], np.asarray(jls.left_id),
        np.asarray(jls.right_id), device="cpu", dtype=F64)


def to_lane(jl):
    return lane_mod.lane_set_from_numpy(
        [np.asarray(f)[None] for f in jl], [-1], [-1], device="cpu",
        dtype=F64).lane(0)


# waypoint sets: name -> (waypoints, ds, P, closed)
_TH = np.linspace(0.0, 1.2, 9)
_RING = np.linspace(0.0, 2 * np.pi, 61)
WAYPOINTS = {
    "straight": (np.stack([np.linspace(0, 200, 21), np.zeros(21)], 1),
                 1.0, 256, False),
    "arc": (np.stack([40 * np.sin(_TH), 40 * (1 - np.cos(_TH))], 1),
            0.5, 128, False),
    "ring": (np.stack([20 * np.cos(_RING), 20 * np.sin(_RING)], 1),
             1.0, 160, True),
    "two_points": (np.array([[0.0, 1.0], [30.0, 4.0]]), 0.5, 64, False),
}


def highway(n_lanes=3, length=300.0, width=3.5, P=384):
    """JAX LaneSet of parallel straight lanes (examples/urban_demo.py's
    build_highway, shorter) in float64, and the port's copy."""
    lanes = [jlane.build_lane(np.stack([np.linspace(0, length, 31),
                                        i * width * np.ones(31)], 1),
                              ds=1.0, P=P, dtype=np.float64)
             for i in range(n_lanes)]
    left = [i + 1 if i + 1 < n_lanes else -1 for i in range(n_lanes)]
    right = [i - 1 if i >= 1 else -1 for i in range(n_lanes)]
    jls = jlane.build_lane_set(lanes, left, right)
    return jls, to_set(jls)


def geoms(A):
    ones = np.ones(A)
    j = jfsim.AgentGeom(*(jnp.asarray(v * ones) for v in
                          (4.88, 1.9, 1.015, 2.85)))
    p = fsim.AgentGeom(*(t64(v * ones) for v in (4.88, 1.9, 1.015, 2.85)))
    return j, p


def scenes(B, A=6, seed=0, n_lanes=3, width=3.5):
    """[B, A, 6] traffic: the ego near the start of a lane, others ahead
    near lane centers (0.3-0.9 m off, never mid-lane)."""
    rng = np.random.default_rng(seed)
    st = np.zeros((B, A, 6))
    lane = rng.integers(0, n_lanes, (B, A))
    st[:, 0, 0] = rng.uniform(0, 10, B)
    st[:, 1:, 0] = rng.uniform(15, 90, (B, A - 1))
    off = rng.uniform(0.3, 0.9, (B, A)) * rng.choice([-1, 1], (B, A))
    st[..., 1] = lane * width + off
    st[..., 2] = rng.uniform(-0.05, 0.05, (B, A))
    st[..., 3] = rng.uniform(1.0, 8.0, (B, A))
    st[..., 4] = rng.uniform(-0.02, 0.02, (B, A))
    return st, lane


@pytest.mark.parametrize("name", list(WAYPOINTS))
def test_build_lane_matches_jax(name):
    wps, ds, P, closed = WAYPOINTS[name]
    ours = lane_mod.build_lane(wps, ds=ds, P=P, closed=closed, dtype=F64,
                               device="cpu")
    theirs = jlane.build_lane(wps, ds=ds, P=P, closed=closed,
                              dtype=np.float64)
    for a, b in zip(ours, theirs):
        same(a, b)
    same(ours.length, theirs.length)


def test_lane_set_from_numpy_and_device_default():
    jls, ls = highway()
    for a, b in zip(ls.lanes, jls.lanes):
        same(a, b)
    same(ls.left_id, jls.left_id)
    same(ls.right_id, jls.right_id)
    assert ls.lanes.n_valid.dtype == torch.int64
    assert ls.lanes.closed.dtype == torch.bool
    # the entry points default to the card: without one they raise
    wps = WAYPOINTS["straight"][0]
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            lane_mod.build_lane(wps)


@pytest.mark.parametrize("name", ["arc", "ring", "straight"])
def test_frenet_maps_match_jax(name):
    wps, ds, P, closed = WAYPOINTS[name]
    jl = jlane.build_lane(wps, ds=ds, P=P, closed=closed, dtype=np.float64)
    lane = to_lane(jl)
    rng = np.random.default_rng(1)
    idx = rng.integers(0, int(jl.n_valid), 40)
    pts = (np.asarray(jl.xy)[idx] + rng.normal(0, 1.5, (40, 2)))
    s, d = lane_mod.frenet_of_point(lane, t64(pts))
    js, jd = jlane.frenet_of_point(jl, jnp.asarray(pts))
    same(s, js)
    same(d, jd)
    ang = rng.uniform(-np.pi, np.pi, 40)
    vel = rng.uniform(0, 10, 40)
    fs = lane_mod.frenet_of_state(lane, t64(pts), t64(ang), t64(vel))
    jfs = jlane.frenet_of_state(jl, jnp.asarray(pts), jnp.asarray(ang),
                                jnp.asarray(vel))
    same(fs.s, jfs.s)
    same(fs.d, jfs.d)
    # the heading terms go through atan2 / cos / tan, whose last bits differ
    # between XLA and libm (measured: at most 3.6e-15 absolute)
    close(fs.s_dot, jfs.s_dot, 1e-14)
    close(fs.d_prime, jfs.d_prime, 1e-14)
    q = rng.uniform(-30, float(jl.length) + 30, 40)
    dq = rng.uniform(-3, 3, 40)
    pos, hd = lane_mod.state_of_frenet(lane, t64(q), t64(dq))
    jpos, jhd = jlane.state_of_frenet(jl, jnp.asarray(q), jnp.asarray(dq))
    same(pos, jpos)
    close(hd, jhd, 1e-15)
    xy, tan, kappa = lane_mod.lane_point(lane, t64(q))
    jxy, jtan, jkappa = jlane.lane_point(jl, jnp.asarray(q))
    same(xy, jxy)
    same(kappa, jkappa)
    close(tan, jtan, 1e-15)


def test_elementwise_models_match_jax():
    """idm, steer, geometry and rss on seeded random inputs."""
    rng = np.random.default_rng(2)
    n = 64
    s, v = rng.uniform(0, 50, n), rng.uniform(0, 12, n)
    sf, vf = s + rng.uniform(3, 60, n), rng.uniform(0, 12, n)
    jp = jidm.IDMParam(desired_velocity=jnp.asarray(rng.uniform(2, 10, n)))
    p = idm.IDMParam(desired_velocity=t64(jp.desired_velocity))
    for name in ("idm_acc", "iidm_acc", "acc_acc"):
        close(getattr(idm, name)(p, t64(s), t64(v), t64(sf), t64(vf)),
              getattr(jidm, name)(jp, *map(jnp.asarray, (s, v, sf, vf))))
    close(idm.idm_velocity(p, t64(s), t64(sf), t64(v), t64(vf), 0.4),
          jidm.idm_velocity(jp, *map(jnp.asarray, (s, sf, v, vf)), 0.4))
    close(idm.ctx_idm_velocity(p, t64(s), t64(v), t64(sf), t64(vf),
                               t64(sf - 10), t64(vf), 0.4),
          jidm.ctx_idm_velocity(jp, *map(jnp.asarray, (s, v, sf, vf,
                                                        sf - 10, vf)), 0.4))

    st = np.stack([rng.uniform(-5, 5, n), rng.uniform(-5, 5, n),
                   rng.uniform(-3, 3, n), rng.uniform(0, 10, n),
                   rng.uniform(-0.5, 0.5, n), rng.uniform(-2, 2, n)], -1)
    cs, cv = rng.uniform(-1, 1, n), rng.uniform(0, 12, n)
    for a, b in zip(
            steer.ideal_steer_step(t64(st), t64(cs), t64(cv), 2.85,
                                   steer.SteerLimits(), 0.4),
            jsteer.ideal_steer_step(jnp.asarray(st), jnp.asarray(cs),
                                    jnp.asarray(cv), 2.85,
                                    jsteer.SteerLimits(), 0.4)):
        close(a, b)

    other = st + np.concatenate([rng.normal(0, 3, (n, 3)),
                                 np.zeros((n, 3))], -1)
    pa = (4.88, 1.9, 1.015)
    for infl in (0.0, 0.5):
        hit = geometry.vehicles_collide(t64(st), t64(other), pa, pa, infl)
        same(hit, jgeometry.vehicles_collide(jnp.asarray(st),
                                             jnp.asarray(other), pa, pa,
                                             infl))
        assert 0 < int(hit.sum()) < n

    args = [rng.uniform(-20, 20, n), rng.uniform(-4, 4, n),
            rng.uniform(-2, 10, n), rng.uniform(-1, 1, n),
            rng.uniform(-20, 20, n), rng.uniform(-4, 4, n),
            rng.uniform(-2, 10, n), rng.uniform(-1, 1, n)]
    same(rss.rss_safe(*map(t64, args)),
         jrss.rss_safe(*map(jnp.asarray, args)))
    geo = (4.88, 1.9, 1.015, 4.5, 1.8, 1.0)
    ours = rss.rss_check_typed(*map(t64, args), *geo)
    theirs = jrss.rss_check_typed(*map(jnp.asarray, args), *geo)
    same(ours[0], theirs[0])
    same(ours[1], theirs[1])
    close(ours[2], theirs[2])
    close(ours[3], theirs[3])


def test_forward_sim_rollout_matches_jax():
    """Closed- and open-loop rollouts over the full 10-step horizon."""
    jls, ls = highway()
    st, lane_ids = scenes(4, seed=3)
    jg, g = geoms(6)
    p, jp = fsim.SimParam(), jfsim.SimParam()
    desired = st[..., 3] + 1.0
    theirs = jax.jit(jax.vmap(lambda s, ids, dv: jfsim.rollout(
        jax.tree.map(lambda f: f[ids], jls.lanes), s, jg, dv, jp, 0.4, 10)))(
        jnp.asarray(st), jnp.asarray(lane_ids), jnp.asarray(desired))
    jol = jax.jit(jax.vmap(lambda s, ids: jsm.openloop_prediction(
        jls, s, ids, jg, jp, 0.4, 10)))(jnp.asarray(st), jnp.asarray(lane_ids))
    for b in range(4):
        ours = fsim.rollout(mpdm._gather_lane(ls, torch.from_numpy(
            lane_ids[b])), t64(st[b]), g, t64(desired[b]), p, 0.4, 10)
        close(ours, theirs[b])
        ol = sm.openloop_prediction(ls, t64(st[b]),
                                    torch.from_numpy(lane_ids[b]), g, p,
                                    0.4, 10)
        close(ol, jol[b])
    # batched over scenes in one call: the same as one by one
    lanes = mpdm._gather_lane(ls, torch.from_numpy(lane_ids))
    desired = t64(st[..., 3] + 1.0)
    batched = fsim.rollout(lanes, t64(st), g, desired, p, 0.4, 10)
    for b in range(4):
        close(batched[b], fsim.rollout(mpdm._gather_lane(
            ls, torch.from_numpy(lane_ids[b])), t64(st[b]), g, desired[b],
            p, 0.4, 10), 1e-15)


def _jax_mpdm(jls, jg, cfg):
    return jax.jit(jax.vmap(lambda st, ids: jmpdm.mpdm_plan(
        jls, st, ids, jg, 0, jfsim.SimParam(), cfg)))


def test_mpdm_plan_matches_jax():
    """Behaviour, reference lane and validity exact; scores, desired
    velocity and trajectories to 1e-9, on tests/test_urban.py's overtaking
    scene and seeded highway scenes, batched in one call each side."""
    jls, ls = highway()
    st, lane_ids = scenes(10, seed=4)
    # tests/test_urban.py's slow leader (lane change left) at A = 6: the
    # other agents far ahead on the ego lane's left
    st[0] = 0.0
    st[0, :, 0] = [0.0, 25.0, 200, 210, 220, 230]
    st[0, :, 1] = [0.0, 0.0, 7.0, 7.0, 7.0, 7.0]
    st[0, :, 3] = [5.0, 1.0, 3, 3, 3, 3]
    lane_ids[0] = [0, 0, 2, 2, 2, 2]
    jg, g = geoms(6)
    cfg = mpdm.MPDMConfig(desired_velocity=8.0)
    jres = _jax_mpdm(jls, jg, jmpdm.MPDMConfig(desired_velocity=8.0))(
        jnp.asarray(st), jnp.asarray(lane_ids, jnp.int32))
    res = mpdm.mpdm_plan(ls, t64(st), torch.from_numpy(lane_ids), g, 0,
                         fsim.SimParam(), cfg)
    same(res.behavior, jres.behavior)
    same(res.ref_lane_id, jres.ref_lane_id)
    same(res.valid, jres.valid)
    close(res.scores, jres.scores)
    close(res.desired_vel, jres.desired_vel)
    close(res.trajs, jres.trajs)
    assert int(res.behavior[0]) == mpdm.LCL
    assert len(set(res.behavior.tolist())) >= 2
    assert not bool(res.valid.all())


def test_mobil_and_semantic_map_match_jax():
    """associate_lanes and nearest_lane exact; MOBIL probabilities and
    gains to 1e-9; rasterizers and the fake mapper exact."""
    jls, ls = highway()
    st, _ = scenes(6, seed=5)
    st[0, 1, 2] = np.pi / 2          # heading gate: no lane for this one
    st[1, 2, 1] = 30.0               # too far from every lane
    jg, g = geoms(6)
    ids = sm.associate_lanes(ls, t64(st))
    jids = jax.jit(jax.vmap(lambda s: jsm.associate_lanes(jls, s)))(
        jnp.asarray(st))
    same(ids, jids)
    assert int(ids[0, 1]) == -1 and int(ids[1, 2]) == -1
    ids = torch.clamp(ids, min=0)
    probs = mobil.predict_all(ls, t64(st), ids, g)
    jprobs = jax.jit(jax.vmap(lambda s, i: jmobil.predict_all(
        jls, s, i, jg)))(jnp.asarray(st), jnp.asarray(ids.numpy(), jnp.int32))
    close(probs, jprobs)
    beh, _ = sm.predict_behaviors(ls, t64(st), ids, g)
    same(beh, np.argmax(np.asarray(jprobs), -1))
    r = mobil.mobil_predict(ls, t64(st[2]), ids[2], g, 3)
    jr = jax.jit(lambda s, i: jmobil.mobil_predict(jls, s, i, jg, 3))(
        jnp.asarray(st[2]), jnp.asarray(ids[2].numpy(), jnp.int32))
    for a, b in zip(r, jr):
        close(a, b) if a.is_floating_point() else same(a, b)

    spec = sm.GridSpec(origin=t64([0.0, -8.0]), resolution=0.5, height=48,
                       width=64)
    jspec = jsm.GridSpec(origin=jnp.asarray([0.0, -8.0]), resolution=0.5,
                         height=48, width=64)
    cen = np.array([[10.0, 0.0], [20.0, 3.0], [28.0, -2.0]])
    rad, mask = np.array([1.5, 2.0, 1.0]), np.array([True, True, False])
    grid = sm.rasterize_circles(spec, t64(cen), t64(rad),
                                torch.from_numpy(mask))
    same(grid, jsm.rasterize_circles(jspec, jnp.asarray(cen),
                                     jnp.asarray(rad), jnp.asarray(mask)))
    obb = sm.rasterize_obbs(spec, t64(st[0]), g.length, g.width, g.d_cr,
                            torch.ones(6, dtype=torch.bool))
    same(obb, jsm.rasterize_obbs(jspec, jnp.asarray(st[0]), jg.length,
                                 jg.width, jg.d_cr, jnp.ones(6, bool)))
    ego = np.array([2.0, 0.5])
    seen = sm.fake_mapper(spec, grid | obb, t64(ego), n_samples=32)
    jmap = jax.jit(lambda g_, e, sp, th: jsm.fake_mapper(
        jspec, g_, e, seen_prev=sp, dist_thres=th, n_samples=32))
    jseen = jax.jit(lambda g_, e: jsm.fake_mapper(jspec, g_, e, n_samples=32))(
        jnp.asarray(np.asarray(grid | obb)), jnp.asarray(ego))
    same(seen, jseen)
    same(sm.fake_mapper(spec, grid, t64(ego + 5), seen_prev=seen,
                        dist_thres=12.0, n_samples=32),
         jmap(jnp.asarray(np.asarray(grid)), jnp.asarray(ego + 5), jseen,
              12.0))
    assert 0 < int(seen.sum()) < int((grid | obb).sum())


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_route_matches_jax(seed):
    succ = [[1, 4], [2, 3], [0], [], [2, 0]]
    lengths = [50.0, 50.0, 50.0, 80.0, 40.0]
    ours = RoutePlanner(LaneGraph(succ, lengths), max_length=180.0,
                        seed=seed)
    theirs = JRoutePlanner(JLaneGraph(succ, lengths), max_length=180.0,
                           seed=seed)
    for lane, s, target in ((0, 0.0, None), (1, 10.0, None),
                            (2, 49.0, None), (4, 0.0, 3), (0, 0.0, 3)):
        assert ours.run_once(lane, s, target) == \
            theirs.run_once(lane, s, target)
        assert ours.status == theirs.status


def test_arena_burst_matches_jax():
    rng = np.random.default_rng(6)
    s0 = np.stack([rng.uniform(-10, 10, 5), rng.uniform(-10, 10, 5),
                   rng.uniform(-3, 3, 5), rng.uniform(-0.3, 0.3, 5),
                   rng.uniform(0, 8, 5)], -1)
    sr, acc = rng.uniform(-0.2, 0.2, 5), rng.uniform(-2, 2, 5)
    ol = np.array([False, False, True, False, False])
    tgt = rng.normal(size=(5, 5))
    wb = np.full(5, 2.85)
    ours = arena.run_burst(t64(s0), arena.ArenaControl(
        t64(sr), t64(acc), torch.from_numpy(ol), t64(tgt)), t64(wb), 0.002,
        500)
    theirs = jarena.run_burst(jnp.asarray(s0), jarena.ArenaControl(
        jnp.asarray(sr), jnp.asarray(acc), jnp.asarray(ol),
        jnp.asarray(tgt)), jnp.asarray(wb), 0.002, 500)
    close(ours, theirs)
    s6 = arena.to_agent_states(ours, t64(acc))
    close(s6, jarena.to_agent_states(theirs, jnp.asarray(acc)))
    close(arena.from_agent_states(s6), jarena.from_agent_states(
        jnp.asarray(s6.numpy())))


def test_demo_five_ticks_match_jax():
    """5 ticks of examples/urban_demo_torch.py's loop (float64, CPU) beside
    JAX's tick functions (examples/urban_demo.py's plan_tick, agent_tick
    and ego update, written out here in float64): behaviours, validity and
    SSC feasibility equal, states to 1e-8."""
    from examples import urban_demo_torch as demo

    w = demo.setup(seed=0, agents=5, device="cpu", dtype=F64)
    jls = jlane.build_lane_set(
        [jlane.build_lane(np.stack([np.linspace(0, 600.0, 31),
                                    i * 3.5 * np.ones(31)], 1),
                          ds=1.0, P=1024, dtype=np.float64)
         for i in range(3)], [1, 2, -1], [-1, 0, 1])
    for a, b in zip(w.lane_set.lanes, jls.lanes):
        same(a, b)
    A = w.states.shape[0]
    jg, _ = geoms(A)
    jp = jfsim.SimParam()
    jcfg = jmpdm.MPDMConfig(desired_velocity=8.0)
    times = np.linspace(0.0, jcfg.sim_horizon, jcfg.n_steps + 1)

    @jax.jit
    def plan_tick(states):
        lane_ids = jnp.maximum(jsm.associate_lanes(jls, states), 0)
        dec = jmpdm.mpdm_plan(jls, states, lane_ids, jg, 0, jp, jcfg)
        ego_traj = dec.trajs[dec.behavior]
        ref_lane = jmpdm._gather_lane(jls, jnp.maximum(dec.ref_lane_id, 0))
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
        return (jnp.concatenate([ego_next[None], agents[1:]]), dec.behavior,
                dec.valid, res.feasible, res.qp.n_iters)

    states = w.states
    jstates = jnp.asarray(states.numpy())
    for tick in range(5):
        out = demo.tick(w, states)
        jnext, jbeh, jvalid, jfeas, jiters = plan_tick(jstates)
        assert int(out.dec.behavior) == int(jbeh), tick
        same(out.dec.valid, jvalid)
        assert bool(out.ssc.feasible) == bool(jfeas), tick
        same(out.ssc.qp.n_iters, jiters)
        close(out.states, jnext, 1e-8)
        states, jstates = out.states, jnext
