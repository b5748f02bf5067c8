"""The port's EUDM planner against the JAX package on the CPU, in float64.

The same numpy inputs go through `dftpav_tpu.urban.eudm` (jitted, batched
with jax.vmap) and `dftpav_tpu_torch.urban.eudm` (batch-first). Exact: the
DCP action scripts, best policy, behaviour, validity, riskiness and the
pattern of infinite scores. To 1e-9 relative: finite scores, the RSS
ladder's per-layer costs, the longitudinal commands; trajectories to 1e-9
absolute; the desired velocity to 1e-12 relative. Cases: tests/
test_urban.py's two-lane scenes, seeded scenes on the demo's highway at the
demo's configuration and at the reference default, a non-LK root, and CFB
with one and two uncertain agents (a one-hot lane-keep belief reproduces
eudm_plan). Agents sit 0.3-0.9 m off lane centres: nearest-lane ties at a
midline can flip between XLA and PyTorch. The demo's EUDM ticks are in
tests/test_torch_eudm_demo.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dftpav_tpu.urban import eudm as jeudm
from dftpav_tpu.urban import forward_sim as jfsim
from dftpav_tpu.urban import lane as jlane

from dftpav_tpu_torch.urban import eudm, forward_sim as fsim
from dftpav_tpu_torch.urban import lane as lane_mod

torch.set_num_threads(1)
F64 = torch.float64
REL = 1e-9

# the demo's configuration and the reference default (eudm.py:69-71)
CFG_DEMO = dict(desired_velocity=8.0, step=0.4, tree_height=5,
                layer_time=0.8)
CFG_REF = dict(desired_velocity=8.0)


def t64(a):
    return torch.from_numpy(np.array(np.asarray(a), np.float64))


def same(ours, theirs):
    ours = ours.numpy() if torch.is_tensor(ours) else np.asarray(ours)
    np.testing.assert_array_equal(ours, np.asarray(theirs))


def close(ours, theirs, rel=REL, atol=None):
    ours = ours.numpy() if torch.is_tensor(ours) else np.asarray(ours)
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape, (ours.shape, theirs.shape)
    if atol is None:
        atol = rel * max(1.0, np.abs(theirs).max())
    np.testing.assert_allclose(ours, theirs, rtol=rel, atol=atol)


def to_set(jls):
    return lane_mod.lane_set_from_numpy(
        [np.asarray(f) for f in jls.lanes], np.asarray(jls.left_id),
        np.asarray(jls.right_id), device="cpu", dtype=F64)


def geoms(A):
    ones = np.ones(A)
    j = jfsim.AgentGeom(*(jnp.asarray(v * ones) for v in
                          (4.88, 1.9, 1.015, 2.85)))
    p = fsim.AgentGeom(*(t64(v * ones) for v in (4.88, 1.9, 1.015, 2.85)))
    return j, p


def two_lane():
    def lane(y):
        return jlane.build_lane(np.stack([np.linspace(0, 200, 21),
                                          y * np.ones(21)], 1),
                                ds=1.0, P=256, dtype=np.float64)
    jls = jlane.build_lane_set([lane(0.0), lane(3.5)], [1, -1], [-1, 0])
    return jls, to_set(jls)


def demo_highway():
    """examples/urban_demo.py's highway (3 lanes, 600 m, P = 1024) in
    float64, and the port demo's own build of it."""
    from examples import urban_demo_torch as demo

    jls = jlane.build_lane_set(
        [jlane.build_lane(np.stack([np.linspace(0, 600.0, 31),
                                    i * 3.5 * np.ones(31)], 1),
                          ds=1.0, P=1024, dtype=np.float64)
         for i in range(3)], [1, 2, -1], [-1, 0, 1])
    ls = demo.build_highway(device="cpu", dtype=F64)
    for a, b in zip(ls.lanes, jls.lanes):
        same(a, b)
    return jls, ls


def highway_scenes(B, seed, A=6, width=3.5):
    """[B, A, 6] scenes: the ego near the start of a lane, traffic ahead
    0.3-0.9 m off lane centres, and in most scenes a slow car 12-35 m
    ahead on the ego's lane."""
    rng = np.random.default_rng(seed)
    st = np.zeros((B, A, 6))
    lane = rng.integers(0, 3, (B, A))
    st[:, 0, 0] = rng.uniform(0, 10, B)
    st[:, 1:, 0] = rng.uniform(15, 90, (B, A - 1))
    st[..., 1] = lane * width + rng.uniform(0.3, 0.9, (B, A)) \
        * rng.choice([-1, 1], (B, A))
    st[..., 2] = rng.uniform(-0.05, 0.05, (B, A))
    st[..., 3] = rng.uniform(1.0, 8.0, (B, A))
    slow = rng.uniform(size=B) < 0.75
    k = int(slow.sum())
    lane[slow, 1] = lane[slow, 0]
    st[slow, 1, 0] = st[slow, 0, 0] + rng.uniform(12, 35, k)
    st[slow, 1, 1] = lane[slow, 1] * width + rng.uniform(0.3, 0.5, k) \
        * rng.choice([-1, 1], k)
    st[slow, 1, 3] = rng.uniform(0.5, 3.0, k)
    st[:, 0, 3] = rng.uniform(4.0, 9.0, B)
    return st, lane


def check_result(res, jres):
    # jax.vmap repeats the (unbatched) script per scene
    jscript = np.asarray(jres.action_script)
    same(res.action_script, jscript.reshape((-1,) + jscript.shape[-3:])[0])
    same(res.best_policy, jres.best_policy)
    same(res.behavior, jres.behavior)
    same(res.valid, jres.valid)
    same(res.risky, jres.risky)
    js = np.asarray(jres.scores)
    same(torch.isinf(res.scores), np.isinf(js))
    fin = np.isfinite(js)
    close(res.scores.numpy()[fin], js[fin])
    close(res.trajs, jres.trajs, rel=0.0, atol=1e-9)
    close(res.desired_vel, jres.desired_vel, rel=1e-12)


def _jax_plan(jls, jg, jcfg):
    """jax.vmap(eudm_plan) over scenes, the action script a traced
    argument (one compile serves every root)."""
    return jax.jit(jax.vmap(
        lambda st, ids, script: jeudm.eudm_plan(
            jls, st, ids, jg, 0, jfsim.SimParam(), jcfg, script=script),
        in_axes=(0, 0, None)))


@pytest.fixture(scope="module")
def two_lane_setup():
    """The two-lane net, geometry, and JAX's planner at desired velocity
    8 over 3 scenes (one compile for every root)."""
    jls, ls = two_lane()
    jg, g = geoms(2)
    return jls, ls, jg, g, _jax_plan(jls, jg, jeudm.EUDMConfig(
        desired_velocity=8.0))


@pytest.fixture(scope="module")
def highway_setup():
    jls, ls = demo_highway()
    jg, g = geoms(6)
    return jls, ls, jg, g


@pytest.mark.parametrize("root", [0, 1, 2])
def test_dcp_action_script_matches_jax(root):
    for H in (3, 5):
        same(eudm.dcp_action_script(H, root),
             jeudm.dcp_action_script(H, root))


@pytest.mark.parametrize("unc", [(1,), (2,), (1, 2), (2, 0)])
def test_cfb_belief_combos_matches_jax(unc):
    rng = np.random.default_rng(11)
    probs = rng.uniform(0.0, 1.0, (3, 3))
    probs /= probs.sum(-1, keepdims=True)
    combos, p = eudm.cfb_belief_combos(probs, unc)
    jcombos, jp = jeudm.cfb_belief_combos(probs, unc)
    assert combos.dtype == jcombos.dtype
    np.testing.assert_array_equal(combos, jcombos)
    np.testing.assert_array_equal(p, jp)


def test_lon_desired_vel_matches_jax():
    rng = np.random.default_rng(3)
    v = rng.uniform(-1.0, 20.0, (3, 40))
    lon = np.arange(3)[:, None]
    for cfg in (CFG_DEMO, dict(desired_velocity=30.0, acc_cmd_vel_gap=4.0)):
        ours = eudm._lon_desired_vel(torch.from_numpy(lon), t64(v),
                                     eudm.EUDMConfig(**cfg))
        theirs = jeudm._lon_desired_vel(jnp.asarray(lon), jnp.asarray(v),
                                        jeudm.EUDMConfig(**cfg))
        close(ours, theirs)


# tests/test_urban.py's two-lane scenes: the slow leader (LCL), the near
# miss (the ladder reorders), the free road (LK); ego 3 cm off its centre
TWO_LANE = np.array([
    [[0.0, 0.03, 0.0, 5.0, 0.0, 0.0], [25.0, -0.04, 0.0, 1.0, 0.0, 0.0]],
    [[0.0, 0.03, 0.0, 8.0, 0.0, 0.0], [18.0, -0.04, 0.0, 2.0, 0.0, 0.0]],
    [[0.0, 0.03, 0.0, 5.0, 0.0, 0.0], [180.0, -0.04, 0.0, 5.0, 0.0, 0.0]],
])


def test_eudm_plan_two_lane_matches_jax(two_lane_setup):
    jls, ls, jg, g, jplan = two_lane_setup
    ids = np.zeros((3, 2), np.int64)
    jres = jplan(jnp.asarray(TWO_LANE), jnp.asarray(ids, jnp.int32),
                 jnp.asarray(jeudm.dcp_action_script(5)))
    res = eudm.eudm_plan(ls, t64(TWO_LANE), torch.from_numpy(ids), g, 0,
                         fsim.SimParam(),
                         eudm.EUDMConfig(desired_velocity=8.0))
    check_result(res, jres)
    assert res.behavior.tolist()[0] == 1 and res.behavior.tolist()[2] == 0
    assert bool(res.risky[1].any())


def test_eudm_plan_non_lk_root_matches_jax(two_lane_setup):
    """A tree rooted at LCL (the manager's ongoing lane change), the ego
    mid-change: the re-basing of lat_map when the change completes."""
    jls, ls, jg, g, jplan = two_lane_setup
    st = TWO_LANE.copy()
    st[:, 0, 1] = [1.4, 2.9, 0.6]
    st[:, 0, 2] = [0.25, 0.1, 0.2]
    ids = np.array([[0, 0], [1, 0], [0, 0]])
    jres = jplan(jnp.asarray(st), jnp.asarray(ids, jnp.int32),
                 jnp.asarray(jeudm.dcp_action_script(5, 1)))
    res = eudm.eudm_plan(ls, t64(st), torch.from_numpy(ids), g, 0,
                         fsim.SimParam(),
                         eudm.EUDMConfig(desired_velocity=8.0),
                         ongoing_lat=1)
    check_result(res, jres)


@pytest.mark.parametrize("cfg", [CFG_DEMO, CFG_REF], ids=["demo", "ref"])
def test_eudm_plan_highway_batch_matches_jax_vmap(highway_setup, cfg):
    """4 seeded scenes on the demo's highway, one batched call each side
    (the port batch-first, JAX through jax.vmap), and the RSS ladder's
    per-layer costs of every policy of one scene."""
    jls, ls, jg, g = highway_setup
    st, ids = highway_scenes(4, seed=5)
    jcfg, pcfg = jeudm.EUDMConfig(**cfg), eudm.EUDMConfig(**cfg)
    jres = _jax_plan(jls, jg, jcfg)(
        jnp.asarray(st), jnp.asarray(ids, jnp.int32),
        jnp.asarray(jeudm.dcp_action_script(pcfg.tree_height)))
    res = eudm.eudm_plan(ls, t64(st), torch.from_numpy(ids), g, 0,
                         fsim.SimParam(), pcfg)
    check_result(res, jres)
    assert len(set(res.behavior.tolist())) >= 2

    # the ladder of every policy of the scene with the most risky ones
    H, spl = pcfg.tree_height, pcfg.steps_per_layer
    b = int(res.risky.sum(-1).argmax())
    lane0 = int(ids[b, 0])
    jlane0 = jax.tree.map(lambda f: f[lane0], jls.lanes)
    jcost, jrisky = jax.jit(jax.vmap(lambda tr: jeudm._rss_ladder(
        tr, 0, jlane0, jg, jcfg, H, spl)))(jnp.asarray(res.trajs[b].numpy()))
    lane = lane_mod.lane_unsqueeze(ls.lane(lane0), 1)
    cost, risky = eudm._rss_ladder(res.trajs[b], 0, lane, g, pcfg, H, spl)
    close(cost, jcost)
    same(risky, jrisky)
    assert bool(risky.any()) and float(cost.max()) > 0.0
    # rss_cost_enable=False zeroes the costs and keeps the riskiness
    off, risky_off = eudm._rss_ladder(
        res.trajs[b], 0, lane, g, pcfg._replace(rss_cost_enable=False), H,
        spl)
    assert not bool(off.any())
    same(risky_off, jrisky)


def _jax_cfb(jls, jg, jcfg, st, ids, probs, unc):
    return jax.jit(lambda s, i: jeudm.eudm_plan_cfb(
        jls, s, i, jg, 0, jfsim.SimParam(), jcfg, probs, unc))(
        jnp.asarray(st), jnp.asarray(ids, jnp.int32))


def test_eudm_plan_cfb_one_agent_matches_jax(two_lane_setup):
    """U = 1 on tests/test_urban.py's cut-in scene (the belief flips the
    decision) against JAX, and in the same batched call a one-hot
    lane-keep belief, which must reproduce eudm_plan."""
    jls, ls, jg, g, _ = two_lane_setup
    cfg = dict(desired_velocity=8.0)
    st = np.array([
        [[0.0, 0.03, 0.0, 8.0, 0.0, 0.0], [14.0, 3.46, 0.0, 2.0, 0.0, 0.0]],
        [[0.0, 0.03, 0.0, 5.0, 0.0, 0.0], [25.0, -0.04, 0.0, 1.0, 0.0, 0.0]],
    ])
    ids = np.array([[0, 1], [0, 0]])
    probs = np.array([[[1.0, 0.0, 0.0], [0.3, 0.0, 0.7]],
                      [[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]]])
    res = eudm.eudm_plan_cfb(ls, t64(st), torch.from_numpy(ids), g, 0,
                             fsim.SimParam(), eudm.EUDMConfig(**cfg),
                             t64(probs), (1,))
    obs = eudm.eudm_plan(ls, t64(st), torch.from_numpy(ids), g, 0,
                         fsim.SimParam(), eudm.EUDMConfig(**cfg))
    jres = _jax_cfb(jls, jg, jeudm.EUDMConfig(**cfg), st[0], ids[0],
                    probs[0], (1,))
    check_result(eudm.EUDMResult(*(
        f if k == "action_script" else f[0]
        for k, f in zip(eudm.EUDMResult._fields, res))), jres)
    assert int(res.best_policy[0]) != int(obs.best_policy[0])
    assert not bool(res.valid[0, int(obs.best_policy[0])])
    # the one-hot lane-keep belief is the observed prediction
    assert int(res.best_policy[1]) == int(obs.best_policy[1])
    same(res.valid[1], obs.valid[1])
    same(res.risky[1], obs.risky[1])
    same(res.trajs[1], obs.trajs[1])
    fin = torch.isfinite(obs.scores[1])
    same(torch.isfinite(res.scores[1]), fin)
    close(res.scores[1][fin], obs.scores[1][fin], rel=1e-12)


def test_eudm_plan_cfb_two_agents_matches_jax(highway_setup):
    """U = 2 (agents 1 and 2, C = 9) on a highway scene at the demo's
    configuration, the beliefs from the port's MOBIL prediction, with one
    combination whose target lane is missing."""
    from dftpav_tpu_torch.urban import semantic_map as sm

    jls, ls, jg, g = highway_setup
    st, ids = highway_scenes(3, seed=9)
    st, ids = st[1], ids[1]
    ids[2] = 2                 # agent 2 on the leftmost lane: no LCL
    st[2, 1] = 7.0 - 0.4
    _, probs = sm.predict_behaviors(ls, t64(st), torch.from_numpy(ids), g)
    probs = probs.numpy()
    probs[1] = [0.5, 0.3, 0.2]
    probs[2] = [0.6, 0.25, 0.15]
    cfg = CFG_DEMO
    jres = _jax_cfb(jls, jg, jeudm.EUDMConfig(**cfg), st, ids, probs, (1, 2))
    res = eudm.eudm_plan_cfb(ls, t64(st), torch.from_numpy(ids), g, 0,
                             fsim.SimParam(), eudm.EUDMConfig(**cfg),
                             t64(probs), (1, 2))
    check_result(res, jres)
