"""The port's trajectory container, bicycle plant and closed-loop planner
server against the JAX package, on the CPU.

  * BicycleModel.step and make_stepper (float64, steering and its rate
    past their clamps): within 1e-12; tracking_control within 1e-12;
  * TrajContainer state / locate / set_from_solve: exact;
  * PlannerServer.check_replan and _filter_singularity on identical
    containers and grids: equal decisions (empty, exhausted with the plant
    far from and at the goal, near the end with the goal moved and
    reached, before a gear switch, and through an obstacle);
  * the JAX package's circle and steer-clamp tests (tests/test_sim.py),
    run on the port;
  * a short closed loop on the CPU (tests/test_sim.py's lot, two boxes):
    it replans and the plant moves toward the goal.
"""

import functools

import jax.numpy as jnp
import numpy as np
import torch

from dftpav_tpu import container as jcontainer
from dftpav_tpu.config import PlannerConfig as JPlannerConfig
from dftpav_tpu.frontend import GridMap2D as JGridMap2D
from dftpav_tpu.pipeline import ParkingPlanner as JParkingPlanner
from dftpav_tpu.sim import server as jserver
from dftpav_tpu.sim import vehicle as jvehicle
from dftpav_tpu.types import Dims as JDims

from dftpav_tpu_torch import container
from dftpav_tpu_torch.config import PlannerConfig
from dftpav_tpu_torch.frontend import GridMap2D
from dftpav_tpu_torch.pipeline import ParkingPlanner
from dftpav_tpu_torch.sim import PlannerServer, SimLoop
from dftpav_tpu_torch.sim.vehicle import BicycleModel, tracking_control
from dftpav_tpu_torch.types import Dims

torch.set_num_threads(1)

TIGHT = dict(rtol=1e-12, atol=1e-12)
GOAL = (23.0, 18.2, 0.0, 0.0)
DIMS_KW = dict(S=2, N=8, K=16, Kdes=32, H=4, O=0, Po=8)
SMALL_KW = dict(DIMS_KW, N=2)


def _lot():
    """tests/test_sim.py's 40 x 60 m lot with two boxes."""
    res = 0.1
    occ = np.zeros((400, 600), np.uint8)
    occ[:3, :] = 1
    occ[-3:, :] = 1
    occ[:, :3] = 1
    occ[:, -3:] = 1
    occ[int(14 / res):int(16.5 / res), int(20 / res):int(25 / res)] = 1
    occ[int(20 / res):int(22.5 / res), int(20 / res):int(25 / res)] = 1
    return occ


def _random_plant(seed):
    rng = np.random.default_rng(seed)
    s = np.stack([rng.uniform(-5, 5, 16), rng.uniform(-5, 5, 16),
                  rng.uniform(-3, 3, 16), rng.uniform(-0.69, 0.69, 16),
                  rng.uniform(-3, 3, 16)], axis=1)
    u = np.stack([rng.uniform(-8, 8, 16), rng.uniform(-12, 12, 16)], axis=1)
    return s, u


def test_bicycle_step_and_stepper_match_jax():
    s, u = _random_plant(0)
    m = BicycleModel(device="cpu")
    jm = jvehicle.BicycleModel()
    out = m.step(torch.from_numpy(s), torch.from_numpy(u), 0.01)
    ref = jm.step(jnp.asarray(s), jnp.asarray(u), 0.01)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TIGHT)
    out = m.make_stepper(0.01, substeps=5)(torch.from_numpy(s), u)
    ref = jm.make_stepper(0.01, substeps=5)(jnp.asarray(s), jnp.asarray(u))
    assert out.dtype == torch.float64 and out.device.type == "cpu"
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TIGHT)


def test_tracking_control_matches_jax():
    s, _u = _random_plant(1)
    rng = np.random.default_rng(2)
    for i in range(16):
        des = {"pos": rng.uniform(-5, 5, 2), "theta": rng.uniform(-3, 3),
               "steer": rng.uniform(-0.6, 0.6), "vel": rng.uniform(-3, 3),
               "acc": rng.uniform(-2, 2)}
        np.testing.assert_allclose(
            tracking_control(s[i], des, 2.85),
            jvehicle.tracking_control(s[i], des, 2.85), **TIGHT)


def test_bicycle_rk4_matches_circle():
    """Constant steer and speed trace the analytic circle."""
    m = BicycleModel(wheel_base=2.85, device="cpu")
    steer, v = 0.3, 2.0
    R = 2.85 / np.tan(steer)
    s = torch.tensor([0.0, 0.0, 0.0, steer, v], dtype=torch.float64)
    u = torch.tensor([0.0, 0.0], dtype=torch.float64)
    dt, T = 0.01, 3.0
    for _ in range(int(T / dt)):
        s = m.step(s, u, dt)
    th = v * T / R
    exp = np.array([R * np.sin(th), R * (1 - np.cos(th)), th, steer, v])
    np.testing.assert_allclose(s.numpy(), exp, atol=1e-6)


def test_bicycle_steer_clamp():
    m = BicycleModel(max_steer=0.7, device="cpu")
    s = torch.tensor([0.0, 0.0, 0.0, 0.69, 1.0], dtype=torch.float64)
    u = torch.tensor([100.0, 0.0], dtype=torch.float64)  # rate clamped
    s = m.step(s, u, 0.1)
    assert float(s[3]) <= 0.7 + 1e-9


def _line(p0, p1, n=4, dur=3.0):
    """Normalized coefficients [n, 6, 2] of a straight constant-speed run
    p0 -> p1 in dur seconds, and its per-piece duration."""
    p0, p1 = np.asarray(p0, float), np.asarray(p1, float)
    dT = dur / n
    c = np.zeros((n, 6, 2))
    for i in range(n):
        c[i, 0] = p0 + (p1 - p0) * i / n
        c[i, 1] = (p1 - p0) / n
    return c, dT


def _fill(pairs, segs):
    """Both containers, filled with the same segments (coeffs, dT, singul,
    start)."""
    for c, jc in pairs:
        c.clear()
        jc.clear()
        for seg in segs:
            c.add(*seg)
            jc.add(*seg)


def test_container_state_locate_set_from_solve_match_jax():
    c, jc = container.TrajContainer(), jcontainer.TrajContainer()
    a, dTa = _line((5, 30), (15, 30))
    b, dTb = _line((15, 30), (12, 28), n=2, dur=2.0)
    _fill([(c, jc)], [(a, dTa, 1, 10.0), (b, dTb, -1, 13.0)])
    for t in np.linspace(9.0, 16.0, 29):
        st, jst = c.state(t, 2.85), jc.state(t, 2.85)
        assert st.keys() == jst.keys()
        for k in st:
            np.testing.assert_array_equal(np.asarray(st[k]),
                                          np.asarray(jst[k]), err_msg=k)
        assert [s is c.locate(t) for s in c.segments] == \
            [s is jc.locate(t) for s in jc.segments]
    rng = np.random.default_rng(3)
    res = type("Res", (), dict(coeffs=rng.standard_normal((3, 8, 6, 2)),
                               dT=rng.uniform(0.3, 0.8, 3)))
    mask, singuls = np.array([True, True, False]), np.array([1, -1, 1])
    c.set_from_solve(res, singuls, mask, 4.0)
    jc.set_from_solve(res, singuls, mask, 4.0)
    assert len(c.segments) == len(jc.segments) == 2
    for s, js in zip(c.segments, jc.segments):
        np.testing.assert_array_equal(s.coeffs, js.coeffs)
        assert (s.dT, s.singul, s.start_time, s.end_time) == \
            (js.dT, js.singul, js.start_time, js.end_time)
    assert (c.start_time, c.end_time) == (jc.start_time, jc.end_time)


@functools.lru_cache(maxsize=None)
def _servers():
    occ = _lot()
    pp = ParkingPlanner(GridMap2D(occ), PlannerConfig(), Dims(**DIMS_KW),
                        small_dims=Dims(**SMALL_KW))
    jpp = JParkingPlanner(JGridMap2D(occ), JPlannerConfig(),
                          JDims(**DIMS_KW), small_dims=JDims(**SMALL_KW))
    return (PlannerServer(pp, GOAL, device="cpu"),
            jserver.PlannerServer(jpp, GOAL))


def test_check_replan_and_filter_singularity_match_jax():
    srv, jsrv = _servers()
    pair = [(srv.container, jsrv.container)]
    clear, dT = _line((5, 30), (15, 30))
    to_goal, dTg = _line((15, GOAL[1]), GOAL[:2])
    into_box, dTx = _line((16, 15.25), (28, 15.25))
    turn, dTt = _line((15, 30), (13, 27), n=2, dur=2.0)
    cases = {
        "clear": [(clear, dT, 1, 0.0)],
        "to_goal": [(to_goal, dTg, 1, 0.0)],
        "into_box": [(into_box, dTx, 1, 0.0)],
        "before_switch": [(clear, dT, 1, 0.0), (turn, dTt, -1, 3.0)],
        "empty": [],
    }
    egos = [None, np.array([15.0, 30.0, 0.0, 0.0, 0.0]),
            np.array([*GOAL[:3], 0.0, 0.0])]
    decisions = {}
    for name, segs in cases.items():
        _fill(pair, segs)
        for t in (0.0, 0.5, 1.5, 2.2, 2.9, 3.5, 6.0):
            for i, ego in enumerate(egos):
                got = srv.check_replan(t, ego)
                assert got == jsrv.check_replan(t, ego), (name, t, i)
                decisions[(name, t, i)] = got
    # each rule fires and holds somewhere
    assert decisions[("empty", 0.0, 0)]
    assert decisions[("into_box", 0.0, 0)]
    assert not decisions[("clear", 0.0, 0)]
    assert decisions[("clear", 2.9, 0)]                      # near, moved
    assert not decisions[("to_goal", 2.9, 0)]                # near, reached
    assert decisions[("clear", 6.0, 1)]                      # exhausted, far
    assert not decisions[("before_switch", 2.2, 0)]          # close turn
    for hist in ([], [(1.0, 0.2)]):
        srv._state_hist, jsrv._state_hist = list(hist), list(hist)
        for theta in (0.2, 0.21, 1.0, -2.5):
            for vel in (0.0, 0.05, -0.09, 0.5):
                st = {"theta": theta, "vel": vel, "pos": np.zeros(2)}
                a = srv._filter_singularity(st, 1.2)
                b = jsrv._filter_singularity(st, 1.2)
                assert a["theta"] == b["theta"], (hist, theta, vel)


def test_closed_loop_replans_and_moves_toward_goal():
    """A few seconds of tests/test_sim.py's closed loop, plant and solves
    on the CPU (the plain round loop; the card runs the same loop through
    the kernels in chip_smoke.py)."""
    srv, _jsrv = _servers()
    srv = PlannerServer(srv.pp, GOAL, budget=0.5, device="cpu")
    loop = SimLoop(srv, ego0=[8.0, 30.0, 0.0, 0.0, 0.0], device="cpu")
    log = loop.run(duration=2.5)
    ego = np.array(log.ego)
    assert loop.ego.device.type == "cpu" and np.isfinite(ego).all()
    assert srv.n_replans >= 1 and srv.n_failures == 0
    assert srv.replans[0]["ok"] and srv.replans[0]["dims"] is not None
    assert srv.container.segments
    d0 = np.hypot(8.0 - GOAL[0], 30.0 - GOAL[1])
    d1 = np.hypot(ego[-1, 0] - GOAL[0], ego[-1, 1] - GOAL[1])
    assert d1 < d0 - 3.0, (ego[-1], d0, d1)
