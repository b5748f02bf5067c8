"""The park-demo path of the port against the JAX package, on the CPU:

  * geo and corridor_builders on tests/test_geo.py's cases: the port's
    outputs equal the JAX module's (exactly: the same numpy code);
  * playgrounds.load for parking_lot and reverse_park: grid, start, goal,
    movers equal to JAX's; highway_v1 and ring_v1 with their lane nets
    and lane graphs equal to JAX's;
  * viz.vehicle_outline equal to JAX's, and a render of a trajectory to a
    PNG (matplotlib, imported only by the render);
  * one replan of the park demo's S = 4 classes through both servers
    (sim.PlannerServer, the front end and one solve): the parking_lot start
    and goal with no movers (O = 0, so that JAX compiles in seconds). The
    same front-end scenario to 1e-12, the same class, both succeed, and the
    port's cost (its default engine, the plain float32 round loop on CPU
    tensors) within 2% of JAX's (its bminor engine) or, past that, within
    2% beyond the port loop's own move when x0 moves by 1e-7.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dftpav_tpu import corridor_builders as jcb
from dftpav_tpu import geo as jgeo
from dftpav_tpu import playgrounds as jpg
from dftpav_tpu import viz as jviz
from dftpav_tpu.config import PlannerConfig as JCfg
from dftpav_tpu.pipeline import ParkingPlanner as JPP
from dftpav_tpu.sim import server as jserver
from dftpav_tpu.types import Dims as JDims

from dftpav_tpu_torch import corridor_builders, geo, playgrounds, viz
from dftpav_tpu_torch.config import PlannerConfig
from dftpav_tpu_torch.pipeline import ParkingPlanner
from dftpav_tpu_torch.sim import server
from dftpav_tpu_torch.types import Dims

torch.set_num_threads(1)

_BOX = (np.array([[1.0, 0], [-1, 0], [0, 1], [0, -1]]),
        np.array([1.0, 1.0, 1.0, 1.0]))
_RING = np.random.default_rng(0)
_ANG, _RAD = _RING.uniform(0, 2 * np.pi, 60), _RING.uniform(8, 12, 60)

# tests/test_geo.py's inputs: name -> (function name, args, kwargs)
GEO = {
    "hull_square": ("convex_hull2d", (np.array(
        [[0, 0], [1, 0], [1, 1], [0, 1], [0.5, 0.5], [0.2, 0.8]]),), {}),
    "hull_ccw": ("convex_hull2d",
                 (np.random.default_rng(0).normal(size=(50, 2)),), {}),
    "hull_inside": ("convex_hull2d",
                    (np.random.default_rng(1).normal(size=(100, 2)),), {}),
    "lp_simple": ("linprog2d", (np.array([1.0, 1.0]),
                                np.array([[-1.0, 0.0], [0.0, -1.0]]),
                                np.array([-1.0, -2.0])), {}),
    "lp_infeasible": ("linprog2d", (np.array([1.0, 0.0]),
                                    np.array([[1.0, 0.0], [-1.0, 0.0]]),
                                    np.array([-1.0, -1.0])), {}),
    "lp_triangle": ("linprog2d", (np.array([-1.0, -1.0]),
                                  np.array([[-1.0, 0.0], [0.0, -1.0],
                                            [1.0, 1.0]]),
                                  np.array([0.0, 0.0, 1.0])), {}),
    "chebyshev_box": ("chebyshev_center2d", _BOX, {}),
    "vertices_box": ("halfplane_vertices", _BOX, {}),
    "vertices_empty": ("halfplane_vertices",
                       (np.array([[1.0, 0.0], [-1.0, 0.0]]),
                        np.array([-1.0, -1.0])), {}),
    "roots_cubic": ("poly_roots", ([6.0, -7.0, 0.0, 1.0],), {}),
    "roots_interval": ("poly_roots", ([6.0, -7.0, 0.0, 1.0],),
                       dict(lo=0.0, hi=1.5)),
    "minmax": ("poly_minmax_on_interval", ([0.0, -2.0, 1.0], 0.0, 3.0), {}),
}
CORRIDORS = {
    "star_ring": ("star_convex_corridor",
                  (np.zeros(2), np.stack([_RAD * np.cos(_ANG),
                                          _RAD * np.sin(_ANG)], 1)),
                  dict(radius=50.0)),
    "star_free_box": ("star_convex_corridor",
                      (np.array([1.0, 2.0]), np.zeros((0, 2))),
                      dict(max_x=20.0, max_y=10.0)),
    "ellipsoid": ("ellipsoid_decomp2d",
                  ([0, 0], [10, 0], np.array([[5.0, 2.0], [5.0, -2.0],
                                              [12.0, 1.5], [-3.0, 1.0]])),
                  {}),
}


def _assert_same(a, b):
    if a is None or b is None:
        assert a is None and b is None
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _assert_same(u, v)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", list(GEO))
def test_geo_matches_jax(case):
    name, args, kw = GEO[case]
    _assert_same(getattr(geo, name)(*args, **kw),
                 getattr(jgeo, name)(*args, **kw))


@pytest.mark.parametrize("case", list(CORRIDORS))
def test_corridor_builders_match_jax(case):
    name, args, kw = CORRIDORS[case]
    _assert_same(getattr(corridor_builders, name)(*args, **kw),
                 getattr(jcb, name)(*args, **kw))


@pytest.mark.parametrize("name", ["parking_lot", "reverse_park"])
def test_playground_load_matches_jax(name):
    ours, theirs = playgrounds.load(name), jpg.load(name)
    np.testing.assert_array_equal(ours.grid.occ, theirs.grid.occ)
    assert tuple(ours.grid.origin) == tuple(theirs.grid.origin)
    assert ours.grid.resolution == theirs.grid.resolution
    assert (ours.name, ours.start, ours.goal, ours.description) == \
        (theirs.name, theirs.start, theirs.goal, theirs.description)
    assert [dataclasses.astuple(m) for m in ours.movers] == \
        [dataclasses.astuple(m) for m in theirs.movers]
    for t in (0.0, 3.7):
        for m, jm in zip(ours.movers, theirs.movers):
            np.testing.assert_array_equal(m.state(t), jm.state(t))
    assert playgrounds.available() == jpg.available()


@pytest.mark.parametrize("name", ["highway_v1", "ring_v1"])
def test_playground_with_lane_net_raises(name):
    """A lane-net scene loads with the same LaneSet (float32, as JAX's
    default) and LaneGraph as JAX's, and its traffic placements."""
    ours = playgrounds.load(name, device="cpu")
    theirs = jpg.load(name)
    for a, b in zip(ours.lane_set.lanes, theirs.lane_set.lanes):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ours.lane_set.left_id.numpy(),
                                  np.asarray(theirs.lane_set.left_id))
    np.testing.assert_array_equal(ours.lane_set.right_id.numpy(),
                                  np.asarray(theirs.lane_set.right_id))
    assert dataclasses.asdict(ours.lane_graph) == \
        dataclasses.asdict(theirs.lane_graph)
    assert ours.agents == theirs.agents and len(ours.agents) >= 4
    assert (ours.name, ours.start, ours.goal) == \
        (theirs.name, theirs.start, theirs.goal)
    np.testing.assert_array_equal(ours.grid.occ, theirs.grid.occ)


def test_viz_outline_and_render(tmp_path):
    vp, jvp = PlannerConfig().vehicle, JCfg().vehicle
    for pose in ((1.0, 2.0, 0.3), (-4.0, 0.5, -2.1)):
        np.testing.assert_array_equal(viz.vehicle_outline(*pose, vp),
                                      jviz.vehicle_outline(*pose, jvp))
    pg = playgrounds.load("reverse_park")
    coeffs = np.zeros((4, 6, 2))
    coeffs[:, 0] = np.stack([np.linspace(6.0, 14.0, 4), np.full(4, 9.0)], 1)
    coeffs[:, 1, 0] = 2.0
    ax = viz.plot_grid(pg.grid)
    viz.plot_trajectory(ax, coeffs, 1.0, 1, vp)
    viz.plot_ego_track(ax, np.array([[6.0, 9.0], [10.0, 9.0]]))
    out = tmp_path / "scene.png"
    viz.save(ax, str(out), title="reverse_park")
    assert out.stat().st_size > 1000


def _replan(pgm, Cfg, PP, srv_mod, D, monkeypatch, **kw):
    """One replan from the parking_lot playground's start through srv_mod's
    PlannerServer with the park demo's classes and no movers: (the
    front end's scenario and meta, the solver result, the server)."""
    pg = pgm.load("parking_lot")
    classes = [D(S=4, N=n, K=16, Kdes=32, H=4, O=0, Po=8) for n in (2, 4, 8)]
    pp = PP(pg.grid, Cfg(), classes[-1], dtype=np.float32,
            dims_classes=classes)
    rec = {}
    plan = pp.plan_scenario

    def planned(*a, **k):
        rec["plan"] = plan(*a, **k)
        return rec["plan"]

    pp.plan_scenario = planned
    make = srv_mod.solver.make_solver

    def recording(*a, **k):
        solve = make(*a, **k)

        def run(batch, w):
            rec["res"] = solve(batch, w)
            return rec["res"]
        return run

    monkeypatch.setattr(srv_mod.solver, "make_solver", recording)
    srv = srv_mod.PlannerServer(pp, goal=pg.goal, budget=0.5, **kw)
    ego0 = np.asarray([pg.start[0], pg.start[1], pg.start[2], 0.0,
                       pg.start[3]], np.float32)
    assert srv.replan(0.0, ego0)
    monkeypatch.undo()
    return rec["plan"], rec["res"], srv


def test_s4_replan_matches_jax_server(monkeypatch):
    (jscen, jmeta), jres, _ = _replan(jpg, JCfg, JPP, jserver, JDims,
                                      monkeypatch)
    (scen, meta), res, srv = _replan(playgrounds, PlannerConfig,
                                     ParkingPlanner, server, Dims,
                                     monkeypatch, device="cpu")
    for a, b in zip(scen, jscen):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=0,
                                   atol=1e-12)
    assert meta.dims.S == 4
    assert dataclasses.astuple(meta.dims) == dataclasses.astuple(jmeta.dims)
    assert srv.replans[-1]["dims"] == meta.dims
    assert srv.replans[-1]["solves"] == 1
    assert bool(res.success[0]) and bool(np.asarray(jres.success)[0])
    c, jc = float(res.cost[0]), float(np.asarray(jres.cost)[0])
    if abs(c - jc) > 0.02 * abs(jc):
        # the port loop's own move under 1e-7 perturbations of x0
        from dftpav_tpu_torch.ops import pallas_solve
        from dftpav_tpu_torch.types import Scenario, from_numpy, \
            weights_from_config
        cfg = PlannerConfig()
        b = from_numpy([np.asarray(a)[None] for a in scen], Scenario,
                       device="cpu")
        w = weights_from_config(cfg.opt, device="cpu")
        xp = pallas_solve._prep(b, w, meta.dims, torch.float32, 1.0)[1]
        moves = []
        for seed in (1, 2, 3):
            noise = np.random.default_rng(seed).standard_normal(xp.shape)
            r = pallas_solve.solve_batch_rounds(
                b, w, meta.dims, cfg, 300,
                x0_override=(xp.double() * (1 + 1e-7 * torch.from_numpy(
                    noise))).float())
            moves.append(abs(float(r.cost[0]) - c) / abs(c))
        assert abs(c - jc) <= (0.02 + max(moves)) * abs(jc), (c, jc, moves)
