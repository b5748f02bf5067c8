"""Closed-loop parking demo through the PyTorch port (dftpav_tpu_torch).

Usage:
    python examples/park_demo_torch.py [playground] [--duration 40]
        [--device cuda] [--out demo.png]

The same closed loop as examples/park_demo.py: it loads a playground, plans
with the S = 4 classes of N = 2, 4 and 8 pieces, and runs the
receding-horizon loop (plant 500 Hz substeps, control 100 Hz, replans
20 Hz). Each replan is one solve through make_solver's default engine:
kernels A and B on the card (the N = 2 and 4 classes in their N = 8 form),
the plain round loop with --device cpu. It prints the same summary line,
and renders the scene and the executed track to a PNG only when --out is
given (matplotlib is imported only then).
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def run(playground="parking_lot", duration=40.0, device="cuda"):
    """The closed loop on `playground` for `duration` s of sim time, the
    solves on `device`. Returns (playground, server, sim log, summary
    dict); nothing is rendered."""
    from dftpav_tpu_torch import playgrounds
    from dftpav_tpu_torch.config import PlannerConfig
    from dftpav_tpu_torch.pipeline import ParkingPlanner
    from dftpav_tpu_torch.sim import PlannerServer, SimLoop
    from dftpav_tpu_torch.types import Dims

    pg = playgrounds.load(playground)
    cfg = PlannerConfig()
    O = max(len(pg.movers), 0)
    classes = [Dims(S=4, N=n, K=16, Kdes=32, H=4, O=O, Po=8)
               for n in (2, 4, 8)]
    pp = ParkingPlanner(pg.grid, cfg, classes[-1], dtype=np.float32,
                        dims_classes=classes)
    srv = PlannerServer(pp, goal=pg.goal, budget=0.5, movers=pg.movers,
                        device=device)
    ego0 = [pg.start[0], pg.start[1], pg.start[2], 0.0, pg.start[3]]
    loop = SimLoop(srv, ego0=ego0, device=device)

    t0 = time.time()
    log = loop.run(duration=duration)
    wall = time.time() - t0
    ego = np.array(log.ego)
    err = float(np.hypot(ego[-1, 0] - pg.goal[0], ego[-1, 1] - pg.goal[1]))
    summary = dict(sim_s=float(log.t[-1]), wall_s=wall,
                   replans=srv.n_replans, failures=srv.n_failures,
                   final_error_m=err)
    return pg, srv, log, summary


def render(pg, srv, log, summary, out):
    """The scene, the executed track and the trajectories to a PNG."""
    from dftpav_tpu_torch import viz

    vehicle = srv.cfg.vehicle
    ego = np.array(log.ego)
    ax = viz.plot_grid(pg.grid)
    viz.plot_ego_track(ax, ego)
    viz.plot_vehicle(ax, ego[-1, 0], ego[-1, 1], ego[-1, 2], vehicle,
                     color="tab:red", alpha=1.0)
    gx, gy, gyaw = pg.goal[0], pg.goal[1], pg.goal[2]
    viz.plot_vehicle(ax, gx, gy, gyaw, vehicle, color="tab:green",
                     alpha=1.0)
    for seg in srv.container.segments:
        viz.plot_trajectory(ax, seg.coeffs, seg.dT, seg.singul, vehicle)
    viz.save(ax, out, title=f"{pg.name}: final error "
             f"{summary['final_error_m']:.2f} m")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("playground", nargs="?", default="parking_lot")
    ap.add_argument("--duration", type=float, default=40.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    pg, srv, log, s = run(args.playground, args.duration, args.device)
    print(f"playground: {pg.name} — {pg.description}")
    print(f"sim {s['sim_s']:.1f}s in {s['wall_s']:.1f}s wall | "
          f"replans {s['replans']} (failed {s['failures']}) | "
          f"final error {s['final_error_m']:.3f} m")
    if args.out:
        render(pg, srv, log, s, args.out)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
