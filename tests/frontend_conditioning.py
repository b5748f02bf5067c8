"""How finely float64 and the kernels' float32 arithmetic resolve the front
end's many-point turns, by piece count (not a pytest module; CPU only).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/frontend_conditioning.py [N ...]

For each N (default 2 4 8): the first 64 of chip_smoke.py's phase-15
front-end lanes (frontend_batch of Dims(S=6, N, K=16, Kdes=32, H=4, O=2,
Po=8), 256 plans, seed 11, 20 x 30 m lots, two movers, 1 s of search)
solved for 150 iterations by the plain round loop in float64 and by kernel
B's per-lane code in float32 (the g++ harness, one member per lane), both
from the same float32 inputs; and 12 iterations of each, whose paths are
compared. Prints per N the lanes whose final cost is negative (the jerk
form's rounding error has outgrown its value: dT^-5 rhs^T Q rhs over
positions of ~20 m, with pieces of T / N on segments as short as 0.07 s),
success and cost p50 of both, and the share of equal 12-iteration paths.
Minutes per N on one core.
"""

import sys

import numpy as np
import torch

import _kernel_harness
from dftpav_tpu_torch import config, scenarios
from dftpav_tpu_torch.ops import kcost, pallas_solve
from dftpav_tpu_torch.types import Dims, Scenario, from_numpy, \
    weights_from_config

LANES = 64


def run(N):
    dims = Dims(S=6, N=N, K=16, Kdes=32, H=4, O=2, Po=8)
    npb = scenarios.frontend_batch(dims, 256, seed=11, dtype=np.float32,
                                   lot=(20.0, 30.0), n_obstacles=2,
                                   max_search_time=1.0)
    npb = Scenario(*(a[:LANES] for a in npb))
    cfg, flags = config.PlannerConfig(), config.EngineFlags.tuned()
    p = cfg.opt.lbfgs
    w = weights_from_config(cfg.opt, torch.float32, device="cpu")
    sw = kcost.StaticW.build(w, cfg)
    batch = from_numpy(npb, Scenario, device="cpu", dtype=torch.float32)
    de = pallas_solve.embedded_class(dims)
    _b, x0, sc, kc, _D = pallas_solve._prep(
        pallas_solve.embed_scenario(batch, dims, de), w, de, torch.float32,
        "auto")
    sc64 = kcost.KScenario(*(a.double() for a in sc))
    kc64 = kcost.KConsts(*(a.double() for a in kc))
    f0, g0 = kcost.eval_fg(x0.double(), sc64, kc64, sw, de, flags)
    inst = (("f32", 1, 8, 6),)
    out = {}
    for iters in (150, 12):
        r = pallas_solve._solve_rounds(x0.double(), sc64, kc64, sw, de, p,
                                       iters, flags)
        _x, f, info = _kernel_harness.host_solve(
            x0, f0.float(), g0.float(), sc, kc, sw, "auto", p, iters, flags,
            torch.float32, 1, de, inst)
        out[iters] = (r, f, info)
    r, f, info = out[150]

    def success_cost(status, fp):
        cost = fp.double() / cfg.opt.cost_scale
        ok = (status >= 0) & (cost < cfg.opt.reject_cost)
        return ok.double().mean().item(), cost.median().item(), \
            int((cost < 0).sum())

    r12, _f12, i12 = out[12]
    same = ((i12[0] == r12.status) & (i12[1] == r12.k.clamp(max=12))
            & (i12[2] == r12.n_evals))
    s64, c64, n64 = success_cost(r.status, r.fp)
    s32, c32, n32 = success_cost(info[0], f)
    print(f"N={N}: negative cost float64 {n64} / {LANES}, kernel float32 "
          f"{n32}; success {s64:.4f} / {s32:.4f}; cost p50 {c64:.1f} / "
          f"{c32:.1f}; 12-iteration paths equal {same.double().mean():.4f}",
          flush=True)


if __name__ == "__main__":
    torch.set_num_threads(2)
    for n in [int(a) for a in sys.argv[1:]] or [2, 4, 8]:
        run(n)
