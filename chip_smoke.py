"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # the full check (B=8192 main path)
    python3 chip_smoke.py --quick    # smaller batches, for a first build

Phases (each prints one JSON line; any failure raises, so the script exits
non-zero and prints no final result):
  1. device: the card's name and `nvidia-smi` name / power limit;
     the kernels are built from dftpav_tpu_torch/csrc (nvcc, sm_90a);
  2. kernel A (objective + gradient) against the plain autograd version,
     float32, bench fixture at B=1024: per lane |df|/|f| <= 1e-4 and
     max|dg| <= 1e-3 * max(1, max|g_plain|);
  3. kernel B (the whole solve) against the plain round loop, B=1024,
     150 iterations, tuned flags: both success rates >= 0.99 and within
     0.005, cost p50 within 2%; the share of lanes whose 12-iteration
     (status, k, evals) agree exactly is printed, not gated; then a
     "kernel_times" line: each kernel alone beside its plain version;
  4. the main path, solver.make_solver(engine="fused") on
     scenarios.batch_scenarios(B=8192, seed=7, float32, 2 obstacles),
     timed with CUDA events (one warm-up, best of 3), beside the plain
     round loop at the same shapes; gate success >= 0.99 and every kernel
     of the path launched; "kernel_times" again at this batch.
Then one line {"kernels": [...]} and, last, {"ok": true, "device": ...}.
Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch


_PHASES = []


def _emit(phase, **kw):
    _PHASES.append({"phase": phase, **kw})
    print(json.dumps(_PHASES[-1]), flush=True)


def _cuda_ms(fn, reps=3, warmup=1):
    """Best-of-`reps` milliseconds of fn() between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        best = min(best, s.elapsed_time(e))
    return best


def _pct(a, q):
    return float(np.percentile(a.cpu().numpy(), q))


def _rel_errs(f, g, f_ref, g_ref):
    """Largest per-lane |df|/|f_ref| and max|dg| / max(1, max|g_ref|)."""
    rel_f = ((f - f_ref).abs() / f_ref.abs()).max().item()
    gscale = g_ref.abs().amax(dim=0).clamp(min=1.0)
    rel_g = ((g - g_ref).abs().amax(dim=0) / gscale).max().item()
    return rel_f, rel_g


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="main path at B=1024 and checks at B=256, for a "
                         "first build")
    ap.add_argument("--out", default=None,
                    help="also write every phase's numbers to this JSON file")
    args = ap.parse_args(argv)
    B_main, B_chk = (1024, 256) if args.quick else (8192, 1024)
    iters = 150

    # ---- 1. device and build ----
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false)")
    from dftpav_tpu_torch import scenarios, solver
    from dftpav_tpu_torch.config import EngineFlags, PlannerConfig
    from dftpav_tpu_torch.ops import _cuda, kcost, pallas_solve
    from dftpav_tpu_torch.types import Dims, Scenario, from_numpy, \
        weights_from_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    t0 = time.perf_counter()
    so = _cuda.build()
    _cuda.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in so.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    _emit("device", device=kind, nvidia_smi=smi.splitlines()[0],
          torch=torch.__version__, cuda=torch.version.cuda,
          build_s=round(build_s, 3), ptxas=ptxas)

    dims = Dims(S=1, N=8, K=16, Kdes=32, H=4, O=2, Po=8)
    cfg = PlannerConfig()
    tuned = EngineFlags.tuned()
    w = weights_from_config(cfg.opt, torch.float32)
    sw = kcost.StaticW.build(w, cfg)

    def fixture(B, seed=7):
        return from_numpy(scenarios.batch_scenarios(
            dims, B, seed=seed, dtype=np.float32, n_obstacles=2),
            Scenario, device=dev, dtype=torch.float32)

    # ---- 2. kernel A vs plain ----
    batch = fixture(B_chk)
    _b, x0p, sc, kc, D = pallas_solve._prep(batch, w, dims, torch.float32,
                                            0.25)
    x = x0p.clone()
    rng = np.random.default_rng(23)
    half = B_chk // 2
    x[:D, half:] += torch.from_numpy(
        (0.4 * rng.standard_normal((D, B_chk - half))).astype(np.float32)
    ).to(dev)
    f_k, g_k = kcost.eval_fg(x, sc, kc, sw, dims, tuned)
    f_p, g_p = kcost.eval_fg_plain(x, sc, kc, sw, dims, tuned)
    f_64, g_64 = kcost.eval_fg_plain(
        x.double(), kcost.KScenario(*(a.double() for a in sc)),
        kcost.KConsts(*(a.double() for a in kc)), sw, dims, tuned)
    torch.cuda.synchronize()
    rel_f, rel_g = _rel_errs(f_k, g_k, f_p, g_p)
    rel_f64, rel_g64 = _rel_errs(f_k.double(), g_k.double(), f_64, g_64)
    err_a = max((f_k - f_p).abs().max().item(), (g_k - g_p).abs().max().item())
    ok_a = (rel_f <= 1e-4 and rel_g <= 1e-3 and torch.isfinite(g_k).all()
            and not torch.any(g_k[D:]))
    _emit("kernel_A_vs_plain", B=B_chk, rel_f_max=rel_f, rel_g_max=rel_g,
          max_abs_err=err_a, rel_f_max_vs_f64=rel_f64,
          rel_g_max_vs_f64=rel_g64,
          tol="|df|/|f|<=1e-4, max|dg|<=1e-3*max(1,max|g|)", ok=bool(ok_a))
    if not ok_a:
        raise AssertionError("kernel A disagrees with the plain objective")

    # ---- 3. kernel B vs plain round loop ----
    res_k = pallas_solve.solve_batch_fused(batch, w, dims, cfg, iters,
                                           flags=tuned)
    res_p = pallas_solve.solve_batch_rounds(batch, w, dims, cfg, iters,
                                            flags=tuned)
    s_k = res_k.success.float().mean().item()
    s_p = res_p.success.float().mean().item()
    c_k = res_k.cost.median().item()
    c_p = res_p.cost.median().item()
    # 12-iteration paths, raw (the eval counts are not in SolveResult)
    f0, g0 = kcost.eval_fg(x0p, sc, kc, sw, dims, tuned)
    xb, fb, info = _cuda.launch_solve_fused(x0p, f0, g0, sc, kc, sw, dims,
                                            0.25, cfg.opt.lbfgs, 12, tuned)
    raw_p = pallas_solve._solve_rounds(x0p, sc, kc, sw, dims, cfg.opt.lbfgs,
                                       12, tuned)
    same_raw = ((info[0] == raw_p.status) & (info[1] == raw_p.k.clamp(max=12))
                & (info[2] == raw_p.n_evals))
    share12 = same_raw.float().mean().item()
    err_b = (fb - raw_p.fp)[same_raw].abs().max().item() \
        if bool(same_raw.any()) else None
    ok_b = (s_k >= 0.99 and s_p >= 0.99 and abs(s_k - s_p) <= 0.005
            and abs(c_k - c_p) <= 0.02 * abs(c_p)
            and torch.isfinite(res_k.coeffs).all())
    _emit("kernel_B_vs_plain", B=B_chk, iters=iters,
          success_kernel=s_k, success_plain=s_p, cost_p50_kernel=c_k,
          cost_p50_plain=c_p,
          iters_kernel_p50_p90_p99=[_pct(res_k.n_iters.float(), q)
                                    for q in (50, 90, 99)],
          iters_plain_p50_p90_p99=[_pct(res_p.n_iters.float(), q)
                                   for q in (50, 90, 99)],
          share_12iter_status_k_evals_equal=share12,
          max_abs_err_f_12iter_matched=err_b,
          tol="success>=0.99 both, |dsuccess|<=0.005, cost p50 within 2%",
          ok=bool(ok_b))
    if not ok_b:
        raise AssertionError("kernel B disagrees with the plain round loop")

    def kernel_times(b):
        """CUDA-event ms of kernel A and kernel B (150 iterations) at the
        main path's inputs for batch b, beside their plain versions."""
        _b, x0b, scb, kcb, _D = pallas_solve._prep(b, w, dims, torch.float32,
                                                   0.25)
        f0b, g0b = _cuda.launch_eval_fg(x0b, scb, kcb, sw, dims, 0.25)
        t = {"B": b.init_T.shape[0], "ms_a": _cuda_ms(
            lambda: _cuda.launch_eval_fg(x0b, scb, kcb, sw, dims, 0.25),
            reps=20)}
        t["plain_ms_a"] = _cuda_ms(lambda: kcost.eval_fg_plain(
            x0b, scb, kcb, sw, dims, tuned), reps=5)
        t["ms_b"] = _cuda_ms(lambda: _cuda.launch_solve_fused(
            x0b, f0b, g0b, scb, kcb, sw, dims, 0.25, cfg.opt.lbfgs, iters,
            tuned), reps=3)
        t["plain_ms_b"] = _cuda_ms(lambda: pallas_solve._solve_rounds(
            x0b, scb, kcb, sw, dims, cfg.opt.lbfgs, iters, tuned),
            reps=1, warmup=0)
        _emit("kernel_times", **t)
        return t

    kernel_times(batch)

    # ---- 4. the main path ----
    big = fixture(B_main)
    solve = solver.make_solver(cfg, dims, max_iterations=iters,
                               engine="fused", flags=tuned)
    solve(big, w)                                     # warm-up
    torch.cuda.synchronize()
    kcost.eval_fg.launches = 0
    pallas_solve.solve_batch_fused.launches = 0
    out = {}

    def run():
        out["res"] = solve(big, w)

    wall_ms = _cuda_ms(run, reps=3, warmup=0)
    launches = {"eval_fg": kcost.eval_fg.launches,
                "solve_fused": pallas_solve.solve_batch_fused.launches}
    res = out["res"]
    succ = res.success.float().mean().item()
    shapes_ok = (tuple(res.coeffs.shape) == (B_main, 1, 8, 6, 2)
                 and tuple(res.dT.shape) == (B_main, 1)
                 and torch.isfinite(res.coeffs).all().item()
                 and torch.isfinite(res.cost).all().item())

    times_main = kernel_times(big)
    plain_wall_ms = _cuda_ms(lambda: solver.make_solver(
        cfg, dims, iters, engine="rounds", flags=tuned)(big, w),
        reps=1, warmup=0)
    ok_main = (succ >= 0.99 and shapes_ok and launches["eval_fg"] > 0
               and launches["solve_fused"] > 0)
    _emit("main_path", B=B_main, iters=iters, wall_ms=wall_ms,
          solves_per_s=B_main / (wall_ms / 1e3), success=succ,
          cost_p50=res.cost.median().item(),
          iters_p50_p90_p99=[_pct(res.n_iters.float(), q)
                             for q in (50, 90, 99)],
          launches=launches, plain_rounds_wall_ms=plain_wall_ms,
          jax_reference_quality={"success": 0.9991, "cost_p50": 4411.7,
                                 "source": "BENCH_r05.json (TPU run)"},
          ok=bool(ok_main))
    if not ok_main:
        raise AssertionError("main path failed its gate")

    kernels = [
        {"name": "dftpav_eval_fg", "route": "cuda",
         "source": "dftpav_tpu_torch/csrc/kernels.cu",
         "replaces": "dftpav_tpu/ops/kcost.py:772",
         "launches": launches["eval_fg"], "max_abs_err": err_a,
         "err_of": f"f and g vs plain float32 at B={B_chk}",
         "ms": times_main["ms_a"], "plain_ms": times_main["plain_ms_a"]},
        {"name": "dftpav_solve_fused", "route": "cuda",
         "source": "dftpav_tpu_torch/csrc/kernels.cu",
         "replaces": "dftpav_tpu/ops/pallas_solve.py:567",
         "launches": launches["solve_fused"], "max_abs_err": err_b,
         "err_of": "final f after 12 iterations, lanes whose path matched",
         "ms": times_main["ms_b"], "plain_ms": times_main["plain_ms_b"]},
    ]
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"phases": _PHASES, "kernels": kernels}, fh, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
