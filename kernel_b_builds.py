"""Kernel B built from several csrc trees, timed in turns on one CUDA card.

    python3 kernel_b_builds.py --log out.log [--sass-dir DIR] CSRC [CSRC ...]

Each CSRC is a directory holding a copy of dftpav_tpu_torch/csrc (this
package's, or another commit's unpacked with `git archive` into a
gitignored directory); chip_smoke._other_kernel_b builds it and calls it
through the C interface it exports. On the main path's inputs (the bench
fixture, B=8192, 150 iterations, tuned flags) every build's kernel B runs
in the order given, then reversed, then again (best of 2 each time), and
each run prints its milliseconds, success, cost p50 and lane evaluations
(equal outputs mean equal arithmetic). Per build it prints the ptxas
registers and spill stores and the machine instructions (cuobjdump) of
kernels A and B; with --sass-dir it also writes each build's full SASS
there, to compare where two builds' code differs. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log", required=True,
                    help="also write every printed line to this file")
    ap.add_argument("--sass-dir", default=None,
                    help="write each build's cuobjdump --dump-sass here")
    ap.add_argument("csrc", nargs="+")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_b_builds: no CUDA device")

    import chip_smoke as cs
    from dftpav_tpu_torch import scenarios
    from dftpav_tpu_torch.config import EngineFlags, PlannerConfig
    from dftpav_tpu_torch.ops import _cuda, kcost, pallas_solve
    from dftpav_tpu_torch.types import Dims, Scenario, from_numpy, \
        weights_from_config

    log = open(args.log, "w")

    def say(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        print(line, file=log, flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    dims = Dims(S=1, N=8, K=16, Kdes=32, H=4, O=2, Po=8)
    cfg, tuned = PlannerConfig(), EngineFlags.tuned()
    w = weights_from_config(cfg.opt, torch.float32)
    sw = kcost.StaticW.build(w, cfg)
    p = cfg.opt.lbfgs
    batch = from_numpy(scenarios.batch_scenarios(
        dims, 8192, seed=7, dtype=np.float32, n_obstacles=2), Scenario,
        dtype=torch.float32)
    _b, x0, sc, kc, _D = pallas_solve._prep(batch, w, dims, torch.float32,
                                            "auto")
    f0, g0 = _cuda.launch_eval_fg(x0, sc, kc, sw, dims, "auto")

    builds = {}
    for d in args.csrc:
        so, build_s, fn = cs._other_kernel_b(d)
        builds[d] = fn
        keep = lambda k: "solve_kernel" in k or "eval_fg" in k
        say({"build": d, "build_s": build_s,
             "machine_instructions": {k: v for k, v in
                                      (cs._sass_sizes(so) or {}).items()
                                      if keep(k)},
             "registers_spill_store_bytes": {
                 k: v for k, v in cs._ptxas(
                     so.with_suffix(".log").read_text()).items() if keep(k)}})
        if args.sass_dir:
            out = pathlib.Path(args.sass_dir)
            out.mkdir(parents=True, exist_ok=True)
            sass = subprocess.run(
                ["/usr/local/cuda/bin/cuobjdump", "--dump-sass", str(so)],
                capture_output=True, text=True, check=True).stdout
            (out / (d.strip("/").replace("/", "_") + ".sass")).write_text(sass)

    for d in args.csrc + args.csrc[::-1] + args.csrc:
        res = {}

        def run():
            res["r"] = builds[d](x0, f0, g0, sc, kc, sw, dims, "auto", p, 150,
                                 tuned)

        ms = cs._cuda_ms(run, reps=2)
        _x, f, info = res["r"]
        cost = f.double() / cfg.opt.cost_scale
        ok = (info[0] >= 0) & (cost < cfg.opt.reject_cost)
        say({"build": d, "ms": ms, "success": ok.double().mean().item(),
             "cost_p50": cost.median().item(),
             "lane_evals": int((info[2] - 1).sum())})
    log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
