"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

The kernels are compiled on first use with `nvcc` for sm_90a into one shared
library with a plain C interface, loaded with ctypes: every `.cu` source is
compiled to an object by its own nvcc process, all started together, and the
objects are linked into the library. The library lives in
`dftpav_tpu_torch/_build/` under a name keyed by a hash of the sources and
flags, so an edited source rebuilds by itself; deleting the directory forces
a rebuild. Nothing here runs at import time: the CPU tests import every
module without a GPU, a compiler or the library.

Every launch checks its tensors (CUDA, float32, contiguous, shapes) and
raises on anything else; it raises too when the C entry point returns a
CUDA error. There is no fallback to the plain versions here.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from dftpav_tpu_torch.config import resolve_vt_scale
from dftpav_tpu_torch.ops.kcost import (CAPACITIES, KConsts, KScenario,
                                        StaticW, bnd_rows, dp_of,
                                        kernel_class, misc_rows, r_rows,
                                        seg_active)

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
                     "-v")

_lib = None


def _sources(csrc=CSRC):
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "dftpav_tpu_torch/csrc on first use and need the "
                       "CUDA toolkit")


def library_path(csrc=CSRC) -> pathlib.Path:
    """Path of the shared library for the sources in `csrc` (built or
    not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdftpav_kernels_{h.hexdigest()[:16]}.so"


def build(csrc=CSRC) -> pathlib.Path:
    """Compile csrc/*.cu (one nvcc per source, in parallel) and link them,
    unless the library for these sources exists. The compilers' register
    and spill reports and each nvcc's seconds go to `<library>.log`.
    `csrc` is the package's own unless a caller names another checkout's
    (chip_smoke.py --parent)."""
    csrc = pathlib.Path(csrc)
    so = library_path(csrc)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}"
    srcs = sorted(csrc.glob("*.cu"))
    objs = [so.with_name(f"{so.stem}.{s.stem}.{tag}.o") for s in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-I", str(csrc), "-c", "-o", str(o), str(s)]
            for s, o in zip(srcs, objs)]

    def run(cmd):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        return proc, time.perf_counter() - t0

    with ThreadPoolExecutor(len(cmds)) as pool:
        procs = list(pool.map(run, cmds))
    tmp = so.with_suffix(f".{tag}.tmp")
    link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
    log, failed = [], None
    for c, (p, sec) in zip(cmds, procs):
        log.append(" ".join(c) + f"\n[nvcc {sec:.1f} s]\n" + p.stdout
                   + p.stderr)
        if p.returncode != 0 and failed is None:
            failed = (p.returncode, p.stderr)
    if failed is None:
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed = (proc.returncode, proc.stderr)
    for o in objs:
        o.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("".join(log))
    if failed is not None:
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{failed[1][-4000:]}")
    os.replace(tmp, so)
    return so


_P = ctypes.c_void_p
_I = ctypes.c_int


def library():
    """The loaded kernel library (built on first call). Raises without a
    CUDA device."""
    global _lib
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device; CPU tensors "
                           "take the plain PyTorch path")
    if _lib is None:
        _lib = load(build())
    return _lib


def load(so):
    """The kernel library at path `so`, its entry points typed."""
    lib = ctypes.CDLL(str(so))
    lib.dftpav_eval_fg.argtypes = [_P] * 11 + [_I] * 5 + [_P] * 4
    lib.dftpav_eval_fg.restype = _I
    lib.dftpav_solve_fused.argtypes = [_P] * 14 + [_I] * 10 + [_P] * 5
    lib.dftpav_solve_fused.restype = _I
    lib.dftpav_corridor_fwd.argtypes = [_P] * 7 + [_I] * 3 + [_P] * 2
    lib.dftpav_corridor_fwd.restype = _I
    lib.dftpav_corridor_bwd.argtypes = [_P] * 8 + [_I] * 3 + [_P] * 4
    lib.dftpav_corridor_bwd.restype = _I
    lib.dftpav_kernel_info.argtypes = [_I, _P] + [_I] * 5 + [_P]
    lib.dftpav_kernel_info.restype = _I
    lib.dftpav_kernel_dp.argtypes = [_I, _I]
    lib.dftpav_kernel_dp.restype = _I
    lib.dftpav_kernel_caps.argtypes = [_P, _I]
    lib.dftpav_kernel_caps.restype = _I
    lib.dftpav_scratch_bytes.argtypes = [_I, _P] + [_I] * 7 + [_P]
    lib.dftpav_scratch_bytes.restype = _I
    lib.dftpav_error_string.argtypes = [_I]
    lib.dftpav_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, shape):
    if not (t.is_cuda and t.dtype == torch.float32 and t.is_contiguous()):
        raise ValueError(f"{name}: need a contiguous float32 CUDA tensor, got "
                         f"{t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


# The kernels' domain: gear segments (csrc/common.cuh kMaxS), pieces per
# segment (the largest capacity, csrc/kernels.cu kCaps: 32) and corridor
# half-planes per row (kMaxH); _check_inputs holds a class to the loaded
# library's own limits.
MAX_S = 8
MAX_N = max(CAPACITIES)
MAX_H = 8


def check_domain(dims, max_s: int = MAX_S, max_n: int = MAX_N,
                 max_h: int = MAX_H, mem: int = 1, past: int = 0) -> None:
    """Raise NotImplementedError for a class the kernels do not take (more
    than max_s gear segments, a segment of more than max_n or fewer than 2
    pieces, more than max_h half-planes; the plain round loop takes every
    class), ValueError for an L-BFGS memory below 1 or a negative past
    window. Every other class runs, at any m and past."""
    if dims.S > max_s:
        raise NotImplementedError(
            f"the kernels take at most {max_s} gear segments (S <= {max_s}); "
            f"got S={dims.S} (the plain round loop takes any S)")
    ns = dims.ns_tuple
    if max(ns) > max_n or min(ns) < 2:
        raise NotImplementedError(
            f"the kernels take 2 to {max_n} pieces per segment "
            f"(N <= {max_n}); got {ns} (the plain round loop takes any N)")
    if dims.H > max_h:
        raise NotImplementedError(f"the kernels take at most {max_h} "
                                  f"half-planes per row; got H={dims.H}")
    if mem < 1 or past < 0:
        raise ValueError(f"L-BFGS memory m={mem} (>= 1) and past={past} "
                         f"(>= 0)")


def capacities(lib) -> tuple:
    """The capacities (pieces per segment) the library has kernels for."""
    out = (ctypes.c_int * 8)()
    n = lib.dftpav_kernel_caps(out, 8)
    return tuple(out[:n])


def _check_inputs(lib, x, sc: KScenario, kc: KConsts, dims, mem=1, past=0):
    """The class's domain (check_domain, with the library's limits), and
    the tensors' shapes in the layout of its kernel class; returns (B, R,
    the kernel class)."""
    # S first: it needs only the library's kMaxS
    check_domain(dims, max_s=lib.dftpav_kernel_max_s(), mem=mem, past=past)
    caps = capacities(lib)
    check_domain(dims, max_n=max(caps), max_h=lib.dftpav_max_h())
    kd = kernel_class(dims)
    if kd.N != dims.N:
        raise ValueError(f"a class of N={dims.N} runs in its capacity-{kd.N} "
                         f"layout: pallas_solve.embedded_class / "
                         f"embed_scenario")
    if kd.N not in caps or dp_of(kd) != lib.dftpav_kernel_dp(kd.N, kd.S):
        raise NotImplementedError(f"no kernels of capacity {kd.N} at S={kd.S} "
                                  f"in this library (capacities {caps})")
    B, S = x.shape[-1], kd.S
    R, C, O = r_rows(kd), kd.N + 5, max(kd.O, 1)
    _check("x", x, (dp_of(kd), B))
    _check("bnd", sc.bnd, (bnd_rows(kd), B))
    _check("misc", sc.misc, (misc_rows(kd), B))
    _check("corr_n", sc.corr_n, (kd.H, 2, S * R, B))
    _check("corr_p", sc.corr_p, (kd.H, 2, S * R, B))
    _check("corr_m", sc.corr_m, (kd.H, S * R, B))
    _check("obs_c", sc.obs_c, (O, 2, 6 * kd.Po, B))
    _check("P", kc.P, (S, 3, R, C))
    _check("gridc", kc.gridc, (S, 2, R, 1))
    if kc.Q.shape[0] != S or kc.Q.shape[-1] != C or not kc.Q.is_cuda:
        raise ValueError(f"Q: shape {tuple(kc.Q.shape)}")
    return B, R, kd


def seg_rows(dims) -> list:
    """Sample rows the kernels keep per segment: its weighted rows, padded
    to a multiple of 8 (within r_rows); one segment keeps all r_rows, so
    that its constants are one flat copy."""
    R = r_rows(dims)
    if dims.S == 1:
        return [R]
    return [min(R, -(-seg_active(dims, s) // 8) * 8) for s in range(dims.S)]


def weight_vector(sw: StaticW, sigma, dims, max_s: int = MAX_S):
    """The kernels' weight vector (csrc/kcost.cuh WIdx order), computed in
    double on the host and rounded once to float32: the weights, hull and
    the class (segments, piece counts, rows kept, per-segment virtual-time
    sigma, capacity; `sigma` as EngineFlags.vt_scale takes it). `max_s`:
    the slots per field of the class, a build's kMaxS."""
    sig = resolve_vt_scale(sigma, dims.ns_tuple)
    vals = [sw.wei_obs, sw.wei_surround, sw.wei_feas, sw.wei_time,
            sw.max_forward_vel, sw.max_forward_acc, sw.max_forward_cur,
            sw.max_backward_vel, sw.max_backward_acc, sw.max_backward_cur,
            sw.mini_t, sw.epis, sw.lse_alpha, sw.cost_scale,
            (1.5 * sw.veh_len) ** 2,
            sw.surround_clearance + math.log(8.0) / sw.lse_alpha, sig[0]]
    vals += [v for xy in sw.le for v in xy]
    vals += [v for xy in sw.e_hat for v in xy]
    return vals + [sw.non_sinv] + _class_vector(dims, sig, max_s)


def _class_vector(dims, sig, max_s: int = MAX_S):
    """S, then per segment (max_s slots, the unused ones repeating
    segment 0) its pieces, rows kept and sigma, then the capacity of its
    kernel class."""
    pad = lambda v: list(v)[:max_s] + [v[0]] * (max_s - len(v))
    return [dims.S, *pad(dims.ns_tuple), *pad(seg_rows(dims)), *pad(sig),
            kernel_class(dims).N]


def _weights(lib, sw, sigma, dims):
    """weight_vector as the library's float array, laid out for the
    library's kMaxS (another build's may differ: chip_smoke.py --parent)."""
    return _floats(weight_vector(sw, sigma, dims, lib.dftpav_kernel_max_s()),
                   lib.dftpav_weight_len())


def lbfgs_vector(p, flags):
    """The kernels' L-BFGS parameter vector (csrc/solve.cuh LIdx order)."""
    return [p.delta, p.delta / max(p.past, 1), p.g_epsilon, p.min_step,
            p.max_step, p.f_dec_coeff, p.s_curv_coeff, p.cautious_factor,
            p.machine_prec, flags.adaptive_step_lo, flags.adaptive_step_mult]


def _floats(vals, n):
    if len(vals) != n:
        raise ValueError(f"parameter vector of {len(vals)} != {n}")
    return (ctypes.c_float * n)(*vals)


def _raise_on(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}: "
                           f"{lib.dftpav_error_string(rc).decode()}")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _scratch(lib, which, w, B, R, dims, mem, past, device):
    """The scratch buffer kernel `which` (0: A, 1: B) needs for this class
    and batch (csrc/kernels.cuh scratch_layout), or None for none."""
    n = ctypes.c_longlong(0)
    rc = lib.dftpav_scratch_bytes(which, ctypes.addressof(w), B, R, dims.H,
                                  dims.O, dims.Po, mem, past,
                                  ctypes.addressof(n))
    if rc != 0:
        raise NotImplementedError(
            f"the kernels cannot lay out the class {dims} (m={mem}, "
            f"past={past}): CUDA error {rc}: "
            f"{lib.dftpav_error_string(rc).decode()}")
    if n.value == 0:
        return None
    return torch.empty(n.value, dtype=torch.uint8, device=device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_eval_fg(x, sc: KScenario, kc: KConsts, sw: StaticW, dims,
                   sigma):
    """Kernel A: (f [B], g [DP, B]) at x [DP, B]. sigma: the virtual-time
    preconditioning, as EngineFlags.vt_scale takes it. dims: the class in
    its kernel layout (a KClass, or a Dims of capacity N)."""
    lib = library()
    B, R, kd = _check_inputs(lib, x, sc, kc, dims)
    Q = kc.Q[:, :kd.N + 5].contiguous()
    f = torch.empty(B, dtype=torch.float32, device=x.device)
    g = torch.empty_like(x)
    w = _weights(lib, sw, sigma, kd)
    scratch = _scratch(lib, 0, w, B, R, kd, 1, 0, x.device)
    rc = lib.dftpav_eval_fg(
        x.data_ptr(), sc.bnd.data_ptr(), sc.misc.data_ptr(),
        sc.corr_n.data_ptr(), sc.corr_p.data_ptr(), sc.corr_m.data_ptr(),
        sc.obs_c.data_ptr(), kc.P.data_ptr(), Q.data_ptr(),
        kc.gridc.data_ptr(), ctypes.addressof(w), B, R, kd.H, kd.O, kd.Po,
        f.data_ptr(), g.data_ptr(), _ptr(scratch), _stream())
    _raise_on(lib, rc, "dftpav_eval_fg")
    return f, g


def launch_solve_fused(x0, f0, g0, sc: KScenario, kc: KConsts, sw: StaticW,
                       dims, sigma, p, max_iter: int, flags):
    """Kernel B: the whole solve from (x0, f0, g0). Returns x [DP, B],
    f [B] and info [3, B] int32 (status, k clamped to max_iter, evals)."""
    return solve_fused_with(library(), x0, f0, g0, sc, kc, sw, dims, sigma, p,
                            max_iter, flags)


def solve_fused_with(lib, x0, f0, g0, sc: KScenario, kc: KConsts,
                     sw: StaticW, dims, sigma, p, max_iter: int, flags):
    """launch_solve_fused through the kernel library `lib` (from `load`).
    The L-BFGS memory and past window are p's (any m >= 1, past >= 0)."""
    m, past = int(p.mem_size), int(p.past)
    B, R, kd = _check_inputs(lib, x0, sc, kc, dims, m, past)
    _check("f0", f0, (B,))
    _check("g0", g0, tuple(x0.shape))
    Q = kc.Q[:, :kd.N + 5].contiguous()
    x = torch.empty_like(x0)
    f = torch.empty(B, dtype=torch.float32, device=x0.device)
    info = torch.empty((3, B), dtype=torch.int32, device=x0.device)
    w = _weights(lib, sw, sigma, kd)
    lp = _floats(lbfgs_vector(p, flags), lib.dftpav_lbfgs_len())
    # the persistent grid's lane counter (zeroed by the launch), the
    # half-planes' lane-major copy, and the constants and history where
    # they leave shared memory
    scratch = _scratch(lib, 1, w, B, R, kd, m, past, x0.device)
    rc = lib.dftpav_solve_fused(
        x0.data_ptr(), f0.data_ptr(), g0.data_ptr(), sc.bnd.data_ptr(),
        sc.misc.data_ptr(), sc.corr_n.data_ptr(), sc.corr_p.data_ptr(),
        sc.corr_m.data_ptr(), sc.obs_c.data_ptr(), kc.P.data_ptr(),
        Q.data_ptr(), kc.gridc.data_ptr(), ctypes.addressof(w),
        ctypes.addressof(lp), int(max_iter), int(p.max_linesearch), m, past,
        int(bool(flags.adaptive_step)), B, R, kd.H, kd.O, kd.Po,
        x.data_ptr(), f.data_ptr(), info.data_ptr(), _ptr(scratch),
        _stream())
    _raise_on(lib, rc, "dftpav_solve_fused")
    return x, f, info


def kernel_info(dims, which: str, mem: int = 16, past: int = 3) -> dict:
    """Registers, local memory, resident warps per SM, persistent-grid
    blocks and shared memory of kernel "A" or "B" on this card, and where
    the class constants and (B) the history of m = mem pairs lie, for the
    class `dims` in its kernel layout (the occupancy API; nothing is
    launched)."""
    lib = library()
    kd = kernel_class(dims)
    out = (ctypes.c_int * 8)()
    # the launch plan reads only the class at the vector's end
    cls = _class_vector(kd, (1.0,) * kd.S, lib.dftpav_kernel_max_s())
    w = _floats([0.0] * (lib.dftpav_weight_len() - len(cls)) + cls,
                lib.dftpav_weight_len())
    rc = lib.dftpav_kernel_info("AB".index(which), ctypes.addressof(w),
                                r_rows(kd), kd.O, kd.Po, mem, past, out)
    _raise_on(lib, rc, "dftpav_kernel_info")
    info = dict(zip(("registers", "local_bytes", "resident_warps_per_sm",
                     "blocks", "smem_bytes"), list(out)[:5]))
    info["consts"] = "global" if out[5] else "shared"
    info["history"] = ("none" if which == "A" else
                       "global" if out[6] else "shared")
    info["capacity"] = out[7]
    return info


def _check_penalty(lib, sig, dsig, wq, corr_n, corr_p, corr_mask, le):
    if corr_n.dim() != 4:
        raise ValueError(f"corr_n: need [H, 2, R, B], got {tuple(corr_n.shape)}")
    H, _, R, B = corr_n.shape
    if H > lib.dftpav_max_h():
        raise NotImplementedError(f"H={H} > {lib.dftpav_max_h()}")
    if len(le) != 4:
        raise NotImplementedError(f"the kernels take a 4-vertex hull, got "
                                  f"{len(le)} vertices")
    _check("sig", sig, (2, R, B))
    _check("dsig", dsig, (2, R, B))
    _check("wq", wq, (1, R, B))
    _check("corr_n", corr_n, (H, 2, R, B))
    _check("corr_p", corr_p, (H, 2, R, B))
    _check("corr_mask", corr_mask, (H, R, B))
    return R, B, H, _floats([v for xy in le for v in xy], 8)


def launch_corridor_fwd(sig, dsig, wq, corr_n, corr_p, corr_mask, le):
    """Kernel K2: the per-lane corridor cost [B] (ops/pallas_penalty.py
    layout; le: 4 hull vertices (x, y))."""
    lib = library()
    R, B, H, le_v = _check_penalty(lib, sig, dsig, wq, corr_n, corr_p,
                                   corr_mask, le)
    out = torch.empty(B, dtype=torch.float32, device=sig.device)
    rc = lib.dftpav_corridor_fwd(
        sig.data_ptr(), dsig.data_ptr(), wq.data_ptr(), corr_n.data_ptr(),
        corr_p.data_ptr(), corr_mask.data_ptr(), ctypes.addressof(le_v), R,
        B, H, out.data_ptr(), _stream())
    _raise_on(lib, rc, "dftpav_corridor_fwd")
    return out


def launch_corridor_bwd(sig, dsig, wq, corr_n, corr_p, corr_mask, le, gbar):
    """Kernel K3: (d_sig [2, R, B], d_dsig [2, R, B], d_wq [1, R, B]) for
    the per-lane cotangent gbar [B]."""
    lib = library()
    R, B, H, le_v = _check_penalty(lib, sig, dsig, wq, corr_n, corr_p,
                                   corr_mask, le)
    _check("gbar", gbar, (B,))
    d_sig = torch.empty_like(sig)
    d_dsig = torch.empty_like(dsig)
    d_wq = torch.empty_like(wq)
    rc = lib.dftpav_corridor_bwd(
        sig.data_ptr(), dsig.data_ptr(), wq.data_ptr(), corr_n.data_ptr(),
        corr_p.data_ptr(), corr_mask.data_ptr(), ctypes.addressof(le_v),
        gbar.data_ptr(), R, B, H, d_sig.data_ptr(), d_dsig.data_ptr(),
        d_wq.data_ptr(), _stream())
    _raise_on(lib, rc, "dftpav_corridor_bwd")
    return d_sig, d_dsig, d_wq
