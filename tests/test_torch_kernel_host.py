"""The CUDA kernels' per-lane code, compiled for the host, against the
port's plain PyTorch versions.

csrc/kcost.cuh (objective + hand-written gradient) and csrc/solve.cuh (the
per-lane L-BFGS round loop) are __host__ __device__ code. Here a small C
harness instantiates them for double and float with g++ (no GPU, no nvcc)
and runs them lane by lane:

  * float64 objective and gradient vs autograd: f rtol 1e-11,
    g rtol 1e-9 / atol 1e-9 (the JAX parity tolerances);
  * float32 objective and gradient vs float64 autograd: per lane
    |df|/|f| <= 1e-4 and max|dg| <= 1e-3 * max(1, max|g|) (the tolerance
    the card is held to: float32 with another summation order over 166 rows
    and the alpha=100 log-sum-exp);
  * float64 round loop vs the plain round loop, 12 iterations: statuses, k,
    eval counts exact, fp rtol 1e-10, xp rtol 1e-9 / atol 1e-10.

Skips where g++ is absent. The harness is a test tool only; the package
never builds or loads it.
"""

import ctypes
import dataclasses
import functools
import hashlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dftpav_tpu_torch import scenarios
from dftpav_tpu_torch.config import EngineFlags, PlannerConfig
from dftpav_tpu_torch.ops import _cuda, kcost, pallas_solve
from dftpav_tpu_torch.types import Dims, Scenario, from_numpy, \
    weights_from_config

torch.set_num_threads(1)

DIMS = Dims(S=1, N=8, K=16, Kdes=32, H=4, O=2, Po=8)

HARNESS = r"""
#include "kcost.cuh"
#include "solve.cuh"
using namespace dftpav;

template <class T>
static Slabs<T> slabs(const T* bnd, const T* misc, const T* cn, const T* cp,
                      const T* cm, const T* obs, int B, int R, int H, int O,
                      int Po) {
  Slabs<T> s;
  s.bnd = bnd; s.misc = misc; s.cn = cn; s.cp = cp; s.cm = cm; s.obs = obs;
  s.B = B; s.R = R; s.H = H; s.O = O; s.Po = Po;
  return s;
}

template <class T>
static void eval_all(const T* x, const T* bnd, const T* misc, const T* cn,
                     const T* cp, const T* cm, const T* obs, const T* P,
                     const T* Q, const T* gridc, const double* wts, int B,
                     int R, int H, int O, int Po, T* f, T* g) {
  const KW<T> w = make_kw<T>(wts);
  const Slabs<T> s = slabs(bnd, misc, cn, cp, cm, obs, B, R, H, O, Po);
  const int DP = KDims<8>::DP;
  for (int lane = 0; lane < B; ++lane) {
    T xl[KDims<8>::DP], gl[KDims<8>::DP];
    for (int i = 0; i < DP; ++i) xl[i] = x[i * B + lane];
    f[lane] = lane_fg<T, 8>(xl, gl, s, lane, P, Q, gridc, w);
    for (int i = 0; i < DP; ++i) g[i * B + lane] = gl[i];
  }
}

template <class T>
static void solve_all(const T* x0, const T* f0, const T* g0, const T* bnd,
                      const T* misc, const T* cn, const T* cp, const T* cm,
                      const T* obs, const T* P, const T* Q, const T* gridc,
                      const double* wts, const double* lbp, int max_iter,
                      int max_ls, int past, int adaptive, int B, int R, int H,
                      int O, int Po, T* x_out, T* f_out, int* info) {
  const KW<T> w = make_kw<T>(wts);
  const LP<T> p = make_lp<T>(lbp, max_iter, max_ls, past, adaptive);
  const Slabs<T> s = slabs(bnd, misc, cn, cp, cm, obs, B, R, H, O, Po);
  const int DP = KDims<8>::DP;
  for (int lane = 0; lane < B; ++lane) {
    T xl[KDims<8>::DP], gl[KDims<8>::DP], xo[KDims<8>::DP];
    for (int i = 0; i < DP; ++i) {
      xl[i] = x0[i * B + lane];
      gl[i] = g0[i * B + lane];
    }
    const SolveOut o = lane_solve<T, 8>(xl, f0[lane], gl, s, lane, P, Q,
                                        gridc, w, p, xo, &f_out[lane]);
    for (int i = 0; i < DP; ++i) x_out[i * B + lane] = xo[i];
    info[lane] = o.status;
    info[B + lane] = o.k;
    info[2 * B + lane] = o.n_evals;
  }
}

#define DEF(T, SUF)                                                        \
  extern "C" void eval_##SUF(const T* x, const T* bnd, const T* misc,      \
      const T* cn, const T* cp, const T* cm, const T* obs, const T* P,     \
      const T* Q, const T* gridc, const double* wts, int B, int R, int H,  \
      int O, int Po, T* f, T* g) {                                          \
    eval_all<T>(x, bnd, misc, cn, cp, cm, obs, P, Q, gridc, wts, B, R, H,  \
                O, Po, f, g);                                              \
  }                                                                        \
  extern "C" void solve_##SUF(const T* x0, const T* f0, const T* g0,       \
      const T* bnd, const T* misc, const T* cn, const T* cp, const T* cm,  \
      const T* obs, const T* P, const T* Q, const T* gridc,                \
      const double* wts, const double* lbp, int max_iter, int max_ls,      \
      int past, int adaptive, int B, int R, int H, int O, int Po,          \
      T* x_out, T* f_out, int* info) {                                      \
    solve_all<T>(x0, f0, g0, bnd, misc, cn, cp, cm, obs, P, Q, gridc, wts, \
                 lbp, max_iter, max_ls, past, adaptive, B, R, H, O, Po,    \
                 x_out, f_out, info);                                      \
  }
DEF(double, f64)
DEF(float, f32)
"""


@functools.lru_cache(maxsize=None)
def _harness():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available to build the host harness")
    srcs = sorted(_cuda.CSRC.glob("*.cuh"))
    h = hashlib.sha256(HARNESS.encode())
    for s in srcs:
        h.update(s.read_bytes())
    so = _cuda.BUILD_DIR / f"libhost_harness_{h.hexdigest()[:16]}.so"
    if not so.exists():
        _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = so.with_suffix(".cpp")
        src.write_text(HARNESS)
        tmp = so.with_suffix(".tmp")
        subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                        "-I", str(_cuda.CSRC), "-o", str(tmp), str(src)],
                       check=True, capture_output=True, text=True)
        tmp.replace(so)
    return ctypes.CDLL(str(so))


def _ptr(t):
    assert t.is_contiguous()
    return ctypes.c_void_p(t.data_ptr())


def _doubles(vals):
    return (ctypes.c_double * len(vals))(*vals)


@functools.lru_cache(maxsize=None)
def _setup(B=16, seed=3, sigma=1.0):
    cfg = PlannerConfig()
    w = weights_from_config(cfg.opt, torch.float64, device="cpu")
    batch = from_numpy(scenarios.batch_scenarios(DIMS, B, seed=seed,
                                                 n_obstacles=2),
                       Scenario, device="cpu", dtype=torch.float64)
    _b, x0p, sc, kc, D = pallas_solve._prep(batch, w, DIMS, torch.float64,
                                            sigma)
    sw = kcost.StaticW.build(w, cfg)
    # move half of the lanes off the initial guess (seeded), a quarter of
    # them far enough to leave their corridors
    x = x0p.clone()
    rng = np.random.default_rng(23)
    scale = np.where(np.arange(B) >= 3 * B // 4, 4.0, 0.4)[B // 2:]
    x[:D, B // 2:] += torch.from_numpy(
        scale * rng.standard_normal((D, B - B // 2)))
    return cfg, sw, sc, kc, x0p, x, D


def _host_eval(x, sc, kc, sw, sigma, dtype):
    lib = _harness()
    fn = lib.eval_f64 if dtype == torch.float64 else lib.eval_f32
    c = lambda t: t.to(dtype).contiguous()
    xs, scs = c(x), [c(a) for a in sc]
    P, Q, G = c(kc.P), c(kc.Q[0, :DIMS.N + 5]), c(kc.gridc)
    B = x.shape[1]
    f = torch.empty(B, dtype=dtype)
    g = torch.empty_like(xs)
    w = _doubles(_cuda.weight_vector(sw, sigma))
    fn(_ptr(xs), *(_ptr(a) for a in scs), _ptr(P), _ptr(Q), _ptr(G), w, B,
       kcost.r_rows(DIMS), DIMS.H, DIMS.O, DIMS.Po, _ptr(f), _ptr(g))
    return f, g


@pytest.mark.parametrize("vt", [1.0, "auto"])
def test_hand_gradient_f64_matches_autograd(vt):
    flags = EngineFlags(vt_scale=vt)
    sigma = 0.25 if vt == "auto" else 1.0
    cfg, sw, sc, kc, x0p, x, D = _setup(sigma=sigma)
    f_ref, g_ref = kcost.eval_fg(x, sc, kc, sw, DIMS, flags)
    f, g = _host_eval(x, sc, kc, sw, sigma, torch.float64)
    np.testing.assert_allclose(f.numpy(), f_ref.numpy(), rtol=1e-11)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=1e-9,
                               atol=1e-9)
    assert not torch.any(g[D:])


def test_hand_gradient_f32_within_card_tolerance():
    cfg, sw, sc, kc, x0p, x, D = _setup()
    f_ref, g_ref = kcost.eval_fg(x, sc, kc, sw, DIMS)
    f, g = _host_eval(x, sc, kc, sw, 1.0, torch.float32)
    rel = (f.double() - f_ref).abs() / f_ref.abs()
    assert float(rel.max()) <= 1e-4, rel
    gmax = g_ref.abs().amax(dim=0).clamp(min=1.0)
    dg = (g.double() - g_ref).abs().amax(dim=0)
    assert bool((dg <= 1e-3 * gmax).all()), (dg / gmax)


def _host_solve(x0, f0, g0, sc, kc, sw, sigma, p, max_iter, flags, dtype):
    lib = _harness()
    fn = lib.solve_f64 if dtype == torch.float64 else lib.solve_f32
    c = lambda t: t.to(dtype).contiguous()
    B = x0.shape[1]
    xs, fs, gs = c(x0), c(f0), c(g0)
    scs = [c(a) for a in sc]
    P, Q, G = c(kc.P), c(kc.Q[0, :DIMS.N + 5]), c(kc.gridc)
    x = torch.empty_like(xs)
    f = torch.empty(B, dtype=dtype)
    info = torch.empty((3, B), dtype=torch.int32)
    fn(_ptr(xs), _ptr(fs), _ptr(gs), *(_ptr(a) for a in scs), _ptr(P),
       _ptr(Q), _ptr(G), _doubles(_cuda.weight_vector(sw, sigma)),
       _doubles(_cuda.lbfgs_vector(p, flags)), max_iter, p.max_linesearch,
       p.past, int(flags.adaptive_step), B, kcost.r_rows(DIMS), DIMS.H,
       DIMS.O, DIMS.Po, _ptr(x), _ptr(f), _ptr(info))
    return x, f, info


@pytest.mark.parametrize("tuned", [False, True])
def test_host_solve_f64_matches_round_loop_12_iterations(tuned):
    flags = EngineFlags.tuned() if tuned else EngineFlags()
    sigma = 0.25 if tuned else 1.0
    cfg, sw, sc, kc, x0p, _x, D = _setup(sigma=sigma)
    p = cfg.opt.lbfgs
    ref = pallas_solve._solve_rounds(x0p, sc, kc, sw, DIMS, p, 12, flags)
    f0, g0 = kcost.eval_fg(x0p, sc, kc, sw, DIMS, flags)
    x, f, info = _host_solve(x0p, f0, g0, sc, kc, sw, sigma, p, 12, flags,
                             torch.float64)
    np.testing.assert_array_equal(info[0].numpy(), ref.status.numpy())
    np.testing.assert_array_equal(info[1].numpy(),
                                  ref.k.clamp(max=12).numpy())
    np.testing.assert_array_equal(info[2].numpy(), ref.n_evals.numpy())
    np.testing.assert_allclose(f.numpy(), ref.fp.numpy(), rtol=1e-10)
    np.testing.assert_allclose(x.numpy(), ref.xp.numpy(), rtol=1e-9,
                               atol=1e-10)


def test_host_solve_f32_converges_like_round_loop():
    """float32 whole solves (the card's arithmetic) reach the plain float64
    loop's quality on the bench flags: usable statuses and a cost p50
    within 2%. Single lanes may land in other basins either way (float
    paths drift apart), so the median needs a few dozen lanes."""
    flags = EngineFlags.tuned()
    cfg, sw, sc, kc, x0p, _x, D = _setup(B=64, sigma=0.25)
    p = dataclasses.replace(cfg.opt.lbfgs)
    ref = pallas_solve._solve_rounds(x0p, sc, kc, sw, DIMS, p, 150, flags)
    f0, g0 = _host_eval(x0p, sc, kc, sw, 0.25, torch.float32)
    x, f, info = _host_solve(x0p, f0, g0, sc, kc, sw, 0.25, p, 150, flags,
                             torch.float32)
    assert bool((info[0] >= 0).all()), info[0]
    med, med_ref = float(f.double().median()), float(ref.fp.median())
    assert abs(med - med_ref) <= 0.02 * abs(med_ref), (med, med_ref)
