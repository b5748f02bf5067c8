"""The corridor penalty (ops/pallas_penalty.py; kernels K2 and K3 on the
card) against the JAX package and against itself, float64 unless stated,
one torch thread.

  * CorridorPenalty forward and backward (the plain pair on CPU tensors)
    against JAX pallas_penalty.corridor_penalty in interpret mode on the
    same inputs: cost rtol 1e-12; d_sig, d_dsig, d_wq atol 1e-10.
  * The plain closed-form backward against autograd of the plain forward.
  * The half-plane count comes from the tensors: at H = 6 the forward is the
    sum of its H = 4 and H = 2 parts (the JAX kernels assume H == 4).
  * csrc/penalty.cuh, the kernels' per-row code, compiled with g++ for the
    host: in double against the plain pair (rtol 1e-12 / atol 1e-12), and in
    float against the float64 plain pair (per lane |df| <= 1e-4 |f|; per
    lane and gradient max|d - d64| <= 1e-3 max(1, the lane's max|d64|)).

Inputs are the bench class's sampled trajectory (ops.bcost.samples_b) in the
kernel layout, B = 8, half of the lanes moved off the initial guess so that
the hinges are active; one row has |dsig| = 0, where the unit velocity uses
the clamped norm.
"""

import ctypes
import functools
import hashlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dftpav_tpu.ops import pallas_penalty as jpp

from dftpav_tpu_torch import config, cost, scenarios
from dftpav_tpu_torch.ops import _cuda, bcost, pallas_penalty
from dftpav_tpu_torch.types import Dims, Scenario, from_numpy, \
    weights_from_config

torch.set_num_threads(1)

DIMS = Dims(S=1, N=8, K=16, Kdes=32, H=4, O=2, Po=8)
B = 8


@functools.lru_cache(maxsize=None)
def _inputs():
    """Kernel-layout operands (numpy float64), the hull and a cotangent."""
    cfg = config.PlannerConfig()
    w = weights_from_config(cfg.opt, torch.float64, device="cpu")
    batch = from_numpy(scenarios.batch_scenarios(DIMS, B, seed=3,
                                                 n_obstacles=2),
                       Scenario, device="cpu", dtype=torch.float64)
    x = cost.initial_guess(batch, w, DIMS).T.clone()
    rng = np.random.default_rng(29)
    x[:, B // 2:] += torch.from_numpy(
        5.0 * rng.standard_normal((x.shape[0], B - B // 2)))
    bm = bcost.to_bminor(batch)
    sp = bcost.samples_b(x, bm, w, DIMS)
    ops = pallas_penalty.kernel_layout(sp.sig, sp.dsig, sp.sgl, sp.wq,
                                       bm.corr_n, bm.corr_p, bm.corr_mask,
                                       w.wei_obs)
    ops = [a.numpy().copy() for a in ops]
    ops[1][:, 0, 0] = 0.0                 # a zero velocity (wq = 0 there)
    le = pallas_penalty.hull_tuple(cost.hull_arrays(cfg)[0])
    gbar = rng.uniform(0.5, 2.0, B)
    return ops, le, gbar


@functools.lru_cache(maxsize=None)
def _jax_ref():
    ops, le, gbar = _inputs()
    sig, dsig, wq, cn, cp, cm = (jnp.asarray(a) for a in ops)
    f, vjp = jax.vjp(lambda s, d, q: jpp.corridor_penalty(
        s, d, q, cn, cp, cm, le, True), sig, dsig, wq)
    return np.asarray(f), [np.asarray(a) for a in vjp(jnp.asarray(gbar))]


def _port(ops, le, gbar):
    t = [torch.from_numpy(a) for a in ops]
    for a in t[:3]:
        a.requires_grad_(True)
    f = pallas_penalty.CorridorPenalty.apply(*t, le)
    grads = torch.autograd.grad(f, t[:3], grad_outputs=torch.from_numpy(gbar))
    return f.detach().numpy(), [g.numpy() for g in grads]


def test_corridor_penalty_matches_jax_interpret():
    ops, le, gbar = _inputs()
    f_ref, g_ref = _jax_ref()
    launches = (pallas_penalty.corridor_fwd.launches,
                pallas_penalty.corridor_bwd.launches)
    f, grads = _port(ops, le, gbar)
    assert (pallas_penalty.corridor_fwd.launches,
            pallas_penalty.corridor_bwd.launches) == launches  # CPU: plain
    assert (f_ref > 0).sum() >= B // 2 and (f_ref == 0).any()
    np.testing.assert_allclose(f, f_ref, rtol=1e-12)
    for name, g, r in zip(("d_sig", "d_dsig", "d_wq"), grads, g_ref):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-10, err_msg=name)
    # d_wq is the hinge sum on every row, weighted or not
    assert (grads[2][0][ops[2][0] == 0] != 0).any()


def test_plain_backward_is_autograd_of_plain_forward():
    ops, le, gbar = _inputs()
    t = [torch.from_numpy(a) for a in ops]
    for a in t[:3]:
        a.requires_grad_(True)
    f = pallas_penalty.corridor_penalty_plain_fwd(*t, le)
    auto = torch.autograd.grad(f, t[:3], grad_outputs=torch.from_numpy(gbar))
    closed = pallas_penalty.corridor_penalty_plain_bwd(
        *(a.detach() for a in t), le, torch.from_numpy(gbar))
    # the row with |dsig| = 0 takes the clamped norm, whose derivative the
    # closed form does not follow; it carries no weight, so d_dsig is 0 there
    for a, c in zip(auto, closed):
        np.testing.assert_allclose(c.numpy(), a.numpy(), rtol=1e-10,
                                   atol=1e-10)


def test_forward_loops_over_the_tensors_half_planes():
    ops, le, _ = _inputs()
    sig, dsig, wq, cn, cp, cm = (torch.from_numpy(a) for a in ops)
    extra = slice(0, 2)                  # two more half-planes: H = 6
    cn6 = torch.cat([cn, -cn[extra]])
    cp6 = torch.cat([cp, cp[extra] - 0.5 * cn[extra]])
    cm6 = torch.cat([cm, cm[extra]])
    f6 = pallas_penalty.corridor_penalty_plain_fwd(sig, dsig, wq, cn6, cp6,
                                                   cm6, le)
    f4 = pallas_penalty.corridor_penalty_plain_fwd(sig, dsig, wq, cn, cp, cm,
                                                   le)
    f2 = pallas_penalty.corridor_penalty_plain_fwd(
        sig, dsig, wq, cn6[4:], cp6[4:], cm6[4:], le)
    assert bool((f2 > 0).any())
    np.testing.assert_allclose(f6.numpy(), (f4 + f2).numpy(), rtol=1e-13)


HARNESS = r"""
#include "penalty.cuh"
using namespace dftpav;

template <class T>
static PenaltyArgs<T> args(const T* sig, const T* dsig, const T* wq,
                           const T* cn, const T* cp, const T* cm,
                           const double* le, int R, int B, int H) {
  PenaltyArgs<T> a;
  a.sig = sig; a.dsig = dsig; a.wq = wq; a.cn = cn; a.cp = cp; a.cm = cm;
  for (int e = 0; e < 4; ++e)
    for (int j = 0; j < 2; ++j) a.le[e][j] = T(le[2 * e + j]);
  a.R = R; a.B = B; a.H = H;
  return a;
}

#define DEF(T, SUF)                                                        \
  extern "C" void fwd_##SUF(const T* sig, const T* dsig, const T* wq,      \
      const T* cn, const T* cp, const T* cm, const double* le, int R,      \
      int B, int H, T* out) {                                              \
    const PenaltyArgs<T> a = args(sig, dsig, wq, cn, cp, cm, le, R, B, H); \
    for (int b = 0; b < B; ++b) {                                          \
      double acc = 0.0;                                                    \
      for (int r = 0; r < R; ++r) acc += double(corridor_fwd_row(a, r, b)); \
      out[b] = T(acc);                                                     \
    }                                                                      \
  }                                                                        \
  extern "C" void bwd_##SUF(const T* sig, const T* dsig, const T* wq,      \
      const T* cn, const T* cp, const T* cm, const double* le,             \
      const T* gbar, int R, int B, int H, T* d_sig, T* d_dsig, T* d_wq) {  \
    const PenaltyArgs<T> a = args(sig, dsig, wq, cn, cp, cm, le, R, B, H); \
    for (int r = 0; r < R; ++r)                                            \
      for (int b = 0; b < B; ++b)                                          \
        corridor_bwd_row(a, r, b, gbar[b], d_sig, d_dsig, d_wq);           \
  }
DEF(double, f64)
DEF(float, f32)
"""


@functools.lru_cache(maxsize=None)
def _harness():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available to build the host harness")
    h = hashlib.sha256(HARNESS.encode())
    for name in ("common.cuh", "penalty.cuh"):
        h.update((_cuda.CSRC / name).read_bytes())
    so = _cuda.BUILD_DIR / f"libpenalty_harness_{h.hexdigest()[:16]}.so"
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


def _host(ops, le, gbar, dtype):
    """The harness's (f, (d_sig, d_dsig, d_wq)) in `dtype`."""
    lib = _harness()
    suf = "f64" if dtype == torch.float64 else "f32"
    t = [torch.from_numpy(a).to(dtype).contiguous() for a in ops]
    H, _, R, Bn = t[3].shape
    lev = (ctypes.c_double * 8)(*[v for xy in le for v in xy])
    f = torch.empty(Bn, dtype=dtype)
    getattr(lib, f"fwd_{suf}")(*map(_ptr, t), lev, R, Bn, H, _ptr(f))
    g = torch.from_numpy(gbar).to(dtype)
    outs = [torch.empty_like(t[0]), torch.empty_like(t[1]),
            torch.empty_like(t[2])]
    getattr(lib, f"bwd_{suf}")(*map(_ptr, t), lev, _ptr(g), R, Bn, H,
                               *map(_ptr, outs))
    return f, outs


def _plain(ops, le, gbar):
    t = [torch.from_numpy(a) for a in ops]
    return (pallas_penalty.corridor_penalty_plain_fwd(*t, le),
            pallas_penalty.corridor_penalty_plain_bwd(
                *t, le, torch.from_numpy(gbar)))


def test_host_kernel_code_f64_matches_plain():
    ops, le, gbar = _inputs()
    f, grads = _host(ops, le, gbar, torch.float64)
    f_p, g_p = _plain(ops, le, gbar)
    np.testing.assert_allclose(f.numpy(), f_p.numpy(), rtol=1e-12, atol=1e-12)
    for g, r in zip(grads, g_p):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_host_kernel_code_f64_at_six_half_planes():
    ops, le, gbar = _inputs()
    ops6 = list(ops)
    for i, flip in ((3, -1.0), (4, 1.0), (5, 1.0)):
        ops6[i] = np.concatenate([ops[i], flip * ops[i][:2]])
    f, grads = _host(ops6, le, gbar, torch.float64)
    f_p, g_p = _plain(ops6, le, gbar)
    np.testing.assert_allclose(f.numpy(), f_p.numpy(), rtol=1e-12, atol=1e-12)
    for g, r in zip(grads, g_p):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_host_kernel_code_f32_within_card_tolerance():
    ops, le, gbar = _inputs()
    f, grads = _host(ops, le, gbar, torch.float32)
    f_p, g_p = _plain(ops, le, gbar)
    df = (f.double() - f_p).abs()
    assert bool((df <= 1e-4 * f_p.abs()).all()), (df, f_p)
    for g, r in zip(grads, g_p):
        # per lane: the lane's max error over its own max(1, max|d|)
        err = (g.double() - r).abs().amax(dim=(0, 1))
        scale = r.abs().amax(dim=(0, 1)).clamp(min=1.0)
        assert bool((err <= 1e-3 * scale).all()), err / scale
