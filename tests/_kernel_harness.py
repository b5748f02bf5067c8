"""The CUDA kernels' per-lane code, compiled for the host with g++.

csrc/kcost.cuh (objective + hand-written gradient) and csrc/solve.cuh (the
per-lane L-BFGS round loop) are __host__ __device__ code. HARNESS
instantiates them for double and float, at a capacity N (8 or 16: the
layout kernels.cuh runs a class in, each segment reading its own piece
count at run time) and S segments, and runs them lane by lane as a team
(csrc/team.cuh) of one member (the Solo path) or of 32 members run in turn,
the card's one warp per lane. The history of m pairs lies where the card
puts it: in the lane's scratch (the warp's slice) up to kMemShared pairs,
in a per-lane scratch [B][hist_floats] above (solve.cuh lane_history).

Skips where g++ is absent. A test tool only; the package never builds or
loads it.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import pytest
import torch

from dftpav_tpu_torch.ops import _cuda, kcost

HARNESS = r"""
#include <vector>
#include "kcost.cuh"
#include "solve.cuh"
using namespace dftpav;

// One lane's scratch, as a warp's slice of shared memory holds it on the
// card, and the class constants: per segment its rows_s weighted rows of
// the sample maps (also in double), quadrature rows and jerk form, as the
// kernels stage them.
template <class T, int G, int N, int S>
struct Lane {
  typedef KDims<N, S> Dm;
  static constexpr int kC = Dm::C, kK = kSlots<S>;
  std::vector<double> Pd[kK];
  std::vector<T> Pc[kK], gc[kK];
  std::vector<T> bnd, lm, obs, hist, pf;
  std::vector<ObsLane<T>> ol;
  std::vector<NearPair<T>> ring;
  T x[Dm::DP], g[Dm::DP], qr[2 * kC], acc[Dm::ACC * G], sb[12], gb[8];
  double rhs[2 * kC];
  LaneS<T, S> L;
  SolverMem<T> M;
  Lane(const T* P, const T* Q, const T* gridc, const KWS<T, S>& w, int R,
       int H, int O, int Po, int m, int past)
      : bnd(12 * S), lm(2 * S), obs(12 * O * Po + 1), ol(O + 1),
        ring(2 * G) {
    for (int s = 0; s < kK; ++s) {
      const int q = s < S ? s : 0, rs = w.rs[q];
      Pd[s].resize(3 * rs * kC);
      Pc[s].resize(3 * rs * kC);
      gc[s].resize(2 * rs);
      for (int o = 0; o < 3; ++o)
        for (int i = 0; i < rs * kC; ++i) {
          const T v = P[((size_t)q * 3 + o) * R * kC + i];
          Pc[s][o * rs * kC + i] = v;
          Pd[s][o * rs * kC + i] = double(v);
        }
      for (int o = 0; o < 2; ++o)
        for (int r = 0; r < rs; ++r)
          gc[s][o * rs + r] = gridc[((size_t)q * 2 + o) * R + r];
      L.Pds[s] = Pd[s].data(); L.Ps[s] = Pc[s].data();
      L.gridcs[s] = gc[s].data(); L.Qs[s] = Q + (size_t)q * kC * kC;
    }
    L.H = H; L.O = O; L.Po = Po; L.seg_rows = R;
    L.bnd_lane = bnd.data(); L.lm = lm.data(); L.obs = obs.data();
    L.ol = ol.data(); L.x = x; L.g = g; L.rhs = rhs; L.qr = qr;
    L.ring = ring.data(); L.acc = acc; L.sb = sb; L.gb = gb;
    // the slice's history (the card's layout: s, y, ys, alpha in a row)
    M.m = m;
    hist.resize(m <= kMemShared ? hist_floats(m, Dm::DP) : 1);
    if (m <= kMemShared) lane_history(M, hist.data(), 0, Dm::DP);
    pf.resize(past > kPastSlots ? past : kPastSlots);
    M.pf = pf.data();
  }
  void stage(const Slabs<T>& s, int lane) {
    stage_lane<S>(HostTeam<G, Dm::DP>(), s, lane, bnd.data(), lm.data(),
                  obs.data(), ol.data());
  }
};

template <class T>
static Slabs<T> slabs(const T* bnd, const T* misc, const T* cn, const T* cp,
                      const T* cm, const T* obs, int B, int R, int H, int O,
                      int Po, int S) {
  Slabs<T> s;
  s.bnd = bnd; s.misc = misc; s.cn = cn; s.cp = cp; s.cm = cm; s.obs = obs;
  s.B = B; s.R = R; s.H = H; s.O = O; s.Po = Po; s.S = S;
  return s;
}

// kernel A's mapping: half-planes read from the slabs
template <class T, int G, int N, int S>
static void eval_all(const T* x, const T* bnd, const T* misc, const T* cn,
                     const T* cp, const T* cm, const T* obs, const T* P,
                     const T* Q, const T* gridc, const double* wts, int B,
                     int R, int H, int O, int Po, T* f, T* g) {
  typedef KDims<N, S> Dm;
  const KWS<T, S> w = make_kw<T, kSlots<S>>(wts);
  const Slabs<T> s = slabs(bnd, misc, cn, cp, cm, obs, B, R, H, O, Po, S);
  Lane<T, G, N, S> ln(P, Q, gridc, w, R, H, O, Po, 0, 0);
  for (int lane = 0; lane < B; ++lane) {
    ln.stage(s, lane);
    ln.L.planes_lane = planes_slab(s, lane);
    ln.L.plane_row = (size_t)B;
    if (S == 1) select_segment<T, N, S>(ln.L, w, 0);
    for (int i = 0; i < Dm::DP; ++i) ln.x[i] = x[i * B + lane];
    f[lane] = lane_eval<T, N, S>(HostTeam<G, Dm::DP>(), ln.L, w);
    for (int i = 0; i < Dm::DP; ++i) g[i * B + lane] = ln.g[i];
  }
}

// kernel B's mapping: half-planes read from the lane-major copy, the
// history in the slice or, past kMemShared pairs, in a per-lane scratch
template <class T, int G, int N, int S>
static void solve_all(const T* x0, const T* f0, const T* g0, const T* bnd,
                      const T* misc, const T* cn, const T* cp, const T* cm,
                      const T* obs, const T* P, const T* Q, const T* gridc,
                      const double* wts, const double* lbp, int max_iter,
                      int max_ls, int mem, int past, int adaptive, int B,
                      int R, int H, int O, int Po, T* x_out, T* f_out,
                      int* info) {
  typedef KDims<N, S> Dm;
  const KWS<T, S> w = make_kw<T, kSlots<S>>(wts);
  const LP<T> p = make_lp<T>(lbp, max_iter, max_ls, mem, past, adaptive);
  const Slabs<T> s = slabs(bnd, misc, cn, cp, cm, obs, B, R, H, O, Po, S);
  const int RS = S * R;
  std::vector<T> copy((size_t)B * 5 * H * RS + 1);
  for (int b = 0; b < B; ++b)
    for (int q = 0; q < 5 * H; ++q)
      for (int r = 0; r < RS; ++r)
        copy[((size_t)b * 5 * H + q) * RS + r] =
            lane_major_src(s, q)[(size_t)r * B + b];
  const bool global = mem > kMemShared;
  std::vector<T> ghist(global ? (size_t)B * hist_floats(mem, Dm::DP) : 1);
  Lane<T, G, N, S> ln(P, Q, gridc, w, R, H, O, Po, mem, past);
  for (int lane = 0; lane < B; ++lane) {
    ln.stage(s, lane);
    ln.L.planes_lane = planes_lane_major(copy.data(), lane, H, RS);
    ln.L.plane_row = 1;
    if (S == 1) select_segment<T, N, S>(ln.L, w, 0);
    if (global) lane_history(ln.M, ghist.data(), lane, Dm::DP);
    T xl[Dm::DP], gl[Dm::DP], xo[Dm::DP];
    for (int i = 0; i < Dm::DP; ++i) {
      xl[i] = x0[i * B + lane];
      gl[i] = g0[i * B + lane];
    }
    // the card's choice of kernel: m fixed at compile time, or run-time m
    const SolveOut o =
        kFixedMem<N, S> > 0 && mem == kFixedMem<N, S>
            ? lane_solve<T, N, S, kFixedMem<N, S>>(HostTeam<G, Dm::DP>(),
                                                   ln.L, w, p, ln.M, xl,
                                                   f0[lane], gl, xo,
                                                   &f_out[lane])
            : lane_solve<T, N, S, 0>(HostTeam<G, Dm::DP>(), ln.L, w, p, ln.M,
                                     xl, f0[lane], gl, xo, &f_out[lane]);
    for (int i = 0; i < Dm::DP; ++i) x_out[i * B + lane] = xo[i];
    info[lane] = o.status;
    info[B + lane] = o.k;
    info[2 * B + lane] = o.n_evals;
  }
}

// the entry points of one instantiation (harness() appends one line each)
#define DEF(T, SUF, G, N, S)                                               \
  extern "C" void eval_##SUF##_g##G##_n##N##_s##S(const T* x,             \
      const T* bnd, const T* misc, const T* cn, const T* cp, const T* cm,  \
      const T* obs, const T* P, const T* Q, const T* gridc,                \
      const double* wts, int B, int R, int H, int O, int Po, T* f, T* g) { \
    eval_all<T, G, N, S>(x, bnd, misc, cn, cp, cm, obs, P, Q, gridc, wts,  \
                         B, R, H, O, Po, f, g);                            \
  }                                                                        \
  extern "C" void solve_##SUF##_g##G##_n##N##_s##S(const T* x0,           \
      const T* f0, const T* g0, const T* bnd, const T* misc, const T* cn,  \
      const T* cp, const T* cm, const T* obs, const T* P, const T* Q,      \
      const T* gridc, const double* wts, const double* lbp, int max_iter,  \
      int max_ls, int mem, int past, int adaptive, int B, int R, int H,    \
      int O, int Po, T* x_out, T* f_out, int* info) {                      \
    solve_all<T, G, N, S>(x0, f0, g0, bnd, misc, cn, cp, cm, obs, P, Q,    \
                          gridc, wts, lbp, max_iter, max_ls, mem, past,    \
                          adaptive, B, R, H, O, Po, x_out, f_out, info);   \
  }
"""

_CTYPE = {"f64": "double", "f32": "float"}


@functools.lru_cache(maxsize=None)
def harness(instances: tuple):
    """The harness library with the entry points eval_/solve_<dtype>_g<G>_
    n<N>_s<S> for each (dtype "f64" / "f32", G, N, S) of `instances` (each
    costs g++ seconds), built into the package's _build directory on first
    use, keyed by a hash of its source and the headers."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available to build the host harness")
    source = HARNESS + "".join(f"DEF({_CTYPE[t]}, {t}, {g}, {n}, {s})\n"
                               for t, g, n, s in instances)
    srcs = sorted(_cuda.CSRC.glob("*.cuh"))
    h = hashlib.sha256(source.encode())
    for s in srcs:
        h.update(s.read_bytes())
    so = _cuda.BUILD_DIR / f"libhost_harness_{h.hexdigest()[:16]}.so"
    if not so.exists():
        _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = os.getpid()
        src = so.with_suffix(f".{tag}.cpp")
        src.write_text(source)
        tmp = so.with_suffix(f".{tag}.tmp")
        subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                        "-I", str(_cuda.CSRC), "-o", str(tmp), str(src)],
                       check=True, capture_output=True, text=True)
        src.unlink()
        tmp.replace(so)
    return ctypes.CDLL(str(so))


_SUF = {torch.float64: "f64", torch.float32: "f32"}


def _ptr(t):
    assert t.is_contiguous()
    return ctypes.c_void_p(t.data_ptr())


def _doubles(vals):
    return (ctypes.c_double * len(vals))(*vals)


def _entry(kind, instances, dtype, G, kd):
    inst = (_SUF[dtype], G, kd.N, kd.S)
    assert inst in instances, (inst, instances)
    return getattr(harness(instances),
                   f"{kind}_{inst[0]}_g{G}_n{kd.N}_s{kd.S}")


def host_eval(x, sc, kc, sw, sigma, dtype, G, dims, instances):
    """The objective with kernel A's team mapping, G members per lane
    (1: the Solo path; 32: the card's warp, its members run in turn), for
    `dims` in its kernel layout (a KClass, or a Dims of capacity N), from
    the harness built for `instances`."""
    kd = kcost.kernel_class(dims)
    fn = _entry("eval", instances, dtype, G, kd)
    c = lambda t: t.to(dtype).contiguous()
    xs, scs = c(x), [c(a) for a in sc]
    P, Q, gc = c(kc.P), c(kc.Q[:, :kd.N + 5]), c(kc.gridc)
    B = x.shape[1]
    f = torch.empty(B, dtype=dtype)
    g = torch.empty_like(xs)
    w = _doubles(_cuda.weight_vector(sw, sigma, kd))
    fn(_ptr(xs), *(_ptr(a) for a in scs), _ptr(P), _ptr(Q), _ptr(gc), w, B,
       kcost.r_rows(kd), kd.H, kd.O, kd.Po, _ptr(f), _ptr(g))
    return f, g


def host_solve(x0, f0, g0, sc, kc, sw, sigma, p, max_iter, flags, dtype, G,
               dims, instances):
    """Kernel B's per-lane solve with G members per lane (as host_eval),
    reading the half-planes from the lane-major copy kernel B makes; the
    L-BFGS memory and past window are p's."""
    kd = kcost.kernel_class(dims)
    fn = _entry("solve", instances, dtype, G, kd)
    c = lambda t: t.to(dtype).contiguous()
    B = x0.shape[1]
    xs, fs, gs = c(x0), c(f0), c(g0)
    scs = [c(a) for a in sc]
    P, Q, gc = c(kc.P), c(kc.Q[:, :kd.N + 5]), c(kc.gridc)
    x = torch.empty_like(xs)
    f = torch.empty(B, dtype=dtype)
    info = torch.empty((3, B), dtype=torch.int32)
    fn(_ptr(xs), _ptr(fs), _ptr(gs), *(_ptr(a) for a in scs), _ptr(P),
       _ptr(Q), _ptr(gc), _doubles(_cuda.weight_vector(sw, sigma, kd)),
       _doubles(_cuda.lbfgs_vector(p, flags)), max_iter, p.max_linesearch,
       p.mem_size, p.past, int(flags.adaptive_step), B, kcost.r_rows(kd),
       kd.H, kd.O, kd.Po, _ptr(x), _ptr(f), _ptr(info))
    return x, f, info
