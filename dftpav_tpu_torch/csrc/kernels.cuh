// Hand-written Hopper kernels for the batched whole-solve, as templates on
// the class's capacity N and segments S; kernels.cu exports the plain C
// interface (loaded with ctypes by dftpav_tpu_torch/ops/_cuda.py), and it
// and kernels<N>_s<S..>.cu each instantiate some (N, S) (DFT_DEFINE_OPS),
// so that nvcc compiles them in parallel.
//
//   kernel A  eval_fg_kernel: objective + gradient for every lane
//             (replaces dftpav_tpu/ops/kcost.py eval_fg)
//   kernel B  solve_kernel: the whole L-BFGS solve for every lane
//             (replaces dftpav_tpu/ops/pallas_solve.py _kernel)
//
// Mapping: one warp per lane (scenario). The warp is a team of 32 members
// (team.cuh, kcost.cuh lane_eval): member m takes sample rows m, m + 32,
// ...; the (row, obstacle) pairs that may carry an obstacle penalty are
// packed by a ballot into batches of 32 and run through the dual-number
// obstacle block together; per-lane sums are xor-butterfly all-reduces and
// the gradient partials a reduce-scatter, so every member holds bitwise
// identical totals and takes identical solver decisions. The solver state
// leaves the registers: member m holds decision coordinate m % 16 of the
// iterate, gradient, direction and trial point (m, m + 32, ... for the
// classes whose decision vectors have 32 rows or more); the history pairs,
// the evaluated point, the rhs (in double), the lane's obstacle
// coefficients, the near-pair ring and the members' gradient partials sit
// in the warp's slice of shared memory, beside the block's copy of the
// sample maps (float and double), the jerk form and the quadrature rows:
// one copy per distinct piece count of the class's segments, each holding
// only its weighted rows.
//
// The class: capacity N (8, 16 or 32: the pieces per segment the decision
// vector and the rhs have room for) and S (1 to 8) are template
// arguments; each segment's own piece count (any n_s from 2 to N), rows and
// sigma are read at run time from the weight vector, so that every class
// with the same capacity and S runs the same code. The kernels of S <= 4
// hold four per-segment slots in their tables, those of S = 5 to 8 kMaxS
// (common.cuh kSlots). The L-BFGS memory m and past window are run-time
// arguments; at capacity 8 and S <= 4 kernel B is also built with m = 16
// fixed (solve.cuh kFixedMem), the main path's code.
//
// Where things live (place, decided per class on the host):
//   * the class constants stay in shared memory wherever they and at least
//     kMinWarps warp slices fit, and always at capacity 8 and S <= 4;
//     beyond (capacity 16: N = 16, and the multi-gear classes at N >= 12,
//     whose sample maps alone outgrow the 227 KB a block may have; and a
//     class of more than four segments whose distinct piece counts and
//     wider slices leave fewer warps), a small kernel writes them once per
//     launch into a global scratch in the same layout, and the warps read
//     them there (~240 KB at N = 16: resident in the card's 50 MB L2); at
//     capacity 32 always (~760 KB per distinct piece count of 32);
//   * the history stays in the warp's slice up to kMemShared pairs (so the
//     m = 16 classes keep the layout they always had) and lies in a
//     per-lane global scratch [B][hist_floats] above; at capacity 32 also
//     where a slice with it would leave fewer than kMinWarps warps (the
//     decision vectors of up to 528 rows make an m = 16 history 42 KB at
//     S = 5).
//
// Kernel B runs a persistent grid: as many blocks as fit on the card (the
// occupancy API; 16 warps each, fewer where a class's shared memory needs
// it; one block of 16 per SM at the bench class), each warp taking its
// next lane from a global counter (atomicAdd) whenever its lane exits, so
// no SM slot waits on a block's slowest lane and there are no waves. Which
// warp solves which lane changes from run to run; a lane's arithmetic does
// not, so two launches on the same inputs give bitwise identical outputs.
// Before it, a transpose copies the half-planes lane-major (kcost.cuh
// planes_lane_major), so that a warp reads its lane's rows in whole lines;
// the slabs are lane-minor, and the ~170 evaluations of a lane would
// otherwise fetch a 32-byte sector for every 4-byte value.
//
// Bound on the H100: instruction issue and latency, not bytes (PERF.md,
// Findings). The earlier design (8 threads per lane, 4 lanes per warp)
// lost 61% of its time to lanes waiting on each other, mostly through one
// lane's obstacle block; here each lane has its own warp, the obstacle
// block is convergent, and a separating-axis bound keeps the dual-number
// pass to the pairs that can have a penalty (~58 of ~224 in reach per
// evaluation). The code is kept small on purpose (loops rolled, one call
// site of the dual pass): unrolled, kernel B doubled to ~15,600 machine
// instructions and ran 2.8x slower, its 16 warps missing the instruction
// caches.
//
// A launch allocates nothing: the caller passes every output and one
// scratch buffer (scratch_layout: the lane counter, the lane-major
// half-planes, and the constants and history where they leave shared
// memory). Each entry point returns cudaGetLastError() after its launches.
#pragma once

#include <cuda_runtime.h>

#include "kcost.cuh"
#include "solve.cuh"

namespace dftpav {

struct Args {
  const float *x, *f0, *g0;
  const float *bnd, *misc, *cn, *cp, *cm, *obs;
  const float *P, *Q, *gridc;
  float *x_out, *f_out, *g_out;
  int* info;
  int* queue;        // kernel B's lane counter, zeroed by the launch
  float* planes;     // kernel B's lane-major half-planes [B][5 H][S R]
  unsigned char* consts;  // the class constants where they leave shared
                          // memory (Layout offsets), else null
  float* hist;       // kernel B's history [B][hist_floats] where it leaves
                     // shared memory, else null
  int B, R, H, O, Po, S;
  // the layout's run-time inputs besides the class (place): history pairs
  // (0 for kernel A), past window, constants and history in global memory
  int m, past, consts_global, hist_global;
};

// The host side of one instantiation (capacity N, S segments): launches
// of kernels A and B, their occupancy and the scratch they need
// (eval_s .. scratch_s below).
// Each takes the weight vector (W_LEN floats, the class at its end) and
// reads it with the instantiation's slots.
struct Ops {
  cudaError_t (*eval)(Args a, const float* wts, unsigned char* scratch,
                      cudaStream_t st);
  cudaError_t (*solve)(Args a, const float* wts, const LP<float>& lp,
                       unsigned char* scratch, cudaStream_t st);
  cudaError_t (*info)(int which, const float* wts, int O, int Po, int m,
                      int past, int* out);
  cudaError_t (*scratch)(int which, const float* wts, int B, int R, int H,
                         int O, int Po, int m, int past, size_t* bytes);
};

// ops_<N>_<S>(): each defined (DFT_DEFINE_OPS) in the source file that
// compiles that instantiation, so that nvcc builds them in parallel:
// kernels.cu capacity 8 at S = 1, 2, kernels8_s34.cu at S = 3, 4,
// kernels8_s56.cu and kernels8_s78.cu at S = 5 to 8, and
// kernels16_s<S..>.cu and kernels32_s<S..>.cu the same pairs of S at
// capacities 16 and 32.
#define DFT_DECLARE_OPS(N_, S_) Ops ops_##N_##_##S_();
DFT_DECLARE_OPS(8, 1) DFT_DECLARE_OPS(8, 2) DFT_DECLARE_OPS(8, 3)
DFT_DECLARE_OPS(8, 4) DFT_DECLARE_OPS(16, 1) DFT_DECLARE_OPS(16, 2)
DFT_DECLARE_OPS(16, 3) DFT_DECLARE_OPS(16, 4)
DFT_DECLARE_OPS(8, 5) DFT_DECLARE_OPS(8, 6) DFT_DECLARE_OPS(8, 7)
DFT_DECLARE_OPS(8, 8) DFT_DECLARE_OPS(16, 5) DFT_DECLARE_OPS(16, 6)
DFT_DECLARE_OPS(16, 7) DFT_DECLARE_OPS(16, 8)
DFT_DECLARE_OPS(32, 1) DFT_DECLARE_OPS(32, 2) DFT_DECLARE_OPS(32, 3)
DFT_DECLARE_OPS(32, 4) DFT_DECLARE_OPS(32, 5) DFT_DECLARE_OPS(32, 6)
DFT_DECLARE_OPS(32, 7) DFT_DECLARE_OPS(32, 8)
#undef DFT_DECLARE_OPS

namespace {

constexpr int kMaxWarps = 16;  // warps (lanes in flight) per block, at most
constexpr int kMaxThreads = 32 * kMaxWarps;
// Warps per block below which the class constants leave shared memory.
constexpr int kMinWarps = 4;

// Byte offsets of the class constants (per segment, K slots; segments with
// equal piece counts share theirs) from their base (shared memory, or the
// global scratch), and of a warp's slice in shared memory: the slices
// start at warp0 (after the constants when those are shared, else at 0).
template <int K>
struct Layout {
  size_t pd[K], p[K], q[K], gridc[K], consts, warp0, slice;
  size_t rhs, qr, x, g, bnd, lm, sb, gb, hs, hy, ys, alpha, pf, ol, ring,
      acc, obs;
  int m, consts_global, hist_global;
};

// The Layout of the kernels of S segments.
template <int S>
using LayoutS = Layout<kSlots<S>>;

__host__ __device__ inline size_t up16(size_t n) { return (n + 15) & ~(size_t)15; }

// The first segment with segment s's piece count (whose constants s uses).
template <int K>
__host__ __device__ inline int slot_of(const KW<float, K>& w, int s) {
  int j = 0;
  while (w.ns[j] != w.ns[s]) ++j;
  return j;
}

// Whether the class constants may lie in global memory: at capacities 16
// and 32, and in the classes of more than four segments (kernels A and B
// then read them through generic loads); at capacity 8 and S <= 4 they are
// always shared, which the compiler knows (shared-memory loads).
template <int N, int S>
constexpr bool kConstsMayLeave = N > 8 || S > 4;

// m: history pairs (0: none, kernel A); hist_global: they lie in the
// per-lane global scratch, not in the slice. The kernels compute their
// layout from the same inputs (kernel_layout), so that the offsets that
// are known at compile time (the class's capacity and S, and m for the
// kernels with m fixed) fold into the loads' immediates.
template <int N, int S>
__host__ __device__ inline LayoutS<S> layout(const KWS<float, S>& w, int O,
                                             int Po, int m, int past,
                                             bool consts_global,
                                             bool hist_global) {
  typedef KDims<N, S> Dm;
  const size_t C = Dm::C, DP = Dm::DP;
  LayoutS<S> l;
  size_t o = 0;
  if constexpr (S == 1) {        // one segment: all R rows, one flat copy
    const size_t R = (size_t)w.rs[0];
    l.pd[0] = 0;
    l.p[0] = l.pd[0] + 8 * 3 * R * C;
    l.q[0] = l.p[0] + 4 * 3 * R * C;
    l.gridc[0] = l.q[0] + 4 * C * C;
    o = up16(l.gridc[0] + 4 * 2 * R);
  } else {
    for (int s = 0; s < S; ++s) {
      const int j = slot_of(w, s);
      if (j < s) {
        l.pd[s] = l.pd[j]; l.p[s] = l.p[j]; l.q[s] = l.q[j];
        l.gridc[s] = l.gridc[j];
        continue;
      }
      const size_t rs = (size_t)w.rs[s];
      l.pd[s] = o;    o += 8 * 3 * rs * C;
      l.p[s] = o;     o += 4 * 3 * rs * C;
      l.q[s] = o;     o += 4 * C * C;
      l.gridc[s] = o; o += 4 * 2 * rs;
      o = up16(o);
    }
  }
  l.consts = o;
  l.warp0 = consts_global ? 0 : o;
  l.m = m;
  l.consts_global = consts_global ? 1 : 0;
  l.hist_global = hist_global ? 1 : 0;
  const size_t mh = hist_global ? 0 : (size_t)m;
  o = 0;
  l.rhs = o;   o += 8 * 2 * C;
  l.qr = o;    o += 4 * 2 * C;
  l.x = o;     o += 4 * DP;
  l.g = o;     o += 4 * DP;
  l.bnd = o;   o += 4 * 12 * S;
  l.lm = o;    o += 4 * 2 * S;
  l.sb = o;    o += S > 1 ? 4 * 12 : 0;   // junction rows: multi-gear only
  l.gb = o;    o += S > 1 ? 4 * 8 : 0;
  l.hs = o;    o += 4 * mh * DP;
  l.hy = o;    o += 4 * mh * DP;
  l.ys = o;    o += 4 * mh;
  l.alpha = o; o += 4 * mh;
  l.ol = o;    o += sizeof(ObsLane<float>) * (size_t)O;
  l.ring = o;  o += sizeof(NearPair<float>) * 2 * 32;
  l.acc = o;   o += 4 * Dm::ACC * 32;
  l.obs = o;   o += 4 * 12 * (size_t)O * Po;
  // last, so that no offset above depends on the run-time past window
  l.pf = o;    o += m > 0 ? 4 * (size_t)(past > kPastSlots ? past : kPastSlots)
                        : 0;
  l.slice = up16(o);
  return l;
}

// Copies each distinct segment's constants (its first rs rows of the
// [S][3][R][C] maps, [S][2][R] quadrature rows, [S][C][C] jerk form) to
// `base` in the layout's order; thread t of nt takes elements t, t + nt, ...
template <int N, int S>
__device__ void stage_consts(const Args& a, const KWS<float, S>& w,
                             unsigned char* base, const LayoutS<S>& l, int t,
                             int nt) {
  const int C = KDims<N, S>::C, R = a.R;
  if constexpr (S == 1) {        // all R rows (w.rs[0] == R)
    const int nP = 3 * R * C, nQ = C * C, nG = 2 * R;
    double* Pd = (double*)(base + l.pd[0]);
    float* P = (float*)(base + l.p[0]);
    float* Q = (float*)(base + l.q[0]);
    float* gridc = (float*)(base + l.gridc[0]);
    for (int i = t; i < nP; i += nt) {
      const float v = a.P[i];
      P[i] = v;
      Pd[i] = double(v);
    }
    for (int i = t; i < nQ; i += nt) Q[i] = a.Q[i];
    for (int i = t; i < nG; i += nt) gridc[i] = a.gridc[i];
    return;
  }
  for (int s = 0; s < S; ++s) {
    if (slot_of(w, s) < s) continue;
    const int rs = w.rs[s];
    for (int o = 0; o < 3; ++o) {
      double* Pd = (double*)(base + l.pd[s]) + (size_t)o * rs * C;
      float* P = (float*)(base + l.p[s]) + (size_t)o * rs * C;
      const float* src = a.P + ((size_t)s * 3 + o) * R * C;
      for (int i = t; i < rs * C; i += nt) {
        P[i] = src[i];
        Pd[i] = double(src[i]);
      }
    }
    float* Q = (float*)(base + l.q[s]);
    for (int i = t; i < C * C; i += nt) Q[i] = a.Q[(size_t)s * C * C + i];
    for (int o = 0; o < 2; ++o) {
      float* gridc = (float*)(base + l.gridc[s]) + (size_t)o * rs;
      const float* src = a.gridc + ((size_t)s * 2 + o) * R;
      for (int i = t; i < rs; i += nt) gridc[i] = src[i];
    }
  }
}

// The layout a kernel runs with: kernel B with m fixed at compile time
// (KM > 0) or at run time (KM = 0), kernel A (KM = -1: no history); at
// capacity 8 and S <= 4 the constants are always shared.
template <int N, int S, int KM>
__device__ __forceinline__ LayoutS<S> kernel_layout(const Args& a,
                                                    const KWS<float, S>& w) {
  return layout<N, S>(w, a.O, a.Po, KM > 0 ? KM : (KM == 0 ? a.m : 0),
                      a.past, kConstsMayLeave<N, S> && a.consts_global,
                      KM == 0 && a.hist_global);
}

// The block's constants: staged into shared memory, or where the launch
// put them in global memory.
template <int N, int S>
__device__ const unsigned char* block_consts(const Args& a,
                                             const KWS<float, S>& w,
                                             unsigned char* sm,
                                             const LayoutS<S>& l) {
  // capacity 8 and S <= 4: always shared, known at compile time
  // (shared-memory loads)
  if constexpr (kConstsMayLeave<N, S>)
    if (l.consts_global) return a.consts;
  stage_consts<N, S>(a, w, sm, l, threadIdx.x, blockDim.x);
  __syncthreads();
  return sm;
}

template <int N, int S>
__global__ void consts_kernel(Args a, KWS<float, S> w, LayoutS<S> l) {
  stage_consts<N, S>(a, w, a.consts, l, blockIdx.x * blockDim.x + threadIdx.x,
                     gridDim.x * blockDim.x);
}

// This warp's view of its slice, and the block's constants (K: the
// per-segment slots).
template <int K>
struct Slice {
  LaneData<float, K> L;
  SolverMem<float> M;
  float* bnd;
  float* lm;
  float* obs;
  ObsLane<float>* ol;
};

template <int N, int S>
__device__ Slice<kSlots<S>> slice_of(const Args& a, const KWS<float, S>& kw,
                                     const unsigned char* cb,
                                     unsigned char* sm, const LayoutS<S>& l,
                                     int wid) {
  unsigned char* w = sm + l.warp0 + (size_t)wid * l.slice;
  Slice<kSlots<S>> s;
  s.bnd = (float*)(w + l.bnd);
  s.lm = (float*)(w + l.lm);
  s.obs = (float*)(w + l.obs);
  s.ol = (ObsLane<float>*)(w + l.ol);
  LaneS<float, S>& L = s.L;
  if constexpr (S == 1) {
    // one segment: its constants and boundary rows, once (its rows of the
    // slabs are selected per lane)
    L.s = 0;
    L.ns = kw.ns[0];
    L.Pd = (const double*)(cb + l.pd[0]);
    L.P = (const float*)(cb + l.p[0]);
    L.Q = (const float*)(cb + l.q[0]);
    L.gridc = (const float*)(cb + l.gridc[0]);
    L.R = a.R;
    L.bnd = s.bnd;
  } else {
    for (int j = 0; j < S; ++j) {
      L.Pds[j] = (const double*)(cb + l.pd[j]);
      L.Ps[j] = (const float*)(cb + l.p[j]);
      L.Qs[j] = (const float*)(cb + l.q[j]);
      L.gridcs[j] = (const float*)(cb + l.gridc[j]);
    }
  }
  L.H = a.H; L.O = a.O; L.Po = a.Po;
  L.seg_rows = a.R;
  L.plane_row = 0;
  L.bnd_lane = s.bnd;
  L.lm = s.lm;
  L.obs = s.obs;
  L.ol = s.ol;
  L.x = (float*)(w + l.x);
  L.g = (float*)(w + l.g);
  L.rhs = (double*)(w + l.rhs);
  L.qr = (float*)(w + l.qr);
  L.ring = (NearPair<float>*)(w + l.ring);
  L.acc = (float*)(w + l.acc);
  L.sb = (float*)(w + l.sb);
  L.gb = (float*)(w + l.gb);
  s.M.m = l.m;
  s.M.s = (float*)(w + l.hs);
  s.M.y = (float*)(w + l.hy);
  s.M.ys = (float*)(w + l.ys);
  s.M.alpha = (float*)(w + l.alpha);
  s.M.pf = (float*)(w + l.pf);
  return s;
}

__device__ inline Slabs<float> slabs_of(const Args& a) {
  Slabs<float> s;
  s.bnd = a.bnd; s.misc = a.misc; s.cn = a.cn; s.cp = a.cp; s.cm = a.cm;
  s.obs = a.obs; s.B = a.B; s.R = a.R; s.H = a.H; s.O = a.O; s.Po = a.Po;
  s.S = a.S;
  return s;
}

template <int N, int S>
__global__ void __launch_bounds__(kMaxThreads, 1)
    eval_fg_kernel(Args a, KWS<float, S> w) {
  constexpr int DP = KDims<N, S>::DP;
  extern __shared__ __align__(16) unsigned char sm[];
  const LayoutS<S> l = kernel_layout<N, S, -1>(a, w);
  const unsigned char* cb = block_consts<N, S>(a, w, sm, l);
  const int wid = threadIdx.x >> 5;
  WarpTeam<DP> tm;
  tm.m = threadIdx.x & 31;
  Slice<kSlots<S>> s = slice_of<N, S>(a, w, cb, sm, l, wid);
  const Slabs<float> sl = slabs_of(a);
  const int nw = blockDim.x >> 5;
  for (int lane = blockIdx.x * nw + wid; lane < a.B;
       lane += gridDim.x * nw) {
    stage_lane<S>(tm, sl, lane, s.bnd, s.lm, s.obs, s.ol);
    s.L.planes_lane = planes_slab(sl, lane);
    s.L.plane_row = (size_t)a.B;
    if (S == 1) select_rows(s.L, 0);
    for (int i = tm.m; i < DP; i += 32) s.L.x[i] = a.x[(size_t)i * a.B + lane];
    tm.sync();
    const float f = lane_eval<float, N, S>(tm, s.L, w);
    for (int i = tm.m; i < DP; i += 32)
      a.g_out[(size_t)i * a.B + lane] = s.L.g[i];
    if (tm.m == 0) a.f_out[lane] = f;
    tm.sync();
  }
}

// KM: the history length fixed at compile time (kFixedMem), else 0.
template <int N, int S, int KM>
__global__ void __launch_bounds__(kMaxThreads, 1)
    solve_kernel(Args a, KWS<float, S> w, LP<float> p) {
  constexpr int DP = KDims<N, S>::DP;
  typedef WarpTeam<DP> Team;
  constexpr int V = Team::kVec;
  extern __shared__ __align__(16) unsigned char sm[];
  const LayoutS<S> l = kernel_layout<N, S, KM>(a, w);
  const unsigned char* cb = block_consts<N, S>(a, w, sm, l);
  const int wid = threadIdx.x >> 5;
  Team tm;
  tm.m = threadIdx.x & 31;
  Slice<kSlots<S>> s = slice_of<N, S>(a, w, cb, sm, l, wid);
  const Slabs<float> sl = slabs_of(a);
  for (;;) {
    int lane = 0;
    if (tm.m == 0) lane = atomicAdd(a.queue, 1);
    lane = __shfl_sync(0xffffffffu, lane, 0);
    if (lane >= a.B) break;
    stage_lane<S>(tm, sl, lane, s.bnd, s.lm, s.obs, s.ol);
    s.L.planes_lane = planes_lane_major((const float*)a.planes, lane, a.H,
                                        a.S * a.R);
    s.L.plane_row = 1;
    if (S == 1) select_rows(s.L, 0);
    if (KM == 0 && l.hist_global) lane_history(s.M, a.hist, lane, DP);
    float x0[V], g0[V], xo[V], fo;
    for (int k = 0; k < V; ++k) {
      const size_t c = (size_t)tm.coord(k);
      x0[k] = tm.valid(k) ? a.x[c * a.B + lane] : 0.f;
      g0[k] = tm.valid(k) ? a.g0[c * a.B + lane] : 0.f;
    }
    const SolveOut o = lane_solve<float, N, S, KM>(tm, s.L, w, p, s.M, x0,
                                                   a.f0[lane], g0, xo, &fo);
    for (int k = 0; k < V; ++k)
      if (tm.owner(k)) a.x_out[(size_t)tm.coord(k) * a.B + lane] = xo[k];
    if (tm.m == 0) {
      a.f_out[lane] = fo;
      a.info[lane] = o.status;
      a.info[a.B + lane] = o.k;
      a.info[2 * a.B + lane] = o.n_evals;
    }
    tm.sync();
  }
}

// planes[b][q][r] = plane q's (r, b): 32 x 32 tiles through shared memory.
__global__ void lane_major_kernel(Args a) {
  __shared__ float tile[32][33];
  const Slabs<float> sl = slabs_of(a);
  const int q = blockIdx.z, RS = a.S * a.R;
  const float* src = lane_major_src(sl, q);
  const int b0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int r = r0 + i, b = b0 + threadIdx.x;
    if (r < RS && b < a.B) tile[i][threadIdx.x] = src[(size_t)r * a.B + b];
  }
  __syncthreads();
  const size_t nq = 5 * (size_t)a.H;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int b = b0 + i, r = r0 + threadIdx.x;
    if (b < a.B && r < RS)
      a.planes[((size_t)b * nq + q) * RS + r] = tile[threadIdx.x][i];
  }
}

// ---------------------------------------------------------------------------
// Host side, per capacity
// ---------------------------------------------------------------------------

inline cudaError_t max_smem(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
}

// Warps per block for layout l within `smem` bytes (kMaxWarps at most).
template <int K>
inline int warps_for(const Layout<K>& l, int smem) {
  int nw = kMaxWarps;
  while (nw > 0 && l.warp0 + nw * l.slice > (size_t)smem) --nw;
  return nw;
}

// The class's layout for kernel A (m = 0: no history) or B. The
// constants stay in shared memory where they and kMinWarps slices fit (at
// capacity 8 and S <= 4 always: a class there has at most three distinct
// piece counts, <= 140 KB of constants at the bench resolution, and
// kernels A and B keep their shared-memory loads), else they go to global
// memory, and at capacity 32 always (kWide); the history stays in the
// slice up to kMemShared pairs and while a slice with it fits (at capacity
// 32, while kMinWarps do), else it goes to global memory. *ok = false
// where not even one slice fits.
template <int N, int S>
inline LayoutS<S> place(const KWS<float, S>& w, int O, int Po, int m,
                        int past, int smem, bool* ok) {
  constexpr bool may_leave = kConstsMayLeave<N, S>;
  constexpr bool kWide = N > 16;
  const int first_h = m > kMemShared ? 1 : 0;
  *ok = true;
  for (int c = kWide ? 1 : 0; c < (may_leave ? 2 : 1); ++c)
    for (int h = first_h; h < 2; ++h) {
      const LayoutS<S> l = layout<N, S>(w, O, Po, m, past, c == 1, h == 1);
      const int need = (c == 0 && may_leave) || (kWide && h == 0)
                           ? kMinWarps : 1;
      if (warps_for(l, smem) >= need) return l;
    }
  *ok = false;
  return layout<N, S>(w, O, Po, m, past, may_leave, true);
}

// The scratch buffer of one launch (byte offsets, 256-aligned): kernel B's
// lane counter and lane-major half-planes, and either kernel's constants
// and (B) history where the layout puts them in global memory.
struct Scratch {
  size_t queue, planes, consts, hist, total;
};

inline size_t up256(size_t n) { return (n + 255) & ~(size_t)255; }

template <int N, int S>
inline Scratch scratch_layout(int which, const LayoutS<S>& l, int B, int R,
                              int H) {
  Scratch s;
  size_t o = 0;
  s.queue = o;
  if (which == 1) o += 256;
  s.planes = o;
  if (which == 1) o += up256(4 * (size_t)B * 5 * H * S * R);
  s.consts = o;
  if (l.consts_global) o += up256(l.consts);
  s.hist = o;
  if (which == 1 && l.hist_global)
    o += up256(4 * (size_t)B * hist_floats(l.m, KDims<N, S>::DP));
  s.total = o;
  return s;
}

// A persistent launch for the class: warps per block, the shared memory,
// blocks per SM and in all.
struct Plan {
  int warps, smem, per_sm, blocks;
};

template <class Kern, int K>
cudaError_t plan(Kern kernel, const Layout<K>& l, Plan* pl) {
  int dev = 0, sms = 0, smem = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = max_smem(&smem);
  if (err != cudaSuccess) return err;
  const int nw = warps_for(l, smem);
  if (nw == 0) return cudaErrorInvalidConfiguration;
  const size_t bytes = l.warp0 + nw * l.slice;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      32 * nw, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  pl->warps = nw;
  pl->smem = (int)bytes;
  pl->per_sm = per_sm;
  pl->blocks = per_sm * sms;
  return cudaSuccess;
}

// Launches `kernel` on a persistent grid (every block that fits, at most
// one warp per lane) with the layout l (its inputs set in a), after
// writing the constants to global memory where l puts them there; `params`
// are its arguments after Args and KW.
template <int N, int S, class Kern, class... Params>
cudaError_t launch(Kern kernel, Args a, const KWS<float, S>& w,
                   const LayoutS<S>& l, cudaStream_t stream,
                   const Params&... params) {
  Plan pl;
  cudaError_t err = plan(kernel, l, &pl);
  if (err != cudaSuccess) return err;
  a.m = l.m;
  a.consts_global = l.consts_global;
  a.hist_global = l.hist_global;
  if (l.consts_global) {
    consts_kernel<N, S><<<264, 256, 0, stream>>>(a, w, l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int need = (a.B + pl.warps - 1) / pl.warps;
  const int blocks = pl.blocks < need ? pl.blocks : need;
  kernel<<<blocks, 32 * pl.warps, pl.smem, stream>>>(a, w, params...);
  return cudaGetLastError();
}

template <int N, int S>
cudaError_t eval_s(Args a, const float* wts, unsigned char* scratch,
                   cudaStream_t st) {
  const KWS<float, S> w = make_kw<float, kSlots<S>>(wts);
  int smem = 0;
  bool ok = false;
  cudaError_t err = max_smem(&smem);
  if (err != cudaSuccess) return err;
  const LayoutS<S> l = place<N, S>(w, a.O, a.Po, 0, 0, smem, &ok);
  if (!ok) return cudaErrorInvalidConfiguration;
  a.consts = scratch + scratch_layout<N, S>(0, l, a.B, a.R, a.H).consts;
  return launch<N, S>(eval_fg_kernel<N, S>, a, w, l, st);
}

template <int N, int S, int KM>
cudaError_t solve_km(Args a, const KWS<float, S>& w, const LP<float>& lp,
                     const LayoutS<S>& l, unsigned char* scratch,
                     cudaStream_t st) {
  const Scratch sc = scratch_layout<N, S>(1, l, a.B, a.R, a.H);
  a.past = lp.past;
  a.queue = (int*)(scratch + sc.queue);
  a.planes = (float*)(scratch + sc.planes);
  a.consts = scratch + sc.consts;
  a.hist = (float*)(scratch + sc.hist);
  cudaError_t err = cudaMemsetAsync(a.queue, 0, sizeof(int), st);
  if (err != cudaSuccess) return err;
  if (a.H > 0) {
    const dim3 grid((a.B + 31) / 32, (S * a.R + 31) / 32, 5 * a.H);
    lane_major_kernel<<<grid, dim3(32, 8), 0, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch<N, S>(solve_kernel<N, S, KM>, a, w, l, st, lp);
}

// Whether kernel B runs the class with m fixed at compile time (kFixedMem):
// its m, and its history in the slice.
template <int N, int S>
inline bool fixed_mem(const LayoutS<S>& l) {
  return kFixedMem<N, S> > 0 && l.m == kFixedMem<N, S> && !l.hist_global;
}

template <int N, int S>
cudaError_t solve_s(Args a, const float* wts, const LP<float>& lp,
                    unsigned char* scratch, cudaStream_t st) {
  const KWS<float, S> w = make_kw<float, kSlots<S>>(wts);
  int smem = 0;
  bool ok = false;
  cudaError_t err = max_smem(&smem);
  if (err != cudaSuccess) return err;
  const LayoutS<S> l = place<N, S>(w, a.O, a.Po, lp.mem, lp.past, smem, &ok);
  if (!ok) return cudaErrorInvalidConfiguration;
  if constexpr (kFixedMem<N, S> > 0)
    if (fixed_mem<N, S>(l))
      return solve_km<N, S, kFixedMem<N, S>>(a, w, lp, l, scratch, st);
  return solve_km<N, S, 0>(a, w, lp, l, scratch, st);
}

// out[0] registers per thread, [1] local memory per thread (bytes: spills
// and stack), [2] resident warps per SM, [3] blocks of the persistent grid,
// [4] shared memory per block, [5] constants in global memory (0 / 1), [6]
// history in global memory, [7] the capacity.
template <int N, int S>
cudaError_t info_s(int which, const float* wts, int O, int Po, int m,
                   int past, int* out) {
  const KWS<float, S> w = make_kw<float, kSlots<S>>(wts);
  int smem = 0;
  bool ok = false;
  cudaError_t err = max_smem(&smem);
  if (err != cudaSuccess) return err;
  const LayoutS<S> l =
      place<N, S>(w, O, Po, which == 0 ? 0 : m, past, smem, &ok);
  if (!ok) return cudaErrorInvalidConfiguration;
  cudaFuncAttributes fa;
  Plan pl;
  const bool fixed = which == 1 && fixed_mem<N, S>(l);
  if (which == 0) {
    err = cudaFuncGetAttributes(&fa, eval_fg_kernel<N, S>);
    if (err == cudaSuccess) err = plan(eval_fg_kernel<N, S>, l, &pl);
  } else if (fixed) {
    err = cudaFuncGetAttributes(&fa, solve_kernel<N, S, kFixedMem<N, S>>);
    if (err == cudaSuccess)
      err = plan(solve_kernel<N, S, kFixedMem<N, S>>, l, &pl);
  } else {
    err = cudaFuncGetAttributes(&fa, solve_kernel<N, S, 0>);
    if (err == cudaSuccess) err = plan(solve_kernel<N, S, 0>, l, &pl);
  }
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = pl.per_sm * pl.warps;
  out[3] = pl.blocks;
  out[4] = pl.smem;
  out[5] = l.consts_global;
  out[6] = which == 1 && l.hist_global;
  out[7] = N;
  return cudaSuccess;
}

// Bytes of the scratch buffer that kernel `which` needs for this class and
// batch.
template <int N, int S>
cudaError_t scratch_s(int which, const float* wts, int B, int R, int H,
                      int O, int Po, int m, int past, size_t* bytes) {
  const KWS<float, S> w = make_kw<float, kSlots<S>>(wts);
  int smem = 0;
  bool ok = false;
  cudaError_t err = max_smem(&smem);
  if (err != cudaSuccess) return err;
  const LayoutS<S> l =
      place<N, S>(w, O, Po, which == 0 ? 0 : m, past, smem, &ok);
  if (!ok) return cudaErrorInvalidConfiguration;
  *bytes = scratch_layout<N, S>(which, l, B, R, H).total;
  return cudaSuccess;
}

}  // namespace
}  // namespace dftpav

// Defines ops_<N>_<S>() (in namespace dftpav).
#define DFT_DEFINE_OPS(N_, S_)                                   \
  namespace dftpav {                                             \
  Ops ops_##N_##_##S_() {                                        \
    Ops o;                                                       \
    o.eval = eval_s<N_, S_>;                                     \
    o.solve = solve_s<N_, S_>;                                   \
    o.info = info_s<N_, S_>;                                     \
    o.scratch = scratch_s<N_, S_>;                               \
    return o;                                                    \
  }                                                              \
  }
