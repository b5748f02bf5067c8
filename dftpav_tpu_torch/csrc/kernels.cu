// Hand-written Hopper kernels for the batched whole-solve, with a plain C
// interface (loaded with ctypes by dftpav_tpu_torch/ops/_cuda.py).
//
//   dftpav_eval_fg     kernel A: objective + gradient for every lane
//                      (replaces dftpav_tpu/ops/kcost.py eval_fg)
//   dftpav_solve_fused kernel B: the whole L-BFGS solve for every lane
//                      (replaces dftpav_tpu/ops/pallas_solve.py _kernel)
//
// Mapping: one warp per lane (scenario). The warp is a team of 32 members
// (team.cuh, kcost.cuh lane_eval): member m takes sample rows m, m + 32,
// ...; the (row, obstacle) pairs that may carry an obstacle penalty are
// packed by a ballot into batches of 32 and run through the dual-number
// obstacle block together; per-lane sums are xor-butterfly all-reduces and
// the gradient partials a reduce-scatter, so every member holds bitwise
// identical totals and takes identical solver decisions. The solver state
// leaves the registers: member m holds decision coordinate m % 16 of the
// iterate, gradient, direction and trial point (m, m + 32 and m + 64 for
// the multi-gear classes, whose decision vectors have 40, 56 or 72 rows);
// the m = 16 history pairs, the evaluated point, the rhs (in double), the
// lane's obstacle coefficients, the near-pair ring and the members'
// gradient partials sit in the warp's slice of shared memory, beside the
// block's copy of the sample maps (float and double), the jerk form and
// the quadrature rows: one copy per distinct piece count of the class's
// segments, each holding only its weighted rows.
//
// Both kernels are templates on the number of gear segments S (1 to 4,
// the decision length following it); the piece counts, rows and sigmas of
// the segments are read at run time from the weight vector, so that every
// class with the same S runs the same code.
//
// Kernel B runs a persistent grid: as many blocks as fit on the card (the
// occupancy API; 16 warps each, fewer where a class's shared memory needs
// it; one block of 16 per SM at the bench class), each warp taking its
// next lane from a global counter (atomicAdd) whenever its lane exits, so
// no SM slot waits on a block's slowest lane and there are no waves. Which warp solves which lane
// changes from run to run; a lane's arithmetic does not, so two launches
// on the same inputs give bitwise identical outputs. Before it, a transpose
// copies the half-planes lane-major (kcost.cuh planes_lane_major), so that
// a warp reads its lane's rows in whole lines; the slabs are lane-minor,
// and the ~170 evaluations of a lane would otherwise fetch a 32-byte
// sector for every 4-byte value.
//
// Bound on the H100: instruction issue and latency, not bytes (PERF.md,
// Findings). The earlier design (8 threads per lane, 4 lanes per warp)
// lost 61% of its time to lanes waiting on each other, mostly through one
// lane's obstacle block; here each lane has its own warp, the obstacle block is
// convergent, and a separating-axis bound keeps the dual-number pass to
// the pairs that can have a penalty (~58 of ~224 in reach per
// evaluation). The code is kept small on purpose (loops rolled, one call
// site of the dual pass): unrolled, kernel B doubled to ~15,600 machine
// instructions and ran 2.8x slower, its 16 warps missing the instruction
// caches.
//
// A launch allocates nothing: the caller passes every output, the lane
// counter (zeroed) and the lane-major scratch. Each entry point returns
// cudaGetLastError() after its launches.

#include <cuda_runtime.h>

#include "kcost.cuh"
#include "solve.cuh"

using namespace dftpav;

namespace {

constexpr int kN = 8;        // pieces per segment (N) of the ported classes
constexpr int kMaxWarps = 16;  // warps (lanes in flight) per block, at most
constexpr int kMaxThreads = 32 * kMaxWarps;

struct Args {
  const float *x, *f0, *g0;
  const float *bnd, *misc, *cn, *cp, *cm, *obs;
  const float *P, *Q, *gridc;
  float *x_out, *f_out, *g_out;
  int* info;
  int* queue;        // kernel B's lane counter, zero at launch
  float* planes;     // kernel B's lane-major half-planes [B][5 H][S R]
  int B, R, H, O, Po, S;
};

// Byte offsets in shared memory: the class constants once per block (per
// segment; segments with equal piece counts share theirs), then one slice
// per warp.
struct Layout {
  size_t pd[kMaxS], p[kMaxS], q[kMaxS], gridc[kMaxS], warp0, slice;
  size_t rhs, qr, x, g, bnd, lm, sb, gb, hs, hy, ys, alpha, pf, ol, ring,
      acc, obs;
};

__host__ __device__ inline size_t up16(size_t n) { return (n + 15) & ~(size_t)15; }

// The first segment with segment s's piece count (whose constants s uses).
__host__ __device__ inline int slot_of(const KW<float>& w, int s) {
  int j = 0;
  while (w.ns[j] != w.ns[s]) ++j;
  return j;
}

template <int S>
__host__ __device__ inline Layout layout(const KW<float>& w, int O, int Po) {
  const size_t C = kN + 5, DP = KDims<kN, S>::DP;
  Layout l;
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
  l.warp0 = o;
  o = 0;
  l.rhs = o;   o += 8 * 2 * C;
  l.qr = o;    o += 4 * 2 * C;
  l.x = o;     o += 4 * DP;
  l.g = o;     o += 4 * DP;
  l.bnd = o;   o += 4 * 12 * S;
  l.lm = o;    o += 4 * 2 * S;
  l.sb = o;    o += S > 1 ? 4 * 12 : 0;   // junction rows: multi-gear only
  l.gb = o;    o += S > 1 ? 4 * 8 : 0;
  l.hs = o;    o += 4 * kMem * DP;
  l.hy = o;    o += 4 * kMem * DP;
  l.ys = o;    o += 4 * kMem;
  l.alpha = o; o += 4 * kMem;
  l.pf = o;    o += 4 * kMaxPast;
  l.ol = o;    o += sizeof(ObsLane<float>) * (size_t)O;
  l.ring = o;  o += sizeof(NearPair<float>) * 2 * 32;
  l.acc = o;   o += 4 * kAcc * 32;
  l.obs = o;   o += 4 * 12 * (size_t)O * Po;
  l.slice = up16(o);
  return l;
}

// Copies each distinct segment's constants (its first rs rows of the
// [S][3][R][C] maps, [S][2][R] quadrature rows, [S][C][C] jerk form) into
// the block's shared memory.
template <int S>
__device__ void stage_consts(const Args& a, const KW<float>& w,
                             unsigned char* sm, const Layout& l) {
  const int C = kN + 5, R = a.R;
  if constexpr (S == 1) {        // all R rows (w.rs[0] == R)
    const int nP = 3 * R * C, nQ = C * C, nG = 2 * R;
    double* Pd = (double*)(sm + l.pd[0]);
    float* P = (float*)(sm + l.p[0]);
    float* Q = (float*)(sm + l.q[0]);
    float* gridc = (float*)(sm + l.gridc[0]);
    for (int i = threadIdx.x; i < nP; i += blockDim.x) {
      const float v = a.P[i];
      P[i] = v;
      Pd[i] = double(v);
    }
    for (int i = threadIdx.x; i < nQ; i += blockDim.x) Q[i] = a.Q[i];
    for (int i = threadIdx.x; i < nG; i += blockDim.x) gridc[i] = a.gridc[i];
    __syncthreads();
    return;
  }
  for (int s = 0; s < S; ++s) {
    if (slot_of(w, s) < s) continue;
    const int rs = w.rs[s];
    for (int o = 0; o < 3; ++o) {
      double* Pd = (double*)(sm + l.pd[s]) + (size_t)o * rs * C;
      float* P = (float*)(sm + l.p[s]) + (size_t)o * rs * C;
      const float* src = a.P + ((size_t)s * 3 + o) * R * C;
      for (int i = threadIdx.x; i < rs * C; i += blockDim.x) {
        P[i] = src[i];
        Pd[i] = double(src[i]);
      }
    }
    float* Q = (float*)(sm + l.q[s]);
    for (int i = threadIdx.x; i < C * C; i += blockDim.x)
      Q[i] = a.Q[(size_t)s * C * C + i];
    for (int o = 0; o < 2; ++o) {
      float* gridc = (float*)(sm + l.gridc[s]) + (size_t)o * rs;
      const float* src = a.gridc + ((size_t)s * 2 + o) * R;
      for (int i = threadIdx.x; i < rs; i += blockDim.x) gridc[i] = src[i];
    }
  }
  __syncthreads();
}

// This warp's view of its slice, and the block's constants.
struct Slice {
  LaneData<float> L;
  SolverMem<float> M;
  float* bnd;
  float* lm;
  float* obs;
  ObsLane<float>* ol;
};

template <int S>
__device__ Slice slice_of(const Args& a, const KW<float>& kw,
                          unsigned char* sm, const Layout& l, int wid) {
  unsigned char* w = sm + l.warp0 + (size_t)wid * l.slice;
  Slice s;
  s.bnd = (float*)(w + l.bnd);
  s.lm = (float*)(w + l.lm);
  s.obs = (float*)(w + l.obs);
  s.ol = (ObsLane<float>*)(w + l.ol);
  LaneData<float>& L = s.L;
  if constexpr (S == 1) {
    // one segment: its constants and boundary rows, once (its rows of the
    // slabs are selected per lane)
    L.s = 0;
    L.ns = kw.ns[0];
    L.Pd = (const double*)(sm + l.pd[0]);
    L.P = (const float*)(sm + l.p[0]);
    L.Q = (const float*)(sm + l.q[0]);
    L.gridc = (const float*)(sm + l.gridc[0]);
    L.R = a.R;
    L.bnd = s.bnd;
  } else {
    for (int j = 0; j < S; ++j) {
      L.Pds[j] = (const double*)(sm + l.pd[j]);
      L.Ps[j] = (const float*)(sm + l.p[j]);
      L.Qs[j] = (const float*)(sm + l.q[j]);
      L.gridcs[j] = (const float*)(sm + l.gridc[j]);
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
  s.M.s = (float*)(w + l.hs);
  s.M.y = (float*)(w + l.hy);
  s.M.ys = (float*)(w + l.ys);
  s.M.alpha = (float*)(w + l.alpha);
  s.M.pf = (float*)(w + l.pf);
  return s;
}

__device__ Slabs<float> slabs_of(const Args& a) {
  Slabs<float> s;
  s.bnd = a.bnd; s.misc = a.misc; s.cn = a.cn; s.cp = a.cp; s.cm = a.cm;
  s.obs = a.obs; s.B = a.B; s.R = a.R; s.H = a.H; s.O = a.O; s.Po = a.Po;
  s.S = a.S;
  return s;
}

template <int S>
__global__ void __launch_bounds__(kMaxThreads, 1)
    eval_fg_kernel(Args a, KW<float> w) {
  constexpr int DP = KDims<kN, S>::DP;
  extern __shared__ __align__(16) unsigned char sm[];
  const Layout l = layout<S>(w, a.O, a.Po);
  stage_consts<S>(a, w, sm, l);
  const int wid = threadIdx.x >> 5;
  WarpTeam<DP> tm;
  tm.m = threadIdx.x & 31;
  Slice s = slice_of<S>(a, w, sm, l, wid);
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
    const float f = lane_eval<float, kN, S>(tm, s.L, w);
    for (int i = tm.m; i < DP; i += 32)
      a.g_out[(size_t)i * a.B + lane] = s.L.g[i];
    if (tm.m == 0) a.f_out[lane] = f;
    tm.sync();
  }
}

template <int S>
__global__ void __launch_bounds__(kMaxThreads, 1)
    solve_kernel(Args a, KW<float> w, LP<float> p) {
  constexpr int DP = KDims<kN, S>::DP;
  typedef WarpTeam<DP> Team;
  constexpr int V = Team::kVec;
  extern __shared__ __align__(16) unsigned char sm[];
  const Layout l = layout<S>(w, a.O, a.Po);
  stage_consts<S>(a, w, sm, l);
  const int wid = threadIdx.x >> 5;
  Team tm;
  tm.m = threadIdx.x & 31;
  Slice s = slice_of<S>(a, w, sm, l, wid);
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
    float x0[V], g0[V], xo[V], fo;
    for (int k = 0; k < V; ++k) {
      const size_t c = (size_t)tm.coord(k);
      x0[k] = tm.valid(k) ? a.x[c * a.B + lane] : 0.f;
      g0[k] = tm.valid(k) ? a.g0[c * a.B + lane] : 0.f;
    }
    const SolveOut o = lane_solve<float, kN, S>(tm, s.L, w, p, s.M, x0,
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

// A persistent launch for the class: warps per block (kMaxWarps, or as
// many as fit in the card's shared memory per block), the shared memory,
// blocks per SM and in all.
struct Plan {
  int warps, smem, per_sm, blocks;
};

template <int S, class K>
cudaError_t plan(K kernel, const KW<float>& w, int O, int Po, Plan* pl) {
  int dev = 0, sms = 0, max_smem = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const Layout l = layout<S>(w, O, Po);
  int nw = kMaxWarps;
  while (nw > 0 && l.warp0 + nw * l.slice > (size_t)max_smem) --nw;
  if (nw == 0) return cudaErrorInvalidConfiguration;
  const size_t smem = l.warp0 + nw * l.slice;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      32 * nw, smem);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  pl->warps = nw;
  pl->smem = (int)smem;
  pl->per_sm = per_sm;
  pl->blocks = per_sm * sms;
  return cudaSuccess;
}

// Launches `kernel` on a persistent grid: every block that fits, at most
// one warp per lane; `params` are its arguments after Args and KW.
template <int S, class K, class... Params>
cudaError_t launch(K kernel, const Args& a, const KW<float>& w,
                   cudaStream_t stream, const Params&... params) {
  Plan pl;
  const cudaError_t err = plan<S>(kernel, w, a.O, a.Po, &pl);
  if (err != cudaSuccess) return err;
  const int need = (a.B + pl.warps - 1) / pl.warps;
  const int blocks = pl.blocks < need ? pl.blocks : need;
  kernel<<<blocks, 32 * pl.warps, pl.smem, stream>>>(a, w, params...);
  return cudaGetLastError();
}

Args make_args(const float* x, const float* f0, const float* g0,
               const float* bnd, const float* misc, const float* cn,
               const float* cp, const float* cm, const float* obs,
               const float* P, const float* Q, const float* gridc, int B,
               int R, int H, int O, int Po, int S) {
  Args a;
  a.x = x; a.f0 = f0; a.g0 = g0; a.bnd = bnd; a.misc = misc; a.cn = cn;
  a.cp = cp; a.cm = cm; a.obs = obs; a.P = P; a.Q = Q; a.gridc = gridc;
  a.x_out = nullptr; a.f_out = nullptr; a.g_out = nullptr; a.info = nullptr;
  a.queue = nullptr; a.planes = nullptr;
  a.B = B; a.R = R; a.H = H; a.O = O; a.Po = Po; a.S = S;
  return a;
}

// Whether the class in the weight vector is one the kernels take.
bool class_ok(const KW<float>& w, int R) {
  if (w.nseg < 1 || w.nseg > kMaxS || (w.nseg == 1 && w.rs[0] != R))
    return false;
  for (int s = 0; s < w.nseg; ++s)
    if (w.ns[s] < 2 || w.ns[s] > kN || kN % w.ns[s] != 0 || w.rs[s] < 1 ||
        w.rs[s] > R)
      return false;
  return true;
}

}  // namespace

extern "C" {

// Compile-time class of this build: pieces per segment, the most gear
// segments, and padded decision rows for S segments. The wrapper checks
// them before launching.
int dftpav_kernel_n() { return kN; }
int dftpav_kernel_max_s() { return kMaxS; }
int dftpav_kernel_dp(int S) {
  switch (S) {
    case 1: return KDims<kN, 1>::DP;
    case 2: return KDims<kN, 2>::DP;
    case 3: return KDims<kN, 3>::DP;
    case 4: return KDims<kN, 4>::DP;
  }
  return 0;
}
int dftpav_weight_len() { return W_LEN; }
int dftpav_lbfgs_len() { return L_LEN; }
int dftpav_max_h() { return kMaxH; }
int dftpav_mem() { return kMem; }
int dftpav_max_past() { return kMaxPast; }
const char* dftpav_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// What kernel `which` (0: A, 1: B) gets on this card for the class of the
// weight vector wts (W_LEN floats), R rows per segment, O obstacles of Po
// pieces: out[0] registers per thread, out[1] local memory per thread
// (bytes: spills and stack), out[2] resident warps per SM, out[3] blocks of
// the persistent grid, out[4] shared memory per block.
int dftpav_kernel_info(int which, const float* wts, int R, int O, int Po,
                       int* out) {
  const KW<float> w = make_kw<float>(wts);
  if (!class_ok(w, R)) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  Plan pl;
  cudaError_t err = cudaErrorInvalidValue;
#define DFT_INFO(S_)                                                     \
  if (w.nseg == S_) {                                                    \
    err = which == 0 ? cudaFuncGetAttributes(&fa, eval_fg_kernel<S_>)    \
                     : cudaFuncGetAttributes(&fa, solve_kernel<S_>);     \
    if (err != cudaSuccess) return (int)err;                             \
    err = which == 0 ? plan<S_>(eval_fg_kernel<S_>, w, O, Po, &pl)       \
                     : plan<S_>(solve_kernel<S_>, w, O, Po, &pl);        \
  }
  DFT_INFO(1) else DFT_INFO(2) else DFT_INFO(3) else DFT_INFO(4)
#undef DFT_INFO
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = pl.per_sm * pl.warps;
  out[3] = pl.blocks;
  out[4] = pl.smem;
  return 0;
}

// x [DP, B] -> f [B], g [DP, B]. wts: host vector of W_LEN floats, the
// class (S, n_s, rows) included; P [S][3][R][C], Q [S][C][C], gridc
// [S][2][R]; the corridor slabs have S R rows.
int dftpav_eval_fg(const float* x, const float* bnd, const float* misc,
                   const float* cn, const float* cp, const float* cm,
                   const float* obs, const float* P, const float* Q,
                   const float* gridc, const float* wts, int B, int R, int H,
                   int O, int Po, float* f_out, float* g_out, void* stream) {
  const KW<float> w = make_kw<float>(wts);
  if (H < 0 || H > kMaxH || R <= 0 || B <= 0 || O < 0 || Po <= 0 ||
      !class_ok(w, R))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(x, nullptr, nullptr, bnd, misc, cn, cp, cm, obs, P, Q,
                     gridc, B, R, H, O, Po, w.nseg);
  a.f_out = f_out;
  a.g_out = g_out;
  const cudaStream_t st = (cudaStream_t)stream;
  if (w.nseg == 1) return (int)launch<1>(eval_fg_kernel<1>, a, w, st);
  if (w.nseg == 2) return (int)launch<2>(eval_fg_kernel<2>, a, w, st);
  if (w.nseg == 3) return (int)launch<3>(eval_fg_kernel<3>, a, w, st);
  return (int)launch<4>(eval_fg_kernel<4>, a, w, st);
}

// Whole solve from (x0 [DP, B], f0 [B], g0 [DP, B]) -> x_out [DP, B],
// f_out [B], info [3, B] int32 = status, k clamped to max_iter, n_evals.
// wts: W_LEN floats; lbp: L_LEN floats (host vectors). queue: one int32,
// zero; planes: scratch of B * 5 H * S R floats.
int dftpav_solve_fused(const float* x0, const float* f0, const float* g0,
                       const float* bnd, const float* misc, const float* cn,
                       const float* cp, const float* cm, const float* obs,
                       const float* P, const float* Q, const float* gridc,
                       const float* wts, const float* lbp, int max_iter,
                       int max_ls, int past, int adaptive, int B, int R,
                       int H, int O, int Po, float* x_out, float* f_out,
                       int* info, int* queue, float* planes, void* stream) {
  const KW<float> w = make_kw<float>(wts);
  if (H < 0 || H > kMaxH || R <= 0 || B <= 0 || O < 0 || Po <= 0 ||
      !class_ok(w, R))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(x0, f0, g0, bnd, misc, cn, cp, cm, obs, P, Q, gridc, B,
                     R, H, O, Po, w.nseg);
  a.x_out = x_out;
  a.f_out = f_out;
  a.info = info;
  a.queue = queue;
  a.planes = planes;
  const cudaStream_t st = (cudaStream_t)stream;
  if (H > 0) {
    const dim3 grid((B + 31) / 32, (w.nseg * R + 31) / 32, 5 * H);
    lane_major_kernel<<<grid, dim3(32, 8), 0, st>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const LP<float> lp = make_lp<float>(lbp, max_iter, max_ls, past, adaptive);
  if (w.nseg == 1) return (int)launch<1>(solve_kernel<1>, a, w, st, lp);
  if (w.nseg == 2) return (int)launch<2>(solve_kernel<2>, a, w, st, lp);
  if (w.nseg == 3) return (int)launch<3>(solve_kernel<3>, a, w, st, lp);
  return (int)launch<4>(solve_kernel<4>, a, w, st, lp);
}

}  // extern "C"
