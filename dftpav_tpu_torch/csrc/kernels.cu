// Hand-written Hopper kernels for the batched whole-solve, with a plain C
// interface (loaded with ctypes by dftpav_tpu_torch/ops/_cuda.py).
//
//   dftpav_eval_fg     kernel A: objective + gradient for every lane
//                      (replaces dftpav_tpu/ops/kcost.py eval_fg)
//   dftpav_solve_fused kernel B: the whole L-BFGS solve for every lane
//                      (replaces dftpav_tpu/ops/pallas_solve.py _kernel)
//
// Mapping: a group of kGroup = 8 threads of one warp per lane (scenario),
// groups grid-striding over lanes, each lane exiting on its own. The group
// splits the lane's sample rows (thread j takes rows j, j+8, ...) and
// all-reduces the per-lane sums with __shfl_xor_sync, so every member holds
// the identical objective and gradient and takes the identical solver
// decisions. The solver state (16 decision coordinates of iterate, gradient,
// direction and the m=16 history pairs) is split too: each member keeps 2
// coordinates, and dot products are all-reduced the same way. The shared
// constants P, Q and the quadrature rows (~28 KB at the bench class) are
// staged once per block in shared memory.
//
// Bound on the H100: instruction latency. Per objective evaluation a lane
// does ~170 rows of scalar arithmetic (sample maps, 16 corridor hinges,
// feasibility, and -- only near an obstacle -- the dual-number obstacle
// block), and a thread needs 255 registers with spills. With one thread per
// lane, B = 8192 lanes fill only 256 warps (~2 per SM) and little latency is
// hidden; 8 threads per lane give 8x the warps and 1/8 of the rows per
// thread. Measured at B = 8192 on an H100 80GB HBM3 (700 W), kernel B took
// 2.08 s with 1 thread per lane, 1.21 s with 2, 0.91 s with 4 and 0.87 s
// with 8 (PERF.md, Findings).
//
// A launch allocates nothing: the caller passes every output. Each entry
// point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include "kcost.cuh"
#include "solve.cuh"

using namespace dftpav;

namespace {

constexpr int kN = 8;      // pieces per segment of the ported class
constexpr int kGroup = 8;  // threads per lane: divides DP = 16 and 32
typedef KDims<kN> Dm;

// G threads of one warp working on one lane (kcost.cuh Solo is G = 1).
// sum() is an xor butterfly: a + b == b + a exactly at every level, so all
// members end with bitwise identical totals.
template <int G>
struct WarpGroup {
  static constexpr int size = G;
  int r;
  unsigned mask;
  DFT_HD int rank() const { return r; }
  template <class V>
  DFT_HD V sum(V v) const {
#ifdef __CUDA_ARCH__
    for (int off = G / 2; off > 0; off >>= 1)
      v += __shfl_xor_sync(mask, v, off, G);
#endif
    return v;
  }
  template <class V>
  DFT_HD V bcast(V v, int src) const {
#ifdef __CUDA_ARCH__
    v = __shfl_sync(mask, v, src, G);
#endif
    return v;
  }
};

template <int G>
__device__ WarpGroup<G> group_of_thread() {
  WarpGroup<G> g;
  const int t = threadIdx.x & 31;
  g.r = t & (G - 1);
  g.mask = G == 32 ? 0xffffffffu : (((1u << G) - 1u) << (t & ~(G - 1)));
  return g;
}

struct Args {
  const float *x, *f0, *g0;
  const float *bnd, *misc, *cn, *cp, *cm, *obs;
  const float *P, *Q, *gridc;
  float *x_out, *f_out, *g_out;
  int* info;
  int B, R, H, O, Po;
};

__device__ void stage_consts(const Args& a, float* smem) {
  const int C = Dm::C;
  const int nP = 3 * a.R * C, nQ = C * C, nG = 2 * a.R;
  for (int i = threadIdx.x; i < nP; i += blockDim.x) smem[i] = a.P[i];
  for (int i = threadIdx.x; i < nQ; i += blockDim.x) smem[nP + i] = a.Q[i];
  for (int i = threadIdx.x; i < nG; i += blockDim.x)
    smem[nP + nQ + i] = a.gridc[i];
  __syncthreads();
}

__device__ Slabs<float> slabs_of(const Args& a) {
  Slabs<float> s;
  s.bnd = a.bnd; s.misc = a.misc; s.cn = a.cn; s.cp = a.cp; s.cm = a.cm;
  s.obs = a.obs; s.B = a.B; s.R = a.R; s.H = a.H; s.O = a.O; s.Po = a.Po;
  return s;
}

template <int G>
__global__ void eval_fg_kernel(Args a, KW<float> w) {
  extern __shared__ float smem[];
  stage_consts(a, smem);
  const float* P = smem;
  const float* Q = smem + 3 * a.R * Dm::C;
  const float* gridc = Q + Dm::C * Dm::C;
  const Slabs<float> sl = slabs_of(a);
  const WarpGroup<G> grp = group_of_thread<G>();
  const int stride = gridDim.x * blockDim.x / G;
  for (int lane = (blockIdx.x * blockDim.x + threadIdx.x) / G; lane < a.B;
       lane += stride) {
    float x[Dm::DP], g[Dm::DP];
    for (int i = 0; i < Dm::DP; ++i) x[i] = a.x[(size_t)i * a.B + lane];
    const float f = lane_fg<float, kN>(x, g, sl, lane, P, Q, gridc, w, grp);
    if (grp.rank() == 0) {
      a.f_out[lane] = f;
      for (int i = 0; i < Dm::DP; ++i) a.g_out[(size_t)i * a.B + lane] = g[i];
    }
  }
}

template <int G>
__global__ void solve_kernel(Args a, KW<float> w, LP<float> p) {
  extern __shared__ float smem[];
  stage_consts(a, smem);
  const float* P = smem;
  const float* Q = smem + 3 * a.R * Dm::C;
  const float* gridc = Q + Dm::C * Dm::C;
  const Slabs<float> sl = slabs_of(a);
  const WarpGroup<G> grp = group_of_thread<G>();
  const int stride = gridDim.x * blockDim.x / G;
  for (int lane = (blockIdx.x * blockDim.x + threadIdx.x) / G; lane < a.B;
       lane += stride) {
    float x0[Dm::DP], g0[Dm::DP], xo[Dm::DP], fo;
    for (int i = 0; i < Dm::DP; ++i) {
      x0[i] = a.x[(size_t)i * a.B + lane];
      g0[i] = a.g0[(size_t)i * a.B + lane];
    }
    const SolveOut o = lane_solve<float, kN>(x0, a.f0[lane], g0, sl, lane, P,
                                             Q, gridc, w, p, xo, &fo, grp);
    if (grp.rank() == 0) {
      for (int i = 0; i < Dm::DP; ++i)
        a.x_out[(size_t)i * a.B + lane] = xo[i];
      a.f_out[lane] = fo;
      a.info[lane] = o.status;
      a.info[a.B + lane] = o.k;
      a.info[2 * a.B + lane] = o.n_evals;
    }
  }
}

size_t smem_bytes(const Args& a) {
  return sizeof(float) * (size_t)(3 * a.R * Dm::C + Dm::C * Dm::C + 2 * a.R);
}

// Launches `kernel` with kGroup threads per lane, 64 threads per block, and
// the constants' shared memory; `params` are its arguments after Args.
template <class K, class... Params>
cudaError_t launch(K kernel, const Args& a, cudaStream_t stream,
                   const Params&... params) {
  const size_t smem = smem_bytes(a);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int threads = 64;
  const int blocks = (int)(((size_t)a.B * kGroup + threads - 1) / threads);
  kernel<<<blocks, threads, smem, stream>>>(a, params...);
  return cudaGetLastError();
}

Args make_args(const float* x, const float* f0, const float* g0,
               const float* bnd, const float* misc, const float* cn,
               const float* cp, const float* cm, const float* obs,
               const float* P, const float* Q, const float* gridc, int B,
               int R, int H, int O, int Po) {
  Args a;
  a.x = x; a.f0 = f0; a.g0 = g0; a.bnd = bnd; a.misc = misc; a.cn = cn;
  a.cp = cp; a.cm = cm; a.obs = obs; a.P = P; a.Q = Q; a.gridc = gridc;
  a.x_out = nullptr; a.f_out = nullptr; a.g_out = nullptr; a.info = nullptr;
  a.B = B; a.R = R; a.H = H; a.O = O; a.Po = Po;
  return a;
}

}  // namespace

extern "C" {

// Compile-time class of this build: pieces per segment and padded decision
// rows. The wrapper checks both before launching.
int dftpav_kernel_n() { return kN; }
int dftpav_kernel_dp() { return Dm::DP; }
int dftpav_weight_len() { return W_LEN; }
int dftpav_lbfgs_len() { return L_LEN; }
int dftpav_max_h() { return kMaxH; }
int dftpav_mem() { return kMem; }
int dftpav_max_past() { return kMaxPast; }
const char* dftpav_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
// x [DP, B] -> f [B], g [DP, B]. wts: host vector of W_LEN floats.
int dftpav_eval_fg(const float* x, const float* bnd, const float* misc,
                   const float* cn, const float* cp, const float* cm,
                   const float* obs, const float* P, const float* Q,
                   const float* gridc, const float* wts, int B, int R, int H,
                   int O, int Po, float* f_out, float* g_out, void* stream) {
  Args a = make_args(x, nullptr, nullptr, bnd, misc, cn, cp, cm, obs, P, Q,
                     gridc, B, R, H, O, Po);
  a.f_out = f_out;
  a.g_out = g_out;
  return (int)launch(eval_fg_kernel<kGroup>, a, (cudaStream_t)stream,
                     make_kw<float>(wts));
}

// Whole solve from (x0 [DP, B], f0 [B], g0 [DP, B]) -> x_out [DP, B],
// f_out [B], info [3, B] int32 = status, k clamped to max_iter, n_evals.
// wts: W_LEN floats; lbp: L_LEN floats (host vectors).
int dftpav_solve_fused(const float* x0, const float* f0, const float* g0,
                       const float* bnd, const float* misc, const float* cn,
                       const float* cp, const float* cm, const float* obs,
                       const float* P, const float* Q, const float* gridc,
                       const float* wts, const float* lbp, int max_iter,
                       int max_ls, int past, int adaptive, int B, int R,
                       int H, int O, int Po, float* x_out, float* f_out,
                       int* info, void* stream) {
  Args a = make_args(x0, f0, g0, bnd, misc, cn, cp, cm, obs, P, Q, gridc, B,
                     R, H, O, Po);
  a.x_out = x_out;
  a.f_out = f_out;
  a.info = info;
  return (int)launch(solve_kernel<kGroup>, a, (cudaStream_t)stream,
                     make_kw<float>(wts),
                     make_lp<float>(lbp, max_iter, max_ls, past, adaptive));
}

}  // extern "C"
