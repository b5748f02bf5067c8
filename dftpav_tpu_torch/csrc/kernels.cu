// The plain C interface of kernels A and B (kernels.cuh), loaded with ctypes
// by dftpav_tpu_torch/ops/_cuda.py, and their instantiation at capacity 8
// for S = 1 and 2 (kernels8_s34.cu .. kernels32_s78.cu instantiate the
// others, each compiled beside this file by its own nvcc process into the
// same library). The class in the weight vector picks the capacity, its S
// the instantiation.

#include "kernels.cuh"

DFT_DEFINE_OPS(8, 1)
DFT_DEFINE_OPS(8, 2)

using namespace dftpav;

namespace {

// The class in a weight vector, every segment's slot read.
typedef KW<float, kMaxS> KWide;

// The instantiation for the class in w (class_ok has checked it).
Ops ops_for(const KWide& w) {
  static const Ops table[3][kMaxS] = {
      {ops_8_1(), ops_8_2(), ops_8_3(), ops_8_4(), ops_8_5(), ops_8_6(),
       ops_8_7(), ops_8_8()},
      {ops_16_1(), ops_16_2(), ops_16_3(), ops_16_4(), ops_16_5(),
       ops_16_6(), ops_16_7(), ops_16_8()},
      {ops_32_1(), ops_32_2(), ops_32_3(), ops_32_4(), ops_32_5(),
       ops_32_6(), ops_32_7(), ops_32_8()}};
  return table[w.cap == 8 ? 0 : (w.cap == 16 ? 1 : 2)][w.nseg - 1];
}

constexpr int kCaps[] = {8, 16, 32};   // capacities this library is built for

Args make_args(const float* x, const float* f0, const float* g0,
               const float* bnd, const float* misc, const float* cn,
               const float* cp, const float* cm, const float* obs,
               const float* P, const float* Q, const float* gridc, int B,
               int R, int H, int O, int Po, int S) {
  Args a;
  a.x = x; a.f0 = f0; a.g0 = g0; a.bnd = bnd; a.misc = misc; a.cn = cn;
  a.cp = cp; a.cm = cm; a.obs = obs; a.P = P; a.Q = Q; a.gridc = gridc;
  a.x_out = nullptr; a.f_out = nullptr; a.g_out = nullptr; a.info = nullptr;
  a.queue = nullptr; a.planes = nullptr; a.consts = nullptr; a.hist = nullptr;
  a.B = B; a.R = R; a.H = H; a.O = O; a.Po = Po; a.S = S;
  a.m = 0; a.past = 0; a.consts_global = 0; a.hist_global = 0;
  return a;
}

// Whether the class in the weight vector is one the kernels take: a built
// capacity, 1 to kMaxS segments of 2 to capacity pieces each (any count:
// a segment reads its own at run time), rows kept within R (all R at S = 1).
bool class_ok(const KWide& w, int R) {
  if (w.cap != 8 && w.cap != 16 && w.cap != 32) return false;
  if (w.nseg < 1 || w.nseg > kMaxS || (w.nseg == 1 && w.rs[0] != R))
    return false;
  for (int s = 0; s < w.nseg; ++s)
    if (w.ns[s] < 2 || w.ns[s] > w.cap || w.rs[s] < 1 || w.rs[s] > R)
      return false;
  return true;
}

}  // namespace

extern "C" {

// The capacities (pieces per segment) this build has kernels for: writes up
// to n of them to out, returns how many there are.
int dftpav_kernel_caps(int* out, int n) {
  const int k = (int)(sizeof(kCaps) / sizeof(kCaps[0]));
  for (int i = 0; i < k && i < n; ++i) out[i] = kCaps[i];
  return k;
}
int dftpav_kernel_max_s() { return kMaxS; }
// Padded decision rows of a class of capacity cap and S segments (0: not
// built).
int dftpav_kernel_dp(int cap, int S) {
#define DFT_DP(N_)                                      \
  switch (S) {                                          \
    case 1: return KDims<N_, 1>::DP;                    \
    case 2: return KDims<N_, 2>::DP;                    \
    case 3: return KDims<N_, 3>::DP;                    \
    case 4: return KDims<N_, 4>::DP;                    \
    case 5: return KDims<N_, 5>::DP;                    \
    case 6: return KDims<N_, 6>::DP;                    \
    case 7: return KDims<N_, 7>::DP;                    \
    case 8: return KDims<N_, 8>::DP;                    \
  }
  if (cap == 8) DFT_DP(8)
  if (cap == 16) DFT_DP(16)
  if (cap == 32) DFT_DP(32)
#undef DFT_DP
  return 0;
}
int dftpav_weight_len() { return W_LEN; }
int dftpav_lbfgs_len() { return L_LEN; }
int dftpav_max_h() { return kMaxH; }
const char* dftpav_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// What kernel `which` (0: A, 1: B) gets on this card for the class of the
// weight vector wts (W_LEN floats), R rows per segment, O obstacles of Po
// pieces, L-BFGS memory m and past window: out[0] registers per thread,
// out[1] local memory per thread (bytes: spills and stack), out[2] resident
// warps per SM, out[3] blocks of the persistent grid, out[4] shared memory
// per block, out[5] 1 where the class constants lie in global memory, out[6]
// 1 where kernel B's history does, out[7] the capacity.
int dftpav_kernel_info(int which, const float* wts, int R, int O, int Po,
                       int m, int past, int* out) {
  const KWide w = make_kw<float, kMaxS>(wts);
  if (!class_ok(w, R) || m < 1 || past < 0) return (int)cudaErrorInvalidValue;
  return (int)ops_for(w).info(which, wts, O, Po, m, past, out);
}

// Bytes of the scratch buffer (one per launch, device memory, 256-byte
// aligned) that kernel `which` needs for this class at batch B; *bytes is
// written as an int64. Returns a CUDA error code where the class is not one
// the kernels take.
int dftpav_scratch_bytes(int which, const float* wts, int B, int R, int H,
                         int O, int Po, int m, int past, long long* bytes) {
  const KWide w = make_kw<float, kMaxS>(wts);
  if (H < 0 || H > kMaxH || R <= 0 || B <= 0 || O < 0 || Po <= 0 || m < 1 ||
      past < 0 || !class_ok(w, R))
    return (int)cudaErrorInvalidValue;
  size_t n = 0;
  const cudaError_t err =
      ops_for(w).scratch(which, wts, B, R, H, O, Po, m, past, &n);
  *bytes = (long long)n;
  return (int)err;
}

// x [DP, B] -> f [B], g [DP, B]. wts: host vector of W_LEN floats, the
// class (S, n_s, rows, capacity) included; P [S][3][R][C], Q [S][C][C],
// gridc [S][2][R] with C = capacity + 5; the corridor slabs have S R rows;
// scratch: dftpav_scratch_bytes(0, ...) bytes.
int dftpav_eval_fg(const float* x, const float* bnd, const float* misc,
                   const float* cn, const float* cp, const float* cm,
                   const float* obs, const float* P, const float* Q,
                   const float* gridc, const float* wts, int B, int R, int H,
                   int O, int Po, float* f_out, float* g_out, void* scratch,
                   void* stream) {
  const KWide w = make_kw<float, kMaxS>(wts);
  if (H < 0 || H > kMaxH || R <= 0 || B <= 0 || O < 0 || Po <= 0 ||
      !class_ok(w, R))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(x, nullptr, nullptr, bnd, misc, cn, cp, cm, obs, P, Q,
                     gridc, B, R, H, O, Po, w.nseg);
  a.f_out = f_out;
  a.g_out = g_out;
  unsigned char* sc = (unsigned char*)scratch;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)ops_for(w).eval(a, wts, sc, st);
}

// Whole solve from (x0 [DP, B], f0 [B], g0 [DP, B]) -> x_out [DP, B],
// f_out [B], info [3, B] int32 = status, k clamped to max_iter, n_evals.
// wts: W_LEN floats; lbp: L_LEN floats (host vectors); mem: the L-BFGS
// history length m (>= 1), past its past-f window (>= 0); scratch:
// dftpav_scratch_bytes(1, ...) bytes.
int dftpav_solve_fused(const float* x0, const float* f0, const float* g0,
                       const float* bnd, const float* misc, const float* cn,
                       const float* cp, const float* cm, const float* obs,
                       const float* P, const float* Q, const float* gridc,
                       const float* wts, const float* lbp, int max_iter,
                       int max_ls, int mem, int past, int adaptive, int B,
                       int R, int H, int O, int Po, float* x_out,
                       float* f_out, int* info, void* scratch, void* stream) {
  const KWide w = make_kw<float, kMaxS>(wts);
  if (H < 0 || H > kMaxH || R <= 0 || B <= 0 || O < 0 || Po <= 0 ||
      mem < 1 || past < 0 || !class_ok(w, R))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(x0, f0, g0, bnd, misc, cn, cp, cm, obs, P, Q, gridc, B,
                     R, H, O, Po, w.nseg);
  a.x_out = x_out;
  a.f_out = f_out;
  a.info = info;
  const LP<float> lp =
      make_lp<float>(lbp, max_iter, max_ls, mem, past, adaptive);
  unsigned char* sc = (unsigned char*)scratch;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)ops_for(w).solve(a, wts, lp, sc, st);
}

}  // extern "C"
