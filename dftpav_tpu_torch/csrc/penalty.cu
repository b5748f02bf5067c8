// Hand-written Hopper kernels for the static-corridor penalty of the
// batch-minor engine, with a plain C interface (loaded with ctypes by
// dftpav_tpu_torch/ops/_cuda.py):
//
//   dftpav_corridor_fwd  K2: per-lane cost sum_r wq_r * A_r
//                        (replaces dftpav_tpu/ops/pallas_penalty.py
//                        _fwd_kernel)
//   dftpav_corridor_bwd  K3: d_sig, d_dsig, d_wq per (row, lane), times the
//                        lane's cotangent (replaces _bwd_kernel)
//
// The per-row arithmetic is penalty.cuh, shared with kernel A and compiled
// for the host by the CPU tests.
//
// Bound on the H100: memory. Each (row, lane) reads 25 floats (sig 2, dsig
// 2, wq 1, normals 8, points 8, masks 4 at H = 4), 100 B, against ~200 flop
// for K2 and ~350 for K3, so at 3.35 TB/s and 67 TFLOP/s float32 the bytes
// take 5-10x longer than the arithmetic: at R = 264, B = 8192, K2 moves
// 216 MB (65 us) and K3, which also writes 5 floats per (row, lane), 260 MB
// (78 us). The design reads every operand exactly once, coalesced: lanes
// are the minor axis of every plane, and consecutive threads take
// consecutive lanes of one row. K2 splits a lane's rows over the 8 rows of
// its block (one thread per lane would leave 64 blocks at B = 8192) and
// sums them through shared memory in double; K3 is one thread per (row,
// lane), purely elementwise.
//
// A launch allocates nothing: the caller passes every output. Each entry
// point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include "penalty.cuh"

using namespace dftpav;

namespace {

constexpr int kFwdLanes = 32;  // lanes per K2 block (threadIdx.x)
constexpr int kFwdRows = 8;    // row slices per K2 block (threadIdx.y)
constexpr int kBwdThreads = 256;

__global__ void corridor_fwd_kernel(PenaltyArgs<float> a, float* out) {
  __shared__ double part[kFwdRows][kFwdLanes];
  const int b = blockIdx.x * kFwdLanes + threadIdx.x;
  double acc = 0.0;
  if (b < a.B)
    for (int r = threadIdx.y; r < a.R; r += kFwdRows)
      acc += double(corridor_fwd_row(a, r, b));
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && b < a.B) {
    double s = 0.0;
    for (int j = 0; j < kFwdRows; ++j) s += part[j][threadIdx.x];
    out[b] = float(s);
  }
}

__global__ void corridor_bwd_kernel(PenaltyArgs<float> a, const float* gbar,
                                    float* d_sig, float* d_dsig,
                                    float* d_wq) {
  const size_t i = (size_t)blockIdx.x * kBwdThreads + threadIdx.x;
  if (i >= (size_t)a.R * a.B) return;
  const int r = (int)(i / a.B), b = (int)(i % a.B);
  corridor_bwd_row(a, r, b, gbar[b], d_sig, d_dsig, d_wq);
}

PenaltyArgs<float> make_args(const float* sig, const float* dsig,
                             const float* wq, const float* cn,
                             const float* cp, const float* cm,
                             const float* le, int R, int B, int H) {
  PenaltyArgs<float> a;
  a.sig = sig; a.dsig = dsig; a.wq = wq; a.cn = cn; a.cp = cp; a.cm = cm;
  for (int e = 0; e < 4; ++e)
    for (int j = 0; j < 2; ++j) a.le[e][j] = le[2 * e + j];
  a.R = R; a.B = B; a.H = H;
  return a;
}

}  // namespace

extern "C" {

// sig, dsig [2, R, B]; wq [R, B]; cn, cp [H, 2, R, B]; cm [H, R, B];
// le: host vector of the 4 hull vertices (x, y) -> out [B].
int dftpav_corridor_fwd(const float* sig, const float* dsig, const float* wq,
                        const float* cn, const float* cp, const float* cm,
                        const float* le, int R, int B, int H, float* out,
                        void* stream) {
  if (H < 0 || H > kMaxH || R <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  const PenaltyArgs<float> a = make_args(sig, dsig, wq, cn, cp, cm, le, R, B,
                                         H);
  const dim3 block(kFwdLanes, kFwdRows);
  const int blocks = (B + kFwdLanes - 1) / kFwdLanes;
  corridor_fwd_kernel<<<blocks, block, 0, (cudaStream_t)stream>>>(a, out);
  return (int)cudaGetLastError();
}

// The same operands and the per-lane cotangent gbar [B] -> d_sig [2, R, B],
// d_dsig [2, R, B], d_wq [R, B].
int dftpav_corridor_bwd(const float* sig, const float* dsig, const float* wq,
                        const float* cn, const float* cp, const float* cm,
                        const float* le, const float* gbar, int R, int B,
                        int H, float* d_sig, float* d_dsig, float* d_wq,
                        void* stream) {
  if (H < 0 || H > kMaxH || R <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  const PenaltyArgs<float> a = make_args(sig, dsig, wq, cn, cp, cm, le, R, B,
                                         H);
  const size_t n = (size_t)R * B;
  const unsigned blocks = (unsigned)((n + kBwdThreads - 1) / kBwdThreads);
  corridor_bwd_kernel<<<blocks, kBwdThreads, 0, (cudaStream_t)stream>>>(
      a, gbar, d_sig, d_dsig, d_wq);
  return (int)cudaGetLastError();
}

}  // extern "C"
