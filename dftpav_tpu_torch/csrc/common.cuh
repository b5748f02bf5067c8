// Scalar helpers shared by the kernels' headers: the host/device qualifier,
// float and double overloads of the math functions, and the smoothed-L1
// hinge with its derivative. Like every header here, this compiles with nvcc
// (the kernels, float) and with g++ (the host test harnesses, double and
// float).
#pragma once

#ifdef __CUDACC__
#define DFT_HD __host__ __device__ __forceinline__
#define DFT_UNROLL _Pragma("unroll")
#else
#include <cmath>
#define DFT_HD inline
#define DFT_UNROLL
#endif

namespace dftpav {

DFT_HD float m_sqrt(float x) { return sqrtf(x); }
DFT_HD double m_sqrt(double x) { return sqrt(x); }
DFT_HD float m_exp(float x) { return expf(x); }
DFT_HD double m_exp(double x) { return exp(x); }
DFT_HD float m_log(float x) { return logf(x); }
DFT_HD double m_log(double x) { return log(x); }
DFT_HD float m_floor(float x) { return floorf(x); }
DFT_HD double m_floor(double x) { return floor(x); }
DFT_HD float m_cos(float x) { return cosf(x); }
DFT_HD double m_cos(double x) { return cos(x); }
DFT_HD float m_sin(float x) { return sinf(x); }
DFT_HD double m_sin(double x) { return sin(x); }
DFT_HD float m_abs(float x) { return fabsf(x); }
DFT_HD double m_abs(double x) { return fabs(x); }
#ifdef __CUDACC__
DFT_HD bool m_isfinite(float x) { return isfinite(x); }
DFT_HD bool m_isfinite(double x) { return isfinite(x); }
#else
inline bool m_isfinite(float x) { return std::isfinite(x); }
inline bool m_isfinite(double x) { return std::isfinite(x); }
#endif
template <class T> DFT_HD T m_max(T a, T b) { return a > b ? a : b; }
template <class T> DFT_HD T m_min(T a, T b) { return a < b ? a : b; }
template <class T> DFT_HD T m_rsqrt(T x) { return T(1) / m_sqrt(x); }

// Smoothed-L1 hinge (positiveSmoothedL1, traj_optimizer.cpp:783-806): 0 for
// x <= 0, a cubic blend on (0, pe), x - pe/2 above; and its derivative
// (dftpav_tpu/ops/pallas_penalty.py _smoothed_l1_grad).
template <class T> DFT_HD T sl1(T x) {
  const T pe = T(1.0e-4);
  const T f3c = T(1.0 / (1.0e-4 * 1.0e-4));
  const T f4c = T(-0.5 * (1.0 / (1.0e-4 * 1.0e-4)) / 1.0e-4);
  if (x <= T(0)) return T(0);
  if (x < pe) return (f4c * x + f3c) * x * x * x;
  return x - T(0.5 * 1.0e-4);
}
template <class T> DFT_HD T sl1_grad(T x) {
  const T pe = T(1.0e-4);
  const T a = T(4.0 * (-0.5 * (1.0 / (1.0e-4 * 1.0e-4)) / 1.0e-4));
  const T b = T(3.0 * (1.0 / (1.0e-4 * 1.0e-4)));
  if (x <= T(0)) return T(0);
  if (x < pe) return (a * x + b) * x * x;
  return T(1);
}

// Largest number of corridor half-planes per sample row the kernels take.
constexpr int kMaxH = 8;

// Largest number of gear segments the kernels take.
constexpr int kMaxS = 8;

// Per-segment slots of a class's tables (KW, LaneData, Layout) in the
// kernels of S segments: four in the S <= 4 kernels, whose code a wider
// table would change (it moves their kernel parameters, and a table
// indexed at run time may then live on their stack), kMaxS in the others.
template <int S>
constexpr int kSlots = S <= 4 ? 4 : kMaxS;

// a[s] for s < 4 by selects, so that an array of a struct in registers is
// never indexed at run time.
template <class V>
DFT_HD V pick(const V* a, int s) {
  return s == 0 ? a[0] : (s == 1 ? a[1] : (s == 2 ? a[2] : a[3]));
}

// a[s] for s < S, the kernels of S segments: at S <= 4 the chain above,
// else one select per segment.
template <int S, class V>
DFT_HD V pick_s(const V* a, int s) {
  if constexpr (S <= 4) {
    return pick(a, s);
  } else {
    V v = a[S - 1];
    DFT_UNROLL
    for (int j = S - 2; j >= 0; --j) v = s == j ? a[j] : v;
    return v;
  }
}

}  // namespace dftpav
