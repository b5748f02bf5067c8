// The threads that share one lane (one scenario), and the host's stand-in
// for them.
//
// A team has G members. On the card (WarpTeam) the members are the 32
// threads of one warp and each object runs one member; in the g++ test
// harness (HostTeam) one object runs all G members in turn, so the same
// per-member code (kcost.cuh lane_eval, solve.cuh lane_solve) runs on a CPU
// with the same split of work and the same order of every sum. An object
// runs kRun members, member(k) for k < kRun; per-member values are passed
// to the combines as arrays of kRun.
//
// Combines:
//   sum       xor butterfly over the G members: at each level a member adds
//             its partner's value to its own (a + b == b + a exactly), so
//             every member ends with the bitwise identical total;
//   ballot    bit m set when member m's flag is;
//   reduce_scatter  recursive halving of NS slots per member: after it,
//             member m holds the totals of slots m * NS / G + q at its
//             slot q < NS / G, each summed in a fixed tree;
//   vsum / vmax  over the DP coordinates of a solver vector; each object
//             holds kVec of them, coordinate coord(k) at k. On the card, at
//             DP = 16 a half warp holds the 16 coordinates and both halves
//             hold the same ones; above 16 (multi-gear classes) thread m
//             holds coordinates m, m + 32, ..., valid(k) telling which are
//             below DP (the others stay 0), and a sum adds a thread's own
//             coordinates in that order before the butterfly over the warp.
// sync() orders the members' scratch writes before other members' reads
// (__syncwarp on the card).
#pragma once

#include "common.cuh"

namespace dftpav {

DFT_HD int popc(unsigned x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

template <int G_, int DP_>
struct HostTeam {
  static constexpr int G = G_, kRun = G_, DP = DP_, kVec = DP_;
  static_assert(G == 1 || DP == 16 || G == 32, "a team is one warp");
  int member(int k) const { return k; }
  int coord(int k) const { return k; }
  bool valid(int) const { return true; }
  void sync() const {}

  template <class V>
  V sum(const V* v) const {
    V a[G];
    for (int t = 0; t < G; ++t) a[t] = v[t];
    for (int off = G / 2; off > 0; off >>= 1) {
      V b[G];
      for (int t = 0; t < G; ++t) b[t] = a[t] + a[t ^ off];
      for (int t = 0; t < G; ++t) a[t] = b[t];
    }
    return a[0];
  }

  unsigned ballot(const bool* f) const {
    unsigned m = 0u;
    for (int t = 0; t < G; ++t)
      if (f[t]) m |= 1u << t;
    return m;
  }

  template <class T, int NS>
  void reduce_scatter(T (*acc)[NS]) const {
    int half = NS / 2;
    for (int off = G / 2; off > 0; off >>= 1, half >>= 1) {
      T nv[G][NS];
      for (int t = 0; t < G; ++t) {
        const int q = t ^ off;
        const bool bit = (t & off) != 0;
        for (int i = 0; i < half; ++i)
          nv[t][i] = bit ? acc[t][i + half] + acc[q][i + half]
                         : acc[t][i] + acc[q][i];
      }
      for (int t = 0; t < G; ++t)
        for (int i = 0; i < half; ++i) acc[t][i] = nv[t][i];
    }
  }

  // one member: the sums in coordinate order; more: the card's butterfly
  // over the 16 coordinates of a half warp, or above 16 each thread's own
  // coordinates m, m + 32, ... and then the butterfly over the warp
  template <class T>
  T vsum(const T* v) const {
    if (G == 1) {
      T s = T(0);
      for (int i = 0; i < DP; ++i) s += v[i];
      return s;
    }
    constexpr int W = DP == 16 ? 16 : 32;
    T a[W];
    for (int i = 0; i < W; ++i) {
      a[i] = v[i];
      for (int j = i + W; j < W * ((DP + W - 1) / W); j += W)
        a[i] = a[i] + (j < DP ? v[j] : T(0));
    }
    for (int off = W / 2; off > 0; off >>= 1) {
      T b[W];
      for (int i = 0; i < W; ++i) b[i] = a[i] + a[i ^ off];
      for (int i = 0; i < W; ++i) a[i] = b[i];
    }
    return a[0];
  }
  template <class T>
  T vmax(const T* v) const {
    T s = v[0];
    for (int i = 1; i < DP; ++i) s = m_max(s, v[i]);
    return s;
  }
};

#ifdef __CUDACC__
// One warp per lane; this thread is member m, and holds coordinate m % 16
// of every solver vector at DP = 16, coordinates m, m + 32, ... above.
template <int DP_>
struct WarpTeam {
  static constexpr int G = 32, kRun = 1, DP = DP_;
  static constexpr bool kHalf = DP == 16;
  static constexpr int kVec = kHalf ? 1 : (DP + 31) / 32;
  static_assert(kHalf || DP >= 32, "DP is 16 or at least 32");
  int m;
  __device__ __forceinline__ int member(int) const { return m; }
  __device__ __forceinline__ int coord(int k) const {
    return kHalf ? (m & 15) : m + 32 * k;
  }
  __device__ __forceinline__ bool valid(int k) const {
    return kHalf || m + 32 * k < DP;
  }
  // whether this thread writes coordinate coord(k) out (one per
  // coordinate)
  __device__ __forceinline__ bool owner(int k) const {
    return kHalf ? m < 16 : m + 32 * k < DP;
  }
  __device__ __forceinline__ void sync() const { __syncwarp(); }

  template <class V>
  __device__ __forceinline__ V sum(const V* v) const {
    V a = v[0];
    DFT_UNROLL
    for (int off = G / 2; off > 0; off >>= 1)
      a += __shfl_xor_sync(0xffffffffu, a, off);
    return a;
  }

  __device__ __forceinline__ unsigned ballot(const bool* f) const {
    return __ballot_sync(0xffffffffu, f[0]);
  }

  template <class T, int NS>
  __device__ __forceinline__ void reduce_scatter(T (*acc)[NS]) const {
    T* v = acc[0];
    DFT_UNROLL
    for (int off = G / 2, half = NS / 2; off > 0; off >>= 1, half >>= 1) {
      const bool bit = (m & off) != 0;
      DFT_UNROLL
      for (int i = 0; i < half; ++i) {
        const T send = bit ? v[i] : v[i + half];
        const T keep = bit ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
    }
  }

  template <class T>
  __device__ __forceinline__ T vsum(const T* v) const {
    T a = v[0];
    DFT_UNROLL
    for (int k = 1; k < kVec; ++k) a = a + v[k];
    DFT_UNROLL
    for (int off = kHalf ? 8 : 16; off > 0; off >>= 1)
      a += __shfl_xor_sync(0xffffffffu, a, off);
    return a;
  }
  template <class T>
  __device__ __forceinline__ T vmax(const T* v) const {
    T a = v[0];
    DFT_UNROLL
    for (int k = 1; k < kVec; ++k) a = m_max(a, v[k]);
    DFT_UNROLL
    for (int off = kHalf ? 8 : 16; off > 0; off >>= 1)
      a = m_max(a, __shfl_xor_sync(0xffffffffu, a, off));
    return a;
  }
};
#endif

}  // namespace dftpav
