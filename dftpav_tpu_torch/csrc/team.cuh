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
//             holds kVec of them, coordinate coord(k) at k (on the card a
//             half warp holds the 16 coordinates, and both halves hold
//             the same ones).
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
  int member(int k) const { return k; }
  int coord(int k) const { return k; }
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
  // over the 16 coordinates of a half warp
  template <class T>
  T vsum(const T* v) const {
    if (G == 1) {
      T s = T(0);
      for (int i = 0; i < DP; ++i) s += v[i];
      return s;
    }
    static_assert(G == 1 || DP == 16, "a warp team holds 16 coordinates");
    T a[DP];
    for (int i = 0; i < DP; ++i) a[i] = v[i];
    for (int off = DP / 2; off > 0; off >>= 1) {
      T b[DP];
      for (int i = 0; i < DP; ++i) b[i] = a[i] + a[i ^ off];
      for (int i = 0; i < DP; ++i) a[i] = b[i];
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
// of every solver vector.
template <int DP_>
struct WarpTeam {
  static constexpr int G = 32, kRun = 1, DP = DP_, kVec = 1;
  static_assert(DP == 16, "a half warp holds the 16 decision coordinates");
  int m;
  __device__ __forceinline__ int member(int) const { return m; }
  __device__ __forceinline__ int coord(int) const { return m & (DP - 1); }
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
    for (int off = DP / 2; off > 0; off >>= 1)
      a += __shfl_xor_sync(0xffffffffu, a, off);
    return a;
  }
  template <class T>
  __device__ __forceinline__ T vmax(const T* v) const {
    T a = v[0];
    DFT_UNROLL
    for (int off = DP / 2; off > 0; off >>= 1)
      a = m_max(a, __shfl_xor_sync(0xffffffffu, a, off));
    return a;
  }
};
#endif

}  // namespace dftpav
