// Static-corridor penalty of one sample row, as __host__ __device__ code:
// the per-row arithmetic of kernel A's corridor term (kcost.cuh) and of the
// corridor kernels K2 / K3 (penalty.cu), which replace the TPU kernels
// dftpav_tpu/ops/pallas_penalty.py _fwd_kernel and _bwd_kernel.
//
// Ego hull vertex e sits at sig + R le_e, R = [[u, -v], [v, u]] (the unit
// velocity, gear sign folded in); half-plane h has outward normal n_h
// through p_h. The row's hinge sum is
//   A = sum_{e < 4, h < H} sl1(n_h . (sig + R le_e - p_h)) * mask_h,
// and its partial derivatives in closed form (traj_optimizer.cpp:592-622).
#pragma once

#include "common.cuh"

namespace dftpav {

template <class T>
struct CorridorRow {
  T A;       // hinge sum
  T gx, gy;  // dA / dsig
  T gu, gv;  // dA / du, dA / dv
};

// The H half-planes of one sample row where they lie in memory: plane q
// (normal x, y of half-plane h at q = 2h, 2h + 1; its point likewise; its
// 0/1 mask at q = h) at n / p / m[q * stride].
template <class T>
struct Planes {
  const T* n;
  const T* p;
  const T* m;
  size_t stride;
};

// One row from its half-planes. The derivatives are summed only when
// want_g. The planes are read once, into arrays indexed only at compile
// time (H <= kMaxH), so they stay in registers; the sums run over
// (vertex e, half-plane h < H) in that order.
template <class T>
DFT_HD CorridorRow<T> corridor_row(T sx, T sy, T u, T v, const Planes<T>& pl,
                                   int H, const T (&le)[4][2], bool want_g) {
  T cnx[kMaxH], cny[kMaxH], cpx[kMaxH], cpy[kMaxH], cmh[kMaxH];
  DFT_UNROLL
  for (int h = 0; h < kMaxH; ++h)
    if (h < H) {
      cnx[h] = pl.n[(size_t)(2 * h) * pl.stride];
      cny[h] = pl.n[(size_t)(2 * h + 1) * pl.stride];
      cpx[h] = pl.p[(size_t)(2 * h) * pl.stride];
      cpy[h] = pl.p[(size_t)(2 * h + 1) * pl.stride];
      cmh[h] = pl.m[(size_t)h * pl.stride];
    }
  CorridorRow<T> c;
  c.A = T(0);
  c.gx = T(0);
  c.gy = T(0);
  c.gu = T(0);
  c.gv = T(0);
  DFT_UNROLL
  for (int e = 0; e < 4; ++e) {
    const T lex = le[e][0], ley = le[e][1];
    const T bx = sx + u * lex - v * ley;
    const T by = sy + v * lex + u * ley;
    DFT_UNROLL
    for (int h = 0; h < kMaxH; ++h) {
      if (h >= H) break;
      const T viol = cnx[h] * (bx - cpx[h]) + cny[h] * (by - cpy[h]);
      c.A += sl1(viol) * cmh[h];
      if (want_g) {
        const T s = sl1_grad(viol) * cmh[h];
        c.gx += s * cnx[h];
        c.gy += s * cny[h];
        c.gu += s * (cnx[h] * lex + cny[h] * ley);
        c.gv += s * (cny[h] * lex - cnx[h] * ley);
      }
    }
  }
  return c;
}

// Operands of K2 / K3 in the layout of dftpav_tpu_torch/ops/pallas_penalty.py:
// element (row r, lane b) of an [R, B] plane sits at r * B + b.
template <class T>
struct PenaltyArgs {
  const T* sig;    // [2, R, B]
  const T* dsig;   // [2, R, B], gear sign folded in
  const T* wq;     // [R, B] quadrature weight, wei_obs folded in
  const T* cn;     // [H, 2, R, B]
  const T* cp;     // [H, 2, R, B]
  const T* cm;     // [H, R, B] 0/1
  T le[4][2];      // hull vertices, clockwise
  int R, B, H;
};

// Row r of lane b: the unit velocity (|dsig|^2 clamped at 1e-8; no row is
// skipped) and the corridor row.
template <class T>
struct PenaltyRow {
  T u, v, inv_vn, wq;
  CorridorRow<T> c;
};

template <class T>
DFT_HD PenaltyRow<T> penalty_row(const PenaltyArgs<T>& a, int r, int b,
                                 bool want_g) {
  const size_t B = (size_t)a.B, R = (size_t)a.R, i = (size_t)r * B + b;
  const T dx = a.dsig[i], dy = a.dsig[R * B + i];
  PenaltyRow<T> p;
  p.inv_vn = m_rsqrt(m_max(dx * dx + dy * dy, T(1e-8)));
  p.u = dx * p.inv_vn;
  p.v = dy * p.inv_vn;
  p.wq = a.wq[i];
  Planes<T> pl;
  pl.n = a.cn + i;
  pl.p = a.cp + i;
  pl.m = a.cm + i;
  pl.stride = R * B;
  p.c = corridor_row(a.sig[i], a.sig[R * B + i], p.u, p.v, pl, a.H, a.le,
                     want_g);
  return p;
}

// K2's term of row r, lane b: wq * A.
template <class T>
DFT_HD T corridor_fwd_row(const PenaltyArgs<T>& a, int r, int b) {
  const PenaltyRow<T> p = penalty_row(a, r, b, false);
  return p.wq * p.c.A;
}

// K3 at row r, lane b with the lane's cotangent gbar: writes d_sig [2, R, B],
// d_dsig [2, R, B] and d_wq [R, B] at (r, b).
template <class T>
DFT_HD void corridor_bwd_row(const PenaltyArgs<T>& a, int r, int b, T gbar,
                             T* d_sig, T* d_dsig, T* d_wq) {
  const PenaltyRow<T> p = penalty_row(a, r, b, true);
  const size_t RB = (size_t)a.R * a.B, i = (size_t)r * a.B + b;
  const T wg = p.wq * gbar;
  const T du = wg * p.c.gu, dv = wg * p.c.gv;
  d_sig[i] = wg * p.c.gx;
  d_sig[RB + i] = wg * p.c.gy;
  d_dsig[i] = (du * (T(1) - p.u * p.u) - dv * p.u * p.v) * p.inv_vn;
  d_dsig[RB + i] = (-du * p.u * p.v + dv * (T(1) - p.v * p.v)) * p.inv_vn;
  d_wq[i] = gbar * p.c.A;
}

}  // namespace dftpav
