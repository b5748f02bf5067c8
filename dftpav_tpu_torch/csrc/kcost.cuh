// Objective and hand-written gradient of the trajectory-optimization cost for
// ONE lane (one scenario), as __host__ __device__ code.
//
// Replaces the objective half of the TPU whole-solve kernel:
// dftpav_tpu/ops/kcost.py eval_fg (traced with jax.vjp inside
// dftpav_tpu/ops/pallas_solve.py _kernel). Same math as
// dftpav_tpu_torch/ops/kcost.py eval_cost, whose autograd gradient is the
// plain reference for the one written out here:
//
//   * _pre: rhs per dimension = (head p, v*dT, a*dT^2 | inner waypoints |
//     tail p, v*dT, a*dT^2), T = virtual_to_real(vt * sigma), dT = T / N;
//   * jerk energy dT^-5 rhs^T Q rhs plus wei_time * T;
//   * per sample row r: sig = P0 rhs, dsig = P1 rhs / dT, ddsig = P2 rhs / dT^2,
//     then the corridor hinge (E x H, penalty.cuh corridor_row, shared with
//     the corridor kernels), feasibility (speed, acceleration, two-sided
//     curvature) and the dual log-sum-exp obstacle distance.
//
// Gradient: every row's penalty depends only on (sig, dsig, ddsig, dT), so it
// is differentiated row-locally -- corridor and feasibility in closed form,
// the obstacle block by forward-mode dual numbers over (sig_x, sig_y, u, v,
// dT) -- and chained back through P_o^T to rhs, then through _pre to x.
// Rows whose weight is zero (invalid samples, obstacle gate closed, hinge
// inactive) contribute exactly zero and are skipped; JAX's where-selects give
// the same zeros.
//
// The same header compiles with nvcc (kernels.cu, float) and with g++ (the
// host test harness, double), so the hand gradient is checked against
// autograd on the CPU before it runs on the card.
#pragma once

#include "penalty.cuh"

namespace dftpav {

// ---------------------------------------------------------------------------
// Forward-mode dual numbers (value + K tangents)
// ---------------------------------------------------------------------------
template <class T, int K>
struct Dual {
  T v;
  T d[K];
  DFT_HD Dual() : v(0) {
    for (int i = 0; i < K; ++i) d[i] = 0;
  }
  DFT_HD Dual(T x) : v(x) {
    for (int i = 0; i < K; ++i) d[i] = 0;
  }
};

template <class T> DFT_HD T val(T x) { return x; }
template <class T, int K> DFT_HD T val(const Dual<T, K>& x) { return x.v; }

#define DFT_DUAL_BINOP(OP, VAL, DER)                                          \
  template <class T, int K>                                                   \
  DFT_HD Dual<T, K> operator OP(const Dual<T, K>& a, const Dual<T, K>& b) {   \
    Dual<T, K> r;                                                             \
    r.v = VAL;                                                                \
    for (int i = 0; i < K; ++i) r.d[i] = DER;                                 \
    return r;                                                                 \
  }
DFT_DUAL_BINOP(+, a.v + b.v, a.d[i] + b.d[i])
DFT_DUAL_BINOP(-, a.v - b.v, a.d[i] - b.d[i])
DFT_DUAL_BINOP(*, a.v * b.v, a.d[i] * b.v + a.v * b.d[i])
#undef DFT_DUAL_BINOP

template <class T, int K>
DFT_HD Dual<T, K> operator/(const Dual<T, K>& a, const Dual<T, K>& b) {
  Dual<T, K> r;
  r.v = a.v / b.v;
  for (int i = 0; i < K; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) / b.v;
  return r;
}
template <class T, int K>
DFT_HD Dual<T, K> operator-(const Dual<T, K>& a) {
  Dual<T, K> r;
  r.v = -a.v;
  for (int i = 0; i < K; ++i) r.d[i] = -a.d[i];
  return r;
}
template <class T, int K>
DFT_HD Dual<T, K> operator+(const Dual<T, K>& a, T b) {
  Dual<T, K> r = a;
  r.v = a.v + b;
  return r;
}
template <class T, int K>
DFT_HD Dual<T, K> operator+(T a, const Dual<T, K>& b) {
  Dual<T, K> r = b;
  r.v = a + b.v;
  return r;
}
template <class T, int K>
DFT_HD Dual<T, K> operator-(const Dual<T, K>& a, T b) {
  Dual<T, K> r = a;
  r.v = a.v - b;
  return r;
}
template <class T, int K>
DFT_HD Dual<T, K> operator-(T a, const Dual<T, K>& b) {
  Dual<T, K> r;
  r.v = a - b.v;
  for (int i = 0; i < K; ++i) r.d[i] = -b.d[i];
  return r;
}
template <class T, int K>
DFT_HD Dual<T, K> operator*(const Dual<T, K>& a, T b) {
  Dual<T, K> r;
  r.v = a.v * b;
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * b;
  return r;
}
template <class T, int K>
DFT_HD Dual<T, K> operator*(T a, const Dual<T, K>& b) {
  return b * a;
}
template <class T, int K>
DFT_HD Dual<T, K> operator/(const Dual<T, K>& a, T b) {
  Dual<T, K> r;
  r.v = a.v / b;
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] / b;
  return r;
}
template <class T, int K>
DFT_HD Dual<T, K> m_exp(const Dual<T, K>& a) {
  Dual<T, K> r;
  r.v = m_exp(a.v);
  for (int i = 0; i < K; ++i) r.d[i] = r.v * a.d[i];
  return r;
}
template <class T, int K>
DFT_HD Dual<T, K> m_log(const Dual<T, K>& a) {
  Dual<T, K> r;
  r.v = m_log(a.v);
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] / a.v;
  return r;
}
template <class T, int K>
DFT_HD Dual<T, K> m_rsqrt(const Dual<T, K>& a) {
  Dual<T, K> r;
  r.v = T(1) / m_sqrt(a.v);
  const T k = T(-0.5) * r.v / a.v;
  for (int i = 0; i < K; ++i) r.d[i] = k * a.d[i];
  return r;
}

// Smoothed-L1 hinge of a dual number (common.cuh has the scalar one)
template <class T, int K>
DFT_HD Dual<T, K> sl1(const Dual<T, K>& x) {
  Dual<T, K> r;
  r.v = sl1(x.v);
  const T g = sl1_grad(x.v);
  for (int i = 0; i < K; ++i) r.d[i] = g * x.d[i];
  return r;
}

// ---------------------------------------------------------------------------
// Parameters and per-lane inputs
// ---------------------------------------------------------------------------

// Layout of the weight vector handed to the C entry points (host order).
enum WIdx {
  W_WEI_OBS = 0, W_WEI_SUR, W_WEI_FEAS, W_WEI_TIME,
  W_MFV, W_MFA, W_MFC, W_MBV, W_MBA, W_MBC,
  W_MINI_T, W_EPIS, W_ALPHA, W_COST_SCALE, W_NEAR_R2, W_D_MIN, W_SIGMA,
  W_LE = 17,      // 8 values: hull vertices (x, y) x 4, clockwise
  W_EH = 25,      // 8 values: unit edge vectors (x, y) x 4
  W_LEN = 33
};

template <class T>
struct KW {
  T wei_obs, wei_sur, wei_feas, wei_time;
  T mfv, mfa, mfc, mbv, mba, mbc;
  T mini_t, epis, alpha, cost_scale, near_r2, d_min, sigma;
  T le[4][2], eh[4][2];
};

template <class T, class S>
DFT_HD KW<T> make_kw(const S* a) {
  KW<T> w;
  w.wei_obs = T(a[W_WEI_OBS]); w.wei_sur = T(a[W_WEI_SUR]);
  w.wei_feas = T(a[W_WEI_FEAS]); w.wei_time = T(a[W_WEI_TIME]);
  w.mfv = T(a[W_MFV]); w.mfa = T(a[W_MFA]); w.mfc = T(a[W_MFC]);
  w.mbv = T(a[W_MBV]); w.mba = T(a[W_MBA]); w.mbc = T(a[W_MBC]);
  w.mini_t = T(a[W_MINI_T]); w.epis = T(a[W_EPIS]); w.alpha = T(a[W_ALPHA]);
  w.cost_scale = T(a[W_COST_SCALE]); w.near_r2 = T(a[W_NEAR_R2]);
  w.d_min = T(a[W_D_MIN]); w.sigma = T(a[W_SIGMA]);
  for (int e = 0; e < 4; ++e)
    for (int j = 0; j < 2; ++j) {
      w.le[e][j] = T(a[W_LE + 2 * e + j]);
      w.eh[e][j] = T(a[W_EH + 2 * e + j]);
    }
  return w;
}

// Lane-minor slabs (the layout of ops/kcost.py KScenario): element (row, lane)
// of an [rows, B] slab sits at row * B + lane.
template <class T>
struct Slabs {
  const T* bnd;    // [12.., B]
  const T* misc;   // [2 + 3 O.., B]
  const T* cn;     // [H, 2, R, B]
  const T* cp;     // [H, 2, R, B]
  const T* cm;     // [H, R, B]
  const T* obs;    // [O, 2, 6 Po, B]
  int B, R, H, O, Po;
};

template <class S, class T>
DFT_HD S horner0(const T* c, const S& tau) {
  S h = S(c[5]);
  for (int k = 4; k >= 0; --k) h = h * tau + c[k];
  return h;
}
template <class S, class T>
DFT_HD S horner1(const T* c, const S& tau) {
  S h = S(T(5) * c[5]);
  for (int k = 4; k >= 1; --k) h = h * tau + T(k) * c[k];
  return h;
}

template <class S, class T, int K>
DFT_HD S neg_lse(const S* vals, T alpha) {
  S neg[K];
  T m = T(0);
  for (int i = 0; i < K; ++i) {
    neg[i] = (-alpha) * vals[i];
    m = i == 0 ? val(neg[0]) : m_max(m, val(neg[i]));
  }
  S s = m_exp(neg[0] - m);
  for (int i = 1; i < K; ++i) s = s + m_exp(neg[i] - m);
  return (-(m_log(s) + m)) / alpha;
}
template <class S, class T, int K>
DFT_HD S pos_lse(const S* vals, T alpha) {
  S pos[K];
  T m = T(0);
  for (int i = 0; i < K; ++i) {
    pos[i] = alpha * vals[i];
    m = i == 0 ? val(pos[0]) : m_max(m, val(pos[i]));
  }
  S s = m_exp(pos[0] - m);
  for (int i = 1; i < K; ++i) s = s + m_exp(pos[i] - m);
  return (m_log(s) + m) / alpha;
}

// One obstacle's penalty at one valid sample row (kcost.py obstacle_cost):
// 0 when the obstacle is far, masked, or the signed distance is above d_min.
// S is T (value) or Dual<T, 5> (value + d/d(sig_x, sig_y, u, v, dT)).
// cx, cy: the obstacle's coefficient rows for this lane, stride B.
template <class S, class T>
DFT_HD S obstacle_pen(const S& sx, const S& sy, const S& u, const S& v,
                      const S& dT, T frac, T dt_o, T rel_t0, const T* cx,
                      const T* cy, size_t B, int Po, const KW<T>& w) {
  const S pt = rel_t0 + frac * dT;
  const T total = dt_o * T(Po);
  const bool inside = val(pt) < total;
  const S ft = (inside ? pt : S(total)) / dt_o;
  T idxf = m_floor(val(ft));
  idxf = m_min(m_max(idxf, T(0)), T(Po - 1));
  const int idx = int(idxf);
  const S tau = ft - idxf;

  T px[6], py[6];
  for (int k = 0; k < 6; ++k) {
    px[k] = cx[(size_t)(6 * idx + k) * B];
    py[k] = cy[(size_t)(6 * idx + k) * B];
  }
  const S pin_x = horner0(px, tau);
  const S pin_y = horner0(py, tau);

  // end state of the last piece, constant-acceleration extrapolation
  const T inv_dt = T(1) / dt_o;
  T lx[6], ly[6];
  for (int k = 0; k < 6; ++k) {
    lx[k] = cx[(size_t)(6 * (Po - 1) + k) * B];
    ly[k] = cy[(size_t)(6 * (Po - 1) + k) * B];
  }
  T pe_x = lx[0], pe_y = ly[0], ve_x = T(0), ve_y = T(0), ae_x = T(0),
    ae_y = T(0);
  for (int k = 1; k < 6; ++k) {
    pe_x = pe_x + lx[k];
    pe_y = pe_y + ly[k];
    ve_x = k == 1 ? lx[1] : ve_x + T(k) * lx[k];
    ve_y = k == 1 ? ly[1] : ve_y + T(k) * ly[k];
    if (k >= 2) {
      ae_x = k == 2 ? T(2) * lx[2] : ae_x + T(k * (k - 1)) * lx[k];
      ae_y = k == 2 ? T(2) * ly[2] : ae_y + T(k * (k - 1)) * ly[k];
    }
  }
  ve_x = ve_x * inv_dt;
  ve_y = ve_y * inv_dt;
  ae_x = ae_x * inv_dt * inv_dt;
  ae_y = ae_y * inv_dt * inv_dt;
  const S ex = val(pt) - total > T(0) ? pt - total : S(T(0));
  const S half_ex2 = (T(0.5) * ex) * ex;
  const S p_x = inside ? pin_x : (pe_x + ex * ve_x) + half_ex2 * ae_x;
  const S p_y = inside ? pin_y : (pe_y + ex * ve_y) + half_ex2 * ae_y;

  // heading frame: derivative of the selected (or extrapolated last) piece
  const S tau_r = inside ? tau : T(1) + ex / dt_o;
  const int pr = inside ? idx : Po - 1;
  for (int k = 0; k < 6; ++k) {
    px[k] = cx[(size_t)(6 * pr + k) * B];
    py[k] = cy[(size_t)(6 * pr + k) * B];
  }
  const S vr_x = horner1(px, tau_r);
  const S vr_y = horner1(py, tau_r);
  const S vrn2 = vr_x * vr_x + vr_y * vr_y;
  const S inv_vrn = m_rsqrt(val(vrn2) > T(1e-24) ? vrn2 : S(T(1e-24)));
  const S uo = vr_x * inv_vrn;
  const S vo = vr_y * inv_vrn;

  const S rel_x = p_x - sx;
  const S rel_y = p_y - sy;
  if (!(val(rel_x * rel_x + rel_y * rel_y) <= w.near_r2)) return S(T(0));

  S He[4][2], Ho[4][2], Rle[4][2], Rlo[4][2];
  for (int e = 0; e < 4; ++e) {
    const T ehx = w.eh[e][0], ehy = w.eh[e][1];
    const T lex = w.le[e][0], ley = w.le[e][1];
    He[e][0] = (-v) * ehx - u * ehy;
    He[e][1] = u * ehx - v * ehy;
    Ho[e][0] = (-vo) * ehx - uo * ehy;
    Ho[e][1] = uo * ehx - vo * ehy;
    Rle[e][0] = u * lex - v * ley;
    Rle[e][1] = v * lex + u * ley;
    Rlo[e][0] = uo * lex - vo * ley;
    Rlo[e][1] = vo * lex + uo * ley;
  }
  S d_all[8];
  S cross[4];
  for (int e = 0; e < 4; ++e) {
    const S hx = He[e][0], hy = He[e][1];
    const S d_tilde = hx * (rel_x - Rle[e][0]) + hy * (rel_y - Rle[e][1]);
    for (int f = 0; f < 4; ++f) cross[f] = hx * Rlo[f][0] + hy * Rlo[f][1];
    d_all[e] = neg_lse<S, T, 4>(cross, w.alpha) + d_tilde;
  }
  for (int f = 0; f < 4; ++f) {
    const S hx = Ho[f][0], hy = Ho[f][1];
    const S d_tilde =
        hx * ((-rel_x) - Rlo[f][0]) + hy * ((-rel_y) - Rlo[f][1]);
    for (int e = 0; e < 4; ++e) cross[e] = hx * Rle[e][0] + hy * Rle[e][1];
    d_all[4 + f] = neg_lse<S, T, 4>(cross, w.alpha) + d_tilde;
  }
  const S d_val = w.d_min - pos_lse<S, T, 8>(d_all, w.alpha);
  if (!(val(d_val) > T(0))) return S(T(0));
  return sl1(d_val);
}

template <int N>
struct KDims {
  static constexpr int C = N + 5;                 // rhs rows per dimension
  static constexpr int NIN = 2 * (N - 1);         // inner-waypoint rows
  static constexpr int DIM = NIN + 1;             // decision length (S = 1)
  static constexpr int DP = ((DIM + 7) / 8) * 8 > 16 ? ((DIM + 7) / 8) * 8 : 16;
};

// The threads that work on one lane. Solo is one thread (the host harness);
// the kernels use a group of G threads of one warp (kernels.cu WarpGroup):
// each takes every G-th sample row, sum() all-reduces a per-lane partial so
// that every member holds the identical total and takes the identical solver
// decisions, and bcast(v, j) hands every member member j's v.
struct Solo {
  static constexpr int size = 1;
  DFT_HD int rank() const { return 0; }
  template <class V> DFT_HD V sum(V v) const { return v; }
  template <class V> DFT_HD V bcast(V v, int) const { return v; }
};

// f (scaled by cost_scale) and, if g != nullptr, its gradient g[DP] at the
// decision vector x[DP] of lane `lane`. P [3][R][C], Q [C][C], gridc [2][R].
template <class T, int N, class Grp = Solo>
DFT_HD T lane_fg(const T* x, T* g, const Slabs<T>& sl, int lane, const T* P,
                 const T* Q, const T* gridc, const KW<T>& w,
                 const Grp& grp = Grp()) {
  constexpr int C = KDims<N>::C;
  constexpr int NIN = KDims<N>::NIN;
  constexpr int DP = KDims<N>::DP;
  const size_t B = (size_t)sl.B;
  const int R = sl.R, H = sl.H, O = sl.O, Po = sl.Po;
  const T* bnd = sl.bnd + lane;

  // ---- _pre ----
  const T vt = x[NIN] * w.sigma;
  const T Tpos = (T(0.5) * vt + T(1)) * vt + T(1);
  const T qneg = (T(0.5) * vt - T(1)) * vt + T(1);
  const T Ttot = (vt > T(0) ? Tpos : T(1) / qneg) + w.mini_t;
  const T dT = Ttot / T(N);
  const T dT2 = dT * dT;
  T rhs[2][C];
  for (int d = 0; d < 2; ++d) {
    rhs[d][0] = bnd[(size_t)d * B];
    rhs[d][1] = bnd[(size_t)(2 + d) * B] * dT;
    rhs[d][2] = bnd[(size_t)(4 + d) * B] * dT2;
    for (int j = 0; j < N - 1; ++j) rhs[d][3 + j] = x[2 * j + d];
    rhs[d][N + 2] = bnd[(size_t)(6 + d) * B];
    rhs[d][N + 3] = bnd[(size_t)(8 + d) * B] * dT;
    rhs[d][N + 4] = bnd[(size_t)(10 + d) * B] * dT2;
  }

  // ---- jerk energy + time ----
  // The quadratic form cancels heavily (Q's entries are large next to the
  // energy), so it is summed in double, like the per-row cost sums below:
  // float sums over ~170 terms otherwise cost ~3e-5 relative in f.
  const T invdT = T(1) / dT;
  const T invdT2 = invdT * invdT;
  const T i5 = invdT2 * invdT2 * invdT;
  T qr[2][C];
  double energy = 0.0;
  for (int d = 0; d < 2; ++d) {
    for (int i = 0; i < C; ++i) {
      double s = 0.0;
      for (int k = 0; k < C; ++k) s += double(Q[i * C + k]) * rhs[d][k];
      qr[d][i] = T(s);
      energy += double(rhs[d][i]) * s;
    }
  }
  const T jerk = T(energy * double(i5));

  // ---- per-lane constants ----
  const T sgl = sl.misc[lane];
  const bool fwd = sgl > T(0);
  const T max_vel = fwd ? w.mfv : w.mbv;
  const T max_acc = fwd ? w.mfa : w.mba;
  const T max_cur = fwd ? w.mfc : w.mbc;
  const T* cn = sl.cn + lane;
  const T* cp = sl.cp + lane;
  const T* cm = sl.cm + lane;

  const bool want_g = g != nullptr;
  T G[2][C];              // d f / d rhs_d through the sample maps P_o
  if (want_g)
    for (int d = 0; d < 2; ++d)
      for (int c = 0; c < C; ++c) G[d][c] = T(0);
  T g_dT = T(0);
  double f_corr = 0.0, f_feas = 0.0, f_dyn = 0.0;

  for (int r = grp.rank(); r < R; r += Grp::size) {
    const T omg = gridc[r];
    if (!(omg > T(0))) continue;
    const T* P0 = P + (size_t)r * C;
    const T* P1 = P + (size_t)(R + r) * C;
    const T* P2 = P + (size_t)(2 * R + r) * C;
    // sample maps in double: the derivative rows cancel large terms of
    // opposite sign, and float sums there cost ~3e-5 relative in f
    double s0[2] = {0.0, 0.0}, s1[2] = {0.0, 0.0}, s2[2] = {0.0, 0.0};
    for (int c = 0; c < C; ++c) {
      for (int d = 0; d < 2; ++d) {
        s0[d] += double(P0[c]) * double(rhs[d][c]);
        s1[d] += double(P1[c]) * double(rhs[d][c]);
        s2[d] += double(P2[c]) * double(rhs[d][c]);
      }
    }
    const T sx = T(s0[0]), sy = T(s0[1]);
    const T dsx = T(s1[0]) * invdT, dsy = T(s1[1]) * invdT;
    const T ddx = T(s2[0]) * invdT2, ddy = T(s2[1]) * invdT2;
    const T vn2 = dsx * dsx + dsy * dsy;
    if (!(vn2 >= T(1e-8))) continue;             // invalid row: weight 0
    const T inv_vn = m_rsqrt(vn2);
    const T vel2_reci = T(1) / vn2;
    const T vel2_reci_e = T(1) / (vn2 + w.epis);
    const T vel32 = vel2_reci_e * m_sqrt(vel2_reci_e);
    const T wq = omg * dT;
    const T u = dsx * inv_vn * sgl;
    const T v = dsy * inv_vn * sgl;

    // corridor: A = sum_eh sl1(viol_eh) * mask_h
    T cnx[kMaxH], cny[kMaxH], cpx[kMaxH], cpy[kMaxH], cmh[kMaxH];
    for (int h = 0; h < H; ++h) {
      cnx[h] = cn[((size_t)(2 * h) * R + r) * B];
      cny[h] = cn[((size_t)(2 * h + 1) * R + r) * B];
      cpx[h] = cp[((size_t)(2 * h) * R + r) * B];
      cpy[h] = cp[((size_t)(2 * h + 1) * R + r) * B];
      cmh[h] = cm[((size_t)h * R + r) * B];
    }
    const CorridorRow<T> cr = corridor_row(sx, sy, u, v, cnx, cny, cpx, cpy,
                                           cmh, H, w.le, want_g);
    const T A = cr.A, gA_sx = cr.gx, gA_sy = cr.gy, gA_u = cr.gu,
            gA_v = cr.gv;

    // feasibility
    const T z1 = ddx * dsx + ddy * dsy;
    const T z3 = ddy * dsx - ddx * dsy;
    const T vv = vn2 - max_vel * max_vel;
    const T va = z1 * z1 * vel2_reci - max_acc * max_acc;
    const T cur = z3 * vel32;
    const T F = sl1(vv) + sl1(va) +
                T(10) * (sl1(cur - max_cur) + sl1(-cur - max_cur));

    // dynamic obstacles
    T D = T(0);
    T gD[5] = {T(0), T(0), T(0), T(0), T(0)};
    const T frac = gridc[R + r];
    for (int o = 0; o < O; ++o) {
      if (!(sl.misc[(size_t)(2 + 2 * O + o) * B + lane] > T(0.5))) continue;
      const T dt_o = sl.misc[(size_t)(2 + o) * B + lane];
      const T rel_t0 = sl.misc[(size_t)(2 + O + o) * B + lane];
      const T* cx = sl.obs + (size_t)(2 * o) * 6 * Po * B + lane;
      const T* cy = sl.obs + (size_t)(2 * o + 1) * 6 * Po * B + lane;
      const T pen = obstacle_pen<T, T>(sx, sy, u, v, dT, frac, dt_o, rel_t0,
                                       cx, cy, B, Po, w);
      if (!(pen > T(0))) continue;
      D += pen;
      if (want_g) {
        typedef Dual<T, 5> D5;
        D5 a[5];
        const T in[5] = {sx, sy, u, v, dT};
        for (int i = 0; i < 5; ++i) {
          a[i] = D5(in[i]);
          a[i].d[i] = T(1);
        }
        const D5 pd = obstacle_pen<D5, T>(a[0], a[1], a[2], a[3], a[4], frac,
                                          dt_o, rel_t0, cx, cy, B, Po, w);
        for (int i = 0; i < 5; ++i) gD[i] += pd.d[i];
      }
    }

    f_corr += double(wq * A);
    f_feas += double(wq * F);
    f_dyn += double(wq * D);
    if (!want_g) continue;

    // ---- row-local gradient ----
    g_dT += omg * (w.wei_obs * A + w.wei_feas * F + w.wei_sur * D);
    const T g_sx = wq * (w.wei_obs * gA_sx + w.wei_sur * gD[0]);
    const T g_sy = wq * (w.wei_obs * gA_sy + w.wei_sur * gD[1]);
    const T g_u = wq * (w.wei_obs * gA_u + w.wei_sur * gD[2]);
    const T g_v = wq * (w.wei_obs * gA_v + w.wei_sur * gD[3]);
    g_dT += wq * w.wei_sur * gD[4];
    // (u, v) = sgl * dsig / |dsig|: project out the radial component
    const T nx = dsx * inv_vn, ny = dsy * inv_vn;
    const T proj = g_u * nx + g_v * ny;
    T g_dsx = sgl * inv_vn * (g_u - nx * proj);
    T g_dsy = sgl * inv_vn * (g_v - ny * proj);
    // feasibility in closed form
    const T wqf = wq * w.wei_feas;
    const T dF_vv = sl1_grad(vv);
    const T dF_va = sl1_grad(va);
    const T dF_cur = T(10) * (sl1_grad(cur - max_cur) - sl1_grad(-cur - max_cur));
    const T g_vn2 = dF_vv - dF_va * z1 * z1 * vel2_reci * vel2_reci -
                    dF_cur * T(1.5) * cur * vel2_reci_e;
    const T g_z1 = dF_va * T(2) * z1 * vel2_reci;
    const T g_z3 = dF_cur * vel32;
    g_dsx += wqf * (g_vn2 * T(2) * dsx + g_z1 * ddx + g_z3 * ddy);
    g_dsy += wqf * (g_vn2 * T(2) * dsy + g_z1 * ddy - g_z3 * ddx);
    const T g_ddx = wqf * (g_z1 * dsx - g_z3 * dsy);
    const T g_ddy = wqf * (g_z1 * dsy + g_z3 * dsx);
    // dsig = P1 rhs / dT, ddsig = P2 rhs / dT^2
    g_dT -= (g_dsx * dsx + g_dsy * dsy) * invdT +
            T(2) * (g_ddx * ddx + g_ddy * ddy) * invdT;
    const T c0[2] = {g_sx, g_sy};
    const T c1[2] = {g_dsx * invdT, g_dsy * invdT};
    const T c2[2] = {g_ddx * invdT2, g_ddy * invdT2};
    for (int d = 0; d < 2; ++d)
      for (int c = 0; c < C; ++c)
        G[d][c] += c0[d] * P0[c] + c1[d] * P1[c] + c2[d] * P2[c];
  }

  f_corr = grp.sum(f_corr);
  f_feas = grp.sum(f_feas);
  f_dyn = grp.sum(f_dyn);
  const T f = T((double(jerk) + double(w.wei_time * Ttot)) +
                (double(w.wei_obs) * f_corr + double(w.wei_feas) * f_feas +
                 double(w.wei_sur) * f_dyn));
  if (!want_g) return w.cost_scale * f;

  // ---- back through the jerk form and _pre ----
  g_dT = grp.sum(g_dT);
  T g_rhs[2][C];
  for (int d = 0; d < 2; ++d)
    for (int c = 0; c < C; ++c) {
      T qt = T(0);                                 // (Q^T rhs)_c
      for (int k = 0; k < C; ++k) qt += Q[k * C + c] * rhs[d][k];
      g_rhs[d][c] = grp.sum(G[d][c]) + i5 * (qr[d][c] + qt);
    }
  g_dT -= T(5) * jerk * invdT;
  for (int d = 0; d < 2; ++d) {
    g_dT += g_rhs[d][1] * bnd[(size_t)(2 + d) * B] +
            g_rhs[d][2] * bnd[(size_t)(4 + d) * B] * T(2) * dT +
            g_rhs[d][N + 3] * bnd[(size_t)(8 + d) * B] +
            g_rhs[d][N + 4] * bnd[(size_t)(10 + d) * B] * T(2) * dT;
  }
  const T g_T = w.wei_time + g_dT / T(N);
  const T dTdvt = vt > T(0) ? vt + T(1) : -(vt - T(1)) / (qneg * qneg);
  for (int i = 0; i < DP; ++i) g[i] = T(0);
  for (int j = 0; j < N - 1; ++j)
    for (int d = 0; d < 2; ++d) g[2 * j + d] = w.cost_scale * g_rhs[d][3 + j];
  g[NIN] = w.cost_scale * (g_T * dTdvt * w.sigma);
  return w.cost_scale * f;
}

}  // namespace dftpav
