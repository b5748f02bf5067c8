// Objective and hand-written gradient of the trajectory-optimization cost for
// ONE lane (one scenario), as __host__ __device__ code.
//
// Replaces the objective half of the TPU whole-solve kernel:
// dftpav_tpu/ops/kcost.py eval_fg (traced with jax.vjp inside
// dftpav_tpu/ops/pallas_solve.py _kernel). Same math as
// dftpav_tpu_torch/ops/kcost.py eval_cost, whose autograd gradient is the
// plain reference for the one written out here:
//
//   * _pre, per gear segment s: rhs per dimension = (head p, v*dT, a*dT^2 |
//     the n_s - 1 inner waypoints | tail p, v*dT, a*dT^2 | zeros to N + 5),
//     T_s = virtual_to_real(vt_s * sigma_s), dT = T_s / n_s; the junction
//     between segments s and s + 1 takes its position from the gear
//     variables and its velocity -+non_sinv (cos a, sin a) when segment
//     s + 1 is unmasked;
//   * jerk energy dT^-5 rhs^T Q rhs plus wei_time * T;
//   * per sample row r: sig = P0 rhs, dsig = P1 rhs / dT, ddsig = P2 rhs / dT^2,
//     then the corridor hinge (E x H, penalty.cuh corridor_row, shared with
//     the corridor kernels), feasibility (speed, acceleration, two-sided
//     curvature) and the dual log-sum-exp obstacle distance, the obstacle
//     sampled at the absolute time rel_t0 + tt_s + frac dT (tt_s: the
//     earlier segments' durations). Each segment has its own sample maps
//     (built for its piece count n_s) and its own rows of the slabs.
//
// Gradient: every row's penalty depends only on (sig, dsig, ddsig, dT), so it
// is differentiated row-locally -- corridor and feasibility in closed form,
// the obstacle block by forward-mode dual numbers over (sig_x, sig_y, u, v,
// t) with t the sample's absolute time -- and chained back through P_o^T to
// rhs, then through _pre to x.
// Rows whose weight is zero (invalid samples, obstacle gate closed, hinge
// inactive) contribute exactly zero and are skipped; JAX's where-selects give
// the same zeros.
//
// Mapping (lane_eval): the G members of a team (team.cuh: one warp on the
// card, G = 32; the host harness runs the same members in turn) share one
// lane. The segments run one after another, the last first (so that the
// gradient of each segment's duration is complete when it is reached: the
// later segments' obstacle times depend on it); within a segment every
// stage is a function of one member plus a combine over the team:
//   1. rhs and the jerk form: member m takes entries m, m + G, ... of the
//      2 (N + 5) rhs values (written once per evaluation, in double, to the
//      lane's scratch) and of Q rhs; the energy is a team sum;
//   2. rows: member m takes sample rows m, m + G, ...: sample maps,
//      corridor, feasibility and their gradient; the obstacle block is only
//      a scalar gate here, which marks the (row, obstacle) pairs within
//      reach;
//   3. near pairs: each step's marked pairs are packed by a ballot and a
//      prefix popcount into a ring of 2G entries; whenever G are waiting,
//      member m runs the obstacle penalty of entry m in dual numbers (its
//      .v is the value), so the team never idles on one member's pair;
//   4. combine: the per-member gradient partials (2 (N + 5) rhs slots, dT
//      and the time offset tt) are reduce-scattered, member m finishes the
//      rhs slots it holds through the jerk form and _pre, and member 0
//      chains the junction rows into the gear variables.
// Every combine is an xor butterfly (team.cuh), so the result depends on
// which member took which row, never on timing: two runs are bitwise equal.
//
// The same header compiles with nvcc (kernels.cu, float) and with g++ (the
// host test harness, double and float), so the hand gradient and the team
// mapping are checked against autograd on the CPU before they run on the
// card.
#pragma once

#include "penalty.cuh"
#include "team.cuh"

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
  const T ib = T(1) / b.v;
  for (int i = 0; i < K; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) * ib;
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
  const T ib = T(1) / b;
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * ib;
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
  const T ia = T(1) / a.v;
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * ia;
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
// The class (segments, piece counts, rows) rides at its end.
enum WIdx {
  W_WEI_OBS = 0, W_WEI_SUR, W_WEI_FEAS, W_WEI_TIME,
  W_MFV, W_MFA, W_MFC, W_MBV, W_MBA, W_MBC,
  W_MINI_T, W_EPIS, W_ALPHA, W_COST_SCALE, W_NEAR_R2, W_D_MIN,
  W_SIGMA,        // virtual-time sigma of segment 0
  W_LE = 17,      // 8 values: hull vertices (x, y) x 4, clockwise
  W_EH = 25,      // 8 values: unit edge vectors (x, y) x 4
  W_NON_SINV = 33,
  W_NSEG = 34,    // gear segments S
  W_NS = 35,      // kMaxS values: pieces n_s of segment s
  W_RS = W_NS + kMaxS,    // kMaxS values: weighted sample rows of segment s
  W_SIG = W_RS + kMaxS,   // kMaxS values: virtual-time sigma of segment s
  W_CAP = W_SIG + kMaxS,  // capacity: the pieces per segment the layout
                          // has room for
  W_LEN = W_CAP + 1
};

// The weights and the class, with K per-segment slots (kSlots<S> in the
// kernels of S segments; kMaxS on the host, to check a class).
template <class T, int K>
struct KW {
  T wei_obs, wei_sur, wei_feas, wei_time;
  T mfv, mfa, mfc, mbv, mba, mbc;
  T mini_t, epis, alpha, cost_scale, near_r2, d_min, non_sinv;
  T le[4][2], eh[4][2];
  int nseg, ns[K], rs[K], cap;
  T sig[K];
};

// The KW of the kernels of S segments.
template <class T, int S>
using KWS = KW<T, kSlots<S>>;

// The weight vector (W_LEN values) as a KW of K slots (its first K
// segments).
template <class T, int K, class S>
DFT_HD KW<T, K> make_kw(const S* a) {
  KW<T, K> w;
  w.wei_obs = T(a[W_WEI_OBS]); w.wei_sur = T(a[W_WEI_SUR]);
  w.wei_feas = T(a[W_WEI_FEAS]); w.wei_time = T(a[W_WEI_TIME]);
  w.mfv = T(a[W_MFV]); w.mfa = T(a[W_MFA]); w.mfc = T(a[W_MFC]);
  w.mbv = T(a[W_MBV]); w.mba = T(a[W_MBA]); w.mbc = T(a[W_MBC]);
  w.mini_t = T(a[W_MINI_T]); w.epis = T(a[W_EPIS]); w.alpha = T(a[W_ALPHA]);
  w.cost_scale = T(a[W_COST_SCALE]); w.near_r2 = T(a[W_NEAR_R2]);
  w.d_min = T(a[W_D_MIN]); w.non_sinv = T(a[W_NON_SINV]);
  for (int e = 0; e < 4; ++e)
    for (int j = 0; j < 2; ++j) {
      w.le[e][j] = T(a[W_LE + 2 * e + j]);
      w.eh[e][j] = T(a[W_EH + 2 * e + j]);
    }
  w.nseg = int(a[W_NSEG]);
  w.cap = int(a[W_CAP]);
  for (int s = 0; s < K; ++s) {
    w.ns[s] = int(a[W_NS + s]);
    w.rs[s] = int(a[W_RS + s]);
    w.sig[s] = T(a[W_SIG + s]);
  }
  return w;
}

// Lane-minor slabs (the layout of ops/kcost.py KScenario): element (row, lane)
// of an [rows, B] slab sits at row * B + lane. The sample rows of segment s
// are rows s R .. s R + R - 1 of the corridor slabs.
template <class T>
struct Slabs {
  const T* bnd;    // [12 S.., B]
  const T* misc;   // [2 S + 3 O.., B]
  const T* cn;     // [H, 2, S R, B]
  const T* cp;     // [H, 2, S R, B]
  const T* cm;     // [H, S R, B]
  const T* obs;    // [O, 2, 6 Po, B]
  int B, R, H, O, Po, S;
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

// ---------------------------------------------------------------------------
// Dynamic obstacles (kcost.py obstacle_cost)
// ---------------------------------------------------------------------------

// One obstacle of one lane: the timing of its prediction and the end state
// of its last piece, for the constant-acceleration extrapolation past it.
// Its coefficient rows lie beside it: cx / cy[6 p + k], piece p, power k.
template <class T>
struct ObsLane {
  T dt, rel_t0, total;
  T pe_x, pe_y, ve_x, ve_y, ae_x, ae_y;
  int active;
};

template <class T>
DFT_HD ObsLane<T> obs_lane(const T* cx, const T* cy, int Po, T dt, T rel_t0,
                           bool active) {
  ObsLane<T> ol;
  ol.dt = dt;
  ol.rel_t0 = rel_t0;
  ol.total = dt * T(Po);
  ol.active = active ? 1 : 0;
  const T inv_dt = T(1) / dt;
  const T* lx = cx + 6 * (Po - 1);
  const T* ly = cy + 6 * (Po - 1);
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
  ol.pe_x = pe_x;
  ol.pe_y = pe_y;
  ol.ve_x = ve_x * inv_dt;
  ol.ve_y = ve_y * inv_dt;
  ol.ae_x = ae_x * inv_dt * inv_dt;
  ol.ae_y = ae_y * inv_dt * inv_dt;
  return ol;
}

// The obstacle at a sample's absolute time pt = rel_t0 + tt + frac * dT:
// its position, and the piece and local time whose derivative gives its
// heading.
template <class S>
struct ObsAt {
  S p_x, p_y, tau_r;
  int pr;
};

template <class S, class T>
DFT_HD ObsAt<S> obstacle_at(const S& pt, const ObsLane<T>& ol, const T* cx,
                            const T* cy, int Po) {
  const bool inside = val(pt) < ol.total;
  const S ft = (inside ? pt : S(ol.total)) / ol.dt;
  T idxf = m_floor(val(ft));
  idxf = m_min(m_max(idxf, T(0)), T(Po - 1));
  const int idx = int(idxf);
  const S tau = ft - idxf;
  const S pin_x = horner0(cx + 6 * idx, tau);
  const S pin_y = horner0(cy + 6 * idx, tau);
  const S ex = val(pt) - ol.total > T(0) ? pt - ol.total : S(T(0));
  const S half_ex2 = (T(0.5) * ex) * ex;
  ObsAt<S> a;
  a.p_x = inside ? pin_x : (ol.pe_x + ex * ol.ve_x) + half_ex2 * ol.ae_x;
  a.p_y = inside ? pin_y : (ol.pe_y + ex * ol.ve_y) + half_ex2 * ol.ae_y;
  a.tau_r = inside ? tau : T(1) + ex / ol.dt;
  a.pr = inside ? idx : Po - 1;
  return a;
}

// The obstacle's heading frame (its unit velocity) at the sample's time.
template <class S, class T>
DFT_HD void obstacle_heading(const ObsAt<S>& a, const T* cx, const T* cy,
                             S& uo, S& vo) {
  const S vr_x = horner1(cx + 6 * a.pr, a.tau_r);
  const S vr_y = horner1(cy + 6 * a.pr, a.tau_r);
  const S vrn2 = vr_x * vr_x + vr_y * vr_y;
  const S inv_vrn = m_rsqrt(val(vrn2) > T(1e-24) ? vrn2 : S(T(1e-24)));
  uo = vr_x * inv_vrn;
  vo = vr_y * inv_vrn;
}

// Hull edge i of the pair (i < 4: an ego edge against the obstacle's
// vertices; i >= 4: an obstacle edge against the ego's): its normal h and
// offset term d_tilde; its 4 cross terms are h . (the other hull's vertex
// f), and its signed distance is their soft minimum plus the offset. The
// rotated vertices are recomputed where they are used rather than held,
// which keeps a dual-number evaluation's live state small.
template <class S>
struct Edge {
  S hx, hy, d_tilde;
};

template <class S, class T, int K>
DFT_HD Edge<S> edge_of(int i, const S& u, const S& v, const S& uo,
                       const S& vo, const S& rel_x, const S& rel_y,
                       const KW<T, K>& w) {
  const bool ego = i < 4;
  const int e = ego ? i : i - 4;
  const S& a_u = ego ? u : uo;   // the edge's frame
  const S& a_v = ego ? v : vo;
  const T ehx = w.eh[e][0], ehy = w.eh[e][1];
  const T lex = w.le[e][0], ley = w.le[e][1];
  Edge<S> g;
  g.hx = (-a_v) * ehx - a_u * ehy;
  g.hy = a_u * ehx - a_v * ehy;
  const S rl_x = a_u * lex - a_v * ley;
  const S rl_y = a_v * lex + a_u * ley;
  g.d_tilde = ego ? g.hx * (rel_x - rl_x) + g.hy * (rel_y - rl_y)
                  : g.hx * ((-rel_x) - rl_x) + g.hy * ((-rel_y) - rl_y);
  return g;
}

// Cross term f of edge i: h . (the other hull's vertex f, rotated).
template <class S, class T, int K>
DFT_HD S edge_cross(int i, int f, const Edge<S>& g, const S& u, const S& v,
                    const S& uo, const S& vo, const KW<T, K>& w) {
  const bool ego = i < 4;
  const S& b_u = ego ? uo : u;   // the other hull's frame
  const S& b_v = ego ? vo : v;
  const T lfx = w.le[f][0], lfy = w.le[f][1];
  return g.hx * (b_u * lfx - b_v * lfy) + g.hy * (b_v * lfx + b_u * lfy);
}

// Running log-sum-exp: after add(0, x_0) .. add(k, x_k), lse() is
// log sum_j exp x_j. m, a plain number (no derivative), is the running
// maximum that keeps the exponentials in range; s is rescaled when it
// moves (by exp(0) = 1 exactly when it does not).
template <class S, class T>
struct RunLse {
  S s;
  T m;
  DFT_HD void add(int j, const S& x) {
    if (j == 0) {
      m = val(x);
      s = m_exp(x - m);
    } else {
      const T nm = m_max(m, val(x));
      s = s * m_exp(m - nm) + m_exp(x - nm);
      m = nm;
    }
  }
  DFT_HD S lse() const { return m_log(s) + m; }
};

// The scalar gate: whether the pair can have a penalty. First the reach
// |p_obs - sig|^2 <= near_r2 (beyond it the penalty is 0 by definition);
// then a lower bound of the smooth distance D = (1/alpha) log sum_i
// exp(alpha d_i): D >= max_i d_i, and each edge's soft minimum is at least
// its smallest cross term less log(4)/alpha (the separating-axis bound).
// When the bound clears d_min by 1e-3 m (far above float rounding of D),
// d_min - D < 0 and the penalty is exactly 0, so only pairs that fail it
// go on to the dual-number pass.
template <class T, int K>
DFT_HD bool obstacle_near(T sx, T sy, T u, T v, T pt, const ObsLane<T>& ol,
                          const T* cx, const T* cy, int Po,
                          const KW<T, K>& w) {
  const ObsAt<T> a = obstacle_at<T, T>(pt, ol, cx, cy, Po);
  const T rel_x = a.p_x - sx;
  const T rel_y = a.p_y - sy;
  if (!(rel_x * rel_x + rel_y * rel_y <= w.near_r2)) return false;
  T uo, vo;
  obstacle_heading(a, cx, cy, uo, vo);
  T bound = T(0);
  for (int i = 0; i < 8; ++i) {
    const Edge<T> g = edge_of<T, T>(i, u, v, uo, vo, rel_x, rel_y, w);
    T lo = T(0);
    for (int f = 0; f < 4; ++f) {
      const T c = edge_cross<T, T>(i, f, g, u, v, uo, vo, w);
      lo = f == 0 ? c : m_min(lo, c);
    }
    bound = i == 0 ? lo + g.d_tilde : m_max(bound, lo + g.d_tilde);
  }
  bound = bound - m_log(T(4)) / w.alpha;
  return !(bound >= w.d_min + T(1e-3));
}

// One obstacle's penalty at one valid sample row: 0 when the obstacle is
// beyond the gate or the smooth signed distance is above d_min. S is T
// (value) or Dual<T, 5> (value + d/d(sig_x, sig_y, u, v, pt), pt the
// sample's absolute time). Both log-sum-exps (over an edge's 4 cross
// terms, and over the 8 edges) run online, so no array of dual numbers is
// held.
template <class S, class T, int K>
DFT_HD S obstacle_pen(const S& sx, const S& sy, const S& u, const S& v,
                      const S& pt, const ObsLane<T>& ol, const T* cx,
                      const T* cy, int Po, const KW<T, K>& w) {
  const ObsAt<S> a = obstacle_at<S, T>(pt, ol, cx, cy, Po);
  S uo, vo;
  obstacle_heading(a, cx, cy, uo, vo);
  const S rel_x = a.p_x - sx;
  const S rel_y = a.p_y - sy;
  if (!(val(rel_x * rel_x + rel_y * rel_y) <= w.near_r2)) return S(T(0));

  RunLse<S, T> outer;
  for (int i = 0; i < 8; ++i) {
    const Edge<S> g = edge_of<S, T>(i, u, v, uo, vo, rel_x, rel_y, w);
    RunLse<S, T> inner;                  // soft minimum of the cross terms
    for (int f = 0; f < 4; ++f)
      inner.add(f, (-w.alpha) * edge_cross<S, T>(i, f, g, u, v, uo, vo, w));
    outer.add(i, w.alpha * ((-inner.lse()) / w.alpha + g.d_tilde));
  }
  const S d_val = w.d_min - outer.lse() / w.alpha;
  if (!(val(d_val) > T(0))) return S(T(0));
  return sl1(d_val);
}

// ---------------------------------------------------------------------------
// One lane's evaluation, split over the members of a team
// ---------------------------------------------------------------------------

// The layout of a class of capacity N (pieces per segment the decision
// vector and the rhs have room for; a segment's own piece count n_s <= N
// is read at run time) and S segments.
template <int N, int S = 1>
struct KDims {
  static constexpr int C = N + 5;                 // rhs rows per dimension
  static constexpr int NIN = 2 * S * (N - 1);     // inner-waypoint rows
  static constexpr int DIM = NIN + S + 3 * (S - 1);  // decision length
  static constexpr int DP = ((DIM + 7) / 8) * 8 > 16 ? ((DIM + 7) / 8) * 8 : 16;
  // slots of a member's gradient partials: the 2 (N + 5) rhs entries, then
  // d/d dT and d/d tt (the segment's time offset); a multiple of every team
  // size, so that each of the reduce-scatter's five halvings splits it
  // evenly (32 up to N = 10, 64 up to N = 26, 96 = 3 x 32 up to N = 42)
  static constexpr int ACC =
      2 * C + 2 <= 32 ? 32 : (2 * C + 2 <= 64 ? 64 : 96);
  static_assert(2 * C + 2 <= ACC, "gradient slots");
};

// A member's gradient partials in the team's scratch: slot i of member m
// at p[i * G] (p = base + m), so that the members of a warp touch
// consecutive words. Keeping them out of the registers leaves those to the
// dual-number pass.
template <class T>
struct Acc {
  T* p;
  int stride;
  DFT_HD T& operator[](int i) const { return p[i * stride]; }
};

// A (row, obstacle) pair within reach, waiting for its dual-number pass:
// the row's sample as the scalar pass computed it.
template <class T>
struct NearPair {
  T sx, sy, dsx, dsy, inv_vn;
  int r, o;
};

// What one lane's evaluation reads and writes. The class constants are
// shared by every lane, one set per distinct piece count (segments with
// equal n_s share theirs); the lane's rows are its own; the rest is the
// team's scratch (shared memory on the card). lane_eval points the
// segment fields (planes .. bnd) at the segment it works on. K: the
// per-segment slots (kSlots<S>).
template <class T, int K>
struct LaneData {
  const double* Pds[K];  // [3][R_s][C] sample maps, in double
  const T* Ps[K];        // the same in T
  const T* Qs[K];        // [C][C] jerk form
  const T* gridcs[K];    // [2][R_s] quadrature weight (0: skipped), frac
  int H, O, Po;
  int seg_rows;          // rows of a segment in the slabs (their R)
  Planes<T> planes_lane;  // the lane's half-planes of row 0, segment 0;
  size_t plane_row;       // row r at + r * plane_row
  const T* bnd_lane;     // [12 S] head p, v, a; tail p, v, a (x, y each)
  const T* lm;           // [2 S] gear sign, then seg_mask, per segment
  const T* obs;          // [O][2][6 Po] obstacle coefficients
  const ObsLane<T>* ol;  // [O]
  T* x;                  // [DP] the point to evaluate
  T* g;                  // [DP] its gradient
  double* rhs;           // [2][C]
  T* qr;                 // [2][C] Q rhs
  NearPair<T>* ring;     // [2 G]
  T* acc;                // [ACC][G] the members' gradient partials
  T* sb;                 // [12] the segment's boundary after the junctions
  T* gb;                 // [8] gradients of the junction-fed boundary rows
  // the segment being evaluated
  Planes<T> planes;      // its half-planes of row 0
  const double* Pd;
  const T* P;
  const T* Q;
  const T* gridc;
  int R;                 // rows of its sample maps
  int s, ns;             // its index and pieces
  T sgl, tt;             // gear sign, time offset
  const T* bnd;          // [12] its boundary
};

// The LaneData of the kernels of S segments.
template <class T, int S>
using LaneS = LaneData<T, kSlots<S>>;

// Copies lane `lane`'s boundary rows, gear signs and segment masks, and
// obstacle coefficients from the slabs into the team's scratch (bnd_s
// [12 S], lm_s [2 S], obs_s [O][2][6 Po]) and sets up its obstacles (ol_s
// [O]).
template <int S, class T, class Team>
DFT_HD void stage_lane(const Team& tm, const Slabs<T>& sl, int lane, T* bnd_s,
                       T* lm_s, T* obs_s, ObsLane<T>* ol_s) {
  const size_t B = (size_t)sl.B;
  const int O = sl.O, Po = sl.Po, n_obs = 12 * O * Po;
  for (int k = 0; k < Team::kRun; ++k) {
    const int m = tm.member(k);
    for (int i = m; i < 12 * S; i += Team::G) bnd_s[i] = sl.bnd[i * B + lane];
    for (int i = m; i < 2 * S; i += Team::G) lm_s[i] = sl.misc[i * B + lane];
    for (int i = m; i < n_obs; i += Team::G) obs_s[i] = sl.obs[i * B + lane];
  }
  tm.sync();
  const int ob = 2 * S;
  for (int k = 0; k < Team::kRun; ++k)
    for (int o = tm.member(k); o < O; o += Team::G)
      ol_s[o] = obs_lane(obs_s + 12 * Po * o, obs_s + 12 * Po * o + 6 * Po,
                         Po, sl.misc[(size_t)(ob + o) * B + lane],
                         sl.misc[(size_t)(ob + O + o) * B + lane],
                         sl.misc[(size_t)(ob + 2 * O + o) * B + lane] > T(0.5));
  tm.sync();
}

// The half-planes of lane `lane` in the slabs (kernel A reads them there).
template <class T>
DFT_HD Planes<T> planes_slab(const Slabs<T>& sl, int lane) {
  Planes<T> pl;
  pl.n = sl.cn + lane;
  pl.p = sl.cp + lane;
  pl.m = sl.cm + lane;
  pl.stride = (size_t)sl.S * sl.R * sl.B;
  return pl;
}

// Kernel B reads them lane-major, from a copy [B][5 H][S R] made once per
// launch: plane q of lane b at (b * 5 H + q) * S R, planes cn (2 H), cp
// (2 H), cm (H) in that order. A lane's rows are then contiguous, so a warp
// that works on one lane reads each plane in whole lines.
template <class T>
DFT_HD const T* lane_major_src(const Slabs<T>& sl, int q) {
  const size_t RB = (size_t)sl.S * sl.R * sl.B;
  const int H = sl.H;
  if (q < 2 * H) return sl.cn + q * RB;
  if (q < 4 * H) return sl.cp + (q - 2 * H) * RB;
  return sl.cm + (q - 4 * H) * RB;
}
template <class T>
DFT_HD Planes<T> planes_lane_major(const T* copy, int lane, int H, int RS) {
  const T* base = copy + (size_t)lane * 5 * H * RS;
  Planes<T> pl;
  pl.n = base;
  pl.p = base + (size_t)2 * H * RS;
  pl.m = base + (size_t)4 * H * RS;
  pl.stride = (size_t)RS;
  return pl;
}

// Segment-level values of one evaluation, the same on every member.
template <class T>
struct EvPre {
  T vt, Ttot, qneg, dT, dT2, invdT, invdT2, i5;
  T max_vel, max_acc, max_cur;
};

template <class T>
DFT_HD T virtual_to_real(T vt, T mini_t) {
  const T Tpos = (T(0.5) * vt + T(1)) * vt + T(1);
  const T qneg = (T(0.5) * vt - T(1)) * vt + T(1);
  return (vt > T(0) ? Tpos : T(1) / qneg) + mini_t;
}

template <class T, int K>
DFT_HD EvPre<T> ev_pre(T x_vt, T sigma, int ns, T sgl, const KW<T, K>& w) {
  EvPre<T> e;
  e.vt = x_vt * sigma;
  e.qneg = (T(0.5) * e.vt - T(1)) * e.vt + T(1);
  e.Ttot = virtual_to_real(e.vt, w.mini_t);
  e.dT = e.Ttot / T(ns);
  e.dT2 = e.dT * e.dT;
  e.invdT = T(1) / e.dT;
  e.invdT2 = e.invdT * e.invdT;
  e.i5 = e.invdT2 * e.invdT2 * e.invdT;
  const bool fwd = sgl > T(0);
  e.max_vel = fwd ? w.mfv : w.mbv;
  e.max_acc = fwd ? w.mfa : w.mba;
  e.max_cur = fwd ? w.mfc : w.mbc;
  return e;
}

// rhs entry i = d (N + 5) + c of the segment (_pre).
template <class T, int N, int S>
DFT_HD T rhs_entry(int i, const LaneS<T, S>& L, const EvPre<T>& e) {
  constexpr int C = N + 5;
  const int d = i / C, c = i - d * C, ns = L.ns;
  const int seg = S == 1 ? 0 : L.s;
  if (c == 0) return L.bnd[d];
  if (c == 1) return L.bnd[2 + d] * e.dT;
  if (c == 2) return L.bnd[4 + d] * e.dT2;
  if (c < ns + 2) return L.x[2 * ((N - 1) * seg + c - 3) + d];
  if (c == ns + 2) return L.bnd[6 + d];
  if (c == ns + 3) return L.bnd[8 + d] * e.dT;
  if (c == ns + 4) return L.bnd[10 + d] * e.dT2;
  return T(0);
}

// (Q rhs_d)_c for entry i = d (N + 5) + c, stored to qr; returns entry i's
// share of the jerk energy rhs^T Q rhs. In double: the quadratic form
// cancels heavily (Q's entries are large next to the energy).
template <class T, int N, int K>
DFT_HD double jerk_entry(int i, const LaneData<T, K>& L) {
  constexpr int C = N + 5;
  const int d = i / C, c = i - d * C;
  double s = 0.0;
  for (int k = 0; k < C; ++k) s += double(L.Q[c * C + k]) * L.rhs[d * C + k];
  L.qr[i] = T(s);
  return L.rhs[i] * s;
}

// The scalar pass over sample row r: its corridor and feasibility terms
// and their gradient, added to the member's partials (acc, f), and which
// obstacles are within reach of it (bit o of .near). .p.r < 0: no row.
template <class T>
struct RowOut {
  NearPair<T> p;
  unsigned near;
};

template <class T, int N, int S>
DFT_HD RowOut<T> row_pass(int r, const LaneS<T, S>& L, const EvPre<T>& e,
                          const KWS<T, S>& w, const Acc<T>& acc, double& f) {
  constexpr int C = N + 5;
  RowOut<T> out;
  out.near = 0u;
  out.p.r = -1;
  if (r >= L.R) return out;
  const T omg = L.gridc[r];
  if (!(omg > T(0))) return out;
  const int R = L.R;
  // sample maps in double: the derivative rows cancel large terms of
  // opposite sign, and float sums there cost ~3e-5 relative in f
  const double* P0 = L.Pd + (size_t)r * C;
  const double* P1 = L.Pd + (size_t)(R + r) * C;
  const double* P2 = L.Pd + (size_t)(2 * R + r) * C;
  double s0[2] = {0.0, 0.0}, s1[2] = {0.0, 0.0}, s2[2] = {0.0, 0.0};
  for (int c = 0; c < C; ++c) {
    for (int d = 0; d < 2; ++d) {
      const double rd = L.rhs[d * C + c];
      s0[d] += P0[c] * rd;
      s1[d] += P1[c] * rd;
      s2[d] += P2[c] * rd;
    }
  }
  const T sx = T(s0[0]), sy = T(s0[1]);
  const T dsx = T(s1[0]) * e.invdT, dsy = T(s1[1]) * e.invdT;
  const T ddx = T(s2[0]) * e.invdT2, ddy = T(s2[1]) * e.invdT2;
  const T vn2 = dsx * dsx + dsy * dsy;
  if (!(vn2 >= T(1e-8))) return out;             // invalid row: weight 0
  const T sgl = L.sgl;
  const T inv_vn = m_rsqrt(vn2);
  const T vel2_reci = T(1) / vn2;
  const T vel2_reci_e = T(1) / (vn2 + w.epis);
  const T vel32 = vel2_reci_e * m_sqrt(vel2_reci_e);
  const T wq = omg * e.dT;
  const T nx = dsx * inv_vn, ny = dsy * inv_vn;
  const T u = nx * sgl;
  const T v = ny * sgl;

  // corridor: A = sum_eh sl1(viol_eh) * mask_h
  Planes<T> pl = L.planes;
  pl.n += (size_t)r * L.plane_row;
  pl.p += (size_t)r * L.plane_row;
  pl.m += (size_t)r * L.plane_row;
  const CorridorRow<T> cr = corridor_row(sx, sy, u, v, pl, L.H, w.le, true);

  // feasibility
  const T z1 = ddx * dsx + ddy * dsy;
  const T z3 = ddy * dsx - ddx * dsy;
  const T vv = vn2 - e.max_vel * e.max_vel;
  const T va = z1 * z1 * vel2_reci - e.max_acc * e.max_acc;
  const T cur = z3 * vel32;
  const T F = sl1(vv) + sl1(va) +
              T(10) * (sl1(cur - e.max_cur) + sl1(-cur - e.max_cur));
  f += double(w.wei_obs) * double(wq * cr.A) +
       double(w.wei_feas) * double(wq * F);

  // ---- row-local gradient ----
  acc[2 * C] += omg * (w.wei_obs * cr.A + w.wei_feas * F);
  const T g_sx = wq * (w.wei_obs * cr.gx);
  const T g_sy = wq * (w.wei_obs * cr.gy);
  const T g_u = wq * (w.wei_obs * cr.gu);
  const T g_v = wq * (w.wei_obs * cr.gv);
  // (u, v) = sgl * dsig / |dsig|: project out the radial component
  const T proj = g_u * nx + g_v * ny;
  T g_dsx = sgl * inv_vn * (g_u - nx * proj);
  T g_dsy = sgl * inv_vn * (g_v - ny * proj);
  // feasibility in closed form
  const T wqf = wq * w.wei_feas;
  const T dF_vv = sl1_grad(vv);
  const T dF_va = sl1_grad(va);
  const T dF_cur =
      T(10) * (sl1_grad(cur - e.max_cur) - sl1_grad(-cur - e.max_cur));
  const T g_vn2 = dF_vv - dF_va * z1 * z1 * vel2_reci * vel2_reci -
                  dF_cur * T(1.5) * cur * vel2_reci_e;
  const T g_z1 = dF_va * T(2) * z1 * vel2_reci;
  const T g_z3 = dF_cur * vel32;
  g_dsx += wqf * (g_vn2 * T(2) * dsx + g_z1 * ddx + g_z3 * ddy);
  g_dsy += wqf * (g_vn2 * T(2) * dsy + g_z1 * ddy - g_z3 * ddx);
  const T g_ddx = wqf * (g_z1 * dsx - g_z3 * dsy);
  const T g_ddy = wqf * (g_z1 * dsy + g_z3 * dsx);
  // dsig = P1 rhs / dT, ddsig = P2 rhs / dT^2
  acc[2 * C] -= (g_dsx * dsx + g_dsy * dsy) * e.invdT +
                T(2) * (g_ddx * ddx + g_ddy * ddy) * e.invdT;
  const T c0[2] = {g_sx, g_sy};
  const T c1[2] = {g_dsx * e.invdT, g_dsy * e.invdT};
  const T c2[2] = {g_ddx * e.invdT2, g_ddy * e.invdT2};
  const T* Pf0 = L.P + (size_t)r * C;
  const T* Pf1 = L.P + (size_t)(R + r) * C;
  const T* Pf2 = L.P + (size_t)(2 * R + r) * C;
  for (int d = 0; d < 2; ++d)
    for (int c = 0; c < C; ++c)
      acc[d * C + c] += c0[d] * Pf0[c] + c1[d] * Pf1[c] + c2[d] * Pf2[c];

  // obstacles: only the gate here (obstacle_near)
  const T frac = L.gridc[R + r];
  const int Po = L.Po;
  for (int o = 0; o < L.O; ++o)
    if (L.ol[o].active &&
        obstacle_near(sx, sy, u, v,
                      (S == 1 ? L.ol[o].rel_t0 : L.ol[o].rel_t0 + L.tt) +
                          frac * e.dT,
                      L.ol[o], L.obs + 12 * Po * o,
                      L.obs + 12 * Po * o + 6 * Po, Po, w))
      out.near |= 1u << o;
  out.p.sx = sx;
  out.p.sy = sy;
  out.p.dsx = dsx;
  out.p.dsy = dsy;
  out.p.inv_vn = inv_vn;
  out.p.r = r;
  out.p.o = 0;
  return out;
}

// The obstacle term of one near pair, in dual numbers, and its gradient
// chained to the rhs slots, dT and (multi-gear) tt, added to the member's
// partials.
template <class T, int N, int S>
DFT_HD void dual_pass(const NearPair<T>& q, const LaneS<T, S>& L,
                      const EvPre<T>& e, const KWS<T, S>& w,
                      const Acc<T>& acc, double& f) {
  constexpr int C = N + 5;
  const int r = q.r, o = q.o, R = L.R, Po = L.Po;
  const T omg = L.gridc[r], frac = L.gridc[R + r];
  const T wq = omg * e.dT;
  const T sgl = L.sgl;
  const T nx = q.dsx * q.inv_vn, ny = q.dsy * q.inv_vn;
  typedef Dual<T, 5> D5;
  // the fifth variable: dT at S = 1 (the sample's time rel_t0 + frac dT
  // formed in dual numbers), else the sample's absolute time
  D5 a[5];
  const T in[5] = {q.sx, q.sy, nx * sgl, ny * sgl,
                   S == 1 ? e.dT : (L.ol[o].rel_t0 + L.tt) + frac * e.dT};
  for (int i = 0; i < 5; ++i) {
    a[i] = D5(in[i]);
    a[i].d[i] = T(1);
  }
  const D5 pt = S == 1 ? L.ol[o].rel_t0 + frac * a[4] : a[4];
  const D5 pd = obstacle_pen<D5, T>(a[0], a[1], a[2], a[3], pt, L.ol[o],
                                    L.obs + 12 * Po * o,
                                    L.obs + 12 * Po * o + 6 * Po, Po, w);
  if (!(pd.v > T(0))) return;
  f += double(w.wei_sur) * double(wq * pd.v);
  if (S == 1) {
    acc[2 * C] += omg * (w.wei_sur * pd.v) + wq * w.wei_sur * pd.d[4];
  } else {
    const T g_t = wq * (w.wei_sur * pd.d[4]);    // d/d(absolute time)
    acc[2 * C] += omg * (w.wei_sur * pd.v) + frac * g_t;
    acc[2 * C + 1] += g_t;
  }
  const T g_sx = wq * (w.wei_sur * pd.d[0]);
  const T g_sy = wq * (w.wei_sur * pd.d[1]);
  const T g_u = wq * (w.wei_sur * pd.d[2]);
  const T g_v = wq * (w.wei_sur * pd.d[3]);
  const T proj = g_u * nx + g_v * ny;
  const T g_dsx = sgl * q.inv_vn * (g_u - nx * proj);
  const T g_dsy = sgl * q.inv_vn * (g_v - ny * proj);
  acc[2 * C] -= (g_dsx * q.dsx + g_dsy * q.dsy) * e.invdT;
  const T c0[2] = {g_sx, g_sy};
  const T c1[2] = {g_dsx * e.invdT, g_dsy * e.invdT};
  const T* Pf0 = L.P + (size_t)r * C;
  const T* Pf1 = L.P + (size_t)(R + r) * C;
  for (int d = 0; d < 2; ++d)
    for (int c = 0; c < C; ++c)
      acc[d * C + c] += c0[d] * Pf0[c] + c1[d] * Pf1[c];
}

// rhs slot i = d (N + 5) + c with its summed partial gsum: back through the
// jerk form; writes the decision gradient of an inner waypoint, and of a
// junction-fed boundary row (multi-gear) to L.gb, and returns the slot's
// share of d/d dT (the boundary rows scaled by dT, dT^2).
template <class T, int N, int S>
DFT_HD T tail_entry(int i, T gsum, const LaneS<T, S>& L, const EvPre<T>& e,
                    const KWS<T, S>& w) {
  constexpr int C = N + 5;
  const int d = i / C, c = i - d * C, ns = L.ns;
  const int seg = S == 1 ? 0 : L.s;
  T qt = T(0);                                   // (Q^T rhs_d)_c
  for (int k = 0; k < C; ++k) qt += L.Q[k * C + c] * T(L.rhs[d * C + k]);
  const T g_rhs = gsum + e.i5 * (L.qr[i] + qt);
  if (c >= 3 && c < N + 2)        // a class's unused inner rows: zero
    L.g[2 * ((N - 1) * seg + c - 3) + d] =
        c < ns + 2 ? w.cost_scale * g_rhs : T(0);
  if (S > 1) {
    if (c == 0) L.gb[d] = g_rhs;
    if (c == 1) L.gb[2 + d] = g_rhs * e.dT;
    if (c == ns + 2) L.gb[4 + d] = g_rhs;
    if (c == ns + 3) L.gb[6 + d] = g_rhs * e.dT;
  }
  if (c == 1) return g_rhs * L.bnd[2 + d];
  if (c == 2) return g_rhs * L.bnd[4 + d] * T(2) * e.dT;
  if (c == ns + 3) return g_rhs * L.bnd[8 + d];
  if (c == ns + 4) return g_rhs * L.bnd[10 + d] * T(2) * e.dT;
  return T(0);
}

// Boundary value i = 2 k + d of segment s (k: head p, v, a, tail p, v, a)
// after the gear junctions: a junction whose later segment is unmasked
// takes its position from the gear variables and its velocity
// -+non_sinv (cos a, sin a) (head of the later segment -, tail of the
// earlier +).
template <class T, int N, int S>
DFT_HD T seg_boundary(int i, int s, const LaneS<T, S>& L,
                      const KWS<T, S>& w) {
  constexpr int NIN = KDims<N, S>::NIN;
  const int d = i & 1, k = i >> 1;
  if (S > 1) {
    const bool head = k < 2 && s > 0 && L.lm[S + s] > T(0.5);
    const bool tail = (k == 3 || k == 4) && s < S - 1 &&
                      L.lm[S + s + 1] > T(0.5);
    if (head || tail) {
      const int j = head ? s - 1 : s;
      if (k == 0 || k == 3) return L.x[NIN + S + 2 * j + d];
      const T ga = L.x[NIN + S + 2 * (S - 1) + j];
      const T tv = w.non_sinv * (d == 0 ? m_cos(ga) : m_sin(ga));
      return head ? -tv : tv;
    }
  }
  return L.bnd_lane[12 * s + i];
}

// Points the segment fields of L at segment s's class constants: its piece
// count, sample maps, rows and jerk form.
template <class T, int N, int S>
DFT_HD void select_maps(LaneS<T, S>& L, const KWS<T, S>& w, int s) {
  L.s = s;
  L.ns = pick_s<S>(w.ns, s);
  L.Pd = pick_s<S>(L.Pds, s);
  L.P = pick_s<S>(L.Ps, s);
  L.Q = pick_s<S>(L.Qs, s);
  L.gridc = pick_s<S>(L.gridcs, s);
  L.R = pick_s<S>(w.rs, s);
}

// Points the segment fields of L at the lane's rows of segment s: its gear
// sign and half-planes (and a time offset of 0, set by lane_eval for a
// later segment).
template <class T, int K>
DFT_HD void select_rows(LaneData<T, K>& L, int s) {
  L.sgl = L.lm[s];
  L.tt = T(0);
  L.planes = L.planes_lane;
  const size_t off = (size_t)s * L.seg_rows * L.plane_row;
  L.planes.n += off;
  L.planes.p += off;
  L.planes.m += off;
}

// Both, and the boundary rows: the lane's at S = 1, else the junction
// rows that lane_eval writes. At S = 1 the caller selects the segment
// (the maps once, the rows once per lane); lane_eval selects each
// segment of a multi-gear class.
template <class T, int N, int S>
DFT_HD void select_segment(LaneS<T, S>& L, const KWS<T, S>& w, int s) {
  select_maps<T, N, S>(L, w, s);
  select_rows(L, s);
  L.bnd = S == 1 ? L.bnd_lane : L.sb;
}

// f (scaled by cost_scale) at L.x, with its gradient written to L.g; every
// member returns the same value. At S = 1 the segment fields were set by
// select_segment.
template <class T, int N, int S, class Team>
DFT_HD T lane_eval(const Team& tm, LaneS<T, S>& L, const KWS<T, S>& w) {
  constexpr int C = N + 5, NE = 2 * C;
  constexpr int NIN = KDims<N, S>::NIN, DP = KDims<N, S>::DP;
  constexpr int kAcc = KDims<N, S>::ACC;
  constexpr int G = Team::G, KR = Team::kRun, per = kAcc / G;
  static_assert(NE + 2 <= kAcc && kAcc % G == 0, "gradient slots");
  if (S > 1)      // the gear rows of g accumulate over the segments
    for (int k = 0; k < KR; ++k)
      for (int i = tm.member(k); i < DP; i += G) L.g[i] = T(0);
  double f = 0.0;
  T g_tt_after = T(0);      // d f / d tt of the later segments, summed
  for (int s = S - 1; s >= 0; --s) {
    const bool on = S == 1 || L.lm[S + s] > T(0.5);
    if (S > 1) {          // at S = 1 the caller selected it for the lane
      select_segment<T, N, S>(L, w, s);
      L.tt = T(0);                               // earlier segments' time
      for (int j = 0; j < s; ++j)
        L.tt = L.tt +
               virtual_to_real(L.x[NIN + j] * pick_s<S>(w.sig, j), w.mini_t);
    }
    const T sigma = pick_s<S>(w.sig, s);
    const int ns = L.ns;
    const EvPre<T> e = ev_pre(L.x[NIN + s], sigma, ns, L.sgl, w);
    T g_T = T(0), g_tt = T(0);
    if (on) {
      if (S > 1) {
        for (int k = 0; k < KR; ++k)
          for (int i = tm.member(k); i < 12; i += G)
            L.sb[i] = seg_boundary<T, N, S>(i, s, L, w);
        tm.sync();
      }

      // 1. rhs (in double, once) and the jerk form
      for (int k = 0; k < KR; ++k)
        for (int i = tm.member(k); i < NE; i += G)
          L.rhs[i] = double(rhs_entry<T, N, S>(i, L, e));
      tm.sync();
      double en[KR], fr[KR];
      Acc<T> ac[KR];
      for (int k = 0; k < KR; ++k) {
        en[k] = 0.0;
        fr[k] = 0.0;
        for (int i = tm.member(k); i < NE; i += G)
          en[k] += jerk_entry<T, N>(i, L);
        ac[k].p = L.acc + tm.member(k);
        ac[k].stride = G;
        for (int i = 0; i < kAcc; ++i) ac[k][i] = T(0);
      }

      // 2.-3. rows; the near pairs packed into the ring and run G at a
      // time (the last step, with no rows, drains the ring). One call site
      // of the dual pass keeps one copy of its code in the kernel.
      constexpr int cap = 2 * G;
      int head = 0, tail = 0;
      const int J = (L.R + G - 1) / G;
      for (int j = 0; j <= J; ++j) {
        const bool drain = j == J;
        RowOut<T> ro[KR];
        for (int k = 0; k < KR; ++k)
          ro[k] = row_pass<T, N, S>(drain ? L.R : tm.member(k) + G * j, L, e,
                                 w, ac[k], fr[k]);
        for (int o = 0; o < L.O; ++o) {
          bool fl[KR];
          for (int k = 0; k < KR; ++k) fl[k] = ((ro[k].near >> o) & 1u) != 0u;
          const unsigned mask = tm.ballot(fl);
          for (int k = 0; k < KR; ++k)
            if (fl[k]) {
              NearPair<T> q = ro[k].p;
              q.o = o;
              const unsigned below = (1u << tm.member(k)) - 1u;
              L.ring[(tail + popc(mask & below)) % cap] = q;
            }
          tail += popc(mask);
          const int n = tail - head;
          if (n >= G || (drain && o == L.O - 1 && n > 0)) {
            tm.sync();
            for (int k = 0; k < KR; ++k)
              if (tm.member(k) < n)
                dual_pass<T, N, S>(L.ring[(head + tm.member(k)) % cap], L, e,
                                   w, ac[k], fr[k]);
            head += n < G ? n : G;
            tm.sync();
          }
        }
      }

      // 4. combine, then back through the jerk form and _pre
      T acc[KR][kAcc];
      for (int k = 0; k < KR; ++k)
        for (int i = 0; i < kAcc; ++i) acc[k][i] = ac[k][i];
      tm.reduce_scatter(acc);
      const double energy = tm.sum(en);
      const double f_rows = tm.sum(fr);
      T gdt[KR], gtt[KR];
      for (int k = 0; k < KR; ++k) {
        gdt[k] = T(0);
        gtt[k] = T(0);
        for (int q = 0; q < per; ++q) {
          const int i = tm.member(k) * per + q;
          if (i < NE)
            gdt[k] += tail_entry<T, N, S>(i, acc[k][q], L, e, w);
          else if (i == NE)
            gdt[k] += acc[k][q];
          else if (i == NE + 1)
            gtt[k] += acc[k][q];
        }
      }
      T g_dT = tm.sum(gdt);
      if (S > 1) g_tt = tm.sum(gtt);
      const T jerk = T(energy * double(e.i5));
      f += (double(jerk) + double(w.wei_time * e.Ttot)) + f_rows;
      g_dT -= T(5) * jerk * e.invdT;
      g_T = w.wei_time + g_dT / T(ns);
      if (S > 1) tm.sync();                      // gb before member 0 reads
    }
    // the segment's duration: its own terms and the later segments'
    // obstacle times; then its junction rows into the gear variables
    const T dTdvt =
        e.vt > T(0) ? e.vt + T(1) : -(e.vt - T(1)) / (e.qneg * e.qneg);
    for (int k = 0; k < KR; ++k)
      if (tm.member(k) == 0) {
        if (S == 1) {
          L.g[NIN] = w.cost_scale * (g_T * dTdvt * sigma);
          for (int i = NIN + 1; i < DP; ++i) L.g[i] = T(0);
        } else {
          L.g[NIN + s] = w.cost_scale * ((g_T + g_tt_after) * dTdvt * sigma);
        }
        if (S > 1 && on) {
          const T cs = w.cost_scale, nsv = w.non_sinv;
          if (s > 0 && L.lm[S + s] > T(0.5)) {         // head of segment s
            const int j = s - 1;
            const T ga = L.x[NIN + S + 2 * (S - 1) + j];
            L.g[NIN + S + 2 * j] += cs * L.gb[0];
            L.g[NIN + S + 2 * j + 1] += cs * L.gb[1];
            L.g[NIN + S + 2 * (S - 1) + j] +=
                cs * (nsv * (L.gb[2] * m_sin(ga) - L.gb[3] * m_cos(ga)));
          }
          if (s < S - 1 && L.lm[S + s + 1] > T(0.5)) {  // tail of segment s
            const int j = s;
            const T ga = L.x[NIN + S + 2 * (S - 1) + j];
            L.g[NIN + S + 2 * j] += cs * L.gb[4];
            L.g[NIN + S + 2 * j + 1] += cs * L.gb[5];
            L.g[NIN + S + 2 * (S - 1) + j] +=
                cs * (nsv * (L.gb[7] * m_cos(ga) - L.gb[6] * m_sin(ga)));
          }
        }
      }
    g_tt_after = g_tt_after + g_tt;
    tm.sync();
  }
  return w.cost_scale * T(f);
}

}  // namespace dftpav
