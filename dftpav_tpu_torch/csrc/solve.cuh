// The whole L-BFGS solve of ONE lane, as __host__ __device__ code.
//
// Replaces the solver half of the TPU whole-solve kernel:
// dftpav_tpu/ops/pallas_solve.py _kernel -> _solve_rounds. Per lane it runs
// the same round loop as dftpav_tpu_torch/ops/pallas_solve.py _solve_rounds
// (the plain reference): each round evaluates the trial point; Lewis-Overton
// accept or bracket (lbfgs.hpp:276-389); on accept the g_epsilon and past-delta
// stop tests, the cautious m = 16 history update, the two-loop direction and
// the next line-search setup with the adaptive warm step. A lane that is not
// RUNNING never changes again, so exiting it at once is the same as the TPU
// tile idling it until its slowest lane finished.
//
// Integer state (k, line-search count, status, history bound) is int, where
// the TPU carried floats for Mosaic. The history is a ring indexed newest
// first, where the TPU shifted a tuple of 16 arrays.
#pragma once

#include "kcost.cuh"

namespace dftpav {

enum StatusCode {
  ST_CONVERGENCE = 0, ST_STOP = 1, ST_MAXITER = 2, ST_MAXLS = 3,
  ST_RUNNING = 99, ST_ERR_WIDTHTOOSMALL = -2, ST_ERR_MINSTEP = -3,
  ST_ERR_MAXSTEP = -4, ST_ERR_INCREASEGRADIENT = -5
};

// Layout of the L-BFGS parameter vector handed to the C entry points.
enum LIdx {
  L_DELTA = 0, L_DELTA_PAST, L_G_EPS, L_MIN_STEP, L_MAX_STEP, L_F_DEC,
  L_S_CURV, L_CAUTIOUS, L_MACHINE_PREC, L_AD_LO, L_AD_MULT, L_LEN
};

constexpr int kMem = 16;      // history length m
constexpr int kMaxPast = 8;   // past-f window bound

template <class T>
struct LP {
  T delta, delta_past, g_eps, min_step, max_step, f_dec, s_curv, cautious,
      machine_prec, ad_lo, ad_mult;
  int max_iter, max_ls, past, adaptive;
};

template <class T, class S>
DFT_HD LP<T> make_lp(const S* a, int max_iter, int max_ls, int past,
                     int adaptive) {
  LP<T> p;
  p.delta = T(a[L_DELTA]); p.delta_past = T(a[L_DELTA_PAST]);
  p.g_eps = T(a[L_G_EPS]); p.min_step = T(a[L_MIN_STEP]);
  p.max_step = T(a[L_MAX_STEP]); p.f_dec = T(a[L_F_DEC]);
  p.s_curv = T(a[L_S_CURV]); p.cautious = T(a[L_CAUTIOUS]);
  p.machine_prec = T(a[L_MACHINE_PREC]); p.ad_lo = T(a[L_AD_LO]);
  p.ad_mult = T(a[L_AD_MULT]);
  p.max_iter = max_iter; p.max_ls = max_ls; p.past = past;
  p.adaptive = adaptive;
  return p;
}

// Dot product of two vectors whose coordinates are split over the group:
// each member holds L of them; the partial sums are all-reduced.
template <class T, int L, class Grp>
DFT_HD T gdot(const T* a, const T* b, const Grp& grp) {
  T s = T(0);
  for (int i = 0; i < L; ++i) s += a[i] * b[i];
  return grp.sum(s);
}
template <class T, int DP>
DFT_HD T vmaxabs(const T* a) {
  T s = m_abs(a[0]);
  for (int i = 1; i < DP; ++i) s = m_max(s, m_abs(a[i]));
  return s;
}

struct SolveOut {
  int status, k, n_evals;
};

// Solve lane `lane` from x0 with its objective value f0 and gradient g0
// already evaluated (kernel A); writes the final base point to x_out and its
// objective to *f_out. Returns status, k clamped to max_iter, evaluations.
//
// With a group of G threads per lane, each member keeps L = DP / G of the
// decision coordinates of the iterate, gradient, direction and the m = 16
// history pairs; dot products are all-reduced over the group, and the full
// trial point is gathered for the objective (lane_fg returns the full
// gradient to every member). Every reduced value is bitwise identical on all
// members (see Solo), so all members take the same branches.
template <class T, int N, class Grp = Solo>
DFT_HD SolveOut lane_solve(const T* x0, T f0, const T* g0, const Slabs<T>& sl,
                           int lane, const T* P, const T* Q, const T* gridc,
                           const KW<T>& w, const LP<T>& p, T* x_out,
                           T* f_out, const Grp& grp = Grp()) {
  constexpr int DP = KDims<N>::DP;
  constexpr int L = DP / Grp::size;
  static_assert(DP % Grp::size == 0, "group size must divide DP");
  const int me = grp.rank();
  T xp[L], gp[L], d[L], xt[L], gt[L];
  T xt_full[DP], gt_full[DP];
  T lm_s[kMem][L], lm_y[kMem][L], lm_ys[kMem], alpha[kMem];
  T pf[kMaxPast];
  const int past = p.past > 1 ? p.past : 1;
  const bool use_past = p.past > 0;

  // this member's slice of a full vector (compile-time indices only)
  for (int i = 0; i < DP; ++i)
    if (i / L == me) {
      xp[i % L] = x0[i];
      gp[i % L] = g0[i];
      d[i % L] = -g0[i];
    }
  T fp = f0;
  const bool already = vmaxabs<T, DP>(g0) / m_max(T(1), vmaxabs<T, DP>(x0)) <
                       p.g_eps;
  const T dginit0 = gdot<T, L>(gp, d, grp);
  T stp = T(1) / m_max(m_sqrt(gdot<T, L>(d, d, grp)), T(1e-30));
  T finit = f0, dgtest = p.f_dec * dginit0, dstest = p.s_curv * dginit0;
  T mu = T(0), nu = p.max_step;
  bool brackt = false, touched = false;
  int lscnt = 0, bound = 0, head = 0, k = 1, n_evals = 1;
  pf[0] = f0;
  for (int i = 1; i < past; ++i) pf[i] = T(0);
  int status = already ? ST_CONVERGENCE : ST_RUNNING;

  while (status == ST_RUNNING) {
    for (int i = 0; i < L; ++i) xt[i] = xp[i] + stp * d[i];
    for (int i = 0; i < DP; ++i) xt_full[i] = grp.bcast(xt[i % L], i / L);
    const T ft =
        lane_fg<T, N, Grp>(xt_full, gt_full, sl, lane, P, Q, gridc, w, grp);
    ++n_evals;
    for (int i = 0; i < DP; ++i)
      if (i / L == me) gt[i % L] = gt_full[i];

    // Lewis-Overton decision
    const T dg = gdot<T, L>(gt, d, grp);
    const bool bad = !m_isfinite(ft);
    const bool early =
        use_past && (m_abs(finit - ft) / (m_abs(finit) + T(1)) < p.delta_past);
    const bool armijo_fail = bad || (ft > finit + stp * dgtest);
    const bool wolfe_fail = dg < dstest;
    const bool accept = (early && !bad) || (!armijo_fail && !wolfe_fail);
    const bool cont = !accept;

    // bracket / step update
    if (cont && armijo_fail) nu = stp;
    const bool brackt_b = brackt || (cont && armijo_fail);
    if (cont && !armijo_fail && wolfe_fail) mu = stp;
    if (cont) ++lscnt;
    int code = 0;
    if (cont && lscnt >= p.max_ls) code = 2;
    if (cont && code == 0 && brackt_b && (nu - mu) < p.machine_prec * nu)
      code = ST_ERR_WIDTHTOOSMALL;
    T stp_n = brackt_b ? T(0.5) * (mu + nu) : stp * T(2);
    if (cont && code == 0 && stp_n < p.min_step) code = ST_ERR_MINSTEP;
    const bool over = stp_n > p.max_step;
    if (cont && code == 0 && over && touched) code = ST_ERR_MAXSTEP;
    const bool touched_b = touched || (cont && over);
    if (over) stp_n = p.max_step;
    const bool ls_fail = cont && code != 0;
    if (ls_fail) status = code == 2 ? ST_MAXLS : code;

    // iteration end for an accepted trial
    const bool conv = vmaxabs<T, DP>(gt_full) /
                          m_max(T(1), vmaxabs<T, DP>(xt_full)) <
                      p.g_eps;
    if (accept && conv) status = ST_CONVERGENCE;
    if (use_past) {
      const int slot = k % past;
      const T pf_slot = pf[slot];
      const T rate = m_abs(pf_slot - ft) / m_max(T(1), m_abs(ft));
      const bool stop = (k >= past) && (rate < p.delta);
      if (accept && status == ST_RUNNING && stop) status = ST_STOP;
      if (accept) pf[slot] = status == ST_RUNNING ? ft : pf_slot;
    }
    // a running lane finishes its whole state transition before MAXITER
    const bool running = accept && status == ST_RUNNING;
    if (running) ++k;

    if (accept) {
      // cautious history update
      T s[L], y[L];
      for (int i = 0; i < L; ++i) {
        s[i] = xt[i] - xp[i];
        y[i] = gt[i] - gp[i];
      }
      const T ys = gdot<T, L>(y, s, grp);
      const T yy = gdot<T, L>(y, y, grp);
      const T cau = gdot<T, L>(s, s, grp) *
                    m_sqrt(gdot<T, L>(gp, gp, grp)) * p.cautious;
      const bool do_up = running && ys > cau;
      if (do_up) {
        head = (head + kMem - 1) % kMem;
        for (int i = 0; i < L; ++i) {
          lm_s[head][i] = s[i];
          lm_y[head][i] = y[i];
        }
        lm_ys[head] = ys;
        bound = bound + 1 < kMem ? bound + 1 : kMem;
        // two-loop recursion, newest entry first
        for (int i = 0; i < L; ++i) d[i] = -gt[i];
        for (int j = 0; j < bound; ++j) {
          const int h = (head + j) % kMem;
          const T a = gdot<T, L>(lm_s[h], d, grp) / lm_ys[h];
          for (int i = 0; i < L; ++i) d[i] = d[i] - a * lm_y[h][i];
          alpha[j] = a;
        }
        const T scale = ys / m_max(yy, T(1e-30));
        for (int i = 0; i < L; ++i) d[i] = d[i] * scale;
        for (int j = bound - 1; j >= 0; --j) {
          const int h = (head + j) % kMem;
          const T b = gdot<T, L>(lm_y[h], d, grp) / lm_ys[h];
          for (int i = 0; i < L; ++i) d[i] = d[i] + (alpha[j] - b) * lm_s[h][i];
        }
      } else {
        for (int i = 0; i < L; ++i) d[i] = -gt[i];
      }
      // next line-search setup
      const T dginit = gdot<T, L>(gt, d, grp);
      if (running && dginit > T(0)) status = ST_ERR_INCREASEGRADIENT;
      if (running && status == ST_RUNNING && k > p.max_iter)
        status = ST_MAXITER;
      finit = ft;
      dgtest = p.f_dec * dginit;
      dstest = p.s_curv * dginit;
      mu = T(0);
      nu = p.max_step;
      lscnt = 0;
      stp = p.adaptive ? m_min(m_max(stp * p.ad_mult, p.ad_lo), T(1)) : T(1);
      for (int i = 0; i < L; ++i) {
        xp[i] = xt[i];
        gp[i] = gt[i];
      }
    } else {
      stp = stp_n;
    }
    brackt = brackt_b && !accept;
    touched = touched_b && !accept;
    if (accept || ls_fail) fp = ft;
  }

  for (int i = 0; i < DP; ++i) x_out[i] = grp.bcast(xp[i % L], i / L);
  *f_out = fp;
  SolveOut out;
  out.status = status;
  out.k = k < p.max_iter ? k : p.max_iter;
  out.n_evals = n_evals;
  return out;
}

}  // namespace dftpav
