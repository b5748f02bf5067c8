// The whole L-BFGS solve of ONE lane, as __host__ __device__ code.
//
// Replaces the solver half of the TPU whole-solve kernel:
// dftpav_tpu/ops/pallas_solve.py _kernel -> _solve_rounds. Per lane it runs
// the same round loop as dftpav_tpu_torch/ops/pallas_solve.py _solve_rounds
// (the plain reference): each round evaluates the trial point; Lewis-Overton
// accept or bracket (lbfgs.hpp:276-389); on accept the g_epsilon and past-delta
// stop tests, the cautious history update (m pairs, LBFGSParams.mem_size),
// the two-loop direction and the next line-search setup with the adaptive
// warm step. A lane that is not RUNNING never changes again, so exiting it
// at once is the same as the TPU tile idling it until its slowest lane
// finished.
//
// Integer state (k, line-search count, status, history bound) is int, where
// the TPU carried floats for Mosaic. The history is a ring indexed newest
// first, where the TPU shifted a tuple of m arrays. The solver runs on a
// team (team.cuh): on the card the lane's warp, each thread holding one
// decision coordinate of every vector in registers (two or more above 32
// coordinates, the multi-gear classes), the evaluated point in shared
// memory, the history there too up to kMemShared pairs and in a per-lane
// scratch in global memory above (lane_history), or where a slice with it
// leaves too few warps (kernels.cuh place: capacity 32, whose decision
// vectors have up to 528 rows).
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

// History pairs (m) that a warp's slice of shared memory holds; a longer
// history lies in a per-lane scratch in global memory (lane_history).
constexpr int kMemShared = 16;
// Past-f window slots a slice reserves at least (it holds max(past, this)).
constexpr int kPastSlots = 8;

// At capacity 8 and S <= 4, kernel B is also built with m = kMemShared
// fixed at compile time (lane_solve's KM): the history then stays in the
// slice and its ring has a constant length, the code the m = 16 classes
// (the main path's) ran before m became a run-time value; with m at run
// time their kernel B measured 4-16% slower on the bench class (more
// instructions, history loads that may be shared or global; PERF.md
// section 6). Other m, capacities 16 and 32, and the classes of more than
// four segments (one kernel B each, which keeps their build short) run
// with m at run time (KM = 0).
template <int N, int S>
constexpr int kFixedMem = N == 8 && S <= 4 ? kMemShared : 0;

template <class T>
struct LP {
  T delta, delta_past, g_eps, min_step, max_step, f_dec, s_curv, cautious,
      machine_prec, ad_lo, ad_mult;
  int max_iter, max_ls, mem, past, adaptive;
};

template <class T, class S>
DFT_HD LP<T> make_lp(const S* a, int max_iter, int max_ls, int mem, int past,
                     int adaptive) {
  LP<T> p;
  p.delta = T(a[L_DELTA]); p.delta_past = T(a[L_DELTA_PAST]);
  p.g_eps = T(a[L_G_EPS]); p.min_step = T(a[L_MIN_STEP]);
  p.max_step = T(a[L_MAX_STEP]); p.f_dec = T(a[L_F_DEC]);
  p.s_curv = T(a[L_S_CURV]); p.cautious = T(a[L_CAUTIOUS]);
  p.machine_prec = T(a[L_MACHINE_PREC]); p.ad_lo = T(a[L_AD_LO]);
  p.ad_mult = T(a[L_AD_MULT]);
  p.max_iter = max_iter; p.max_ls = max_ls; p.mem = mem; p.past = past;
  p.adaptive = adaptive;
  return p;
}

struct SolveOut {
  int status, k, n_evals;
};

// Where the solver keeps what it indexes at run time: the m history pairs
// s, y [m][DP] (newest first from `head`, a ring), their s.y, the
// two-loop's alphas (the team's scratch, or the lane's global scratch for a
// long history) and the past-f window (the team's scratch: shared memory on
// the card).
template <class T>
struct SolverMem {
  T* s;
  T* y;
  T* ys;
  T* alpha;
  T* pf;
  int m;
};

// Floats of one lane's history in a per-lane scratch [B][hist_floats]:
// s [m][DP], y [m][DP], ys [m], alpha [m].
DFT_HD size_t hist_floats(int m, int DP) {
  return 2 * (size_t)m * DP + 2 * (size_t)m;
}

// Points M's history at lane `lane`'s part of such a scratch.
template <class T>
DFT_HD void lane_history(SolverMem<T>& M, T* base, int lane, int DP) {
  T* h = base + (size_t)lane * hist_floats(M.m, DP);
  M.s = h;
  M.y = h + (size_t)M.m * DP;
  M.ys = h + 2 * (size_t)M.m * DP;
  M.alpha = M.ys + M.m;
}

// Dot product and max-abs of solver vectors whose coordinates the team
// holds kVec at a time (team.cuh).
template <class T, class Team>
DFT_HD T tdot(const Team& tm, const T* a, const T* b) {
  T pr[Team::kVec];
  for (int k = 0; k < Team::kVec; ++k) pr[k] = a[k] * b[k];
  return tm.vsum(pr);
}
template <class T, class Team>
DFT_HD T tmaxabs(const Team& tm, const T* a) {
  T t[Team::kVec];
  for (int k = 0; k < Team::kVec; ++k) t[k] = m_abs(a[k]);
  return tm.vmax(t);
}

// Slot i of a ring of m history slots, 0 <= i < 2 m. KM > 0: m is KM,
// known at compile time (the m = 16 kernels, whose code stays what it was
// before m became a run-time value); KM = 0: m is a run-time value, and a
// modulo by it would cost an integer division per history pair.
template <int KM>
DFT_HD int ring_slot(int i, int m) {
  if (KM > 0) return i % KM;
  return i < m ? i : i - m;
}

// Solve the lane whose data L holds, from x0 with its objective value f0
// and gradient g0 already evaluated (kernel A); x0, g0 and x_out are this
// object's coordinates of the vectors (coordinate tm.coord(k) at k; those
// with !tm.valid(k), past DP, are 0 and stay 0).
// Writes the final base point to x_out and its objective to *f_out.
// Returns status, k clamped to max_iter, evaluations. Every team-reduced
// value is bitwise identical on all members, so all members take the same
// branches. KM: the history length when it is fixed at compile time (then
// M.m == KM), else 0 (ring_slot).
template <class T, int N, int S, int KM, class Team>
DFT_HD SolveOut lane_solve(const Team& tm, LaneS<T, S>& L,
                           const KWS<T, S>& w, const LP<T>& p,
                           const SolverMem<T>& M, const T* x0, T f0,
                           const T* g0, T* x_out, T* f_out) {
  constexpr int DP = KDims<N, S>::DP, V = Team::kVec;
  // a coordinate of a vector in the scratch (0 past DP)
  auto ld = [&](const T* a, int c) {
    return tm.valid(c) ? a[tm.coord(c)] : T(0);
  };
  T xp[V], gp[V], d[V], xt[V], gt[V];
  const int mem = KM > 0 ? KM : M.m;
  const int past = p.past > 1 ? p.past : 1;
  const bool use_past = p.past > 0;

  for (int k = 0; k < V; ++k) {
    xp[k] = x0[k];
    gp[k] = g0[k];
    d[k] = -g0[k];
  }
  T fp = f0;
  const bool already =
      tmaxabs(tm, g0) / m_max(T(1), tmaxabs(tm, x0)) < p.g_eps;
  const T dginit0 = tdot(tm, gp, d);
  T stp = T(1) / m_max(m_sqrt(tdot(tm, d, d)), T(1e-30));
  T finit = f0, dgtest = p.f_dec * dginit0, dstest = p.s_curv * dginit0;
  T mu = T(0), nu = p.max_step;
  bool brackt = false, touched = false;
  int lscnt = 0, bound = 0, head = 0, k = 1, n_evals = 1;
  M.pf[0] = f0;
  for (int i = 1; i < past; ++i) M.pf[i] = T(0);
  int status = already ? ST_CONVERGENCE : ST_RUNNING;

  while (status == ST_RUNNING) {
    for (int c = 0; c < V; ++c) {
      xt[c] = xp[c] + stp * d[c];
      if (tm.valid(c)) L.x[tm.coord(c)] = xt[c];
    }
    tm.sync();
    const T ft = lane_eval<T, N, S>(tm, L, w);
    ++n_evals;
    for (int c = 0; c < V; ++c) gt[c] = ld(L.g, c);

    // Lewis-Overton decision
    const T dg = tdot(tm, gt, d);
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
    const bool conv =
        tmaxabs(tm, gt) / m_max(T(1), tmaxabs(tm, xt)) < p.g_eps;
    if (accept && conv) status = ST_CONVERGENCE;
    if (use_past) {
      const int slot = k % past;
      const T pf_slot = M.pf[slot];
      const T rate = m_abs(pf_slot - ft) / m_max(T(1), m_abs(ft));
      const bool stop = (k >= past) && (rate < p.delta);
      if (accept && status == ST_RUNNING && stop) status = ST_STOP;
      if (accept) M.pf[slot] = status == ST_RUNNING ? ft : pf_slot;
    }
    // a running lane finishes its whole state transition before MAXITER
    const bool running = accept && status == ST_RUNNING;
    if (running) ++k;

    if (accept) {
      // cautious history update
      T s[V], y[V];
      for (int c = 0; c < V; ++c) {
        s[c] = xt[c] - xp[c];
        y[c] = gt[c] - gp[c];
      }
      const T ys = tdot(tm, y, s);
      const T yy = tdot(tm, y, y);
      const T cau = tdot(tm, s, s) * m_sqrt(tdot(tm, gp, gp)) * p.cautious;
      const bool do_up = running && ys > cau;
      if (do_up) {
        head = ring_slot<KM>(head + mem - 1, mem);
        for (int c = 0; c < V; ++c)
          if (tm.valid(c)) {
            M.s[head * DP + tm.coord(c)] = s[c];
            M.y[head * DP + tm.coord(c)] = y[c];
          }
        M.ys[head] = ys;
        bound = bound + 1 < mem ? bound + 1 : mem;
        // two-loop recursion, newest entry first
        T hv[V];
        for (int c = 0; c < V; ++c) d[c] = -gt[c];
        for (int j = 0; j < bound; ++j) {
          const int h = ring_slot<KM>(head + j, mem);
          for (int c = 0; c < V; ++c) hv[c] = ld(M.s + h * DP, c);
          const T a = tdot(tm, hv, d) / M.ys[h];
          for (int c = 0; c < V; ++c) d[c] = d[c] - a * ld(M.y + h * DP, c);
          M.alpha[j] = a;
        }
        const T scale = ys / m_max(yy, T(1e-30));
        for (int c = 0; c < V; ++c) d[c] = d[c] * scale;
        for (int j = bound - 1; j >= 0; --j) {
          const int h = ring_slot<KM>(head + j, mem);
          for (int c = 0; c < V; ++c) hv[c] = ld(M.y + h * DP, c);
          const T b = tdot(tm, hv, d) / M.ys[h];
          for (int c = 0; c < V; ++c)
            d[c] = d[c] + (M.alpha[j] - b) * ld(M.s + h * DP, c);
        }
      } else {
        for (int c = 0; c < V; ++c) d[c] = -gt[c];
      }
      // next line-search setup
      const T dginit = tdot(tm, gt, d);
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
      for (int c = 0; c < V; ++c) {
        xp[c] = xt[c];
        gp[c] = gt[c];
      }
    } else {
      stp = stp_n;
    }
    brackt = brackt_b && !accept;
    touched = touched_b && !accept;
    if (accept || ls_fail) fp = ft;
  }

  for (int c = 0; c < V; ++c) x_out[c] = xp[c];
  *f_out = fp;
  SolveOut out;
  out.status = status;
  out.k = k < p.max_iter ? k : p.max_iter;
  out.n_evals = n_evals;
  return out;
}

}  // namespace dftpav
