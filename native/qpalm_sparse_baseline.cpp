// Native single-threaded sparse C++ baseline solver: the wall-clock
// comparator for the Maros-Meszaros-at-scale table (VERDICT r4 missing #1).
//
// A sparse, double-precision proximal-ALM + semismooth-Newton QP solver
// with the same algorithmic semantics as reference C-QPALM (reference:
// src/qpalm.c:401-736, src/iteration.c, src/newton.c, src/linesearch.c,
// src/termination.c) built the way the reference's CHOLMOD backend is
// (Schur form only, solver_interface.c:72-74): sparse LDL' of
// M = Q + A' Sigma_act A + (1/gamma) I with AMD fill-reducing ordering,
// numeric refactorization on active-set/penalty change against a superset
// symbolic pattern (all constraints active), exact breakpoint linesearch
// with qsort, reference default schedules (sigma_init/delta/theta/rho).
//
// Deliberately does NOT include this framework's beyond-reference
// stagnation rescue (host_sparse.py) — the baseline represents what the
// reference algorithm does; schedule improvements are part of what the
// framework is measured against.
//
// Reuses the in-repo native LDL kernel (sparse_ldl.cpp) and AMD ordering
// (amd_order.cpp) — compiled into the same shared object (see Makefile).
//
// NOT a copy of the reference: the reference does per-constraint rank-1
// LDL updates on a LADEL factor with a mutable ~60-vector workspace; this
// is a ~550-line refactorizing solver over an index-mapped superset
// pattern.  The rank-1-update economy is traded for refactorization
// against a precomputed assembly map — on the MM family patterns
// (<= ~5 nnz per constraint row) the assembly is O(nnz), so a
// refactorization costs about what ~2-3 rank-1 updates would.

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstring>
#include <vector>

// from sparse_ldl.cpp (same .so)
extern "C" {
void *ldl_symbolic(int n, const int *Ap, const int *Ai);
int ldl_numeric(void *h, const int *Ap, const int *Ai, const double *Ax,
                double shift, int shift_size);
void ldl_solve(void *h, double *b);
void ldl_free(void *h);
// from amd_order.cpp (same .so)
int amd_order(int n, const int *Ap, const int *Ai, int *perm);
}

namespace {

constexpr double kInfty = 1e20;  // reference: constants.h QPALM_INFTY

struct Settings {
  double eps_abs = 1e-6;
  double eps_rel = 1e-6;
  double eps_abs_in = 1.0;
  double eps_rel_in = 1.0;
  double rho = 0.1;
  double theta = 0.25;
  double delta = 100.0;
  double sigma_max = 1e9;
  double sigma_init = 2e1;
  double gamma_init = 1e7;
  double gamma_upd = 10.0;
  double gamma_max = 1e7;
  int proximal = 1;
  int max_iter = 50000;
  int inner_max_iter = 100;
  int scaling = 10;
  // framework mode (NOT part of the reference-semantics baseline): the
  // stagnation rescue of qpalm_jax/host_sparse.py — when pri_res fails to
  // halve across 5 consecutive outer updates, escalate sigma globally by
  // delta.  Off (0) when this solver acts as the baseline comparator.
  int rescue = 0;
  int rescue_window = 5;  // outer updates without halving pri_res
  double time_limit = 0.0;  // seconds; 0 = unlimited
  double eps_prim_inf = 1e-5;  // reference: constants.h EPS_PRIM_INF
  double eps_dual_inf = 1e-5;
};

inline double norm_inf(const double *v, int k) {
  double r = 0.0;
  for (int i = 0; i < k; ++i) r = std::max(r, std::abs(v[i]));
  return r;
}

// CSC matrix (column pointers / row indices / values)
struct Csc {
  int rows = 0, cols = 0;
  std::vector<int> p, i;
  std::vector<double> x;
};

class SparseQpalm {
 public:
  SparseQpalm(int n, int m, const int *Qp, const int *Qi, const double *Qx,
              int Qnnz, const int *Ap, const int *Ai, const double *Axv,
              int Annz, const double *q, const double *bmin,
              const double *bmax, const Settings &s)
      : n_(n), m_(m), s_(s), q_(q, q + n), bmin_(bmin, bmin + m),
        bmax_(bmax, bmax + m), D_(n, 1.0), E_(m, 1.0), c_(1.0) {
    // store Q as upper-triangular CSC (drop any lower entries the caller
    // may have passed; reference data convention is upper-symmetric,
    // types.h:104-113)
    Q_.rows = Q_.cols = n;
    Q_.p.assign(n + 1, 0);
    for (int j = 0; j < n; ++j)
      for (int p = Qp[j]; p < Qp[j + 1]; ++p)
        if (Qi[p] <= j) Q_.p[j + 1]++;
    for (int j = 0; j < n; ++j) Q_.p[j + 1] += Q_.p[j];
    Q_.i.resize(Q_.p[n]);
    Q_.x.resize(Q_.p[n]);
    {
      std::vector<int> cur(Q_.p.begin(), Q_.p.end() - 1);
      for (int j = 0; j < n; ++j)
        for (int p = Qp[j]; p < Qp[j + 1]; ++p)
          if (Qi[p] <= j) {
            Q_.i[cur[j]] = Qi[p];
            Q_.x[cur[j]] = Qx[p];
            cur[j]++;
          }
    }
    (void)Qnnz;
    A_.rows = m;
    A_.cols = n;
    A_.p.assign(Ap, Ap + n + 1);
    A_.i.assign(Ai, Ai + Annz);
    A_.x.assign(Axv, Axv + Annz);
    if (s_.scaling > 0) ruiz_scale();
    build_row_view();
    build_schur_pattern();
    x_.assign(n, 0.0);
    y_.assign(m, 0.0);
    x0_ = x_;
    x_prev_ = x_;
    Qx_.assign(n, 0.0);
    Ax_.assign(m, 0.0);
    active_.assign(m, 0);
    active_old_.assign(m, 0);
    sigma_.assign(m, 0.0);
    bp_.resize(2 * (size_t)m);
    tAd_.assign(m, 0.0);
    tQd_pure_.assign(n, 0.0);
    tmpm_cert_.resize(m);
    tmpn_cert_.resize(n);
    cert_dy_.assign(m, 0.0);
    cert_dx_.assign(n, 0.0);
  }

  ~SparseQpalm() {
    if (ldl_) ldl_free(ldl_);
  }

  // returns status (1 solved, -2 max_iter, 0 internal/factorization error)
  int solve(double *x_out, double *y_out, int *iter_out, double *obj_out) {
    init_sigma();
    gamma_ = s_.gamma_init;
    eps_abs_in_ = s_.eps_abs_in;
    eps_rel_in_ = s_.eps_rel_in;
    pri_res_in_.assign(m_, 0.0);
    factor_valid_ = false;
    gamma_maxed_ = false;
    int iter_out_count = 0, prev_iter = 0, no_change = 0;
    int status = -2;
    int iter = 0;
    double best_pri_outer = kInfty;
    int stall_outer = 0;
    auto t_start = std::chrono::steady_clock::now();
    std::vector<double> Axys(m_), z(m_), pri_res(m_), yh(m_), Atyh(n_),
        df(n_), dphi(n_), d(n_), Qd(n_), Ad(m_);
    for (iter = 0; iter < s_.max_iter; ++iter) {
      // every iteration: one steady_clock read is ~20 ns, while a single
      // iteration on a heavy-fill instance can run minutes (observed on
      // AUG2D-A: a 16-iteration check stride overshot the cap ~20x)
      if (s_.time_limit > 0.0) {
        std::chrono::duration<double> el =
            std::chrono::steady_clock::now() - t_start;
        if (el.count() > s_.time_limit) {
          status = -5;  // QPALM_TIME_LIMIT_REACHED (constants.h)
          break;
        }
      }
      // ---- residuals (reference: iteration.c:24-48) ----
      for (int k = 0; k < m_; ++k) {
        Axys[k] = Ax_[k] + y_[k] / sigma_[k];
        z[k] = std::min(std::max(Axys[k], bmin_[k]), bmax_[k]);
        pri_res[k] = Ax_[k] - z[k];
        yh[k] = y_[k] + sigma_[k] * pri_res[k];
      }
      mat_tvec(yh.data(), Atyh.data());
      for (int i = 0; i < n_; ++i) {
        df[i] = Qx_[i] + q_[i];
        if (s_.proximal) df[i] -= x0_[i] / gamma_;
        dphi[i] = df[i] + Atyh[i];
      }
      // ---- termination (reference: termination.c:44-129) ----
      double pri_norm = 0.0, ax_n = 0.0, z_n = 0.0;
      for (int k = 0; k < m_; ++k) {
        pri_norm = std::max(pri_norm, std::abs(pri_res[k]) / E_[k]);
        ax_n = std::max(ax_n, std::abs(Ax_[k]) / E_[k]);
        z_n = std::max(z_n, std::abs(z[k]) / E_[k]);
      }
      double dua_norm = 0.0, dua2_norm = 0.0, qx_n = 0.0, q_n = 0.0,
             aty_n = 0.0;
      for (int i = 0; i < n_; ++i) {
        double di = dphi[i];
        if (s_.proximal) di -= (x_[i] - x0_[i]) / gamma_;
        dua_norm = std::max(dua_norm, std::abs(di) / D_[i]);
        dua2_norm = std::max(dua2_norm, std::abs(dphi[i]) / D_[i]);
        qx_n = std::max(qx_n, std::abs(Qx_[i]) / D_[i]);
        q_n = std::max(q_n, std::abs(q_[i]) / D_[i]);
        aty_n = std::max(aty_n, std::abs(Atyh[i]) / D_[i]);
      }
      dua_norm /= c_;
      dua2_norm /= c_;
      double eps_pri = s_.eps_abs + s_.eps_rel * std::max(ax_n, z_n);
      double max_norm = std::max(qx_n, std::max(q_n, aty_n)) / c_;
      double eps_dua = s_.eps_abs + s_.eps_rel * max_norm;
      double eps_dua_in = eps_abs_in_ + eps_rel_in_ * max_norm;

      if (pri_norm < eps_pri && dua_norm < eps_dua) {
        status = 1;
        y_ = yh;
        break;
      }
      // ---- infeasibility certificates (termination.c:136-240) ----
      {
        double edy_n = 0.0;
        for (int k = 0; k < m_; ++k)
          edy_n = std::max(edy_n, std::abs(E_[k] * (yh[k] - y_[k])));
        double eps_p = s_.eps_prim_inf * edy_n;
        if (eps_p > 0.0) {
          for (int k = 0; k < m_; ++k) tmpm_cert_[k] = yh[k] - y_[k];
          mat_tvec(tmpm_cert_.data(), tmpn_cert_.data());
          double atdy_n = 0.0;
          for (int i = 0; i < n_; ++i)
            atdy_n = std::max(atdy_n, std::abs(tmpn_cert_[i] / D_[i]));
          double oob = 0.0;
          for (int k = 0; k < m_; ++k) {
            double dy = tmpm_cert_[k];
            if (bmax_[k] < kInfty && dy > 0.0) oob += bmax_[k] * dy;
            if (bmin_[k] > -kInfty && dy < 0.0) oob += bmin_[k] * dy;
          }
          if (atdy_n <= eps_p && oob <= -eps_p) {
            status = -3;  // QPALM_PRIMAL_INFEASIBLE
            // unscaled certificate delta_y = E (dy / c) (host_sparse twin)
            for (int k = 0; k < m_; ++k)
              cert_dy_[k] = E_[k] * (tmpm_cert_[k] / c_);
            y_ = yh;
            break;
          }
        }
        double ddx_n = 0.0;
        for (int i = 0; i < n_; ++i)
          ddx_n = std::max(ddx_n, std::abs(D_[i] * (x_[i] - x_prev_[i])));
        double eps_d = s_.eps_dual_inf * ddx_n;
        if (eps_d > 0.0) {
          bool viol = false;
          for (int k = 0; k < m_ && !viol; ++k) {
            double adx = tAd_[k] / E_[k];
            viol = (bmax_[k] < kInfty && adx >= eps_d) ||
                   (bmin_[k] > -kInfty && adx <= -eps_d);
          }
          double dxQdx = 0.0, dxdx = 0.0, qdx = 0.0;
          for (int i = 0; i < n_; ++i) {
            double dx = x_[i] - x_prev_[i];
            dxQdx += dx * tQd_pure_[i];
            dxdx += (D_[i] * dx) * (D_[i] * dx);
            qdx += q_[i] * dx;
          }
          double e2 = s_.eps_dual_inf * s_.eps_dual_inf;
          double cs = s_.scaling ? c_ : 1.0;
          bool curv = dxQdx <= -cs * e2 * dxdx ||
                      (dxQdx <= cs * e2 * dxdx && qdx <= -cs * eps_d);
          if (!viol && curv) {
            status = -4;  // QPALM_DUAL_INFEASIBLE
            for (int i = 0; i < n_; ++i)
              cert_dx_[i] = D_[i] * (x_[i] - x_prev_[i]);
            break;
          }
        }
      }
      bool subproblem_done = dua2_norm <= eps_dua_in;
      bool outer_trigger = subproblem_done || no_change == 3;
      bool exhausted = (iter == prev_iter + s_.inner_max_iter);
      if (outer_trigger || exhausted) {
        // ---- outer update (reference: qpalm.c:515-660) ----
        no_change = 0;
        if (iter_out_count > 0 && pri_norm > eps_pri)
          update_sigma(pri_res.data());
        if (s_.rescue && iter_out_count > 0) {
          // framework-mode stagnation rescue (host_sparse.py twin)
          if (pri_norm < 0.5 * best_pri_outer)
            stall_outer = 0;
          else
            ++stall_outer;
          best_pri_outer = std::min(best_pri_outer, pri_norm);
          if (stall_outer >= s_.rescue_window && pri_norm > eps_pri) {
            for (int k = 0; k < m_; ++k)
              sigma_[k] = std::min(sigma_[k] * s_.delta, s_.sigma_max);
            factor_valid_ = false;
            stall_outer = 0;
            best_pri_outer = pri_norm;
          }
        }
        y_ = yh;
        eps_abs_in_ = std::max(s_.eps_abs, s_.rho * eps_abs_in_);
        eps_rel_in_ = std::max(s_.eps_rel, s_.rho * eps_rel_in_);
        if (s_.proximal) {
          bool check = outer_trigger && !gamma_maxed_ && iter_out_count > 0 &&
                       nb_enter_ == 0 && nb_leave_ == 0 && pri_norm < eps_pri;
          if (check) {
            int nb_e2 = 0, nb_l2 = 0, nb_act = 0;
            for (int k = 0; k < m_; ++k) {
              double ax2 = Ax_[k] + y_[k] / sigma_[k];
              int act = (ax2 <= bmin_[k]) || (ax2 >= bmax_[k]);
              nb_e2 += act && !active_old_[k];
              nb_l2 += !act && active_old_[k];
              nb_act += act;
              active_[k] = act;
            }
            nb_enter_ = nb_e2;
            nb_leave_ = nb_l2;
            if (nb_e2 == 0 && nb_l2 == 0) {
              double boosted = nb_act > 0
                                   ? std::max(s_.gamma_max,
                                              1e14 / std::max(gersh_, 1e-30))
                                   : 1e12;
              apply_gamma(boosted);
              if (nb_act > 0) gamma_maxed_ = true;
            } else {
              step_gamma();
            }
          } else {
            step_gamma();
          }
          x0_ = x_;
        }
        pri_res_in_ = pri_res;
        ++iter_out_count;
        prev_iter = iter;
      } else {
        // ---- inner semismooth-Newton step (qpalm.c:662-678) ----
        int changed = 0;
        nb_enter_ = nb_leave_ = 0;
        for (int k = 0; k < m_; ++k) {
          int act = (Axys[k] <= bmin_[k]) || (Axys[k] >= bmax_[k]);
          nb_enter_ += act && !active_old_[k];
          nb_leave_ += !act && active_old_[k];
          changed |= (act != active_[k]);
          active_[k] = act;
        }
        no_change = (nb_enter_ + nb_leave_ > 0) ? 0 : no_change + 1;
        active_old_ = active_;
        if (changed || !factor_valid_) {
          if (!refactor()) return 0;
        }
        for (int i = 0; i < n_; ++i) d[i] = -dphi[i];
        ldl_solve_perm(d.data());
        symv(Qd.data(), d.data());
        // pure Q d (no proximal term) for the dual-infeasibility curvature
        // test — immune to later gamma updates (host_sparse.py twin)
        for (int i = 0; i < n_; ++i) tQd_pure_[i] = Qd[i];
        if (s_.proximal)
          for (int i = 0; i < n_; ++i) Qd[i] += d[i] / gamma_;
        mat_vec(d.data(), Ad.data());
        double tau = linesearch(d.data(), Qd.data(), Ad.data(), df.data());
        x_prev_ = x_;
        for (int i = 0; i < n_; ++i) {
          x_[i] += tau * d[i];
          Qx_[i] += tau * Qd[i];
          tQd_pure_[i] *= tau;
        }
        for (int k = 0; k < m_; ++k) {
          Ax_[k] += tau * Ad[k];
          tAd_[k] = tau * Ad[k];
        }
      }
    }
    for (int i = 0; i < n_; ++i) x_out[i] = D_[i] * x_[i];
    for (int k = 0; k < m_; ++k) y_out[k] = E_[k] * y_[k] / c_;
    *iter_out = iter;
    double obj = 0.0;
    for (int i = 0; i < n_; ++i) {
      double qx = Qx_[i];
      if (s_.proximal) qx -= x_[i] / gamma_;
      obj += (0.5 * qx + q_[i]) * x_[i];
    }
    *obj_out = obj / c_;
    return status;
  }

 private:
  // y = A x (CSC columns)
  void mat_vec(const double *x, double *y) {
    std::fill(y, y + m_, 0.0);
    for (int j = 0; j < n_; ++j) {
      double xj = x[j];
      if (xj == 0.0) continue;
      for (int p = A_.p[j]; p < A_.p[j + 1]; ++p) y[A_.i[p]] += A_.x[p] * xj;
    }
  }
  // y = A' w
  void mat_tvec(const double *w, double *y) {
    for (int j = 0; j < n_; ++j) {
      double s = 0.0;
      for (int p = A_.p[j]; p < A_.p[j + 1]; ++p) s += A_.x[p] * w[A_.i[p]];
      y[j] = s;
    }
  }
  // y = Q x from upper-CSC storage
  void symv(double *y, const double *x) {
    std::fill(y, y + n_, 0.0);
    for (int j = 0; j < n_; ++j) {
      double xj = x[j], acc = 0.0;
      for (int p = Q_.p[j]; p < Q_.p[j + 1]; ++p) {
        int i = Q_.i[p];
        double v = Q_.x[p];
        if (i == j) {
          acc += v * xj;
        } else {
          y[i] += v * xj;
          acc += v * x[i];
        }
      }
      y[j] += acc;
    }
  }

  void ruiz_scale() {
    // reference: scaling.c:34-113 on sparse storage
    std::vector<double> Dt(n_), Et(m_);
    for (int it = 0; it < s_.scaling; ++it) {
      std::fill(Dt.begin(), Dt.end(), 0.0);
      std::fill(Et.begin(), Et.end(), 0.0);
      for (int j = 0; j < n_; ++j)
        for (int p = A_.p[j]; p < A_.p[j + 1]; ++p) {
          double a = std::abs(A_.x[p]);
          Dt[j] = std::max(Dt[j], a);
          Et[A_.i[p]] = std::max(Et[A_.i[p]], a);
        }
      for (int j = 0; j < n_; ++j)
        Dt[j] = 1.0 / std::sqrt(Dt[j] < 1e-12 ? 1.0 : Dt[j]);
      for (int k = 0; k < m_; ++k)
        Et[k] = 1.0 / std::sqrt(Et[k] < 1e-12 ? 1.0 : Et[k]);
      for (int j = 0; j < n_; ++j)
        for (int p = A_.p[j]; p < A_.p[j + 1]; ++p)
          A_.x[p] *= Et[A_.i[p]] * Dt[j];
      for (int j = 0; j < n_; ++j) D_[j] *= Dt[j];
      for (int k = 0; k < m_; ++k) E_[k] *= Et[k];
    }
    for (int j = 0; j < n_; ++j) q_[j] *= D_[j];
    c_ = 1.0 / std::max(1.0, norm_inf(q_.data(), n_));
    for (int j = 0; j < n_; ++j) q_[j] *= c_;
    for (int j = 0; j < n_; ++j)
      for (int p = Q_.p[j]; p < Q_.p[j + 1]; ++p)
        Q_.x[p] *= c_ * D_[Q_.i[p]] * D_[j];
    for (int k = 0; k < m_; ++k) {
      if (bmin_[k] > -kInfty) bmin_[k] *= E_[k];
      if (bmax_[k] < kInfty) bmax_[k] *= E_[k];
    }
  }

  // CSR view of A (row-major) for per-constraint Schur contributions
  void build_row_view() {
    Ar_p_.assign(m_ + 1, 0);
    for (int j = 0; j < n_; ++j)
      for (int p = A_.p[j]; p < A_.p[j + 1]; ++p) Ar_p_[A_.i[p] + 1]++;
    for (int k = 0; k < m_; ++k) Ar_p_[k + 1] += Ar_p_[k];
    Ar_j_.resize(Ar_p_[m_]);
    Ar_x_.resize(Ar_p_[m_]);
    std::vector<int> cur(Ar_p_.begin(), Ar_p_.end() - 1);
    for (int j = 0; j < n_; ++j)
      for (int p = A_.p[j]; p < A_.p[j + 1]; ++p) {
        int k = A_.i[p];
        Ar_j_[cur[k]] = j;
        Ar_x_[cur[k]] = A_.x[p];
        cur[k]++;
      }
  }

  // Superset Schur pattern M = Q + A'A (upper CSC) under an AMD
  // permutation, plus index maps: for every Q entry and every per-row
  // (i, j) product pair of A, the destination position in M.x — so a
  // numeric refactorization is one flat scatter pass, no hashing.
  void build_schur_pattern() {
    // 1) unpermuted upper superset pattern via per-column flags
    std::vector<std::vector<int>> cols(n_);
    {
      std::vector<int> flag(n_, -1);
      for (int j = 0; j < n_; ++j) {
        for (int p = Q_.p[j]; p < Q_.p[j + 1]; ++p) {
          int i = Q_.i[p];
          if (flag[i] != j) {
            flag[i] = j;
            cols[j].push_back(i);
          }
        }
        // diagonal always present (1/gamma shift + sigma products)
        if (flag[j] != j) {
          flag[j] = j;
          cols[j].push_back(j);
        }
      }
      for (int k = 0; k < m_; ++k)
        for (int p1 = Ar_p_[k]; p1 < Ar_p_[k + 1]; ++p1)
          for (int p2 = Ar_p_[k]; p2 < Ar_p_[k + 1]; ++p2) {
            int i = Ar_j_[p1], j = Ar_j_[p2];
            if (i > j) continue;
            if (flag[i] != j) {
              // re-scan guard: flag is per-(col j) only when visiting in
              // column order; A products hit arbitrary columns, so use a
              // per-column sorted-unique pass below instead
              cols[j].push_back(i);
              flag[i] = j;  // best-effort dedup; exact dedup below
            }
          }
      for (int j = 0; j < n_; ++j) {
        auto &cj = cols[j];
        std::sort(cj.begin(), cj.end());
        cj.erase(std::unique(cj.begin(), cj.end()), cj.end());
      }
    }
    // 2) AMD ordering on the superset pattern (symmetrized internally by
    //    amd_order; pass the upper pattern)
    {
      std::vector<int> Sp(n_ + 1, 0), Si;
      for (int j = 0; j < n_; ++j) Sp[j + 1] = Sp[j] + (int)cols[j].size();
      Si.reserve(Sp[n_]);
      for (int j = 0; j < n_; ++j)
        Si.insert(Si.end(), cols[j].begin(), cols[j].end());
      perm_.assign(n_, 0);
      if (amd_order(n_, Sp.data(), Si.data(), perm_.data()) != 0)
        for (int i = 0; i < n_; ++i) perm_[i] = i;  // natural fallback
      iperm_.assign(n_, 0);
      for (int i = 0; i < n_; ++i) iperm_[perm_[i]] = i;
    }
    // 3) permuted upper pattern: entry (i, j) -> (pi, pj) sorted
    {
      std::vector<std::vector<int>> pcols(n_);
      for (int j = 0; j < n_; ++j)
        for (int i : cols[j]) {
          int pi = iperm_[i], pj = iperm_[j];
          if (pi > pj) std::swap(pi, pj);
          pcols[pj].push_back(pi);
        }
      for (int j = 0; j < n_; ++j) {
        auto &cj = pcols[j];
        std::sort(cj.begin(), cj.end());
        cj.erase(std::unique(cj.begin(), cj.end()), cj.end());
      }
      M_.rows = M_.cols = n_;
      M_.p.assign(n_ + 1, 0);
      for (int j = 0; j < n_; ++j)
        M_.p[j + 1] = M_.p[j] + (int)pcols[j].size();
      M_.i.resize(M_.p[n_]);
      M_.x.assign(M_.p[n_], 0.0);
      for (int j = 0; j < n_; ++j)
        std::copy(pcols[j].begin(), pcols[j].end(), M_.i.begin() + M_.p[j]);
    }
    // 4) destination index maps (binary search once, flat arrays forever)
    auto find_pos = [&](int i, int j) {
      int pi = iperm_[i], pj = iperm_[j];
      if (pi > pj) std::swap(pi, pj);
      const int *beg = M_.i.data() + M_.p[pj];
      const int *end = M_.i.data() + M_.p[pj + 1];
      const int *it = std::lower_bound(beg, end, pi);
      return (int)(it - M_.i.data());
    };
    qmap_.resize(Q_.p[n_]);
    for (int j = 0; j < n_; ++j)
      for (int p = Q_.p[j]; p < Q_.p[j + 1]; ++p)
        qmap_[p] = find_pos(Q_.i[p], j);
    amap_p_.assign(m_ + 1, 0);
    for (int k = 0; k < m_; ++k) {
      int r = Ar_p_[k + 1] - Ar_p_[k];
      amap_p_[k + 1] = amap_p_[k] + r * (r + 1) / 2;
    }
    amap_.resize(amap_p_[m_]);
    amap_v_.resize(amap_p_[m_]);
    for (int k = 0; k < m_; ++k) {
      int c = amap_p_[k];
      for (int p1 = Ar_p_[k]; p1 < Ar_p_[k + 1]; ++p1)
        for (int p2 = p1; p2 < Ar_p_[k + 1]; ++p2) {
          amap_[c] = find_pos(Ar_j_[p1], Ar_j_[p2]);
          amap_v_[c] = Ar_x_[p1] * Ar_x_[p2];
          ++c;
        }
    }
    diag_pos_.resize(n_);
    for (int j = 0; j < n_; ++j) diag_pos_[j] = find_pos(j, j);
    ldl_ = ldl_symbolic(n_, M_.p.data(), M_.i.data());
  }

  void init_sigma() {
    // reference: iteration.c:50-84 (cold start: x = 0)
    double f = 0.0;
    double dist2 = 0.0;
    for (int k = 0; k < m_; ++k) {
      double zk = std::min(std::max(Ax_[k], bmin_[k]), bmax_[k]);
      double dk = Ax_[k] - zk;
      dist2 += dk * dk;
    }
    double s0 = s_.sigma_init * std::max(1.0, std::abs(f)) /
                std::max(1.0, 0.5 * dist2);
    s0 = std::min(std::max(s0, 1e-4), 1e4);
    std::fill(sigma_.begin(), sigma_.end(), s0);
  }

  void update_sigma(const double *pri_res) {
    // reference: iteration.c:86-145
    double pn = norm_inf(pri_res, m_);
    int changed = 0;
    for (int k = 0; k < m_; ++k) {
      if (std::abs(pri_res[k]) > s_.theta * std::abs(pri_res_in_[k]) &&
          active_[k]) {
        double mult =
            std::max(1.0, s_.delta * std::abs(pri_res[k]) / (pn + 1e-6));
        double ns = std::min(mult * sigma_[k], s_.sigma_max);
        if (ns != sigma_[k]) {
          sigma_[k] = ns;
          changed = 1;
        }
      }
    }
    if (changed) factor_valid_ = false;
  }

  void apply_gamma(double new_gamma) {
    if (new_gamma == gamma_) return;
    double diff = 1.0 / new_gamma - 1.0 / gamma_;
    for (int i = 0; i < n_; ++i) Qx_[i] += diff * x_[i];
    gamma_ = new_gamma;
    factor_valid_ = false;
  }

  void step_gamma() {
    if (gamma_ < s_.gamma_max)
      apply_gamma(std::min(gamma_ * s_.gamma_upd, s_.gamma_max));
  }

  // assemble M values from the index maps and run the numeric LDL
  bool refactor() {
    std::fill(M_.x.begin(), M_.x.end(), 0.0);
    for (int p = 0; p < Q_.p[n_]; ++p) M_.x[qmap_[p]] += Q_.x[p];
    gersh_ = 0.0;
    // Gershgorin bound of A' Sigma_act A (reference: nonconvex.c:185-210):
    // accumulate row sums of |sigma_k a_ki a_kj| during the scatter
    std::vector<double> grow(n_, 0.0);
    for (int k = 0; k < m_; ++k) {
      if (!active_[k]) continue;
      double sk = sigma_[k];
      int c = amap_p_[k];
      for (int p1 = Ar_p_[k]; p1 < Ar_p_[k + 1]; ++p1)
        for (int p2 = p1; p2 < Ar_p_[k + 1]; ++p2) {
          double v = sk * amap_v_[c];
          M_.x[amap_[c]] += v;
          grow[Ar_j_[p1]] += std::abs(v);
          if (p2 != p1) grow[Ar_j_[p2]] += std::abs(v);
          ++c;
        }
    }
    for (int i = 0; i < n_; ++i) gersh_ = std::max(gersh_, grow[i]);
    double shift = s_.proximal ? 1.0 / gamma_ : 0.0;
    // static regularization retry ladder on pivot breakdown (the
    // reference's LADEL aborts; CHOLMOD falls back supernodal->simplicial,
    // solver_interface.c:357-368 — a small diagonal bump is the
    // refactorizing analogue)
    for (double reg = 0.0; reg <= 1e-8; reg = (reg == 0.0 ? 1e-12 : reg * 100)) {
      int rc = ldl_numeric(ldl_, M_.p.data(), M_.i.data(), M_.x.data(),
                           shift + reg, n_);
      if (rc == 0) {
        factor_valid_ = true;
        return true;
      }
    }
    return false;
  }

  void ldl_solve_perm(double *b) {
    // permuted solve: bp = P b, L D L' z = bp, b = P' z
    std::vector<double> bp(n_);
    for (int i = 0; i < n_; ++i) bp[iperm_[i]] = b[i];
    ldl_solve(ldl_, bp.data());
    for (int i = 0; i < n_; ++i) b[i] = bp[iperm_[i]];
  }

  double linesearch(const double *d, const double *Qd, const double *Ad,
                    const double *df) {
    // reference: linesearch.c:14-120
    double eta = 0.0, beta = 0.0;
    for (int i = 0; i < n_; ++i) {
      eta += d[i] * Qd[i];
      beta += d[i] * df[i];
    }
    size_t nb = 0;
    double a = eta, b = beta;
    for (int k = 0; k < m_; ++k) {
      double ss = std::sqrt(sigma_[k]);
      double sad = ss * Ad[k];
      double del[2] = {-sad, sad};
      double alp[2] = {(y_[k] + sigma_[k] * (Ax_[k] - bmin_[k])) / ss,
                       (-y_[k] + sigma_[k] * (bmax_[k] - Ax_[k])) / ss};
      for (int t = 0; t < 2; ++t) {
        // a zero-delta breakpoint is constant in tau — no derivative
        // contribution; and with an infinite bound (alp = inf) the
        // 0 * inf product would poison the accumulators with NaN
        if (del[t] == 0.0) continue;
        double sv = alp[t] / del[t];
        bool l = sv > 0;
        bool p = del[t] > 0;
        if (p != l) {
          a += del[t] * del[t];
          b -= del[t] * alp[t];
        }
        if (l && std::isfinite(sv)) {
          bp_[nb].s = sv;
          bp_[nb].inc_a = p ? del[t] * del[t] : -del[t] * del[t];
          bp_[nb].inc_b = p ? -del[t] * alp[t] : del[t] * alp[t];
          ++nb;
        }
      }
    }
    std::sort(bp_.begin(), bp_.begin() + nb,
              [](const Bp &u, const Bp &v) { return u.s < v.s; });
    for (size_t i = 0; i < nb; ++i) {
      if (a * bp_[i].s + b > 0) break;
      a += bp_[i].inc_a;
      b += bp_[i].inc_b;
    }
    return -b / a;
  }

  struct Bp {
    double s, inc_a, inc_b;
  };

  int n_, m_;
  Settings s_;
  Csc Q_, A_, M_;
  std::vector<double> q_, bmin_, bmax_, D_, E_;
  double c_;
  std::vector<int> Ar_p_, Ar_j_;
  std::vector<double> Ar_x_;
  std::vector<int> perm_, iperm_, qmap_, amap_, amap_p_, diag_pos_;
  std::vector<double> amap_v_;
  void *ldl_ = nullptr;
  std::vector<double> x_, y_, x0_, x_prev_, Qx_, Ax_, sigma_, pri_res_in_;
  std::vector<double> tAd_, tQd_pure_, tmpm_cert_, tmpn_cert_;

 public:
  std::vector<double> cert_dy_, cert_dx_;

 private:
  std::vector<int> active_, active_old_;
  std::vector<Bp> bp_;
  double gamma_ = 1e7, eps_abs_in_ = 1.0, eps_rel_in_ = 1.0;
  double gersh_ = 0.0;
  bool factor_valid_ = false, gamma_maxed_ = false;
  int nb_enter_ = 0, nb_leave_ = 0;
};

}  // namespace

extern "C" {

// Solve one sparse QP.  Q, A in CSC (int32 indices); Q may be upper or
// full symmetric (lower entries are dropped).  Returns status
// (1 solved, -2 max_iter, 0 internal error).
// flags: bit 0 = framework-mode stagnation rescue (0 for the
// reference-semantics baseline); bits 1-7 = rescue window override
// (0 -> default 5 outer updates).  time_limit in seconds (0 = unlimited;
// status -5 when hit).  Returns status (1 solved, -2 max_iter,
// -5 time_limit, -3/-4 infeasibility certificates, 0 internal error).
int qpalm_sparse_baseline_solve(int n, int m, const int *Qp, const int *Qi,
                                const double *Qx, int Qnnz, const int *Ap,
                                const int *Ai, const double *Axv, int Annz,
                                const double *q, const double *bmin,
                                const double *bmax, double eps_abs,
                                double eps_rel, int max_iter, int scaling,
                                double delta, int flags, double time_limit,
                                double *x_out, double *y_out,
                                int *iter_out, double *obj_out,
                                double *dy_out, double *dx_out) {
  try {
    Settings s;
    s.eps_abs = eps_abs;
    s.eps_rel = eps_rel;
    s.max_iter = max_iter;
    s.scaling = scaling;
    s.delta = delta;
    s.rescue = flags & 1;
    int win = (flags >> 1) & 0x7f;
    if (win > 0) s.rescue_window = win;
    s.time_limit = time_limit;
    SparseQpalm solver(n, m, Qp, Qi, Qx, Qnnz, Ap, Ai, Axv, Annz, q, bmin,
                       bmax, s);
    int st = solver.solve(x_out, y_out, iter_out, obj_out);
    if (dy_out)
      std::copy(solver.cert_dy_.begin(), solver.cert_dy_.end(), dy_out);
    if (dx_out)
      std::copy(solver.cert_dx_.begin(), solver.cert_dx_.end(), dx_out);
    return st;
  } catch (...) {
    return 0;
  }
}
}
