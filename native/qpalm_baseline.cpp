// Native single-threaded C++/LAPACK baseline solver for bench.py.
//
// A dense, double-precision proximal-ALM + semismooth-Newton QP solver with
// the same algorithmic semantics as the reference C solver (reference:
// src/qpalm.c:401-736, src/iteration.c, src/newton.c, src/linesearch.c,
// src/termination.c) and as qpalm_jax/solver/core.py — but implemented the
// way a tuned dense C solver would be: BLAS-2/3 kernels (dgemv/dsyrk) for
// the matvecs and Schur assembly, LAPACK dpotrf/dpotrs for the Newton
// systems, std::sort for the linesearch breakpoints, factor caching across
// iterations with unchanged active set.
//
// Purpose: an honest C-comparable baseline for the batched device
// benchmark (bench.py) — the environment has no C-QPALM build (LADEL/SuiteSparse
// submodules are empty upstream), so this dense LAPACK solver is the proxy:
// single thread, double precision, same iteration semantics, same stopping
// protocol.  It is deliberately *favourable* to the baseline: dense BLAS on
// an n=64 problem is faster than sparse LDL with rank-1 surgery would be.
//
// NOT a copy of the reference: the reference is a sparse LDL^T solver with
// per-constraint rank-1 factor updates and a mutable workspace of ~60
// vectors; this is a dense refactorizing solver in ~500 lines of C++.

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

extern "C" {
// BLAS / LAPACK (Fortran symbols from libblas/liblapack)
void dgemv_(const char *trans, const int *m, const int *n, const double *alpha,
            const double *a, const int *lda, const double *x, const int *incx,
            const double *beta, double *y, const int *incy);
void dsymv_(const char *uplo, const int *n, const double *alpha,
            const double *a, const int *lda, const double *x, const int *incx,
            const double *beta, double *y, const int *incy);
void dsyrk_(const char *uplo, const char *trans, const int *n, const int *k,
            const double *alpha, const double *a, const int *lda,
            const double *beta, double *c, const int *ldc);
void dpotrf_(const char *uplo, const int *n, double *a, const int *lda,
             int *info);
void dpotrs_(const char *uplo, const int *n, const int *nrhs, const double *a,
             const int *lda, double *b, const int *ldb, int *info);
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
  int max_iter = 10000;
  int inner_max_iter = 100;
  int scaling = 10;
};

inline double norm_inf(const double *v, int k) {
  double r = 0.0;
  for (int i = 0; i < k; ++i) r = std::max(r, std::abs(v[i]));
  return r;
}

inline double dot(const double *a, const double *b, int k) {
  double r = 0.0;
  for (int i = 0; i < k; ++i) r += a[i] * b[i];
  return r;
}

// The solver.  Data layout convention: Q is n*n (symmetric, layout-agnostic);
// A is the numpy C-order (m, n) buffer, which in Fortran view is the n x m
// matrix A^T — so A@x is dgemv('T') and A^T@w is dgemv('N') on that buffer.
class DenseQpalm {
 public:
  DenseQpalm(int n, int m, const double *Q, const double *A, const double *q,
             const double *bmin, const double *bmax, const Settings &s)
      : n_(n), m_(m), s_(s), Q_(Q, Q + (size_t)n * n),
        A_(A, A + (size_t)n * m), q_(q, q + n), bmin_(bmin, bmin + m),
        bmax_(bmax, bmax + m), D_(n, 1.0), E_(m, 1.0), c_(1.0) {
    if (s_.scaling > 0) ruiz_scale();
    x_.assign(n, 0.0);
    y_.assign(m, 0.0);
    x0_ = x_;
    Qx_.assign(n, 0.0);
    Ax_.assign(m, 0.0);
    Aty_.assign(n, 0.0);
    active_.assign(m, 0);
    active_old_.assign(m, 0);
    sigma_.assign(m, 0.0);
    M_.resize((size_t)n * n);
    tmpn_.resize(n);
    tmpm_.resize(m);
    bp_.resize(2 * (size_t)m);
  }

  // returns status (1 solved, -2 max_iter)
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
    std::vector<double> Axys(m_), z(m_), pri_res(m_), yh(m_), Atyh(n_),
        df(n_), dphi(n_), d(n_), Qd(n_), Ad(m_);
    for (iter = 0; iter < s_.max_iter; ++iter) {
      // ---- residuals (reference: iteration.c:24-48) ----
      for (int k = 0; k < m_; ++k) {
        Axys[k] = Ax_[k] + y_[k] / sigma_[k];
        z[k] = std::min(std::max(Axys[k], bmin_[k]), bmax_[k]);
        pri_res[k] = Ax_[k] - z[k];
        yh[k] = y_[k] + sigma_[k] * pri_res[k];
      }
      mat_tvec(yh.data(), Atyh.data());  // A^T yh
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
        y_ = yh;  // store yh as the final multiplier (termination.c:242-252)
        break;
      }
      bool subproblem_done = dua2_norm <= eps_dua_in;
      bool outer_trigger = subproblem_done || no_change == 3;
      bool exhausted = (iter == prev_iter + s_.inner_max_iter);
      if (outer_trigger) {
        // ---- outer update (reference: qpalm.c:515-644) ----
        no_change = 0;
        if (iter_out_count > 0 && pri_norm > eps_pri)
          update_sigma(pri_res.data());
        y_ = yh;
        Aty_ = Atyh;
        eps_abs_in_ = std::max(s_.eps_abs, s_.rho * eps_abs_in_);
        eps_rel_in_ = std::max(s_.eps_rel, s_.rho * eps_rel_in_);
        if (s_.proximal) {
          // gamma boost when the active set has settled
          // (reference: qpalm.c:612-630, iteration.c:158-205)
          bool check = !gamma_maxed_ && iter_out_count > 0 && nb_enter_ == 0 &&
                       nb_leave_ == 0 && pri_norm < eps_pri;
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
            active_old_ = active_;
            nb_enter_ = nb_e2;
            nb_leave_ = nb_l2;
            if (nb_e2 == 0 && nb_l2 == 0) {
              double boosted = nb_act > 0
                                   ? std::max(s_.gamma_max,
                                              1e14 / std::max(gersh_, 1e-30))
                                   : 1e12;
              apply_gamma(boosted, d.data(), Qd.data());
              if (nb_act > 0) gamma_maxed_ = true;
            } else {
              step_gamma(d.data(), Qd.data());
            }
          } else {
            step_gamma(d.data(), Qd.data());
          }
          x0_ = x_;
        }
        pri_res_in_ = pri_res;
        ++iter_out_count;
        prev_iter = iter;
      } else if (exhausted) {
        // ---- inner_max_iter hit (reference: qpalm.c:647-660) ----
        no_change = 0;
        if (iter_out_count > 0 && pri_norm > eps_pri)
          update_sigma(pri_res.data());
        if (s_.proximal) {
          step_gamma(d.data(), Qd.data());
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
        if (changed || !factor_valid_) refactor();
        // d = -M^{-1} dphi
        for (int i = 0; i < n_; ++i) d[i] = -dphi[i];
        chol_solve(d.data());
        // exact linesearch (reference: linesearch.c:14-120)
        symv(Qd.data(), d.data());
        if (s_.proximal)
          for (int i = 0; i < n_; ++i) Qd[i] += d[i] / gamma_;
        mat_vec(d.data(), Ad.data());
        double tau = linesearch(d.data(), Qd.data(), Ad.data(), df.data());
        for (int i = 0; i < n_; ++i) {
          x_[i] += tau * d[i];
          Qx_[i] += tau * Qd[i];
        }
        for (int k = 0; k < m_; ++k) Ax_[k] += tau * Ad[k];
      }
    }
    // unscale solution (reference: termination.c:242-252)
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
  // y = A x  (A buffer is Fortran-view A^T: use trans)
  void mat_vec(const double *x, double *y) {
    const double one = 1.0, zero = 0.0;
    const int inc = 1;
    dgemv_("T", &n_, &m_, &one, A_.data(), &n_, x, &inc, &zero, y, &inc);
  }
  // y = A^T w
  void mat_tvec(const double *w, double *y) {
    const double one = 1.0, zero = 0.0;
    const int inc = 1;
    dgemv_("N", &n_, &m_, &one, A_.data(), &n_, w, &inc, &zero, y, &inc);
  }
  // y = Q x
  void symv(double *y, const double *x) {
    const double one = 1.0, zero = 0.0;
    const int inc = 1;
    dsymv_("U", &n_, &one, Q_.data(), &n_, x, &inc, &zero, y, &inc);
  }

  void ruiz_scale() {
    // reference: scaling.c:34-113
    std::vector<double> Dt(n_), Et(m_);
    for (int it = 0; it < s_.scaling; ++it) {
      std::fill(Dt.begin(), Dt.end(), 0.0);
      std::fill(Et.begin(), Et.end(), 0.0);
      for (int k = 0; k < m_; ++k)
        for (int i = 0; i < n_; ++i) {
          double a = std::abs(A_[(size_t)k * n_ + i]);
          Dt[i] = std::max(Dt[i], a);
          Et[k] = std::max(Et[k], a);
        }
      for (int i = 0; i < n_; ++i)
        Dt[i] = 1.0 / std::sqrt(Dt[i] < 1e-12 ? 1.0 : Dt[i]);
      for (int k = 0; k < m_; ++k)
        Et[k] = 1.0 / std::sqrt(Et[k] < 1e-12 ? 1.0 : Et[k]);
      for (int k = 0; k < m_; ++k)
        for (int i = 0; i < n_; ++i) A_[(size_t)k * n_ + i] *= Et[k] * Dt[i];
      for (int i = 0; i < n_; ++i) D_[i] *= Dt[i];
      for (int k = 0; k < m_; ++k) E_[k] *= Et[k];
    }
    for (int i = 0; i < n_; ++i) q_[i] *= D_[i];
    c_ = 1.0 / std::max(1.0, norm_inf(q_.data(), n_));
    for (int i = 0; i < n_; ++i) q_[i] *= c_;
    for (int i = 0; i < n_; ++i)
      for (int j = 0; j < n_; ++j)
        Q_[(size_t)i * n_ + j] *= c_ * D_[i] * D_[j];
    for (int k = 0; k < m_; ++k) {
      if (bmin_[k] > -kInfty) bmin_[k] *= E_[k];
      if (bmax_[k] < kInfty) bmax_[k] *= E_[k];
    }
  }

  void init_sigma() {
    // reference: iteration.c:50-84 (cold start: x = 0, f = 0, dist = -mid)
    double f = 0.5 * dot(x_.data(), Qx_.data(), n_) + dot(q_.data(), x_.data(), n_);
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

  void apply_gamma(double new_gamma, double *d, double *Qd) {
    if (new_gamma == gamma_) return;
    double diff = 1.0 / new_gamma - 1.0 / gamma_;
    for (int i = 0; i < n_; ++i) {
      Qx_[i] += diff * x_[i];
      Qd[i] += tau_ * diff * d[i];
    }
    gamma_ = new_gamma;
    factor_valid_ = false;
  }

  void step_gamma(double *d, double *Qd) {
    if (gamma_ < s_.gamma_max)
      apply_gamma(std::min(gamma_ * s_.gamma_upd, s_.gamma_max), d, Qd);
  }

  void refactor() {
    // M = Q + A^T diag(sigma * active) A + (1/gamma) I, then dpotrf.
    // Assembly via dsyrk on the sqrt(sigma)-scaled active rows (BLAS-3).
    B_.assign((size_t)n_ * m_, 0.0);
    for (int k = 0; k < m_; ++k) {
      if (!active_[k]) continue;
      double w = std::sqrt(sigma_[k]);
      const double *row = &A_[(size_t)k * n_];
      double *brow = &B_[(size_t)k * n_];
      for (int i = 0; i < n_; ++i) brow[i] = w * row[i];
    }
    std::memcpy(M_.data(), Q_.data(), sizeof(double) * n_ * n_);
    const double one = 1.0;
    // Fortran view of B_ is the n x m matrix B^T; dsyrk N computes B^T B.
    dsyrk_("U", "N", &n_, &m_, &one, B_.data(), &n_, &one, M_.data(), &n_);
    // Gershgorin upper bound of A^T S A for the gamma boost
    // (reference: nonconvex.c:185-210); computed from B^T B = M - Q.
    // dsyrk only updated the Fortran-upper triangle: entry (r, c) with
    // c >= r lives at M_[c*n + r]; Q_ is full-symmetric so the same index
    // addresses the matching Q entry.
    gersh_ = 0.0;
    for (int i = 0; i < n_; ++i) {
      double row = 0.0;
      for (int j = 0; j < n_; ++j) {
        size_t idx = (size_t)std::max(i, j) * n_ + std::min(i, j);
        double ats = M_[idx] - Q_[idx];
        row += (j == i) ? ats : std::abs(ats);
      }
      gersh_ = std::max(gersh_, row);
    }
    if (s_.proximal) {
      double gi = 1.0 / gamma_;
      for (int i = 0; i < n_; ++i) M_[(size_t)i * n_ + i] += gi;
    }
    int info = 0;
    dpotrf_("U", &n_, M_.data(), &n_, &info);
    factor_valid_ = (info == 0);
  }

  void chol_solve(double *b) {
    const int one = 1;
    int info = 0;
    dpotrs_("U", &n_, &one, M_.data(), &n_, b, &n_, &info);
  }

  double linesearch(const double *d, const double *Qd, const double *Ad,
                    const double *df) {
    // reference: linesearch.c:14-120 (same math as solver/linesearch.py,
    // but with the data-dependent filter + qsort a C solver would use)
    double eta = dot(d, Qd, n_);
    double beta = dot(d, df, n_);
    size_t nb = 0;
    double a = eta, b = beta;
    for (int k = 0; k < m_; ++k) {
      double ss = std::sqrt(sigma_[k]);
      double sad = ss * Ad[k];
      // lower bound breakpoint: delta = -sad, alpha = (y + sigma(Ax-bmin))/ss
      // upper bound breakpoint: delta = +sad, alpha = (-y + sigma(bmax-Ax))/ss
      double del[2] = {-sad, sad};
      double alp[2] = {(y_[k] + sigma_[k] * (Ax_[k] - bmin_[k])) / ss,
                       (-y_[k] + sigma_[k] * (bmax_[k] - Ax_[k])) / ss};
      for (int t = 0; t < 2; ++t) {
        // zero-delta breakpoints are constant in tau (no derivative
        // contribution) and 0 * inf against an infinite bound is NaN
        if (del[t] == 0.0) continue;
        double sv = alp[t] / del[t];
        bool l = sv > 0;           // IEEE: nan -> false, +-inf kept
        bool p = del[t] > 0;
        if (p != l) {              // xor: contributes to the tau=0 derivative
          a += del[t] * del[t];
          b -= del[t] * alp[t];
        }
        if (l) {
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
    tau_ = -b / a;
    return tau_;
  }

  struct Bp {
    double s, inc_a, inc_b;
  };

  int n_, m_;
  Settings s_;
  std::vector<double> Q_, A_, q_, bmin_, bmax_;
  std::vector<double> D_, E_;
  double c_;
  std::vector<double> x_, y_, x0_, Qx_, Ax_, Aty_, sigma_, pri_res_in_;
  std::vector<int> active_, active_old_;
  std::vector<double> M_, B_, tmpn_, tmpm_;
  std::vector<Bp> bp_;
  double gamma_ = 1e7, eps_abs_in_ = 1.0, eps_rel_in_ = 1.0;
  double gersh_ = 0.0, tau_ = 0.0;
  bool factor_valid_ = false, gamma_maxed_ = false;
  int nb_enter_ = 0, nb_leave_ = 0;
};

}  // namespace

extern "C" {

// Solve one dense QP.  Q: n*n (symmetric), A: m*n C-order, all double.
// Returns status (1 solved, -2 max_iter, 0 internal error).
int qpalm_baseline_solve(int n, int m, const double *Q, const double *A,
                         const double *q, const double *bmin,
                         const double *bmax, double eps_abs, double eps_rel,
                         int max_iter, int scaling, double delta,
                         double *x_out, double *y_out, int *iter_out,
                         double *obj_out) {
  try {
    Settings s;
    s.eps_abs = eps_abs;
    s.eps_rel = eps_rel;
    s.max_iter = max_iter;
    s.scaling = scaling;
    s.delta = delta;
    DenseQpalm solver(n, m, Q, A, q, bmin, bmax, s);
    return solver.solve(x_out, y_out, iter_out, obj_out);
  } catch (...) {
    return 0;
  }
}
}
