// Batched symmetric-indefinite KKT solves for the f64 polish — the hot
// host-side operation of the certified-accuracy pipeline (qpalm_jax/
// polish.py).  numpy's batched np.linalg.solve runs LU (dgetrf, 2/3 nk^3
// FLOPs); the polish KKT matrix is symmetric (quasi-definite), so
// Bunch-Kaufman dsytrf (1/3 nk^3) + dsytrs does the same job with half
// the FLOPs and keeps the factors for iterative-refinement re-solves.
//
// Layout notes: the caller passes C-order (row-major) K of shape
// (B, nk, nk); reinterpreted column-major this is K^T, which equals K by
// symmetry, so the buffers are handed to LAPACK as-is with uplo='L'.
// Factors overwrite K in place; ipiv (B, nk) must be kept for re-solves.

#include <cstddef>
#include <vector>

extern "C" {
void dsytrf_(const char *, const int *, double *, const int *, int *,
             double *, const int *, int *);
void dsytrs_(const char *, const int *, const int *, const double *,
             const int *, const int *, double *, const int *, int *);
void ssytrf_(const char *, const int *, float *, const int *, int *,
             float *, const int *, int *);
void ssytrs_(const char *, const int *, const int *, const float *,
             const int *, const int *, float *, const int *, int *);
}

// Factor every lane of K (B, nk, nk) in place and solve K x = rhs
// (B, nk, in/out).  fail[b] is set to 1 when lane b's factorization
// breaks down (caller falls back for that lane).  Returns the number of
// failed lanes, or -1 on an unexpected error.
extern "C" int bkkt_factor_solve(int B, int nk, double *K, int *ipiv,
                                 double *rhs, int *fail) {
  try {
    const int one = 1;
    int lwork = nk * 64;
    std::vector<double> work(lwork);
    int nfail = 0;
    for (int b = 0; b < B; ++b) {
      double *Kb = K + (size_t)b * nk * nk;
      int *pv = ipiv + (size_t)b * nk;
      double *rb = rhs + (size_t)b * nk;
      int info = 0;
      dsytrf_("L", &nk, Kb, &nk, pv, work.data(), &lwork, &info);
      if (info != 0) {
        fail[b] = 1;
        nfail++;
        continue;
      }
      fail[b] = 0;
      dsytrs_("L", &nk, &one, Kb, &nk, pv, rb, &nk, &info);
      if (info != 0) {
        fail[b] = 1;
        nfail++;
      }
    }
    return nfail;
  } catch (...) {
    return -1;
  }
}

// Mixed-precision variant (bench polish hot path): cast each lane's f64
// K to f32, factor with ssytrf (half the FLOPs and half the memory
// traffic of the f64 factor), solve the f64 rhs through the f32 factor.
// The caller recovers f64 accuracy with refinement steps against the
// f64 STRUCTURE (Q/A matvecs) re-solved via bkkt_resolve_f32 — classic
// mixed-precision iterative refinement (the reference's own KKT path
// refines, newton.c:57-90; here the factor precision is the knob).
// Kf (B, nk, nk) float32 is caller-allocated workspace that must be kept
// (with ipiv) for the re-solves.
extern "C" int bkkt_factor_solve_f32(int B, int nk, const double *K,
                                     float *Kf, int *ipiv, double *rhs,
                                     int *fail) {
  try {
    const int one = 1;
    int lwork = nk * 64;
    std::vector<float> work(lwork);
    std::vector<float> rf(nk);
    int nfail = 0;
    for (int b = 0; b < B; ++b) {
      const double *Kb = K + (size_t)b * nk * nk;
      float *Fb = Kf + (size_t)b * nk * nk;
      for (size_t i = 0; i < (size_t)nk * nk; ++i) Fb[i] = (float)Kb[i];
      int *pv = ipiv + (size_t)b * nk;
      double *rb = rhs + (size_t)b * nk;
      int info = 0;
      ssytrf_("L", &nk, Fb, &nk, pv, work.data(), &lwork, &info);
      if (info != 0) {
        fail[b] = 1;
        nfail++;
        continue;
      }
      fail[b] = 0;
      for (int i = 0; i < nk; ++i) rf[i] = (float)rb[i];
      ssytrs_("L", &nk, &one, Fb, &nk, pv, rf.data(), &nk, &info);
      if (info != 0) {
        fail[b] = 1;
        nfail++;
        continue;
      }
      for (int i = 0; i < nk; ++i) rb[i] = (double)rf[i];
    }
    return nfail;
  } catch (...) {
    return -1;
  }
}

extern "C" int bkkt_resolve_f32(int B, int nk, const float *Kf,
                                const int *ipiv, double *rhs,
                                const int *fail) {
  try {
    const int one = 1;
    std::vector<float> rf(nk);
    for (int b = 0; b < B; ++b) {
      if (fail[b]) continue;
      double *rb = rhs + (size_t)b * nk;
      for (int i = 0; i < nk; ++i) rf[i] = (float)rb[i];
      int info = 0;
      ssytrs_("L", &nk, &one, Kf + (size_t)b * nk * nk, &nk,
               ipiv + (size_t)b * nk, rf.data(), &nk, &info);
      if (info != 0) return -1;
      for (int i = 0; i < nk; ++i) rb[i] = (double)rf[i];
    }
    return 0;
  } catch (...) {
    return -1;
  }
}

// Re-solve with the factors left by bkkt_factor_solve (refinement steps).
// Lanes flagged failed are skipped.
extern "C" int bkkt_resolve(int B, int nk, const double *K,
                            const int *ipiv, double *rhs,
                            const int *fail) {
  try {
    const int one = 1;
    for (int b = 0; b < B; ++b) {
      if (fail[b]) continue;
      int info = 0;
      dsytrs_("L", &nk, &one, K + (size_t)b * nk * nk, &nk,
               ipiv + (size_t)b * nk, rhs + (size_t)b * nk, &nk, &info);
      if (info != 0) return -1;
    }
    return 0;
  } catch (...) {
    return -1;
  }
}
