// Native sparse LDL' factorization: the framework's equivalent of the
// reference's LADEL backend (reference: src/solver_interface.c:319-405 uses
// ladel_factorize_advanced_with_diag / ladel_dense_solve for the Schur
// system M = Q + A' Sigma_act A with a 1/gamma diagonal shift).
//
// Up-looking LDL' with an elimination-tree symbolic phase:
//   symbolic: etree + per-column nonzero counts from the upper-triangular
//             pattern (one pass, O(nnz) amortized via path compression)
//   numeric:  column k solved against the already-computed columns reached
//             through the etree (sparse triangular solve per column)
// The pattern is analyzed ONCE for the superset structure (all constraints
// active); numeric refactorization per active-set/penalty change reuses it
// — the dense-refactor analogue of the reference's rank-1 update economy,
// chosen because refactorization at O(fill) beats pointer surgery on wide
// vector hosts.
//
// Exposed via a C API for ctypes (qpalm_jax/linalg/sparse_direct.py).
// Fill-reducing ordering is the caller's job (the Python wrapper uses
// reverse Cuthill-McKee and permutes the matrix before the symbolic call).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct LDL {
  int n = 0;
  // symbolic
  std::vector<int> parent;   // etree
  std::vector<int> Lp;       // column pointers of L (size n+1)
  std::vector<int> Lnz;      // column counts
  // numeric
  std::vector<int> Li;       // row indices of L
  std::vector<double> Lx;    // values of L
  std::vector<double> D;     // diagonal of D
  // workspaces
  std::vector<int> flag, pattern, lnz_cursor;
  std::vector<double> y;
};

// input pattern: upper-triangular CSC (column k holds rows i <= k)
void symbolic(LDL &S, int n, const int *Ap, const int *Ai) {
  S.n = n;
  S.parent.assign(n, -1);
  S.Lnz.assign(n, 0);
  S.flag.assign(n, -1);
  for (int k = 0; k < n; ++k) {
    S.parent[k] = -1;
    S.flag[k] = k;
    for (int p = Ap[k]; p < Ap[k + 1]; ++p) {
      int i = Ai[p];
      // walk up the etree from i to the root below k, counting one
      // nonzero per visited column (row k of L touches that column)
      while (i < k && S.flag[i] != k) {
        if (S.parent[i] == -1) S.parent[i] = k;
        S.Lnz[i]++;
        S.flag[i] = k;
        i = S.parent[i];
      }
    }
  }
  S.Lp.assign(n + 1, 0);
  for (int k = 0; k < n; ++k) S.Lp[k + 1] = S.Lp[k] + S.Lnz[k];
  S.Li.assign(S.Lp[n], 0);
  S.Lx.assign(S.Lp[n], 0.0);
  S.D.assign(n, 0.0);
  S.pattern.assign(n, 0);
  S.lnz_cursor.assign(n, 0);
  S.y.assign(n, 0.0);
}

// numeric factorization of the same pattern; `shift` adds to the FIRST
// `shift_size` diagonal entries (the reference's 1/gamma proximal shift
// with LADEL's diag_size semantics, solver_interface.c:330-343 — for the
// KKT form only the (1,1) block is shifted).
// returns 0 on success, k+1 if D[k] collapses to 0 (singular).
int numeric(LDL &S, const int *Ap, const int *Ai, const double *Ax,
            double shift, int shift_size) {
  const int n = S.n;
  std::fill(S.flag.begin(), S.flag.end(), -1);
  std::fill(S.lnz_cursor.begin(), S.lnz_cursor.end(), 0);
  for (int k = 0; k < n; ++k) {
    // scatter column k of A (rows <= k) into y, collecting the pattern of
    // row k of L via etree walks (stack reversed into topological order)
    int top = n;
    S.flag[k] = k;
    double dk = (k < shift_size) ? shift : 0.0;
    for (int p = Ap[k]; p < Ap[k + 1]; ++p) {
      int i = Ai[p];
      if (i > k) continue;
      if (i == k) {
        dk += Ax[p];
        continue;
      }
      S.y[i] += Ax[p];
      int len = 0;
      while (S.flag[i] != k) {
        S.pattern[len++] = i;
        S.flag[i] = k;
        i = S.parent[i];
      }
      while (len > 0) S.pattern[--top] = S.pattern[--len];
    }
    // up-looking solve: process columns in topological (etree) order
    for (int t = top; t < n; ++t) {
      int j = S.pattern[t];
      double yj = S.y[j];
      S.y[j] = 0.0;
      // apply existing entries of column j of L to y
      int pend = S.Lp[j] + S.lnz_cursor[j];
      for (int p = S.Lp[j]; p < pend; ++p) S.y[S.Li[p]] -= S.Lx[p] * yj;
      double lkj = yj / S.D[j];
      dk -= lkj * yj;
      // append L(k, j)
      S.Li[pend] = k;
      S.Lx[pend] = lkj;
      S.lnz_cursor[j]++;
    }
    if (dk == 0.0) return k + 1;
    S.D[k] = dk;
  }
  return 0;
}

void solve(const LDL &S, double *b) {
  const int n = S.n;
  // L z = b (unit lower-triangular, columns)
  for (int j = 0; j < n; ++j) {
    double bj = b[j];
    for (int p = S.Lp[j]; p < S.Lp[j + 1]; ++p) b[S.Li[p]] -= S.Lx[p] * bj;
  }
  for (int j = 0; j < n; ++j) b[j] /= S.D[j];
  // L' x = z
  for (int j = n - 1; j >= 0; --j) {
    double s = b[j];
    for (int p = S.Lp[j]; p < S.Lp[j + 1]; ++p) s -= S.Lx[p] * b[S.Li[p]];
    b[j] = s;
  }
}

}  // namespace

extern "C" {

void *ldl_symbolic(int n, const int *Ap, const int *Ai) {
  auto *S = new LDL();
  try {
    symbolic(*S, n, Ap, Ai);
  } catch (...) {
    delete S;
    return nullptr;
  }
  return S;
}

int ldl_numeric(void *h, const int *Ap, const int *Ai, const double *Ax,
                double shift, int shift_size) {
  try {
    return numeric(*static_cast<LDL *>(h), Ap, Ai, Ax, shift, shift_size);
  } catch (...) {
    return -1;
  }
}

void ldl_solve(void *h, double *b) { solve(*static_cast<LDL *>(h), b); }

long ldl_lnz(void *h) {
  auto *S = static_cast<LDL *>(h);
  return (long)S->Lp[S->n];
}

void ldl_free(void *h) { delete static_cast<LDL *>(h); }

}  // extern "C"
