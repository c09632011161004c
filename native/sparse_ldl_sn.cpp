// Supernodal left-looking sparse LDL' with BLAS panels — the heavy-fill
// half of the framework's LADEL equivalence class (reference:
// src/solver_interface.c:319-405).  The up-looking scalar LDL'
// (sparse_ldl.cpp) is right for banded/structured patterns where columns
// stay short; random-sparsity Gram matrices Q + A' Sigma A fill heavily,
// and there the work concentrates in dense panel-panel products that a
// scalar inner loop wastes.  This factorization groups columns with (near-)
// nested patterns into supernodes stored as dense column-major panels and
// runs the dominant update work through dgemm.
//
//   symbolic: etree + column counts (same algorithm as the scalar
//             backend), full column-pattern fill, then supernode
//             partitioning.  A run of columns with parent[k] == k+1 always
//             has pattern(k) <= {k+1} u pattern(k+1) (etree nesting), so a
//             supernode's rowset is its own columns plus the LAST column's
//             pattern; relaxed amalgamation admits columns whose pattern is
//             strictly smaller, storing explicit zeros, while the zero
//             fraction stays under a cap.
//   numeric:  left-looking by supernode with CHOLMOD-style descendant
//             lists: each factored supernode is linked to the supernode
//             containing its next un-consumed row; the update
//             C = W * D * W_J' is one dgemm per (descendant, target) pair,
//             scattered through a relative-index map.  The target panel is
//             then factored in place (right-looking dense LDL over the
//             panel, daxpy inner steps).
//   solve:    per-supernode dtrsv on the diagonal block + dgemv on the
//             below-diagonal panel, forward and transposed backward.
//
// Input: LOWER-triangular CSC (column k holds rows i >= k) — the natural
// orientation for scattering values into lower-storage panels; the
// symbolic phase builds its own upper copy for the etree pass.  No
// pivoting: the P-ALM Schur/KKT matrices this serves are quasi-definite
// (positive definite after the 1/gamma shift), like the reference's LADEL
// usage.  Exposed via a C API for ctypes (qpalm_jax/linalg/sparse_direct.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include "etree_common.h"

extern "C" {
void dgemm_(const char *, const char *, const int *, const int *,
            const int *, const double *, const double *, const int *,
            const double *, const int *, const double *, double *,
            const int *);
void dgemv_(const char *, const int *, const int *, const double *,
            const double *, const int *, const double *, const int *,
            const double *, double *, const int *);
void dtrsv_(const char *, const char *, const char *, const int *,
            const double *, const int *, double *, const int *);
void daxpy_(const int *, const double *, const double *, const int *,
            double *, const int *);
}

namespace {

struct SNLDL {
  int n = 0;
  int nsuper = 0;
  // supernode partition: columns [scol[s], scol[s+1])
  std::vector<int> scol;       // size nsuper+1
  std::vector<int> snode_of;   // column -> supernode
  // rowsets: rows[rp[s] .. rp[s+1]), ascending; first width(s) entries are
  // the supernode's own columns
  std::vector<int> rp, rows;
  // panels: values[vp[s] ..], column-major (ns x w), ld = ns
  std::vector<int64_t> vp;
  std::vector<double> values;
  std::vector<double> D;       // diagonal of D, size n
  int64_t lnz = 0;             // true L nonzeros (panel minus upper corner)
  // numeric workspaces
  std::vector<int> relmap;     // global row -> local panel row
  std::vector<int> head, next_sn, cursor;  // descendant lists
  std::vector<double> work;    // dgemm scratch (T and C blocks)
  std::vector<double> solve_tmp;  // per-supernode gather buffer (solve)
};

// full column-pattern fill: Lcol[j] lists the rows (> j) of L's column j,
// ascending (built by appending k in increasing-k order)
void column_patterns(int n, const int *Up, const int *Ui,
                     const std::vector<int> &parent,
                     const std::vector<int> &Lnz, std::vector<int> &Lp,
                     std::vector<int> &Li) {
  Lp.assign(n + 1, 0);
  for (int k = 0; k < n; ++k) Lp[k + 1] = Lp[k] + Lnz[k];
  Li.assign(Lp[n], 0);
  std::vector<int> cursor(n, 0), flag(n, -1);
  for (int k = 0; k < n; ++k) {
    flag[k] = k;
    for (int p = Up[k]; p < Up[k + 1]; ++p) {
      int i = Ui[p];
      while (i < k && flag[i] != k) {
        Li[Lp[i] + cursor[i]++] = k;
        flag[i] = k;
        i = parent[i];
      }
    }
  }
}

bool build(SNLDL &S, int n, const int *Ap, const int *Ai, int max_width,
           double relax_frac) {
  S.n = n;
  // upper copy of the lower-CSC input (counting transpose)
  std::vector<int> Up(n + 1, 0), Ui(Ap[n]);
  for (int j = 0; j < n; ++j)
    for (int p = Ap[j]; p < Ap[j + 1]; ++p) Up[Ai[p] + 1]++;
  for (int i = 0; i < n; ++i) Up[i + 1] += Up[i];
  {
    std::vector<int> cur(Up.begin(), Up.end() - 1);
    for (int j = 0; j < n; ++j)
      for (int p = Ap[j]; p < Ap[j + 1]; ++p) Ui[cur[Ai[p]]++] = j;
  }
  std::vector<int> parent, Lnz, Lp, Li;
  etree_column_counts(n, Up.data(), Ui.data(), parent, Lnz);
  column_patterns(n, Up.data(), Ui.data(), parent, Lnz, Lp, Li);

  // supernode partition: extend while the etree chains and the explicit-
  // zero fraction of the (last-column-based) rowset stays under the cap
  S.scol.clear();
  S.scol.push_back(0);
  int64_t true_nz = 0, padded_nz = 0;
  for (int k = 0; k < n; ++k) {
    true_nz += Lnz[k] + 1;
    int c0 = S.scol.back();
    bool extend = false;
    if (k + 1 < n && parent[k] == k + 1 && (k + 1 - c0) < max_width) {
      // zeros this supernode would carry if extended through k+1:
      // column j's panel height is (k+1 - j) + Lnz[k+1] + 1 vs its true
      // Lnz[j] + 1
      int w = k + 2 - c0;
      int64_t panel = 0, truth = 0;
      for (int j = c0; j <= k + 1; ++j) {
        panel += (k + 1 - j) + Lnz[k + 1] + 1;
        truth += Lnz[j] + 1;
      }
      double zfrac = double(panel - truth) / double(panel);
      extend = (zfrac <= relax_frac) || (w <= 2);
    }
    if (!extend) S.scol.push_back(k + 1);
  }
  S.nsuper = (int)S.scol.size() - 1;
  S.snode_of.assign(n, 0);
  for (int s = 0; s < S.nsuper; ++s)
    for (int j = S.scol[s]; j < S.scol[s + 1]; ++j) S.snode_of[j] = s;

  // rowsets + panel allocation
  S.rp.assign(S.nsuper + 1, 0);
  S.vp.assign(S.nsuper + 1, 0);
  for (int s = 0; s < S.nsuper; ++s) {
    int c0 = S.scol[s], c1 = S.scol[s + 1];
    int w = c1 - c0;
    int nbelow = Lnz[c1 - 1];
    int ns = w + nbelow;
    S.rp[s + 1] = S.rp[s] + ns;
    S.vp[s + 1] = S.vp[s] + (int64_t)ns * w;
    padded_nz += (int64_t)ns * w - (int64_t)w * (w - 1) / 2;
  }
  S.rows.assign(S.rp[S.nsuper], 0);
  for (int s = 0; s < S.nsuper; ++s) {
    int c0 = S.scol[s], c1 = S.scol[s + 1];
    int w = c1 - c0;
    int *r = S.rows.data() + S.rp[s];
    for (int j = 0; j < w; ++j) r[j] = c0 + j;
    const int *src = Li.data() + Lp[c1 - 1];
    std::copy(src, src + Lnz[c1 - 1], r + w);
  }
  S.values.assign(S.vp[S.nsuper], 0.0);
  S.D.assign(n, 0.0);
  S.lnz = padded_nz;
  S.relmap.assign(n, -1);
  S.head.assign(S.nsuper, -1);
  S.next_sn.assign(S.nsuper, -1);
  S.cursor.assign(S.nsuper, 0);
  int max_nb = 0;
  for (int s = 0; s < S.nsuper; ++s)
    max_nb = std::max(max_nb, (S.rp[s + 1] - S.rp[s])
                                  - (S.scol[s + 1] - S.scol[s]));
  S.solve_tmp.assign(std::max(max_nb, 1), 0.0);
  (void)true_nz;
  return true;
}

// returns 0 on success, k+1 if D[k] == 0 at column k; `shift` adds to
// the first `shift_size` diagonal entries only (LADEL diag_size)
int factorize(SNLDL &S, const int *Ap, const int *Ai, const double *Ax,
              double shift, int shift_size) {
  const int nsuper = S.nsuper;
  std::fill(S.values.begin(), S.values.end(), 0.0);
  std::fill(S.head.begin(), S.head.end(), -1);
  const int ione = 1;
  for (int s = 0; s < nsuper; ++s) {
    const int c0 = S.scol[s], c1 = S.scol[s + 1];
    const int w = c1 - c0;
    const int ns = S.rp[s + 1] - S.rp[s];
    const int *rs = S.rows.data() + S.rp[s];
    double *F = S.values.data() + S.vp[s];
    // relative map for this target
    for (int i = 0; i < ns; ++i) S.relmap[rs[i]] = i;
    // scatter A(+shift) columns c0..c1-1 (lower CSC: rows >= col)
    for (int j = c0; j < c1; ++j) {
      double *Fj = F + (int64_t)(j - c0) * ns;
      for (int p = Ap[j]; p < Ap[j + 1]; ++p) {
        int i = Ai[p];
        if (i < j) continue;
        Fj[S.relmap[i]] += Ax[p];
      }
      if (j < shift_size) Fj[j - c0] += shift;
    }
    // descendant updates
    int d = S.head[s];
    while (d != -1) {
      int dnext = S.next_sn[d];
      const int wd = S.scol[d + 1] - S.scol[d];
      const int nd = S.rp[d + 1] - S.rp[d];
      const int *rd = S.rows.data() + S.rp[d];
      const double *Fd = S.values.data() + S.vp[d];
      int pd = S.cursor[d];
      int nj = 0;
      while (pd + nj < nd && rd[pd + nj] < c1) nj++;
      const int nr = nd - pd;
      // T = W_J * diag(D_d)   (nj x wd), W = Fd[pd:, :] (nr x wd)
      if ((int64_t)(nj * wd + (int64_t)nr * nj) > (int64_t)S.work.size())
        S.work.resize(nj * wd + (int64_t)nr * nj);
      double *T = S.work.data();
      double *Cb = T + nj * wd;
      const double *Dd = S.D.data() + S.scol[d];
      for (int c = 0; c < wd; ++c) {
        const double dv = Dd[c];
        const double *src = Fd + (int64_t)c * nd + pd;
        double *dst = T + (int64_t)c * nj;
        for (int r = 0; r < nj; ++r) dst[r] = src[r] * dv;
      }
      // C (nr x nj) = W (nr x wd) * T' (wd x nj)
      const double one = 1.0, zero = 0.0;
      dgemm_("N", "T", &nr, &nj, &wd, &one, Fd + pd, &nd, T, &nj, &zero,
             Cb, &nr);
      // scatter-subtract into the target panel (rows ascending, so the
      // lower-triangular part of C starts at row jj of column jj)
      for (int jj = 0; jj < nj; ++jj) {
        double *Fc = F + (int64_t)(rd[pd + jj] - c0) * ns;
        const double *Cc = Cb + (int64_t)jj * nr;
        for (int ii = jj; ii < nr; ++ii)
          Fc[S.relmap[rd[pd + ii]]] -= Cc[ii];
      }
      // advance d past the consumed rows, relink to its next target
      S.cursor[d] = pd + nj;
      if (pd + nj < nd) {
        int t = S.snode_of[rd[pd + nj]];
        S.next_sn[d] = S.head[t];
        S.head[t] = d;
      }
      d = dnext;
    }
    // dense right-looking LDL on the panel (L overwrites F; D extracted)
    for (int j = 0; j < w; ++j) {
      double *Fj = F + (int64_t)j * ns;
      const double dj = Fj[j];
      if (dj == 0.0) return c0 + j + 1;
      S.D[c0 + j] = dj;
      for (int t = j + 1; t < w; ++t) {
        const double ltj = Fj[t] / dj;
        const int len = ns - t;
        const double alpha = -ltj;
        // F(t:, t) -= F(t:, j) * (F(t,j)/dj)
        daxpy_(&len, &alpha, Fj + t, &ione, F + (int64_t)t * ns + t,
               &ione);
      }
      // scale column j below the diagonal into L entries
      const double inv = 1.0 / dj;
      for (int i = j + 1; i < ns; ++i) Fj[i] *= inv;
    }
    // link this supernode to the first supernode its below-rows update
    S.cursor[s] = w;
    if (w < ns) {
      int t = S.snode_of[rs[w]];
      S.next_sn[s] = S.head[t];
      S.head[t] = s;
    }
    for (int i = 0; i < ns; ++i) S.relmap[rs[i]] = -1;
  }
  return 0;
}

void solve(SNLDL &S, double *b) {
  const int ione = 1;
  const double one = 1.0, mone = -1.0;
  std::vector<double> &tmp = S.solve_tmp;
  // forward: L z = b
  for (int s = 0; s < S.nsuper; ++s) {
    const int c0 = S.scol[s], w = S.scol[s + 1] - c0;
    const int ns = S.rp[s + 1] - S.rp[s];
    const int nb = ns - w;
    const double *F = S.values.data() + S.vp[s];
    dtrsv_("L", "N", "U", &w, F, &ns, b + c0, &ione);
    if (nb > 0) {
      if ((int)tmp.size() < nb) tmp.resize(nb);
      const double zero = 0.0;
      // tmp = L21 * z
      dgemv_("N", &nb, &w, &one, F + w, &ns, b + c0, &ione, &zero,
             tmp.data(), &ione);
      const int *rs = S.rows.data() + S.rp[s];
      for (int i = 0; i < nb; ++i) b[rs[w + i]] -= tmp[i];
    }
  }
  for (int j = 0; j < S.n; ++j) b[j] /= S.D[j];
  // backward: L' x = z
  for (int s = S.nsuper - 1; s >= 0; --s) {
    const int c0 = S.scol[s], w = S.scol[s + 1] - c0;
    const int ns = S.rp[s + 1] - S.rp[s];
    const int nb = ns - w;
    const double *F = S.values.data() + S.vp[s];
    if (nb > 0) {
      if ((int)tmp.size() < nb) tmp.resize(nb);
      const int *rs = S.rows.data() + S.rp[s];
      for (int i = 0; i < nb; ++i) tmp[i] = b[rs[w + i]];
      // z -= L21' * x_below
      dgemv_("T", &nb, &w, &mone, F + w, &ns, tmp.data(), &ione, &one,
             b + c0, &ione);
    }
    dtrsv_("L", "T", "U", &w, F, &ns, b + c0, &ione);
  }
}

}  // namespace

extern "C" {

void *sldl_symbolic(int n, const int *Ap, const int *Ai, int max_width,
                    double relax_frac) {
  auto *S = new SNLDL();
  try {
    if (!build(*S, n, Ap, Ai, max_width > 0 ? max_width : 48,
               relax_frac >= 0 ? relax_frac : 0.2)) {
      delete S;
      return nullptr;
    }
  } catch (...) {
    delete S;
    return nullptr;
  }
  return S;
}

int sldl_numeric(void *h, const int *Ap, const int *Ai, const double *Ax,
                 double shift, int shift_size) {
  try {
    return factorize(*static_cast<SNLDL *>(h), Ap, Ai, Ax, shift,
                     shift_size);
  } catch (...) {
    return -1;
  }
}

void sldl_solve(void *h, double *b) { solve(*static_cast<SNLDL *>(h), b); }

long sldl_lnz(void *h) { return (long)static_cast<SNLDL *>(h)->lnz; }

int sldl_nsuper(void *h) { return static_cast<SNLDL *>(h)->nsuper; }

void sldl_free(void *h) { delete static_cast<SNLDL *>(h); }

}  // extern "C"
