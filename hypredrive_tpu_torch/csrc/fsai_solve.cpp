// FSAI's batched row solves on the host: for every row i, A_i y_i = b_i
// with A_i a small dense (k, k) matrix, computed as the JAX package's
// jax.vmap(jnp.linalg.solve) computes it on the CPU:
//   dgetrf on A_i (column-major, as LAPACK stores it);
//   the row swaps of its pivots applied to b_i in order;
//   dtrsm, left, lower, no transpose, unit diagonal;
//   dtrsm, left, upper, no transpose, non-unit diagonal;
// with b_i as a (k, 1) column.  The LAPACK and BLAS routines are SciPy's
// own (scipy.linalg.cython_lapack / cython_blas export them as
// PyCapsules); the caller passes their addresses in, so this file links
// against no BLAS.  The same routines on the same inputs give the same
// bits as the plain loop in hypredrive_tpu_torch/precon/fsai.py.
//
// Built with the other host helpers by hypredrive_tpu_torch/io/native.py
// (g++ -O3 -ffp-contract=off -fPIC -shared -std=c++17).

#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

typedef void (*hdtt_dgetrf_t)(int*, int*, double*, int*, int*, int*);
typedef void (*hdtt_dtrsm_t)(char*, char*, char*, char*, int*, int*,
                             double*, double*, int*, double*, int*);

// sub: (n, k, k) row-major; rhs: (n, k); y: (n, k), written.  A row
// whose factor is exactly singular gets what the triangular solves give,
// as in the JAX package (dgetrf's info is not checked there either).
void hdtt_fsai_solve(int64_t n, int32_t k, const double* sub,
                        const double* rhs, double* y, void* getrf_ptr,
                        void* trsm_ptr) {
    hdtt_dgetrf_t getrf = reinterpret_cast<hdtt_dgetrf_t>(getrf_ptr);
    hdtt_dtrsm_t trsm = reinterpret_cast<hdtt_dtrsm_t>(trsm_ptr);
    std::vector<double> a(static_cast<size_t>(k) * k);
    std::vector<int> piv(k > 0 ? k : 1);
    int m = k, one = 1, lda = k, info = 0;
    double alpha = 1.0;
    char left = 'L', lower = 'L', upper = 'U', notrans = 'N', unit = 'U',
         nonunit = 'N';
    for (int64_t i = 0; i < n; ++i) {
        const double* s = sub + i * k * k;
        double* x = y + i * k;
        for (int r = 0; r < k; ++r) {
            for (int c = 0; c < k; ++c) a[c * k + r] = s[r * k + c];
            x[r] = rhs[i * k + r];
        }
        getrf(&m, &m, a.data(), &lda, piv.data(), &info);
        for (int r = 0; r < k; ++r) {
            const int p = piv[r] - 1;
            if (p != r) {
                const double t = x[r];
                x[r] = x[p];
                x[p] = t;
            }
        }
        trsm(&left, &lower, &notrans, &unit, &m, &one, &alpha, a.data(),
             &lda, x, &lda);
        trsm(&left, &upper, &notrans, &nonunit, &m, &one, &alpha, a.data(),
             &lda, x, &lda);
    }
}

}  // extern "C"
