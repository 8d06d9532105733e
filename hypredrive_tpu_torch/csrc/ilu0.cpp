// ILU(0) factorization on the host: the IKJ loop of
// hypredrive_tpu/precon/ilu.py::ilu0_factor, compiled.
//
// Same order and the same floating-point operations as the Python loop,
// so with -ffp-contract=off (no fused multiply-add) the factors are
// bit-identical:
//   for each row i, for each k < i in row i's pattern (ascending):
//     l_ik = a_ik / u_kk            (skipped when u_kk == 0)
//     a_ij -= l_ik * u_kj           for j > k in both patterns
// Row patterns are sorted; a column repeated in a row is matched at its
// first position, as np.intersect1d(..., return_indices=True) does.
//
// Built with the other host helpers by hypredrive_tpu_torch/io/native.py
// (g++ -O3 -ffp-contract=off -fPIC -shared -std=c++17).

#include <cstdint>

extern "C" {

// data (in/out): the CSR values, overwritten with L (strict lower, unit
// diagonal implied) and U (upper, diagonal included).  Returns 0, or
// 1 + the first row whose diagonal is missing from the pattern.
int64_t hdtt_ilu0_factor(int64_t n, const int64_t* indptr,
                         const int32_t* indices, double* data,
                         int64_t* diag_pos) {
    for (int64_t i = 0; i < n; ++i) {
        diag_pos[i] = -1;
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            if (indices[p] == i) {
                diag_pos[i] = p;
                break;
            }
        }
        if (diag_pos[i] < 0) return i + 1;
    }
    for (int64_t i = 0; i < n; ++i) {
        const int64_t lo = indptr[i], hi = indptr[i + 1];
        for (int64_t kk = lo; kk < hi; ++kk) {
            const int64_t k = indices[kk];
            if (k >= i) break;
            const double dk = data[diag_pos[k]];
            if (dk == 0.0) continue;
            const double lik = data[kk] / dk;
            data[kk] = lik;
            // merge row i with row k's entries right of its column k
            int64_t p = lo;
            int64_t q = indptr[k];
            const int64_t q_hi = indptr[k + 1];
            while (q < q_hi && indices[q] <= k) ++q;
            while (p < hi && q < q_hi) {
                const int32_t cp = indices[p], cq = indices[q];
                if (cp < cq) {
                    ++p;
                } else if (cq < cp) {
                    ++q;
                } else {
                    data[p] -= lik * data[q];
                    while (p < hi && indices[p] == cp) ++p;
                    while (q < q_hi && indices[q] == cq) ++q;
                }
            }
        }
    }
    return 0;
}

}  // extern "C"
