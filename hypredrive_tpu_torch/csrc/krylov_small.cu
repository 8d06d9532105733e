// The small dense steps of restarted GMRES and FGMRES on the device, for
// Hopper (sm_90a).
//
// These are not ports of TPU kernels.  The JAX package leaves them to XLA
// inside its jitted while_loop (hypredrive_tpu/solvers/gmres.py: the
// rot_step fori_loop and the back_sub fori_loop; fgmres.py the same):
//
//   givens_update        write the Arnoldi column into H[:, j], apply the
//                        j earlier rotations to it, form rotation j, rotate
//                        g, then write |g[j+1]| (the residual estimate),
//                        its history entry and the inner done flag
//   hessenberg_backsolve y solving the leading jcount x jcount upper-
//                        triangular system H y = g, zero where H[k, k] == 0
//                        and past jcount
//
// Without them a Givens step is dozens of 0-d launches inside each
// captured graph.  Both are sequential recurrences over at most krylov_dim
// entries: one thread does the arithmetic, in the order of the plain torch
// versions in ops/krylov_small.py, and the file is built with -fmad=false
// so that no product is fused into an add.  The results are then bit for
// bit the plain versions' in float32 and float64.
//
// Bound: latency.  The work is O(j) (rotations) and O(j^2) (back-
// substitution) flops on a few kilobytes; one launch costs more.
//
// Both take a device flag `active`: when it is false they write nothing
// (givens_update) or zeros (hessenberg_backsolve), so that a masked
// iteration of the device loop changes no state.
//
// Plain C interface, bound from Python with ctypes (ops/krylov_small.py);
// hdtt_graph_nodes counts the nodes of a captured CUDA graph.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename T>
__device__ __forceinline__ T abs_of(T v) { return v < T(0) ? -v : v; }

template <typename T>
__global__ void givens_update_kernel(T* __restrict__ H, T* __restrict__ cs,
                                     T* __restrict__ sn, T* __restrict__ g,
                                     const T* __restrict__ col, int j, int m,
                                     const bool* __restrict__ active,
                                     T* __restrict__ norm,
                                     const T* __restrict__ thr,
                                     bool* __restrict__ done,
                                     T* __restrict__ hist,
                                     const int64_t* __restrict__ hist_base,
                                     int64_t hist_len) {
  if (threadIdx.x != 0 || !*active) return;
  // H is (m + 1, m), row-major: H[i, j] = H[i * m + j]
  for (int i = 0; i <= j + 1; ++i) H[i * m + j] = col[i];
  for (int i = 0; i < j; ++i) {
    const T hi = H[i * m + j];
    const T hn = H[(i + 1) * m + j];
    const T t = cs[i] * hi + sn[i] * hn;
    H[(i + 1) * m + j] = -sn[i] * hi + cs[i] * hn;
    H[i * m + j] = t;
  }
  const T hjj = H[j * m + j];
  const T hnj = H[(j + 1) * m + j];
  const T d = sqrt(hjj * hjj + hnj * hnj);
  const T c = d > T(0) ? hjj / d : T(1);
  const T s = d > T(0) ? hnj / d : T(0);
  H[j * m + j] = c * hjj + s * hnj;
  H[(j + 1) * m + j] = T(0);
  cs[j] = c;
  sn[j] = s;
  const T gj = g[j];
  g[j + 1] = -s * gj;
  g[j] = c * gj;
  const T r = abs_of(g[j + 1]);
  *norm = r;
  *done = r <= *thr;
  const int64_t e = *hist_base + j + 1;
  if (e < hist_len) hist[e] = r;
}

template <typename T>
__global__ void hessenberg_backsolve_kernel(
    const T* __restrict__ H, const T* __restrict__ g, T* __restrict__ y,
    int m, const int64_t* __restrict__ jcount,
    const bool* __restrict__ active) {
  if (threadIdx.x != 0) return;
  for (int k = 0; k < m; ++k) y[k] = T(0);
  if (!*active) return;
  const int64_t n = *jcount < m ? *jcount : m;
  for (int64_t k = n - 1; k >= 0; --k) {
    const T hkk = H[k * m + k];
    if (hkk != T(0)) {
      T acc = T(0);
      for (int64_t l = k + 1; l < n; ++l) acc = acc + H[k * m + l] * y[l];
      y[k] = (g[k] - acc) / hkk;
    }
  }
}

template <typename T>
int launch_givens(void* H, void* cs, void* sn, void* g, const void* col,
                  int j, int m, const void* active, void* norm,
                  const void* thr, void* done, void* hist,
                  const void* hist_base, int64_t hist_len, void* stream) {
  if (m < 1 || j < 0 || j >= m) return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();  // clear any stale error before this launch
  givens_update_kernel<T><<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(H), static_cast<T*>(cs), static_cast<T*>(sn),
      static_cast<T*>(g), static_cast<const T*>(col), j, m,
      static_cast<const bool*>(active), static_cast<T*>(norm),
      static_cast<const T*>(thr), static_cast<bool*>(done),
      static_cast<T*>(hist), static_cast<const int64_t*>(hist_base),
      hist_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_backsolve(const void* H, const void* g, void* y, int m,
                     const void* jcount, const void* active, void* stream) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();
  hessenberg_backsolve_kernel<T>
      <<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(H), static_cast<const T*>(g), static_cast<T*>(y),
      m, static_cast<const int64_t*>(jcount),
      static_cast<const bool*>(active));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int hdtt_givens_update_f32(void* H, void* cs, void* sn, void* g,
                           const void* col, int j, int m, const void* active,
                           void* norm, const void* thr, void* done,
                           void* hist, const void* hist_base,
                           int64_t hist_len, void* stream) {
  return launch_givens<float>(H, cs, sn, g, col, j, m, active, norm, thr,
                              done, hist, hist_base, hist_len, stream);
}

int hdtt_givens_update_f64(void* H, void* cs, void* sn, void* g,
                           const void* col, int j, int m, const void* active,
                           void* norm, const void* thr, void* done,
                           void* hist, const void* hist_base,
                           int64_t hist_len, void* stream) {
  return launch_givens<double>(H, cs, sn, g, col, j, m, active, norm, thr,
                               done, hist, hist_base, hist_len, stream);
}

int hdtt_hessenberg_backsolve_f32(const void* H, const void* g, void* y,
                                  int m, const void* jcount,
                                  const void* active, void* stream) {
  return launch_backsolve<float>(H, g, y, m, jcount, active, stream);
}

int hdtt_hessenberg_backsolve_f64(const void* H, const void* g, void* y,
                                  int m, const void* jcount,
                                  const void* active, void* stream) {
  return launch_backsolve<double>(H, g, y, m, jcount, active, stream);
}

// The number of nodes of a captured graph (a cudaGraph_t).
int hdtt_graph_nodes(void* graph, int64_t* count) {
  size_t n = 0;
  const cudaError_t e = cudaGraphGetNodes(static_cast<cudaGraph_t>(graph),
                                          nullptr, &n);
  *count = static_cast<int64_t>(n);
  return static_cast<int>(e);
}

}  // extern "C"
