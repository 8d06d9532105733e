// CSR sparse matrix-vector product for Hopper (sm_90a).
//
//   y[r] (=|+=) sum_{j in [indptr[r], indptr[r+1])} data[j] * x[indices[j]]
//
// Replaces the two Pallas TPU kernels of hypredrive_tpu/ops/pallas_spmv.py:
// _make_kernel / _gather_spmv_call (f32 remainder SpMV over the (8, 128)
// pass plan of ops/gather_plan.py) and _make_kernel_ds /
// _gather_spmv_call_ds (the same at f64-class accuracy from double-single
// f32 pairs).  The pass plan exists because a TPU cannot gather lanes
// cheaply, and double-single because Mosaic has no 64-bit type; on Hopper a
// row kernel gathers x directly and `double` is native, so neither is kept.
//
// It applies the entries off the chosen diagonals of every device matrix:
// the AMG prolongation P (n_f x n_c), restriction R (n_c x n_f) and coarse
// operators.  Shapes may be rectangular: only n_rows is needed here, and
// every column index is < len(x) by construction (checked by the wrapper).
//
// Design: a group of G lanes (G a power of two, 2..32, chosen by the wrapper
// from the mean row length) owns one row; the lanes stride over the row's
// entries and reduce with warp shuffles of width G.  Groups never straddle
// a warp, and no thread returns before the shuffles, so the full mask is
// valid.  `accumulate` makes the kernel add into y instead of writing it:
// the hybrid DIA + CSR matvec is then one DIA launch and one CSR launch
// into the same y, with no extra pass.
//
// Bound: device-memory bytes, sizeof(T) + 4 bytes per entry (value,
// column), one x gather per entry (mostly L2 hits for AMG operators) and
// sizeof(T) (+ sizeof(T) when accumulating) per row.
//
// Plain C interface, bound from Python with ctypes
// (hypredrive_tpu_torch/ops/csr_spmv.py).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
csr_spmv_kernel(const int64_t* __restrict__ indptr,
                const int32_t* __restrict__ indices,
                const T* __restrict__ data, const T* __restrict__ x,
                T* __restrict__ y, int64_t n_rows, int accumulate) {
  const int64_t tid = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t row = tid / G;
  const int lane = static_cast<int>(threadIdx.x) & (G - 1);
  T acc = T(0);
  if (row < n_rows) {
    const int64_t end = __ldg(indptr + row + 1);
    for (int64_t j = __ldg(indptr + row) + lane; j < end; j += G) {
      acc += __ldg(data + j) * __ldg(x + __ldg(indices + j));
    }
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, o, G);
  }
  if (row < n_rows && lane == 0) {
    y[row] = accumulate ? y[row] + acc : acc;
  }
}

template <typename T, int G>
void launch_g(const int64_t* indptr, const int32_t* indices, const void* data,
              const void* x, void* y, int64_t n_rows, int accumulate,
              cudaStream_t stream) {
  const int64_t threads = n_rows * G;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  csr_spmv_kernel<T, G><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      indptr, indices, static_cast<const T*>(data), static_cast<const T*>(x),
      static_cast<T*>(y), n_rows, accumulate);
}

template <typename T>
int launch(const void* indptr, const void* indices, const void* data,
           const void* x, void* y, int64_t n_rows, int group, int accumulate,
           void* stream) {
  if (n_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  (void)cudaGetLastError();  // clear any stale error before this launch
  if (n_rows == 0) return 0;
  const auto* ip = static_cast<const int64_t*>(indptr);
  const auto* ix = static_cast<const int32_t*>(indices);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 2: launch_g<T, 2>(ip, ix, data, x, y, n_rows, accumulate, s); break;
    case 4: launch_g<T, 4>(ip, ix, data, x, y, n_rows, accumulate, s); break;
    case 8: launch_g<T, 8>(ip, ix, data, x, y, n_rows, accumulate, s); break;
    case 16: launch_g<T, 16>(ip, ix, data, x, y, n_rows, accumulate, s); break;
    case 32: launch_g<T, 32>(ip, ix, data, x, y, n_rows, accumulate, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int hdtt_csr_spmv_f32(const void* indptr, const void* indices,
                      const void* data, const void* x, void* y,
                      int64_t n_rows, int group, int accumulate,
                      void* stream) {
  return launch<float>(indptr, indices, data, x, y, n_rows, group,
                       accumulate, stream);
}

int hdtt_csr_spmv_f64(const void* indptr, const void* indices,
                      const void* data, const void* x, void* y,
                      int64_t n_rows, int group, int accumulate,
                      void* stream) {
  return launch<double>(indptr, indices, data, x, y, n_rows, group,
                        accumulate, stream);
}

}  // extern "C"
