// DIA sparse matrix-vector product for Hopper (sm_90a).
//
//   y[r] = sum_d dia[d, r] * x[r + off_d]      0 <= r < n_rows
//
// Replaces the two Pallas TPU kernels of hypredrive_tpu/ops/pallas_dia.py:
// _make_dia_kernel / _dia_matvec_call (x whole in VMEM, zero margins) and
// _make_dia_kernel_windowed / _dia_matvec_call_windowed (x in HBM,
// double-buffered halo windows).  Both splits, and the (D, S, 128) dia3
// tiling, exist for VMEM capacity; here one kernel serves every size.
//
// Layout: diagonals row-contiguous, dia is (D, n_rows) with
// dia[d * n_rows + r] = A[r, r + off_d].  One thread owns one row and loops
// over the D offsets, so each diagonal load is coalesced across the warp.
// The column r + off_d is masked to [0, n_cols) here (the TPU kernel got
// that from zero margins around x), which also covers rectangular
// operators.
//
// Bound: device-memory bytes, (D + 2) * sizeof(T) per row (D diagonal
// values, one x, one y); neighbouring rows share x through L1/L2, so x is
// read from HBM about once.  No shared memory, no atomics.
//
// dia_spmv_epilogue is the same row sum with an epilogue in place of the
// store of y (csrc/spmv_epilogue.cuh): one thread owns its row, so the
// epilogue reads that row of its vectors, coalesced as the diagonals are.
// It is the last kernel of a matvec whose operator has no CSR remainder.
//
// Plain C interface, bound from Python with ctypes
// (hypredrive_tpu_torch/ops/dia_spmv.py).

#include <cuda_runtime.h>
#include <cstdint>

#include "spmv_epilogue.cuh"

namespace {

constexpr int kMaxDiags = 48;  // DIA_MAX_DIAGS in ops/device_matrix.py
constexpr int kThreads = 256;

struct DiaOffsets {
  int n;
  int off[kMaxDiags];
};

template <typename T>
__device__ __forceinline__ T dia_row(const T* __restrict__ dia,
                                     const T* __restrict__ x, int64_t r,
                                     int64_t n_rows, int64_t n_cols,
                                     const DiaOffsets& offs) {
  T acc = T(0);
  for (int d = 0; d < offs.n; ++d) {
    const int64_t c = r + offs.off[d];
    if (c >= 0 && c < n_cols) {
      acc += __ldg(dia + d * n_rows + r) * __ldg(x + c);
    }
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const T* __restrict__ dia, const T* __restrict__ x,
                T* __restrict__ y, int64_t n_rows, int64_t n_cols,
                const DiaOffsets offs) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (r >= n_rows) return;
  y[r] = dia_row(dia, x, r, n_rows, n_cols, offs);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmv_epilogue(const T* __restrict__ dia, const T* __restrict__ x,
                  int64_t n_rows, int64_t n_cols, const DiaOffsets offs,
                  const hdtt::Epilogue<T> ep) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (r >= n_rows) return;
  hdtt::apply(ep, r, dia_row(dia, x, r, n_rows, n_cols, offs));
}

// ep null: y = A·x; else the epilogue *ep in place of y (y unused)
template <typename T>
int launch(const void* dia, const int32_t* h_offsets, int n_diag,
           const void* x, void* y, int64_t n_rows, int64_t n_cols,
           const hdtt::EpilogueArgs* ep, void* stream) {
  if (n_diag < 1 || n_diag > kMaxDiags || n_rows < 0 || n_cols < 0 ||
      (ep && !hdtt::valid(*ep))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();  // clear any stale error before this launch
  if (n_rows == 0) return 0;
  DiaOffsets offs;
  offs.n = n_diag;
  for (int d = 0; d < n_diag; ++d) offs.off[d] = h_offsets[d];
  const int64_t blocks = (n_rows + kThreads - 1) / kThreads;
  if (ep) {
    dia_spmv_epilogue<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(dia), static_cast<const T*>(x), n_rows, n_cols,
        offs, hdtt::typed<T>(*ep));
  } else {
    dia_spmv_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(dia), static_cast<const T*>(x),
        static_cast<T*>(y), n_rows, n_cols, offs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int hdtt_dia_spmv_f32(const void* dia, const int32_t* offsets, int n_diag,
                      const void* x, void* y, int64_t n_rows, int64_t n_cols,
                      const hdtt::EpilogueArgs* ep, void* stream) {
  return launch<float>(dia, offsets, n_diag, x, y, n_rows, n_cols, ep, stream);
}

int hdtt_dia_spmv_f64(const void* dia, const int32_t* offsets, int n_diag,
                      const void* x, void* y, int64_t n_rows, int64_t n_cols,
                      const hdtt::EpilogueArgs* ep, void* stream) {
  return launch<double>(dia, offsets, n_diag, x, y, n_rows, n_cols, ep, stream);
}

}  // extern "C"
