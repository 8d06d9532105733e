// CSR sparse matrix-vector product for Hopper (sm_90a), over tiles that
// hold a bounded number of nonzeros.
//
//   y[r] (=|+=) sum_{j in [indptr[r], indptr[r+1])} data[j] * x[indices[j]]
//
// Replaces the two Pallas TPU kernels of hypredrive_tpu/ops/pallas_spmv.py:
// K3, _make_kernel / _gather_spmv_call (:85, f32 remainder SpMV over the
// (8, 128) pass plan of ops/gather_plan.py), and K4, _make_kernel_ds /
// _gather_spmv_call_ds_inner (:216, the same at f64-class accuracy from
// double-single f32 pairs).  The pass plan exists because a TPU cannot
// gather lanes cheaply, and double-single because Mosaic has no 64-bit
// type; Hopper gathers x per entry and has native `double`, so neither is
// kept.  It applies the entries off the chosen diagonals of every device
// matrix: AMG and MGR prolongations and restrictions (rectangular), coarse
// operators, ILU and FSAI factors.
//
// Bound: device-memory bytes.  Each entry moves sizeof(T) + 4 bytes (value,
// column) and does 2 flops; each row moves 8 bytes of indptr and sizeof(T)
// of y (twice when accumulating), and x is read about once (it fits the
// 50 MB L2 at every operator of the solves).  At 2 flops per 12-16 bytes the
// tensor cores have no role: the kernel has to keep enough bytes in flight.
//
// Design, against a row-per-lane-group kernel whose every lane ran a chain
// of dependent loads (indptr, then indices and data, then x):
// * Tiles.  The host cuts the rows into tiles of at most kTileNnz entries
//   and kTileRows rows (ops/csr_spmv.py::csr_tiles; `tiles` holds the first
//   row of each tile, then n_rows, and after them the first entry of each
//   tile, then nnz).  A row longer than kTileNnz is a tile of
//   its own, walked by one block in chunks of kTileNnz.  Every block moves
//   about the same bytes per tile whatever the row lengths are.
// * Asynchronous copies.  A persistent grid (the SM count times the blocks
//   that fit, more only when a block would take over kBlockTiles tiles)
//   splits the tiles into contiguous runs, one a block; a block reads its
//   run's table (first row and first entry of each tile, independent
//   loads) into shared memory once, so no tile waits on a load of its
//   bounds.  For each
//   tile the block copies the spans of data, indices and indptr into a
//   kStages-deep shared-memory ring: one thread issues a bulk (TMA) copy of
//   each span's 16-byte-aligned middle, completing on the slot's mbarrier
//   and marked evict-first in L2 (which keeps x there), and the unaligned
//   head and tail (under 16 bytes each) go by 4- or 8-byte cp.async, so no
//   copy reads outside the span.  The next tile's copies are in flight
//   while this tile's x gathers and sums run.  Two stages, not more: a
//   small ring leaves more of the SM's 256 KB to L1, which serves the x
//   gathers.
// * Deterministic sums, no atomics.  Each row of a tile is summed by G =
//   1..32 lanes, G chosen from the tile's row count: lane l multiplies
//   entries l, l + G, ... by x (gathered through the read-only path,
//   kBatch gathers in flight) and adds the products in that order, then a
//   shuffle tree of width G adds the lanes.  With one lane a row (short
//   rows) a thread advances its kRowsPerThread rows together, so their
//   gathers are in flight at once.  Products are rounded on their own,
//   never fused into the sum.  A long row adds its chunks in order in one
//   thread.  y is written (or added to) once per row, so two launches on
//   the same input give bit-identical y.  One barrier a tile: a slot is
//   only read, and is refilled once every thread has passed the next
//   barrier.
//
// `accumulate` makes the kernel add into y instead of writing it: the
// hybrid DIA + CSR matvec is then one DIA launch and one CSR launch into the
// same y.  Column indices must lie in [0, len(x)) and `tiles` must come
// from csr_tiles for this indptr; the wrapper and the device matrix ensure
// both.
//
// Plain C interface, bound from Python with ctypes
// (hypredrive_tpu_torch/ops/csr_spmv.py).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 2;
constexpr int kTileNnz = 1024;   // TILE_NNZ in ops/csr_spmv.py
constexpr int kTileRows = 512;   // TILE_ROWS in ops/csr_spmv.py
constexpr int kBatch = 4;        // x gathers a lane keeps in flight
constexpr int kRowsPerThread = kTileRows / kThreads;  // one-lane rows
static_assert(kTileRows % kThreads == 0, "one-lane rows cover the tile");
constexpr int kBlockTiles = 64;  // most tiles one block walks

// shared-memory bytes of one ring slot: each span may start up to 16 bytes
// before its first element (the alignment skew)
template <typename T>
__host__ __device__ constexpr int data_bytes() {
  return kTileNnz * sizeof(T) + 16;
}
__host__ __device__ constexpr int index_bytes() { return kTileNnz * 4 + 16; }
__host__ __device__ constexpr int indptr_bytes() {
  return (kTileRows + 1) * 8 + 8;
}
template <typename T>
__host__ __device__ constexpr int slot_bytes() {
  return data_bytes<T>() + index_bytes() + indptr_bytes();
}
static_assert(indptr_bytes() % 16 == 0 && index_bytes() % 16 == 0 &&
              data_bytes<float>() % 16 == 0 && data_bytes<double>() % 16 == 0,
              "ring slots keep 16-byte alignment");

// one unit of work: a tile, or one chunk of a tile that is a single long row
struct Item {
  int64_t e0, e1;   // entries [e0, e1) of this chunk
  int row0, nrows;  // the tile's rows
  int valid, first, last;
};

// the bulk (TMA) copy of one 16-byte-aligned run, completing on an
// mbarrier; marked first to leave L2, so that x stays there
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

template <int S>
__device__ __forceinline__ void cp_async_elem(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(src), "n"(S)
               : "memory");
}

// products rounded on their own (never fused into the sum), so the sums
// are those of a product-then-add loop in the same order
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// elements of S bytes before e0 in the same 16-byte word: the slot holds
// element e at (skew + e - e0) * S, so its 16-byte words line up with
// device memory's
template <int S>
__device__ __forceinline__ int skew_of(const void* base, int64_t e0) {
  return static_cast<int>(
      ((reinterpret_cast<uintptr_t>(base) + e0 * S) & 15) / S);
}

// the 16-byte-aligned middle of a span, left to one bulk copy
struct Body {
  unsigned dst;
  const char* src;
  unsigned bytes;
};

// copy elements [e0, e1) of base (S bytes each) to the slot at dst: the
// unaligned head and tail (under 16 bytes each) here, with cp.async; the
// aligned body is returned for the bulk copy
template <int S>
__device__ __forceinline__ Body copy_span(unsigned dst, const void* base,
                                          int64_t e0, int64_t e1, int tid) {
  // spans are at most kTileNnz (or kTileRows + 1) elements: int offsets
  const char* src = static_cast<const char*>(base) + e0 * S;
  const int skew = skew_of<S>(base, e0);
  const int n = static_cast<int>(e1 - e0);
  int head = skew ? 16 / S - skew : 0;
  head = head < n ? head : n;
  const int words = (n - head) * S / 16;
  const int body_end = head + words * (16 / S);
  dst += static_cast<unsigned>(skew * S);
  if (tid < head) {
    cp_async_elem<S>(dst + static_cast<unsigned>(tid * S), src + tid * S);
  }
  // the last threads take the tail (fewer than 16 / S elements)
  const int t = body_end + (kThreads - 1 - tid);
  if (kThreads - 1 - tid < n - body_end) {
    cp_async_elem<S>(dst + static_cast<unsigned>(t * S), src + t * S);
  }
  return {dst + static_cast<unsigned>(head * S), src + head * S,
          static_cast<unsigned>(words * 16)};
}

// the chunk-th chunk of the block's k-th tile, from its table in shared
// memory (first row and first entry of each tile, then those past the last)
__device__ __forceinline__ Item make_item(const int* t_row,
                                          const int* t_ent, int k,
                                          int64_t chunk, int count) {
  Item it{0, 0, 0, 0, 0, 0, 0};
  if (k >= count) return it;
  const int64_t te = t_ent[k + 1];
  it.e0 = t_ent[k] + chunk * kTileNnz;
  it.e1 = te - it.e0 > kTileNnz ? it.e0 + kTileNnz : te;
  it.row0 = t_row[k];
  it.nrows = t_row[k + 1] - it.row0;
  it.valid = 1;
  it.first = chunk == 0;
  it.last = it.e1 == te;
  return it;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
csr_spmv_tiled(const int64_t* __restrict__ indptr,
               const int32_t* __restrict__ indices,
               const T* __restrict__ data, const T* __restrict__ x,
               T* __restrict__ y, const int32_t* __restrict__ tiles,
               int64_t n_tiles, int accumulate) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ Item desc[kStages];
  __shared__ uint64_t full[kStages];  // a slot's bulk copies have landed
  __shared__ int t_row[kBlockTiles + 1];
  __shared__ int t_ent[kBlockTiles + 1];
  const int tid = threadIdx.x;
  const unsigned ring0 = static_cast<unsigned>(__cvta_generic_to_shared(ring));
  const uint64_t policy = evict_first_policy();

  // this block's contiguous run of tiles, its table read once
  const int64_t t0 = n_tiles * blockIdx.x / gridDim.x;
  const int count = static_cast<int>(n_tiles * (blockIdx.x + 1) / gridDim.x
                                     - t0);
  for (int k = tid; k <= count; k += kThreads) {
    t_row[k] = __ldg(tiles + t0 + k);
    t_ent[k] = __ldg(tiles + n_tiles + 1 + t0 + k);
  }
  const unsigned full0 = static_cast<unsigned>(__cvta_generic_to_shared(full));
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full0 + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // producer cursor: the block's k-th tile, chunk of that tile
  int p_k = 0;
  int64_t p_chunk = 0;
  auto issue = [&](const Item& it, int slot) {
    if (tid == 0) desc[slot] = it;
    if (it.valid) {
      const unsigned s = ring0 + slot * slot_bytes<T>();
      const Body b[3] = {
          copy_span<sizeof(T)>(s, data, it.e0, it.e1, tid),
          copy_span<4>(s + data_bytes<T>(), indices, it.e0, it.e1, tid),
          copy_span<8>(s + data_bytes<T>() + index_bytes(), indptr, it.row0,
                       it.row0 + it.nrows + 1, tid)};
      if (tid == 0) {
        const unsigned bar = full0 + 8 * slot;
        mbar_expect_tx(bar, b[0].bytes + b[1].bytes + b[2].bytes);
        for (int k = 0; k < 3; ++k) {
          if (b[k].bytes) bulk_copy(b[k].dst, b[k].src, b[k].bytes, bar,
                                    policy);
        }
      }
      if (it.last) {
        ++p_k;
        p_chunk = 0;
      } else {
        ++p_chunk;
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    issue(make_item(t_row, t_ent, p_k, p_chunk, count), s);
  }

  T carry = T(0);  // a long row's sum over its earlier chunks (thread 0)
  for (int i = 0;; ++i) {
    const int slot = i % kStages;
    cp_async_wait<kStages - 2>();  // this slot's heads and tails
    __syncthreads();  // ... seen by all; the previous slot is free
    const Item it = desc[slot];
    if (!it.valid) break;
    mbar_wait(full0 + 8 * slot, (i / kStages) & 1);
    issue(make_item(t_row, t_ent, p_k, p_chunk, count),
          (i + kStages - 1) % kStages);

    const unsigned char* base = ring + slot * slot_bytes<T>();
    const T* val = reinterpret_cast<const T*>(base)
                   + skew_of<sizeof(T)>(data, it.e0);
    const int32_t* col = reinterpret_cast<const int32_t*>(
        base + data_bytes<T>()) + skew_of<4>(indices, it.e0);
    const int64_t* ip = reinterpret_cast<const int64_t*>(
        base + data_bytes<T>() + index_bytes()) + skew_of<8>(indptr, it.row0);
    const int n = static_cast<int>(it.e1 - it.e0);

    // each row summed by g lanes in a fixed order: lane l takes entries
    // l, l + g, ... of the row, kBatch gathers of x in flight at a time
    int log_g = 5;
    while (log_g > 0 && (it.nrows << log_g) > kThreads) --log_g;
    if (log_g == 0) {
      // one lane a row (short rows): a thread's rows tid, tid + kThreads,
      // ... advance together, two entries each at a time
      int lo[kRowsPerThread], hi[kRowsPerThread];
      T acc[kRowsPerThread];
      bool more = false;
#pragma unroll
      for (int p = 0; p < kRowsPerThread; ++p) {
        const int r = tid + p * kThreads;
        lo[p] = hi[p] = 0;
        if (r < it.nrows) {
          lo[p] = static_cast<int>(ip[r] - it.e0);
          hi[p] = static_cast<int>(ip[r + 1] - it.e0);
        }
        acc[p] = T(0);
        more |= lo[p] < hi[p];
      }
      for (int j = 0; more; j += 2) {
        T v[kRowsPerThread][2];
#pragma unroll
        for (int p = 0; p < kRowsPerThread; ++p) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int k = lo[p] + j + u;
            v[p][u] = k < hi[p] ? mul_rn(val[k], __ldg(x + col[k])) : T(0);
          }
        }
        more = false;
#pragma unroll
        for (int p = 0; p < kRowsPerThread; ++p) {
          acc[p] += v[p][0];
          acc[p] += v[p][1];
          more |= lo[p] + j + 2 < hi[p];
        }
      }
#pragma unroll
      for (int p = 0; p < kRowsPerThread; ++p) {
        const int r = tid + p * kThreads;
        if (r < it.nrows) {
          T* out = y + it.row0 + r;
          *out = accumulate ? *out + acc[p] : acc[p];
        }
      }
      continue;
    }
    const int g = 1 << log_g;
    const int grp = tid >> log_g, lane = tid & (g - 1);
    for (int r0 = 0; r0 < it.nrows; r0 += kThreads >> log_g) {  // same trips
      const int r = r0 + grp;
      T acc = T(0);
      if (r < it.nrows) {
        const int lo = ip[r] > it.e0 ? static_cast<int>(ip[r] - it.e0) : 0;
        const int hi = ip[r + 1] < it.e1 ? static_cast<int>(ip[r + 1] - it.e0)
                                         : n;
        for (int j = lo + lane; j < hi; j += kBatch * g) {
          T v[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int k = j + u * g;
            v[u] = k < hi ? mul_rn(val[k], __ldg(x + col[k])) : T(0);
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) acc += v[u];
        }
      }
      for (int o = g / 2; o > 0; o >>= 1) {
        acc += __shfl_down_sync(0xffffffffu, acc, o, g);
      }
      if (lane == 0 && r < it.nrows) {
        if (!it.first) acc = carry + acc;
        if (!it.last) {
          carry = acc;
        } else {
          T* out = y + it.row0 + r;
          *out = accumulate ? *out + acc : acc;
        }
      }
    }
  }
}

template <typename T>
int launch(const void* indptr, const void* indices, const void* data,
           const void* x, void* y, int64_t n_rows, const void* tiles,
           int64_t n_tiles, int accumulate, void* stream) {
  if (n_rows < 0 || n_tiles < 0 || (n_rows > 0 && n_tiles == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)cudaGetLastError();  // clear any stale error before this launch
  if (n_rows == 0) return 0;
  constexpr int smem = kStages * slot_bytes<T>();
  static int64_t grid_cap = 0;  // SMs x resident blocks, found on first use
  if (grid_cap == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        csr_spmv_tiled<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, csr_spmv_tiled<T>, kThreads, smem);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid_cap = sms * per_sm;
  }
  // one wave of resident blocks, or more when a block would take more
  // than kBlockTiles tiles
  int64_t grid = n_tiles < grid_cap ? n_tiles : grid_cap;
  const int64_t min_grid = (n_tiles + kBlockTiles - 1) / kBlockTiles;
  if (grid < min_grid) grid = min_grid;
  csr_spmv_tiled<T><<<static_cast<unsigned>(grid), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(indptr), static_cast<const int32_t*>(indices),
      static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const int32_t*>(tiles), n_tiles, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int hdtt_csr_spmv_f32(const void* indptr, const void* indices,
                      const void* data, const void* x, void* y,
                      int64_t n_rows, const void* tiles, int64_t n_tiles,
                      int accumulate, void* stream) {
  return launch<float>(indptr, indices, data, x, y, n_rows, tiles, n_tiles,
                       accumulate, stream);
}

int hdtt_csr_spmv_f64(const void* indptr, const void* indices,
                      const void* data, const void* x, void* y,
                      int64_t n_rows, const void* tiles, int64_t n_tiles,
                      int accumulate, void* stream) {
  return launch<double>(indptr, indices, data, x, y, n_rows, tiles, n_tiles,
                        accumulate, stream);
}

}  // extern "C"
