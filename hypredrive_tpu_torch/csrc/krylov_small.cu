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
// captured graph.  Both are sequential recurrences: one instruction stream
// does the arithmetic, in the order of the plain torch versions in
// ops/krylov_small.py, and the file is built with -fmad=false so that no
// product is fused into an add.  The results are then bit for bit the
// plain versions' in float32 and float64.
//
// Bound: latency.  The work is O(j) (rotations) and O(n^2) (back-
// substitution) flops on a few kilobytes; the chain of dependent adds is
// what takes the time.  The design keeps every operand of that chain in
// shared memory or registers, so that a step costs an add's latency and
// not a round trip to device memory:
//
//   givens_update        the block stages col, cs[:j] and sn[:j] in shared
//                        memory, every load issued before the first store;
//                        thread 0 carries the rotated entry in a register
//                        and reads each rotation's operands in batches of
//                        kBatch, loaded while the batch before runs; the
//                        block writes H[:, j] back, and threads 0-6 the
//                        scalars.
//   hessenberg_backsolve the block stages the packed triangle of H and g in
//                        shared memory; warp 0 runs the row recurrence (its
//                        32 lanes in lockstep on the same values, so the
//                        warp's barriers stay uniform), y in shared memory,
//                        each row's products loaded kBatch at a time ahead
//                        of their adds (dot_run); the block writes y out.
//
// Staging modes, template parameters chosen on the host from m and j
// alone (jcount lives on the device): when the packed triangle for n = m and
// y fit in the block's shared memory (the opt-in maximum, 227 KB on an H100:
// m <= 338 in float32, m <= 238 in float64), it is staged at once, in an
// order that does not depend on jcount, so that its loads go out with the
// flags' loads.  Past that, the triangle, packed in the order the
// recurrence reads it, streams in chunks through two buffers: warps 1-7
// load chunk c + 1 while warp 0 works on chunk c, one block barrier per
// chunk.
// When y itself takes more than a quarter of shared memory (m >= 14,521 in
// float32, 7,257 in float64), warp 0 keeps it in the output y in device
// memory.  The Givens column and rotations stay in device memory when their
// 3 j + 34 entries do not fit (j > 19,359 in float32, 9,674 in float64).
// Every m runs this code; no m is refused.
//
// Both take a device flag `active`: when it is false they write nothing
// (givens_update) or zeros (hessenberg_backsolve), so that a masked
// iteration of the device loop changes no state.  One block per call: the
// kernels are nodes of captured graphs.
//
// Two measurement helpers sit beside them (chip_smoke.py): an empty
// one-block kernel, whose graph replay is the floor under any launch, and
// a probe of the dependent add, multiply, divide and square-root latencies
// the recurrences chain.
//
// Plain C interface, bound from Python with ctypes (ops/krylov_small.py);
// hdtt_graph_nodes counts the nodes of a captured CUDA graph.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kGivensThreads = 128;
constexpr int kBacksolveThreads = 256;  // warp 0 computes, warps 1-7 stream
constexpr int kBatch = 8;               // operands loaded ahead of a chain run

template <typename T>
__device__ __forceinline__ T abs_of(T v) { return v < T(0) ? -v : v; }

// the current card's opt-in limit: the wrapper makes the operands' card
// current, so this is the limit of the card the kernel launches on
int optin_smem_bytes(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  return static_cast<int>(e);
}

// dynamic shared memory above the default 48 KB needs the kernel's opt-in
template <typename K>
int allow_smem(K kernel, int64_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// ---------------------------------------------------------------- Givens

// Shared memory when kStaged: [out: 8 | h: j + 2 + kBatch | c: j + kBatch |
// s: j + kBatch], the kBatch past each array read ahead and unused; else
// [out: 8] and the column and rotations are read where they lie (indices
// clamped instead).
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kGivensThreads) givens_update_kernel(
    T* __restrict__ H, T* __restrict__ cs, T* __restrict__ sn,
    T* __restrict__ g, const T* __restrict__ col, int j, int m,
    const bool* __restrict__ active, T* __restrict__ norm,
    const T* __restrict__ thr, bool* __restrict__ done,
    T* __restrict__ hist, const int64_t* __restrict__ hist_base,
    int64_t hist_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* const out = reinterpret_cast<T*>(smem);  // c, s, g[j], g[j+1], |g[j+1]|
  const int tid = threadIdx.x;
  const int64_t ld = m;  // H is (m + 1, m), row-major: H[i, j] = H[i*m + j]
  // every load is issued before the first store, so that the block waits
  // for device memory once
  const bool on = *active;
  T gj = T(0), tr = T(0);
  int64_t e = 0;
  if (tid == 0) gj = g[j];
  if (tid == 5) tr = *thr;
  if (tid == 6) e = *hist_base + j + 1;
  T* const sh = out + 8;
  T* const sc = sh + (j + 2 + kBatch);
  T* const ss = sc + (j + kBatch);
  T* h;  // the column H[:, j], entry i at h[i * hs]
  const T* c;
  const T* s;
  int64_t hs;
  if (kStaged) {  // staged whatever `active` says, so the loads overlap
    for (int i0 = 0; i0 < j + 2; i0 += blockDim.x) {
      const int i = i0 + tid;
      T vh = T(0), vc = T(0), vs = T(0);
      if (i < j + 2) vh = col[i];
      if (i < j) {
        vc = cs[i];
        vs = sn[i];
      }
      if (i < j + 2) sh[i] = vh;
      if (i < j) {
        sc[i] = vc;
        ss[i] = vs;
      }
    }
    h = sh;
    c = sc;
    s = ss;
    hs = 1;
  } else {
    if (!on) return;
    for (int i = tid; i < j + 2; i += blockDim.x) H[i * ld + j] = col[i];
    h = H + j;
    c = cs;
    s = sn;
    hs = ld;
  }
  __syncthreads();
  if (!on) return;
  if (tid == 0) {
    // H[i, j] after rotations 0..i-1 is carried in a register; H[i+1, j]
    // is still col[i + 1] when rotation i reads it.  The operands of
    // rotations i0..i0+kBatch-1 are loaded while the rotations before i0
    // run.
    T carry = h[0];
    const T hnj = h[(j + 1) * hs];
    T cv[kBatch], sv[kBatch], hv[kBatch];
    auto at = [j](int i) { return kStaged || i < j ? i : j - 1; };
    if (j > 0) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        cv[u] = c[at(u)];
        sv[u] = s[at(u)];
        hv[u] = h[(at(u) + 1) * hs];
      }
    }
    // rotation i of a batch: H[i, j] out, the carried entry updated
    auto rotate = [&](T ci, T si, T hn, int i) {
      const T t = ci * carry + si * hn;
      carry = -si * carry + ci * hn;
      h[i * hs] = t;
    };
    int i0 = 0;
    for (; i0 + kBatch <= j; i0 += kBatch) {
      T cc[kBatch], ss_[kBatch], hh[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        cc[u] = cv[u];
        ss_[u] = sv[u];
        hh[u] = hv[u];
      }
      if (i0 + kBatch < j) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = at(i0 + kBatch + u);
          cv[u] = c[i];
          sv[u] = s[i];
          hv[u] = h[(i + 1) * hs];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) rotate(cc[u], ss_[u], hh[u], i0 + u);
    }
#pragma unroll
    for (int u = 0; u < kBatch - 1; ++u)  // the j - i0 < kBatch left
      if (i0 + u < j) rotate(cv[u], sv[u], hv[u], i0 + u);
    const T hjj = carry;
    const T d = sqrt(hjj * hjj + hnj * hnj);
    const T cj = d > T(0) ? hjj / d : T(1);
    const T sj = d > T(0) ? hnj / d : T(0);
    h[j * hs] = cj * hjj + sj * hnj;
    h[(j + 1) * hs] = T(0);
    const T g1 = -sj * gj;
    out[0] = cj;
    out[1] = sj;
    out[2] = cj * gj;
    out[3] = g1;
    out[4] = abs_of(g1);
  }
  __syncthreads();
  if (kStaged)
    for (int i = tid; i < j + 2; i += blockDim.x) H[i * ld + j] = sh[i];
  switch (tid) {
    case 0: cs[j] = out[0]; break;
    case 1: sn[j] = out[1]; break;
    case 2: g[j] = out[2]; break;
    case 3: g[j + 1] = out[3]; break;
    case 4: *norm = out[4]; break;
    case 5: *done = out[4] <= tr; break;
    case 6: if (e < hist_len) hist[e] = out[4]; break;
    default: break;
  }
}

// ------------------------------------------------- back-substitution

// The packed triangle, in one of two orders:
// - whole (the triangle fits): rows k = 0..m-1 top down, row k as [g[k],
//   H[k, k], ..., H[k, m-1]] from position k (m + 1) - k (k - 1) / 2.  It
//   does not depend on jcount, so its loads start with the flags' loads.
// - streamed: rows in the order the recurrence reads them, row t = 0..n-1
//   holding H's row k = n - 1 - t as [g[k], H[k, k], ..., H[k, n-1]] (t + 2
//   entries) from position t (t + 3) / 2, so that chunks are read in turn.
__device__ __forceinline__ int64_t top_offset(int64_t k, int64_t m) {
  return k * (m + 1) - k * (k - 1) / 2;
}

__device__ __forceinline__ int64_t row_offset(int64_t t) {
  return t * (t + 3) / 2;
}

// entry q of the packed triangle of kTop order (n = m) or the streamed one
template <typename T, bool kTop>
__device__ __forceinline__ T packed_entry(const T* H, const T* g, int64_t m,
                                          int64_t n, int64_t q) {
  int64_t k, u;
  if (kTop) {  // the largest k with top_offset(k) <= q, from the quadratic
    const float b = 2.0f * static_cast<float>(m) + 3.0f;
    k = static_cast<int64_t>(
        (b - sqrtf(fmaxf(b * b - 8.0f * static_cast<float>(q), 0.0f))) *
        0.5f);
    k = k < 0 ? 0 : (k > m - 1 ? m - 1 : k);
    while (k > 0 && top_offset(k, m) > q) --k;
    while (k < m - 1 && top_offset(k + 1, m) <= q) ++k;
    u = q - top_offset(k, m);
  } else {
    int64_t t = static_cast<int64_t>(
        (sqrtf(9.0f + 8.0f * static_cast<float>(q)) - 3.0f) * 0.5f);
    if (t < 0) t = 0;
    while (t > 0 && row_offset(t) > q) --t;
    while (row_offset(t + 1) <= q) ++t;
    k = n - 1 - t;
    u = q - row_offset(t);
  }
  const T* p = u == 0 ? g + k : H + (k * m + k + u - 1);
  return *p;
}

// packed positions [q0, q1) into dst[0 .. q1 - q0), by threads r of nthr,
// kBatch loads in flight per thread
template <typename T, bool kTop>
__device__ void stage_packed(T* dst, const T* H, const T* g, int64_t m,
                             int64_t n, int64_t q0, int64_t q1, int r,
                             int nthr) {
  const int64_t step = static_cast<int64_t>(kBatch) * nthr;
  for (int64_t b = q0 + r; b < q1; b += step) {
    T v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int64_t q = b + static_cast<int64_t>(u) * nthr;
      if (q < q1) v[u] = packed_entry<T, kTop>(H, g, m, n, q);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int64_t q = b + static_cast<int64_t>(u) * nthr;
      if (q < q1) dst[q - q0] = v[u];
    }
  }
}

// h[b .. b + kBatch) and y[b .. b + kBatch) into hv, yv (y's indices
// clamped to cnt - 1 when kClampY)
template <typename T, bool kClampY>
__device__ __forceinline__ void load_batch(T (&hv)[kBatch], T (&yv)[kBatch],
                                           const T* h, const T* y, int cnt,
                                           int b) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    hv[u] = h[b + u];
    yv[u] = y[kClampY && b + u >= cnt ? cnt - 1 : b + u];
  }
}

// acc + h[0] y[0] + h[1] y[1] + ... + h[cnt-1] y[cnt-1], added in this
// order.  The products of each kBatch are loaded while the batch before is
// added; h (and y, unless kClampY) is read up to kBatch entries past cnt,
// which the caller's buffers hold as padding.  The last partial batch is
// padded with +0: that leaves the sum bit for bit the same, since acc
// starts at +0 and is never -0 (x + y is -0 only when both are) and
// acc + (+0) == acc for every acc that is not -0.  At most kBatch / 2 - 1
// such adds.
template <typename T, bool kClampY>
__device__ __forceinline__ T dot_run(T acc, const T* h, const T* y, int cnt) {
  T hv[kBatch], yv[kBatch];
  load_batch<T, kClampY>(hv, yv, h, y, cnt, 0);
  int b = 0;
  for (; b + kBatch <= cnt; b += kBatch) {
    T pr[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) pr[u] = hv[u] * yv[u];
    load_batch<T, kClampY>(hv, yv, h, y, cnt, b + kBatch);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) acc = acc + pr[u];
  }
  const int rem = cnt - b;
  if (rem > 0) {
    T pr[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) pr[u] = u < rem ? hv[u] * yv[u] : T(0);
#pragma unroll
    for (int u = 0; u < kBatch / 2; ++u) acc = acc + pr[u];
    if (rem > kBatch / 2) {
#pragma unroll
      for (int u = kBatch / 2; u < kBatch; ++u) acc = acc + pr[u];
    }
  }
  return acc;
}

// Shared memory: [y: ypad >= m + kBatch, if kYShared | buffer 0: chunk +
// kBatch | buffer 1: chunk + kBatch, if kStream]; the kBatch past each is
// dot_run's read-ahead.  The staging mode is a pair of template parameters
// (whole triangle: kStream false, kYShared true), so that the recurrence's
// loads are shared-memory loads and the whole-triangle case carries no
// chunk bookkeeping.
template <typename T, bool kStream, bool kYShared>
__global__ void __launch_bounds__(kBacksolveThreads)
hessenberg_backsolve_kernel(const T* __restrict__ H, const T* __restrict__ g,
                            T* __restrict__ y, int m,
                            const int64_t* __restrict__ jcount,
                            const bool* __restrict__ active, int64_t chunk,
                            int64_t ypad) {
  const int tid = threadIdx.x;
  const bool on = *active;
  const int64_t jc = *jcount;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const ys = kYShared ? reinterpret_cast<T*>(smem) : y;
  T* const buf0 = reinterpret_cast<T*>(smem) + (kYShared ? ypad : 0);
  if constexpr (!kStream)  // staged whatever the flags say: loads overlap
    stage_packed<T, true>(buf0, H, g, m, m, 0, chunk, tid, blockDim.x);
  if (!on) {
    for (int i = tid; i < m; i += blockDim.x) y[i] = T(0);
    return;
  }
  const int64_t n = jc < 0 ? 0 : (jc < m ? jc : m);
  if constexpr (!kStream) {
    __syncthreads();
    if (tid < 32) {
      const int nn = static_cast<int>(n);
      const T* row = buf0 + top_offset(nn - 1, m);  // [g[k], H[k, k], ...]
      for (int k = nn - 1; k >= 0; --k) {
        const T acc = dot_run<T, false>(T(0), row + 2, ys + k + 1,
                                        nn - 1 - k);
        ys[k] = row[1] != T(0) ? (row[0] - acc) / row[1] : T(0);
        row -= m - k + 2;  // to row k - 1, m - k + 2 entries long
      }
    }
  } else {
    const int64_t total = row_offset(n);
    T* const buf1 = buf0 + chunk + kBatch;
    const int64_t end0 = chunk < total ? chunk : total;
    stage_packed<T, false>(buf0, H, g, m, n, 0, end0, tid, blockDim.x);
    __syncthreads();
    if (tid < 32) {
      // the recurrence; a block barrier each time it passes into the next
      // chunk, as the loaders take one after each chunk they stage.  Every
      // packed position is read, so it passes into every chunk.
      int64_t cbeg = 0, cend = end0;
      const T* cur = buf0;
      auto reach = [&](int64_t p) {
        while (p >= cend) {
          __syncthreads();
          cbeg = cend;
          cend = cend + chunk < total ? cend + chunk : total;
          cur = cur == buf0 ? buf1 : buf0;
        }
      };
      int64_t p = 0;  // packed position of row t's g[k]
      for (int64_t t = 0; t < n; ++t) {
        const int64_t k = n - 1 - t;
        reach(p);
        const T gk = cur[p - cbeg];
        reach(p + 1);
        const T hkk = cur[p + 1 - cbeg];
        p += 2;
        // the row's t entries right of the diagonal, times y[k+1 .. n-1],
        // in runs that end where the chunk ends
        T acc = T(0);
        for (int64_t i = 0; i < t;) {
          reach(p + i);
          const int cnt = static_cast<int>(
              t - i < cend - (p + i) ? t - i : cend - (p + i));
          acc = dot_run<T, !kYShared>(acc, cur + (p + i - cbeg),
                                      ys + (k + 1 + i), cnt);
          i += cnt;
        }
        p += t;
        ys[k] = hkk != T(0) ? (gk - acc) / hkk : T(0);
      }
    } else {
      for (int64_t c0 = chunk; c0 < total; c0 += chunk) {
        T* const dst = (c0 / chunk) & 1 ? buf1 : buf0;
        stage_packed<T, false>(dst, H, g, m, n, c0,
                               c0 + chunk < total ? c0 + chunk : total,
                               tid - 32, blockDim.x - 32);
        __syncthreads();
      }
    }
  }
  __syncthreads();
  for (int64_t i = tid; i < m; i += blockDim.x)
    if (kYShared || i >= n) y[i] = i < n ? ys[i] : T(0);
}

// ---------------------------------------------------------- measurement

__global__ void empty_kernel() {}

__device__ __forceinline__ int64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<int64_t>(t);
}

// `reps` dependent applications of f to a; SM cycles and nanoseconds into
// out[0], out[1], the chain's end into *sink
template <typename T, typename F>
__device__ void time_chain(F f, T a, int reps, int64_t* out, T* sink) {
  T x = a;
  const int64_t n0 = global_ns();
  const int64_t c0 = clock64();
#pragma unroll 16
  for (int i = 0; i < reps; ++i) x = f(x);
  *sink = x;  // waits for the chain's end before the clocks are read
  const int64_t c1 = clock64();
  const int64_t n1 = global_ns();
  out[0] = c1 - c0;
  out[1] = n1 - n0;
}

// out[2 i], out[2 i + 1]: SM cycles and nanoseconds of `reps` dependent
// adds (i = 0), multiplies (1), divides (2) and square roots (3)
template <typename T>
__global__ void latency_probe_kernel(T a, T b, int reps, int64_t* out,
                                     T* sink) {
  time_chain([b](T x) { return x + b; }, a, reps, out, sink);
  time_chain([b](T x) { return x * b; }, a, reps, out + 2, sink + 1);
  time_chain([b](T x) { return x / b; }, a, reps, out + 4, sink + 2);
  time_chain([](T x) { return sqrt(x); }, a, reps, out + 6, sink + 3);
}

template <typename T>
int launch_givens(void* H, void* cs, void* sn, void* g, const void* col,
                  int j, int m, const void* active, void* norm,
                  const void* thr, void* done, void* hist,
                  const void* hist_base, int64_t hist_len, void* stream) {
  if (m < 1 || j < 0 || j >= m) return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0;
  int rc = optin_smem_bytes(&optin);
  if (rc) return rc;
  const int64_t staged_bytes =
      (3 * static_cast<int64_t>(j) + 3 * kBatch + 10) * sizeof(T);
  const bool staged = staged_bytes <= optin;
  const int64_t bytes = staged ? staged_bytes : 8 * sizeof(T);
  const auto kernel = staged ? givens_update_kernel<T, true>
                             : givens_update_kernel<T, false>;
  rc = allow_smem(kernel, bytes);
  if (rc) return rc;
  (void)cudaGetLastError();  // clear any stale error before this launch
  kernel<<<1, kGivensThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
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
  int optin = 0;
  int rc = optin_smem_bytes(&optin);
  if (rc) return rc;
  const int64_t size = sizeof(T);
  const int64_t ypad = (static_cast<int64_t>(m) + kBatch + 3) / 4 * 4;
  const int64_t whole = static_cast<int64_t>(m) * (m + 3) / 2;
  int64_t chunk, bytes;
  const bool streamed = (ypad + whole + kBatch) * size > optin;
  bool y_shared = true;
  if (!streamed) {  // the whole triangle
    chunk = whole;
    bytes = (ypad + whole + kBatch) * size;
  } else {          // two buffers
    y_shared = 4 * ypad * size <= optin;
    const int64_t room = optin - (y_shared ? ypad * size : 0);
    chunk = (room / (2 * size) - kBatch) / 4 * 4;
    bytes = (y_shared ? ypad : 0) * size + 2 * (chunk + kBatch) * size;
  }
  const auto kernel = !streamed ? hessenberg_backsolve_kernel<T, false, true>
                      : y_shared ? hessenberg_backsolve_kernel<T, true, true>
                                 : hessenberg_backsolve_kernel<T, true, false>;
  rc = allow_smem(kernel, bytes);
  if (rc) return rc;
  (void)cudaGetLastError();
  kernel<<<1, kBacksolveThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(H), static_cast<const T*>(g), static_cast<T*>(y),
      m, static_cast<const int64_t*>(jcount),
      static_cast<const bool*>(active), chunk, ypad);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_latency_probe(int reps, void* out, void* sink, void* stream) {
  (void)cudaGetLastError();
  latency_probe_kernel<T><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      T(1.5), T(1.0000001), reps, static_cast<int64_t*>(out),
      static_cast<T*>(sink));
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

// One empty one-block kernel of `threads` threads.
int hdtt_empty_node(int threads, void* stream) {
  (void)cudaGetLastError();
  empty_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// The latency probe (latency_probe_kernel): out holds 8 int64, sink 4 T.
int hdtt_latency_probe_f32(int reps, void* out, void* sink, void* stream) {
  return launch_latency_probe<float>(reps, out, sink, stream);
}

int hdtt_latency_probe_f64(int reps, void* out, void* sink, void* stream) {
  return launch_latency_probe<double>(reps, out, sink, stream);
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
