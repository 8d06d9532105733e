// Epilogues of the SpMV kernels (csrc/dia_spmv.cu, csrc/csr_spmv.cu).
//
// The last kernel of a matvec y = A·x may store, in place of y, one of a
// small closed set of expressions of y, computed in registers from vectors
// it reads at the same row.  They are the vector chains of the AMG and MGR
// cycles and of the Chebyshev recurrence (precon/amg/cycle.py,
// precon/chebyshev.py, precon/mgr.py), which as torch operations each
// wrote a vector that the next one read back:
//
//   kResidual   out = b − y;  with out2 also out2 = (u ⊙ out) · s0
//               (the Chebyshev start z₀ = u ⊙ r / θ, s0 = 1/θ)
//   kChebyshev  rk = u ⊙ (b − y);  d' = s0·d + s1·rk;  z' = x + d'
//               (b = r, x = z); with x2: out = x2 + z' (the sweep's last
//               step), else out = z' and, with out2, out2 = d'
//   kJacobi     out = x + u ⊙ (b − y)
//   kAdd        out = x + y
//
// Rounding: each operation is rounded on its own, in the order the torch
// chain computes it, with the _rn intrinsics, so that no product is
// contracted into an add: the result equals the chain's bit for bit.  The
// SpMV's own sum is left to the source's flags, as for the plain matvec.
// torch divides a CUDA tensor by a Python scalar as a product with the
// scalar's reciprocal, taken in double and rounded to the tensor's type,
// so s0 of kResidual is that reciprocal; the host computes it
// (ops/epilogue.py).
//
// Inputs are read-only for the whole launch and no output aliases an
// input or another output (the wrappers allocate the outputs).

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace hdtt {

enum EpilogueKind : int32_t {
  kResidual = 1,
  kChebyshev = 2,
  kJacobi = 3,
  kAdd = 4,
};

// The C layout of ops/epilogue.py's EpilogueArgs; the scalars in double,
// converted to the vectors' type on the host as torch converts a Python
// scalar (round to nearest).
struct EpilogueArgs {
  int32_t kind;
  int32_t pad;
  const void* b;
  const void* u;
  const void* x;
  const void* d;
  const void* x2;
  void* out;
  void* out2;
  double s0;
  double s1;
};

template <typename T>
struct Epilogue {
  int kind;
  const T* b;
  const T* u;
  const T* x;
  const T* d;
  const T* x2;
  T* out;
  T* out2;
  T s0, s1;
};

template <typename T>
inline Epilogue<T> typed(const EpilogueArgs& a) {
  return {a.kind,
          static_cast<const T*>(a.b),
          static_cast<const T*>(a.u),
          static_cast<const T*>(a.x),
          static_cast<const T*>(a.d),
          static_cast<const T*>(a.x2),
          static_cast<T*>(a.out),
          static_cast<T*>(a.out2),
          static_cast<T>(a.s0),
          static_cast<T>(a.s1)};
}

inline bool valid(const EpilogueArgs& a) {
  switch (a.kind) {
    case kResidual:
      return a.b && a.out && (!a.out2 || a.u);
    case kChebyshev:
      return a.b && a.u && a.x && a.d && a.out;
    case kJacobi:
      return a.b && a.u && a.x && a.out;
    case kAdd:
      return a.x && a.out;
    default:
      return false;
  }
}

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float prod_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double prod_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// row r's epilogue on its matvec value y
template <typename T>
__device__ __forceinline__ void apply(const Epilogue<T>& e, int64_t r, T y) {
  switch (e.kind) {
    case kResidual: {
      const T res = sub_rn(__ldg(e.b + r), y);
      e.out[r] = res;
      if (e.out2) e.out2[r] = prod_rn(prod_rn(__ldg(e.u + r), res), e.s0);
      break;
    }
    case kChebyshev: {
      const T rk = prod_rn(__ldg(e.u + r), sub_rn(__ldg(e.b + r), y));
      const T dn = add_rn(prod_rn(e.s0, __ldg(e.d + r)), prod_rn(e.s1, rk));
      const T zn = add_rn(__ldg(e.x + r), dn);
      if (e.x2) {
        e.out[r] = add_rn(__ldg(e.x2 + r), zn);
      } else {
        e.out[r] = zn;
        if (e.out2) e.out2[r] = dn;
      }
      break;
    }
    case kJacobi:
      e.out[r] = add_rn(__ldg(e.x + r),
                        prod_rn(__ldg(e.u + r), sub_rn(__ldg(e.b + r), y)));
      break;
    default:  // kAdd
      e.out[r] = add_rn(__ldg(e.x + r), y);
      break;
  }
}

}  // namespace hdtt
