// Shared pieces of the port's batch-last CUDA kernels.
//
// Layout (the JAX package's): every array is batch-last, (stage, n, m, B)
// with B contiguous.  One thread owns one batch lane b; element (r) of a
// lane's slice of an (..., B) array sits at ptr[r * B + b], so a warp's
// loads of one entry are 32 consecutive words (coalesced).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// CFL_ASM(card, cpu): the inline-asm statement `card` in the CUDA build, and
// `cpu` in the CPU rehearsal (csrc/emu, which defines CFL_EMULATED).
#ifdef CFL_EMULATED
#define CFL_ASM(card, cpu) cpu
#else
#define CFL_ASM(card, cpu) card
#endif

namespace cfl {

constexpr int NX = 13;            // states
constexpr int NU = 4;             // inputs
constexpr int NY = NX + NU;       // stage reference
constexpr int NUC = 2 * NU;       // condensed (stacked) inputs
constexpr int NLC = NUC * (NUC + 1) / 2;  // packed 8x8 Cholesky entries
constexpr int NPARAM = 9;         // g0, mq, Ixx, Iyy, Izz, Cd, Ct, l, dt

// Packed index of L[i][j] (i >= j), column-major lower
// (condensed_kernels._pk).
__host__ __device__ constexpr int pk(int i, int j, int n) {
  return j * n - j * (j - 1) / 2 + (i - j);
}

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

// A lane's view of a batch-last array: v[r] is entry r of this lane.
template <typename T>
struct LaneRef {
  T* p;
  int B;
  __device__ __forceinline__ T& operator[](int r) const { return p[r * B]; }
};

template <typename T>
__device__ __forceinline__ LaneRef<T> lane(T* base, int stage_size, int k,
                                           int B, int b) {
  return LaneRef<T>{base + (size_t)k * stage_size * B + b, B};
}

// Conversion between a stored stream's type S and the compute type D.
// bfloat16 is rounded from float, a double through float first: PyTorch's
// and XLA's host casts round float64 -> float32 -> bfloat16, and a direct
// double rounding (__double2bfloat16) would differ from them.
template <typename D, typename S>
__device__ __forceinline__ D cvt(S v) { return static_cast<D>(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16, float>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16, double>(double v) {
  return __float2bfloat16_rn(static_cast<float>(v));
}
template <>
__device__ __forceinline__ float cvt<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ double cvt<double, __nv_bfloat16>(__nv_bfloat16 v) {
  return static_cast<double>(__bfloat162float(v));
}

}  // namespace cfl

// Message for a code returned by an entry point (ctypes reads it).
extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
