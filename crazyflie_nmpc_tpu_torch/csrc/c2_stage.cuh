// Stage bodies of the block-2 condensed sweeps.  kkt_sweep_c2.cu (K2 and
// K5a bwd_c2), corrector_sweep_c2.cu (K3, K5b fwd_c2 and K5c bwd_vec_c2),
// iter_c2.cu (K10 iter_sweep_c2) and riccati.cu (K8a, K9a, K9b, K8b, K9c)
// take chol / cho_solve from here, and split the rest of their stages over
// a thread group, keeping the order of operations of vec_stage and
// rollout_stage below (the one-thread-per-lane stage bodies they
// replaced, kept as that order's statement).  The vector pass and the
// rollout take the input width nu as a template argument (NUC by default,
// the condensed sweeps' width; 4 in riccati.cu).
//
// Counterparts of the per-stage math of
// crazyflie_nmpc_tpu/ops/pallas/condensed_kernels.py (_corr_c2_kernel,
// _bwd_vec_c2_kernel, _fwd_c2_kernel; _chol_n, _cho_solve_n_vec, _pk).
// In these bodies one thread owns one batch lane: p and the rollout state
// live in its registers.  The fused and split sweeps evaluate the same
// formulas in the same order, and agree to the last bit on the same
// inputs.
#pragma once

#include "batch_last.cuh"

namespace cfl {

// Unrolled n x n Cholesky of the lower triangle of Q -> packed L
// (rsqrt formulation of condensed_kernels._chol_n: L_jj = s * rsqrt(s)).
template <typename T, int n>
__device__ __forceinline__ void chol(const T (&Q)[n][n], T* L) {
#pragma unroll
  for (int j = 0; j < n; ++j) {
    T s = Q[j][j];
#pragma unroll
    for (int t = 0; t < j; ++t) s = s - L[pk(j, t, n)] * L[pk(j, t, n)];
    const T inv = rsqrt_t(s);
    L[pk(j, j, n)] = s * inv;
#pragma unroll
    for (int i = j + 1; i < n; ++i) {
      T r = Q[i][j];
#pragma unroll
      for (int t = 0; t < j; ++t) r = r - L[pk(i, t, n)] * L[pk(j, t, n)];
      L[pk(i, j, n)] = r * inv;
    }
  }
}

// Solve (L L^T) x = y in place, packed L (an array, or a view indexed the
// same way), reciprocal-diagonal substitution
// (condensed_kernels._cho_solve_n_vec).
template <typename T, int n, typename VL>
__device__ __forceinline__ void cho_solve(const VL& L, T* y) {
  T inv[n];
#pragma unroll
  for (int i = 0; i < n; ++i) inv[i] = T(1) / L[pk(i, i, n)];
#pragma unroll
  for (int i = 0; i < n; ++i) {
    T s = y[i];
#pragma unroll
    for (int t = 0; t < i; ++t) s = s - L[pk(i, t, n)] * y[t];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = n - 1; i >= 0; --i) {
    T s = y[i];
#pragma unroll
    for (int t = i + 1; t < n; ++t) s = s - L[pk(t, i, n)] * y[t];
    y[i] = s * inv[i];
  }
}

// One stage of the backward vector pass on the stored factorization
// (K, L, Pc of stage k): m = p + Pc, Qu = r + B'm, kff = -Quu^{-1} Qu,
// p <- q + A'm + K'Qu.  A, B, K, Pc, L and the linear input term r are
// lane views.
template <typename T, int nu = NUC, typename VA, typename VB, typename VK,
          typename VP, typename VL, typename V>
__device__ __forceinline__ void vec_stage(
    VA A, VB Bm, VK Kk, VP Pck, VL Lk, LaneRef<const T> q,
    const V& r, T (&p)[NX], LaneRef<T> kff) {
  constexpr int nl = nu * (nu + 1) / 2;
  T m[NX], Qu[nu], kf[nu], Lp[nl];
#pragma unroll
  for (int i = 0; i < NX; ++i) m[i] = p[i] + Pck[i];
#pragma unroll
  for (int a = 0; a < nu; ++a) {
    T s = Bm[a] * m[0];
#pragma unroll
    for (int i = 1; i < NX; ++i) s = s + Bm[i * nu + a] * m[i];
    Qu[a] = r[a] + s;
    kf[a] = Qu[a];
  }
#pragma unroll
  for (int t = 0; t < nl; ++t) Lp[t] = Lk[t];
  cho_solve<T, nu>(Lp, kf);
#pragma unroll
  for (int a = 0; a < nu; ++a) kff[a] = -kf[a];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    T s = A[i] * m[0];
#pragma unroll
    for (int l = 1; l < NX; ++l) s = s + A[l * NX + i] * m[l];
    T t = Kk[i] * Qu[0];
#pragma unroll
    for (int a = 1; a < nu; ++a) t = t + Kk[a * NX + i] * Qu[a];
    p[i] = q[i] + s + t;
  }
}

// One rollout stage: u = K x + kff, xn = A x + B u + c (A, B, c and K lane
// views as in vec_stage).
template <typename T, int nu = NUC, typename VA, typename VB, typename VC,
          typename VK>
__device__ __forceinline__ void rollout_stage(
    VA A, VB Bm, VC c, VK Kk, LaneRef<const T> kff, const T (&x)[NX],
    T (&u)[nu], T (&xn)[NX]) {
#pragma unroll
  for (int a = 0; a < nu; ++a) {
    T s = Kk[a * NX] * x[0];
#pragma unroll
    for (int j = 1; j < NX; ++j) s = s + Kk[a * NX + j] * x[j];
    u[a] = s + kff[a];
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    T s = A[i * NX] * x[0];
#pragma unroll
    for (int j = 1; j < NX; ++j) s = s + A[i * NX + j] * x[j];
    T t = Bm[i * nu] * u[0];
#pragma unroll
    for (int a = 1; a < nu; ++a) t = t + Bm[i * nu + a] * u[a];
    xn[i] = s + t + c[i];
  }
}

}  // namespace cfl
