// Sweeps of the uncondensed diagonal-cost QP (N stages, 13 states, 4
// inputs): the path of condense=1 and of every odd horizon.
//
// Replaces, in crazyflie_nmpc_tpu/ops/pallas/riccati_kernels.py:
//   kkt_sweep       (_kkt_kernel, _chol4, _cho_solve4, _cho_solve4_vec)
//                   -> kkt_sweep_kernel
//   corrector_sweep (_corrector_kernel) -> corrector_sweep_kernel
//   and the split forms of solve_batched(fused=False):
//   backward_sweep  (_backward_kernel) -> kkt_sweep_kernel<T, false>, the
//                   factorization without its rollout
//   forward_sweep   (_forward_kernel) -> forward_sweep_kernel
//   backward_vector_sweep (_backward_vec_kernel)
//                   -> backward_vector_sweep_kernel
// The JAX package computes the last rollout state dx[N] outside its Pallas
// kernels (an einsum after the launch); these kernels write it themselves.
//
// Design: one thread per batch lane, as for the condensed sweeps
// (condensed_c2.cu): the stage loop runs inside the thread in place of the
// sequential Pallas grid, P (13x13), p and the rollout state live in its
// registers and local memory, and the whole-horizon K_all/kff_all VMEM
// scratch becomes the K/kff outputs (corrector_sweep parks its kff in du).
// The factorization loop is written out in the kernel, the form in which
// ptxas schedules kkt_sweep_c2's loop fastest; the vector pass and the
// rollout are c2_stage.cuh's with 4 inputs.  The 4x4 Cholesky is the
// rsqrt form, packed column-major lower, [l00,l10,l20,l30,l11,l21,l31,
// l22,l32,l33] (riccati_kernels._chol4).
//
// The split forms share those bodies: backward_sweep is kkt_sweep's
// factorization loop (the same kernel template, ROLLOUT false), and the two
// others are c2_stage.cuh's rollout and vector pass, which the fused sweeps
// run too, so split and fused agree to the last bit on the same inputs.
//
// Bound on the H100: per stage and lane kkt_sweep reads ~260 values and
// writes ~90 for ~6.5k FMAs, corrector_sweep reads ~290 and writes ~20 for
// ~500: both bytes-bound in principle, but at the path's B only B threads
// run, so the latency of one thread's dependent chain over the N stages
// sets the time (PERF.md).  The split forms are bound the same way; the
// rollout alone re-reads the gains its backward launch wrote.
#include "c2_stage.cuh"

using namespace cfl;

namespace {

constexpr int NL = NU * (NU + 1) / 2;  // packed 4x4 Cholesky entries

template <typename T, bool ROLLOUT>
__global__ void __launch_bounds__(64)
kkt_sweep_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ c, const T* __restrict__ qxx,
                 const T* __restrict__ qx, const T* __restrict__ ruu,
                 const T* __restrict__ ru, const T* __restrict__ pT,
                 const T* __restrict__ pterm, const T* __restrict__ dx0,
                 T* K, T* kff, T* Lout, T* Pcout, T* dx, T* du, int N,
                 int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  // terminal cost-to-go: P = diag(pT), p = p_term
  T P[NX][NX], p[NX];
  {
    auto d = lane(pT, NX, 0, B, b);
    auto pt = lane(pterm, NX, 0, B, b);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) P[i][j] = (i == j) ? d[i] : T(0);
      p[i] = pt[i];
    }
  }

#pragma unroll 1
  for (int k = N - 1; k >= 0; --k) {
    auto Ak = lane(A, NX * NX, k, B, b);
    auto Bk = lane(Bm, NX * NU, k, B, b);

    // Pc = P_{k+1} c_k (before P is updated), m = p + Pc
    T m[NX];
    {
      auto ck = lane(c, NX, k, B, b);
      auto Pc = lane(Pcout, NX, k, B, b);
      T cv[NX];
#pragma unroll
      for (int j = 0; j < NX; ++j) cv[j] = ck[j];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T s = P[i][0] * cv[0];
#pragma unroll
        for (int j = 1; j < NX; ++j) s = s + P[i][j] * cv[j];
        Pc[i] = s;
        m[i] = p[i] + s;
      }
    }

    // Quu = B'PB + diag(ruu_shift) (lower triangle)
    T Quu[NU][NU];
    {
      T PB[NX][NU];
#pragma unroll 1
      for (int i = 0; i < NX; ++i) {
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          T s = P[i][0] * Bk[a];
#pragma unroll
          for (int j = 1; j < NX; ++j) s = s + P[i][j] * Bk[j * NU + a];
          PB[i][a] = s;
        }
      }
      auto rs = lane(ruu, NU, k, B, b);
#pragma unroll
      for (int a = 0; a < NU; ++a) {
#pragma unroll
        for (int a2 = 0; a2 <= a; ++a2) {
          T s = Bk[a] * PB[0][a2];
#pragma unroll
          for (int i = 1; i < NX; ++i) s = s + Bk[i * NU + a] * PB[i][a2];
          if (a == a2) s = s + rs[a];
          Quu[a][a2] = s;
        }
      }
    }

    // PA = P A;  Qux = B' PA (S = 0);  Qu = ru + B' m
    T PA[NX][NX], Qux[NU][NX], Qu[NU];
#pragma unroll 1
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T s = P[i][0] * Ak[j];
#pragma unroll
        for (int l = 1; l < NX; ++l) s = s + P[i][l] * Ak[l * NX + j];
        PA[i][j] = s;
      }
    }
    {
      auto r = lane(ru, NU, k, B, b);
#pragma unroll 1
      for (int a = 0; a < NU; ++a) {
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T s = Bk[a] * PA[0][j];
#pragma unroll
          for (int i = 1; i < NX; ++i) s = s + Bk[i * NU + a] * PA[i][j];
          Qux[a][j] = s;
        }
        T s = Bk[a] * m[0];
#pragma unroll
        for (int i = 1; i < NX; ++i) s = s + Bk[i * NU + a] * m[i];
        Qu[a] = r[a] + s;
      }
    }

    // L = chol(Quu); K = -Quu^{-1} Qux; kff = -Quu^{-1} Qu
    T Lp[NL], Kk[NU][NX], kf[NU];
    chol<T, NU>(Quu, Lp);
#pragma unroll 1
    for (int j = 0; j < NX; ++j) {
      T y[NU];
#pragma unroll
      for (int a = 0; a < NU; ++a) y[a] = Qux[a][j];
      cho_solve<T, NU>(Lp, y);
#pragma unroll
      for (int a = 0; a < NU; ++a) Kk[a][j] = -y[a];
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) kf[a] = Qu[a];
    cho_solve<T, NU>(Lp, kf);
    {
      auto Ko = lane(K, NU * NX, k, B, b);
      auto ko = lane(kff, NU, k, B, b);
      auto Lo = lane(Lout, NL, k, B, b);
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        kf[a] = -kf[a];
        ko[a] = kf[a];
#pragma unroll
        for (int j = 0; j < NX; ++j) Ko[a * NX + j] = Kk[a][j];
      }
#pragma unroll
      for (int t = 0; t < NL; ++t) Lo[t] = Lp[t];
    }

    // P <- sym(A'PA + Qux'K + diag(qxx));  p <- qx + A'm + K'Qu
    {
      auto q = lane(qxx, NX, k, B, b);
#pragma unroll 1
      for (int i = 0; i < NX; ++i) {
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T s = Ak[i] * PA[0][j];
#pragma unroll
          for (int l = 1; l < NX; ++l) s = s + Ak[l * NX + i] * PA[l][j];
          T t = Qux[0][i] * Kk[0][j];
#pragma unroll
          for (int a = 1; a < NU; ++a) t = t + Qux[a][i] * Kk[a][j];
          P[i][j] = (i == j) ? (s + t) + q[i] : s + t;
        }
      }
#pragma unroll 1
      for (int i = 0; i < NX; ++i) {
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          if (j > i) {
            const T v = T(0.5) * (P[i][j] + P[j][i]);
            P[i][j] = v;
            P[j][i] = v;
          }
        }
      }
      auto g = lane(qx, NX, k, B, b);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T s = Ak[i] * m[0];
#pragma unroll
        for (int l = 1; l < NX; ++l) s = s + Ak[l * NX + i] * m[l];
        T t = Kk[0][i] * Qu[0];
#pragma unroll
        for (int a = 1; a < NU; ++a) t = t + Kk[a][i] * Qu[a];
        p[i] = g[i] + s + t;
      }
    }
  }

  if constexpr (ROLLOUT)
    rollout<T, NU>(A, Bm, c, K, kff, dx0, dx, du, N, B, b);
}

template <typename T>
__global__ void __launch_bounds__(64)
corrector_sweep_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                       const T* __restrict__ c, const T* __restrict__ qx,
                       const T* __restrict__ ru, const T* __restrict__ K,
                       const T* __restrict__ L, const T* __restrict__ Pc,
                       const T* __restrict__ pterm,
                       const T* __restrict__ dx0, T* dx, T* du, int N,
                       int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  // backward vector pass on the stored factorization; kff parks in du
  vec_sweep<T, NU>(A, Bm, qx, ru, K, L, Pc, pterm, du, N, B, b);
  rollout<T, NU>(A, Bm, c, K, du, dx0, dx, du, N, B, b);
}

// The split sweeps (fused=False): the rollout alone from stored gains, and
// the backward vector pass alone on the stored factorization.
template <typename T>
__global__ void __launch_bounds__(64)
forward_sweep_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ c, const T* __restrict__ K,
                     const T* __restrict__ kff, const T* __restrict__ dx0,
                     T* __restrict__ dx, T* __restrict__ du, int N, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  rollout<T, NU>(A, Bm, c, K, kff, dx0, dx, du, N, B, b);
}

template <typename T>
__global__ void __launch_bounds__(64)
backward_vector_sweep_kernel(const T* __restrict__ A,
                             const T* __restrict__ Bm,
                             const T* __restrict__ qx,
                             const T* __restrict__ ru,
                             const T* __restrict__ K, const T* __restrict__ L,
                             const T* __restrict__ Pc,
                             const T* __restrict__ pterm,
                             T* __restrict__ kff, int N, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  vec_sweep<T, NU>(A, Bm, qx, ru, K, L, Pc, pterm, kff, N, B, b);
}

inline cudaStream_t as_stream(void* s) {
  return static_cast<cudaStream_t>(s);
}

inline int lanes_grid(int B) { return (B + 63) / 64; }

}  // namespace

#define RICCATI_ENTRIES(SUFFIX, T)                                            \
  extern "C" int kkt_sweep_##SUFFIX(                                          \
      const T* A, const T* Bm, const T* c, const T* qxx, const T* qx,         \
      const T* ruu, const T* ru, const T* pT, const T* pterm, const T* dx0,   \
      T* K, T* kff, T* L, T* Pc, T* dx, T* du, int N, int B, void* stream) {  \
    kkt_sweep_kernel<T, true><<<lanes_grid(B), 64, 0, as_stream(stream)>>>(   \
        A, Bm, c, qxx, qx, ruu, ru, pT, pterm, dx0, K, kff, L, Pc, dx, du, N, \
        B);                                                                   \
    return static_cast<int>(cudaGetLastError());                              \
  }                                                                           \
  extern "C" int backward_sweep_##SUFFIX(                                     \
      const T* A, const T* Bm, const T* c, const T* qxx, const T* qx,         \
      const T* ruu, const T* ru, const T* pT, const T* pterm, T* K, T* kff,   \
      T* L, T* Pc, int N, int B, void* stream) {                              \
    kkt_sweep_kernel<T, false><<<lanes_grid(B), 64, 0, as_stream(stream)>>>(  \
        A, Bm, c, qxx, qx, ruu, ru, pT, pterm, nullptr, K, kff, L, Pc,        \
        nullptr, nullptr, N, B);                                              \
    return static_cast<int>(cudaGetLastError());                              \
  }                                                                           \
  extern "C" int forward_sweep_##SUFFIX(const T* A, const T* Bm, const T* c,  \
                                        const T* K, const T* kff,             \
                                        const T* dx0, T* dx, T* du, int N,    \
                                        int B, void* stream) {                \
    forward_sweep_kernel<T><<<lanes_grid(B), 64, 0, as_stream(stream)>>>(     \
        A, Bm, c, K, kff, dx0, dx, du, N, B);                                 \
    return static_cast<int>(cudaGetLastError());                              \
  }                                                                           \
  extern "C" int backward_vector_sweep_##SUFFIX(                              \
      const T* A, const T* Bm, const T* qx, const T* ru, const T* K,          \
      const T* L, const T* Pc, const T* pterm, T* kff, int N, int B,          \
      void* stream) {                                                         \
    backward_vector_sweep_kernel<T>                                           \
        <<<lanes_grid(B), 64, 0, as_stream(stream)>>>(A, Bm, qx, ru, K, L,    \
                                                      Pc, pterm, kff, N, B);  \
    return static_cast<int>(cudaGetLastError());                              \
  }                                                                           \
  extern "C" int corrector_sweep_##SUFFIX(                                    \
      const T* A, const T* Bm, const T* c, const T* qx, const T* ru,          \
      const T* K, const T* L, const T* Pc, const T* pterm, const T* dx0,      \
      T* dx, T* du, int N, int B, void* stream) {                             \
    corrector_sweep_kernel<T><<<lanes_grid(B), 64, 0, as_stream(stream)>>>(   \
        A, Bm, c, qx, ru, K, L, Pc, pterm, dx0, dx, du, N, B);                \
    return static_cast<int>(cudaGetLastError());                              \
  }

RICCATI_ENTRIES(f32, float)
RICCATI_ENTRIES(f64, double)
