// Speed-of-light probes of the condensed sweeps: the primitive rate and the
// issue floor of the backward stage, on the card's own terms.
//
// Replaces, in tools/ipm_iter_sol.py (the JAX package's speed-of-light
// study):
//   measure_fma_rate     (its kernel `kern`, a 13x13x13 broadcast-FMA
//                         product chain on resident VMEM data) -> fma_chain
//   measure_stage_replay (its kernel `kern`, _kkt_c2_kernel's backward
//                         stage replayed on resident VMEM data)
//                                                           -> stage_replay
//
// Design: one thread per batch lane, 64 threads a block, the launch shape
// of the port's one-thread-per-lane sweeps, so a probe's time per lane and
// stage is what such a sweep's thread can reach at best.
//
// fma_chain computes c <- (c b) 7.6e-4 + b, `reps` times (rounded down to
// a multiple of UNROLL), the UNROLL products of a loop step unrolled: the
// products are written as the one-thread K2 wrote P A (rows in a loop the
// compiler keeps, columns and the inner sum unrolled), so c and its
// successor live in local memory (L1) as that K2's P and PA did, and b in
// registers.  `reps` is a runtime argument: no product is folded or
// dropped, and the time must grow with it (roofline/ipm_iter_sol.py
// checks that).  Bound: operations, 2 x 13^3 flops a product and lane.
//
// stage_replay runs `reps` backward stages of the one-thread-per-lane K2
// (the factorization loop as that kernel wrote it out), on the
// same stage data every stage: PA, PB, Pc, m, B'PB, Quu (R00 in its
// top-left 4x4 block, the shift on its diagonal), Qux ([S1T; 0] + B'PA),
// Qu, the packed 8x8 rsqrt Cholesky, K, kff, A'PA, Qux'K, P symmetrised,
// p.  It drops K2's stores of K, kff, L and Pc (so the compiler also drops
// kff's solve, dead without its store, as in the JAX tool's replay: ~70 of
// the stage's ~11k multiply-adds).  The stage inputs are read through lane
// views at fixed addresses every stage, so they stay in L1/L2: the card's
// counterpart of the TPU's VMEM-resident data.  Per-stage time x stages x
// waves is the issue floor of a one-thread-per-lane K2's backward phase
// (kkt_sweep_c2.cu splits a lane's stage over a thread group and is not
// bound by it).  It is written out here rather than shared as an inlined
// stage function: ptxas scheduled that form ~6% slower (PERF.md).
#include "c2_stage.cuh"

using namespace cfl;

namespace {

constexpr int UNROLL = 16;
constexpr double FMA_SCALE = 7.6e-4;

// o = (c b) FMA_SCALE + b for one lane's 13x13 c, o (local memory) and b
// (registers).
template <typename T>
__device__ __forceinline__ void fma_product(const T (&c)[NX][NX],
                                            const T (&bm)[NX][NX],
                                            T (&o)[NX][NX]) {
#pragma unroll 1
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      T s = c[i][0] * bm[0][j];
#pragma unroll
      for (int l = 1; l < NX; ++l) s = s + c[i][l] * bm[l][j];
      o[i][j] = s * T(FMA_SCALE) + bm[i][j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(64)
fma_chain_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 T* __restrict__ out, int reps, int B) {
  const int lb = blockIdx.x * blockDim.x + threadIdx.x;
  if (lb >= B) return;
  T c[NX][NX], n[NX][NX], bm[NX][NX];
  {
    auto av = lane(a, NX * NX, 0, B, lb);
    auto bv = lane(b, NX * NX, 0, B, lb);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        c[i][j] = av[i * NX + j];
        bm[i][j] = bv[i * NX + j];
      }
    }
  }
#pragma unroll 1
  for (int r = 0; r < reps / UNROLL; ++r) {
#pragma unroll
    for (int u = 0; u < UNROLL; u += 2) {
      fma_product<T>(c, bm, n);
      fma_product<T>(n, bm, c);
    }
  }
  auto ov = lane(out, NX * NX, 0, B, lb);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) ov[i * NX + j] = c[i][j];
  }
}

// The one-thread K2's stage loop without the stores of K, kff, L and Pc.
// Stage `rep` reads its inputs at stage rep * stride, and the wrapper
// passes stride 0: every stage reads the same addresses, but through an
// index the compiler cannot prove constant, so the loads stay inside the
// loop as that K2's did.  With a constant index ptxas gave the kernel 32
// registers and a 5.8 KB stack (the loop-invariant stage data kept in
// local memory, by the look of it), and the replay ran 1.5x slower than
// that K2's whole stage (PERF.md).
template <typename T>
__global__ void __launch_bounds__(64)
stage_replay_kernel(const T* __restrict__ Abar, const T* __restrict__ Bbar,
                    const T* __restrict__ cbar, const T* __restrict__ Qbar,
                    const T* __restrict__ S1T, const T* __restrict__ R00,
                    const T* __restrict__ qx, const T* __restrict__ ruu,
                    const T* __restrict__ ru, const T* __restrict__ P0,
                    const T* __restrict__ p0, T* __restrict__ Pout,
                    T* __restrict__ pout, int reps, int stride,
                    int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  T P[NX][NX], p[NX];
  {
    auto Pi = lane(P0, NX * NX, 0, B, b);
    auto pi = lane(p0, NX, 0, B, b);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) P[i][j] = Pi[i * NX + j];
      p[i] = pi[i];
    }
  }
#pragma unroll 1
  for (int rep = 0; rep < reps; ++rep) {
    const int k = rep * stride;
    auto A = lane(Abar, NX * NX, k, B, b);
    auto Bm = lane(Bbar, NX * NUC, k, B, b);

    // Pc = P_{k+1} c_k (before P is updated), m = p + Pc
    T m[NX];
    {
      auto c = lane(cbar, NX, k, B, b);
      T cv[NX];
#pragma unroll
      for (int j = 0; j < NX; ++j) cv[j] = c[j];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T s = P[i][0] * cv[0];
#pragma unroll
        for (int j = 1; j < NX; ++j) s = s + P[i][j] * cv[j];
        m[i] = p[i] + s;
      }
    }

    // Quu = B'PB + [R00 0; 0 0] + diag(ruu_shift) (lower triangle)
    T Quu[NUC][NUC];
    {
      T PB[NX][NUC];
#pragma unroll 1
      for (int i = 0; i < NX; ++i) {
#pragma unroll
        for (int a = 0; a < NUC; ++a) {
          T s = P[i][0] * Bm[a];
#pragma unroll
          for (int j = 1; j < NX; ++j) s = s + P[i][j] * Bm[j * NUC + a];
          PB[i][a] = s;
        }
      }
      auto R = lane(R00, NU * NU, k, B, b);
      auto rs = lane(ruu, NUC, k, B, b);
#pragma unroll
      for (int a = 0; a < NUC; ++a) {
#pragma unroll
        for (int a2 = 0; a2 <= a; ++a2) {
          T s = Bm[a] * PB[0][a2];
#pragma unroll
          for (int i = 1; i < NX; ++i) s = s + Bm[i * NUC + a] * PB[i][a2];
          if (a < NU) s = s + R[a * NU + a2];
          if (a == a2) s = s + rs[a];
          Quu[a][a2] = s;
        }
      }
    }

    // PA = P A;  Qux = [S1T; 0] + B' PA;  Qu = ru + B' m
    T PA[NX][NX], Qux[NUC][NX], Qu[NUC];
#pragma unroll 1
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T s = P[i][0] * A[j];
#pragma unroll
        for (int l = 1; l < NX; ++l) s = s + P[i][l] * A[l * NX + j];
        PA[i][j] = s;
      }
    }
    {
      auto S = lane(S1T, NU * NX, k, B, b);
      auto r = lane(ru, NUC, k, B, b);
#pragma unroll 1
      for (int a = 0; a < NUC; ++a) {
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T s = Bm[a] * PA[0][j];
#pragma unroll
          for (int i = 1; i < NX; ++i) s = s + Bm[i * NUC + a] * PA[i][j];
          Qux[a][j] = (a < NU) ? S[a * NX + j] + s : s;
        }
        T s = Bm[a] * m[0];
#pragma unroll
        for (int i = 1; i < NX; ++i) s = s + Bm[i * NUC + a] * m[i];
        Qu[a] = r[a] + s;
      }
    }

    // L = chol(Quu); K = -Quu^{-1} Qux; kff = -Quu^{-1} Qu
    T Lp[NLC], Kk[NUC][NX], kf[NUC];
    chol<T, NUC>(Quu, Lp);
#pragma unroll 1
    for (int j = 0; j < NX; ++j) {
      T y[NUC];
#pragma unroll
      for (int a = 0; a < NUC; ++a) y[a] = Qux[a][j];
      cho_solve<T, NUC>(Lp, y);
#pragma unroll
      for (int a = 0; a < NUC; ++a) Kk[a][j] = -y[a];
    }
#pragma unroll
    for (int a = 0; a < NUC; ++a) kf[a] = Qu[a];
    cho_solve<T, NUC>(Lp, kf);

    // P <- sym(Qbar + A'PA + Qux'K);  p <- qx + A'm + K'Qu
    {
      auto Q = lane(Qbar, NX * NX, k, B, b);
#pragma unroll 1
      for (int i = 0; i < NX; ++i) {
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T s = A[i] * PA[0][j];
#pragma unroll
          for (int l = 1; l < NX; ++l) s = s + A[l * NX + i] * PA[l][j];
          T t = Qux[0][i] * Kk[0][j];
#pragma unroll
          for (int a = 1; a < NUC; ++a) t = t + Qux[a][i] * Kk[a][j];
          P[i][j] = Q[i * NX + j] + s + t;
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
      auto q = lane(qx, NX, k, B, b);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T s = A[i] * m[0];
#pragma unroll
        for (int l = 1; l < NX; ++l) s = s + A[l * NX + i] * m[l];
        T t = Kk[0][i] * Qu[0];
#pragma unroll
        for (int a = 1; a < NUC; ++a) t = t + Kk[a][i] * Qu[a];
        p[i] = q[i] + s + t;
      }
    }
  }

  auto Po = lane(Pout, NX * NX, 0, B, b);
  auto po = lane(pout, NX, 0, B, b);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) Po[i * NX + j] = P[i][j];
    po[i] = p[i];
  }
}

inline cudaStream_t as_stream(void* s) {
  return static_cast<cudaStream_t>(s);
}

inline int lanes_grid(int B) { return (B + 63) / 64; }

}  // namespace

#define SOL_ENTRIES(SUFFIX, T)                                                \
  extern "C" int fma_chain_##SUFFIX(const T* a, const T* b, T* out,          \
                                    int reps, int B, void* stream) {         \
    fma_chain_kernel<T><<<lanes_grid(B), 64, 0, as_stream(stream)>>>(        \
        a, b, out, reps, B);                                                  \
    return static_cast<int>(cudaGetLastError());                              \
  }                                                                           \
  extern "C" int stage_replay_##SUFFIX(                                       \
      const T* Abar, const T* Bbar, const T* cbar, const T* Qbar,             \
      const T* S1T, const T* R00, const T* qx, const T* ruu, const T* ru,     \
      const T* P0, const T* p0, T* P, T* p, int reps, int stride, int B,      \
      void* stream) {                                                         \
    stage_replay_kernel<T><<<lanes_grid(B), 64, 0, as_stream(stream)>>>(      \
        Abar, Bbar, cbar, Qbar, S1T, R00, qx, ruu, ru, P0, p0, P, p, reps,    \
        stride, B);                                                           \
    return static_cast<int>(cudaGetLastError());                              \
  }                                                                           \
  extern "C" int fma_chain_occupancy_##SUFFIX(int* blocks_per_sm) {           \
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(    \
        blocks_per_sm, fma_chain_kernel<T>, 64, 0));                          \
  }                                                                           \
  extern "C" int stage_replay_occupancy_##SUFFIX(int* blocks_per_sm) {        \
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(    \
        blocks_per_sm, stage_replay_kernel<T>, 64, 0));                       \
  }

SOL_ENTRIES(f32, float)
SOL_ENTRIES(f64, double)
