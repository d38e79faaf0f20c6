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
// fma_chain computes c <- (c b) 7.6e-4 + b, `reps` times (rounded down to
// a multiple of UNROLL), from c = a.  Bound: operations, 2 x 13^3 flops a
// product and lane.  It is the primitive rate of the port's sweeps, which
// give each lane a group of threads (kkt_sweep_c2.cu, corrector_sweep_c2.cu,
// riccati.cu): here a group of kFmaGroup = 16 threads a lane (K2's G),
// kFmaLanes = 8 lanes a block (K2's block).  Row i of the next c depends
// only on row i of c and on b, so the 13 rows are 13 independent chains:
// thread i < 13 of a group holds row i of c in registers for the whole
// chain (threads 13-15 idle after b lands; kFmaRows > 1 gives a thread
// several rows, a study variant), and no thread needs another's results
// between products.  b lands once in shared memory, its rows at a
// pitch of 16 and each lane's 13 rows one 16-byte pad apart (the lanes of
// a warp then read other banks); every thread of a group reads a row of b
// with the same 16-byte loads (a broadcast), about 3 multiply-adds a load.
// One barrier, after b lands; the stores go out at the end.  Each entry's
// sum runs in the one-thread kernel's order, then s 7.6e-4 + b, so the
// output equals that kernel's bit for bit.  FP32 (FP64) FMAs on the CUDA
// cores: no tensor cores, no TF32, as the group sweeps are built.  The
// product's loads of b sit behind an index the compiler cannot prove
// constant (an empty asm on it), so they stay inside the chain and b is
// not hoisted into registers.  `reps` is a runtime argument: no product is
// folded or dropped, and the time must grow with it
// (roofline/ipm_iter_sol.py checks that).  One thread per lane, its form
// before, held c, its successor and b (507 values) at 255 registers with
// spills in both dtypes: 1.64-1.74 ms at B=4096 for 512 products, 11x the
// bound.  This form takes 0.60 ms there, 4.1x the bound (H100 80GB HBM3,
// 700 W; roofline/kkt_variants.py, PERF.md): each of a row's 13 x 13
// multiply-adds a product takes its b entry from shared memory, 56
// 16-byte loads a warp and product for 182 multiply-adds, and the loads
// of b, not the multiply-adds, set its time.  Two rows a thread (half the
// loads) was no faster (0.635 ms: two warps a scheduler do not hide the
// loads' latency), four rows a thread faster (0.456, 146 registers).
// The wrapper (ops/cuda/sol_kernels.fma_launch_geometry) computes grid,
// block and shared bytes; the launch refuses numbers that disagree with
// these.  Ragged tiles: spare lanes read lane B-1, store nothing, and take
// part in the barrier.
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
// bound by it).  One thread per lane, 64 threads a block, the launch shape
// of the port's one-thread-per-lane sweeps.  It is written out here rather
// than shared as an inlined stage function: ptxas scheduled that form ~6%
// slower (PERF.md).
#include <algorithm>

#include "c2_stage.cuh"

using namespace cfl;

namespace {

constexpr int UNROLL = 16;
constexpr double FMA_SCALE = 7.6e-4;

// fma_chain's launch shape: kFmaGroup threads a lane, each holding
// kFmaRows rows of c (thread t of a block is lane t / kFmaGroup, its rows
// from (t % kFmaGroup) kFmaRows on), kFmaThreads a block; b's 13 rows at a
// pitch of 16, a 16-byte pad after each lane's (kFmaLaneValues values a
// lane in either dtype)
constexpr int kFmaRows = 1;
constexpr int kFmaGroup = 16;
constexpr int kFmaThreads = 128;
constexpr int kFmaLanes = kFmaThreads / kFmaGroup;
constexpr int kFmaLaneValues = NX * 16 + 4;
static_assert(kFmaGroup * kFmaRows >= NX && kFmaThreads % kFmaGroup == 0,
              "a group holds a lane's 13 rows");
static_assert(kFmaLaneValues == 212,
              "fma_launch_geometry's FMA_LANE_VALUES");

template <typename T>
constexpr int fma_smem() {
  return kFmaLanes * kFmaLaneValues * static_cast<int>(sizeof(T));
}

// What __launch_bounds__ asks for: 1024 rows an SM in float32 (64
// registers a row), 512 in float64.
template <typename T>
constexpr int fma_min_blocks() {
  return std::max(1, (sizeof(T) == 4 ? 1024 : 512) / (kFmaThreads * kFmaRows));
}

template <typename T>
struct alignas(16) Pack {
  T v[16 / sizeof(T)];
};

// Row k of b at bl (pitch 16), a pack a load.
template <typename T>
__device__ __forceinline__ void b_row(const T* bl, int k, T (&bk)[16]) {
  constexpr int P = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < NX; q += P) {
    const Pack<T> v = *reinterpret_cast<const Pack<T>*>(bl + k * 16 + q);
#pragma unroll
    for (int t = 0; t < P; ++t) bk[q + t] = v.v[t];
  }
}

// c <- (c b) FMA_SCALE + b for rows i0.. of a lane's c (a row past the
// 13th is held as zeros and adds row 12 of b), b's rows at bl.
template <typename T>
__device__ __forceinline__ void fma_product(const T* bl, int i0,
                                            T (&c)[kFmaRows][NX]) {
  T s[kFmaRows][NX], bk[16];
#pragma unroll
  for (int k = 0; k < NX; ++k) {
    b_row(bl, k, bk);
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r) {
#pragma unroll
      for (int j = 0; j < NX; ++j)
        s[r][j] = k ? s[r][j] + c[r][k] * bk[j] : c[r][k] * bk[j];
    }
  }
#pragma unroll
  for (int r = 0; r < kFmaRows; ++r) {
    b_row(bl, min(i0 + r, NX - 1), bk);
#pragma unroll
    for (int j = 0; j < NX; ++j) c[r][j] = s[r][j] * T(FMA_SCALE) + bk[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kFmaThreads, fma_min_blocks<T>())
fma_chain_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 T* __restrict__ out, int reps, int B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sh = reinterpret_cast<T*>(smem_raw);
  const int l = threadIdx.x / kFmaGroup;
  const int i0 = threadIdx.x % kFmaGroup * kFmaRows;  // this thread's rows
  const int b0 = blockIdx.x * kFmaLanes;
  const int lb = min(b0 + l, B - 1);
  // b lands: entry (r, k) of lane ll at sh[ll kFmaLaneValues + 16 r + k],
  // consecutive threads on consecutive lanes, every load issued before
  // the first store
  constexpr int kTurns = (kFmaLanes * NX * NX + kFmaThreads - 1) / kFmaThreads;
  T v[kTurns];
#pragma unroll
  for (int n = 0; n < kTurns; ++n) {
    const int t = threadIdx.x + n * kFmaThreads;
    if (t < kFmaLanes * NX * NX)
      v[n] = b[(size_t)(t / kFmaLanes) * B + min(b0 + t % kFmaLanes, B - 1)];
  }
#pragma unroll
  for (int n = 0; n < kTurns; ++n) {
    const int t = threadIdx.x + n * kFmaThreads;
    const int ll = t % kFmaLanes, rk = t / kFmaLanes;
    if (t < kFmaLanes * NX * NX)
      sh[ll * kFmaLaneValues + rk / NX * 16 + rk % NX] = v[n];
  }
  T c[kFmaRows][NX];
#pragma unroll
  for (int r = 0; r < kFmaRows; ++r) {
#pragma unroll
    for (int k = 0; k < NX; ++k)
      c[r][k] = i0 + r < NX ? a[(size_t)((i0 + r) * NX + k) * B + lb] : T(0);
  }
  __syncthreads();
  if (i0 >= NX) return;
  int off = l * kFmaLaneValues;
#pragma unroll 1
  for (int r = 0; r < reps / UNROLL; ++r) {
#pragma unroll 1
    for (int u = 0; u < UNROLL; ++u) {
      asm volatile("" : "+r"(off));  // b's loads stay in the chain
      fma_product<T>(sh + off, i0, c);
    }
  }
#pragma unroll
  for (int r = 0; r < kFmaRows; ++r) {
    if (i0 + r < NX && b0 + l < B) {
#pragma unroll
      for (int k = 0; k < NX; ++k)
        out[(size_t)((i0 + r) * NX + k) * B + lb] = c[r][k];
    }
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

template <typename T>
int fma_opt_in() {
  if (fma_smem<T>() <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fma_chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      fma_smem<T>()));
}

// fma_chain's launch: grid, threads and smem are the wrapper's
// fma_launch_geometry; another is refused
template <typename T>
int fma_chain_launch(const T* a, const T* b, T* out, int reps, int B,
                     int grid, int threads, int smem, void* stream) {
  if (B < 1 || reps < 0 || threads != kFmaThreads || smem != fma_smem<T>() ||
      grid != (B + kFmaLanes - 1) / kFmaLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = fma_opt_in<T>();
  if (err != 0) return err;
  fma_chain_kernel<T><<<grid, threads, smem, as_stream(stream)>>>(a, b, out,
                                                                   reps, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SOL_ENTRIES(SUFFIX, T)                                                \
  extern "C" int fma_chain_##SUFFIX(const T* a, const T* b, T* out,          \
                                    int reps, int B, int grid, int threads,  \
                                    int smem, void* stream) {                \
    return fma_chain_launch<T>(a, b, out, reps, B, grid, threads, smem,       \
                               stream);                                       \
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
    const int err = fma_opt_in<T>();                                          \
    if (err != 0) return err;                                                 \
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(    \
        blocks_per_sm, fma_chain_kernel<T>, kFmaThreads, fma_smem<T>()));     \
  }                                                                           \
  extern "C" int stage_replay_occupancy_##SUFFIX(int* blocks_per_sm) {        \
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(    \
        blocks_per_sm, stage_replay_kernel<T>, 64, 0));                       \
  }

SOL_ENTRIES(f32, float)
SOL_ENTRIES(f64, double)
