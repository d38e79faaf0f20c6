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
// stage_replay runs `reps` backward stages of K2 on K2's own design, on
// the same stage data every stage: PA, PB, Pc, m, B'PB, Quu (R00 in its
// top-left 4x4 block, the shift on its diagonal), Qux ([S1T; 0] + B'PA),
// Qu, the packed 8x8 rsqrt Cholesky, K, kff, A'PA, Qux'K, P symmetrised,
// p.  K2's group and block: kGroup = 16 threads a lane, kLanes = 8 lanes
// a block (kThreads = 128), the lane's slots at kStride = 1548 values, K2's
// layout (49,536 bytes a block in float32, 4 blocks and 32 lanes an SM:
// B=4096 is one wave; 99,072 in float64, 2 blocks), both over 48 KB, so the
// launch sets the opt-in attribute.  The stage inputs land once, before
// the loop, through K2's stage_in (stage k = 0) into K2's slots, A and B̄
// transposed, and the cost-to-go (P0, p0) into P and p: the card's
// counterpart of the TPU's VMEM-resident data.  Then `reps` times K2's
// phases A-D with their barriers, exactly as kkt_sweep_c2.cu runs them
// (its text, copied: tests/test_torch_roofline.py holds the two equal);
// kff's solve stays (thread 13, beside K's columns), and K2's stores of its
// gains are dropped, as the JAX tool's replay drops its stores.  P and p go
// out once, at the end, in the flat (entry, lane) order of K2's stage_out.
// So its per-stage time is the floor of K2's backward stage under K2's own
// design with no HBM traffic: K2's measured backward stage less it is
// K2's loads and stores.  A ragged tile's spare groups read lane B-1,
// store nothing, and take part in every barrier.  The wrapper
// (ops/cuda/sol_kernels.replay_launch_geometry) computes grid, block and
// shared bytes; the launch refuses numbers that disagree with these.
// The phases are a copy, not shared with kkt_sweep_c2.cu: moved into a
// header that both include (as one function with the prefetch and the
// gains' stores as hooks, and as three functions with them in between),
// they gave K5a's float32 form 127 registers instead of its 128 and
// changed the SASS of every K2 and K5a form, though their outputs stayed
// bit for bit (PERF.md).  `ptxas -v`: 96 registers in float32, 148
// in float64, no spills.  60 stages take 0.352 / 0.637 / 1.272 ms at B =
// 1024 / 4096 / 8192 in float32, 11.0-11.4 us a stage at 4096, 8.0x the
// bound by operations; its phases A, B, C and D take 33 / 20 / 10 / 28%
// of it (H100 80GB HBM3, 700 W; roofline/kkt_variants.py --kernel
// stage_replay, roofline/ipm_iter_sol.py).  At B=1024 one block an SM
// leaves four warps to hide each thread's shared-memory chain.  Its form
// before, one thread a lane (64 a block), held the stage's chain of ~11k
// multiply-adds in one thread: 255 registers in float32 with spills,
// 2.547 / 2.686 / 4.132 ms at the same B.
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

// stage_replay's copy of K2's group pieces (kkt_sweep_c2.cu): its launch
// shape, its lane's slots (the backward pass's; K2's rollout slots, which
// the replay does not use, are left out) and its copies in and out.
constexpr int kGroup = 16;                 // threads per lane
constexpr int kThreads = 128;              // threads per block
constexpr int kLanes = kThreads / kGroup;  // lanes per block

// One lane's shared-memory slots (offsets in values of the compute type).
namespace slot {
// Rows of 13 are padded to 16 values and rows of 8 start every 8, each
// row 16-byte aligned, so a row is read with 16-byte vector loads
// (ld_row).  A, B and the products the stage reads by column are kept
// transposed: AT row j is column j of Abar, PAT row j column j of P A.
constexpr int RW = 16;                  // the pitch of a 13-row
constexpr int P = 0;                    // P (13 rows)
constexpr int PAT = P + NX * RW;        // (P A)^T (13 rows)
constexpr int PBT = PAT + NX * RW;      // (P B)^T (8 rows)
constexpr int AT = PBT + NUC * RW;      // Abar^T (13 rows)
constexpr int BT = AT + NX * RW;        // Bbar^T (8 rows)
constexpr int QUXT = BT + NUC * RW;     // Qux^T (13 rows of 8)
constexpr int KT = QUXT + NX * NUC;     // K^T (13 rows of 8)
constexpr int QUU = KT + NX * NUC;      // Quu (8x8, lower triangle)
constexpr int L = QUU + NUC * NUC;      // packed Cholesky factor (36 of 40)
constexpr int PV = L + 40;              // p
constexpr int MV = PV + RW;             // m = p + Pc
constexpr int PC = MV + RW;             // Pc = P c
constexpr int C = PC + RW;              // cbar
constexpr int QU = C + RW;              // Qu (8)
constexpr int KFF = QU + NUC;           // kff (8)
constexpr int Q = KFF + NUC;            // Qbar (13x13, unpadded)
constexpr int S = Q + 172;              // S1T (4x13)
constexpr int R = S + NU * NX;          // R00 (4x4)
constexpr int QX = R + NU * NU;         // qbar
constexpr int RS = QX + RW;             // the shifted R̄ diagonal (8)
constexpr int RU = RS + NUC;            // rbar (8)
constexpr int END = RU + NUC;
static_assert(PAT % 8 == 0 && PBT % 8 == 0 && AT % 8 == 0 && BT % 8 == 0 &&
                  QUXT % 8 == 0 && KT % 8 == 0 && PV % 8 == 0 &&
                  MV % 8 == 0 && PC % 8 == 0 && C % 8 == 0 && QU % 8 == 0,
              "rows start 16-byte aligned in both dtypes");
}  // namespace slot

// 1548 a lane: 16-byte aligned, and two lanes' same entry 12 banks apart
constexpr int kStride = slot::END + 4;
static_assert(kStride == 1548, "replay_launch_geometry's REPLAY_LANE_VALUES");

// Global -> shared copies that hold no registers: each thread keeps all
// its copies of a stage in flight (cp.async), and copy_wait() waits for
// them; __syncthreads() after it makes every thread's copies visible.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  CFL_ASM(asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                           static_cast<unsigned>(
                               __cvta_generic_to_shared(dst))),
                       "l"(src), "n"(sizeof(T))
                       : "memory"),
          *dst = *src);
}
__device__ __forceinline__ void copy_wait() {
  CFL_ASM(asm volatile("cp.async.wait_all;\n" ::: "memory"), (void)0);
}

// Entries [0, n) of a batch-last input (one stage) into every lane's slot
// `dst`, entry r at dst + r, or with NCOL > 0 (an input of rows of NCOL)
// transposed, entry (i, j) at dst + j PITCH + i: K2's stage_in at k = 0 on
// the compute type, thread f of the flat (entry, lane) order taking entry
// f / kLanes of lane f % kLanes.  copy_wait() before use.
template <int NCOL = 0, int PITCH = 0, typename T>
__device__ __forceinline__ void stage_in(T* sh, int dst, const T* src,
                                         int n, int B, int b0) {
#pragma unroll 4
  for (int f = threadIdx.x; f < n * kLanes; f += kThreads) {
    const int r = f / kLanes, l = f % kLanes;
    const int at = NCOL ? (r % NCOL) * PITCH + r / NCOL : r;
    copy_async(sh + l * kStride + dst + at,
               src + (size_t)r * B + min(b0 + l, B - 1));
  }
}

// Every lane's slot `src` (rows of `cols` at a pitch of `pitch`) into
// entries [0, n) of a batch-last output, in K2's stage_out order; a ragged
// tile's spare lanes store nothing.
template <typename T>
__device__ __forceinline__ void stage_out(T* dst, const T* sh, int src,
                                          int n, int cols, int pitch, int B,
                                          int b0) {
  for (int f = threadIdx.x; f < n * kLanes; f += kThreads) {
    const int r = f / kLanes, l = f % kLanes;
    if (b0 + l < B)
      dst[(size_t)r * B + b0 + l] =
          sh[l * kStride + src + r / cols * pitch + r % cols];
  }
}

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };
__device__ __forceinline__ void unpack(const float4& v, float* e) {
  e[0] = v.x;
  e[1] = v.y;
  e[2] = v.z;
  e[3] = v.w;
}
__device__ __forceinline__ void unpack(const double2& v, double* e) {
  e[0] = v.x;
  e[1] = v.y;
}

// x = p[0, n) of a 16-byte aligned row, read in 16-byte vectors (up to
// the row's padding).
template <int n, typename T>
__device__ __forceinline__ void ld_row(const T* p, T (&x)[n]) {
  constexpr int per = 16 / static_cast<int>(sizeof(T));
  constexpr int nv = (n + per - 1) / per;
  T e[nv * per];
#pragma unroll
  for (int v = 0; v < nv; ++v)
    unpack(reinterpret_cast<const typename Vec16<T>::type*>(p)[v],
           e + v * per);
#pragma unroll
  for (int i = 0; i < n; ++i) x[i] = e[i];
}

// x[0] y[0] + x[1] y[1] + ..., in that order
template <int n, typename T>
__device__ __forceinline__ T dot(const T (&x)[n], const T (&y)[n]) {
  T s = x[0] * y[0];
#pragma unroll
  for (int i = 1; i < n; ++i) s = s + x[i] * y[i];
  return s;
}

// stage_replay's shared bytes a block: K2's lane (kStride values)
template <typename T>
constexpr int replay_smem() {
  return kLanes * kStride * static_cast<int>(sizeof(T));
}

// What __launch_bounds__ asks for: the blocks an SM holds by shared memory
// (4 in float32, 128 registers a thread; 2 in float64), as K2's
template <typename T>
constexpr int replay_min_blocks() {
  return (227 * 1024) / replay_smem<T>();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, replay_min_blocks<T>())
stage_replay_kernel(const T* __restrict__ Abar, const T* __restrict__ Bbar,
                    const T* __restrict__ cbar, const T* __restrict__ Qbar,
                    const T* __restrict__ S1T, const T* __restrict__ R00,
                    const T* __restrict__ qx, const T* __restrict__ ruu,
                    const T* __restrict__ ru, const T* __restrict__ P0,
                    const T* __restrict__ p0, T* __restrict__ Pout,
                    T* __restrict__ pout, int reps, int B) {
  using namespace slot;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sh = reinterpret_cast<T*>(smem_raw);
  const int l = threadIdx.x / kGroup, t = threadIdx.x % kGroup;
  const int b0 = blockIdx.x * kLanes;
  const int bl = min(b0 + l, B - 1);   // the lane this group reads
  T* const w = sh + l * kStride;
  const int q = Q, qv = QX;            // the stage's Qbar and qbar, as K2's

  // the stage inputs land once, into K2's slots, and the cost-to-go into P
  // (rows at pitch RW) and p
  stage_in<NX, RW>(sh, AT, Abar, NX * NX, B, b0);
  stage_in<NUC, RW>(sh, BT, Bbar, NX * NUC, B, b0);
  stage_in(sh, C, cbar, NX, B, b0);
  stage_in(sh, Q, Qbar, NX * NX, B, b0);
  stage_in(sh, S, S1T, NU * NX, B, b0);
  stage_in(sh, R, R00, NU * NU, B, b0);
  stage_in(sh, QX, qx, NX, B, b0);
  stage_in(sh, RS, ruu, NUC, B, b0);
  stage_in(sh, RU, ru, NUC, B, b0);
  for (int e = t; e < NX * NX; e += kGroup)
    w[P + e / NX * RW + e % NX] = P0[e * B + bl];
  for (int i = t; i < NX; i += kGroup) w[PV + i] = p0[i * B + bl];
  copy_wait();

#pragma unroll 1
  for (int rep = 0; rep < reps; ++rep) {
    __syncthreads();   // the inputs have landed; the last P and p are done

    // P [A | B | c], one column a thread (22 columns): column j of P A
    // into PAT row j, of P B into PBT, P c into Pc and m = p + Pc
#pragma unroll 1
    for (int col = t; col < NX + NUC + 1; col += kGroup) {
      const int src = col < NX ? AT + col * RW
                      : col < NX + NUC ? BT + (col - NX) * RW : C;
      const int dst = col < NX ? PAT + col * RW
                      : col < NX + NUC ? PBT + (col - NX) * RW : PC;
      T x[NX];
      ld_row(w + src, x);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T pr[NX];
        ld_row(w + P + i * RW, pr);
        const T s = dot(pr, x);
        w[dst + i] = s;
        if (col == NX + NUC) w[MV + i] = w[PV + i] + s;
      }
    }
    __syncthreads();

    // B' times [PA | m | PB], one column job a thread (22 jobs): column j
    // of PA gives Qux[:, j] = [S1T; 0][:, j] + B'PA[:, j] (into QUXT row
    // j), m gives Qu = ru + B'm, column a2 of PB gives Quu[a2:, a2] =
    // B'PB + [R00 0; 0 0] + diag(ruu_shift) (the lower triangle)
#pragma unroll 1
    for (int job = t; job < NX + 1 + NUC; job += kGroup) {
      const bool qux = job < NX, qu = job == NX;
      const int a2 = job - NX - 1;              // Quu's column
      const int a0 = (qux || qu) ? 0 : a2;      // its first row
      T y[NX];
      ld_row(w + (qux ? PAT + job * RW : qu ? MV : PBT + a2 * RW), y);
#pragma unroll
      for (int a = 0; a < NUC; ++a) {
        if (a < a0) continue;
        T bt[NX];
        ld_row(w + BT + a * RW, bt);
        T s = dot(bt, y);
        if (qux) {
          w[QUXT + job * NUC + a] = (a < NU) ? w[S + a * NX + job] + s : s;
        } else if (qu) {
          w[QU + a] = w[RU + a] + s;
        } else {
          if (a < NU) s = s + w[R + a * NU + a2];
          if (a == a2) s = s + w[RS + a];
          w[QUU + a * NUC + a2] = s;
        }
      }
    }
    __syncthreads();

    // L = chol(Quu) in every thread; K = -Quu^{-1} Qux one column a
    // thread (into KT row j), kff = -Quu^{-1} Qu
    {
      T Qm[NUC][NUC], Lp[NLC];
#pragma unroll
      for (int a = 0; a < NUC; ++a) {
#pragma unroll
        for (int a2 = 0; a2 < NUC; ++a2)
          Qm[a][a2] = (a2 <= a) ? w[QUU + a * NUC + a2] : T(0);
      }
      chol<T, NUC>(Qm, Lp);
#pragma unroll 1
      for (int col = t; col <= NX; col += kGroup) {
        T y[NUC];
        ld_row(w + (col < NX ? QUXT + col * NUC : QU), y);
        cho_solve<T, NUC>(Lp, y);
        const int dst = col < NX ? KT + col * NUC : KFF;
#pragma unroll
        for (int a = 0; a < NUC; ++a) w[dst + a] = -y[a];
      }
      if (t == kGroup - 1) {
#pragma unroll
        for (int q = 0; q < NLC; ++q) w[L + q] = Lp[q];
      }
    }
    __syncthreads();

    // X = Qbar + A'PA + Qux'K one column a thread (into P, before the
    // symmetrization); the 14th job p <- qx + A'm + K'Qu
#pragma unroll 1
    for (int j = t; j <= NX; j += kGroup) {
      const bool pj = j == NX;
      T y1[NX], y2[NUC];
      ld_row(w + (pj ? MV : PAT + j * RW), y1);
      ld_row(w + (pj ? QU : KT + j * NUC), y2);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T x1[NX], x2[NUC];
        ld_row(w + AT + i * RW, x1);
        ld_row(w + (pj ? KT : QUXT) + i * NUC, x2);
        const T s = dot(x1, y1);
        const T u = dot(x2, y2);
        if (pj)
          w[PV + i] = w[qv + i] + s + u;
        else
          w[P + i * RW + j] = w[q + i * NX + j] + s + u;
      }
    }
    __syncthreads();
    // P <- sym(X): the 78 (i < j) pairs
#pragma unroll 1
    for (int o = t; o < NX * (NX - 1) / 2; o += kGroup) {
      int i = 0, r = o;
      while (r >= NX - 1 - i) {
        r -= NX - 1 - i;
        ++i;
      }
      const int j = i + 1 + r;
      const T v = T(0.5) * (w[P + i * RW + j] + w[P + j * RW + i]);
      w[P + i * RW + j] = v;
      w[P + j * RW + i] = v;
    }
  }
  __syncthreads();

  // P and p out, in the flat (entry, lane) order
  stage_out(Pout, sh, P, NX * NX, NX, RW, B, b0);
  stage_out(pout, sh, PV, NX, NX, RW, B, b0);
}

inline cudaStream_t as_stream(void* s) {
  return static_cast<cudaStream_t>(s);
}

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

template <typename T>
int replay_opt_in() {
  if (replay_smem<T>() <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      stage_replay_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      replay_smem<T>()));
}

// stage_replay's launch: grid, threads and smem are the wrapper's
// replay_launch_geometry; another is refused
template <typename T>
int stage_replay_launch(const T* Abar, const T* Bbar, const T* cbar,
                        const T* Qbar, const T* S1T, const T* R00,
                        const T* qx, const T* ruu, const T* ru, const T* P0,
                        const T* p0, T* P, T* p, int reps, int B, int grid,
                        int threads, int smem, void* stream) {
  if (B < 1 || reps < 1 || threads != kThreads ||
      smem != replay_smem<T>() || grid != (B + kLanes - 1) / kLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = replay_opt_in<T>();
  if (err != 0) return err;
  stage_replay_kernel<T><<<grid, threads, smem, as_stream(stream)>>>(
      Abar, Bbar, cbar, Qbar, S1T, R00, qx, ruu, ru, P0, p0, P, p, reps, B);
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
      const T* P0, const T* p0, T* P, T* p, int reps, int B, int grid,        \
      int threads, int smem, void* stream) {                                  \
    return stage_replay_launch<T>(Abar, Bbar, cbar, Qbar, S1T, R00, qx, ruu,  \
                                  ru, P0, p0, P, p, reps, B, grid, threads,   \
                                  smem, stream);                              \
  }                                                                           \
  extern "C" int fma_chain_occupancy_##SUFFIX(int* blocks_per_sm) {           \
    const int err = fma_opt_in<T>();                                          \
    if (err != 0) return err;                                                 \
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(    \
        blocks_per_sm, fma_chain_kernel<T>, kFmaThreads, fma_smem<T>()));     \
  }                                                                           \
  extern "C" int stage_replay_occupancy_##SUFFIX(int* blocks_per_sm) {        \
    const int err = replay_opt_in<T>();                                       \
    if (err != 0) return err;                                                 \
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(    \
        blocks_per_sm, stage_replay_kernel<T>, kThreads, replay_smem<T>()));  \
  }

SOL_ENTRIES(f32, float)
SOL_ENTRIES(f64, double)
