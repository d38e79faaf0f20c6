// K2: the dense-cost Riccati factorization of the block-2 condensed QP and
// its forward rollout, a group of threads per lane; and K5a, the
// factorization alone.
//
// Replaces kkt_sweep_c2 of crazyflie_nmpc_tpu/ops/pallas/condensed_kernels.py
// (_kkt_c2_kernel, _chol_n, _cho_solve_n, _cho_solve_n_vec, _pk), with its
// compressed-stream forms (gains_dtype=bfloat16: bf16 K/L/Pc; a_dev=True:
// the deviation-coded bf16 Abar - I, Bbar, cbar; the *_g, *_a, *_ga
// entries).  It computes what the one-thread-per-lane kernel of
// condensed_c2.cu did, in the same order of operations within every sum.
//
// What bounds it on the H100.  Per stage and lane the backward pass reads
// 552 values and writes ~160 and does ~11k multiply-adds; the rollout
// re-reads 398 and writes 21.  One thread per lane made the stage a serial
// chain of those 11k multiply-adds with P, PA, Qux and K spilled to local
// memory: at B=4096 only 4096 threads ran, and the chain (P2 stage_replay,
// ~46 us a stage) set the time at ~7x the bytes bound.  Here a group of
// kGroup = 16 threads shares one lane's stage, and the lane's state and
// stage inputs live in shared memory:
//   * the stage inputs arrive by cp.async (no registers held, every copy of
//     a thread in flight at once), A and B transposed so that their columns
//     are rows; the rollout's inputs go round a ring of two slot sets, the
//     next stage's copies landing while this one computes;
//   * every product is split over the group by column: a thread holds one
//     column of the right-hand matrix in registers and streams the rows of
//     the left one through 16-byte vector loads of rows padded to 16
//     (P [A | B | c]; B' [PA | m | PB]; X = Qbar + A'PA + Qux'K, then its
//     symmetrization by pairs);
//   * the 8x8 Cholesky of Quu is serial: every thread of the group factors
//     it in registers (the same instructions, so the same bits), then
//     threads 0-12 each solve one column of K and thread 13 kff.
// Timings with parts cut out (roofline/kkt_variants.py, PERF.md): at
// B=4096 each backward phase takes 1-3 us a stage, the rollout ~4.5 us,
// re-reading a stage stream that no longer fits L2 (at B=1024 it does).
//
// Tile and geometry: kLanes = 8 consecutive lanes a block (kThreads =
// 128), so the block's loads of one entry fill one 32-byte sector of a
// batch-last row; inputs arrive and gains leave in the flat (entry, lane)
// order, 8 neighbouring threads on one sector.  Shared memory: kStride =
// 1548 values a lane, 49,536 bytes a block in float32 (4 blocks, 32 lanes
// an SM: 4224 lanes on 132 SMs, so B=1024 and 4096 run in one wave, B=8192
// in two) and 99,072 in float64 (2 blocks, 16 lanes an SM: B=4096 runs in
// two waves); both need the opt-in attribute.  `__launch_bounds__` asks
// for those blocks, which caps float32 at 128 registers a thread; `ptxas
// -v` in the build log gives the count and the spills (none).  The wrapper
// (ops/cuda/condensed_kernels.kkt_launch_geometry) computes grid, block
// and shared bytes; the launch refuses numbers that disagree with these.
//
// A ragged tile's spare groups read the last lane and store nothing: they
// take part in every barrier.  The rollout reads the gains this launch
// wrote (the K output, or Kf, the full-precision scratch of the bf16-gain
// forms, as condensed_c2.cu did) after __syncthreads, through L1 (the
// lines were not cached before the writes).
//
// K5a (bwd_c2_kernel) replaces _bwd_c2_kernel of the same Pallas module,
// the first launch of kkt_sweep_c2_win (windowed=True, the long-horizon
// form): K2's factorization without its rollout, the same body with a
// compile-time switch (ROLL), K2's group and block, every sum in K2's
// order (so its K, kff, L and Pc equal K2's bit for bit).  What bounds it:
// bytes, 552 values read and ~160 written a stage and lane, 0.70 ms at
// N=400, B=4096 in float32, where no stage's inputs are in L2; but the
// group's chain of shared-memory products sets its time, as K2's backward
// pass.  The one-thread kernel this replaces ran 15.0 ms there (P, PA, Qux
// and K spilled to local memory).  At N=400 every stage's inputs come from
// HBM, so K5a issues stage k-1's cost inputs while stage k computes: Qbar
// and qbar (read by phase D) into a second set, S1T, R00 and the R̄ terms
// (read by phase B alone) in place after phase B (kPrefetch): 1740 values
// a lane, still 4 blocks an SM in float32 and 2 in float64.  `ptxas -v`:
// 128 registers in float32, 192 in float64, no spills.  At N=400, B=4096
// it takes 2.96 ms, 4.2x its bound; the prefetch saves ~1%.  Landing all
// of a stage's inputs ahead (A'PA and A'm moved into phase B, which then
// reads every input last) took 3.13 ms: the copies cost their issue, not
// their latency (roofline/kkt_variants.py --kernel bwd_c2, PERF.md).
#include <type_traits>

#include "c2_stage.cuh"

using namespace cfl;

namespace {

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
// the rollout's ring of two input sets (RSET values apart, unpadded rows)
// and its state, in slots the backward pass no longer needs
constexpr int RA = 0, RB = RA + NX * NX, RC = RB + NX * NUC,
              RK = RC + NX, RKFF = RK + NUC * NX, RSET = RKFF + NUC;
constexpr int X0 = 2 * RSET, X1 = X0 + NX, U = X1 + NX;
static_assert(U + NUC <= END, "the rollout's slots fit the lane's");
static_assert(PAT % 8 == 0 && PBT % 8 == 0 && AT % 8 == 0 && BT % 8 == 0 &&
                  QUXT % 8 == 0 && KT % 8 == 0 && PV % 8 == 0 &&
                  MV % 8 == 0 && PC % 8 == 0 && C % 8 == 0 && QU % 8 == 0,
              "rows start 16-byte aligned in both dtypes");
}  // namespace slot

// 1548 a lane: 16-byte aligned, and two lanes' same entry 12 banks apart
constexpr int kStride = slot::END + 4;
static_assert(kStride == 1548, "kkt_launch_geometry's KKT_LANE_VALUES");

// K5a's lane (bwd_c2_kernel): K2's slots, then a second set of the two
// cost inputs that phase D reads (Qbar and qbar of the odd stages), so
// that stage k-1's cost inputs land while stage k computes; the others
// (S1T, R00, the shifted R̄ diagonal, rbar), read by phase B alone, land
// in place after it.
constexpr bool kPrefetch = true;
namespace slot {
constexpr int Q2 = END;                 // Qbar, odd stages
constexpr int QX2 = Q2 + 172;           // qbar, odd stages
constexpr int END2 = QX2 + RW;
}  // namespace slot
// 1740 a lane: 16-byte aligned, two lanes' same entry 12 banks apart, and
// 4 blocks an SM in float32 and 2 in float64, as K2 (with the 1 KB each
// block reserves of the SM's 228 KB)
constexpr int kBwdStride = slot::END2 + 8;
static_assert(kBwdStride == 1740, "bwd_launch_geometry's BWD_LANE_VALUES");

// ROLL: K2's lane (the rollout's too), else K5a's
template <typename T, bool ROLL = true>
constexpr int smem_bytes() {
  return kLanes * (ROLL ? kStride : kBwdStride) * static_cast<int>(sizeof(T));
}

// Blocks an SM holds by shared memory: what __launch_bounds__ asks for.
template <typename T, bool ROLL = true>
constexpr int min_blocks() {
  return (227 * 1024) / smem_bytes<T, ROLL>();
}

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

// Entries [0, n) of stage k of a batch-last input into every lane's slot
// `dst` (lanes STRIDE values apart), in the compute type: entry r at dst +
// r, or with NCOL > 0 (an input of rows of NCOL) transposed, entry (i, j)
// at dst + j PITCH + i.
// Thread f of the flat (entry, lane) order takes entry f / kLanes of lane
// f % kLanes, so 8 neighbouring threads read one 32-byte sector.  An input
// stored in the compute type is copied asynchronously (copy_wait() before
// use); a bf16 one is converted on the way through registers (DEV: a
// deviation-coded 13x13 block, the identity added back).
template <typename T, bool DEV = false, int NCOL = 0, int PITCH = 0,
          int STRIDE = kStride, typename S>
__device__ __forceinline__ void stage_in(T* sh, int dst, const S* src,
                                         int n, int k, int B, int b0) {
#pragma unroll 4
  for (int f = threadIdx.x; f < n * kLanes; f += kThreads) {
    const int r = f / kLanes, l = f % kLanes;
    const S* from = src + ((size_t)k * n + r) * B + min(b0 + l, B - 1);
    const int at = NCOL ? (r % NCOL) * PITCH + r / NCOL : r;
    T* to = sh + l * STRIDE + dst + at;
    if constexpr (std::is_same<S, T>::value && !DEV) {
      copy_async(to, from);
    } else {
      const T v = cvt<T>(*from);
      *to = (DEV && r % (NX + 1) == 0) ? v + T(1) : v;
    }
  }
}

// Slot `src` of every lane into entries [0, n) of stage k of a batch-last
// output of type D, in the same order (NCOL, PITCH: the slot holds the
// transpose, as in stage_in); a ragged tile's spare lanes store nothing.
template <int NCOL = 0, int PITCH = 0, int STRIDE = kStride, typename T,
          typename D>
__device__ __forceinline__ void stage_out(D* dst, const T* sh, int src,
                                          int n, int k, int B, int b0) {
  for (int f = threadIdx.x; f < n * kLanes; f += kThreads) {
    const int r = f / kLanes, l = f % kLanes;
    const int at = NCOL ? (r % NCOL) * PITCH + r / NCOL : r;
    if (b0 + l < B)
      dst[((size_t)k * n + r) * B + b0 + l] =
          cvt<D>(sh[l * STRIDE + src + at]);
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

// The backward factorization, then with ROLL the forward rollout: K2's
// sweep, and K5a's (ROLL false: no rollout, dx0, dx, du and Kf unused, the
// cost inputs a stage ahead with kPrefetch).  Each kernel below is this
// body with its switch.
template <typename T, typename TA, typename TG, bool DEV, bool ROLL>
__device__ __forceinline__ void sweep(
    const TA* __restrict__ Abar, const TA* __restrict__ Bbar,
    const TA* __restrict__ cbar, const T* __restrict__ Qbar,
    const T* __restrict__ S1T, const T* __restrict__ R00,
    const T* __restrict__ qx, const T* __restrict__ ruu,
    const T* __restrict__ ru, const T* __restrict__ pT,
    const T* __restrict__ pterm, const T* __restrict__ dx0, TG* K, T* kff,
    TG* Lout, TG* Pcout, T* dx, T* du, T* Kf, int M, int B) {
  using namespace slot;
  constexpr bool kGainsT = std::is_same<TG, T>::value;
  constexpr int LS = ROLL ? kStride : kBwdStride;   // values a lane
  constexpr bool kAhead = !ROLL && kPrefetch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sh = reinterpret_cast<T*>(smem_raw);
  const int l = threadIdx.x / kGroup, t = threadIdx.x % kGroup;
  const int b0 = blockIdx.x * kLanes;
  const int bl = min(b0 + l, B - 1);   // the lane this group reads
  const bool valid = b0 + l < B;       // ... and whether it stores
  T* const w = sh + l * LS;

  // terminal cost-to-go: P = diag(pT), p = p_term
  for (int e = t; e < NX * NX; e += kGroup) {
    const int i = e / NX, j = e % NX;
    w[P + i * RW + j] = (i == j) ? pT[i * B + bl] : T(0);
  }
  for (int i = t; i < NX; i += kGroup) w[PV + i] = pterm[i * B + bl];

  // the cost inputs of stage k; ahead (K5a), Qbar and qbar of an odd
  // stage into the second set
  const auto cost_in = [&](int k) {
    const bool odd = kAhead && (k & 1);
    stage_in<T, false, 0, 0, LS>(sh, odd ? Q2 : Q, Qbar, NX * NX, k, B, b0);
    stage_in<T, false, 0, 0, LS>(sh, S, S1T, NU * NX, k, B, b0);
    stage_in<T, false, 0, 0, LS>(sh, R, R00, NU * NU, k, B, b0);
    stage_in<T, false, 0, 0, LS>(sh, odd ? QX2 : QX, qx, NX, k, B, b0);
    stage_in<T, false, 0, 0, LS>(sh, RS, ruu, NUC, k, B, b0);
    stage_in<T, false, 0, 0, LS>(sh, RU, ru, NUC, k, B, b0);
  };
  if constexpr (kAhead) cost_in(M - 1);

#pragma unroll 1
  for (int k = M - 1; k >= 0; --k) {
    __syncthreads();   // the last stage's readers of the input slots are done
    stage_in<T, DEV, NX, RW, LS>(sh, AT, Abar, NX * NX, k, B, b0);
    stage_in<T, false, NUC, RW, LS>(sh, BT, Bbar, NX * NUC, k, B, b0);
    stage_in<T, false, 0, 0, LS>(sh, C, cbar, NX, k, B, b0);
    if constexpr (!kAhead) cost_in(k);
    copy_wait();
    __syncthreads();
    const int q = (kAhead && (k & 1)) ? Q2 : Q;     // this stage's Qbar
    const int qv = (kAhead && (k & 1)) ? QX2 : QX;  // ... and qbar

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

    // K5a: stage k-1's cost inputs, landing while this stage computes (S,
    // R, RS and RU in place: phase B was their last reader)
    if constexpr (kAhead) {
      if (k > 0) cost_in(k - 1);
    }

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

    // the stage's gains out
    stage_out<NX, NUC, LS>(K, sh, KT, NUC * NX, k, B, b0);
    if constexpr (!kGainsT)
      stage_out<NX, NUC, LS>(Kf, sh, KT, NUC * NX, k, B, b0);
    stage_out<0, 0, LS>(kff, sh, KFF, NUC, k, B, b0);
    stage_out<0, 0, LS>(Lout, sh, L, NLC, k, B, b0);
    stage_out<0, 0, LS>(Pcout, sh, PC, NX, k, B, b0);

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

  if constexpr (ROLL) {
    // forward rollout: du_k = K_k dx_k + kff_k, dx_{k+1} = A dx + B du + c,
    // on the full-precision gains.  Its inputs go round a ring of two slot
    // sets in the slots the backward pass is done with: stage k+1's copies
    // land while stage k computes.
    const T* Kr;
    if constexpr (kGainsT) {
      Kr = K;
    } else {
      Kr = Kf;
    }
    const auto roll_in = [&](int k) {
      const int o = (k & 1) * RSET;
      stage_in<T, DEV>(sh, RA + o, Abar, NX * NX, k, B, b0);
      stage_in<T>(sh, RB + o, Bbar, NX * NUC, k, B, b0);
      stage_in<T>(sh, RC + o, cbar, NX, k, B, b0);
      stage_in<T>(sh, RK + o, Kr, NUC * NX, k, B, b0);
      stage_in<T>(sh, RKFF + o, static_cast<const T*>(kff), NUC, k, B, b0);
    };
    __syncthreads();   // the gains are written, the last P update is done
    for (int i = t; i < NX; i += kGroup) w[X0 + i] = dx0[i * B + bl];
    roll_in(0);
    copy_wait();
    __syncthreads();
#pragma unroll 1
    for (int k = 0; k < M; ++k) {
      if (k + 1 < M) roll_in(k + 1);
      const int o = (k & 1) * RSET;
      const T* x = w + ((k & 1) ? X1 : X0);
      T* xn = w + ((k & 1) ? X0 : X1);
      const T* Kk = w + RK + o;
      for (int a = t; a < NUC; a += kGroup) {
        T s = Kk[a * NX] * x[0];
#pragma unroll
        for (int j = 1; j < NX; ++j) s = s + Kk[a * NX + j] * x[j];
        const T u = s + w[RKFF + o + a];
        w[U + a] = u;
        if (valid) du[((size_t)k * NUC + a) * B + b0 + l] = u;
      }
      if (valid) {
        for (int i = t; i < NX; i += kGroup)
          dx[((size_t)k * NX + i) * B + b0 + l] = x[i];
      }
      __syncthreads();
      const T* A = w + RA + o;
      const T* Bm = w + RB + o;
      const T* u = w + U;
      for (int i = t; i < NX; i += kGroup) {
        T s = A[i * NX] * x[0];
#pragma unroll
        for (int j = 1; j < NX; ++j) s = s + A[i * NX + j] * x[j];
        T v = Bm[i * NUC] * u[0];
#pragma unroll
        for (int a = 1; a < NUC; ++a) v = v + Bm[i * NUC + a] * u[a];
        xn[i] = s + v + w[RC + o + i];
      }
      copy_wait();       // stage k+1's inputs have landed (this thread's) ...
      __syncthreads();   // ... everyone's, and stage k's slots are free
    }
    if (valid) {
      const T* x = w + ((M & 1) ? X1 : X0);
      for (int i = t; i < NX; i += kGroup)
        dx[((size_t)M * NX + i) * B + b0 + l] = x[i];
    }
  }
}

template <typename T, typename TA = T, typename TG = T, bool DEV = false>
__global__ void __launch_bounds__(kThreads, min_blocks<T>())
kkt_sweep_c2_kernel(const TA* __restrict__ Abar, const TA* __restrict__ Bbar,
                    const TA* __restrict__ cbar, const T* __restrict__ Qbar,
                    const T* __restrict__ S1T, const T* __restrict__ R00,
                    const T* __restrict__ qx, const T* __restrict__ ruu,
                    const T* __restrict__ ru, const T* __restrict__ pT,
                    const T* __restrict__ pterm, const T* __restrict__ dx0,
                    TG* K, T* kff, TG* Lout, TG* Pcout, T* dx, T* du, T* Kf,
                    int M, int B) {
  sweep<T, TA, TG, DEV, true>(Abar, Bbar, cbar, Qbar, S1T, R00, qx, ruu, ru,
                              pT, pterm, dx0, K, kff, Lout, Pcout, dx, du,
                              Kf, M, B);
}

// K5a: the factorization alone (the windowed sweeps' first launch)
template <typename T>
__global__ void __launch_bounds__(kThreads, min_blocks<T, false>())
bwd_c2_kernel(const T* __restrict__ Abar, const T* __restrict__ Bbar,
              const T* __restrict__ cbar, const T* __restrict__ Qbar,
              const T* __restrict__ S1T, const T* __restrict__ R00,
              const T* __restrict__ qx, const T* __restrict__ ruu,
              const T* __restrict__ ru, const T* __restrict__ pT,
              const T* __restrict__ pterm, T* K, T* kff, T* Lout, T* Pcout,
              int M, int B) {
  sweep<T, T, T, false, false>(Abar, Bbar, cbar, Qbar, S1T, R00, qx, ruu, ru,
                               pT, pterm, nullptr, K, kff, Lout, Pcout,
                               nullptr, nullptr, nullptr, M, B);
}

template <typename T, typename TA, typename TG, bool DEV>
int set_smem() {
  if (smem_bytes<T>() <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kkt_sweep_c2_kernel<T, TA, TG, DEV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>()));
}

template <typename T, typename TA, typename TG, bool DEV>
int launch(const TA* Abar, const TA* Bbar, const TA* cbar, const T* Qbar,
           const T* S1T, const T* R00, const T* qx, const T* ruu,
           const T* ru, const T* pT, const T* pterm, const T* dx0, TG* K,
           T* kff, TG* L, TG* Pc, T* dx, T* du, T* Kf, int M, int B,
           int grid, int threads, int smem, void* stream) {
  if (B < 1 || M < 1 || threads != kThreads || smem != smem_bytes<T>() ||
      grid != (B + kLanes - 1) / kLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = set_smem<T, TA, TG, DEV>();
  if (err != 0) return err;
  kkt_sweep_c2_kernel<T, TA, TG, DEV>
      <<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          Abar, Bbar, cbar, Qbar, S1T, R00, qx, ruu, ru, pT, pterm, dx0, K,
          kff, L, Pc, dx, du, Kf, M, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int set_bwd_smem() {
  return static_cast<int>(cudaFuncSetAttribute(
      bwd_c2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<T, false>()));
}

template <typename T>
int launch_bwd(const T* Abar, const T* Bbar, const T* cbar, const T* Qbar,
               const T* S1T, const T* R00, const T* qx, const T* ruu,
               const T* ru, const T* pT, const T* pterm, T* K, T* kff, T* L,
               T* Pc, int M, int B, int grid, int threads, int smem,
               void* stream) {
  if (B < 1 || M < 1 || threads != kThreads ||
      smem != smem_bytes<T, false>() || grid != (B + kLanes - 1) / kLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = set_bwd_smem<T>();
  if (err != 0) return err;
  bwd_c2_kernel<T>
      <<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          Abar, Bbar, cbar, Qbar, S1T, R00, qx, ruu, ru, pT, pterm, K, kff,
          L, Pc, M, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The exact form (no Kf) and the compressed ones, FORM in the symbol: _g
// bf16 gains (K, L, Pc), _a the deviation-coded bf16 stage stream (Abar -
// I, Bbar, cbar), _ga both.  The compressed forms take Kf after du, the
// full-precision K their rollout reads with bf16 gains (unused by _a,
// whose rollout reads K).  grid, threads and smem are the wrapper's
// kkt_launch_geometry.
#define KKT_ENTRY(SUFFIX, T)                                                  \
  extern "C" int kkt_sweep_c2_##SUFFIX(                                       \
      const T* Abar, const T* Bbar, const T* cbar, const T* Qbar,             \
      const T* S1T, const T* R00, const T* qx, const T* ruu, const T* ru,     \
      const T* pT, const T* pterm, const T* dx0, T* K, T* kff, T* L, T* Pc,   \
      T* dx, T* du, int M, int B, int grid, int threads, int smem,            \
      void* stream) {                                                         \
    return launch<T, T, T, false>(Abar, Bbar, cbar, Qbar, S1T, R00, qx, ruu,  \
                                  ru, pT, pterm, dx0, K, kff, L, Pc, dx, du,  \
                                  nullptr, M, B, grid, threads, smem,         \
                                  stream);                                    \
  }                                                                           \
  extern "C" int kkt_sweep_c2_occupancy_##SUFFIX(int* blocks_per_sm) {        \
    const int err = set_smem<T, T, T, false>();                               \
    if (err != 0) return err;                                                 \
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(    \
        blocks_per_sm, kkt_sweep_c2_kernel<T, T, T, false>, kThreads,         \
        smem_bytes<T>()));                                                    \
  }

#define KKT_COMPRESSED_ENTRY(FORM, SUFFIX, T, TA, TG, DEV)                    \
  extern "C" int kkt_sweep_c2##FORM##_##SUFFIX(                               \
      const TA* Abar, const TA* Bbar, const TA* cbar, const T* Qbar,          \
      const T* S1T, const T* R00, const T* qx, const T* ruu, const T* ru,     \
      const T* pT, const T* pterm, const T* dx0, TG* K, T* kff, TG* L,        \
      TG* Pc, T* dx, T* du, T* Kf, int M, int B, int grid, int threads,       \
      int smem, void* stream) {                                               \
    return launch<T, TA, TG, DEV>(Abar, Bbar, cbar, Qbar, S1T, R00, qx, ruu,  \
                                  ru, pT, pterm, dx0, K, kff, L, Pc, dx, du,  \
                                  Kf, M, B, grid, threads, smem, stream);     \
  }

KKT_ENTRY(f32, float)
KKT_ENTRY(f64, double)

using bf16 = __nv_bfloat16;
KKT_COMPRESSED_ENTRY(_g, f32, float, float, bf16, false)
KKT_COMPRESSED_ENTRY(_g, f64, double, double, bf16, false)
KKT_COMPRESSED_ENTRY(_a, f32, float, bf16, float, true)
KKT_COMPRESSED_ENTRY(_a, f64, double, bf16, double, true)
KKT_COMPRESSED_ENTRY(_ga, f32, float, bf16, bf16, true)
KKT_COMPRESSED_ENTRY(_ga, f64, double, bf16, bf16, true)

// K5a (bwd_c2, no compressed forms: windowed=True drops them); grid,
// threads and smem are the wrapper's bwd_launch_geometry.
#define BWD_ENTRY(SUFFIX, T)                                                  \
  extern "C" int bwd_c2_##SUFFIX(                                             \
      const T* Abar, const T* Bbar, const T* cbar, const T* Qbar,             \
      const T* S1T, const T* R00, const T* qx, const T* ruu, const T* ru,     \
      const T* pT, const T* pterm, T* K, T* kff, T* L, T* Pc, int M, int B,   \
      int grid, int threads, int smem, void* stream) {                        \
    return launch_bwd<T>(Abar, Bbar, cbar, Qbar, S1T, R00, qx, ruu, ru, pT,   \
                         pterm, K, kff, L, Pc, M, B, grid, threads, smem,     \
                         stream);                                             \
  }                                                                           \
  extern "C" int bwd_c2_occupancy_##SUFFIX(int* blocks_per_sm) {              \
    const int err = set_bwd_smem<T>();                                        \
    if (err != 0) return err;                                                 \
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(    \
        blocks_per_sm, bwd_c2_kernel<T>, kThreads, smem_bytes<T, false>()));  \
  }

BWD_ENTRY(f32, float)
BWD_ENTRY(f64, double)
