// K3: the Mehrotra corrector's sweep of the block-2 condensed QP (the
// backward vector pass on a stored factorization, then the forward
// rollout), a group of threads per lane; K5b, the rollout alone; and K5c,
// the vector pass alone.
//
// Replaces corrector_sweep_c2 of crazyflie_nmpc_tpu/ops/pallas/
// condensed_kernels.py (_corr_c2_kernel, _cho_solve_n_vec), with its
// compressed-stream forms (bf16 K/L/Pc, the *_g entries; the deviation-coded
// bf16 Abar - I, Bbar, cbar, *_a; both, *_ga).  Per stage k, from p = p_term
// down to k = 0:
//   m = p + Pc_k,  Qu = r_k + B_k' m,  kff_k = -L_k^-T L_k^-1 Qu,
//   p <- q_k + A_k' m + K_k' Qu;
// then from dx0: du_k = K_k dx_k + kff_k, dx_{k+1} = A_k dx_k + B_k du_k + c_k.
// Every sum runs in the order of c2_stage.cuh's vec_stage and rollout_stage
// (the one-thread-per-lane kernel this one replaced), and every form reads
// its stored streams upcast to the compute type, the rollout the same K as
// the vector pass.
//
// What bounds it on the H100.  Per stage and lane the vector pass reads 447
// values and writes 8 (kff, parked in du) for ~300 multiply-adds; the
// rollout reads 398 and writes 21 for ~380: bytes-bound in principle (358 MB
// at B=4096, M=25: 0.12 ms at the measured bandwidth).  One thread per lane
// in 64-thread blocks ran 64 blocks on 64 of the 132 SMs at B=4096, each
// thread's ~850 loads of a stage one dependent chain: 2.6x the bytes bound.
// Here a group of kGroup = 16 threads shares one lane's stage:
//   * the stage inputs arrive in shared memory by cp.async round a ring of
//     two slot sets, in both passes: stage k-1's copies (vector pass) or
//     k+1's (rollout) land while stage k computes.  A full tile of a
//     batch-last row (kLanes lanes of one entry: 64 bytes in float32, 128
//     in float64, 32 in bf16) goes in 16-byte copies (cp.async.cg); the
//     slots keep the row's (entry, lane) order, so a copy lands as it was
//     read;
//   * the bf16 streams land raw and are upcast where they are read from
//     shared memory (the identity added back on A's diagonal there), so
//     nothing converts on the copy path;
//   * the chain of a stage is short: threads 0-12 form m, threads 0-7 Qu (8
//     dot products of 13), then threads 0-12 each update one entry of p (a
//     dot product of 21) while thread kGroup - 1, which p leaves idle,
//     solves and stores kff; the rollout is u (8 of 13), then dx (13 of
//     21); two barriers a stage;
//   * at the turn the vector pass ends on stage 0, whose A, B and K are in
//     the ring already: the rollout's stage 0 reads them there (its c
//     arrives during the vector pass's last stage, its kff is written
//     there).
// Slots are [entry][lane]: thread t of lane l reads entry e at row e, lane
// l; the two t of a warp read rows an odd stride apart (Bbar padded to a
// pitch of 9), so a warp's float32 loads hit 32 distinct banks.
//
// Tile and geometry: kLanes = 16 consecutive lanes a block (kThreads =
// 256), thread t of lane l is threadIdx.x = t kLanes + l, so a block's
// copies of one entry cover 64 bytes of a float32 row (two sectors).  With
// 8 lanes a block (one sector) the same kernel ran 25% longer at B >= 4096
// and G = 8 with 16 lanes as fast but 20% longer at B=1024, where 64 blocks
// leave half the SMs idle either way (roofline/kkt_variants.py, PERF.md).
// Shared memory: kLaneValues = 996 values a lane (two slot sets of 481 and
// the state), 63,744 bytes a block in float32 (3 blocks an SM) and 127,488
// in float64 (1 block); both need the opt-in attribute, and neither grows
// with M.  `__launch_bounds__` asks for at most 2 blocks (128 registers a
// thread; the float32 forms take 92-99, so 2 blocks and 32 lanes an SM):
// at 3 (80 registers) the bf16-stream forms spilled in float32, and 2
// blocks ran B=1024 and 4096 (one wave on 132 SMs) as fast and split
// B=8192's two waves evenly.  `ptxas -v` in the build log gives registers
// and spills, the occupancy API the blocks an SM.  The wrapper
// (ops/cuda/condensed_kernels.corr_launch_geometry) computes grid, block
// and shared bytes; the launch refuses numbers that disagree with these.
//
// Ragged tiles: a tile whose row is not 16-byte aligned (B not a multiple
// of 4 in float32, 2 in float64, 8 in bf16, or a base pointer off 16
// bytes) or that holds fewer than kLanes lanes (the last one) copies value
// by value; its spare groups read lane B-1, store nothing, and take part in
// every barrier.  The rollout re-reads the kff this launch parked in du
// through L2 (cp.async.cg, or __ldcg value by value), where the stores
// went.
//
// K2 (kkt_sweep_c2.cu) copies value by value into a lane-major layout; K3
// keeps its own copy helpers rather than share K2's through a header:
// moving K2's stage loop into shared inlined code once cost it 6%, and the
// two copies differ in layout anyway.
//
// K5b (fwd_c2_kernel) replaces _fwd_c2_kernel of the same Pallas module,
// the second launch of both windowed long-horizon sweeps (kkt_sweep_c2_win
// after bwd_c2, corrector_sweep_c2_win after bwd_vec_c2): K3's rollout in
// a kernel of its own, K3's group, block, copies and sums (on the same
// gains K5b's dx and du equal K2's rollout's bit for bit).  It loads its
// stage 0 itself and reads kff from its own array.  What bounds it: bytes,
// 398 values read and 21 written a stage and lane for 377 multiply-adds:
// 1.37 GB at N=400, B=4096 in float32, 0.41 ms at 3.35 TB/s, a stream that
// never fits the 50 MB L2.  The one-thread kernel this replaces ran 64 of
// the 132 SMs there, each thread's ~400 loads of a stage one dependent
// chain: 4.9 ms.  A set of K5b's ring holds only the rollout's fields (411
// values a lane, K3's 481), so two sets and the state take 856 values a
// lane (kFwdLaneValues), and 4 blocks fit an SM in float32 (2 in float64):
// B=8192 in one wave; one commit group a stage, kSets-1 stages in flight.
// `ptxas -v`: 64 registers in float32, 97 in float64, no spills.  At N=400,
// B=4096 it takes 0.51 ms, 0.80 of its bound (roofline/kkt_variants.py
// --kernel fwd_c2, PERF.md); 3 sets, G=8 or 32 lanes a block tie there
// (within 4%), 32 lanes is 27% faster at B=8192 and 20% slower at
// B=1024, 3 sets the reverse.
//
// K5c (bwd_vec_c2_kernel) replaces _bwd_vec_c2_kernel of the same Pallas
// module, the first launch of corrector_sweep_c2_win: K3's kernel body,
// `sweep<T, TA, TG, DEV, ROLL>`, with the rollout switched off at compile
// time (ROLL false), exact forms only, its kff written to its own array
// (on the same inputs K5c then K5b equal K3's dx and du bit for bit).
// What bounds it: bytes, 447 values read and 8 written a stage and lane
// for ~440 multiply-adds: 1.49 GB at N=400, B=4096 in float32, 0.445 ms
// at 3.35 TB/s, a stream that never fits the 50 MB L2.  The one-thread
// kernel this replaces (condensed_c2.cu's, c2_stage.cuh's vec_sweep) ran
// 64 of the 132 SMs there: 2.31 ms.  A set of K5c's ring holds only the
// vector pass's fields (460 values a lane, K3's 481), kVecSets = 2 sets
// and the state 954 values (kVecLaneValues): 61,056 bytes a block in
// float32 (3 blocks an SM), 122,112 in float64 (1); its stages land as
// K5b's, one commit group a stage, kVecSets-1 stages in flight.
#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "c2_stage.cuh"

using namespace cfl;

namespace {

constexpr int kGroup = 16;                 // threads per lane
constexpr int kThreads = 256;              // threads per block
constexpr int kLanes = kThreads / kGroup;  // lanes per block

// K3's lane: one slot set and the state, in rows of kLanes values of the
// compute type (a stored bf16 field fills the first half of its rows).
struct CorrLane {
  static constexpr int BP = NUC + 1;           // Bbar's row pitch
  static constexpr int A = 0;                  // Abar (13x13)
  static constexpr int B = A + NX * NX;        // Bbar (13 rows of 8, pitch BP)
  static constexpr int K = B + NX * BP;        // K (8x13)
  static constexpr int C = K + NUC * NX;       // cbar (the rollout's)
  static constexpr int KFF = C + NX;           // kff (the rollout's)
  static constexpr int PC = KFF + NUC;         // Pc (the vector pass's)
  static constexpr int L = PC + NX;            // packed Cholesky factor (36)
  static constexpr int Q = L + NLC;            // qbar
  static constexpr int R = Q + NX;             // rbar
  static constexpr int SET = R + NUC;          // one set of stage inputs
  static constexpr int P = 2 * SET;            // p, then the rollout's odd x
  static constexpr int X0 = P + NX;            // m, then the rollout's even x
  static constexpr int QU = X0 + NX;           // Qu, then the rollout's u
  static constexpr int END = QU + NUC;
};

constexpr int kLaneValues = CorrLane::END;
static_assert(kLaneValues == 996, "corr_launch_geometry's CORR_LANE_VALUES");

// K5c's lane: a ring of kVecSets sets of the vector pass's fields alone
// (K3's less cbar and kff), then the state.
constexpr int kVecSets = 2;   // depth of K5c's input ring
struct VecLane {
  static constexpr int BP = CorrLane::BP;      // Bbar's row pitch
  static constexpr int A = 0;                  // Abar (13x13)
  static constexpr int B = A + NX * NX;        // Bbar (13 rows of 8, pitch BP)
  static constexpr int K = B + NX * BP;        // K (8x13)
  static constexpr int PC = K + NUC * NX;      // Pc
  static constexpr int L = PC + NX;            // packed Cholesky factor (36)
  static constexpr int Q = L + NLC;            // qbar
  static constexpr int R = Q + NX;             // rbar
  static constexpr int SET = R + NUC;          // one set of stage inputs (460)
  static constexpr int P = kVecSets * SET;     // p
  static constexpr int X0 = P + NX;            // m
  static constexpr int QU = X0 + NX;           // Qu
  static constexpr int END = QU + NUC;
};

constexpr int kVecLaneValues = VecLane::END;
static_assert(kVecLaneValues == 954,
              "bwd_vec_launch_geometry's BWD_VEC_LANE_VALUES");

// ROLL: K3's lane, else K5c's
template <typename T, bool ROLL = true>
constexpr int smem_bytes() {
  return kLanes * (ROLL ? kLaneValues : kVecLaneValues) *
         static_cast<int>(sizeof(T));
}

// What __launch_bounds__ asks for: the blocks an SM holds by shared memory,
// at most 2 (128 registers a thread).
template <typename T, bool ROLL = true>
constexpr int min_blocks() {
  return std::min(2, (227 * 1024) / smem_bytes<T, ROLL>());
}

// A field of stored type S that starts at row `row`.
template <typename S, typename T>
__device__ __forceinline__ S* at(T* sh, int row) {
  return reinterpret_cast<S*>(sh + row * kLanes);
}

// Entries [0, n) of stage k of a batch-last input of type S into the field
// `dst`: entry r of the block's lane l at dst[row(r) kLanes + l], row(r) = r
// or, with NCOL > 0 (rows of NCOL entries), r / NCOL * PITCH + r % NCOL.  A
// full, 16-byte aligned tile goes in 16-byte copies, the others value by
// value (cp.async for 4 and 8 bytes, a 2-byte value through a register),
// spare lanes reading lane B-1.  FRESH: the input is this launch's own
// output, read through L2.  cp_wait() before use.
template <int NCOL = 0, int PITCH = 0, bool FRESH = false, typename S>
__device__ __forceinline__ void stage_in(S* dst, const S* src, int n, int k,
                                         int B, int b0) {
  constexpr int per = 16 / static_cast<int>(sizeof(S));  // values a copy
  constexpr int cpe = kLanes / per;                       // copies an entry
  const S* from = src + (size_t)k * n * B;
  const auto row = [](int r) {
    return NCOL ? r / NCOL * PITCH + r % NCOL : r;
  };
  if (b0 + kLanes <= B && B % per == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
#pragma unroll 1   // unrolled, the copies' addresses spilled (_a, float32)
    for (int c = threadIdx.x; c < n * cpe; c += kThreads) {
      const int r = c / cpe, v = c % cpe;
      S* to = dst + row(r) * kLanes + v * per;
      const S* fr = from + (size_t)r * B + b0 + v * per;
      CFL_ASM(asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                               static_cast<unsigned>(
                                   __cvta_generic_to_shared(to))),
                           "l"(fr)
                           : "memory"),
              memcpy(to, fr, 16));
    }
  } else {
    for (int f = threadIdx.x; f < n * kLanes; f += kThreads) {
      const int r = f / kLanes, l = f % kLanes;
      S* to = dst + row(r) * kLanes + l;
      const S* fr = from + (size_t)r * B + min(b0 + l, B - 1);
      if constexpr (FRESH) {
        *to = __ldcg(fr);
      } else if constexpr (sizeof(S) >= 4) {
        CFL_ASM(asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::
                                 "r"(static_cast<unsigned>(
                                     __cvta_generic_to_shared(to))),
                             "l"(fr), "n"(sizeof(S))
                             : "memory"),
                *to = *fr);
      } else {
        *to = *fr;
      }
    }
  }
}

// This thread's copies have landed (__syncthreads() after it: everyone's).
__device__ __forceinline__ void cp_wait() {
  CFL_ASM(asm volatile("cp.async.wait_all;\n" ::: "memory"), (void)0);
}
// The copies issued since the last commit form one group ...
__device__ __forceinline__ void cp_commit() {
  CFL_ASM(asm volatile("cp.async.commit_group;\n" ::: "memory"), (void)0);
}
// ... and this thread's groups but the newest `pending` have landed
// (__syncthreads() after it: everyone's).
template <int pending>
__device__ __forceinline__ void cp_wait_group() {
  CFL_ASM(asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory"),
          (void)0);
}

// A lane's column of a field of stored type S, read in T: entry q at
// p[q kLanes].
template <typename T, typename S>
struct Col {
  const S* p;
  __device__ __forceinline__ T operator[](int q) const {
    return cvt<T>(p[q * kLanes]);
  }
};

// Entry (i, j) of the lane's 13x13 A (column pointer `a`, type S) in T,
// with DEV the identity added back.
template <bool DEV, typename T, typename S>
__device__ __forceinline__ T a_at(const S* a, int i, int j) {
  const T v = cvt<T>(a[(i * NX + j) * kLanes]);
  if constexpr (DEV) return (i == j) ? v + T(1) : v;
  return v;
}

// The backward vector pass, then with ROLL the forward rollout: K3's sweep,
// and K5c's (ROLL false: no rollout, cbar, dx0, dx and du unused; its
// inputs round a ring of kVecSets sets, kff to its own output).  Each
// kernel below is this body inlined; K3 passes du as kff (kff parks there).
template <typename T, typename TA, typename TG, bool DEV, bool ROLL>
__device__ __forceinline__ void sweep(
    const TA* __restrict__ Abar, const TA* __restrict__ Bbar,
    const TA* __restrict__ cbar, const T* __restrict__ qx,
    const T* __restrict__ ru, const TG* __restrict__ K,
    const TG* __restrict__ L, const TG* __restrict__ Pc,
    const T* __restrict__ pterm, const T* __restrict__ dx0, T* dx, T* du,
    T* kff, int M, int B) {
  using S = std::conditional_t<ROLL, CorrLane, VecLane>;
  constexpr int BP = S::BP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sh = reinterpret_cast<T*>(smem_raw);
  const int l = threadIdx.x % kLanes, t = threadIdx.x / kLanes;
  const int b0 = blockIdx.x * kLanes;
  const int bl = min(b0 + l, B - 1);   // the lane this group reads
  const bool valid = b0 + l < B;       // ... and whether it stores
  T* const w = sh + l;                 // the lane's column: entry r at r kLanes
  const auto set = [&](int k) {
    if constexpr (ROLL)
      return sh + (k & 1) * S::SET * kLanes;
    else
      return sh + (k % kVecSets) * S::SET * kLanes;
  };

  for (int i = t; i < NX; i += kGroup)
    w[(S::P + i) * kLanes] = pterm[i * B + bl];

  // vector pass inputs of stage k into its set
  const auto vec_in = [&](int k) {
    T* const s = set(k);
    stage_in(at<TA>(s, S::A), Abar, NX * NX, k, B, b0);
    stage_in<NUC, BP>(at<TA>(s, S::B), Bbar, NX * NUC, k, B, b0);
    stage_in(at<TG>(s, S::K), K, NUC * NX, k, B, b0);
    stage_in(at<TG>(s, S::PC), Pc, NX, k, B, b0);
    stage_in(at<TG>(s, S::L), L, NLC, k, B, b0);
    stage_in(at<T>(s, S::Q), qx, NX, k, B, b0);
    stage_in(at<T>(s, S::R), ru, NUC, k, B, b0);
  };
  if constexpr (ROLL) {
    vec_in(M - 1);
    cp_wait();
  } else {
    // K5c: stages M-1 .. M-kVecSets+1 in flight, one group each
#pragma unroll
    for (int j = 1; j < kVecSets; ++j) {
      if (M - j >= 0) vec_in(M - j);
      cp_commit();
    }
    cp_wait_group<kVecSets - 2>();
  }
  __syncthreads();

  // backward vector pass; kff parks in du (K3) or goes to kff (K5c)
#pragma unroll 1
  for (int k = M - 1; k >= 0; --k) {
    T* const s = set(k);
    if constexpr (ROLL) {
      if (k > 0)
        vec_in(k - 1);
      else   // the rollout's stage-0 c, beside the A, B and K it reuses
        stage_in(at<TA>(s, S::C), cbar, NX, 0, B, b0);
    } else {
      // K5c: stage k-kVecSets+1 into the set stage k+1 freed (a group,
      // maybe empty)
      if (k - kVecSets + 1 >= 0) vec_in(k - kVecSets + 1);
      cp_commit();
    }
    const TA* const As = at<TA>(s, S::A) + l;
    const TA* const Bs = at<TA>(s, S::B) + l;
    const TG* const Ks = at<TG>(s, S::K) + l;

    // vector-pass Qu: m = p + Pc (threads 0-12, into X0 for the p update;
    // threads 0-7 all of it, in registers), Qu = r + B'm (threads 0-7)
    if (t < NX) {
      const TG* const Pcs = at<TG>(s, S::PC) + l;
      for (int i = t; i < NX; i += kGroup)
        w[(S::X0 + i) * kLanes] =
            w[(S::P + i) * kLanes] + cvt<T>(Pcs[i * kLanes]);
      if (t < NUC) {
        T m[NX];
#pragma unroll
        for (int j = 0; j < NX; ++j)
          m[j] = w[(S::P + j) * kLanes] + cvt<T>(Pcs[j * kLanes]);
        for (int a = t; a < NUC; a += kGroup) {
          T acc = cvt<T>(Bs[a * kLanes]) * m[0];
#pragma unroll
          for (int i = 1; i < NX; ++i)
            acc = acc + cvt<T>(Bs[(i * BP + a) * kLanes]) * m[i];
          w[(S::QU + a) * kLanes] = s[(S::R + a) * kLanes + l] + acc;
        }
      }
    }
    __syncthreads();

    // vector-pass p update: p <- q + A'm + K'Qu (threads 0-12)
    for (int i = t; i < NX; i += kGroup) {
      const T* const m = w + S::X0 * kLanes;
      T acc = a_at<DEV, T>(As, 0, i) * m[0];
#pragma unroll
      for (int j = 1; j < NX; ++j)
        acc = acc + a_at<DEV, T>(As, j, i) * m[j * kLanes];
      T v = cvt<T>(Ks[i * kLanes]) * w[S::QU * kLanes];
#pragma unroll
      for (int a = 1; a < NUC; ++a)
        v = v + cvt<T>(Ks[(a * NX + i) * kLanes]) * w[(S::QU + a) * kLanes];
      w[(S::P + i) * kLanes] = s[(S::Q + i) * kLanes + l] + acc + v;
    }
    // vector-pass kff solve: kff = -Quu^{-1} Qu (thread kGroup - 1)
    if (t == kGroup - 1) {
      T y[NUC];
#pragma unroll
      for (int a = 0; a < NUC; ++a) y[a] = w[(S::QU + a) * kLanes];
      // L read where used: the factor never sits in registers whole
      cho_solve<T, NUC>(Col<T, TG>{at<TG>(s, S::L) + l}, y);
#pragma unroll
      for (int a = 0; a < NUC; ++a) {
        const T kf = -y[a];
        if (valid) kff[((size_t)k * NUC + a) * B + b0 + l] = kf;
        if constexpr (ROLL) {
          if (k == 0) s[(S::KFF + a) * kLanes + l] = kf;
        }
      }
    }
    if constexpr (ROLL)
      cp_wait();       // stage k-1's inputs have landed (this thread's) ...
    else
      cp_wait_group<kVecSets - 2>();
    __syncthreads();   // ... everyone's, and stage k's slots are free
  }

  if constexpr (ROLL) {
    // forward rollout: du_k = K_k dx_k + kff_k, dx_{k+1} = A dx + B du + c.
    // Stage 0's inputs are in set 0; stage k+1's land while stage k
    // computes.
    for (int i = t; i < NX; i += kGroup)
      w[(S::X0 + i) * kLanes] = dx0[i * B + bl];
    __syncthreads();
    const auto roll_in = [&](int k) {
      T* const s = set(k);
      stage_in(at<TA>(s, S::A), Abar, NX * NX, k, B, b0);
      stage_in<NUC, BP>(at<TA>(s, S::B), Bbar, NX * NUC, k, B, b0);
      stage_in(at<TA>(s, S::C), cbar, NX, k, B, b0);
      stage_in(at<TG>(s, S::K), K, NUC * NX, k, B, b0);
      stage_in<0, 0, true>(at<T>(s, S::KFF), static_cast<const T*>(du), NUC,
                           k, B, b0);
    };
#pragma unroll 1
    for (int k = 0; k < M; ++k) {
      if (k + 1 < M) roll_in(k + 1);
      T* const s = set(k);
      const TA* const As = at<TA>(s, S::A) + l;
      const TA* const Bs = at<TA>(s, S::B) + l;
      const TG* const Ks = at<TG>(s, S::K) + l;
      const int xo = (k & 1) ? S::P : S::X0, xn = (k & 1) ? S::X0 : S::P;
      const T* const x = w + xo * kLanes;   // x_k: entry j at x[j kLanes]
      // rollout u: u = K x + kff (threads 0-7); dx_k out
      for (int a = t; a < NUC; a += kGroup) {
        T acc = cvt<T>(Ks[a * NX * kLanes]) * x[0];
#pragma unroll
        for (int j = 1; j < NX; ++j)
          acc = acc + cvt<T>(Ks[(a * NX + j) * kLanes]) * x[j * kLanes];
        const T u = acc + s[(S::KFF + a) * kLanes + l];
        w[(S::QU + a) * kLanes] = u;
        if (valid) du[((size_t)k * NUC + a) * B + b0 + l] = u;
      }
      if (valid) {
        for (int i = t; i < NX; i += kGroup)
          dx[((size_t)k * NX + i) * B + b0 + l] = x[i * kLanes];
      }
      __syncthreads();
      // rollout dx: dx_{k+1} = A x + B u + c (threads 0-12)
      for (int i = t; i < NX; i += kGroup) {
        T acc = a_at<DEV, T>(As, i, 0) * x[0];
#pragma unroll
        for (int j = 1; j < NX; ++j)
          acc = acc + a_at<DEV, T>(As, i, j) * x[j * kLanes];
        T v = cvt<T>(Bs[i * BP * kLanes]) * w[S::QU * kLanes];
#pragma unroll
        for (int a = 1; a < NUC; ++a)
          v = v + cvt<T>(Bs[(i * BP + a) * kLanes]) * w[(S::QU + a) * kLanes];
        w[(xn + i) * kLanes] =
            acc + v + cvt<T>(at<TA>(s, S::C)[(i * kLanes) + l]);
      }
      cp_wait();         // stage k+1's inputs have landed (this thread's) ...
      __syncthreads();   // ... everyone's, and stage k's slots are free
    }
    if (valid) {
      const int xo = (M & 1) ? S::P : S::X0;
      for (int i = t; i < NX; i += kGroup)
        dx[((size_t)M * NX + i) * B + b0 + l] = w[(xo + i) * kLanes];
    }
  }
}

template <typename T, typename TA = T, typename TG = T, bool DEV = false>
__global__ void __launch_bounds__(kThreads, min_blocks<T>())
corrector_sweep_c2_kernel(const TA* __restrict__ Abar,
                          const TA* __restrict__ Bbar,
                          const TA* __restrict__ cbar,
                          const T* __restrict__ qx, const T* __restrict__ ru,
                          const TG* __restrict__ K, const TG* __restrict__ L,
                          const TG* __restrict__ Pc,
                          const T* __restrict__ pterm,
                          const T* __restrict__ dx0, T* dx, T* du, int M,
                          int B) {
  sweep<T, TA, TG, DEV, true>(Abar, Bbar, cbar, qx, ru, K, L, Pc, pterm, dx0,
                              dx, du, du, M, B);
}

// K5c: the vector pass alone (bwd_vec_c2), exact forms only
template <typename T>
__global__ void __launch_bounds__(kThreads, min_blocks<T, false>())
bwd_vec_c2_kernel(const T* __restrict__ Abar, const T* __restrict__ Bbar,
                  const T* __restrict__ qx, const T* __restrict__ ru,
                  const T* __restrict__ K, const T* __restrict__ L,
                  const T* __restrict__ Pc, const T* __restrict__ pterm,
                  T* __restrict__ kff, int M, int B) {
  sweep<T, T, T, false, false>(Abar, Bbar, nullptr, qx, ru, K, L, Pc, pterm,
                               nullptr, nullptr, nullptr, kff, M, B);
}

template <typename T, typename TA, typename TG, bool DEV>
int set_smem() {
  if (smem_bytes<T>() <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      corrector_sweep_c2_kernel<T, TA, TG, DEV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>()));
}

template <typename T, typename TA, typename TG, bool DEV>
int launch(const TA* Abar, const TA* Bbar, const TA* cbar, const T* qx,
           const T* ru, const TG* K, const TG* L, const TG* Pc,
           const T* pterm, const T* dx0, T* dx, T* du, int M, int B,
           int grid, int threads, int smem, void* stream) {
  if (B < 1 || M < 1 || threads != kThreads || smem != smem_bytes<T>() ||
      grid != (B + kLanes - 1) / kLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = set_smem<T, TA, TG, DEV>();
  if (err != 0) return err;
  corrector_sweep_c2_kernel<T, TA, TG, DEV>
      <<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          Abar, Bbar, cbar, qx, ru, K, L, Pc, pterm, dx0, dx, du, M, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int set_vec_smem() {
  if (smem_bytes<T, false>() <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      bwd_vec_c2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<T, false>()));
}

template <typename T>
int launch_vec(const T* Abar, const T* Bbar, const T* qx, const T* ru,
               const T* K, const T* L, const T* Pc, const T* pterm, T* kff,
               int M, int B, int grid, int threads, int smem, void* stream) {
  if (B < 1 || M < 1 || threads != kThreads ||
      smem != smem_bytes<T, false>() || grid != (B + kLanes - 1) / kLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = set_vec_smem<T>();
  if (err != 0) return err;
  bwd_vec_c2_kernel<T>
      <<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          Abar, Bbar, qx, ru, K, L, Pc, pterm, kff, M, B);
  return static_cast<int>(cudaGetLastError());
}

// K5b: the rollout alone (fwd_c2), K3's in a kernel of its own; one set
// holds only the rollout's fields (K3's holds the vector pass's too).
constexpr int kSets = 2;                  // depth of K5b's input ring
namespace fwd_slot {
constexpr int BP = CorrLane::BP;        // Bbar's row pitch
constexpr int A = 0;                    // Abar (13x13)
constexpr int B = A + NX * NX;          // Bbar (13 rows of 8, pitch BP)
constexpr int K = B + NX * BP;          // K (8x13)
constexpr int C = K + NUC * NX;         // cbar
constexpr int KFF = C + NX;             // kff
constexpr int SET = KFF + NUC;          // one set of stage inputs (411)
constexpr int X0 = kSets * SET;         // the even stages' x
constexpr int X1 = X0 + NX;             // the odd stages' x
constexpr int U = X1 + NX;              // u
constexpr int END = U + NUC;
}  // namespace fwd_slot

constexpr int kFwdLaneValues = fwd_slot::END;
static_assert(kFwdLaneValues == 856, "fwd_launch_geometry's FWD_LANE_VALUES");

template <typename T>
constexpr int fwd_smem_bytes() {
  return kLanes * kFwdLaneValues * static_cast<int>(sizeof(T));
}

// What K5b's __launch_bounds__ asks for: the blocks an SM holds by shared
// memory (64 registers a thread in float32).
template <typename T>
constexpr int fwd_min_blocks() {
  return std::min(2048 / kThreads, (227 * 1024) / fwd_smem_bytes<T>());
}

template <typename T>
__global__ void __launch_bounds__(kThreads, fwd_min_blocks<T>())
fwd_c2_kernel(const T* __restrict__ Abar, const T* __restrict__ Bbar,
              const T* __restrict__ cbar, const T* __restrict__ K,
              const T* __restrict__ kff, const T* __restrict__ dx0, T* dx,
              T* du, int M, int B) {
  using namespace fwd_slot;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sh = reinterpret_cast<T*>(smem_raw);
  const int l = threadIdx.x % kLanes, t = threadIdx.x / kLanes;
  const int b0 = blockIdx.x * kLanes;
  const int bl = min(b0 + l, B - 1);   // the lane this group reads
  const bool valid = b0 + l < B;       // ... and whether it stores
  T* const w = sh + l;                 // the lane's column: entry r at r kLanes
  const auto set = [&](int k) { return sh + (k % kSets) * SET * kLanes; };
  const auto roll_in = [&](int k) {
    T* const s = set(k);
    stage_in(s + A * kLanes, Abar, NX * NX, k, B, b0);
    stage_in<NUC, BP>(s + fwd_slot::B * kLanes, Bbar, NX * NUC, k, B, b0);
    stage_in(s + C * kLanes, cbar, NX, k, B, b0);
    stage_in(s + fwd_slot::K * kLanes, K, NUC * NX, k, B, b0);
    stage_in(s + KFF * kLanes, kff, NUC, k, B, b0);
  };

  for (int i = t; i < NX; i += kGroup) w[(X0 + i) * kLanes] = dx0[i * B + bl];
  // stages 0 .. kSets-2 in flight, one group each
#pragma unroll
  for (int k = 0; k < kSets - 1; ++k) {
    if (k < M) roll_in(k);
    cp_commit();
  }
  cp_wait_group<kSets - 2>();
  __syncthreads();

#pragma unroll 1
  for (int k = 0; k < M; ++k) {
    // stage k+kSets-1 into the set stage k-1 freed (a group, maybe empty)
    if (k + kSets - 1 < M) roll_in(k + kSets - 1);
    cp_commit();
    const T* const s = set(k);
    const T* const As = s + A * kLanes + l;
    const T* const Bs = s + fwd_slot::B * kLanes + l;
    const T* const Ks = s + fwd_slot::K * kLanes + l;
    const int xo = (k & 1) ? X1 : X0, xn = (k & 1) ? X0 : X1;
    const T* const x = w + xo * kLanes;   // x_k: entry j at x[j kLanes]
    // K5b's u = K x + kff (threads 0-7)
    for (int a = t; a < NUC; a += kGroup) {
      T acc = Ks[a * NX * kLanes] * x[0];
#pragma unroll
      for (int j = 1; j < NX; ++j)
        acc = acc + Ks[(a * NX + j) * kLanes] * x[j * kLanes];
      const T u = acc + s[(KFF + a) * kLanes + l];
      w[(U + a) * kLanes] = u;
      if (valid) du[((size_t)k * NUC + a) * B + b0 + l] = u;
    }
    // K5b's x_k out
    if (valid) {
      for (int i = t; i < NX; i += kGroup)
        dx[((size_t)k * NX + i) * B + b0 + l] = x[i * kLanes];
    }
    __syncthreads();
    // K5b's dx_{k+1} = A x + B u + c (threads 0-12)
    for (int i = t; i < NX; i += kGroup) {
      T acc = As[i * NX * kLanes] * x[0];
#pragma unroll
      for (int j = 1; j < NX; ++j)
        acc = acc + As[(i * NX + j) * kLanes] * x[j * kLanes];
      T v = Bs[i * BP * kLanes] * w[U * kLanes];
#pragma unroll
      for (int a = 1; a < NUC; ++a)
        v = v + Bs[(i * BP + a) * kLanes] * w[(U + a) * kLanes];
      w[(xn + i) * kLanes] = acc + v + s[(C + i) * kLanes + l];
    }
    cp_wait_group<kSets - 2>();   // stage k+1's inputs have landed (this
    __syncthreads();        // thread's, then everyone's); set k is free
  }
  if (valid) {
    const int xo = (M & 1) ? X1 : X0;
    for (int i = t; i < NX; i += kGroup)
      dx[((size_t)M * NX + i) * B + b0 + l] = w[(xo + i) * kLanes];
  }
}

template <typename T>
int set_fwd_smem() {
  return static_cast<int>(cudaFuncSetAttribute(
      fwd_c2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      fwd_smem_bytes<T>()));
}

template <typename T>
int launch_fwd(const T* Abar, const T* Bbar, const T* cbar, const T* K,
           const T* kff, const T* dx0, T* dx, T* du, int M, int B, int grid,
           int threads, int smem, void* stream) {
  if (B < 1 || M < 1 || threads != kThreads ||
      smem != fwd_smem_bytes<T>() || grid != (B + kLanes - 1) / kLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = set_fwd_smem<T>();
  if (err != 0) return err;
  fwd_c2_kernel<T>
      <<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          Abar, Bbar, cbar, K, kff, dx0, dx, du, M, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// FORM in the symbol: "" the exact form, _g bf16 gains (K, L, Pc), _a the
// deviation-coded bf16 stage stream (Abar - I, Bbar, cbar), _ga both.  grid,
// threads and smem are the wrapper's corr_launch_geometry.
#define CORR_ENTRY(FORM, SUFFIX, T, TA, TG, DEV)                              \
  extern "C" int corrector_sweep_c2##FORM##_##SUFFIX(                         \
      const TA* Abar, const TA* Bbar, const TA* cbar, const T* qx,            \
      const T* ru, const TG* K, const TG* L, const TG* Pc, const T* pterm,    \
      const T* dx0, T* dx, T* du, int M, int B, int grid, int threads,        \
      int smem, void* stream) {                                               \
    return launch<T, TA, TG, DEV>(Abar, Bbar, cbar, qx, ru, K, L, Pc, pterm,  \
                                  dx0, dx, du, M, B, grid, threads, smem,     \
                                  stream);                                    \
  }

#define CORR_OCCUPANCY(SUFFIX, T)                                             \
  extern "C" int corrector_sweep_c2_occupancy_##SUFFIX(int* blocks_per_sm) {  \
    const int err = set_smem<T, T, T, false>();                               \
    if (err != 0) return err;                                                 \
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(    \
        blocks_per_sm, corrector_sweep_c2_kernel<T, T, T, false>, kThreads,   \
        smem_bytes<T>()));                                                    \
  }

using bf16 = __nv_bfloat16;
CORR_ENTRY(, f32, float, float, float, false)
CORR_ENTRY(, f64, double, double, double, false)
CORR_ENTRY(_g, f32, float, float, bf16, false)
CORR_ENTRY(_g, f64, double, double, bf16, false)
CORR_ENTRY(_a, f32, float, bf16, float, true)
CORR_ENTRY(_a, f64, double, bf16, double, true)
CORR_ENTRY(_ga, f32, float, bf16, bf16, true)
CORR_ENTRY(_ga, f64, double, bf16, bf16, true)
CORR_OCCUPANCY(f32, float)
CORR_OCCUPANCY(f64, double)

// K5b; grid, threads and smem are the wrapper's fwd_launch_geometry.
#define FWD_ENTRY(SUFFIX, T)                                                  \
  extern "C" int fwd_c2_##SUFFIX(const T* Abar, const T* Bbar,                \
                                 const T* cbar, const T* K, const T* kff,     \
                                 const T* dx0, T* dx, T* du, int M, int B,    \
                                 int grid, int threads, int smem,             \
                                 void* stream) {                              \
    return launch_fwd<T>(Abar, Bbar, cbar, K, kff, dx0, dx, du, M, B, grid,   \
                         threads, smem, stream);                              \
  }                                                                           \
  extern "C" int fwd_c2_occupancy_##SUFFIX(int* blocks_per_sm) {              \
    const int err = set_fwd_smem<T>();                                        \
    if (err != 0) return err;                                                 \
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(    \
        blocks_per_sm, fwd_c2_kernel<T>, kThreads, fwd_smem_bytes<T>()));     \
  }

FWD_ENTRY(f32, float)
FWD_ENTRY(f64, double)

// K5c (bwd_vec_c2, no compressed forms: windowed=True drops them); grid,
// threads and smem are the wrapper's bwd_vec_launch_geometry.
#define BWD_VEC_ENTRY(SUFFIX, T)                                              \
  extern "C" int bwd_vec_c2_##SUFFIX(                                         \
      const T* Abar, const T* Bbar, const T* qx, const T* ru, const T* K,     \
      const T* L, const T* Pc, const T* pterm, T* kff, int M, int B,          \
      int grid, int threads, int smem, void* stream) {                        \
    return launch_vec<T>(Abar, Bbar, qx, ru, K, L, Pc, pterm, kff, M, B,      \
                         grid, threads, smem, stream);                        \
  }                                                                           \
  extern "C" int bwd_vec_c2_occupancy_##SUFFIX(int* blocks_per_sm) {          \
    const int err = set_vec_smem<T>();                                        \
    if (err != 0) return err;                                                 \
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(    \
        blocks_per_sm, bwd_vec_c2_kernel<T>, kThreads,                        \
        smem_bytes<T, false>()));                                             \
  }

BWD_VEC_ENTRY(f32, float)
BWD_VEC_ENTRY(f64, double)
