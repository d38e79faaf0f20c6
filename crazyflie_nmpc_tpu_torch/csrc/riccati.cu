// Sweeps of the uncondensed diagonal-cost QP (N stages, 13 states, 4
// inputs): the path of condense=1 and of every odd horizon.
//
// Replaces, in crazyflie_nmpc_tpu/ops/pallas/riccati_kernels.py:
//   kkt_sweep       (_kkt_kernel, _chol4, _cho_solve4, _cho_solve4_vec)
//                   -> kkt_sweep_kernel (K8a)
//   corrector_sweep (_corrector_kernel) -> corrector_sweep_kernel (K8b)
//   and the split forms of solve_batched(fused=False):
//   backward_sweep  (_backward_kernel) -> backward_sweep_kernel (K9a),
//                   K8a's factorization without its rollout
//   forward_sweep   (_forward_kernel) -> forward_sweep_kernel (K9b),
//                   K8a's rollout alone
//   backward_vector_sweep (_backward_vec_kernel)
//                   -> backward_vector_sweep_kernel (K9c)
// The JAX package computes the last rollout state dx[N] outside its Pallas
// kernels (an einsum after the launch); these kernels write it themselves.
// The 4x4 Cholesky is the rsqrt form, packed column-major lower,
// [l00,l10,l20,l30,l11,l21,l31,l22,l32,l33] (riccati_kernels._chol4).
//
// K8a and K9a: a group of threads per lane, on K2's design
// (kkt_sweep_c2.cu).  What bounds them on the H100: per stage and lane the
// factorization reads 268 values and writes 79 for ~7.3k multiply-adds,
// and the rollout re-reads 290 and writes 17: bytes, 0.09 ms at N=50,
// B=4096 in float32.  One thread per lane (their form before) made each
// stage one thread's serial chain of those multiply-adds, with P, PA, Qux
// and K spilled to local memory, in 64 blocks of 2 warps at B=4096: ~25x
// the bound.  Here kGroup = 16 threads share one lane's stage, and the
// lane's state and stage inputs live in shared memory:
//   * the stage inputs land by cp.async, A and B transposed so that their
//     columns are rows.  Each copy is of one value: a lane's entries lie B
//     apart in device memory and its slots are lane-major, so no two
//     values a thread copies are neighbours at both ends;
//   * every product is split over the group by column: a thread holds one
//     column of the right-hand matrix in registers and streams the rows of
//     the left one through 16-byte vector loads of rows padded to 16.
//     Phase A, P [A | B | c], has 18 columns of 13 dot products: the first
//     16 go one to a thread, and the last two (B's fourth column and c) by
//     row, their 26 dot products over the 16 threads.  Phase B, B' [PA | m
//     | PB], is 16 jobs, one to a thread: Qux's 13 columns and Qu (4 dot
//     products each), and Quu's lower triangle as its columns 0 and 3, and
//     1 and 2 (5 each).  Phase D is X = A'PA + Qux'K + diag(qxx), one
//     column a thread, with p <- qx + A'm + K'Qu as the 14th job; then P <-
//     sym(X) by pairs;
//   * phase C: the 4x4 rsqrt Cholesky of Quu (chol<T, 4>) in every thread
//     (the same instructions, so the same bits), then threads 0-12 each
//     solve one column of K and thread 13 kff;
//   * K8a's rollout runs the stages forward with its inputs round a ring of
//     kSets = 3 slot sets in the slots the factorization is done with:
//     stages k+1 and k+2 land while stage k computes (with two sets, K2's
//     ring, the kernel ran 2% slower at B=1024 and 5% at B=8192, within
//     1% at 4096: roofline/kkt_variants.py, PERF.md).  It reads the gains
//     this launch wrote, after __syncthreads, through L1 (the lines were
//     not cached before the writes), as K2's does.
// Every sum keeps the order of the one-thread kernel this replaces and of
// c2_stage.cuh's rollout_stage, so K9a's K, kff, L and Pc equal K8a's bit
// for bit (one body, `sweep<T, ROLL>`), and K8a's dx and du equal K9b's on
// K8a's gains.
//
// Tile and geometry: kLanes = 8 consecutive lanes a block (kThreads =
// 128), so the block's loads of one entry fill one 32-byte sector of a
// batch-last row; inputs arrive and gains leave in the flat (entry, lane)
// order.  Shared memory: kStride = 1004 values a lane (996 of slots), so
// 32,128 bytes a block in float32 and 64,256 in float64 (the opt-in
// attribute).  In float32 registers, not shared memory, decide the blocks
// an SM holds: `__launch_bounds__` caps a thread at 128 (4 blocks), and
// `ptxas -v` gives K8a 99, no spills (4 blocks an SM: 4224 lanes on 132
// SMs, so B=4096 runs in one wave and B=8192 in two), K9a 72 (7 blocks,
// as many as shared memory allows); in float64 119 and 94 (3 blocks, by
// shared memory).  Asking for 8 blocks (64 registers) was slower at every
// B, and G = 8 or 32, or 16 lanes a block, slower at B=1024 and 4096
// (roofline/kkt_variants.py, PERF.md).
// The wrapper (ops/cuda/riccati_kernels.riccati_launch_geometry) computes
// grid, block and shared bytes; the launch refuses numbers that disagree
// with these.  A ragged tile's spare groups read the last lane, store
// nothing and take part in every barrier.
//
// K9b: a group of threads per lane, on K5b's design (corrector_sweep_c2.cu's
// fwd_c2): the rollout alone, from the gains K9a wrote.  What bounds it:
// bytes, 290 values read and 17 written a stage and lane for 273
// multiply-adds: 251 MB at N=50, B=4096 in float32, 0.075 ms at 3.35 TB/s,
// a stream past the 50 MB L2.  One thread per lane (its form before) ran
// 64 of the 132 SMs there, each thread's ~290 loads of a stage one
// dependent chain: 0.83 ms.  Here kFwdGroup = 16 threads share one lane's
// stage, kFwdLanes = 16 lanes a block (kFwdThreads = 256):
//   * the stage inputs land in [entry][lane] slots round a ring of
//     kFwdSets = 2 sets, one commit group a stage: stage k+1's copies land
//     while stage k computes.  A full tile of a batch-last row (16 lanes
//     of one entry: 64 bytes in float32, 128 in float64) goes in 16-byte
//     copies (cp.async.cg, K3's tile-row copies, `tile::stage_in`), a
//     ragged or unaligned one value by value;
//   * a u phase (threads 0-3, 4 dot products of 13) and a dx phase
//     (threads 0-12, 13 of 17), two barriers a stage; thread t of lane l
//     reads entry e at row e, so a warp's two t read rows an odd stride
//     apart (Bm padded to a pitch of 5, A's rows 13): 32 distinct banks in
//     float32;
//   * the sums are K8a's rollout's term for term, so K9b on K8a's gains
//     equals K8a's dx and du bit for bit.
// Shared memory: kFwdLaneValues = 636 values a lane (two sets of 303 and
// the state), 40,704 bytes a block in float32 (5 blocks an SM by shared
// memory; `__launch_bounds__` asks for 4, 64 registers a thread, so B=8192
// runs in one wave) and 81,408 in float64 (2, the opt-in attribute).  The
// wrapper (ops/cuda/riccati_kernels.forward_launch_geometry) computes grid,
// block and shared bytes; the launch refuses numbers that disagree.
//
// K8b and K9c: one group body, `vec_sweep_group<T, ROLLOUT>`, on K3's
// design (corrector_sweep_c2.cu) at 4 inputs, on K9b's group and block:
// the backward vector pass on the stored factorization (K, L, Pc), then for
// K8b (ROLLOUT) K9b's rollout; K9c is the body with the rollout compiled
// out, its kff written to its own array (K8b parks it in du).  What bounds
// them: bytes.  Per stage and lane the vector pass reads 313 values for
// ~290 multiply-adds, K8b's rollout 290 more (it re-reads A, B and K) for
// 273, and they write 17 (K8b) or 4 (K9c): 281 MB and 260 MB at N=50,
// B=4096 in float32, 0.084 and 0.078 ms at 3.35 TB/s, a stream past the
// 50 MB L2.  One thread per lane (their form before, c2_stage.cuh's stage
// bodies) ran 64 of the 132 SMs at B=4096, each thread's loads of a stage
// one dependent chain: 0.70 and 0.58 ms.  Here:
//   * the stage inputs land in [entry][lane] slots round a ring of
//     kVecSets = 3 sets (343 values a lane each: the vector pass's fields
//     and the rollout's c and kff, which K9c leaves unused), one commit
//     group a stage, by K9b's tile copies (`tile::stage_in`): stages k-1
//     and k-2 (vector pass) or k+1 and k+2 (rollout) land while stage k
//     computes;
//   * the stage's chain is K3's: threads 0-12 form m = p + Pc, threads 0-3
//     Qu (4 dot products of 13, m in registers), then threads 0-12 each
//     update one entry of p (a dot product of 13 and one of 4) while
//     thread kFwdGroup - 1, which p leaves idle, solves and stores kff; two
//     barriers a stage;
//   * at the turn, K8b's rollout stage 0 reads A, B and K where the vector
//     pass left them (its c lands during the pass's last stage, its kff is
//     written there); later stages read the parked kff back through L2
//     (cp.async.cg, or __ldcg value by value);
//   * Bm's rows are padded to a pitch of 5, so a warp's two threads a lane
//     read distinct banks in float32, as in K9b.
// The vector pass sums in c2_stage.cuh's vec_stage order and the rollout in
// K9b's, so K9c's kff equals the kff K8b parks and K9c then K9b equal K8b's
// dx and du bit for bit.  Shared memory: kVecLaneValues = 1059 values a
// lane, 67,776 bytes a block in float32 (3 blocks an SM with the 1 KB a
// block reserves, what `__launch_bounds__` asks for: 85 registers a thread)
// and 135,552 in float64 (1); both need the opt-in attribute.  `ptxas -v`:
// K8b 69 registers in float32, 110 in float64, K9c 62 and 101, no spills.
// At N=50, B=4096 K8b takes 0.187 ms (2.2x its bound; the loads 0.12 of
// it, the rollout 0.09) and K9c 0.099 (1.27x).  Two sets (4 blocks an SM)
// ran 7-11% slower at B=4096, the paths' batch, and 26-28% faster at
// B=8192, which they ran in one wave; 32 lanes a block with three sets won
// at B=4096 and 8192 in float32, but its float64 block would not fit
// (roofline/kkt_variants.py, PERF.md).  The
// wrapper (ops/cuda/riccati_kernels.vector_launch_geometry) computes grid,
// block and shared bytes; the launch refuses numbers that disagree.  A
// ragged tile's spare groups read the last lane, store nothing and take
// part in every barrier.
#include <algorithm>
#include <cstdint>
#include <cstring>

#include "c2_stage.cuh"

using namespace cfl;

namespace {

constexpr int NL = NU * (NU + 1) / 2;  // packed 4x4 Cholesky entries

// ---- K8a and K9a -----------------------------------------------------------

constexpr int kGroup = 16;                 // threads per lane
constexpr int kThreads = 128;              // threads per block
constexpr int kLanes = kThreads / kGroup;  // lanes per block
constexpr int kSets = 3;                   // depth of the rollout's ring

// One lane's shared-memory slots (offsets in values of the compute type).
namespace slot {
// Rows of 13 are padded to 16 values and rows of 4 start every 4, each row
// 16-byte aligned, so a row is read with 16-byte vector loads (ld_row).  A,
// B and the products the stage reads by column are kept transposed: AT row
// j is column j of A, PAT row j column j of P A.
constexpr int RW = 16;                  // the pitch of a 13-row
constexpr int P = 0;                    // P (13 rows)
constexpr int PAT = P + NX * RW;        // (P A)^T (13 rows)
constexpr int PBT = PAT + NX * RW;      // (P B)^T (4 rows)
constexpr int AT = PBT + NU * RW;       // A^T (13 rows)
constexpr int BT = AT + NX * RW;        // B^T (4 rows)
constexpr int QUXT = BT + NU * RW;      // Qux^T (13 rows of 4)
constexpr int KT = QUXT + NX * NU;      // K^T (13 rows of 4)
constexpr int QUU = KT + NX * NU;       // Quu (4x4, lower triangle)
constexpr int L = QUU + NU * NU;        // packed Cholesky factor (10 of 12)
constexpr int PV = L + 12;              // p
constexpr int MV = PV + RW;             // m = p + Pc
constexpr int PC = MV + RW;             // Pc = P c
constexpr int C = PC + RW;              // c
constexpr int QU = C + RW;              // Qu (4)
constexpr int KFF = QU + NU;            // kff (4)
constexpr int QXX = KFF + NU;           // qxx, the state cost's diagonal
constexpr int QX = QXX + RW;            // qx
constexpr int RS = QX + RW;             // ruu, the shifted input diagonal
constexpr int RU = RS + NU;             // ru
constexpr int END = RU + NU;
// the rollout's ring of kSets input sets (RSET values apart, unpadded
// rows) and its state, in slots the factorization is done with
constexpr int RA = 0, RB = RA + NX * NX, RC = RB + NX * NU,
              RK = RC + NX, RKFF = RK + NU * NX, RSET = RKFF + NU;
constexpr int X0 = kSets * RSET, X1 = X0 + NX, U = X1 + NX;
static_assert(U + NU <= END, "the rollout's slots fit the lane's");
static_assert(PAT % 4 == 0 && PBT % 4 == 0 && AT % 4 == 0 && BT % 4 == 0 &&
                  QUXT % 4 == 0 && KT % 4 == 0 && PV % 4 == 0 &&
                  MV % 4 == 0 && PC % 4 == 0 && C % 4 == 0 && QU % 4 == 0,
              "rows start 16-byte aligned in both dtypes");
}  // namespace slot

// 1004 a lane: 16-byte aligned, and two lanes' same entry 12 banks apart
constexpr int kStride = slot::END + 8;
static_assert(kStride == 1004, "riccati_launch_geometry's LANE_VALUES");

template <typename T>
constexpr int smem_bytes() {
  return kLanes * kStride * static_cast<int>(sizeof(T));
}

// What __launch_bounds__ asks for: 512 threads an SM in float32 (128
// registers a thread), 256 in float64 (255).
template <typename T>
constexpr int min_blocks() {
  return (sizeof(T) == 4 ? 512 : 256) / kThreads;
}

// Global -> shared copies that hold no registers (K2's): each thread keeps
// its copies in flight (cp.async); copy_wait() waits for all of them, and
// cp_wait_group<n>() for all but the newest n groups (cp_commit() closes a
// group); __syncthreads() after it makes every thread's copies visible.
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
__device__ __forceinline__ void cp_commit() {
  CFL_ASM(asm volatile("cp.async.commit_group;\n" ::: "memory"), (void)0);
}
template <int pending>
__device__ __forceinline__ void cp_wait_group() {
  CFL_ASM(asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory"),
          (void)0);
}

// Entries [0, n) of stage k of a batch-last input into every lane's slot
// `dst`: entry r at dst + r, or with NCOL > 0 (an input of rows of NCOL)
// transposed, entry (i, j) at dst + j PITCH + i.  Thread f of the flat
// (entry, lane) order takes entry f / kLanes of lane f % kLanes, so 8
// neighbouring threads read one 32-byte sector.
template <int NCOL = 0, int PITCH = 0, typename T>
__device__ __forceinline__ void stage_in(T* sh, int dst, const T* src, int n,
                                         int k, int B, int b0) {
#pragma unroll 4
  for (int f = threadIdx.x; f < n * kLanes; f += kThreads) {
    const int r = f / kLanes, l = f % kLanes;
    const int at = NCOL ? (r % NCOL) * PITCH + r / NCOL : r;
    copy_async(sh + l * kStride + dst + at,
               src + ((size_t)k * n + r) * B + min(b0 + l, B - 1));
  }
}

// Slot `src` of every lane into entries [0, n) of stage k of a batch-last
// output, in the same order (NCOL, PITCH: the slot holds the transpose, as
// in stage_in); a ragged tile's spare lanes store nothing.
template <int NCOL = 0, int PITCH = 0, typename T>
__device__ __forceinline__ void stage_out(T* dst, const T* sh, int src, int n,
                                          int k, int B, int b0) {
  for (int f = threadIdx.x; f < n * kLanes; f += kThreads) {
    const int r = f / kLanes, l = f % kLanes;
    const int at = NCOL ? (r % NCOL) * PITCH + r / NCOL : r;
    if (b0 + l < B)
      dst[((size_t)k * n + r) * B + b0 + l] = sh[l * kStride + src + at];
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

// The backward factorization, then with ROLL the forward rollout: K8a's
// sweep, and K9a's (ROLL false: no rollout, dx0, dx and du unused).
template <typename T, bool ROLL>
__device__ __forceinline__ void sweep(
    const T* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ c, const T* __restrict__ qxx,
    const T* __restrict__ qx, const T* __restrict__ ruu,
    const T* __restrict__ ru, const T* __restrict__ pT,
    const T* __restrict__ pterm, const T* __restrict__ dx0, T* K, T* kff,
    T* Lout, T* Pcout, T* dx, T* du, int N, int B) {
  using namespace slot;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sh = reinterpret_cast<T*>(smem_raw);
  const int l = threadIdx.x / kGroup, t = threadIdx.x % kGroup;
  const int b0 = blockIdx.x * kLanes;
  const int bl = min(b0 + l, B - 1);   // the lane this group reads
  const bool valid = b0 + l < B;       // ... and whether it stores
  T* const w = sh + l * kStride;

  // terminal cost-to-go: P = diag(pT), p = p_term
  for (int e = t; e < NX * NX; e += kGroup) {
    const int i = e / NX, j = e % NX;
    w[P + i * RW + j] = (i == j) ? pT[i * B + bl] : T(0);
  }
  for (int i = t; i < NX; i += kGroup) w[PV + i] = pterm[i * B + bl];

  // column `col` of [A | B | c] (a row of AT or BT, or c), and where
  // column col of P [A | B | c] goes (a row of PAT or PBT, or Pc)
  constexpr int kCols = NX + NU + 1;
  constexpr int kWhole = kCols / kGroup * kGroup;  // the columns taken whole
  const auto src_of = [](int col) {
    return col < NX ? AT + col * RW : col < NX + NU ? BT + (col - NX) * RW : C;
  };
  const auto dst_of = [](int col) {
    return col < NX ? PAT + col * RW
                    : col < NX + NU ? PBT + (col - NX) * RW : PC;
  };

#pragma unroll 1
  for (int k = N - 1; k >= 0; --k) {
    __syncthreads();   // the last stage's readers of the input slots are done
    stage_in<NX, RW>(sh, AT, A, NX * NX, k, B, b0);
    stage_in<NU, RW>(sh, BT, Bm, NX * NU, k, B, b0);
    stage_in(sh, C, c, NX, k, B, b0);
    stage_in(sh, QXX, qxx, NX, k, B, b0);
    stage_in(sh, QX, qx, NX, k, B, b0);
    stage_in(sh, RS, ruu, NU, k, B, b0);
    stage_in(sh, RU, ru, NU, k, B, b0);
    copy_wait();
    __syncthreads();

    // P [A | B | c] (phase A): the first kWhole columns one a thread, the
    // rest by (column, row); column j of P A into PAT row j, of P B into
    // PBT, P c into Pc and m = p + Pc
#pragma unroll 1
    for (int col = t; col < kWhole; col += kGroup) {
      T x[NX];
      ld_row(w + src_of(col), x);
      const int dst = dst_of(col);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T pr[NX];
        ld_row(w + P + i * RW, pr);
        const T s = dot(pr, x);
        w[dst + i] = s;
        if (col == NX + NU) w[MV + i] = w[PV + i] + s;
      }
    }
#pragma unroll 1
    for (int e = t; e < (kCols - kWhole) * NX; e += kGroup) {
      const int col = kWhole + e / NX, i = e % NX;
      T x[NX], pr[NX];
      ld_row(w + src_of(col), x);
      ld_row(w + P + i * RW, pr);
      const T s = dot(pr, x);
      w[dst_of(col) + i] = s;
      if (col == NX + NU) w[MV + i] = w[PV + i] + s;
    }
    __syncthreads();

    // B' [PA | m | PB] (phase B), 16 jobs: column j of PA gives Qux[:, j]
    // = B'PA[:, j] (S = 0; into QUXT row j), m gives Qu = ru + B'm, and
    // columns h and 3 - h of PB (job 14 + h) give Quu[a2:, a2] = B'PB +
    // diag(ruu) (the lower triangle)
#pragma unroll 1
    for (int job = t; job < NX + 3; job += kGroup) {
      if (job <= NX) {
        T y[NX];
        ld_row(w + (job < NX ? PAT + job * RW : MV), y);
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          T bt[NX];
          ld_row(w + BT + a * RW, bt);
          const T s = dot(bt, y);
          if (job < NX)
            w[QUXT + job * NU + a] = s;
          else
            w[QU + a] = w[RU + a] + s;
        }
        continue;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int h = job - NX - 1;
        const int a2 = half ? NU - 1 - h : h;   // Quu's column
        T y[NX];
        ld_row(w + PBT + a2 * RW, y);
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          if (a < a2) continue;
          T bt[NX];
          ld_row(w + BT + a * RW, bt);
          T s = dot(bt, y);
          if (a == a2) s = s + w[RS + a];
          w[QUU + a * NU + a2] = s;
        }
      }
    }
    __syncthreads();

    // L = chol(Quu) in every thread (phase C); K = -Quu^{-1} Qux one
    // column a thread (into KT row j), kff = -Quu^{-1} Qu the 14th job
    {
      T Qm[NU][NU], Lp[NL];
#pragma unroll
      for (int a = 0; a < NU; ++a) {
#pragma unroll
        for (int a2 = 0; a2 < NU; ++a2)
          Qm[a][a2] = (a2 <= a) ? w[QUU + a * NU + a2] : T(0);
      }
      chol<T, NU>(Qm, Lp);
#pragma unroll 1
      for (int col = t; col <= NX; col += kGroup) {
        T y[NU];
        ld_row(w + (col < NX ? QUXT + col * NU : QU), y);
        cho_solve<T, NU>(Lp, y);
        const int dst = col < NX ? KT + col * NU : KFF;
#pragma unroll
        for (int a = 0; a < NU; ++a) w[dst + a] = -y[a];
      }
      if (t == kGroup - 1) {
#pragma unroll
        for (int q = 0; q < NL; ++q) w[L + q] = Lp[q];
      }
    }
    __syncthreads();

    // the stage's gains out
    stage_out<NX, NU>(K, sh, KT, NU * NX, k, B, b0);
    stage_out(kff, sh, KFF, NU, k, B, b0);
    stage_out(Lout, sh, L, NL, k, B, b0);
    stage_out(Pcout, sh, PC, NX, k, B, b0);

    // X = A'PA + Qux'K + diag(qxx) one column a thread (phase D; into P,
    // before the symmetrization); the 14th job p <- qx + A'm + K'Qu
#pragma unroll 1
    for (int j = t; j <= NX; j += kGroup) {
      const bool pj = j == NX;
      T y1[NX], y2[NU];
      ld_row(w + (pj ? MV : PAT + j * RW), y1);
      ld_row(w + (pj ? QU : KT + j * NU), y2);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T x1[NX], x2[NU];
        ld_row(w + AT + i * RW, x1);
        ld_row(w + (pj ? KT : QUXT) + i * NU, x2);
        const T s = dot(x1, y1);
        const T u = dot(x2, y2);
        if (pj)
          w[PV + i] = w[QX + i] + s + u;
        else
          w[P + i * RW + j] = (i == j) ? (s + u) + w[QXX + i] : s + u;
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
    // on the gains just written.  Its inputs go round a ring of kSets slot
    // sets, one commit group a stage: stage k+kSets-1's copies land while
    // stage k computes.
    const auto roll_in = [&](int k) {
      const int o = (k % kSets) * RSET;
      stage_in(sh, RA + o, A, NX * NX, k, B, b0);
      stage_in(sh, RB + o, Bm, NX * NU, k, B, b0);
      stage_in(sh, RC + o, c, NX, k, B, b0);
      stage_in(sh, RK + o, static_cast<const T*>(K), NU * NX, k, B, b0);
      stage_in(sh, RKFF + o, static_cast<const T*>(kff), NU, k, B, b0);
    };
    __syncthreads();   // the gains are written, the last P update is done
    for (int i = t; i < NX; i += kGroup) w[X0 + i] = dx0[i * B + bl];
#pragma unroll
    for (int k = 0; k < kSets - 1; ++k) {
      if (k < N) roll_in(k);
      cp_commit();
    }
    cp_wait_group<kSets - 2>();
    __syncthreads();
#pragma unroll 1
    for (int k = 0; k < N; ++k) {
      // stage k+kSets-1 into the set stage k-1 freed (a group, maybe empty)
      if (k + kSets - 1 < N) roll_in(k + kSets - 1);
      cp_commit();
      const int o = (k % kSets) * RSET;
      const T* x = w + ((k & 1) ? X1 : X0);
      T* xn = w + ((k & 1) ? X0 : X1);
      const T* Kk = w + RK + o;
      for (int a = t; a < NU; a += kGroup) {
        T s = Kk[a * NX] * x[0];
#pragma unroll
        for (int j = 1; j < NX; ++j) s = s + Kk[a * NX + j] * x[j];
        const T u = s + w[RKFF + o + a];
        w[U + a] = u;
        if (valid) du[((size_t)k * NU + a) * B + b0 + l] = u;
      }
      if (valid) {
        for (int i = t; i < NX; i += kGroup)
          dx[((size_t)k * NX + i) * B + b0 + l] = x[i];
      }
      __syncthreads();
      const T* As = w + RA + o;
      const T* Bs = w + RB + o;
      const T* u = w + U;
      for (int i = t; i < NX; i += kGroup) {
        T s = As[i * NX] * x[0];
#pragma unroll
        for (int j = 1; j < NX; ++j) s = s + As[i * NX + j] * x[j];
        T v = Bs[i * NU] * u[0];
#pragma unroll
        for (int a = 1; a < NU; ++a) v = v + Bs[i * NU + a] * u[a];
        xn[i] = s + v + w[RC + o + i];
      }
      cp_wait_group<kSets - 2>();   // stage k+1's inputs have landed (this
      __syncthreads();              // thread's, then everyone's), and stage
                                    // k's set is free
    }
    if (valid) {
      const T* x = w + ((N & 1) ? X1 : X0);
      for (int i = t; i < NX; i += kGroup)
        dx[((size_t)N * NX + i) * B + b0 + l] = x[i];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, min_blocks<T>())
kkt_sweep_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ c, const T* __restrict__ qxx,
                 const T* __restrict__ qx, const T* __restrict__ ruu,
                 const T* __restrict__ ru, const T* __restrict__ pT,
                 const T* __restrict__ pterm, const T* __restrict__ dx0,
                 T* K, T* kff, T* Lout, T* Pcout, T* dx, T* du, int N,
                 int B) {
  sweep<T, true>(A, Bm, c, qxx, qx, ruu, ru, pT, pterm, dx0, K, kff, Lout,
                 Pcout, dx, du, N, B);
}

// K9a: the factorization alone (fused=False)
template <typename T>
__global__ void __launch_bounds__(kThreads, min_blocks<T>())
backward_sweep_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ c, const T* __restrict__ qxx,
                      const T* __restrict__ qx, const T* __restrict__ ruu,
                      const T* __restrict__ ru, const T* __restrict__ pT,
                      const T* __restrict__ pterm, T* K, T* kff, T* Lout,
                      T* Pcout, int N, int B) {
  sweep<T, false>(A, Bm, c, qxx, qx, ruu, ru, pT, pterm, nullptr, K, kff,
                  Lout, Pcout, nullptr, nullptr, N, B);
}

// A kernel's launch shape: `lanes` lanes of `threads` threads a block and
// `smem` bytes of shared memory a block (K8a's and K9a's here; K9b's,
// K8b's and K9c's below).
struct Shape {
  int lanes, threads, smem;
};
template <typename T>
constexpr Shape riccati_shape() {
  return {kLanes, kThreads, smem_bytes<T>()};
}

// The opt-in to the shared bytes a block of `kernel` takes, above 48 KB.
template <typename F>
int opt_in(F kernel, Shape s) {
  if (s.smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem));
}

// Whether a launch (grid, threads, smem) at N stages and B lanes disagrees
// with the shape `s`.
inline bool refused(Shape s, int N, int B, int grid, int threads, int smem) {
  return B < 1 || N < 1 || threads != s.threads || smem != s.smem ||
         grid != (B + s.lanes - 1) / s.lanes;
}

template <typename F>
int occupancy(F kernel, Shape s, int* blocks_per_sm) {
  const int err = opt_in(kernel, s);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, s.threads, s.smem));
}

// ---- K9b: a group of threads per lane, on K5b's design ---------------------

constexpr int kFwdGroup = 16;                       // threads per lane
constexpr int kFwdThreads = 256;                    // threads per block
constexpr int kFwdLanes = kFwdThreads / kFwdGroup;  // lanes per block
constexpr int kFwdSets = 2;                         // depth of the input ring

// One lane's slots, [entry][lane]: entry r of a field at row r of kFwdLanes
// values (K5b's layout; K8a's slots are lane-major).
namespace fwd_slot {
constexpr int BP = NU + 1;              // Bm's row pitch (odd: see below)
constexpr int A = 0;                    // A (13x13)
constexpr int B = A + NX * NX;          // Bm (13 rows of 4, pitch BP)
constexpr int K = B + NX * BP;          // K (4x13)
constexpr int C = K + NU * NX;          // c
constexpr int KFF = C + NX;             // kff
constexpr int SET = KFF + NU;           // one set of stage inputs (303)
constexpr int X0 = kFwdSets * SET;      // the even stages' x
constexpr int X1 = X0 + NX;             // the odd stages' x
constexpr int U = X1 + NX;              // u
constexpr int END = U + NU;
}  // namespace fwd_slot

constexpr int kFwdLaneValues = fwd_slot::END;
static_assert(kFwdLaneValues == 636,
              "forward_launch_geometry's FORWARD_LANE_VALUES");

template <typename T>
constexpr int fwd_smem_bytes() {
  return kFwdLanes * kFwdLaneValues * static_cast<int>(sizeof(T));
}

// What K9b's __launch_bounds__ asks for: the blocks an SM holds by shared
// memory, at most 4 (64 registers a thread; B=8192 in one wave).
template <typename T>
constexpr int fwd_min_blocks() {
  return std::min(1024 / kFwdThreads, (227 * 1024) / fwd_smem_bytes<T>());
}

// K3's tile-row copies (corrector_sweep_c2.cu's stage_in, its exact forms)
// and lane columns, kept here so that K3's source stays as it is.
namespace tile {
// Entries [0, n) of stage k of a batch-last input into the field `dst`:
// entry r of the block's lane l at dst[row(r) kFwdLanes + l], row(r) = r
// or, with NCOL > 0 (rows of NCOL entries), r / NCOL * PITCH + r % NCOL.  A
// full, 16-byte aligned tile goes in 16-byte copies (cp.async.cg), the
// others value by value, spare lanes reading lane B-1.  FRESH: the input
// is this launch's own output, read through L2.  cp_wait_group before use.
template <int NCOL = 0, int PITCH = 0, bool FRESH = false, typename T>
__device__ __forceinline__ void stage_in(T* dst, const T* src, int n, int k,
                                         int B, int b0) {
  constexpr int per = 16 / static_cast<int>(sizeof(T));  // values a copy
  constexpr int cpe = kFwdLanes / per;                    // copies an entry
  const T* from = src + (size_t)k * n * B;
  const auto row = [](int r) {
    return NCOL ? r / NCOL * PITCH + r % NCOL : r;
  };
  if (b0 + kFwdLanes <= B && B % per == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
#pragma unroll 1
    for (int c = threadIdx.x; c < n * cpe; c += kFwdThreads) {
      const int r = c / cpe, v = c % cpe;
      T* to = dst + row(r) * kFwdLanes + v * per;
      const T* fr = from + (size_t)r * B + b0 + v * per;
      CFL_ASM(asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                               static_cast<unsigned>(
                                   __cvta_generic_to_shared(to))),
                           "l"(fr)
                           : "memory"),
              memcpy(to, fr, 16));
    }
  } else {
    for (int f = threadIdx.x; f < n * kFwdLanes; f += kFwdThreads) {
      const int r = f / kFwdLanes, l = f % kFwdLanes;
      T* to = dst + row(r) * kFwdLanes + l;
      const T* fr = from + (size_t)r * B + min(b0 + l, B - 1);
      if constexpr (FRESH)
        *to = __ldcg(fr);
      else
        copy_async(to, fr);
    }
  }
}

// A lane's column of a field: entry q at p[q kFwdLanes].
template <typename T>
struct Col {
  const T* p;
  __device__ __forceinline__ T operator[](int q) const {
    return p[q * kFwdLanes];
  }
};
}  // namespace tile

// K9b: the rollout from stored gains, du_k = K_k dx_k + kff_k, dx_{k+1} =
// A dx + B du + c.  Stage k+kFwdSets-1's inputs land while stage k
// computes (one commit group a stage); a u phase (threads 0-3: 4 dot
// products of 13) and a dx phase (threads 0-12: 13 of 17), two barriers a
// stage; the sums term for term as K8a's rollout.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads, fwd_min_blocks<T>())
forward_sweep_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ c, const T* __restrict__ K,
                     const T* __restrict__ kff, const T* __restrict__ dx0,
                     T* __restrict__ dx, T* __restrict__ du, int N, int B) {
  namespace fs = fwd_slot;
  constexpr int kL = kFwdLanes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sh = reinterpret_cast<T*>(smem_raw);
  const int l = threadIdx.x % kL, t = threadIdx.x / kL;
  const int b0 = blockIdx.x * kL;
  const int bl = min(b0 + l, B - 1);   // the lane this group reads
  const bool valid = b0 + l < B;       // ... and whether it stores
  T* const w = sh + l;                 // the lane's column: entry r at r kL
  const auto set = [&](int k) { return sh + (k % kFwdSets) * fs::SET * kL; };
  const auto roll_in = [&](int k) {
    T* const s = set(k);
    tile::stage_in(s + fs::A * kL, A, NX * NX, k, B, b0);
    tile::stage_in<NU, fs::BP>(s + fs::B * kL, Bm, NX * NU, k, B, b0);
    tile::stage_in(s + fs::C * kL, c, NX, k, B, b0);
    tile::stage_in(s + fs::K * kL, K, NU * NX, k, B, b0);
    tile::stage_in(s + fs::KFF * kL, kff, NU, k, B, b0);
  };

  for (int i = t; i < NX; i += kFwdGroup)
    w[(fs::X0 + i) * kL] = dx0[i * B + bl];
  // stages 0 .. kFwdSets-2 in flight, one group each
#pragma unroll
  for (int k = 0; k < kFwdSets - 1; ++k) {
    if (k < N) roll_in(k);
    cp_commit();
  }
  cp_wait_group<kFwdSets - 2>();
  __syncthreads();

#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    // stage k+kFwdSets-1 into the set stage k-1 freed (a group, maybe empty)
    if (k + kFwdSets - 1 < N) roll_in(k + kFwdSets - 1);
    cp_commit();
    const T* const s = set(k);
    const T* const As = s + fs::A * kL + l;
    const T* const Bs = s + fs::B * kL + l;
    const T* const Ks = s + fs::K * kL + l;
    const int xo = (k & 1) ? fs::X1 : fs::X0, xn = (k & 1) ? fs::X0 : fs::X1;
    const T* const x = w + xo * kL;   // x_k: entry j at x[j kL]
    // K9b's u = K x + kff (threads 0-3)
    for (int a = t; a < NU; a += kFwdGroup) {
      T acc = Ks[a * NX * kL] * x[0];
#pragma unroll
      for (int j = 1; j < NX; ++j)
        acc = acc + Ks[(a * NX + j) * kL] * x[j * kL];
      const T u = acc + s[(fs::KFF + a) * kL + l];
      w[(fs::U + a) * kL] = u;
      if (valid) du[((size_t)k * NU + a) * B + b0 + l] = u;
    }
    // K9b's x_k out
    if (valid) {
      for (int i = t; i < NX; i += kFwdGroup)
        dx[((size_t)k * NX + i) * B + b0 + l] = x[i * kL];
    }
    __syncthreads();
    // K9b's dx_{k+1} = A x + B u + c (threads 0-12)
    for (int i = t; i < NX; i += kFwdGroup) {
      T acc = As[i * NX * kL] * x[0];
#pragma unroll
      for (int j = 1; j < NX; ++j)
        acc = acc + As[(i * NX + j) * kL] * x[j * kL];
      T v = Bs[i * fs::BP * kL] * w[fs::U * kL];
#pragma unroll
      for (int a = 1; a < NU; ++a)
        v = v + Bs[(i * fs::BP + a) * kL] * w[(fs::U + a) * kL];
      w[(xn + i) * kL] = acc + v + s[(fs::C + i) * kL + l];
    }
    cp_wait_group<kFwdSets - 2>();   // stage k+1's inputs have landed (this
    __syncthreads();                 // thread's, then everyone's); set k is
                                     // free
  }
  if (valid) {
    const int xo = (N & 1) ? fs::X1 : fs::X0;
    for (int i = t; i < NX; i += kFwdGroup)
      dx[((size_t)N * NX + i) * B + b0 + l] = w[(xo + i) * kL];
  }
}

template <typename T>
constexpr Shape fwd_shape() {
  return {kFwdLanes, kFwdThreads, fwd_smem_bytes<T>()};
}

// ---- K8b and K9c: a group of threads per lane, on K3's and K5c's design ---

// K9b's group and block (kFwdGroup threads a lane, kFwdLanes lanes a
// block); a ring of kVecSets input sets.
constexpr int kVecSets = 3;   // depth of the input ring

// One lane's slots, [entry][lane] as K9b's: a set holds the vector pass's
// fields and K8b's rollout's (K9c leaves c and kff unused: one layout for
// both, the same blocks an SM by shared memory), then the state.
namespace vec_slot {
constexpr int BP = NU + 1;              // Bm's row pitch (odd, as K9b's)
constexpr int A = 0;                    // A (13x13)
constexpr int B = A + NX * NX;          // Bm (13 rows of 4, pitch BP)
constexpr int K = B + NX * BP;          // K (4x13)
constexpr int PC = K + NU * NX;         // Pc
constexpr int L = PC + NX;              // packed Cholesky factor (10)
constexpr int Q = L + NL;               // qx
constexpr int R = Q + NX;               // ru
constexpr int C = R + NU;               // c (K8b's rollout)
constexpr int KFF = C + NX;             // kff (K8b's rollout)
constexpr int SET = KFF + NU;           // one set of stage inputs (343)
constexpr int P = kVecSets * SET;       // p, then the rollout's odd x
constexpr int X0 = P + NX;              // m, then the rollout's even x
constexpr int QU = X0 + NX;             // Qu, then the rollout's u
constexpr int END = QU + NU;
}  // namespace vec_slot

constexpr int kVecLaneValues = vec_slot::END;
static_assert(kVecLaneValues == 1059,
              "vector_launch_geometry's VECTOR_LANE_VALUES");

template <typename T>
constexpr int vec_smem_bytes() {
  return kFwdLanes * kVecLaneValues * static_cast<int>(sizeof(T));
}

// What K8b's and K9c's __launch_bounds__ ask for: the blocks an SM holds by
// shared memory (3 in float32: 85 registers a thread), at most 4.
template <typename T>
constexpr int vec_min_blocks() {
  return std::min(1024 / kFwdThreads, (227 * 1024) / vec_smem_bytes<T>());
}

// The backward vector pass on the stored factorization (K, L, Pc), then
// with ROLLOUT the forward rollout: K8b's sweep, and K9c's (ROLLOUT false:
// no rollout; c, dx0, dx and du unused).  Per stage k from p = p_term:
// m = p + Pc_k, Qu = r_k + B_k' m, kff_k = -L_k^-T L_k^-1 Qu, p <- q_k +
// A_k' m + K_k' Qu; then from dx0: du_k = K_k dx_k + kff_k, dx_{k+1} = A_k
// dx_k + B_k du_k + c_k.  kff goes to `kff` (K8b passes du: kff parks
// there, and the rollout reads it back through L2).
template <typename T, bool ROLLOUT>
__device__ __forceinline__ void vec_sweep_group(
    const T* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ c, const T* __restrict__ qx,
    const T* __restrict__ ru, const T* __restrict__ K,
    const T* __restrict__ L, const T* __restrict__ Pc,
    const T* __restrict__ pterm, const T* __restrict__ dx0, T* dx, T* du,
    T* kff, int N, int B) {
  namespace vs = vec_slot;
  constexpr int kL = kFwdLanes;
  constexpr int G = kFwdGroup;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sh = reinterpret_cast<T*>(smem_raw);
  const int l = threadIdx.x % kL, t = threadIdx.x / kL;
  const int b0 = blockIdx.x * kL;
  const int bl = min(b0 + l, B - 1);   // the lane this group reads
  const bool valid = b0 + l < B;       // ... and whether it stores
  T* const w = sh + l;                 // the lane's column: entry r at r kL
  const auto set = [&](int k) { return sh + (k % kVecSets) * vs::SET * kL; };
  // the vector pass's inputs of stage k into its set
  const auto vec_in = [&](int k) {
    T* const s = set(k);
    tile::stage_in(s + vs::A * kL, A, NX * NX, k, B, b0);
    tile::stage_in<NU, vs::BP>(s + vs::B * kL, Bm, NX * NU, k, B, b0);
    tile::stage_in(s + vs::K * kL, K, NU * NX, k, B, b0);
    tile::stage_in(s + vs::PC * kL, Pc, NX, k, B, b0);
    tile::stage_in(s + vs::L * kL, L, NL, k, B, b0);
    tile::stage_in(s + vs::Q * kL, qx, NX, k, B, b0);
    tile::stage_in(s + vs::R * kL, ru, NU, k, B, b0);
  };

  for (int i = t; i < NX; i += G) w[(vs::P + i) * kL] = pterm[i * B + bl];
  // stages N-1 .. N-kVecSets+1 in flight, one group each
#pragma unroll
  for (int j = 1; j < kVecSets; ++j) {
    if (N - j >= 0) vec_in(N - j);
    cp_commit();
  }
  cp_wait_group<kVecSets - 2>();
  __syncthreads();

#pragma unroll 1
  for (int k = N - 1; k >= 0; --k) {
    // stage k-kVecSets+1 into the set stage k+1 freed (a group, maybe
    // empty); at the last stage K8b's rollout's stage-0 c, beside the A, B
    // and K it reuses
    if (k - kVecSets + 1 >= 0) {
      vec_in(k - kVecSets + 1);
    } else if constexpr (ROLLOUT) {
      if (k == 0) tile::stage_in(set(0) + vs::C * kL, c, NX, 0, B, b0);
    }
    cp_commit();
    T* const s = set(k);
    const T* const As = s + vs::A * kL + l;
    const T* const Bs = s + vs::B * kL + l;
    const T* const Ks = s + vs::K * kL + l;

    // K8b's and K9c's m = p + Pc (threads 0-12, into X0 for the p update;
    // threads 0-3 all of it, in registers), Qu = r + B'm (threads 0-3)
    if (t < NX) {
      const T* const Pcs = s + vs::PC * kL + l;
      for (int i = t; i < NX; i += G)
        w[(vs::X0 + i) * kL] = w[(vs::P + i) * kL] + Pcs[i * kL];
      if (t < NU) {
        T m[NX];
#pragma unroll
        for (int j = 0; j < NX; ++j)
          m[j] = w[(vs::P + j) * kL] + Pcs[j * kL];
        for (int a = t; a < NU; a += G) {
          T acc = Bs[a * kL] * m[0];
#pragma unroll
          for (int i = 1; i < NX; ++i)
            acc = acc + Bs[(i * vs::BP + a) * kL] * m[i];
          w[(vs::QU + a) * kL] = s[(vs::R + a) * kL + l] + acc;
        }
      }
    }
    __syncthreads();

    // K8b's and K9c's p update: p <- q + A'm + K'Qu (threads 0-12)
    for (int i = t; i < NX; i += G) {
      const T* const m = w + vs::X0 * kL;
      T acc = As[i * kL] * m[0];
#pragma unroll
      for (int j = 1; j < NX; ++j)
        acc = acc + As[(j * NX + i) * kL] * m[j * kL];
      T v = Ks[i * kL] * w[vs::QU * kL];
#pragma unroll
      for (int a = 1; a < NU; ++a)
        v = v + Ks[(a * NX + i) * kL] * w[(vs::QU + a) * kL];
      w[(vs::P + i) * kL] = s[(vs::Q + i) * kL + l] + acc + v;
    }
    // K8b's and K9c's kff solve: kff = -Quu^{-1} Qu (thread G - 1, which
    // the p update leaves idle)
    if (t == G - 1) {
      T y[NU];
#pragma unroll
      for (int a = 0; a < NU; ++a) y[a] = w[(vs::QU + a) * kL];
      // L read where used: the factor never sits in registers whole
      cho_solve<T, NU>(tile::Col<T>{s + vs::L * kL + l}, y);
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        const T kf = -y[a];
        if (valid) kff[((size_t)k * NU + a) * B + b0 + l] = kf;
        if constexpr (ROLLOUT) {
          if (k == 0) s[(vs::KFF + a) * kL + l] = kf;
        }
      }
    }
    cp_wait_group<kVecSets - 2>();   // stage k-1's inputs have landed (this
    __syncthreads();                 // thread's, then everyone's); set k is
                                     // free
  }

  if constexpr (ROLLOUT) {
    // K8b's rollout.  Stage 0's A, B and K are in set 0 from the vector
    // pass, its c landed with the pass's last stage and its kff was written
    // there; stage k+kVecSets-1's inputs land while stage k computes, one
    // commit group a stage (K9b's ring, K9b's sums term for term).
    const auto roll_in = [&](int k) {
      T* const s = set(k);
      tile::stage_in(s + vs::A * kL, A, NX * NX, k, B, b0);
      tile::stage_in<NU, vs::BP>(s + vs::B * kL, Bm, NX * NU, k, B, b0);
      tile::stage_in(s + vs::C * kL, c, NX, k, B, b0);
      tile::stage_in(s + vs::K * kL, K, NU * NX, k, B, b0);
      tile::stage_in<0, 0, true>(s + vs::KFF * kL,
                                 static_cast<const T*>(kff), NU, k, B, b0);
    };
    for (int i = t; i < NX; i += G) w[(vs::X0 + i) * kL] = dx0[i * B + bl];
    copy_wait();   // stage 0's c has landed (this thread's copies)
    // stages 1 .. kVecSets-2 in flight, one group each
#pragma unroll
    for (int k = 1; k < kVecSets - 1; ++k) {
      if (k < N) roll_in(k);
      cp_commit();
    }
    __syncthreads();
#pragma unroll 1
    for (int k = 0; k < N; ++k) {
      // stage k+kVecSets-1 into the set stage k-1 freed (a group, maybe
      // empty)
      if (k + kVecSets - 1 < N) roll_in(k + kVecSets - 1);
      cp_commit();
      const T* const s = set(k);
      const T* const As = s + vs::A * kL + l;
      const T* const Bs = s + vs::B * kL + l;
      const T* const Ks = s + vs::K * kL + l;
      const int xo = (k & 1) ? vs::P : vs::X0, xn = (k & 1) ? vs::X0 : vs::P;
      const T* const x = w + xo * kL;   // x_k: entry j at x[j kL]
      // K8b's u = K x + kff (threads 0-3)
      for (int a = t; a < NU; a += G) {
        T acc = Ks[a * NX * kL] * x[0];
#pragma unroll
        for (int j = 1; j < NX; ++j)
          acc = acc + Ks[(a * NX + j) * kL] * x[j * kL];
        const T u = acc + s[(vs::KFF + a) * kL + l];
        w[(vs::QU + a) * kL] = u;
        if (valid) du[((size_t)k * NU + a) * B + b0 + l] = u;  // K8b's du
      }
      // K8b's x_k out
      if (valid) {
        for (int i = t; i < NX; i += G)
          dx[((size_t)k * NX + i) * B + b0 + l] = x[i * kL];
      }
      __syncthreads();
      // K8b's dx_{k+1} = A x + B u + c (threads 0-12)
      for (int i = t; i < NX; i += G) {
        T acc = As[i * NX * kL] * x[0];
#pragma unroll
        for (int j = 1; j < NX; ++j)
          acc = acc + As[(i * NX + j) * kL] * x[j * kL];
        T v = Bs[i * vs::BP * kL] * w[vs::QU * kL];
#pragma unroll
        for (int a = 1; a < NU; ++a)
          v = v + Bs[(i * vs::BP + a) * kL] * w[(vs::QU + a) * kL];
        w[(xn + i) * kL] = acc + v + s[(vs::C + i) * kL + l];
      }
      cp_wait_group<kVecSets - 2>();   // stage k+1's inputs have landed
      __syncthreads();                 // (this thread's, then everyone's);
                                       // set k is free
    }
    if (valid) {
      const int xo = (N & 1) ? vs::P : vs::X0;
      for (int i = t; i < NX; i += G)
        dx[((size_t)N * NX + i) * B + b0 + l] = w[(xo + i) * kL];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads, vec_min_blocks<T>())
corrector_sweep_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                       const T* __restrict__ c, const T* __restrict__ qx,
                       const T* __restrict__ ru, const T* __restrict__ K,
                       const T* __restrict__ L, const T* __restrict__ Pc,
                       const T* __restrict__ pterm,
                       const T* __restrict__ dx0, T* dx, T* du, int N,
                       int B) {
  vec_sweep_group<T, true>(A, Bm, c, qx, ru, K, L, Pc, pterm, dx0, dx, du,
                           du, N, B);
}

// K9c: the vector pass alone (fused=False)
template <typename T>
__global__ void __launch_bounds__(kFwdThreads, vec_min_blocks<T>())
backward_vector_sweep_kernel(const T* __restrict__ A,
                             const T* __restrict__ Bm,
                             const T* __restrict__ qx,
                             const T* __restrict__ ru,
                             const T* __restrict__ K, const T* __restrict__ L,
                             const T* __restrict__ Pc,
                             const T* __restrict__ pterm,
                             T* __restrict__ kff, int N, int B) {
  vec_sweep_group<T, false>(A, Bm, nullptr, qx, ru, K, L, Pc, pterm, nullptr,
                            nullptr, nullptr, kff, N, B);
}

template <typename T>
constexpr Shape vec_shape() {
  return {kFwdLanes, kFwdThreads, vec_smem_bytes<T>()};
}

inline cudaStream_t as_stream(void* s) {
  return static_cast<cudaStream_t>(s);
}

}  // namespace

// K8a and K9a take their launch shape (grid, threads, smem: the wrapper's
// riccati_launch_geometry), K9b its own (forward_launch_geometry), K8b and
// K9c theirs (vector_launch_geometry), and refuse another; their _occupancy
// entries give the blocks an SM holds.
#define RICCATI_ENTRIES(SUFFIX, T)                                            \
  extern "C" int kkt_sweep_##SUFFIX(                                          \
      const T* A, const T* Bm, const T* c, const T* qxx, const T* qx,         \
      const T* ruu, const T* ru, const T* pT, const T* pterm, const T* dx0,   \
      T* K, T* kff, T* L, T* Pc, T* dx, T* du, int N, int B, int grid,        \
      int threads, int smem, void* stream) {                                  \
    if (refused(riccati_shape<T>(), N, B, grid, threads, smem))               \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    const int err = opt_in(kkt_sweep_kernel<T>, riccati_shape<T>());          \
    if (err != 0) return err;                                                 \
    kkt_sweep_kernel<T><<<grid, threads, smem, as_stream(stream)>>>(          \
        A, Bm, c, qxx, qx, ruu, ru, pT, pterm, dx0, K, kff, L, Pc, dx, du, N, \
        B);                                                                   \
    return static_cast<int>(cudaGetLastError());                              \
  }                                                                           \
  extern "C" int kkt_sweep_occupancy_##SUFFIX(int* blocks_per_sm) {           \
    return occupancy(kkt_sweep_kernel<T>, riccati_shape<T>(), blocks_per_sm); \
  }                                                                           \
  extern "C" int backward_sweep_##SUFFIX(                                     \
      const T* A, const T* Bm, const T* c, const T* qxx, const T* qx,         \
      const T* ruu, const T* ru, const T* pT, const T* pterm, T* K, T* kff,   \
      T* L, T* Pc, int N, int B, int grid, int threads, int smem,             \
      void* stream) {                                                         \
    if (refused(riccati_shape<T>(), N, B, grid, threads, smem))               \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    const int err = opt_in(backward_sweep_kernel<T>, riccati_shape<T>());     \
    if (err != 0) return err;                                                 \
    backward_sweep_kernel<T><<<grid, threads, smem, as_stream(stream)>>>(     \
        A, Bm, c, qxx, qx, ruu, ru, pT, pterm, K, kff, L, Pc, N, B);          \
    return static_cast<int>(cudaGetLastError());                              \
  }                                                                           \
  extern "C" int backward_sweep_occupancy_##SUFFIX(int* blocks_per_sm) {      \
    return occupancy(backward_sweep_kernel<T>, riccati_shape<T>(),            \
                     blocks_per_sm);                                          \
  }                                                                           \
  extern "C" int forward_sweep_##SUFFIX(                                      \
      const T* A, const T* Bm, const T* c, const T* K, const T* kff,          \
      const T* dx0, T* dx, T* du, int N, int B, int grid, int threads,        \
      int smem, void* stream) {                                               \
    if (refused(fwd_shape<T>(), N, B, grid, threads, smem))                   \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    const int err = opt_in(forward_sweep_kernel<T>, fwd_shape<T>());          \
    if (err != 0) return err;                                                 \
    forward_sweep_kernel<T><<<grid, threads, smem, as_stream(stream)>>>(      \
        A, Bm, c, K, kff, dx0, dx, du, N, B);                                 \
    return static_cast<int>(cudaGetLastError());                              \
  }                                                                           \
  extern "C" int forward_sweep_occupancy_##SUFFIX(int* blocks_per_sm) {       \
    return occupancy(forward_sweep_kernel<T>, fwd_shape<T>(), blocks_per_sm); \
  }                                                                           \
  extern "C" int backward_vector_sweep_##SUFFIX(                              \
      const T* A, const T* Bm, const T* qx, const T* ru, const T* K,          \
      const T* L, const T* Pc, const T* pterm, T* kff, int N, int B,          \
      int grid, int threads, int smem, void* stream) {                        \
    if (refused(vec_shape<T>(), N, B, grid, threads, smem))                   \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    const int err = opt_in(backward_vector_sweep_kernel<T>, vec_shape<T>());  \
    if (err != 0) return err;                                                 \
    backward_vector_sweep_kernel<T><<<grid, threads, smem,                    \
                                      as_stream(stream)>>>(                   \
        A, Bm, qx, ru, K, L, Pc, pterm, kff, N, B);                           \
    return static_cast<int>(cudaGetLastError());                              \
  }                                                                           \
  extern "C" int backward_vector_sweep_occupancy_##SUFFIX(                    \
      int* blocks_per_sm) {                                                   \
    return occupancy(backward_vector_sweep_kernel<T>, vec_shape<T>(),         \
                     blocks_per_sm);                                          \
  }                                                                           \
  extern "C" int corrector_sweep_##SUFFIX(                                    \
      const T* A, const T* Bm, const T* c, const T* qx, const T* ru,          \
      const T* K, const T* L, const T* Pc, const T* pterm, const T* dx0,      \
      T* dx, T* du, int N, int B, int grid, int threads, int smem,            \
      void* stream) {                                                         \
    if (refused(vec_shape<T>(), N, B, grid, threads, smem))                   \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    const int err = opt_in(corrector_sweep_kernel<T>, vec_shape<T>());       \
    if (err != 0) return err;                                                 \
    corrector_sweep_kernel<T><<<grid, threads, smem, as_stream(stream)>>>(    \
        A, Bm, c, qx, ru, K, L, Pc, pterm, dx0, dx, du, N, B);                \
    return static_cast<int>(cudaGetLastError());                              \
  }                                                                           \
  extern "C" int corrector_sweep_occupancy_##SUFFIX(int* blocks_per_sm) {     \
    return occupancy(corrector_sweep_kernel<T>, vec_shape<T>(),               \
                     blocks_per_sm);                                          \
  }

RICCATI_ENTRIES(f32, float)
RICCATI_ENTRIES(f64, double)
