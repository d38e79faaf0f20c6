// K10: one whole Mehrotra interior-point iteration on the block-2 condensed
// QP in one launch, a group of threads per lane.
//
// Replaces iter_sweep_c2 (_iter_c2_kernel) of
// crazyflie_nmpc_tpu/ops/pallas/condensed_kernels.py.  Its five grid
// phases run in order over the M condensed stages of each lane:
//   0 backward-affine     barrier shift and affine right-hand side from the
//                         carried slacks/duals, then K2's factorization
//   1 forward-affine      du_aff rollout, slack/dual directions, the
//                         fraction-to-boundary minimum and the mu_aff sums
//                         S0/S1/S2 -> sigma*mu
//   2 backward-corrector  Mehrotra-corrected right-hand side from the stored
//                         du_aff, K3's vector pass on the stored factorization
//   3 forward-corrector   du rollout, final directions, the step length
//                         alpha (tau, mu-floor guard)
//   4 update              z, s, lam += alpha d; residuals *= (1 - alpha)
// The whole-horizon VMEM scratch (K, kff, L, Pc, du_aff, du, ddx) is
// device-memory scratch the wrapper allocates once per solve; the block
// that writes a lane's rows reads them back.  The Pallas kernel's
// input_output_aliases become in-place updates: the carried arrays (z_dx,
// z_du, s_l, s_u, lam_l, lam_u, qx, r1u, c_res, r3, r4, r1x_T, dx0_res,
// z_dxT) are read in phases 0-3 and rewritten in phase 4, so none of them
// is __restrict__, and every copy of phase 3 has landed before phase 4's
// stores.
//
// What bounds it on the H100.  Per stage and lane phase 0 reads K2's 552
// values plus the 64 of the inequality state and writes ~160; phases 1 and
// 3 re-read the rollout's ~460, phase 2 the vector pass's ~590, phase 4
// reads ~200 and writes ~100; with K2's ~11k multiply-adds, K3's ~800 and
// ~150 operations per (stage, input) of barrier algebra.  The bound is
// bytes (0.09 ms at N=50, B=4096 in float32, each input read once), but
// as in K2 the group's chain of shared-memory products sets phase 0's
// time, and phases 1-3 each re-read a stage stream (~200 MB at B=4096)
// that L2 cannot hold.  The one-thread-per-lane kernel this replaces ran
// each lane's five phases in one thread (64-thread blocks: 64 blocks at
// B=4096, two warps on under half of the SMs), the factorization one
// dependent chain with P, PA, Qux and K spilled to local memory.
//
// Design: K2's (kkt_sweep_c2.cu) group, block and lane-major slots, its
// stage loop copied here rather than shared, so that K2 and K5a keep their
// code (ptxas scheduled K2's factorization 6% slower once it came through
// shared inlined code).  kGroup = 16 threads share one lane's stage:
//   * phase 0 is K2's backward pass (phases A-D) on cost inputs it makes:
//     threads 8-15, one input each, form the barrier shift of R̄'s diagonal,
//     the affine right-hand side and the stage's S0 terms while threads 0-5
//     take phase A's second columns; thread 15 adds the terms to S0 in
//     phase B, where it has one job;
//   * phases 1 and 3 are K2's rollout (a ring of two slot sets, stage k+1's
//     copies landing while stage k computes) with the inequality state in
//     the ring: threads 0-7 each form u of one input and, from it, that
//     input's directions and fraction-to-boundary ratio; thread 15, idle in
//     the dx product, adds a stage's 8 terms to S1, S2 and the minimum;
//   * phase 2 is K3's vector pass on K2's slots (A, B and K transposed, a
//     ring of two sets): threads 0-7 form the corrected right-hand side and
//     Qu, threads 0-12 m, then threads 0-12 update p while thread 15 solves
//     and stores kff;
//   * phase 4 is elementwise: each stage's entries of the block's lanes in
//     the flat (entry, lane) order, 8 threads on one 32-byte sector, from
//     and to device memory.
// Every reduction runs over one lane's stages in the order of the
// one-thread kernel (a stage's 8 terms in input order, then added to the
// running sum: S0 in backward stage order, S1/S2 in forward order); every
// product in K2's and K3's order.
//
// Tile and geometry: kLanes = 8 consecutive lanes a block (kThreads = 128),
// as K2.  Shared memory: kStride = 1612 values a lane (K2's 1544, the
// phase-0 inequality rows and the lane's scalars; the rings of phases 1-3
// reuse the same slots), 51,584 bytes a block in float32 (4 blocks, 32
// lanes an SM, with the 1 KB each block reserves of the SM's 228 KB) and
// 103,168 in float64 (2 blocks); both need the opt-in attribute.
// `__launch_bounds__` asks for those blocks, which caps float32 at 128
// registers a thread; `ptxas -v` in the build log gives the count and the
// spills.  The wrapper (ops/cuda/condensed_kernels.iter_launch_geometry)
// computes grid, block and shared bytes; the launch refuses numbers that
// disagree with these.  A ragged tile's spare groups read the last lane,
// store nothing and take part in every barrier.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; float32, N=50;
// roofline/kkt_variants.py --kernel iter_sweep_c2 --baseline, PERF.md §6):
// 0.57 / 0.96 / 1.91 ms at B = 1024 / 4096 / 8192, the one-thread kernel
// 3.77 / 4.21 / 4.50 in the same run; of the 0.96, phase 0 takes 0.39
// (K2's backward pass alone ~0.38), phases 1, 2 and 3 0.14-0.16 each
// (~2x their stream's time at the bandwidth), phase 4 0.10 and the
// barrier algebra 0.04.  The inequality rows land one copy loop a row, as
// K2's inputs: one loop over all of them held their pointers in registers
// across the stage loop, and phase 0 spilled (1.04 ms).  Phase 4 unrolled
// 2 or 4 times ran 2% slower.
#include "c2_stage.cuh"

using namespace cfl;

namespace {

constexpr int kGroup = 16;                 // threads per lane
constexpr int kThreads = 128;              // threads per block
constexpr int kLanes = kThreads / kGroup;  // lanes per block

// The barrier algebra of the five phases; the parts study
// (roofline/kkt_variants.py) times the kernel without it (false).
constexpr bool kAlgebra = true;

// One lane's shared-memory slots (offsets in values of the compute type).
namespace slot {
// phase 0: K2's slots (kkt_sweep_c2.cu: rows of 13 padded to 16, rows of 8
// every 8, each row 16-byte aligned; AT, BT, PAT, PBT, QUXT, KT transposed)
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
constexpr int C = PC + RW;              // c_res
constexpr int QU = C + RW;              // Qu (8)
constexpr int KFF = QU + NUC;           // kff (8)
constexpr int Q = KFF + NUC;            // Qbar (13x13, unpadded)
constexpr int S = Q + 172;              // S1T (4x13)
constexpr int R = S + NU * NX;          // R00 (4x4)
constexpr int QX = R + NU * NU;         // qx
// 8 rows of 8 as they land: ruu (then the shifted diagonal), r1u (then
// the affine right-hand side), s_l, s_u, lam_l, lam_u, r3, r4
constexpr int RS = QX + RW;
constexpr int RU = RS + NUC;
constexpr int SL = RU + NUC;
constexpr int T0 = SL + 6 * NUC;        // a stage's 8 terms of S0
constexpr int END0 = T0 + NUC;
// the lane's scalars, kept through the phases
constexpr int SC = END0;
constexpr int S0 = 0, S1 = 1, S2 = 2, AMIN = 3, SIGMU = 4, MU = 5, ALPHA = 6;
constexpr int END = SC + 8;

// phases 1 and 3: the rollout's ring of two sets (RSET values apart,
// unpadded rows; RG: s_l, s_u, lam_l, lam_u, r3, r4, m_l, m_u, then
// du_aff, 8 rows of 8) and its state
constexpr int RA = 0, RB = RA + NX * NX, RC = RB + NX * NUC,
              RK = RC + NX, RKFF = RK + NUC * NX, RG = RKFF + NUC,
              RSET = RG + 9 * NUC;
constexpr int X0 = 2 * RSET, X1 = X0 + NX, U = X1 + NX;
constexpr int T1 = U + NUC, T2 = T1 + NUC, TR = T2 + NUC;  // a stage's terms
static_assert(TR + NUC <= END0, "the rollout's slots fit phase 0's");

// phase 2: the vector pass's ring of two sets (VSET values apart; VG: r1u,
// s_l, s_u, lam_l, lam_u, r3, r4, m_l, m_u, du_aff) and its state
constexpr int VAT = 0;                  // Abar^T (13 rows)
constexpr int VBT = VAT + NX * RW;      // Bbar^T (8 rows)
constexpr int VKT = VBT + NUC * RW;     // K^T (13 rows of 8)
constexpr int VPC = VKT + NX * NUC;     // Pc
constexpr int VL = VPC + RW;            // packed Cholesky factor
constexpr int VQX = VL + 40;            // qx
constexpr int VG = VQX + RW;
constexpr int VSET = VG + 10 * NUC;
constexpr int VP = 2 * VSET, VM = VP + RW, VQU = VM + RW;
static_assert(VQU + NUC <= END0, "the vector pass's slots fit phase 0's");
static_assert(PAT % 8 == 0 && PBT % 8 == 0 && AT % 8 == 0 && BT % 8 == 0 &&
                  QUXT % 8 == 0 && KT % 8 == 0 && PV % 8 == 0 &&
                  MV % 8 == 0 && PC % 8 == 0 && C % 8 == 0 && QU % 8 == 0 &&
                  VBT % 8 == 0 && VKT % 8 == 0 && VQX % 8 == 0 &&
                  VSET % 8 == 0 && VP % 8 == 0 && VM % 8 == 0 &&
                  VQU % 8 == 0,
              "rows start 16-byte aligned in both dtypes");
}  // namespace slot

// 1612 a lane: 16-byte aligned, two lanes' same entry 12 banks apart, and
// 4 blocks an SM in float32 and 2 in float64
constexpr int kStride = slot::END + 4;
static_assert(kStride == 1612, "iter_launch_geometry's ITER_LANE_VALUES");

template <typename T>
constexpr int smem_bytes() {
  return kLanes * kStride * static_cast<int>(sizeof(T));
}

// Blocks an SM holds by shared memory: what __launch_bounds__ asks for.
template <typename T>
constexpr int min_blocks() {
  return (227 * 1024) / smem_bytes<T>();
}

// The kernel's arrays (the entry's order).
template <typename T>
struct Args {
  const T* Abar;
  const T* Bbar;
  T* c_res;
  const T* Qbar;
  const T* S1T;
  const T* R00;
  T* qx;
  const T* ruu;
  T* r1u;
  T* s_l;
  T* s_u;
  T* lam_l;
  T* lam_u;
  T* r3;
  T* r4;
  const T* m_l;
  const T* m_u;
  T* z_dx;
  T* z_du;
  const T* pT;
  T* r1x_T;
  T* dx0_res;
  T* z_dxT;
  const T* n_ineq;
  const T* has_ineq;
  T* K;
  T* kff;
  T* L;
  T* Pc;
  T* dua;
  T* du;
  T* ddx;
  T* alpha;
  T* mu;
  T tau, mu_floor, tiny;
};

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
// `dst`: entry r at dst + r, or with NCOL > 0 (an input of rows of NCOL)
// transposed, entry (i, j) at dst + j PITCH + i.  Thread f of the flat
// (entry, lane) order takes entry f / kLanes of lane f % kLanes, so 8
// neighbouring threads read one 32-byte sector (K2's stage_in).
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

// Stage k of the inequality state (s_l, s_u, lam_l, lam_u, r3, r4, then
// with MASKS m_l, m_u) into every lane's rows of 8 from `dst`, in the
// order `ineq` reads.
template <bool MASKS = true, typename T>
__device__ __forceinline__ void ineq_in(T* sh, int dst, const Args<T>& g,
                                        int k, int B, int b0) {
  stage_in(sh, dst, g.s_l, NUC, k, B, b0);
  stage_in(sh, dst + NUC, g.s_u, NUC, k, B, b0);
  stage_in(sh, dst + 2 * NUC, g.lam_l, NUC, k, B, b0);
  stage_in(sh, dst + 3 * NUC, g.lam_u, NUC, k, B, b0);
  stage_in(sh, dst + 4 * NUC, g.r3, NUC, k, B, b0);
  stage_in(sh, dst + 5 * NUC, g.r4, NUC, k, B, b0);
  if constexpr (MASKS) {
    stage_in(sh, dst + 6 * NUC, g.m_l, NUC, k, B, b0);
    stage_in(sh, dst + 7 * NUC, g.m_u, NUC, k, B, b0);
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

// jnp.minimum / jnp.maximum on non-NaN values.
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  return b < a ? b : a;
}
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return b > a ? b : a;
}

// ---- the barrier algebra, one input of one stage (kAlgebra)

// One input's carried inequality state, read from rows 8 apart in the
// order s_l, s_u, lam_l, lam_u, r3, r4, m_l, m_u.
template <typename T>
struct Ineq {
  T sl, su, ll, lu, r3, r4, ml, mu;
};
template <typename T>
__device__ __forceinline__ Ineq<T> ineq(const T* g) {
  return {g[0],       g[NUC],     g[2 * NUC], g[3 * NUC],
          g[4 * NUC], g[5 * NUC], g[6 * NUC], g[7 * NUC]};
}

// Phase 0: the barrier shift of R̄'s diagonal and the affine right-hand
// side of input a in place of ruu and r1u, and its S0 term.
template <typename T>
__device__ __forceinline__ void affine_rhs(T* w, int a) {
  using namespace slot;
  if constexpr (!kAlgebra) {
    w[T0 + a] = T(0);
    return;
  }
  const T sl = w[SL + a], su = w[SL + NUC + a], ll = w[SL + 2 * NUC + a],
          lu = w[SL + 3 * NUC + a], g3 = w[SL + 4 * NUC + a],
          g4 = w[SL + 5 * NUC + a];
  const T r5l = ll * sl, r5u = lu * su;
  w[T0 + a] = r5l + r5u;
  w[RS + a] = w[RS + a] + ll / sl + lu / su;
  w[RU + a] = w[RU + a] + (r5l + ll * g3) / sl - (r5u + lu * g4) / su;
}

// Fraction-to-boundary ratio of one entry: min over the four (v, dv) of
// -v/dv where dv < 0, else big.
template <typename T>
__device__ __forceinline__ T ratio4(T big, T sl, T dsl, T su, T dsu, T ll,
                                    T dll, T lu, T dlu) {
  T r = big;
  r = tmin(r, dsl < T(0) ? -sl / dsl : big);
  r = tmin(r, dsu < T(0) ? -su / dsu : big);
  r = tmin(r, dll < T(0) ? -ll / dll : big);
  r = tmin(r, dlu < T(0) ? -lu / dlu : big);
  return r;
}

// Phase 1: the affine directions of an input from its du_aff, into its
// terms of S1 and S2 and its ratio.
template <typename T>
__device__ __forceinline__ void affine_terms(const Ineq<T>& g, T u, T big,
                                             T& t1, T& t2, T& ratio) {
  if constexpr (!kAlgebra) {
    t1 = t2 = T(0);
    ratio = big;
    return;
  }
  const T dsl = g.ml * (u + g.r3);
  const T dsu = g.mu * (g.r4 - u);
  const T dll = -(g.ll * g.sl + g.ll * dsl) / g.sl;
  const T dlu = -(g.lu * g.su + g.lu * dsu) / g.su;
  t1 = g.ll * dsl + g.sl * dll + g.lu * dsu + g.su * dlu;
  t2 = dll * dsl + dlu * dsu;
  ratio = ratio4(big, g.sl, dsl, g.su, dsu, g.ll, dll, g.lu, dlu);
}

// Mehrotra-corrected complementarity residuals of an input from its
// stored du_aff (the Pallas kernel's corrected_r5).
template <typename T>
__device__ __forceinline__ void corrected_r5(const Ineq<T>& g, T dua,
                                             T sigmu, T& r5l, T& r5u) {
  if constexpr (!kAlgebra) {
    r5l = r5u = T(0);
    return;
  }
  const T dsl = g.ml * (dua + g.r3);
  const T dsu = g.mu * (g.r4 - dua);
  const T dll = -(g.ll * g.sl + g.ll * dsl) / g.sl;
  const T dlu = -(g.lu * g.su + g.lu * dsu) / g.su;
  r5l = g.ll * g.sl - sigmu + dsl * dll;
  r5u = g.lu * g.su - sigmu + dsu * dlu;
}

// Corrector directions of an input from its du: ds = mask * (...), dlam =
// -mask * (r5c + lam ds) / s.
template <typename T>
__device__ __forceinline__ void corrector_dirs(const Ineq<T>& g, T du, T r5l,
                                               T r5u, T& dsl, T& dsu,
                                               T& dll, T& dlu) {
  if constexpr (!kAlgebra) {
    dsl = dsu = dll = dlu = T(0);
    return;
  }
  dsl = g.ml * (du + g.r3);
  dsu = g.mu * (g.r4 - du);
  dll = -g.ml * (r5l + g.ll * dsl) / g.sl;
  dlu = -g.mu * (r5u + g.lu * dsu) / g.su;
}

// Phase 2: the corrected right-hand side of an input (e: its r1u, then
// its inequality state and du_aff in rows 8 apart).
template <typename T>
__device__ __forceinline__ T corrected_rhs(const T* e, T sigmu) {
  if constexpr (!kAlgebra) return e[0];
  const Ineq<T> g = ineq(e + NUC);
  T r5l, r5u;
  corrected_r5(g, e[9 * NUC], sigmu, r5l, r5u);
  return e[0] + g.ml * (r5l + g.ll * g.r3) / g.sl
         - g.mu * (r5u + g.lu * g.r4) / g.su;
}

// The lane this thread's group owns: its slots, the lane it reads (a
// ragged tile's spare groups read the last one) and whether it stores.
template <typename T>
struct Lane {
  int l, t, b0, bl;
  bool valid;
  T* w;
  __device__ __forceinline__ Lane(T* sh, int B)
      : l(threadIdx.x / kGroup), t(threadIdx.x % kGroup),
        b0(blockIdx.x * kLanes), bl(min(b0 + l, B - 1)),
        valid(b0 + l < B), w(sh + l * kStride) {}
};

// ---- phase 0: backward-affine.  K2's backward pass (kkt_sweep_c2.cu,
// phases A-D, in its order of operations) on the barrier-shifted cost;
// K, kff, L and Pc of every stage into the scratch.
template <typename T>
__device__ __forceinline__ void backward_affine(const Args<T>& g, T* sh,
                                                int M, int B) {
  using namespace slot;
  const Lane<T> ln(sh, B);
  const int t = ln.t, b0 = ln.b0, bl = ln.bl;
  T* const w = ln.w;

  // terminal cost-to-go: P = diag(pT), p = r1x_T
  for (int e = t; e < NX * NX; e += kGroup) {
    const int i = e / NX, j = e % NX;
    w[P + i * RW + j] = (i == j) ? g.pT[i * B + bl] : T(0);
  }
  for (int i = t; i < NX; i += kGroup) w[PV + i] = g.r1x_T[i * B + bl];
  if (t == kGroup - 1) w[SC + S0] = T(0);

#pragma unroll 1
  for (int k = M - 1; k >= 0; --k) {
    __syncthreads();   // the last stage's readers of the input slots are done
    stage_in<NX, RW>(sh, AT, g.Abar, NX * NX, k, B, b0);
    stage_in<NUC, RW>(sh, BT, g.Bbar, NX * NUC, k, B, b0);
    stage_in(sh, C, g.c_res, NX, k, B, b0);
    stage_in(sh, Q, g.Qbar, NX * NX, k, B, b0);
    stage_in(sh, S, g.S1T, NU * NX, k, B, b0);
    stage_in(sh, R, g.R00, NU * NU, k, B, b0);
    stage_in(sh, QX, g.qx, NX, k, B, b0);
    stage_in(sh, RS, g.ruu, NUC, k, B, b0);
    stage_in(sh, RU, g.r1u, NUC, k, B, b0);
    ineq_in<false>(sh, SL, g, k, B, b0);
    copy_wait();
    __syncthreads();

    // the barrier algebra, threads 8-15 an input each (phase A gives them
    // one column, threads 0-5 two)
    if (t >= kGroup - NUC) affine_rhs(w, t - (kGroup - NUC));

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

    // S0 += the stage's 8 terms, summed in input order (thread 15)
    if (t == kGroup - 1) {
      T s = w[T0];
#pragma unroll
      for (int a = 1; a < NUC; ++a) s = s + w[T0 + a];
      w[SC + S0] = w[SC + S0] + s;
    }

    // B' times [PA | m | PB], one column job a thread (22 jobs): column j
    // of PA gives Qux[:, j] = [S1T; 0][:, j] + B'PA[:, j] (into QUXT row
    // j), m gives Qu = rt1u + B'm, column a2 of PB gives Quu[a2:, a2] =
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

    // the stage's factorization into the scratch
    stage_out<NX, NUC>(g.K, sh, KT, NUC * NX, k, B, b0);
    stage_out(g.kff, sh, KFF, NUC, k, B, b0);
    stage_out(g.L, sh, L, NLC, k, B, b0);
    stage_out(g.Pc, sh, PC, NX, k, B, b0);

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
          w[PV + i] = w[QX + i] + s + u;
        else
          w[P + i * RW + j] = w[Q + i * NX + j] + s + u;
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
}

// ---- phases 1 and 3: forward-affine (CORR false) and forward-corrector.
// K2's rollout, du_k = K_k dx_k + kff_k, dx_{k+1} = A dx + B du + c, its
// inputs and the stage's inequality state round a ring of two slot sets;
// the directions of every input and the running sums.  Phase 1 stores
// du_aff, phase 3 du and ddx, and leaves dx_M in the slots.
template <bool CORR, typename T>
__device__ __forceinline__ void forward(const Args<T>& g, T* sh, int M,
                                        int B) {
  using namespace slot;
  const Lane<T> ln(sh, B);
  const int l = ln.l, t = ln.t, b0 = ln.b0, bl = ln.bl;
  const bool valid = ln.valid;
  T* const w = ln.w;
  const T BIG = T(3.4e38);
  T* const uout = CORR ? g.du : g.dua;
  const auto roll_in = [&](int k) {
    const int o = (k & 1) * RSET;
    stage_in(sh, RA + o, g.Abar, NX * NX, k, B, b0);
    stage_in(sh, RB + o, g.Bbar, NX * NUC, k, B, b0);
    stage_in(sh, RC + o, g.c_res, NX, k, B, b0);
    stage_in(sh, RK + o, g.K, NUC * NX, k, B, b0);
    stage_in(sh, RKFF + o, g.kff, NUC, k, B, b0);
    ineq_in(sh, RG + o, g, k, B, b0);
    if (CORR) stage_in(sh, RG + 8 * NUC + o, g.dua, NUC, k, B, b0);
  };
  __syncthreads();   // the slots' last readers of the phase before are done
  for (int i = t; i < NX; i += kGroup) w[X0 + i] = g.dx0_res[i * B + bl];
  if (t == kGroup - 1) {
    if (!CORR) w[SC + S1] = w[SC + S2] = T(0);
    w[SC + AMIN] = BIG;
  }
  roll_in(0);
  copy_wait();
  __syncthreads();
  const T sigmu = CORR ? w[SC + SIGMU] : T(0);
#pragma unroll 1
  for (int k = 0; k < M; ++k) {
    if (k + 1 < M) roll_in(k + 1);
    const int o = (k & 1) * RSET;
    const T* x = w + ((k & 1) ? X1 : X0);
    T* xn = w + ((k & 1) ? X0 : X1);
    const T* Kk = w + RK + o;
    // u of input a (threads 0-7), then its directions
    for (int a = t; a < NUC; a += kGroup) {
      T s = Kk[a * NX] * x[0];
#pragma unroll
      for (int j = 1; j < NX; ++j) s = s + Kk[a * NX + j] * x[j];
      const T u = s + w[RKFF + o + a];
      w[U + a] = u;
      if (valid) uout[((size_t)k * NUC + a) * B + b0 + l] = u;
      const T* const e = w + RG + o + a;
      const Ineq<T> q = ineq(e);
      if constexpr (CORR) {
        T r5l, r5u, dsl, dsu, dll, dlu;
        corrected_r5(q, e[8 * NUC], sigmu, r5l, r5u);
        corrector_dirs(q, u, r5l, r5u, dsl, dsu, dll, dlu);
        w[TR + a] = ratio4(BIG, q.sl, dsl, q.su, dsu, q.ll, dll, q.lu, dlu);
      } else {
        affine_terms(q, u, BIG, w[T1 + a], w[T2 + a], w[TR + a]);
      }
    }
    if (CORR && valid) {
      for (int i = t; i < NX; i += kGroup)
        g.ddx[((size_t)k * NX + i) * B + b0 + l] = x[i];
    }
    __syncthreads();
    // the running sums, a stage's 8 terms in input order (thread 15, idle
    // in the dx product)
    if (t == kGroup - 1) {
      if constexpr (!CORR) {
        T s1 = w[T1], s2 = w[T2];
#pragma unroll
        for (int a = 1; a < NUC; ++a) {
          s1 = s1 + w[T1 + a];
          s2 = s2 + w[T2 + a];
        }
        w[SC + S1] = w[SC + S1] + s1;
        w[SC + S2] = w[SC + S2] + s2;
      }
      T rmin = BIG;
#pragma unroll
      for (int a = 0; a < NUC; ++a) rmin = tmin(rmin, w[TR + a]);
      w[SC + AMIN] = tmin(w[SC + AMIN], rmin);
    }
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
}

// ---- phase 2: backward-corrector.  K3's vector pass (corrector_sweep_c2.cu,
// in its order of operations) on K2's slots: m = p + Pc, Qu = rt1u_c + B'm,
// kff = -Quu^{-1} Qu into the scratch, p <- qx + A'm + K'Qu; its inputs
// round a ring of two slot sets.
template <typename T>
__device__ __forceinline__ void backward_corrector(const Args<T>& g, T* sh,
                                                   int M, int B) {
  using namespace slot;
  const Lane<T> ln(sh, B);
  const int l = ln.l, t = ln.t, b0 = ln.b0, bl = ln.bl;
  const bool valid = ln.valid;
  T* const w = ln.w;
  const auto vec_in = [&](int k) {
    const int o = (k & 1) * VSET;
    stage_in<NX, RW>(sh, VAT + o, g.Abar, NX * NX, k, B, b0);
    stage_in<NUC, RW>(sh, VBT + o, g.Bbar, NX * NUC, k, B, b0);
    stage_in<NX, NUC>(sh, VKT + o, g.K, NUC * NX, k, B, b0);
    stage_in(sh, VPC + o, g.Pc, NX, k, B, b0);
    stage_in(sh, VL + o, g.L, NLC, k, B, b0);
    stage_in(sh, VQX + o, g.qx, NX, k, B, b0);
    stage_in(sh, VG + o, g.r1u, NUC, k, B, b0);
    ineq_in(sh, VG + NUC + o, g, k, B, b0);
    stage_in(sh, VG + 9 * NUC + o, g.dua, NUC, k, B, b0);
  };
  __syncthreads();   // the rollout's last readers of the slots are done
  for (int i = t; i < NX; i += kGroup) w[VP + i] = g.r1x_T[i * B + bl];
  vec_in(M - 1);
  copy_wait();
  __syncthreads();
  const T sigmu = w[SC + SIGMU];
#pragma unroll 1
  for (int k = M - 1; k >= 0; --k) {
    if (k > 0) vec_in(k - 1);
    const T* const s = w + (k & 1) * VSET;
    // m = p + Pc (threads 0-12, into VM for the p update); the corrected
    // right-hand side and Qu = rt1u_c + B'm (threads 0-7, m in registers)
    if (t < NX) {
      w[VM + t] = w[VP + t] + s[VPC + t];
      if (t < NUC) {
        const T rt = corrected_rhs(s + VG + t, sigmu);
        T m[NX], bt[NX];
#pragma unroll
        for (int j = 0; j < NX; ++j) m[j] = w[VP + j] + s[VPC + j];
        ld_row(s + VBT + t * RW, bt);
        w[VQU + t] = rt + dot(bt, m);
      }
    }
    __syncthreads();
    if (t < NX) {
      // p_t <- qx_t + A[:, t]'m + K[:, t]'Qu (threads 0-12)
      T x1[NX], y1[NX], x2[NUC], y2[NUC];
      ld_row(s + VAT + t * RW, x1);
      ld_row(w + VM, y1);
      ld_row(s + VKT + t * NUC, x2);
      ld_row(w + VQU, y2);
      w[VP + t] = s[VQX + t] + dot(x1, y1) + dot(x2, y2);
    } else if (t == kGroup - 1) {
      // kff = -Quu^{-1} Qu (thread 15)
      T y[NUC];
      ld_row(w + VQU, y);
      cho_solve<T, NUC>(s + VL, y);
      if (valid) {
#pragma unroll
        for (int a = 0; a < NUC; ++a)
          g.kff[((size_t)k * NUC + a) * B + b0 + l] = -y[a];
      }
    }
    copy_wait();       // stage k-1's inputs have landed (this thread's) ...
    __syncthreads();   // ... everyone's, and stage k's slots are free
  }
}

// ---- phase 4: update, in place.  Each stage's entries of the block's
// lanes in the flat (entry, lane) order (13 state entries: z_dx, qx,
// c_res; 8 input entries: z_du, s, lam, r1u, r3, r4), then the terminal
// row; every operand from device memory but alpha, sigma*mu and dx_M.
template <typename T>
__device__ __forceinline__ void update(const Args<T>& g, const T* sh, int M,
                                       int B) {
  using namespace slot;
  const int b0 = blockIdx.x * kLanes;
  constexpr int kJobs = (NX + NUC) * kLanes;   // a stage's
#pragma unroll 1
  for (int f = threadIdx.x; f < M * kJobs; f += kThreads) {
    const int k = f / kJobs, r = f / kLanes % (NX + NUC), l = f % kLanes;
    if (b0 + l >= B) continue;
    const T* const sc = sh + l * kStride + SC;
    const T alpha = sc[ALPHA], shrink = T(1) - alpha;
    if (r < NX) {
      const size_t i = ((size_t)k * NX + r) * B + b0 + l;
      g.z_dx[i] = g.z_dx[i] + alpha * g.ddx[i];
      g.qx[i] = shrink * g.qx[i];
      g.c_res[i] = shrink * g.c_res[i];
    } else {
      const size_t i = ((size_t)k * NUC + r - NX) * B + b0 + l;
      const Ineq<T> q = {g.s_l[i], g.s_u[i], g.lam_l[i], g.lam_u[i],
                         g.r3[i],  g.r4[i],  g.m_l[i],   g.m_u[i]};
      const T du = g.du[i];
      T r5l, r5u, dsl, dsu, dll, dlu;
      corrected_r5(q, g.dua[i], sc[SIGMU], r5l, r5u);
      corrector_dirs(q, du, r5l, r5u, dsl, dsu, dll, dlu);
      g.z_du[i] = g.z_du[i] + alpha * du;
      g.s_l[i] = q.sl + alpha * dsl;
      g.s_u[i] = q.su + alpha * dsu;
      g.lam_l[i] = q.ll + alpha * dll;
      g.lam_u[i] = q.lu + alpha * dlu;
      g.r1u[i] = shrink * g.r1u[i];
      g.r3[i] = shrink * q.r3;
      g.r4[i] = shrink * q.r4;
    }
  }
  for (int f = threadIdx.x; f < NX * kLanes; f += kThreads) {
    const int r = f / kLanes, l = f % kLanes;
    if (b0 + l >= B) continue;
    const T* const w = sh + l * kStride;
    const T alpha = w[SC + ALPHA], shrink = T(1) - alpha;
    const size_t i = (size_t)r * B + b0 + l;
    g.z_dxT[i] = g.z_dxT[i] + alpha * w[((M & 1) ? X1 : X0) + r];
    g.r1x_T[i] = shrink * g.r1x_T[i];
    g.dx0_res[i] = shrink * g.dx0_res[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, min_blocks<T>())
iter_sweep_c2_kernel(const Args<T> g, int M, int B) {
  using namespace slot;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sh = reinterpret_cast<T*>(smem_raw);
  const Lane<T> ln(sh, B);
  T* const sc = ln.w + SC;

  backward_affine(g, sh, M, B);
  forward<false>(g, sh, M, B);
  // sigma*mu and mu of the lane (thread 15)
  if (ln.t == kGroup - 1) {
    const T nin = g.n_ineq[ln.bl];
    const T mu = sc[S0] / nin;
    const T a = tmin(T(1), sc[AMIN]);
    const T mu_aff = (sc[S0] + a * sc[S1] + a * a * sc[S2]) / nin;
    T sig = mu_aff / tmax(mu, g.tiny);
    sig = tmin(tmax(sig * sig * sig, T(0)), T(1));
    sc[SIGMU] = sig * mu;
    sc[MU] = mu;
    if (ln.valid) g.mu[ln.b0 + ln.l] = mu;
  }
  backward_corrector(g, sh, M, B);
  forward<true>(g, sh, M, B);
  // the step length (thread 15)
  if (ln.t == kGroup - 1) {
    T alpha = tmin(T(1), g.tau * sc[AMIN]);
    if (g.has_ineq[ln.bl] > T(0) && sc[MU] <= g.mu_floor) alpha = T(0);
    sc[ALPHA] = alpha;
    if (ln.valid) g.alpha[ln.b0 + ln.l] = alpha;
  }
  __syncthreads();   // alpha is set, every copy has landed
  update(g, sh, M, B);
}

template <typename T>
int set_smem() {
  return static_cast<int>(cudaFuncSetAttribute(
      iter_sweep_c2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<T>()));
}

template <typename T>
int launch(const Args<T>& g, int M, int B, int grid, int threads, int smem,
           void* stream) {
  if (B < 1 || M < 1 || threads != kThreads || smem != smem_bytes<T>() ||
      grid != (B + kLanes - 1) / kLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = set_smem<T>();
  if (err != 0) return err;
  iter_sweep_c2_kernel<T>
      <<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(g, M, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grid, threads and smem are the wrapper's iter_launch_geometry.
#define ITER_ENTRY(SUFFIX, T)                                                 \
  extern "C" int iter_sweep_c2_##SUFFIX(                                      \
      const T* Abar, const T* Bbar, T* c_res, const T* Qbar, const T* S1T,    \
      const T* R00, T* qx, const T* ruu, T* r1u, T* s_l, T* s_u, T* lam_l,    \
      T* lam_u, T* r3, T* r4, const T* m_l, const T* m_u, T* z_dx, T* z_du,   \
      const T* pT, T* r1x_T, T* dx0_res, T* z_dxT, const T* n_ineq,           \
      const T* has_ineq, T* K_all, T* kff_all, T* L_all, T* Pc_all,           \
      T* dua_all, T* du_all, T* ddx_all, T* alpha, T* mu, double tau,         \
      double mu_floor, double tiny, int M, int B, int grid, int threads,      \
      int smem, void* stream) {                                               \
    const Args<T> g{Abar,   Bbar,    c_res,   Qbar,     S1T,                  \
                    R00,    qx,      ruu,     r1u,      s_l,                  \
                    s_u,    lam_l,   lam_u,   r3,       r4,                   \
                    m_l,    m_u,     z_dx,    z_du,     pT,                   \
                    r1x_T,  dx0_res, z_dxT,   n_ineq,   has_ineq,             \
                    K_all,  kff_all, L_all,   Pc_all,   dua_all,              \
                    du_all, ddx_all, alpha,   mu,       static_cast<T>(tau),  \
                    static_cast<T>(mu_floor), static_cast<T>(tiny)};          \
    return launch<T>(g, M, B, grid, threads, smem, stream);                   \
  }                                                                           \
  extern "C" int iter_sweep_c2_occupancy_##SUFFIX(int* blocks_per_sm) {       \
    const int err = set_smem<T>();                                            \
    if (err != 0) return err;                                                 \
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(    \
        blocks_per_sm, iter_sweep_c2_kernel<T>, kThreads, smem_bytes<T>()));  \
  }

ITER_ENTRY(f32, float)
ITER_ENTRY(f64, double)
