// K1: the fused RTI preparation + block-2 partial condensing, one launch per
// step, its tangent columns spread over the threads of a lane.
//
// Replaces crazyflie_nmpc_tpu/ops/pallas/prep_kernel.py:prep_condense2
// (_prep_c2_kernel with _vde_stage, _dyn_rows, _jx_entries, _ju_rows,
// _jx_mul; that stage math is prep_stage.cuh's, shared with prep_sweep.cu),
// and its vde_order=2 form (_vde_stage_o2: ORDER 2, A and B from the
// midpoint Jacobian, the state still through ERK4).  For each stage pair
// (2j, 2j+1) and batch lane b:
//   ERK4 propagation of both stages, the exact ERK4 matrix VDE
//   sensitivities A, B from the sparse hand Jacobians, the defect c, the
//   diagonal LLS gradients and the bounds, then block-2 condensing:
//     Abar = A1 A0, Bbar = [A1 B0, B1], cbar = A1 c0 + c1,
//     Qbar = A0' q A0 + q, S1T = B0' q A0, R00 = B0' q B0,
//     qbar = qx0 + A0' h, rbar = [ru0 + B0' h, ru1],  h = q c0 + qx1.
// Each column of A (and of B) is one directional derivative pushed through
// the RK4 tangent chain; A1 never exists: Abar's columns are A0's columns
// pushed through the odd stage's chain, A1 A0 in exact arithmetic (only
// the rounding differs from the plain version's matrix product).
//
// What bounds it on the H100.  Per pair and lane it reads ~115 values and
// writes 807 (the condensed stage, the even-stage Ae/Be for the expansion,
// c, lb, ub): 359 MB at B=4096, M=25, 0.12 ms at the measured bandwidth.
// Its ~35k operations a pair are half that time at the fp32 rate.  One
// thread per (lane, pair) ran its 39 tangent columns one after another
// (~50k dependent operations), rebuilt the sparse Jacobian for every
// column (~150 builds where 8 are distinct) and spilled A0/B0 at 242
// registers: 0.48 ms at B=4096, 4.4x the bound (H100 80GB HBM3, 700 W,
// PERF.md).  Here a block holds kLanes = 32 consecutive lanes of one pair
// and kWorkers = 8 threads a lane; warp wp holds the block's 32 lanes
// (kRowLanes) of worker wp:
//   1. workers 0 and 1 integrate the even and the odd stage (ERK4) and
//      leave the RK stage states in shared memory; worker 2 forms the
//      linear cost terms and the bounds;
//   2. each of the NSETS = 8 stage Jacobians (4 RK stages x 2 intervals;
//      2 midpoint ones at ORDER 2) is built once, by one worker, into
//      shared memory: jac_build's 32 entries a lane (the rest of jx_mul's
//      coefficients are formed from them in registers), packed 16 bytes a
//      lane so a thread reads them in 8 loads;
//   3. the 22 column jobs, longest first, are dealt to the workers in a
//      snake order: A column j (e_j through the even chain -> A0 e_j,
//      stored as Ae and kept in shared memory, then through the odd chain
//      -> Abar e_j), cbar (c0 through the odd chain, plus c1), B column j
//      (even tangent_u -> B0 e_j, then the odd chain -> Bbar e_j) and the
//      odd stage's own B columns; a job loads each Jacobian once a chain
//      step;
//   4. the cost products by column of [A0 | B0] (13 of Qbar, S1T and qbar;
//      4 of R00 and rbar), 2-3 columns a worker, so each row of A0 and B0
//      it reads (as packs) serves all of its columns.
// Every store of an output entry covers the block's 32 consecutive lanes,
// one 128-byte line in float32, marked evict-first (__stcs: 4% faster
// than cached stores; 359 MB pass through L2 before the next kernel
// reads them).  Three barriers a block.  Every sum runs in the one-thread
// kernel's order (jac_apply sums rows as jx_mul did).
//
// Where its time goes (roofline/kkt_variants.py --kernel prep_condense2 on
// an H100 80GB HBM3 at 700 W, PERF.md): at B=4096 it runs at ~2.5x its
// bytes bound; without its stores it takes ~70% of its time, without the
// cost products ~70%, without either tangent chain ~82%: the parts do not
// overlap.  None of 8 or 16
// lanes a warp (the workers of a lane sharing a warp), 64 lanes a block,
// 4 or 16 workers a lane and 3 blocks an SM (80 registers) ran faster in
// both VDE orders.
//
// Shared memory: [value][lane] rows of kLanes values, the Jacobians, A0
// (rows of pitch 16) and B0 packed (pack_index); kLaneValues(ORDER) = 589
// values a lane at ORDER 4 (75,392 bytes a block in float32), 397 at ORDER
// 2.  `__launch_bounds__` asks for 2 blocks of 256 threads (128 registers
// a thread).  The wrapper (ops/cuda/prep_kernel.prep_launch_geometry)
// computes grid, block and shared bytes; the launch refuses numbers that
// disagree with these.  Ragged tiles: spare lanes read lane B-1, store
// nothing, and take part in every barrier.
#include <algorithm>

#include "prep_stage.cuh"

using namespace cfl;

namespace {

constexpr int kLanes = 32;                    // lanes a block
constexpr int kRowLanes = 32;                 // consecutive lanes a warp holds
constexpr int kThreads = 256;                 // threads a block
constexpr int kWorkers = kThreads / kLanes;   // threads a lane
constexpr int kSlots = 32 / kRowLanes;        // workers a warp holds
constexpr int kRows = kLanes / kRowLanes;     // warps a worker group spans
constexpr int kGroups = kWorkers / kSlots;    // worker groups
static_assert(kLanes % kRowLanes == 0 && kWorkers % kSlots == 0,
              "a warp holds kSlots workers of kRowLanes lanes");

// Shared memory rows (of kLanes values each).  A0 (rows of pitch 16) and
// B0 are packed as the Jacobians are (pack_index), so a row is read in
// 16-byte loads.
template <int ORDER>
struct Slot {
  static constexpr int NSETS = ORDER == 4 ? 8 : 2;  // stage Jacobians
  // rows [0, NSETS NJC): the Jacobians' entries
  static constexpr int A0 = NSETS * NJC;            // A0 (13 x pitch 16)
  static constexpr int B0 = A0 + NX * 16;           // B0 (13x4)
  static constexpr int C = B0 + NX * NU;            // c0, c1
  static constexpr int QD = C + 2 * NX;             // q
  static constexpr int QX0 = QD + NX;               // qx0
  static constexpr int H = QX0 + NX;                // qx1, then h
  static constexpr int RU = H + NX;                 // ru0, ru1
  static constexpr int END = RU + 2 * NU;
};

template <int ORDER>
constexpr int kLaneValues = Slot<ORDER>::END;
static_assert(kLaneValues<4> == 589 && kLaneValues<2> == 397,
              "prep_launch_geometry's PREP_LANE_VALUES");

template <typename T, int ORDER>
constexpr int smem_bytes() {
  return kLanes * kLaneValues<ORDER> * static_cast<int>(sizeof(T));
}

// What __launch_bounds__ asks for: 512 threads an SM (128 registers a
// thread), as many blocks as shared memory allows.
template <typename T, int ORDER>
constexpr int min_blocks() {
  return std::max(1, std::min(512 / kThreads,
                              (227 * 1024) / smem_bytes<T, ORDER>()));
}

// Column jobs: 0..12 A columns, B columns (both stages), cbar, the odd
// stage's own B columns.
constexpr int kJobB = NX, kJobC = NX + NU, kJobBu = NX + NU + 1;

// The column jobs go in rounds of kSlots jobs of one kind, one a worker of
// a group, so a warp runs one code path (kSlots = 1 at 32 lanes a warp):
// the A columns and cbar (the odd chain), then the B columns, then the odd
// B columns.  Rounds are dealt to the groups in a snake order.
constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
constexpr int kRoundsX = cdiv(NX + 1, kSlots), kRoundsU = cdiv(NU, kSlots);
constexpr int kRounds = kRoundsX + 2 * kRoundsU;
// The cost jobs: column i of [A0 | B0] (0..12 Qbar's, 13..16 R00's) goes
// to worker i mod kWorkers, so each row of A0 and B0 a worker reads serves
// all of its (up to kCostCols) columns.
constexpr int kCostCols = cdiv(NX + NU, kWorkers);

// Round of a group's r-th turn.
__device__ __forceinline__ int dealt(int r, int g) {
  return r * kGroups + ((r & 1) ? kGroups - 1 - g : g);
}

// Column job of slot s in round q, or -1.
__device__ __forceinline__ int column_job(int q, int s) {
  if (q < kRoundsX) {
    const int i = q * kSlots + s;
    return i < NX ? i : (i == NX ? kJobC : -1);
  }
  q -= kRoundsX;
  const int i = (q % kRoundsU) * kSlots + s;
  return i < NU ? (q < kRoundsU ? kJobB : kJobBu) + i : -1;
}

template <typename T>
struct alignas(16) Pack {
  T v[16 / sizeof(T)];
};

// Entry e of the packed field at row `row0` of lane l: packs of P = 16 /
// sizeof(T) entries a lane, so the lanes of a warp read a pack in one
// 16-byte load each (and the workers of a warp, on the same lanes, the
// same addresses).
template <typename T>
__device__ __forceinline__ int pack_index(int row0, int e, int l) {
  constexpr int P = 16 / sizeof(T);
  return (row0 + e - e % P) * kLanes + l * P + e % P;
}

// Entry k of Jacobian `set`.
template <typename T>
__device__ __forceinline__ int jac_index(int set, int k, int l) {
  return pack_index<T>(set * NJC, k, l);
}

// Entries [0, n) of the packed field at row `row0`, a pack a load.
template <typename T, int n>
__device__ __forceinline__ void pack_load(const T* sh, int row0, int l,
                                          T (&c)[n]) {
  constexpr int P = 16 / sizeof(T);
  static_assert(n % P == 0, "whole packs");
#pragma unroll
  for (int k = 0; k < n; k += P) {
    const Pack<T> v =
        *reinterpret_cast<const Pack<T>*>(sh + pack_index<T>(row0, k, l));
#pragma unroll
    for (int i = 0; i < P; ++i) c[k + i] = v.v[i];
  }
}

// Lane l's entries of Jacobian `set`.
template <typename T>
__device__ __forceinline__ void jac_load(const T* sh, int set, int l,
                                         T (&c)[NJC]) {
  pack_load(sh, set * NJC, l, c);
}

// out = A w through the interval whose Jacobians start at `set0`
// (tangent_x's chain, the Jacobians from shared memory).  out may be w.
template <int ORDER, typename T>
__device__ __forceinline__ void chain_x(const Par<T>& p, const T* sh,
                                        int set0, int l, const T* w,
                                        T* out) {
  T c[NJC], m[NX], acc[NX], v[NX];
  if constexpr (ORDER == 2) {
    jac_load(sh, set0, l, c);
    jac_apply(p, c, w, m);
    jac_apply(p, c, m, v);
    const T h2 = p.dt * p.dt / T(2);
#pragma unroll
    for (int i = 0; i < NX; ++i) out[i] = w[i] + p.dt * m[i] + h2 * v[i];
    return;
  }
  const T h = T(0.5) * p.dt;
  jac_load(sh, set0, l, c);
  jac_apply(p, c, w, m);
#pragma unroll
  for (int i = 0; i < NX; ++i) { acc[i] = m[i]; v[i] = w[i] + h * m[i]; }
  jac_load(sh, set0 + 1, l, c);
  jac_apply(p, c, v, m);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    acc[i] = acc[i] + 2 * m[i];
    v[i] = w[i] + h * m[i];
  }
  jac_load(sh, set0 + 2, l, c);
  jac_apply(p, c, v, m);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    acc[i] = acc[i] + 2 * m[i];
    v[i] = w[i] + p.dt * m[i];
  }
  jac_load(sh, set0 + 3, l, c);
  jac_apply(p, c, v, m);
  const T d6 = p.dt / T(6);
#pragma unroll
  for (int i = 0; i < NX; ++i) out[i] = w[i] + d6 * (acc[i] + m[i]);
}

// out = column `col` of B of the interval whose Jacobians start at `set0`
// (tangent_u's chain); u its input `col`.
template <int ORDER, typename T>
__device__ __forceinline__ void chain_u(const Par<T>& p, const T* sh,
                                        int set0, int l, T u, int col,
                                        T* out) {
  T c[NJC], g[NX], m[NX], acc[NX], v[NX];
  ju_col(p, u, col, g);
  if constexpr (ORDER == 2) {
    jac_load(sh, set0, l, c);
    jac_apply(p, c, g, m);
    const T h = p.dt / T(2);
#pragma unroll
    for (int i = 0; i < NX; ++i) out[i] = p.dt * (g[i] + h * m[i]);
    return;
  }
  const T h = T(0.5) * p.dt;
#pragma unroll
  for (int i = 0; i < NX; ++i) { acc[i] = g[i]; v[i] = h * g[i]; }
  jac_load(sh, set0 + 1, l, c);
  jac_apply(p, c, v, m);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    m[i] = g[i] + m[i];
    acc[i] = acc[i] + 2 * m[i];
    v[i] = h * m[i];
  }
  jac_load(sh, set0 + 2, l, c);
  jac_apply(p, c, v, m);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    m[i] = g[i] + m[i];
    acc[i] = acc[i] + 2 * m[i];
    v[i] = p.dt * m[i];
  }
  jac_load(sh, set0 + 3, l, c);
  jac_apply(p, c, v, m);
  const T d6 = p.dt / T(6);
#pragma unroll
  for (int i = 0; i < NX; ++i) out[i] = d6 * (acc[i] + (g[i] + m[i]));
}

template <typename T, int ORDER>
__global__ void __launch_bounds__(kThreads, (min_blocks<T, ORDER>()))
prep_condense2_kernel(const T* __restrict__ x, const T* __restrict__ u,
                      const T* __restrict__ yref, const T* __restrict__ qd,
                      const T* __restrict__ rd, const T* __restrict__ lbu,
                      const T* __restrict__ ubu, const T* __restrict__ par,
                      T* __restrict__ Abar, T* __restrict__ Bbar,
                      T* __restrict__ cbar, T* __restrict__ Qbar,
                      T* __restrict__ S1T, T* __restrict__ R00,
                      T* __restrict__ qbar, T* __restrict__ rbar,
                      T* __restrict__ Ae, T* __restrict__ Be,
                      T* __restrict__ c, T* __restrict__ lb,
                      T* __restrict__ ub, int B) {
  using S = Slot<ORDER>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sh = reinterpret_cast<T*>(smem_raw);
  // warp wp holds kRowLanes consecutive lanes of kSlots workers (slot s)
  // of group g, worker w = g kSlots + s (with kRowLanes = 32: the block's
  // lanes, of worker wp)
  const int wp = threadIdx.x / 32, s = threadIdx.x % 32 / kRowLanes;
  const int g = wp / kRows;
  const int l = wp % kRows * kRowLanes + threadIdx.x % kRowLanes;
  const int w = g * kSlots + s;
  const int b0 = blockIdx.x * kLanes;
  const int b = min(b0 + l, B - 1);
  const bool valid = b0 + l < B;
  const int j = blockIdx.y;  // stage pair
  const int e = 2 * j, o = 2 * j + 1;
  // entry r of shared row `row` of this lane; every store of an output
  // entry r of a batch-last array at `base` goes through put()
  const auto at = [&](int row) -> T& { return sh[row * kLanes + l]; };
  const auto put = [&](T* base, int r, T v) {
    if (valid) __stcs(base + (size_t)r * B + b, v);
  };
  const Par<T> p = load_par(par, B, b);
  const int sets = S::NSETS / 2;  // Jacobians an interval

  // 1. both intervals' RK4 stages (workers 0, 1); linear terms (worker 2)
  if (w < 2) {
    const int k = e + w;
    T xk[NX], uk[NU], X[4][NX], xn[NX];
    auto xs = lane(x, NX, k, B, b);
    auto us = lane(u, NU, k, B, b);
#pragma unroll
    for (int i = 0; i < NX; ++i) xk[i] = xs[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) uk[i] = us[i];
    rk4_stages(p, xk, uk, X, xn);
    auto x1 = lane(x, NX, k + 1, B, b);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const T ci = xn[i] - x1[i];
      at(S::C + w * NX + i) = ci;
      put(c, k * NX + i, ci);
    }
    // the states the Jacobians are built at, in their sets' rows: X_1..X_4
    // (ORDER 4) or the midpoint X_2 (ORDER 2); jac_build reads x[3..12]
#pragma unroll
    for (int q = 0; q < sets; ++q) {
#pragma unroll
      for (int i = 3; i < NX; ++i)
        sh[jac_index<T>(w * sets + q, JC_Q + i - 3, l)] =
            X[ORDER == 4 ? q : 1][i];
    }
  } else if (w == 2) {
    auto ye = lane(yref, NY, e, B, b), yo = lane(yref, NY, o, B, b);
    auto xe = lane(x, NX, e, B, b), xo = lane(x, NX, o, B, b);
    auto ue = lane(u, NU, e, B, b), uo = lane(u, NU, o, B, b);
    auto q = lane(qd, NX, 0, B, b), r = lane(rd, NU, 0, B, b);
    auto lo = lane(lbu, NU, 0, B, b), hi = lane(ubu, NU, 0, B, b);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const T qi = q[i];
      at(S::QD + i) = qi;
      at(S::QX0 + i) = qi * (xe[i] - ye[i]);
      at(S::H + i) = qi * (xo[i] - yo[i]);  // qx1
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const T uei = ue[i], uoi = uo[i];
      at(S::RU + i) = r[i] * (uei - ye[NX + i]);
      at(S::RU + NU + i) = r[i] * (uoi - yo[NX + i]);
      put(lb, e * NU + i, lo[i] - uei);
      put(lb, o * NU + i, lo[i] - uoi);
      put(ub, e * NU + i, hi[i] - uei);
      put(ub, o * NU + i, hi[i] - uoi);
    }
  }
  __syncthreads();

  // 2. each stage Jacobian built once; h = q c0 + qx1 (worker 2)
#pragma unroll 1
  for (int set = w; set < S::NSETS; set += kWorkers) {
    T xj[NX], cj[NJC];
#pragma unroll
    for (int i = 3; i < NX; ++i)
      xj[i] = sh[jac_index<T>(set, JC_Q + i - 3, l)];
    jac_build(xj, cj);
#pragma unroll
    for (int k = 0; k < NJC; ++k) sh[jac_index<T>(set, k, l)] = cj[k];
  }
  if (w == 2) {
#pragma unroll
    for (int i = 0; i < NX; ++i)
      at(S::H + i) = at(S::QD + i) * at(S::C + i) + at(S::H + i);
  }
  __syncthreads();

  // 3. the column jobs
#pragma unroll 1
  for (int r = 0;; ++r) {
    const int round = dealt(r, g);
    if (round >= kRounds) break;
    const int job = column_job(round, s);
    if (job < 0) continue;
    T v[NX];
    if (job < kJobB) {
#pragma unroll
      for (int i = 0; i < NX; ++i) v[i] = (i == job) ? T(1) : T(0);
      chain_x<ORDER>(p, sh, 0, l, v, v);  // the even chain of an A column
    } else if (job != kJobC) {
      const bool even = job < kJobC;
      const int col = even ? job - kJobB : job - kJobBu;
      const T uc = u[(size_t)((even ? e : o) * NU + col) * B + b];
      chain_u<ORDER>(p, sh, even ? 0 : sets, l, uc, col, v);
    } else {
#pragma unroll
      for (int i = 0; i < NX; ++i) v[i] = at(S::C + i);
    }
    if (job < kJobC) {  // an even column: Ae/Be, and A0/B0 for step 4
      const bool a = job < kJobB;
      const int col = a ? job : job - kJobB, nc = a ? NX : NU;
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        sh[pack_index<T>(a ? S::A0 : S::B0, i * (a ? 16 : NU) + col, l)] =
            v[i];
        put(a ? Ae : Be, (j * NX + i) * nc + col, v[i]);
      }
    }
    if (job <= kJobC) chain_x<ORDER>(p, sh, sets, l, v, v);  // odd chain
    if (job == kJobC) {
#pragma unroll
      for (int i = 0; i < NX; ++i)
        put(cbar, j * NX + i, v[i] + at(S::C + NX + i));
    } else if (job < kJobB) {
#pragma unroll
      for (int i = 0; i < NX; ++i) put(Abar, (j * NX + i) * NX + job, v[i]);
    } else {
      const int col = job < kJobC ? job - kJobB : NU + job - kJobBu;
#pragma unroll
      for (int i = 0; i < NX; ++i) put(Bbar, (j * NX + i) * NUC + col, v[i]);
    }
  }
  __syncthreads();

  // 4. the cost jobs: for each column `col` of [A0 | B0] a worker holds,
  // f = A0 e_col (Qbar, S1T and qbar's column) or B0 e_col (R00 and
  // rbar's): out[i] = sum_k X[k][i] q[k] f[k], X = A0 or B0, and
  // sum_k f[k] h[k]; rows k of A0 and B0 read once a worker, as packs
  {
    T qa[kCostCols][NX], qb[kCostCols][NU], hs[kCostCols];
    bool any_a = false;
#pragma unroll
    for (int cc = 0; cc < kCostCols; ++cc)
      any_a = any_a || w + cc * kWorkers < NX;
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      T br[NU], ar[16];
      pack_load(sh, S::B0 + k * NU, l, br);
      if (any_a) pack_load(sh, S::A0 + k * 16, l, ar);
      const T qk = at(S::QD + k), hk = at(S::H + k);
#pragma unroll
      for (int cc = 0; cc < kCostCols; ++cc) {
        const int col = w + cc * kWorkers;
        if (col >= NX + NU) continue;
        const bool a = col < NX;
        const T f = sh[a ? pack_index<T>(S::A0, k * 16 + col, l)
                         : pack_index<T>(S::B0, k * NU + col - NX, l)];
        const T qf = qk * f;
        hs[cc] = k ? hs[cc] + f * hk : f * hk;
#pragma unroll
        for (int i = 0; i < NU; ++i)
          qb[cc][i] = k ? qb[cc][i] + br[i] * qf : br[i] * qf;
        if (a) {
#pragma unroll
          for (int i = 0; i < NX; ++i)
            qa[cc][i] = k ? qa[cc][i] + ar[i] * qf : ar[i] * qf;
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < kCostCols; ++cc) {
      const int col = w + cc * kWorkers;
      if (col >= NX + NU) continue;
      if (col < NX) {
#pragma unroll
        for (int i = 0; i < NX; ++i)
          put(Qbar, (j * NX + i) * NX + col,
              i == col ? qa[cc][i] + at(S::QD + i) : qa[cc][i]);
#pragma unroll
        for (int i = 0; i < NU; ++i)
          put(S1T, (j * NU + i) * NX + col, qb[cc][i]);
        put(qbar, j * NX + col, at(S::QX0 + col) + hs[cc]);
      } else {
        const int cu = col - NX;
#pragma unroll
        for (int i = 0; i < NU; ++i)
          put(R00, (j * NU + i) * NU + cu, qb[cc][i]);
        put(rbar, j * NUC + cu, at(S::RU + cu) + hs[cc]);
        put(rbar, j * NUC + NU + cu, at(S::RU + NU + cu));
      }
    }
  }
}

template <typename T, int ORDER>
int set_smem() {
  if (smem_bytes<T, ORDER>() <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      prep_condense2_kernel<T, ORDER>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T, ORDER>()));
}

template <typename T, int ORDER>
int launch(const T* x, const T* u, const T* yref, const T* qd, const T* rd,
           const T* lbu, const T* ubu, const T* par, T* Abar, T* Bbar,
           T* cbar, T* Qbar, T* S1T, T* R00, T* qbar, T* rbar, T* Ae, T* Be,
           T* c, T* lb, T* ub, int M, int B, int grid, int threads, int smem,
           void* stream) {
  if (B < 1 || M < 1 || M > 65535 || threads != kThreads ||
      smem != smem_bytes<T, ORDER>() || grid != (B + kLanes - 1) / kLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = set_smem<T, ORDER>();
  if (err != 0) return err;
  const dim3 blocks(grid, M);
  prep_condense2_kernel<T, ORDER>
      <<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          x, u, yref, qd, rd, lbu, ubu, par, Abar, Bbar, cbar, Qbar, S1T,
          R00, qbar, rbar, Ae, Be, c, lb, ub, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grid, threads and smem are the wrapper's prep_launch_geometry.
#define PREP_ENTRY(NAME, T, ORDER)                                           \
  extern "C" int NAME(const T* x, const T* u, const T* yref, const T* qd,    \
                      const T* rd, const T* lbu, const T* ubu, const T* par, \
                      T* Abar, T* Bbar, T* cbar, T* Qbar, T* S1T, T* R00,    \
                      T* qbar, T* rbar, T* Ae, T* Be, T* c, T* lb, T* ub,    \
                      int M, int B, int grid, int threads, int smem,         \
                      void* stream) {                                        \
    return launch<T, ORDER>(x, u, yref, qd, rd, lbu, ubu, par, Abar, Bbar,   \
                            cbar, Qbar, S1T, R00, qbar, rbar, Ae, Be, c, lb, \
                            ub, M, B, grid, threads, smem, stream);          \
  }

#define PREP_OCCUPANCY(NAME, T, ORDER)                                       \
  extern "C" int NAME(int* blocks_per_sm) {                                  \
    const int err = set_smem<T, ORDER>();                                    \
    if (err != 0) return err;                                                \
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(   \
        blocks_per_sm, prep_condense2_kernel<T, ORDER>, kThreads,            \
        smem_bytes<T, ORDER>()));                                            \
  }

PREP_ENTRY(prep_condense2_f32, float, 4)
PREP_ENTRY(prep_condense2_f64, double, 4)
// the order-2 VDE sensitivities (vde_order=2)
PREP_ENTRY(prep_condense2_o2_f32, float, 2)
PREP_ENTRY(prep_condense2_o2_f64, double, 2)
PREP_OCCUPANCY(prep_condense2_occupancy_f32, float, 4)
PREP_OCCUPANCY(prep_condense2_occupancy_f64, double, 4)
PREP_OCCUPANCY(prep_condense2_occupancy_o2_f32, float, 2)
PREP_OCCUPANCY(prep_condense2_occupancy_o2_f64, double, 2)
