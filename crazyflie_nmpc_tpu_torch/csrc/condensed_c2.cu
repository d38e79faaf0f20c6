// Block-2 partial condensing and the interior-state expansion.
//
// Replaces, in crazyflie_nmpc_tpu/ops/pallas/condensed_kernels.py:
//   condense2          (_condense2_kernel)      -> condense2_kernel
//   expand2            (_expand2_kernel, both forms: even_only=True is
//                       stride 1, even_only=False stride 2) -> expand2_kernel
//
// The sweeps of the condensed QP have their own sources, a group of
// threads per lane with the stage inputs in shared memory: kkt_sweep_c2
// (K2) and the windowed factorization K5a bwd_c2 (_bwd_c2_kernel, K2's
// body without its rollout) in kkt_sweep_c2.cu; corrector_sweep_c2 (K3),
// the windowed rollout K5b fwd_c2 (_fwd_c2_kernel, K3's rollout alone) and
// the windowed corrector's vector pass K5c bwd_vec_c2 (_bwd_vec_c2_kernel,
// K3's body without its rollout) in corrector_sweep_c2.cu; iter_sweep_c2
// (K10) in iter_c2.cu.
//
// K4 expand2: one thread per (lane, stage pair), the grid spanning lanes
// and pairs.  It is bound by bytes (it reads Ae/Be once) and runs at 0.83
// of that bound on the H100 (PERF.md).
//
// K6 condense2: per pair and lane it reads 528 values and writes 544 for
// ~6.6k multiply-adds: bound by bytes (439 MB at B=4096, M=25 in float32,
// 0.131 ms at 3.35 TB/s).  One thread per (lane, pair), its form before,
// held A0, B0, c0, q1 and h (~260 values) at 255 registers with spills in
// both dtypes: 2 blocks of 128 threads an SM, too few loads in flight,
// 0.41 ms at B=4096 (3.1x the bound).  Here it runs on K1's block
// (prep_condense2.cu): kLanes = 32 consecutive lanes of one pair and
// kWorkers = 8 threads a lane, warp wp holding the block's 32 lanes of
// worker wp, so every global load or store of one entry covers 32 lanes,
// one 128-byte line in float32.
//   1. The workers land A0 (rows of pitch 16) and B0, packed as K1 packs
//      them (16 bytes a lane: a row is read in 16-byte loads), c0, q1 and
//      h = q1 c0 + qx1 in shared memory, dealt between them a pack or an
//      entry of the three vectors at a time, every load issued before the
//      first store.  Each worker also loads its row jobs' rows of A1, B1
//      and c1 and its cost columns' Qbar diagonal and linear terms into
//      registers.  One barrier.
//   2. The row jobs: row i of A1 times [A0 | B0 | c0] gives row i of Abar,
//      the four products of Bbar's row (B1's row copied beside them) and
//      cbar's entry; rows are dealt to the workers from the last one down,
//      as the cost columns leave the later workers the less work.
//   3. The cost columns, K1's phase 4: column col of [A0 | B0] goes to
//      worker col mod kWorkers; Qbar's column, S1T's column and qbar's
//      entry for an A0 column, R00's column and rbar's entries for a B0
//      column, each row of A0 and B0 read once a worker for all of its
//      columns.
// Every sum runs in the one-thread kernel's order, which is the plain
// order K1's phase 4 keeps: Abar, Bbar and R00 equal that kernel's bit for
// bit on the card; cbar, Qbar, S1T, qbar and rbar differ in the last bits
// of a few percent of their entries (where nvcc fuses another multiply of
// a sum into an FMA).  Stores are evict-first (__stcs), as K1's.
//
// On the H100 (80GB HBM3, 700 W; roofline/kkt_variants.py, PERF.md) it
// takes 0.185 ms at B=4096, M=25 in float32 (1.41x the bytes bound,
// 0.41 one thread per lane); without its loads it takes 0.128, without
// its stores 0.134, without the row jobs 0.109, without the cost columns
// 0.114: the parts overlap.  4 workers spill and are slower (0.299), 16
// workers (0.231) and 64 lanes a block (0.223) are slower too.
//
// Shared memory: [value][lane] rows of kLanes values, kLaneValues = 299 a
// lane (38,272 bytes a block in float32, 76,544 in float64).
// `__launch_bounds__` asks for 2 blocks of 256 threads in float32 (128
// registers a thread), 1 in float64 (its cost columns hold 54 doubles).
// The wrapper (ops/cuda/condensed_kernels.condense_launch_geometry)
// computes grid, block and shared bytes; the launch refuses numbers that
// disagree with these.  Ragged tiles: spare lanes read lane B-1, store
// nothing, and take part in the barrier.
#include <algorithm>

#include "batch_last.cuh"

using namespace cfl;

namespace {

constexpr int kLanes = 32;                    // lanes a block
constexpr int kThreads = 256;                 // threads a block
constexpr int kWorkers = kThreads / kLanes;   // threads a lane
constexpr int kRows = kLanes / 32;            // warps a worker spans
static_assert(kLanes % 32 == 0 && kThreads % kLanes == 0,
              "a warp holds 32 lanes of one worker");

// Shared memory rows (of kLanes values each).  A0 (rows of pitch 16) and
// B0 are packed (pack_index), so a row is read in 16-byte loads.
struct Slot {
  static constexpr int A0 = 0;                // A0 (13 x pitch 16)
  static constexpr int B0 = A0 + NX * 16;     // B0 (13x4)
  static constexpr int C0 = B0 + NX * NU;     // c0
  static constexpr int Q1 = C0 + NX;          // q1 = qxx[2j+1]
  static constexpr int H = Q1 + NX;           // h = q1 c0 + qx1
  static constexpr int END = H + NX;
};
constexpr int kLaneValues = Slot::END;
static_assert(kLaneValues == 299,
              "condense_launch_geometry's CONDENSE_LANE_VALUES");

template <typename T>
constexpr int smem_bytes() {
  return kLanes * kLaneValues * static_cast<int>(sizeof(T));
}

// What __launch_bounds__ asks for: 512 threads an SM in float32 (128
// registers a thread), 256 in float64, as many blocks as shared memory
// allows.
template <typename T>
constexpr int min_blocks() {
  return std::max(1, std::min((sizeof(T) == 4 ? 512 : 256) / kThreads,
                              (227 * 1024) / smem_bytes<T>()));
}

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}
// the cost columns a worker holds (column col: worker col mod kWorkers),
// the row jobs it runs (row i: worker kWorkers - 1 - i mod kWorkers)
constexpr int kCostCols = cdiv(NX + NU, kWorkers);
constexpr int kRowJobs = cdiv(NX, kWorkers);

template <typename T>
struct alignas(16) Pack {
  T v[16 / sizeof(T)];
};

// Entry e of the packed field at row `row0` of lane l: packs of P = 16 /
// sizeof(T) entries a lane (K1's layout).
template <typename T>
__device__ __forceinline__ int pack_index(int row0, int e, int l) {
  constexpr int P = 16 / sizeof(T);
  return (row0 + e - e % P) * kLanes + l * P + e % P;
}

// Entries [0, n) of the packed field at row `row0`, a pack a load.
template <typename T, int n>
__device__ __forceinline__ void pack_load(const T* sh, int row0, int l,
                                          T (&c)[16]) {
  constexpr int P = 16 / sizeof(T);
  static_assert(n % P == 0 && n <= 16, "whole packs");
#pragma unroll
  for (int k = 0; k < n; k += P) {
    const Pack<T> v =
        *reinterpret_cast<const Pack<T>*>(sh + pack_index<T>(row0, k, l));
#pragma unroll
    for (int i = 0; i < P; ++i) c[k + i] = v.v[i];
  }
}

// Block-2 condensing of stage pair j (stages 2j, 2j+1) of diagonal-cost
// stage data; q1 = qxx[2j+1] is the eliminated state's cost diagonal:
//   Abar = A1 A0, Bbar = [A1 B0, B1], cbar = A1 c0 + c1,
//   Qbar = A0' q1 A0 + diag(qxx[2j]), S1T = B0' q1 A0, R00 = B0' q1 B0,
//   qbar = qx0 + A0' h, rbar = [ru0 + B0' h, ru1],  h = q1 c0 + qx1.
template <typename T>
__global__ void __launch_bounds__(kThreads, (min_blocks<T>()))
condense2_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ c, const T* __restrict__ qxx,
                 const T* __restrict__ qx, const T* __restrict__ ru,
                 T* __restrict__ Abar, T* __restrict__ Bbar,
                 T* __restrict__ cbar, T* __restrict__ Qbar,
                 T* __restrict__ S1T, T* __restrict__ R00,
                 T* __restrict__ qbar, T* __restrict__ rbar, int B) {
  using S = Slot;
  constexpr int P = 16 / sizeof(T);
  // packs of an A0 row holding an entry (the rest of pitch 16 is never
  // read), of a B0 row; phase 1's jobs: those packs, then the 13 entries
  // of c0, q1 and h
  constexpr int kPacksA = cdiv(NX, P), kPacksB = NU / P;
  constexpr int kJobsA = NX * kPacksA, kJobsB = NX * kPacksB;
  constexpr int kLoadJobs = kJobsA + kJobsB + NX;
  constexpr int kTurns = cdiv(kLoadJobs, kWorkers);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sh = reinterpret_cast<T*>(smem_raw);
  // warp wp holds 32 consecutive lanes of worker w
  const int wp = threadIdx.x / 32;
  const int w = wp / kRows;
  const int l = wp % kRows * 32 + threadIdx.x % 32;
  const int b0 = blockIdx.x * kLanes;
  const int b = min(b0 + l, B - 1);
  const bool valid = b0 + l < B;
  const int j = blockIdx.y;  // stage pair
  const int e = 2 * j, o = 2 * j + 1;
  // entry r of shared row `row` of this lane; entry r of this lane of a
  // batch-last array at `base`; every store of an output entry goes
  // through put()
  const auto at = [&](int row) -> T& { return sh[row * kLanes + l]; };
  const auto in = [&](const T* base, int r) {
    return base[(size_t)r * B + b];
  };
  const auto put = [&](T* base, int r, T v) {
    if (valid) __stcs(base + (size_t)r * B + b, v);
  };

  // 1. loads: this worker's packs and vector entries, its row jobs' rows
  // of A1, B1 and c1, its cost columns' Qbar diagonal and linear terms
  T v[kTurns][4];
#pragma unroll
  for (int t = 0; t < kTurns; ++t) {
    const int q = w + t * kWorkers;
    if (q < kJobsA) {
      const int k = q / kPacksA, e0 = q % kPacksA * P;
#pragma unroll
      for (int i = 0; i < P; ++i)
        v[t][i] = e0 + i < NX ? in(A, (e * NX + k) * NX + e0 + i) : T(0);
    } else if (q < kJobsA + kJobsB) {
      const int k = (q - kJobsA) / kPacksB, e0 = (q - kJobsA) % kPacksB * P;
#pragma unroll
      for (int i = 0; i < P; ++i) v[t][i] = in(Bm, (e * NX + k) * NU + e0 + i);
    } else if (q < kLoadJobs) {
      const int i = q - kJobsA - kJobsB;
      v[t][0] = in(c, e * NX + i);
      v[t][1] = in(qxx, o * NX + i);
      v[t][2] = in(qx, o * NX + i);
    }
  }
  T r1[kRowJobs][NX + NU + 1];
#pragma unroll
  for (int t = 0; t < kRowJobs; ++t) {
    const int i = kWorkers - 1 - w + t * kWorkers;
    if (i >= NX) continue;
#pragma unroll
    for (int k = 0; k < NX; ++k) r1[t][k] = in(A, (o * NX + i) * NX + k);
#pragma unroll
    for (int a = 0; a < NU; ++a) r1[t][NX + a] = in(Bm, (o * NX + i) * NU + a);
    r1[t][NX + NU] = in(c, o * NX + i);
  }
  T lin[kCostCols][2];
#pragma unroll
  for (int cc = 0; cc < kCostCols; ++cc) {
    const int col = w + cc * kWorkers;
    if (col < NX) {
      lin[cc][0] = in(qxx, e * NX + col);
      lin[cc][1] = in(qx, e * NX + col);
    } else if (col < NX + NU) {
      lin[cc][0] = in(ru, e * NU + col - NX);
      lin[cc][1] = in(ru, o * NU + col - NX);
    }
  }
#pragma unroll
  for (int t = 0; t < kTurns; ++t) {
    const int q = w + t * kWorkers;
    if (q < kJobsA + kJobsB) {
      const bool a = q < kJobsA;
      const int k = a ? q / kPacksA : (q - kJobsA) / kPacksB;
      const int e0 = (a ? q % kPacksA : (q - kJobsA) % kPacksB) * P;
      Pack<T> pk;
#pragma unroll
      for (int i = 0; i < P; ++i) pk.v[i] = v[t][i];
      *reinterpret_cast<Pack<T>*>(
          sh + pack_index<T>(a ? S::A0 : S::B0, k * (a ? 16 : NU) + e0, l)) =
          pk;
    } else if (q < kLoadJobs) {
      const int i = q - kJobsA - kJobsB;
      at(S::C0 + i) = v[t][0];
      at(S::Q1 + i) = v[t][1];
      at(S::H + i) = v[t][1] * v[t][0] + v[t][2];
    }
  }
  __syncthreads();

  // 2. the row jobs: row i of A1 times [A0 | B0 | c0]
#pragma unroll
  for (int t = 0; t < kRowJobs; ++t) {
    const int i = kWorkers - 1 - w + t * kWorkers;
    if (i >= NX) continue;
    T ab[NX], bb[NU], cb;
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      T ar[16], br[16];
      pack_load<T, kPacksA * P>(sh, S::A0 + k * 16, l, ar);
      pack_load<T, NU>(sh, S::B0 + k * NU, l, br);
      const T rk = r1[t][k], ck = at(S::C0 + k);
#pragma unroll
      for (int jc = 0; jc < NX; ++jc)
        ab[jc] = k ? ab[jc] + rk * ar[jc] : rk * ar[jc];
#pragma unroll
      for (int a = 0; a < NU; ++a) bb[a] = k ? bb[a] + rk * br[a] : rk * br[a];
      cb = k ? cb + rk * ck : rk * ck;
    }
#pragma unroll
    for (int jc = 0; jc < NX; ++jc) put(Abar, (j * NX + i) * NX + jc, ab[jc]);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      put(Bbar, (j * NX + i) * NUC + a, bb[a]);
      put(Bbar, (j * NX + i) * NUC + NU + a, r1[t][NX + a]);
    }
    put(cbar, j * NX + i, cb + r1[t][NX + NU]);
  }

  // 3. the cost columns: for each column `col` of [A0 | B0] a worker
  // holds, f = A0 e_col (Qbar, S1T and qbar's column) or B0 e_col (R00
  // and rbar's): out[i] = sum_k X[k][i] q1[k] f[k], X = A0 or B0, and
  // sum_k f[k] h[k]; rows k of A0 and B0 read once a worker, as packs
  {
    T qa[kCostCols][NX], qb[kCostCols][NU], hs[kCostCols];
    bool any_a = false;
#pragma unroll
    for (int cc = 0; cc < kCostCols; ++cc)
      any_a = any_a || w + cc * kWorkers < NX;
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      T br[16], ar[16];
      pack_load<T, NU>(sh, S::B0 + k * NU, l, br);
      if (any_a) pack_load<T, kPacksA * P>(sh, S::A0 + k * 16, l, ar);
      const T qk = at(S::Q1 + k), hk = at(S::H + k);
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
              i == col ? qa[cc][i] + lin[cc][0] : qa[cc][i]);
#pragma unroll
        for (int i = 0; i < NU; ++i)
          put(S1T, (j * NU + i) * NX + col, qb[cc][i]);
        put(qbar, j * NX + col, lin[cc][1] + hs[cc]);
      } else {
        const int cu = col - NX;
#pragma unroll
        for (int i = 0; i < NU; ++i)
          put(R00, (j * NU + i) * NU + cu, qb[cc][i]);
        put(rbar, j * NUC + cu, lin[cc][0] + hs[cc]);
        put(rbar, j * NUC + NU + cu, lin[cc][1]);
      }
    }
  }
}

// dx_odd[k] = Ae[s k] dx_even[k] + Be[s k] du0[k] + c[2k], stride s = 1
// (even-stage Ae/Be) or 2 (full-horizon A/B, read in place)
template <typename T>
__global__ void __launch_bounds__(128)
expand2_kernel(const T* __restrict__ Ae, const T* __restrict__ Be,
               const T* __restrict__ c, const T* __restrict__ dxe,
               const T* __restrict__ du0, T* __restrict__ dxo, int B,
               int stride) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  if (b >= B) return;
  auto A = lane(Ae, NX * NX, stride * k, B, b);
  auto Bm = lane(Be, NX * NU, stride * k, B, b);
  auto ck = lane(c, NX, 2 * k, B, b);
  auto xe = lane(dxe, NX, k, B, b);
  auto ue = lane(du0, NU, k, B, b);
  auto out = lane(dxo, NX, k, B, b);
  T x[NX], u[NU];
#pragma unroll
  for (int j = 0; j < NX; ++j) x[j] = xe[j];
#pragma unroll
  for (int a = 0; a < NU; ++a) u[a] = ue[a];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    T s = A[i * NX] * x[0];
#pragma unroll
    for (int j = 1; j < NX; ++j) s = s + A[i * NX + j] * x[j];
    T t = Bm[i * NU] * u[0];
#pragma unroll
    for (int a = 1; a < NU; ++a) t = t + Bm[i * NU + a] * u[a];
    out[i] = s + t + ck[i];
  }
}

inline cudaStream_t as_stream(void* s) {
  return static_cast<cudaStream_t>(s);
}

template <typename T>
int set_smem() {
  if (smem_bytes<T>() <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      condense2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<T>()));
}

// K6's launch: grid, threads and smem are the wrapper's
// condense_launch_geometry; another is refused
template <typename T>
int condense2_launch(const T* A, const T* Bm, const T* c, const T* qxx,
                     const T* qx, const T* ru, T* Abar, T* Bbar, T* cbar,
                     T* Qbar, T* S1T, T* R00, T* qbar, T* rbar, int M, int B,
                     int grid, int threads, int smem, void* stream) {
  if (B < 1 || M < 1 || M > 65535 || threads != kThreads ||
      smem != smem_bytes<T>() || grid != (B + kLanes - 1) / kLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = set_smem<T>();
  if (err != 0) return err;
  condense2_kernel<T><<<dim3(grid, M), threads, smem, as_stream(stream)>>>(
      A, Bm, c, qxx, qx, ru, Abar, Bbar, cbar, Qbar, S1T, R00, qbar, rbar, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define C2_ENTRIES(SUFFIX, T)                                                 \
  extern "C" int condense2_##SUFFIX(                                          \
      const T* A, const T* Bm, const T* c, const T* qxx, const T* qx,         \
      const T* ru, T* Abar, T* Bbar, T* cbar, T* Qbar, T* S1T, T* R00,        \
      T* qbar, T* rbar, int M, int B, int grid, int threads, int smem,        \
      void* stream) {                                                         \
    return condense2_launch<T>(A, Bm, c, qxx, qx, ru, Abar, Bbar, cbar, Qbar, \
                               S1T, R00, qbar, rbar, M, B, grid, threads,     \
                               smem, stream);                                 \
  }                                                                           \
  extern "C" int condense2_occupancy_##SUFFIX(int* blocks_per_sm) {           \
    const int err = set_smem<T>();                                            \
    if (err != 0) return err;                                                 \
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(    \
        blocks_per_sm, condense2_kernel<T>, kThreads, smem_bytes<T>()));      \
  }                                                                           \
  extern "C" int expand2_##SUFFIX(const T* Ae, const T* Be, const T* c,       \
                                  const T* dxe, const T* du0, T* dxo, int M,  \
                                  int B, int stride, void* stream) {          \
    expand2_kernel<T><<<dim3((B + 127) / 128, M), 128, 0,                     \
                        as_stream(stream)>>>(Ae, Be, c, dxe, du0, dxo, B,     \
                                             stride);                         \
    return static_cast<int>(cudaGetLastError());                              \
  }

C2_ENTRIES(f32, float)
C2_ENTRIES(f64, double)
