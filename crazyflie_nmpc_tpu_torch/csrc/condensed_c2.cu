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
// Design: one thread per (lane, stage pair), as the Pallas kernels make
// every matrix entry a (B,)-lane vector; the grid spans lanes and pairs.
// Bounds on the H100: K4 is bound by bytes (it reads Ae/Be once).  K6 is
// bound by bytes too: per pair and lane it reads ~500 values and writes
// ~660 for ~6k FMAs; it holds A0/B0 (221 values) for the cost products as
// K1 does.
#include "batch_last.cuh"

using namespace cfl;

namespace {

// Block-2 condensing of stage pair j (stages 2j, 2j+1) of diagonal-cost
// stage data; q1 = qxx[2j+1] is the eliminated state's cost diagonal:
//   Abar = A1 A0, Bbar = [A1 B0, B1], cbar = A1 c0 + c1,
//   Qbar = A0' q1 A0 + diag(qxx[2j]), S1T = B0' q1 A0, R00 = B0' q1 B0,
//   qbar = qx0 + A0' h, rbar = [ru0 + B0' h, ru1],  h = q1 c0 + qx1.
template <typename T>
__global__ void __launch_bounds__(128)
condense2_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ c, const T* __restrict__ qxx,
                 const T* __restrict__ qx, const T* __restrict__ ru,
                 T* __restrict__ Abar, T* __restrict__ Bbar,
                 T* __restrict__ cbar, T* __restrict__ Qbar,
                 T* __restrict__ S1T, T* __restrict__ R00,
                 T* __restrict__ qbar, T* __restrict__ rbar, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;  // stage pair
  if (b >= B) return;
  const int e = 2 * j, o = 2 * j + 1;

  T A0[NX][NX], B0[NX][NU], c0[NX], q1[NX], h[NX];
  {
    auto a = lane(A, NX * NX, e, B, b);
    auto bm = lane(Bm, NX * NU, e, B, b);
    auto ce = lane(c, NX, e, B, b);
    auto qo = lane(qxx, NX, o, B, b);
    auto xo = lane(qx, NX, o, B, b);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int k = 0; k < NX; ++k) A0[i][k] = a[i * NX + k];
#pragma unroll
      for (int k = 0; k < NU; ++k) B0[i][k] = bm[i * NU + k];
      c0[i] = ce[i];
      q1[i] = qo[i];
      h[i] = q1[i] * c0[i] + xo[i];
    }
  }

  // condensed dynamics, row by row of A1
  {
    auto a1 = lane(A, NX * NX, o, B, b);
    auto b1 = lane(Bm, NX * NU, o, B, b);
    auto c1 = lane(c, NX, o, B, b);
    auto Ab = lane(Abar, NX * NX, j, B, b);
    auto Bb = lane(Bbar, NX * NUC, j, B, b);
    auto cb = lane(cbar, NX, j, B, b);
#pragma unroll 1
    for (int i = 0; i < NX; ++i) {
      T r[NX];
#pragma unroll
      for (int k = 0; k < NX; ++k) r[k] = a1[i * NX + k];
#pragma unroll
      for (int jc = 0; jc < NX; ++jc) {
        T s = r[0] * A0[0][jc];
#pragma unroll
        for (int k = 1; k < NX; ++k) s = s + r[k] * A0[k][jc];
        Ab[i * NX + jc] = s;
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        T s = r[0] * B0[0][a];
#pragma unroll
        for (int k = 1; k < NX; ++k) s = s + r[k] * B0[k][a];
        Bb[i * NUC + a] = s;
        Bb[i * NUC + NU + a] = b1[i * NU + a];
      }
      T s = r[0] * c0[0];
#pragma unroll
      for (int k = 1; k < NX; ++k) s = s + r[k] * c0[k];
      cb[i] = s + c1[i];
    }
  }

  // condensed cost, column by column of q1 A0
  {
    auto qe = lane(qxx, NX, e, B, b);
    auto xe = lane(qx, NX, e, B, b);
    auto Qb = lane(Qbar, NX * NX, j, B, b);
    auto S = lane(S1T, NU * NX, j, B, b);
    auto R = lane(R00, NU * NU, j, B, b);
    auto qb = lane(qbar, NX, j, B, b);
    auto rb = lane(rbar, NUC, j, B, b);
    auto re = lane(ru, NU, e, B, b);
    auto ro = lane(ru, NU, o, B, b);
#pragma unroll 1
    for (int jc = 0; jc < NX; ++jc) {
      T qa[NX];
#pragma unroll
      for (int k = 0; k < NX; ++k) qa[k] = q1[k] * A0[k][jc];
#pragma unroll 1
      for (int i = 0; i < NX; ++i) {
        T s = A0[0][i] * qa[0];
#pragma unroll
        for (int k = 1; k < NX; ++k) s = s + A0[k][i] * qa[k];
        Qb[i * NX + jc] = (i == jc) ? s + qe[i] : s;
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        T s = B0[0][a] * qa[0];
#pragma unroll
        for (int k = 1; k < NX; ++k) s = s + B0[k][a] * qa[k];
        S[a * NX + jc] = s;
      }
      T s = A0[0][jc] * h[0];
#pragma unroll
      for (int k = 1; k < NX; ++k) s = s + A0[k][jc] * h[k];
      qb[jc] = xe[jc] + s;
    }
#pragma unroll
    for (int a2 = 0; a2 < NU; ++a2) {
      T qb0[NX];
#pragma unroll
      for (int k = 0; k < NX; ++k) qb0[k] = q1[k] * B0[k][a2];
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        T s = B0[0][a] * qb0[0];
#pragma unroll
        for (int k = 1; k < NX; ++k) s = s + B0[k][a] * qb0[k];
        R[a * NU + a2] = s;
      }
      T s = B0[0][a2] * h[0];
#pragma unroll
      for (int k = 1; k < NX; ++k) s = s + B0[k][a2] * h[k];
      rb[a2] = re[a2] + s;
      rb[NU + a2] = ro[a2];
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

}  // namespace

#define C2_ENTRIES(SUFFIX, T)                                                 \
  extern "C" int condense2_##SUFFIX(                                          \
      const T* A, const T* Bm, const T* c, const T* qxx, const T* qx,         \
      const T* ru, T* Abar, T* Bbar, T* cbar, T* Qbar, T* S1T, T* R00,        \
      T* qbar, T* rbar, int M, int B, void* stream) {                         \
    condense2_kernel<T><<<dim3((B + 127) / 128, M), 128, 0,                   \
                          as_stream(stream)>>>(A, Bm, c, qxx, qx, ru, Abar,   \
                                               Bbar, cbar, Qbar, S1T, R00,    \
                                               qbar, rbar, B);                \
    return static_cast<int>(cudaGetLastError());                              \
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
