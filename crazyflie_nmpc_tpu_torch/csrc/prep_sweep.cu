// RTI preparation without condensing, one launch per step.
//
// Replaces crazyflie_nmpc_tpu/ops/pallas/prep_kernel.py:prep_sweep
// (_prep_kernel with _vde_stage, and with _vde_stage_o2 for vde_order=2:
// ORDER 2 here) and its (bs, 128)-tile variant _prep_sweep_2d, which runs
// the same body with the same device-memory layout.  For each stage k and
// batch lane b: ERK4 propagation, the exact ERK4 matrix VDE sensitivities
// A = dF/dx, B = dF/du from the sparse hand Jacobians (or the order-2
// ones from the midpoint Jacobian), the defect c = F(x_k, u_k) - x_{k+1},
// the diagonal LLS gradients qx = q (x - yref_x), ru = r (u - yref_u) and
// the bound offsets lb = lbu - u, ub = ubu - u.  The stage math is
// prep_stage.cuh's, the same device functions as K1 (prep_condense2.cu).
//
// Design: one thread per (lane, stage); grid (ceil(B/128), N), stages
// independent, B-contiguous loads and stores coalesce across a warp.  Each
// column of A (of B) is a unit vector (a unit input) pushed through the
// four RK4 stages with the sparse Jacobian applied on the fly and written
// out at once, so no 13x13 matrix is ever held in registers.
//
// Bound on the H100: bytes.  Per stage and lane it reads ~50 values and
// writes ~260 (A and B are 221 of them); the ~25k flops of the tangent
// chains are below the fp32 rate's share of that time.
#include "prep_stage.cuh"

using namespace cfl;

namespace {

template <typename T, int ORDER>
__global__ void __launch_bounds__(128)
prep_sweep_kernel(const T* __restrict__ x, const T* __restrict__ u,
                  const T* __restrict__ yref, const T* __restrict__ qd,
                  const T* __restrict__ rd, const T* __restrict__ lbu,
                  const T* __restrict__ ubu, const T* __restrict__ par,
                  T* __restrict__ A, T* __restrict__ Bm, T* __restrict__ c,
                  T* __restrict__ qx, T* __restrict__ ru, T* __restrict__ lb,
                  T* __restrict__ ub, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;  // stage
  if (b >= B) return;
  const Par<T> p = load_par(par, B, b);

  T xk[NX], uk[NU];
  {
    auto xs = lane(x, NX, k, B, b);
    auto us = lane(u, NU, k, B, b);
#pragma unroll
    for (int i = 0; i < NX; ++i) xk[i] = xs[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) uk[i] = us[i];
  }

  T X[4][NX];
  {
    T xn[NX];
    rk4_stages(p, xk, uk, X, xn);
    auto x1 = lane(x, NX, k + 1, B, b);
    auto ck = lane(c, NX, k, B, b);
#pragma unroll
    for (int i = 0; i < NX; ++i) ck[i] = xn[i] - x1[i];
  }
  {
    auto Ak = lane(A, NX * NX, k, B, b);
    T w[NX], col[NX];
#pragma unroll 1
    for (int jc = 0; jc < NX; ++jc) {
#pragma unroll
      for (int i = 0; i < NX; ++i) w[i] = (i == jc) ? T(1) : T(0);
      tangent_x<ORDER>(p, X, w, col);
#pragma unroll
      for (int i = 0; i < NX; ++i) Ak[i * NX + jc] = col[i];
    }
    auto Bk = lane(Bm, NX * NU, k, B, b);
#pragma unroll 1
    for (int jc = 0; jc < NU; ++jc) {
      tangent_u<ORDER>(p, X, uk, jc, col);
#pragma unroll
      for (int i = 0; i < NX; ++i) Bk[i * NU + jc] = col[i];
    }
  }

  auto y = lane(yref, NY, k, B, b);
  auto q = lane(qd, NX, 0, B, b);
  auto qk = lane(qx, NX, k, B, b);
#pragma unroll
  for (int i = 0; i < NX; ++i) qk[i] = q[i] * (xk[i] - y[i]);
  auto r = lane(rd, NU, 0, B, b);
  auto lo = lane(lbu, NU, 0, B, b);
  auto hi = lane(ubu, NU, 0, B, b);
  auto rk = lane(ru, NU, k, B, b);
  auto lk = lane(lb, NU, k, B, b);
  auto hk = lane(ub, NU, k, B, b);
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    rk[i] = r[i] * (uk[i] - y[NX + i]);
    lk[i] = lo[i] - uk[i];
    hk[i] = hi[i] - uk[i];
  }
}

template <typename T, int ORDER>
int launch(const T* x, const T* u, const T* yref, const T* qd, const T* rd,
           const T* lbu, const T* ubu, const T* par, T* A, T* Bm, T* c,
           T* qx, T* ru, T* lb, T* ub, int N, int B, void* stream) {
  const dim3 grid((B + 127) / 128, N);
  prep_sweep_kernel<T, ORDER>
      <<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      x, u, yref, qd, rd, lbu, ubu, par, A, Bm, c, qx, ru, lb, ub, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PREP_SWEEP_ENTRY(NAME, T, ORDER)                                    \
  extern "C" int NAME(const T* x, const T* u, const T* yref, const T* qd,   \
                      const T* rd, const T* lbu, const T* ubu, const T* par,\
                      T* A, T* Bm, T* c, T* qx, T* ru, T* lb, T* ub, int N, \
                      int B, void* stream) {                                \
    return launch<T, ORDER>(x, u, yref, qd, rd, lbu, ubu, par, A, Bm, c,    \
                            qx, ru, lb, ub, N, B, stream);                  \
  }

PREP_SWEEP_ENTRY(prep_sweep_f32, float, 4)
PREP_SWEEP_ENTRY(prep_sweep_f64, double, 4)
// the order-2 VDE sensitivities (vde_order=2)
PREP_SWEEP_ENTRY(prep_sweep_o2_f32, float, 2)
PREP_SWEEP_ENTRY(prep_sweep_o2_f64, double, 2)
