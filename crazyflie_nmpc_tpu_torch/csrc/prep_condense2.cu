// Fused RTI preparation + block-2 partial condensing, one launch per step.
//
// Replaces crazyflie_nmpc_tpu/ops/pallas/prep_kernel.py:prep_condense2
// (_prep_c2_kernel with _vde_stage, _dyn_rows, _jx_entries, _ju_rows,
// _jx_mul; that stage math is prep_stage.cuh's, shared with prep_sweep.cu),
// and its vde_order=2 form (_vde_stage_o2: the same kernel with ORDER 2,
// A and B from the midpoint Jacobian, the state still through ERK4).
// For each stage pair (2j, 2j+1) and batch lane b:
//   ERK4 propagation of both stages, the exact ERK4 matrix VDE
//   sensitivities A, B from the sparse hand Jacobians, the defect c, the
//   diagonal LLS gradients and the bounds, then block-2 condensing:
//     Abar = A1 A0, Bbar = [A1 B0, B1], cbar = A1 c0 + c1,
//     Qbar = A0' q A0 + q, S1T = B0' q A0, R00 = B0' q B0,
//     qbar = qx0 + A0' h, rbar = [ru0 + B0' h, ru1],  h = q c0 + qx1.
//
// Design: one thread per (lane, pair); grid (ceil(B/128), M), B-contiguous
// loads and stores coalesce across a warp.  The Pallas kernel pushed dense
// 13x13 tangent matrices through the RK4 stages; here each column of A
// (and of B) is one directional derivative pushed through the four RK4
// stages with the sparse Jacobian applied on the fly from the stored stage
// states (J(X) v is recomputed per use: ~60 nonzeros, no 169-entry J is
// ever held).  A1 never exists either: Abar's columns are A0's columns
// pushed through the odd stage's tangent chain, which is A1 A0 in exact
// arithmetic; only the rounding differs from the matrix product of the
// plain version (chip_smoke.py holds the two together in float64).
//
// Bound on the H100: bytes.  Per pair and lane it reads ~115 values and
// writes ~810 (the condensed stage and the even-stage Ae/Be for the
// expansion); the ~50k flops of the tangent chains are below the fp32
// rate's share.  A0/B0 (221 values) are held per thread for the cost
// products and spill to local memory (L1); `ptxas -v` in the build log
// gives the counts.  Making this fast is later work.
#include "prep_stage.cuh"

using namespace cfl;

namespace {

template <typename T, int ORDER>
__global__ void __launch_bounds__(128)
prep_condense2_kernel(const T* __restrict__ x, const T* __restrict__ u,
                      const T* __restrict__ yref, const T* __restrict__ qd_,
                      const T* __restrict__ rd_, const T* __restrict__ lbu_,
                      const T* __restrict__ ubu_, const T* __restrict__ par,
                      T* __restrict__ Abar, T* __restrict__ Bbar,
                      T* __restrict__ cbar, T* __restrict__ Qbar,
                      T* __restrict__ S1T, T* __restrict__ R00,
                      T* __restrict__ qbar, T* __restrict__ rbar,
                      T* __restrict__ Ae, T* __restrict__ Be,
                      T* __restrict__ c, T* __restrict__ lb,
                      T* __restrict__ ub, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;  // stage pair
  if (b >= B) return;
  const int e = 2 * j, o = 2 * j + 1;

  const Par<T> p = load_par(par, B, b);
  T qd[NX], rd[NU], lbu[NU], ubu[NU];
  {
    auto q = lane(qd_, NX, 0, B, b);
#pragma unroll
    for (int i = 0; i < NX; ++i) qd[i] = q[i];
    auto r = lane(rd_, NU, 0, B, b);
    auto lo = lane(lbu_, NU, 0, B, b);
    auto hi = lane(ubu_, NU, 0, B, b);
#pragma unroll
    for (int i = 0; i < NU; ++i) { rd[i] = r[i]; lbu[i] = lo[i]; ubu[i] = hi[i]; }
  }

  T xe[NX], xo[NX], xoo[NX], ue[NU], uo[NU];
  {
    auto a = lane(x, NX, e, B, b), a1 = lane(x, NX, o, B, b);
    auto a2 = lane(x, NX, o + 1, B, b);
#pragma unroll
    for (int i = 0; i < NX; ++i) { xe[i] = a[i]; xo[i] = a1[i]; xoo[i] = a2[i]; }
    auto v = lane(u, NU, e, B, b), v1 = lane(u, NU, o, B, b);
#pragma unroll
    for (int i = 0; i < NU; ++i) { ue[i] = v[i]; uo[i] = v1[i]; }
  }

  // even stage: defect, then A0 and B0 column by column (kept for the
  // cost products below)
  T c0[NX], c1[NX], A0[NX][NX], B0[NX][NU];
  {
    T X[4][NX], xn[NX];
    rk4_stages(p, xe, ue, X, xn);
    auto ce = lane(c, NX, e, B, b);
#pragma unroll
    for (int i = 0; i < NX; ++i) { c0[i] = xn[i] - xo[i]; ce[i] = c0[i]; }
    auto Ael = lane(Ae, NX * NX, j, B, b);
    auto Bel = lane(Be, NX * NU, j, B, b);
    T w[NX], col[NX];
#pragma unroll 1
    for (int jc = 0; jc < NX; ++jc) {
#pragma unroll
      for (int i = 0; i < NX; ++i) w[i] = (i == jc) ? T(1) : T(0);
      tangent_x<ORDER>(p, X, w, col);
#pragma unroll
      for (int i = 0; i < NX; ++i) { A0[i][jc] = col[i]; Ael[i * NX + jc] = col[i]; }
    }
#pragma unroll 1
    for (int jc = 0; jc < NU; ++jc) {
      tangent_u<ORDER>(p, X, ue, jc, col);
#pragma unroll
      for (int i = 0; i < NX; ++i) { B0[i][jc] = col[i]; Bel[i * NU + jc] = col[i]; }
    }
  }

  // linear cost terms and bounds of both stages
  T qx0[NX], h[NX], ru0[NU], ru1[NU];
  {
    auto ye = lane(yref, NY, e, B, b), yo = lane(yref, NY, o, B, b);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      ru0[i] = rd[i] * (ue[i] - ye[NX + i]);
      ru1[i] = rd[i] * (uo[i] - yo[NX + i]);
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      qx0[i] = qd[i] * (xe[i] - ye[i]);
      h[i] = qd[i] * c0[i] + qd[i] * (xo[i] - yo[i]);  // q c0 + qx1
    }
    auto lbe = lane(lb, NU, e, B, b), lbo = lane(lb, NU, o, B, b);
    auto ube = lane(ub, NU, e, B, b), ubo = lane(ub, NU, o, B, b);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      lbe[i] = lbu[i] - ue[i]; lbo[i] = lbu[i] - uo[i];
      ube[i] = ubu[i] - ue[i]; ubo[i] = ubu[i] - uo[i];
    }
  }

  // odd stage: condensed dynamics through its tangent chain
  {
    T X[4][NX], xn[NX];
    rk4_stages(p, xo, uo, X, xn);
    auto co = lane(c, NX, o, B, b);
    auto cb = lane(cbar, NX, j, B, b);
    auto Ab = lane(Abar, NX * NX, j, B, b);
    auto Bb = lane(Bbar, NX * NUC, j, B, b);
    T w[NX], col[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) { c1[i] = xn[i] - xoo[i]; co[i] = c1[i]; }
    tangent_x<ORDER>(p, X, c0, col);
#pragma unroll
    for (int i = 0; i < NX; ++i) cb[i] = col[i] + c1[i];
#pragma unroll 1
    for (int jc = 0; jc < NX; ++jc) {
#pragma unroll
      for (int i = 0; i < NX; ++i) w[i] = A0[i][jc];
      tangent_x<ORDER>(p, X, w, col);
#pragma unroll
      for (int i = 0; i < NX; ++i) Ab[i * NX + jc] = col[i];
    }
#pragma unroll 1
    for (int jc = 0; jc < NU; ++jc) {
#pragma unroll
      for (int i = 0; i < NX; ++i) w[i] = B0[i][jc];
      tangent_x<ORDER>(p, X, w, col);
#pragma unroll
      for (int i = 0; i < NX; ++i) Bb[i * NUC + jc] = col[i];
      tangent_u<ORDER>(p, X, uo, jc, col);
#pragma unroll
      for (int i = 0; i < NX; ++i) Bb[i * NUC + NU + jc] = col[i];
    }
  }

  // condensed cost (diagonal stage cost q of the eliminated state)
  {
    auto Qb = lane(Qbar, NX * NX, j, B, b);
    auto S = lane(S1T, NU * NX, j, B, b);
    auto R = lane(R00, NU * NU, j, B, b);
    auto qb = lane(qbar, NX, j, B, b);
    auto rb = lane(rbar, NUC, j, B, b);
#pragma unroll 1
    for (int jc = 0; jc < NX; ++jc) {
      T qa[NX];
#pragma unroll
      for (int k = 0; k < NX; ++k) qa[k] = qd[k] * A0[k][jc];
#pragma unroll 1
      for (int i = 0; i < NX; ++i) {
        T s = A0[0][i] * qa[0];
#pragma unroll
        for (int k = 1; k < NX; ++k) s = s + A0[k][i] * qa[k];
        Qb[i * NX + jc] = (i == jc) ? s + qd[i] : s;
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T s = B0[0][i] * qa[0];
#pragma unroll
        for (int k = 1; k < NX; ++k) s = s + B0[k][i] * qa[k];
        S[i * NX + jc] = s;
      }
      T s = A0[0][jc] * h[0];
#pragma unroll
      for (int k = 1; k < NX; ++k) s = s + A0[k][jc] * h[k];
      qb[jc] = qx0[jc] + s;
    }
#pragma unroll
    for (int jc = 0; jc < NU; ++jc) {
      T qb0[NX];
#pragma unroll
      for (int k = 0; k < NX; ++k) qb0[k] = qd[k] * B0[k][jc];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T s = B0[0][i] * qb0[0];
#pragma unroll
        for (int k = 1; k < NX; ++k) s = s + B0[k][i] * qb0[k];
        R[i * NU + jc] = s;
      }
      T s = B0[0][jc] * h[0];
#pragma unroll
      for (int k = 1; k < NX; ++k) s = s + B0[k][jc] * h[k];
      rb[jc] = ru0[jc] + s;
      rb[NU + jc] = ru1[jc];
    }
  }
}

template <typename T, int ORDER>
int launch(const T* x, const T* u, const T* yref, const T* qd, const T* rd,
           const T* lbu, const T* ubu, const T* par, T* Abar, T* Bbar,
           T* cbar, T* Qbar, T* S1T, T* R00, T* qbar, T* rbar, T* Ae, T* Be,
           T* c, T* lb, T* ub, int M, int B, void* stream) {
  const dim3 grid((B + 127) / 128, M);
  prep_condense2_kernel<T, ORDER>
      <<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      x, u, yref, qd, rd, lbu, ubu, par, Abar, Bbar, cbar, Qbar, S1T, R00,
      qbar, rbar, Ae, Be, c, lb, ub, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PREP_ENTRY(NAME, T, ORDER)                                           \
  extern "C" int NAME(const T* x, const T* u, const T* yref, const T* qd,    \
                      const T* rd, const T* lbu, const T* ubu, const T* par, \
                      T* Abar, T* Bbar, T* cbar, T* Qbar, T* S1T, T* R00,    \
                      T* qbar, T* rbar, T* Ae, T* Be, T* c, T* lb, T* ub,    \
                      int M, int B, void* stream) {                          \
    return launch<T, ORDER>(x, u, yref, qd, rd, lbu, ubu, par, Abar, Bbar,   \
                            cbar, Qbar, S1T, R00, qbar, rbar, Ae, Be, c, lb, \
                            ub, M, B, stream);                               \
  }

PREP_ENTRY(prep_condense2_f32, float, 4)
PREP_ENTRY(prep_condense2_f64, double, 4)
// the order-2 VDE sensitivities (vde_order=2)
PREP_ENTRY(prep_condense2_o2_f32, float, 2)
PREP_ENTRY(prep_condense2_o2_f64, double, 2)
