// Fused RTI preparation + block-2 partial condensing, one launch per step.
//
// Replaces crazyflie_nmpc_tpu/ops/pallas/prep_kernel.py:prep_condense2
// (_prep_c2_kernel with _vde_stage, _dyn_rows, _jx_entries, _ju_rows,
// _jx_mul).  For each stage pair (2j, 2j+1) and batch lane b:
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
#include "batch_last.cuh"

using namespace cfl;

namespace {

template <typename T>
struct Par {
  T g0, mq, Ixx, Iyy, Izz, Cd, Ct, l, dt;
  T imq, iIxx, iIyy, iIzz;  // hoisted reciprocals (prep_kernel._pinv)
};

// xdot = f(x, u): the 13 channels of prep_kernel._dyn_rows.
template <typename T>
__device__ __forceinline__ void dyn(const Par<T>& p, const T* x, const T* u,
                                    T* f) {
  const T q1 = x[3], q2 = x[4], q3 = x[5], q4 = x[6];
  const T vbx = x[7], vby = x[8], vbz = x[9];
  const T wx = x[10], wy = x[11], wz = x[12];
  const T w1 = u[0], w2 = u[1], w3 = u[2], w4 = u[3];
  const T g0 = p.g0, Ixx = p.Ixx, Iyy = p.Iyy, Izz = p.Izz;
  const T Cd = p.Cd, Ct = p.Ct, l = p.l;
  f[0] = (vbx * (2 * q1 * q1 + 2 * q2 * q2 - 1)
          - vby * (2 * q1 * q4 - 2 * q2 * q3)
          + vbz * (2 * q1 * q3 + 2 * q2 * q4));
  f[1] = (vby * (2 * q1 * q1 + 2 * q3 * q3 - 1)
          + vbx * (2 * q1 * q4 + 2 * q2 * q3)
          - vbz * (2 * q1 * q2 - 2 * q3 * q4));
  f[2] = (vbz * (2 * q1 * q1 + 2 * q4 * q4 - 1)
          - vbx * (2 * q1 * q3 - 2 * q2 * q4)
          + vby * (2 * q1 * q2 + 2 * q3 * q4));
  f[3] = -(q2 * wx) / 2 - (q3 * wy) / 2 - (q4 * wz) / 2;
  f[4] = (q1 * wx) / 2 - (q4 * wy) / 2 + (q3 * wz) / 2;
  f[5] = (q4 * wx) / 2 + (q1 * wy) / 2 - (q2 * wz) / 2;
  f[6] = (q2 * wy) / 2 - (q3 * wx) / 2 + (q1 * wz) / 2;
  const T thrust = (Ct * (w1 * w1 + w2 * w2 + w3 * w3 + w4 * w4)) * p.imq;
  f[7] = vby * wz - vbz * wy + g0 * (2 * q1 * q3 - 2 * q2 * q4);
  f[8] = vbz * wx - vbx * wz - g0 * (2 * q1 * q2 + 2 * q3 * q4);
  f[9] = (vbx * wy - vby * wx - g0 * (2 * q1 * q1 + 2 * q4 * q4 - 1)
          + thrust);
  f[10] = -(Ct * l * (w1 * w1 + w2 * w2 - w3 * w3 - w4 * w4)
            - Iyy * wy * wz + Izz * wy * wz) * p.iIxx;
  f[11] = -(Ct * l * (w1 * w1 - w2 * w2 - w3 * w3 + w4 * w4)
            + Ixx * wx * wz - Izz * wx * wz) * p.iIyy;
  f[12] = -(Cd * (w1 * w1 - w2 * w2 + w3 * w3 - w4 * w4)
            - Ixx * wx * wy + Iyy * wx * wy) * p.iIzz;
}

// out = J(x) v with J = df/dx in the sparse form of
// prep_kernel._jx_entries (entries of a row summed in column order).
template <typename T>
__device__ __forceinline__ void jx_mul(const Par<T>& p, const T* x,
                                       const T* v, T* out) {
  const T q1 = x[3], q2 = x[4], q3 = x[5], q4 = x[6];
  const T vbx = x[7], vby = x[8], vbz = x[9];
  const T wx = x[10], wy = x[11], wz = x[12];
  const T g0 = p.g0;
  out[0] = ((4 * q1 * vbx - 2 * q4 * vby + 2 * q3 * vbz) * v[3]
            + (4 * q2 * vbx + 2 * q3 * vby + 2 * q4 * vbz) * v[4]
            + (2 * q2 * vby + 2 * q1 * vbz) * v[5]
            + (-2 * q1 * vby + 2 * q2 * vbz) * v[6]
            + (2 * q1 * q1 + 2 * q2 * q2 - 1) * v[7]
            + (-(2 * q1 * q4 - 2 * q2 * q3)) * v[8]
            + (2 * q1 * q3 + 2 * q2 * q4) * v[9]);
  out[1] = ((4 * q1 * vby + 2 * q4 * vbx - 2 * q2 * vbz) * v[3]
            + (2 * q3 * vbx - 2 * q1 * vbz) * v[4]
            + (4 * q3 * vby + 2 * q2 * vbx + 2 * q4 * vbz) * v[5]
            + (2 * q1 * vbx + 2 * q3 * vbz) * v[6]
            + (2 * q1 * q4 + 2 * q2 * q3) * v[7]
            + (2 * q1 * q1 + 2 * q3 * q3 - 1) * v[8]
            + (-(2 * q1 * q2 - 2 * q3 * q4)) * v[9]);
  out[2] = ((4 * q1 * vbz - 2 * q3 * vbx + 2 * q2 * vby) * v[3]
            + (2 * q4 * vbx + 2 * q1 * vby) * v[4]
            + (-2 * q1 * vbx + 2 * q4 * vby) * v[5]
            + (4 * q4 * vbz + 2 * q2 * vbx + 2 * q3 * vby) * v[6]
            + (-(2 * q1 * q3 - 2 * q2 * q4)) * v[7]
            + (2 * q1 * q2 + 2 * q3 * q4) * v[8]
            + (2 * q1 * q1 + 2 * q4 * q4 - 1) * v[9]);
  out[3] = ((-wx / 2) * v[4] + (-wy / 2) * v[5] + (-wz / 2) * v[6]
            + (-q2 / 2) * v[10] + (-q3 / 2) * v[11] + (-q4 / 2) * v[12]);
  out[4] = ((wx / 2) * v[3] + (wz / 2) * v[5] + (-wy / 2) * v[6]
            + (q1 / 2) * v[10] + (-q4 / 2) * v[11] + (q3 / 2) * v[12]);
  out[5] = ((wy / 2) * v[3] + (-wz / 2) * v[4] + (wx / 2) * v[6]
            + (q4 / 2) * v[10] + (q1 / 2) * v[11] + (-q2 / 2) * v[12]);
  out[6] = ((wz / 2) * v[3] + (wy / 2) * v[4] + (-wx / 2) * v[5]
            + (-q3 / 2) * v[10] + (q2 / 2) * v[11] + (q1 / 2) * v[12]);
  out[7] = ((2 * g0 * q3) * v[3] + (-2 * g0 * q4) * v[4]
            + (2 * g0 * q1) * v[5] + (-2 * g0 * q2) * v[6]
            + wz * v[8] + (-wy) * v[9] + (-vbz) * v[11] + vby * v[12]);
  out[8] = ((-2 * g0 * q2) * v[3] + (-2 * g0 * q1) * v[4]
            + (-2 * g0 * q4) * v[5] + (-2 * g0 * q3) * v[6]
            + (-wz) * v[7] + wx * v[9] + vbz * v[10] + (-vbx) * v[12]);
  out[9] = ((-4 * g0 * q1) * v[3] + (-4 * g0 * q4) * v[6]
            + wy * v[7] + (-wx) * v[8] + (-vby) * v[10] + vbx * v[11]);
  out[10] = (((p.Iyy - p.Izz) * wz * p.iIxx) * v[11]
             + ((p.Iyy - p.Izz) * wy * p.iIxx) * v[12]);
  out[11] = (((p.Izz - p.Ixx) * wz * p.iIyy) * v[10]
             + ((p.Izz - p.Ixx) * wx * p.iIyy) * v[12]);
  out[12] = (((p.Ixx - p.Iyy) * wy * p.iIzz) * v[10]
             + ((p.Ixx - p.Iyy) * wx * p.iIzz) * v[11]);
}

// RK4 stage states X1..X4 of one shooting interval and its end state.
template <typename T>
__device__ __forceinline__ void rk4_stages(const Par<T>& p, const T* x,
                                           const T* u, T (&X)[4][NX],
                                           T* x_next) {
  T k1[NX], k2[NX], k3[NX], k4[NX];
  const T h = T(0.5) * p.dt;
#pragma unroll
  for (int i = 0; i < NX; ++i) X[0][i] = x[i];
  dyn(p, X[0], u, k1);
#pragma unroll
  for (int i = 0; i < NX; ++i) X[1][i] = x[i] + h * k1[i];
  dyn(p, X[1], u, k2);
#pragma unroll
  for (int i = 0; i < NX; ++i) X[2][i] = x[i] + h * k2[i];
  dyn(p, X[2], u, k3);
#pragma unroll
  for (int i = 0; i < NX; ++i) X[3][i] = x[i] + p.dt * k3[i];
  dyn(p, X[3], u, k4);
  const T d6 = p.dt / T(6);
#pragma unroll
  for (int i = 0; i < NX; ++i)
    x_next[i] = x[i] + d6 * (k1[i] + 2 * k2[i] + 2 * k3[i] + k4[i]);
}

// out = A w for the interval's A = dF/dx: w pushed through the RK4 tangent
// chain m_i = J(X_i) (w + c_i dt m_{i-1}).
template <typename T>
__device__ __forceinline__ void tangent_x(const Par<T>& p,
                                          const T (&X)[4][NX], const T* w,
                                          T* out) {
  T m1[NX], m2[NX], m3[NX], m4[NX], v[NX];
  const T h = T(0.5) * p.dt;
  jx_mul(p, X[0], w, m1);
#pragma unroll
  for (int i = 0; i < NX; ++i) v[i] = w[i] + h * m1[i];
  jx_mul(p, X[1], v, m2);
#pragma unroll
  for (int i = 0; i < NX; ++i) v[i] = w[i] + h * m2[i];
  jx_mul(p, X[2], v, m3);
#pragma unroll
  for (int i = 0; i < NX; ++i) v[i] = w[i] + p.dt * m3[i];
  jx_mul(p, X[3], v, m4);
  const T d6 = p.dt / T(6);
#pragma unroll
  for (int i = 0; i < NX; ++i)
    out[i] = w[i] + d6 * (m1[i] + 2 * m2[i] + 2 * m3[i] + m4[i]);
}

// out = column `col` of B = dF/du: M_1 = G e_col,
// M_i = G e_col + J(X_i) (c_i dt M_{i-1}) (prep_kernel._vde_stage).
template <typename T>
__device__ __forceinline__ void tangent_u(const Par<T>& p,
                                          const T (&X)[4][NX], const T* u,
                                          int col, T* out) {
  // column `col` of G = df/du (prep_kernel._ju_rows): rows 9..12 only
  const T tcm = 2 * p.Ct * p.imq;
  const T tlx = 2 * p.Ct * p.l * p.iIxx;
  const T tly = 2 * p.Ct * p.l * p.iIyy;
  const T tdz = 2 * p.Cd * p.iIzz;
  const T w = u[col];
  T g[NX];
#pragma unroll
  for (int i = 0; i < 9; ++i) g[i] = T(0);
  g[9] = tcm * w;
  g[10] = (col < 2 ? -tlx : tlx) * w;
  g[11] = (col == 0 || col == 3 ? -tly : tly) * w;
  g[12] = (col % 2 == 0 ? -tdz : tdz) * w;

  T m1[NX], m2[NX], m3[NX], m4[NX], v[NX], jv[NX];
  const T h = T(0.5) * p.dt;
#pragma unroll
  for (int i = 0; i < NX; ++i) { m1[i] = g[i]; v[i] = h * m1[i]; }
  jx_mul(p, X[1], v, jv);
#pragma unroll
  for (int i = 0; i < NX; ++i) { m2[i] = g[i] + jv[i]; v[i] = h * m2[i]; }
  jx_mul(p, X[2], v, jv);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    m3[i] = g[i] + jv[i];
    v[i] = p.dt * m3[i];
  }
  jx_mul(p, X[3], v, jv);
#pragma unroll
  for (int i = 0; i < NX; ++i) m4[i] = g[i] + jv[i];
  const T d6 = p.dt / T(6);
#pragma unroll
  for (int i = 0; i < NX; ++i)
    out[i] = d6 * (m1[i] + 2 * m2[i] + 2 * m3[i] + m4[i]);
}

template <typename T>
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

  Par<T> p;
  {
    auto pl = lane(par, NPARAM, 0, B, b);
    p.g0 = pl[0]; p.mq = pl[1]; p.Ixx = pl[2]; p.Iyy = pl[3];
    p.Izz = pl[4]; p.Cd = pl[5]; p.Ct = pl[6]; p.l = pl[7]; p.dt = pl[8];
    p.imq = T(1) / p.mq; p.iIxx = T(1) / p.Ixx;
    p.iIyy = T(1) / p.Iyy; p.iIzz = T(1) / p.Izz;
  }
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
      tangent_x(p, X, w, col);
#pragma unroll
      for (int i = 0; i < NX; ++i) { A0[i][jc] = col[i]; Ael[i * NX + jc] = col[i]; }
    }
#pragma unroll 1
    for (int jc = 0; jc < NU; ++jc) {
      tangent_u(p, X, ue, jc, col);
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
    tangent_x(p, X, c0, col);
#pragma unroll
    for (int i = 0; i < NX; ++i) cb[i] = col[i] + c1[i];
#pragma unroll 1
    for (int jc = 0; jc < NX; ++jc) {
#pragma unroll
      for (int i = 0; i < NX; ++i) w[i] = A0[i][jc];
      tangent_x(p, X, w, col);
#pragma unroll
      for (int i = 0; i < NX; ++i) Ab[i * NX + jc] = col[i];
    }
#pragma unroll 1
    for (int jc = 0; jc < NU; ++jc) {
#pragma unroll
      for (int i = 0; i < NX; ++i) w[i] = B0[i][jc];
      tangent_x(p, X, w, col);
#pragma unroll
      for (int i = 0; i < NX; ++i) Bb[i * NUC + jc] = col[i];
      tangent_u(p, X, uo, jc, col);
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

template <typename T>
int launch(const T* x, const T* u, const T* yref, const T* qd, const T* rd,
           const T* lbu, const T* ubu, const T* par, T* Abar, T* Bbar,
           T* cbar, T* Qbar, T* S1T, T* R00, T* qbar, T* rbar, T* Ae, T* Be,
           T* c, T* lb, T* ub, int M, int B, void* stream) {
  const dim3 grid((B + 127) / 128, M);
  prep_condense2_kernel<T><<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      x, u, yref, qd, rd, lbu, ubu, par, Abar, Bbar, cbar, Qbar, S1T, R00,
      qbar, rbar, Ae, Be, c, lb, ub, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PREP_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const T* x, const T* u, const T* yref, const T* qd,    \
                      const T* rd, const T* lbu, const T* ubu, const T* par, \
                      T* Abar, T* Bbar, T* cbar, T* Qbar, T* S1T, T* R00,    \
                      T* qbar, T* rbar, T* Ae, T* Be, T* c, T* lb, T* ub,    \
                      int M, int B, void* stream) {                          \
    return launch<T>(x, u, yref, qd, rd, lbu, ubu, par, Abar, Bbar, cbar,    \
                     Qbar, S1T, R00, qbar, rbar, Ae, Be, c, lb, ub, M, B,    \
                     stream);                                                \
  }

PREP_ENTRY(prep_condense2_f32, float)
PREP_ENTRY(prep_condense2_f64, double)
