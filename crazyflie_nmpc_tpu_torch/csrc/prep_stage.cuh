// Stage math of the RTI preparation, shared by the fused prep + condense
// launch (prep_condense2.cu, K1) and the preparation without condensing
// (prep_sweep.cu, K7).  K1 applies the Jacobian through jac_build /
// jac_apply, K7 through jx_mul.
//
// Counterparts of crazyflie_nmpc_tpu/ops/pallas/prep_kernel.py's
// _dyn_rows, _jx_entries/_jx_mul, _ju_rows, _vde_stage and _vde_stage_o2,
// for one batch lane held by one thread: the quadrotor ODE, its sparse
// Jacobian applied to a vector, the four RK4 stage states of one shooting
// interval, and the columns of A = dF/dx and B = dF/du, either pushed
// through the RK4 tangent chain (ORDER 4: the exact ERK4 matrix VDE) or
// from the midpoint Jacobian alone (ORDER 2: the order-2 sensitivities).
#pragma once

#include "batch_last.cuh"

namespace cfl {

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

// K1's form of the same Jacobian: NJC entries built once at a state
// (jac_build) and applied to many vectors (jac_apply); K7 keeps jx_mul.
// Stored: JC_C the 12 attitude-velocity terms of rows 0-2 (row-major,
// columns 3-6), JC_R the rotation R of rows 0-2 (columns 7-9), and the
// state's q, w and body velocity; jac_apply forms the rest from these in
// registers (q/2, w/2, 2 g0 q, the gyroscopic terms), each entry and each
// row's sum as jx_mul evaluates them (the halves are exact, and -4 g0 q is
// -2 times 2 g0 q exactly).
enum : int { JC_C = 0, JC_R = 12, JC_Q = 21, JC_W = 25, JC_V = 28, NJC = 32 };

template <typename T>
__device__ __forceinline__ void jac_build(const T* x, T* c) {
  const T q1 = x[3], q2 = x[4], q3 = x[5], q4 = x[6];
  const T vbx = x[7], vby = x[8], vbz = x[9];
  c[JC_C + 0] = 4 * q1 * vbx - 2 * q4 * vby + 2 * q3 * vbz;
  c[JC_C + 1] = 4 * q2 * vbx + 2 * q3 * vby + 2 * q4 * vbz;
  c[JC_C + 2] = 2 * q2 * vby + 2 * q1 * vbz;
  c[JC_C + 3] = -2 * q1 * vby + 2 * q2 * vbz;
  c[JC_C + 4] = 4 * q1 * vby + 2 * q4 * vbx - 2 * q2 * vbz;
  c[JC_C + 5] = 2 * q3 * vbx - 2 * q1 * vbz;
  c[JC_C + 6] = 4 * q3 * vby + 2 * q2 * vbx + 2 * q4 * vbz;
  c[JC_C + 7] = 2 * q1 * vbx + 2 * q3 * vbz;
  c[JC_C + 8] = 4 * q1 * vbz - 2 * q3 * vbx + 2 * q2 * vby;
  c[JC_C + 9] = 2 * q4 * vbx + 2 * q1 * vby;
  c[JC_C + 10] = -2 * q1 * vbx + 2 * q4 * vby;
  c[JC_C + 11] = 4 * q4 * vbz + 2 * q2 * vbx + 2 * q3 * vby;
  c[JC_R + 0] = 2 * q1 * q1 + 2 * q2 * q2 - 1;
  c[JC_R + 1] = -(2 * q1 * q4 - 2 * q2 * q3);
  c[JC_R + 2] = 2 * q1 * q3 + 2 * q2 * q4;
  c[JC_R + 3] = 2 * q1 * q4 + 2 * q2 * q3;
  c[JC_R + 4] = 2 * q1 * q1 + 2 * q3 * q3 - 1;
  c[JC_R + 5] = -(2 * q1 * q2 - 2 * q3 * q4);
  c[JC_R + 6] = -(2 * q1 * q3 - 2 * q2 * q4);
  c[JC_R + 7] = 2 * q1 * q2 + 2 * q3 * q4;
  c[JC_R + 8] = 2 * q1 * q1 + 2 * q4 * q4 - 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) c[JC_Q + i] = x[3 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    c[JC_W + i] = x[10 + i];
    c[JC_V + i] = x[7 + i];
  }
  c[NJC - 1] = T(0);  // pads the entries to whole 16-byte packs
}

// out = J v from jac_build's entries (rows summed as jx_mul sums them).
template <typename T>
__device__ __forceinline__ void jac_apply(const Par<T>& p, const T* c,
                                          const T* v, T* out) {
  const T* cc = c + JC_C;
  const T* R = c + JC_R;
  const T q1 = c[JC_Q], q2 = c[JC_Q + 1], q3 = c[JC_Q + 2],
          q4 = c[JC_Q + 3];
  const T wx = c[JC_W], wy = c[JC_W + 1], wz = c[JC_W + 2];
  const T vbx = c[JC_V], vby = c[JC_V + 1], vbz = c[JC_V + 2];
  const T p1 = q1 / 2, p2 = q2 / 2, p3 = q3 / 2, p4 = q4 / 2;
  const T hx = wx / 2, hy = wy / 2, hz = wz / 2;
  const T g0 = p.g0;
  const T g1 = 2 * g0 * q1, g2 = 2 * g0 * q2, g3 = 2 * g0 * q3,
          g4 = 2 * g0 * q4;
#pragma unroll
  for (int r = 0; r < 3; ++r)
    out[r] = (cc[4 * r] * v[3] + cc[4 * r + 1] * v[4]
              + cc[4 * r + 2] * v[5] + cc[4 * r + 3] * v[6]
              + R[3 * r] * v[7] + R[3 * r + 1] * v[8] + R[3 * r + 2] * v[9]);
  out[3] = ((-hx) * v[4] + (-hy) * v[5] + (-hz) * v[6]
            + (-p2) * v[10] + (-p3) * v[11] + (-p4) * v[12]);
  out[4] = (hx * v[3] + hz * v[5] + (-hy) * v[6]
            + p1 * v[10] + (-p4) * v[11] + p3 * v[12]);
  out[5] = (hy * v[3] + (-hz) * v[4] + hx * v[6]
            + p4 * v[10] + p1 * v[11] + (-p2) * v[12]);
  out[6] = (hz * v[3] + hy * v[4] + (-hx) * v[5]
            + (-p3) * v[10] + p2 * v[11] + p1 * v[12]);
  out[7] = (g3 * v[3] + (-g4) * v[4] + g1 * v[5] + (-g2) * v[6]
            + wz * v[8] + (-wy) * v[9] + (-vbz) * v[11] + vby * v[12]);
  out[8] = ((-g2) * v[3] + (-g1) * v[4] + (-g4) * v[5] + (-g3) * v[6]
            + (-wz) * v[7] + wx * v[9] + vbz * v[10] + (-vbx) * v[12]);
  out[9] = ((-2 * g1) * v[3] + (-2 * g4) * v[6]
            + wy * v[7] + (-wx) * v[8] + (-vby) * v[10] + vbx * v[11]);
  out[10] = (((p.Iyy - p.Izz) * wz * p.iIxx) * v[11]
             + ((p.Iyy - p.Izz) * wy * p.iIxx) * v[12]);
  out[11] = (((p.Izz - p.Ixx) * wz * p.iIyy) * v[10]
             + ((p.Izz - p.Ixx) * wx * p.iIyy) * v[12]);
  out[12] = (((p.Ixx - p.Iyy) * wy * p.iIzz) * v[10]
             + ((p.Ixx - p.Iyy) * wx * p.iIzz) * v[11]);
}

// Column `col` of G = df/du (prep_kernel._ju_rows): rows 9..12 only; u
// the input `col` of the interval.
template <typename T>
__device__ __forceinline__ void ju_col(const Par<T>& p, T u, int col, T* g) {
  const T tcm = 2 * p.Ct * p.imq;
  const T tlx = 2 * p.Ct * p.l * p.iIxx;
  const T tly = 2 * p.Ct * p.l * p.iIyy;
  const T tdz = 2 * p.Cd * p.iIzz;
#pragma unroll
  for (int i = 0; i < 9; ++i) g[i] = T(0);
  g[9] = tcm * u;
  g[10] = (col < 2 ? -tlx : tlx) * u;
  g[11] = (col == 0 || col == 3 ? -tly : tly) * u;
  g[12] = (col % 2 == 0 ? -tdz : tdz) * u;
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

// out = A w for the interval's A = dF/dx.  ORDER 4: w pushed through the
// RK4 tangent chain m_i = J(X_i) (w + c_i dt m_{i-1}).  ORDER 2: the
// midpoint expansion A = I + dt J + dt^2/2 J J with J = J(X_2), the
// Jacobian at the RK4 midpoint state x + dt/2 k1 (_vde_stage_o2).
template <int ORDER = 4, typename T>
__device__ __forceinline__ void tangent_x(const Par<T>& p,
                                          const T (&X)[4][NX], const T* w,
                                          T* out) {
  if constexpr (ORDER == 2) {
    T j1[NX], j2[NX];
    jx_mul(p, X[1], w, j1);
    jx_mul(p, X[1], j1, j2);
    const T h2 = p.dt * p.dt / T(2);
#pragma unroll
    for (int i = 0; i < NX; ++i) out[i] = w[i] + p.dt * j1[i] + h2 * j2[i];
    return;
  }
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

// out = column `col` of B = dF/du.  ORDER 4: M_1 = G e_col,
// M_i = G e_col + J(X_i) (c_i dt M_{i-1}) (prep_kernel._vde_stage).
// ORDER 2: B = dt (G + dt/2 J G) with J = J(X_2) (_vde_stage_o2).
template <int ORDER = 4, typename T>
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

  if constexpr (ORDER == 2) {
    T jg[NX];
    jx_mul(p, X[1], g, jg);
    const T h = p.dt / T(2);
#pragma unroll
    for (int i = 0; i < NX; ++i) out[i] = p.dt * (g[i] + h * jg[i]);
    return;
  }
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

// The lane's physical parameters from the (9, B) tile, reciprocals hoisted.
template <typename T>
__device__ __forceinline__ Par<T> load_par(const T* par, int B, int b) {
  Par<T> p;
  auto pl = lane(par, NPARAM, 0, B, b);
  p.g0 = pl[0]; p.mq = pl[1]; p.Ixx = pl[2]; p.Iyy = pl[3];
  p.Izz = pl[4]; p.Cd = pl[5]; p.Ct = pl[6]; p.l = pl[7]; p.dt = pl[8];
  p.imq = T(1) / p.mq; p.iIxx = T(1) / p.Ixx;
  p.iIyy = T(1) / p.Iyy; p.iIzz = T(1) / p.Izz;
  return p;
}

}  // namespace cfl
