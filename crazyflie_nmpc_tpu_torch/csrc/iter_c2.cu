// One whole Mehrotra interior-point iteration on the block-2 condensed QP
// in one launch.
//
// Replaces iter_sweep_c2 (_iter_c2_kernel) of
// crazyflie_nmpc_tpu/ops/pallas/condensed_kernels.py.  One thread owns one
// batch lane and runs the Pallas kernel's five grid phases in order over
// the M condensed stages:
//   0 backward-affine     barrier shift and affine right-hand side from
//                         the carried slacks/duals, the Riccati
//                         factorization (c2_stage.cuh factor_stage)
//   1 forward-affine      du_aff rollout, slack/dual directions, the
//                         fraction-to-boundary minimum and the mu_aff sums
//                         S0/S1/S2 -> sigma*mu
//   2 backward-corrector  Mehrotra-corrected right-hand side from the stored
//                         du_aff, vector pass on the stored factorization
//   3 forward-corrector   du rollout, final directions, the step length
//                         alpha (tau, mu-floor guard)
//   4 update              z, s, lam += alpha d; residuals *= (1 - alpha)
// Every reduction of the Pallas kernel runs over one lane's stages and
// inputs, so each is a thread-local accumulator here, summed in the Pallas
// kernel's order (S0 in backward stage order, S1/S2 in forward order).
//
// The whole-horizon VMEM scratch (K, kff, L, Pc, du_aff, du, ddx) is
// device-memory scratch the wrapper allocates once per solve; the same
// thread writes and reads it back, mostly from L2.  The Pallas kernel's
// input_output_aliases become in-place updates: the carried arrays
// (z_dx, z_du, s_l, s_u, lam_l, lam_u, qx, r1u, c_res, r3, r4, r1x_T,
// dx0_res, z_dxT) are read in phases 0-3 and rewritten, stage by stage,
// in phase 4.
//
// Bounds on the H100: the kernel reads the condensed QP data once per
// phase that needs it and does K2's + K3's arithmetic plus ~40 flops per
// (stage, input) of barrier algebra.  As for K2, only B threads run, so
// it waits on one thread's dependent chain and on the spills of the
// factorization stage (`ptxas -v` in the build log).  What it saves
// against the two-launch iteration is the ~80 PyTorch launches of
// barrier algebra between the sweeps and their device-memory round trips.
#include "c2_stage.cuh"

using namespace cfl;

namespace {

// jnp.minimum / jnp.maximum on non-NaN values.
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  return b < a ? b : a;
}
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return b > a ? b : a;
}

// Carried inequality state of one condensed stage (8 stacked inputs).
template <typename T>
struct Ineq {
  T sl[NUC], su[NUC], ll[NUC], lu[NUC], r3[NUC], r4[NUC], ml[NUC], mu[NUC];
};

template <typename T>
__device__ __forceinline__ void load_ineq(Ineq<T>& q, const T* s_l,
                                          const T* s_u, const T* lam_l,
                                          const T* lam_u, const T* r3,
                                          const T* r4, const T* m_l,
                                          const T* m_u, int k, int B, int b) {
  auto a0 = lane(s_l, NUC, k, B, b);
  auto a1 = lane(s_u, NUC, k, B, b);
  auto a2 = lane(lam_l, NUC, k, B, b);
  auto a3 = lane(lam_u, NUC, k, B, b);
  auto a4 = lane(r3, NUC, k, B, b);
  auto a5 = lane(r4, NUC, k, B, b);
  auto a6 = lane(m_l, NUC, k, B, b);
  auto a7 = lane(m_u, NUC, k, B, b);
#pragma unroll
  for (int a = 0; a < NUC; ++a) {
    q.sl[a] = a0[a];
    q.su[a] = a1[a];
    q.ll[a] = a2[a];
    q.lu[a] = a3[a];
    q.r3[a] = a4[a];
    q.r4[a] = a5[a];
    q.ml[a] = a6[a];
    q.mu[a] = a7[a];
  }
}

// Mehrotra-corrected complementarity residuals of a stage from its stored
// affine du (the Pallas kernel's corrected_r5).
template <typename T>
__device__ __forceinline__ void corrected_r5(const Ineq<T>& q,
                                             const T (&du_a)[NUC], T sigmu,
                                             T (&r5l)[NUC], T (&r5u)[NUC]) {
#pragma unroll
  for (int a = 0; a < NUC; ++a) {
    const T dsl = q.ml[a] * (du_a[a] + q.r3[a]);
    const T dsu = q.mu[a] * (q.r4[a] - du_a[a]);
    const T dll = -(q.ll[a] * q.sl[a] + q.ll[a] * dsl) / q.sl[a];
    const T dlu = -(q.lu[a] * q.su[a] + q.lu[a] * dsu) / q.su[a];
    r5l[a] = q.ll[a] * q.sl[a] - sigmu + dsl * dll;
    r5u[a] = q.lu[a] * q.su[a] - sigmu + dsu * dlu;
  }
}

// Corrector directions of a stage from its du: ds = mask * (...), dlam =
// -mask * (r5c + lam ds) / s.
template <typename T>
__device__ __forceinline__ void corrector_dirs(
    const Ineq<T>& q, const T (&du)[NUC], const T (&r5l)[NUC],
    const T (&r5u)[NUC], T (&dsl)[NUC], T (&dsu)[NUC], T (&dll)[NUC],
    T (&dlu)[NUC]) {
#pragma unroll
  for (int a = 0; a < NUC; ++a) {
    dsl[a] = q.ml[a] * (du[a] + q.r3[a]);
    dsu[a] = q.mu[a] * (q.r4[a] - du[a]);
    dll[a] = -q.ml[a] * (r5l[a] + q.ll[a] * dsl[a]) / q.sl[a];
    dlu[a] = -q.mu[a] * (r5u[a] + q.lu[a] * dsu[a]) / q.su[a];
  }
}

// Fraction-to-boundary ratio of one entry: min over the four (v, dv) of
// -v/dv where dv < 0, else BIG.
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

template <typename T>
__global__ void __launch_bounds__(64)
iter_sweep_c2_kernel(
    const T* __restrict__ Abar, const T* __restrict__ Bbar, T* c_res,
    const T* __restrict__ Qbar, const T* __restrict__ S1T,
    const T* __restrict__ R00, T* qx, const T* __restrict__ ruu, T* r1u,
    T* s_l, T* s_u, T* lam_l, T* lam_u, T* r3, T* r4,
    const T* __restrict__ m_l, const T* __restrict__ m_u, T* z_dx, T* z_du,
    const T* __restrict__ pT, T* r1x_T, T* dx0_res, T* z_dxT,
    const T* __restrict__ n_ineq, const T* __restrict__ has_ineq, T* K_all,
    T* kff_all, T* L_all, T* Pc_all, T* dua_all, T* du_all, T* ddx_all,
    T* __restrict__ alpha_out, T* __restrict__ mu_out, T tau, T mu_floor,
    T tiny, int M, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const T BIG = T(3.4e38);
  const T* c = c_res;
  const T* q = qx;

  // ---- phase 0: backward-affine
  T S0 = T(0);
  {
    T P[NX][NX], p[NX];
    {
      auto d = lane(pT, NX, 0, B, b);
      auto pt = lane(static_cast<const T*>(r1x_T), NX, 0, B, b);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
#pragma unroll
        for (int j = 0; j < NX; ++j) P[i][j] = (i == j) ? d[i] : T(0);
        p[i] = pt[i];
      }
    }
#pragma unroll 1
    for (int k = M - 1; k >= 0; --k) {
      T rs[NUC], rt[NUC];
      {
        auto sl = lane(static_cast<const T*>(s_l), NUC, k, B, b);
        auto su = lane(static_cast<const T*>(s_u), NUC, k, B, b);
        auto ll = lane(static_cast<const T*>(lam_l), NUC, k, B, b);
        auto lu = lane(static_cast<const T*>(lam_u), NUC, k, B, b);
        auto g3 = lane(static_cast<const T*>(r3), NUC, k, B, b);
        auto g4 = lane(static_cast<const T*>(r4), NUC, k, B, b);
        auto g1 = lane(static_cast<const T*>(r1u), NUC, k, B, b);
        auto gr = lane(ruu, NUC, k, B, b);
        T s = T(0);
#pragma unroll
        for (int a = 0; a < NUC; ++a) {
          const T vsl = sl[a], vsu = su[a], vll = ll[a], vlu = lu[a];
          const T r5l = vll * vsl;
          const T r5u = vlu * vsu;
          s = (a == 0) ? r5l + r5u : s + (r5l + r5u);
          rs[a] = gr[a] + vll / vsl + vlu / vsu;
          rt[a] = g1[a] + (r5l + vll * g3[a]) / vsl
                  - (r5u + vlu * g4[a]) / vsu;
        }
        S0 = S0 + s;
      }
      factor_stage<T>(lane(Abar, NX * NX, k, B, b),
                      lane(Bbar, NX * NUC, k, B, b), lane(c, NX, k, B, b),
                      lane(Qbar, NX * NX, k, B, b),
                      lane(S1T, NU * NX, k, B, b), lane(R00, NU * NU, k, B, b),
                      lane(q, NX, k, B, b), rs, rt, P, p,
                      lane(K_all, NUC * NX, k, B, b),
                      lane(kff_all, NUC, k, B, b), lane(L_all, NLC, k, B, b),
                      lane(Pc_all, NX, k, B, b));
    }
  }

  // ---- phase 1: forward-affine
  T S1 = T(0), S2 = T(0), amin = BIG;
  {
    T x[NX];
    {
      auto x0 = lane(static_cast<const T*>(dx0_res), NX, 0, B, b);
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = x0[i];
    }
#pragma unroll 1
    for (int k = 0; k < M; ++k) {
      T u[NUC], xn[NX];
      rollout_stage<T>(lane(Abar, NX * NX, k, B, b),
                       lane(Bbar, NX * NUC, k, B, b), lane(c, NX, k, B, b),
                       lane(static_cast<const T*>(K_all), NUC * NX, k, B, b),
                       lane(static_cast<const T*>(kff_all), NUC, k, B, b), x,
                       u, xn);
      auto dua = lane(dua_all, NUC, k, B, b);
#pragma unroll
      for (int a = 0; a < NUC; ++a) dua[a] = u[a];
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = xn[i];

      Ineq<T> g;
      load_ineq<T>(g, s_l, s_u, lam_l, lam_u, r3, r4, m_l, m_u, k, B, b);
      T s1 = T(0), s2 = T(0), rmin = BIG;
#pragma unroll
      for (int a = 0; a < NUC; ++a) {
        const T dsl = g.ml[a] * (u[a] + g.r3[a]);
        const T dsu = g.mu[a] * (g.r4[a] - u[a]);
        const T dll = -(g.ll[a] * g.sl[a] + g.ll[a] * dsl) / g.sl[a];
        const T dlu = -(g.lu[a] * g.su[a] + g.lu[a] * dsu) / g.su[a];
        const T t1 = g.ll[a] * dsl + g.sl[a] * dll + g.lu[a] * dsu
                     + g.su[a] * dlu;
        const T t2 = dll * dsl + dlu * dsu;
        s1 = (a == 0) ? t1 : s1 + t1;
        s2 = (a == 0) ? t2 : s2 + t2;
        rmin = tmin(rmin, ratio4(BIG, g.sl[a], dsl, g.su[a], dsu, g.ll[a],
                                 dll, g.lu[a], dlu));
      }
      S1 = S1 + s1;
      S2 = S2 + s2;
      amin = tmin(amin, rmin);
    }
  }
  const T nin = n_ineq[b];
  const T mu = S0 / nin;
  T sigmu;
  {
    const T a = tmin(T(1), amin);
    const T mu_aff = (S0 + a * S1 + a * a * S2) / nin;
    T sig = mu_aff / tmax(mu, tiny);
    sig = tmin(tmax(sig * sig * sig, T(0)), T(1));
    sigmu = sig * mu;
  }
  mu_out[b] = mu;

  // ---- phase 2: backward-corrector
  {
    T p[NX];
    {
      auto pt = lane(static_cast<const T*>(r1x_T), NX, 0, B, b);
#pragma unroll
      for (int i = 0; i < NX; ++i) p[i] = pt[i];
    }
#pragma unroll 1
    for (int k = M - 1; k >= 0; --k) {
      T rt[NUC];
      {
        Ineq<T> g;
        load_ineq<T>(g, s_l, s_u, lam_l, lam_u, r3, r4, m_l, m_u, k, B, b);
        T du_a[NUC], r5l[NUC], r5u[NUC];
        auto dua = lane(static_cast<const T*>(dua_all), NUC, k, B, b);
#pragma unroll
        for (int a = 0; a < NUC; ++a) du_a[a] = dua[a];
        corrected_r5<T>(g, du_a, sigmu, r5l, r5u);
        auto g1 = lane(static_cast<const T*>(r1u), NUC, k, B, b);
#pragma unroll
        for (int a = 0; a < NUC; ++a)
          rt[a] = g1[a] + g.ml[a] * (r5l[a] + g.ll[a] * g.r3[a]) / g.sl[a]
                  - g.mu[a] * (r5u[a] + g.lu[a] * g.r4[a]) / g.su[a];
      }
      vec_stage<T>(lane(Abar, NX * NX, k, B, b),
                   lane(Bbar, NX * NUC, k, B, b),
                   lane(static_cast<const T*>(K_all), NUC * NX, k, B, b),
                   lane(static_cast<const T*>(Pc_all), NX, k, B, b),
                   lane(static_cast<const T*>(L_all), NLC, k, B, b),
                   lane(q, NX, k, B, b), rt, p, lane(kff_all, NUC, k, B, b));
    }
  }

  // ---- phase 3: forward-corrector
  T xT[NX];
  amin = BIG;
  {
#pragma unroll
    for (int i = 0; i < NX; ++i) xT[i] = dx0_res[i * B + b];
#pragma unroll 1
    for (int k = 0; k < M; ++k) {
      T u[NUC], xn[NX];
      rollout_stage<T>(lane(Abar, NX * NX, k, B, b),
                       lane(Bbar, NX * NUC, k, B, b), lane(c, NX, k, B, b),
                       lane(static_cast<const T*>(K_all), NUC * NX, k, B, b),
                       lane(static_cast<const T*>(kff_all), NUC, k, B, b), xT,
                       u, xn);
      auto ddx = lane(ddx_all, NX, k, B, b);
      auto duo = lane(du_all, NUC, k, B, b);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        ddx[i] = xT[i];
        xT[i] = xn[i];
      }
#pragma unroll
      for (int a = 0; a < NUC; ++a) duo[a] = u[a];

      Ineq<T> g;
      load_ineq<T>(g, s_l, s_u, lam_l, lam_u, r3, r4, m_l, m_u, k, B, b);
      T du_a[NUC], r5l[NUC], r5u[NUC], dsl[NUC], dsu[NUC], dll[NUC],
          dlu[NUC];
      auto dua = lane(static_cast<const T*>(dua_all), NUC, k, B, b);
#pragma unroll
      for (int a = 0; a < NUC; ++a) du_a[a] = dua[a];
      corrected_r5<T>(g, du_a, sigmu, r5l, r5u);
      corrector_dirs<T>(g, u, r5l, r5u, dsl, dsu, dll, dlu);
      T rmin = BIG;
#pragma unroll
      for (int a = 0; a < NUC; ++a)
        rmin = tmin(rmin, ratio4(BIG, g.sl[a], dsl[a], g.su[a], dsu[a],
                                 g.ll[a], dll[a], g.lu[a], dlu[a]));
      amin = tmin(amin, rmin);
    }
  }
  T alpha = tmin(T(1), tau * amin);
  if (has_ineq[b] > T(0) && mu <= mu_floor) alpha = T(0);
  alpha_out[b] = alpha;

  // ---- phase 4: update, in place
  const T shrink = T(1) - alpha;
#pragma unroll 1
  for (int k = 0; k < M; ++k) {
    Ineq<T> g;
    load_ineq<T>(g, s_l, s_u, lam_l, lam_u, r3, r4, m_l, m_u, k, B, b);
    T du_a[NUC], du[NUC], r5l[NUC], r5u[NUC], dsl[NUC], dsu[NUC], dll[NUC],
        dlu[NUC];
    auto dua = lane(static_cast<const T*>(dua_all), NUC, k, B, b);
    auto duk = lane(static_cast<const T*>(du_all), NUC, k, B, b);
#pragma unroll
    for (int a = 0; a < NUC; ++a) {
      du_a[a] = dua[a];
      du[a] = duk[a];
    }
    corrected_r5<T>(g, du_a, sigmu, r5l, r5u);
    corrector_dirs<T>(g, du, r5l, r5u, dsl, dsu, dll, dlu);

    auto zx = lane(z_dx, NX, k, B, b);
    auto ddx = lane(static_cast<const T*>(ddx_all), NX, k, B, b);
    auto qk = lane(qx, NX, k, B, b);
    auto ckk = lane(c_res, NX, k, B, b);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      zx[i] = zx[i] + alpha * ddx[i];
      qk[i] = shrink * qk[i];
      ckk[i] = shrink * ckk[i];
    }
    auto zu = lane(z_du, NUC, k, B, b);
    auto osl = lane(s_l, NUC, k, B, b);
    auto osu = lane(s_u, NUC, k, B, b);
    auto oll = lane(lam_l, NUC, k, B, b);
    auto olu = lane(lam_u, NUC, k, B, b);
    auto o1 = lane(r1u, NUC, k, B, b);
    auto o3 = lane(r3, NUC, k, B, b);
    auto o4 = lane(r4, NUC, k, B, b);
#pragma unroll
    for (int a = 0; a < NUC; ++a) {
      zu[a] = zu[a] + alpha * du[a];
      osl[a] = g.sl[a] + alpha * dsl[a];
      osu[a] = g.su[a] + alpha * dsu[a];
      oll[a] = g.ll[a] + alpha * dll[a];
      olu[a] = g.lu[a] + alpha * dlu[a];
      o1[a] = shrink * o1[a];
      o3[a] = shrink * g.r3[a];
      o4[a] = shrink * g.r4[a];
    }
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    z_dxT[i * B + b] = z_dxT[i * B + b] + alpha * xT[i];
    r1x_T[i * B + b] = shrink * r1x_T[i * B + b];
    dx0_res[i * B + b] = shrink * dx0_res[i * B + b];
  }
}

}  // namespace

#define ITER_ENTRY(SUFFIX, T)                                                 \
  extern "C" int iter_sweep_c2_##SUFFIX(                                      \
      const T* Abar, const T* Bbar, T* c_res, const T* Qbar, const T* S1T,    \
      const T* R00, T* qx, const T* ruu, T* r1u, T* s_l, T* s_u, T* lam_l,    \
      T* lam_u, T* r3, T* r4, const T* m_l, const T* m_u, T* z_dx, T* z_du,   \
      const T* pT, T* r1x_T, T* dx0_res, T* z_dxT, const T* n_ineq,           \
      const T* has_ineq, T* K_all, T* kff_all, T* L_all, T* Pc_all,           \
      T* dua_all, T* du_all, T* ddx_all, T* alpha, T* mu, double tau,         \
      double mu_floor, double tiny, int M, int B, void* stream) {             \
    iter_sweep_c2_kernel<T><<<(B + 63) / 64, 64, 0,                           \
                              static_cast<cudaStream_t>(stream)>>>(           \
        Abar, Bbar, c_res, Qbar, S1T, R00, qx, ruu, r1u, s_l, s_u, lam_l,     \
        lam_u, r3, r4, m_l, m_u, z_dx, z_du, pT, r1x_T, dx0_res, z_dxT,       \
        n_ineq, has_ineq, K_all, kff_all, L_all, Pc_all, dua_all, du_all,     \
        ddx_all, alpha, mu, static_cast<T>(tau), static_cast<T>(mu_floor),    \
        static_cast<T>(tiny), M, B);                                          \
    return static_cast<int>(cudaGetLastError());                              \
  }

ITER_ENTRY(f32, float)
ITER_ENTRY(f64, double)
