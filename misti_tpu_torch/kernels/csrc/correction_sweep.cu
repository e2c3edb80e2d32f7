// Fused pre-split lambda-correction sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel misti_tpu/kernels/correction_pallas.py
// `build_fused_correction` (its `pl.pallas_call`, body `_sweep_body`): for
// each candidate lane and each pre-split interval, the fixed point of the
// reference's CorrectLambdas (MigrationInference.py:305-354).  Per Jacobi
// round the kernel propagates the 3x3 two-lineage chain (Taylor-18
// scaling-and-squaring expm, optional pulse maps, ordered prefix product
// over intervals), then solves each interval's 2-unknown system by
// trust-region Levenberg-Marquardt from a warm start; one last chain gives
// the states after each interval.
//
// What bounds it on this card: arithmetic.  A lane moves 7 inputs and 8
// outputs per interval (~60 bytes in float32) but spends thousands of
// dependent 3x3 flops per LM iteration, so the card's FP32/FP64 non-tensor
// rate and the latency of the dependent chains set the time, not HBM.
// What the design does about it:
//   * one thread per (interval, lane): the expm and LM work of a round is
//     independent across intervals, so 28 intervals x 4096 lanes give
//     ~115k threads of straight-line register arithmetic;
//   * a block holds L lanes x all s intervals (L a power of two, L*s <= 256);
//     each round the 3x3 interval propagators go to shared memory once and
//     the ordered product C_t = G_t ... G_0 is formed by the same
//     Hillis-Steele doubling as the JAX kernel (log2(s) steps), so the
//     association order, and with it the rounding, is the plain version's;
//   * the LM Jacobian comes from one pass over dual numbers D2 {v, d0, d1}:
//     the residual code is written once, generic over the scalar type, and
//     instantiated on T for the chain and on D2<T> for the residuals (what
//     jax.linearize shared in the TPU kernel);
//   * a thread leaves its LM loop once converged; every update after
//     convergence was masked in the TPU kernel, so the numbers are the same.
// Built with --fmad=false so each product and sum rounds as the plain torch
// version's separate ops do.
//
// Layout: inp (7, s, B) = T, lh0, lh1, mi0, mi1, pu0, pu1; out (8, s, B) =
// lc0, lc1, p_after (2 genomes x 3 states); the lane index is fastest.
// Compile-time variants: residual mode (cpfit or expected coalescence time,
// -DMISTI_CPFIT), dtype (-DMISTI_T), and inside each library the template
// flags STATIC_NO_MIG and HAS_PULSE.

#include <cuda_runtime.h>
#include <math.h>

#ifndef MISTI_T
#define MISTI_T float
#endif
#ifndef MISTI_CPFIT
#define MISTI_CPFIT 1
#endif

namespace {

constexpr int kMaxThreads = 256;

// ---------------------------------------------------------------- scalars

__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_log2(float x) { return log2f(x); }
__device__ __forceinline__ double m_log2(double x) { return log2(x); }
__device__ __forceinline__ float m_exp2(float x) { return exp2f(x); }
__device__ __forceinline__ double m_exp2(double x) { return exp2(x); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_ceil(float x) { return ceilf(x); }
__device__ __forceinline__ double m_ceil(double x) { return ceil(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ bool m_isnan(T x) { return x != x; }

// NaN-propagating max/min (jnp.maximum / torch.maximum semantics)
template <typename T>
__device__ __forceinline__ T jmax(T a, T b) {
  return (m_isnan(a) || m_isnan(b)) ? a + b : (a > b ? a : b);
}
template <typename T>
__device__ __forceinline__ T jmin(T a, T b) {
  return (m_isnan(a) || m_isnan(b)) ? a + b : (a < b ? a : b);
}
template <typename T>
__device__ __forceinline__ T jclip(T x, T lo, T hi) { return jmin(jmax(x, lo), hi); }

// ------------------------------------------------------------ dual numbers

// v + d0 e0 + d1 e1: value and the two forward-mode tangent components.
template <typename T>
struct D2 {
  T v, d0, d1;
  __device__ D2() {}
  __device__ D2(T x) : v(x), d0(T(0)), d1(T(0)) {}
  __device__ D2(T x, T a, T b) : v(x), d0(a), d1(b) {}
};

template <typename T>
__device__ __forceinline__ D2<T> operator+(const D2<T>& a, const D2<T>& b) {
  return D2<T>(a.v + b.v, a.d0 + b.d0, a.d1 + b.d1);
}
template <typename T>
__device__ __forceinline__ D2<T> operator-(const D2<T>& a, const D2<T>& b) {
  return D2<T>(a.v - b.v, a.d0 - b.d0, a.d1 - b.d1);
}
template <typename T>
__device__ __forceinline__ D2<T> operator-(const D2<T>& a) {
  return D2<T>(-a.v, -a.d0, -a.d1);
}
template <typename T>
__device__ __forceinline__ D2<T> operator*(const D2<T>& a, const D2<T>& b) {
  return D2<T>(a.v * b.v, a.d0 * b.v + a.v * b.d0, a.d1 * b.v + a.v * b.d1);
}
template <typename T>
__device__ __forceinline__ D2<T> operator/(const D2<T>& a, const D2<T>& b) {
  T q = a.v / b.v;
  return D2<T>(q, (a.d0 - q * b.d0) / b.v, (a.d1 - q * b.d1) / b.v);
}
template <typename T>
__device__ __forceinline__ D2<T> operator+(const D2<T>& a, T b) { return D2<T>(a.v + b, a.d0, a.d1); }
template <typename T>
__device__ __forceinline__ D2<T> operator+(T a, const D2<T>& b) { return D2<T>(a + b.v, b.d0, b.d1); }
template <typename T>
__device__ __forceinline__ D2<T> operator-(const D2<T>& a, T b) { return D2<T>(a.v - b, a.d0, a.d1); }
template <typename T>
__device__ __forceinline__ D2<T> operator-(T a, const D2<T>& b) { return D2<T>(a - b.v, -b.d0, -b.d1); }
template <typename T>
__device__ __forceinline__ D2<T> operator*(const D2<T>& a, T b) { return D2<T>(a.v * b, a.d0 * b, a.d1 * b); }
template <typename T>
__device__ __forceinline__ D2<T> operator*(T a, const D2<T>& b) { return D2<T>(a * b.v, a * b.d0, a * b.d1); }
template <typename T>
__device__ __forceinline__ D2<T> operator/(const D2<T>& a, T b) { return D2<T>(a.v / b, a.d0 / b, a.d1 / b); }
template <typename T>
__device__ __forceinline__ D2<T> operator/(T a, const D2<T>& b) {
  T q = a / b.v;
  return D2<T>(q, (-q * b.d0) / b.v, (-q * b.d1) / b.v);
}

template <typename T>
__device__ __forceinline__ D2<T> m_exp(const D2<T>& a) {
  T e = m_exp(a.v);
  return D2<T>(e, e * a.d0, e * a.d1);
}

template <typename T> struct Val { __device__ static T get(T x) { return x; } };
template <typename T> struct Val<D2<T>> { __device__ static T get(const D2<T>& x) { return x.v; } };
template <typename S> __device__ __forceinline__ auto val(const S& x) { return Val<S>::get(x); }

// --------------------------------------------------------- 3x3 algebra

template <typename S>
struct M3 {
  S a[9];
};

template <typename S>
__device__ __forceinline__ M3<S> m3_mul(const M3<S>& a, const M3<S>& b) {
  M3<S> o;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      o.a[3 * i + j] = a.a[3 * i] * b.a[j] + a.a[3 * i + 1] * b.a[3 + j] + a.a[3 * i + 2] * b.a[6 + j];
  return o;
}

template <typename S, typename T>
__device__ __forceinline__ M3<S> m3_eye() {
  M3<S> o;
#pragma unroll
  for (int k = 0; k < 9; ++k) o.a[k] = S(T((k % 4) == 0 ? 1 : 0));
  return o;
}

// 3x3 two-lineage location generator (reference CorrectLambda.py:55-56)
template <typename S, typename T>
__device__ __forceinline__ M3<S> corr_mat(S l0, S l1, T m0, T m1) {
  M3<S> o;
  o.a[0] = S(T(-2.0) * m0) - l0;
  o.a[1] = S(T(0));
  o.a[2] = S(m1);
  o.a[3] = S(T(0));
  o.a[4] = S(T(-2.0) * m1) - l1;
  o.a[5] = S(m0);
  o.a[6] = S(T(2.0) * m0);
  o.a[7] = S(T(2.0) * m1);
  o.a[8] = S(-m0 - m1);
  return o;
}

// Squaring count and scale of a matrix (values only: the count is a step
// function of the rates, so its tangent is zero).  Past 2^max_sq the scale
// is NaN: a runaway trial rate poisons its lane instead of being clamped.
template <typename S, typename T>
__device__ __forceinline__ void scaling(const M3<S>& a, int max_sq, int& ns, T& scale) {
  T c0 = m_abs(val(a.a[0])) + m_abs(val(a.a[3])) + m_abs(val(a.a[6]));
  T c1 = m_abs(val(a.a[1])) + m_abs(val(a.a[4])) + m_abs(val(a.a[7]));
  T c2 = m_abs(val(a.a[2])) + m_abs(val(a.a[5])) + m_abs(val(a.a[8]));
  T norm = jmax(jmax(c0, c1), c2);
  T sv = jmax(T(0), m_ceil(m_log2(jmax(norm, T(1e-30)))));
  if (!(isfinite(norm) && norm > T(0))) sv = T(0);
  bool over = sv > T(max_sq);
  sv = jmin(sv, T(max_sq));
  scale = over ? T(NAN) : m_exp2(-sv);
  ns = (int)sv;
}

template <typename S, typename T>
__device__ __forceinline__ M3<S> m3_scale(const M3<S>& a, T sc) {
  M3<S> o;
#pragma unroll
  for (int k = 0; k < 9; ++k) o.a[k] = a.a[k] * sc;
  return o;
}

// Paterson-Stockmeyer powers b^1 .. b^6 (b^0 = I is implicit below)
template <typename S>
__device__ __forceinline__ void ps_powers(const M3<S>& b, M3<S> (&p)[7]) {
  p[1] = b;
#pragma unroll
  for (int k = 2; k < 7; ++k) p[k] = m3_mul(p[k - 1], b);
}

// sum_k c[k] b^k (k <= 18) in base b^6
template <typename S, typename T>
__device__ __forceinline__ M3<S> ps_horner(const M3<S> (&p)[7], const double (&c)[19]) {
  M3<S> eye = m3_eye<S, T>();
  M3<S> blk[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int k0 = 6 * q;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      S o = T(c[k0]) * eye.a[k];
#pragma unroll
      for (int j = 1; j < 6; ++j) o = o + T(c[k0 + j]) * p[j].a[k];
      blk[q].a[k] = o;
    }
  }
  M3<S> b2;
#pragma unroll
  for (int k = 0; k < 9; ++k) b2.a[k] = blk[2].a[k] + T(c[18]) * p[6].a[k];
  M3<S> t2 = m3_mul(p[6], b2);
  M3<S> inner;
#pragma unroll
  for (int k = 0; k < 9; ++k) inner.a[k] = blk[1].a[k] + t2.a[k];
  M3<S> t1 = m3_mul(p[6], inner);
  M3<S> out;
#pragma unroll
  for (int k = 0; k < 9; ++k) out.a[k] = blk[0].a[k] + t1.a[k];
  return out;
}

// Taylor coefficients: e^b, phi1(b) = (e^b - I)/b, E - I, centred moment J
struct Coeffs {
  double ce[19], c1[19], cphi[19], cj[19];
};
__constant__ Coeffs kC;

template <typename S, typename T>
__device__ M3<S> expm3(const M3<S>& a, int max_sq) {
  int ns;
  T sc;
  scaling<S, T>(a, max_sq, ns, sc);
  M3<S> p[7];
  ps_powers(m3_scale(a, sc), p);
  M3<S> e = ps_horner<S, T>(p, kC.ce);
  for (int i = 0; i < ns; ++i) e = m3_mul(e, e);
  return e;
}

// Phi = e^a - I without cancellation: Phi(2h) = Phi^2 + 2 Phi
template <typename S, typename T>
__device__ M3<S> expm3_m1(const M3<S>& a, int max_sq) {
  int ns;
  T sc;
  scaling<S, T>(a, max_sq, ns, sc);
  M3<S> p[7];
  ps_powers(m3_scale(a, sc), p);
  M3<S> phi = ps_horner<S, T>(p, kC.cphi);
  for (int i = 0; i < ns; ++i) {
    M3<S> sq = m3_mul(phi, phi);
#pragma unroll
    for (int k = 0; k < 9; ++k) phi.a[k] = sq.a[k] + T(2.0) * phi.a[k];
  }
  return phi;
}

// (N1, J) of the stretched generator: N1 = int_0^1 e^{as} ds and the
// centred first moment J = int_0^1 (s - 1/2) e^{as} ds
template <typename S, typename T>
__device__ void expm3_nc_moments(const M3<S>& a, int max_sq, M3<S>& n1, M3<S>& j) {
  int ns;
  T h;
  scaling<S, T>(a, max_sq, ns, h);
  M3<S> p[7];
  ps_powers(m3_scale(a, h), p);
  M3<S> phi1 = ps_horner<S, T>(p, kC.c1);
  M3<S> phim = ps_horner<S, T>(p, kC.cphi);
  M3<S> jr = ps_horner<S, T>(p, kC.cj);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    n1.a[k] = h * phi1.a[k];
    j.a[k] = (h * h) * jr.a[k];
  }
  for (int i = 0; i < ns; ++i) {
    M3<S> tmp = m3_mul(phim, n1);
    M3<S> pj = m3_mul(phim, j);
    M3<S> pp = m3_mul(phim, phim);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      j.a[k] = T(2.0) * j.a[k] + pj.a[k] + (T(0.5) * h) * tmp.a[k];
      n1.a[k] = T(2.0) * n1.a[k] + tmp.a[k];
      phim.a[k] = pp.a[k] + T(2.0) * phim.a[k];
    }
    h = T(2.0) * h;
  }
}

// ------------------------------------------------------ scalar helpers

// exp(x) - 1: 7-term series below 0.5, exp(x) - 1 above (kept from the TPU
// kernel so results match the reference package)
template <typename S, typename T>
__device__ __forceinline__ S expm1_ser(const S& x) {
  if (val(x) < T(0.5)) {
    S t = T(1.0) + x / T(7);
    t = T(1.0) + (x / T(6)) * t;
    t = T(1.0) + (x / T(5)) * t;
    t = T(1.0) + (x / T(4)) * t;
    t = T(1.0) + (x / T(3)) * t;
    t = T(1.0) + (x / T(2)) * t;
    return x * t;
  }
  return m_exp(x) - T(1.0);
}

// 1 - exp(-x)
template <typename S, typename T>
__device__ __forceinline__ S em1m(const S& x) {
  if (val(x) < T(0.5)) {
    S t = T(1.0) - x / T(7);
    t = T(1.0) - (x / T(6)) * t;
    t = T(1.0) - (x / T(5)) * t;
    t = T(1.0) - (x / T(4)) * t;
    t = T(1.0) - (x / T(3)) * t;
    t = T(1.0) - (x / T(2)) * t;
    return x * t;
  }
  return T(1.0) - m_exp(-x);
}

// log(1 + x) by the w = 1 + x compensation
template <typename T>
__device__ __forceinline__ T log1p_c(T x) {
  T w = T(1.0) + x;
  T d = w - T(1.0);
  if (d == T(0)) return x;
  return x * m_log(w) / d;
}

// ECT(lam, T)/T - 1/2 at x = lam*T
template <typename T>
__device__ __forceinline__ T ect_dev(T x) {
  if (x < T(1.0)) {
    T x2 = x * x;
    T t = T(1.0 / 1209600.0) + x2 * T(-1.0 / 47900160.0);
    t = T(-1.0 / 30240.0) + x2 * t;
    t = T(1.0 / 720.0) + x2 * t;
    t = T(-1.0 / 12.0) + x2 * t;
    return x * t;
  }
  T tail = (x > T(100.0)) ? T(0) : T(1.0) / expm1_ser<T, T>(x);
  return T(1.0) / x - tail - T(0.5);
}

// ECTnc(x) - (1 - e^-x)/2
template <typename S, typename T>
__device__ __forceinline__ S ectnc_dev(const S& x) {
  if (val(x) < T(1.0)) {
    S t = T(1.0 / 95800320.0) + x * T(-11.0 / 12454041600.0);
    t = T(-1.0 / 8870400.0) + x * t;
    t = T(1.0 / 907200.0) + x * t;
    t = T(-1.0 / 103680.0) + x * t;
    t = T(1.0 / 13440.0) + x * t;
    t = T(-1.0 / 2016.0) + x * t;
    t = T(1.0 / 360.0) + x * t;
    t = T(-1.0 / 80.0) + x * t;
    t = T(1.0 / 24.0) + x * t;
    t = T(-1.0 / 12.0) + x * t;
    return (x * x) * t;
  }
  return (T(1.0) - m_exp(-x) * (T(1.0) + x)) / x - T(0.5) * em1m<S, T>(x);
}

// Pulse-migration map on a location column (q_p, q_q, q_split)
// (MigrationInference.py:315-323; identity at rate == 0)
template <typename T>
__device__ __forceinline__ void pulse_cols(T& q0, T& q1, T& q2, T rate, int pop) {
  T qp = pop == 0 ? q0 : q1;
  T qq = pop == 0 ? q1 : q0;
  T om = T(1.0) - rate;
  T np_ = qp * (om * om);
  T nq = qp * (rate * rate) + qq + q2 * rate;
  T n2 = qp * T(2.0) * om * rate + q2 * om;
  if (pop == 0) {
    q0 = np_;
    q1 = nq;
  } else {
    q0 = nq;
    q1 = np_;
  }
  q2 = n2;
}

// ------------------------------------------------------------ residuals

template <typename T>
struct Ctx {
  T p00, p01, p02, p10, p11, p12;        // state entering the solve
  T pn00, pn01, pn02, pn10, pn11, pn12;  // ... normalised
  T s0, s1;                              // its total masses
  T mu0s, mu1s;                          // stretched migration rates
  T em_s0, em_s1;                        // em1m of the target rates (cpfit)
  T ect_s0, ect_s1;                      // ect_dev of the target rates (ECT)
  T ect_raw0, ect_raw1;                  // ect_dev of the unmerged targets
  int max_sq;
};

// cpfit: no-coalescence masses as deviations from the total mass
template <typename S, typename T>
__device__ void res_cp(const Ctx<T>& c, const S& a0, const S& a1, S& r0, S& r1) {
  M3<S> phi = expm3_m1<S, T>(corr_mat<S, T>(a0, a1, c.mu0s, c.mu1s), c.max_sq);
  S cs0 = phi.a[0] + phi.a[3] + phi.a[6];
  S cs1 = phi.a[1] + phi.a[4] + phi.a[7];
  S cs2 = phi.a[2] + phi.a[5] + phi.a[8];
  r0 = cs0 * c.p00 + cs1 * c.p01 + cs2 * c.p02 + S(c.s0 * c.em_s0);
  r1 = cs0 * c.p10 + cs1 * c.p11 + cs2 * c.p12 + S(c.s1 * c.em_s1);
}

// expected coalescence time with migration: conditional mean minus its
// T/2 baseline, 1 - pnc == a0 (N1 p)_0 + a1 (N1 p)_1
template <typename S, typename T>
__device__ void res_ect(const Ctx<T>& c, const S& a0, const S& a1, S& r0, S& r1) {
  M3<S> n1, jm;
  expm3_nc_moments<S, T>(corr_mat<S, T>(a0, a1, c.mu0s, c.mu1s), c.max_sq, n1, jm);
  S n1p00 = n1.a[0] * c.pn00 + n1.a[1] * c.pn01 + n1.a[2] * c.pn02;
  S n1p01 = n1.a[3] * c.pn00 + n1.a[4] * c.pn01 + n1.a[5] * c.pn02;
  S n1p10 = n1.a[0] * c.pn10 + n1.a[1] * c.pn11 + n1.a[2] * c.pn12;
  S n1p11 = n1.a[3] * c.pn10 + n1.a[4] * c.pn11 + n1.a[5] * c.pn12;
  S jp00 = jm.a[0] * c.pn00 + jm.a[1] * c.pn01 + jm.a[2] * c.pn02;
  S jp01 = jm.a[3] * c.pn00 + jm.a[4] * c.pn01 + jm.a[5] * c.pn02;
  S jp10 = jm.a[0] * c.pn10 + jm.a[1] * c.pn11 + jm.a[2] * c.pn12;
  S jp11 = jm.a[3] * c.pn10 + jm.a[4] * c.pn11 + jm.a[5] * c.pn12;
  S den0 = a0 * n1p00 + a1 * n1p01;
  S den1 = a0 * n1p10 + a1 * n1p11;
  S t2_0 = (a0 * jp00 + a1 * jp01) / den0;
  S t2_1 = (a0 * jp10 + a1 * jp11) / den1;
  r0 = t2_0 - c.ect_s0;
  r1 = t2_1 - c.ect_s1;
}

// expected coalescence time without migration
template <typename S, typename T>
__device__ void res_nomig(const Ctx<T>& c, const S& a0, const S& a1, S& r0, S& r1) {
  S d0 = em1m<S, T>(a0);
  S d1 = em1m<S, T>(a1);
  S q0 = ectnc_dev<S, T>(a0);
  S q1 = ectnc_dev<S, T>(a1);
  S den0 = c.pn00 * d0 + c.pn01 * d1;
  S den1 = c.pn10 * d0 + c.pn11 * d1;
  S ct0 = (c.pn00 * q0 + c.pn01 * q1) / den0;
  S ct1 = (c.pn10 * q0 + c.pn11 * q1) / den1;
  r0 = ct0 - c.ect_raw0;
  r1 = ct1 - c.ect_raw1;
}

enum { RES_CP = 0, RES_ECT = 1, RES_NOMIG = 2 };

// residual and 2x2 Jacobian in one dual-number pass
template <int MODE, typename T>
__device__ void lin_at(const Ctx<T>& c, T x0, T x1, T& r0, T& r1, T& j00, T& j10,
                       T& j01, T& j11) {
  D2<T> a0(x0, T(1), T(0)), a1(x1, T(0), T(1)), o0, o1;
  if constexpr (MODE == RES_CP) res_cp<D2<T>, T>(c, a0, a1, o0, o1);
  if constexpr (MODE == RES_ECT) res_ect<D2<T>, T>(c, a0, a1, o0, o1);
  if constexpr (MODE == RES_NOMIG) res_nomig<D2<T>, T>(c, a0, a1, o0, o1);
  r0 = o0.v;
  r1 = o1.v;
  j00 = o0.d0;
  j10 = o1.d0;
  j01 = o0.d1;
  j11 = o1.d1;
}

// Fixed-budget 2-unknown Levenberg-Marquardt (damping 1e-3 with x0.25/x4,
// trust region x2/x0.5, accept on decrease); leaves the loop once converged
template <int MODE, typename T>
__device__ void lm2(const Ctx<T>& c, T& x0, T& x1, int n_iters, T lower0, T lower1) {
  x0 = jmax(x0, lower0);
  x1 = jmax(x1, lower1);
  T trust = jmax(m_sqrt(x0 * x0 + x1 * x1), T(1.0));
  T r0, r1, j00, j10, j01, j11;
  lin_at<MODE, T>(c, x0, x1, r0, r1, j00, j10, j01, j11);
  T damp = T(1e-3);
  T cost = r0 * r0 + r1 * r1;
  for (int it = 0; it < n_iters; ++it) {
    T a00 = j00 * j00 + j10 * j10 + damp;
    T a01 = j00 * j01 + j10 * j11;
    T a11 = j01 * j01 + j11 * j11 + damp;
    T g0 = j00 * r0 + j10 * r1;
    T g1 = j01 * r0 + j11 * r1;
    T det = a00 * a11 - a01 * a01;
    if (det == T(0)) det = T(1.0);
    T d0 = (a01 * g1 - a11 * g0) / det;
    T d1 = (a01 * g0 - a00 * g1) / det;
    T dn = m_sqrt(d0 * d0 + d1 * d1);
    T shrink = jmin(T(1.0), trust / jmax(dn, T(1e-30)));
    d0 = d0 * shrink;
    d1 = d1 * shrink;
    T xn0 = jmax(x0 + d0, lower0);
    T xn1 = jmax(x1 + d1, lower1);
    T rn0, rn1, jn00, jn10, jn01, jn11;
    lin_at<MODE, T>(c, xn0, xn1, rn0, rn1, jn00, jn10, jn01, jn11);
    T cn = rn0 * rn0 + rn1 * rn1;
    bool ok = isfinite(cn) && (cn < cost);
    T step = T(INFINITY);
    if (ok) {
      T e0 = xn0 - x0, e1 = xn1 - x1;
      step = m_sqrt(e0 * e0 + e1 * e1);
      x0 = xn0;
      x1 = xn1;
      r0 = rn0;
      r1 = rn1;
      j00 = jn00;
      j10 = jn10;
      j01 = jn01;
      j11 = jn11;
      cost = cn;
    }
    damp = jclip(ok ? damp * T(0.25) : damp * T(4.0), T(1e-14), T(1e10));
    trust = jclip(ok ? trust * T(2.0) : trust * T(0.5), T(1e-8), T(1e3));
    if (cost < T(1e-28) || step < T(1e-13) * (T(1.0) + m_sqrt(x0 * x0 + x1 * x1))) break;
  }
}

// ---------------------------------------------------------------- kernel

struct Geometry {
  int s, B, L, t, ll, lane;
};

// Chain for stretched rate guesses (x0s, x1s): the state entering each
// solve (pulses applied) and the state after each interval.  Every thread
// of the block calls it: it holds the block-wide prefix product.
template <typename T, bool HAS_PULSE>
__device__ void chain(const Geometry& g, T* sm, T x0s, T x1s, T mu0s, T mu1s, T pu0,
                      T pu1, int max_sq, T (&pin)[6], T (&pa)[6]) {
  M3<T> gm = expm3<T, T>(corr_mat<T, T>(x0s, x1s, mu0s, mu1s), max_sq);
  if constexpr (HAS_PULSE) {
    // pulses act before the exponential: P = PU1 @ PU0, column by column
    M3<T> pm;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T q0 = T(j == 0 ? 1 : 0), q1 = T(j == 1 ? 1 : 0), q2 = T(j == 2 ? 1 : 0);
      pulse_cols(q0, q1, q2, pu0, 0);
      pulse_cols(q0, q1, q2, pu1, 1);
      pm.a[0 + j] = q0;
      pm.a[3 + j] = q1;
      pm.a[6 + j] = q2;
    }
    gm = m3_mul(gm, pm);
  }
  const int stride = g.s * g.L;
  const int me = g.t * g.L + g.ll;
  M3<T> c = gm;
  // Hillis-Steele ordered product C_t = G_t @ ... @ G_0 (JAX order)
  for (int d = 1; d < g.s; d *= 2) {
#pragma unroll
    for (int k = 0; k < 9; ++k) sm[k * stride + me] = c.a[k];
    __syncthreads();
    M3<T> sh = m3_eye<T, T>();
    if (g.t >= d) {
#pragma unroll
      for (int k = 0; k < 9; ++k) sh.a[k] = sm[k * stride + me - d * g.L];
    }
    __syncthreads();
    c = m3_mul(c, sh);
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) sm[k * stride + me] = c.a[k];
  __syncthreads();
  M3<T> ex = m3_eye<T, T>();  // C_{t-1}, identity at t == 0
  if (g.t >= 1) {
#pragma unroll
    for (int k = 0; k < 9; ++k) ex.a[k] = sm[k * stride + me - g.L];
  }
  __syncthreads();
#pragma unroll
  for (int gi = 0; gi < 2; ++gi) {
    T q0 = ex.a[0 + gi], q1 = ex.a[3 + gi], q2 = ex.a[6 + gi];
    if constexpr (HAS_PULSE) {
      pulse_cols(q0, q1, q2, pu0, 0);
      pulse_cols(q0, q1, q2, pu1, 1);
    }
    pin[3 * gi + 0] = q0;
    pin[3 * gi + 1] = q1;
    pin[3 * gi + 2] = q2;
    pa[3 * gi + 0] = c.a[0 + gi];
    pa[3 * gi + 1] = c.a[3 + gi];
    pa[3 * gi + 2] = c.a[6 + gi];
  }
}

// One interval's solve from the entry state pin and warm start (x0, x1)
// (stretched units); returns unstretched rates.
template <typename T, bool CPFIT, bool STATIC_NO_MIG>
__device__ void solve(const T (&pin)[6], T Tt, T lh0, T lh1, T mu0s, T mu1s, bool no_mig,
                      T x0, T x1, int n_iters, T mixture_th, int max_sq, T& lc0, T& lc1) {
  Ctx<T> c;
  c.max_sq = max_sq;
  c.mu0s = mu0s;
  c.mu1s = mu1s;
  c.p00 = pin[0];
  c.p01 = pin[1];
  c.p02 = pin[2];
  c.p10 = pin[3];
  c.p11 = pin[4];
  c.p12 = pin[5];
  c.s0 = c.p00 + c.p01 + c.p02;
  c.s1 = c.p10 + c.p11 + c.p12;
  c.pn00 = c.p00 / c.s0;
  c.pn01 = c.p01 / c.s0;
  c.pn02 = c.p02 / c.s0;
  c.pn10 = c.p10 / c.s1;
  c.pn11 = c.p11 / c.s1;
  c.pn12 = c.p12 / c.s1;
  T nv0 = m_sqrt(c.p00 * c.p00 + c.p01 * c.p01 + c.p02 * c.p02);
  T nv1 = m_sqrt(c.p10 * c.p10 + c.p11 * c.p11 + c.p12 * c.p12);
  T e0 = c.p00 - c.p10, e1 = c.p01 - c.p11, e2 = c.p02 - c.p12;
  T nd = m_sqrt(e0 * e0 + e1 * e1 + e2 * e2);
  bool merge = nd < T(0.02) * jmin(nv0, nv1);
  T lh_raw_s0 = lh0 * Tt, lh_raw_s1 = lh1 * Tt;
  T lh_mid = T(0.5) * (lh0 + lh1) * Tt;
  T lh_s0 = merge ? lh_mid : lh_raw_s0;
  T lh_s1 = merge ? lh_mid : lh_raw_s1;

  if constexpr (CPFIT) {
    // no-migration closed form (CorrectLambda.py:213-235), unstretched
    T det = c.pn00 * c.pn11 - c.pn01 * c.pn10;
    if (det == T(0)) det = T(1.0);
    T em0 = em1m<T, T>(lh0 * Tt);
    T em1v = em1m<T, T>(lh1 * Tt);
    T dy1 = (c.pn01 * em1v - c.pn11 * em0) / det;
    T dy2 = (c.pn10 * em0 - c.pn00 * em1v) / det;
    bool good = (dy1 > T(-1.0)) && (dy2 > T(-1.0));
    lc0 = good ? -log1p_c(dy1) / Tt : T(-1.0);
    lc1 = good ? -log1p_c(dy2) / Tt : T(-1.0);
    if (!STATIC_NO_MIG && !no_mig) {
      c.em_s0 = em1m<T, T>(lh_s0);
      c.em_s1 = em1m<T, T>(lh_s1);
      lm2<RES_CP, T>(c, x0, x1, n_iters, T(-INFINITY), T(-INFINITY));
      lc0 = x0 / Tt;
      lc1 = x1 / Tt;
    }
  } else {
    c.ect_raw0 = ect_dev(lh_raw_s0);
    c.ect_raw1 = ect_dev(lh_raw_s1);
    T lower_nm = T(0.01) * jmin(lh_raw_s0, lh_raw_s1);
    if (STATIC_NO_MIG || no_mig) {
      lm2<RES_NOMIG, T>(c, x0, x1, n_iters, lower_nm, lower_nm);
    } else {
      c.ect_s0 = ect_dev(lh_s0);
      c.ect_s1 = ect_dev(lh_s1);
      lm2<RES_ECT, T>(c, x0, x1, n_iters, T(-INFINITY), T(-INFINITY));
    }
    lc0 = x0 / Tt;
    lc1 = x1 / Tt;
  }
  if (mixture_th > T(0)) {
    T f0 = c.pn00 - c.pn10, f1 = c.pn01 - c.pn11, f2 = c.pn02 - c.pn12;
    if (m_sqrt(f0 * f0 + f1 * f1 + f2 * f2) < mixture_th) {
      lc0 = T(-1.0);
      lc1 = T(-1.0);
    }
  }
  // zero-length (padding) intervals: lc = 1, an exact no-op in the chain
  if (Tt == T(0)) {
    lc0 = T(1.0);
    lc1 = T(1.0);
  }
}

template <typename T, bool CPFIT, bool STATIC_NO_MIG, bool HAS_PULSE>
__global__ void __launch_bounds__(kMaxThreads)
sweep_kernel(const T* __restrict__ inp, T* __restrict__ out, int s, int B, int L,
             T mixture_th, int rounds, int iters0, int iters_warm, int max_sq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);  // [9][s][L]
  Geometry g;
  g.s = s;
  g.B = B;
  g.L = L;
  g.ll = threadIdx.x % L;
  g.t = threadIdx.x / L;
  g.lane = blockIdx.x * L + g.ll;
  const bool live = g.lane < B;
  const int b = live ? g.lane : B - 1;  // ragged last block: duplicate a lane
  const size_t plane = (size_t)s * B;
  const size_t idx = (size_t)g.t * B + b;
  const T Tt = inp[idx];
  const T lh0 = inp[plane + idx];
  const T lh1 = inp[2 * plane + idx];
  const T mi0 = inp[3 * plane + idx];
  const T mi1 = inp[4 * plane + idx];
  const T pu0 = HAS_PULSE ? inp[5 * plane + idx] : T(0);
  const T pu1 = HAS_PULSE ? inp[6 * plane + idx] : T(0);
  const T mu0s = mi0 * Tt, mu1s = mi1 * Tt;
  const bool no_mig = (mi0 + mi1) < T(1e-10);

  T pin[6], pa[6], lc0, lc1;
  T x0 = lh0 * Tt, x1 = lh1 * Tt;
  chain<T, HAS_PULSE>(g, sm, x0, x1, mu0s, mu1s, pu0, pu1, max_sq, pin, pa);
  solve<T, CPFIT, STATIC_NO_MIG>(pin, Tt, lh0, lh1, mu0s, mu1s, no_mig, x0, x1, iters0,
                                 mixture_th, max_sq, lc0, lc1);
  for (int r = 1; r < rounds; ++r) {
    x0 = lc0 * Tt;
    x1 = lc1 * Tt;
    chain<T, HAS_PULSE>(g, sm, x0, x1, mu0s, mu1s, pu0, pu1, max_sq, pin, pa);
    solve<T, CPFIT, STATIC_NO_MIG>(pin, Tt, lh0, lh1, mu0s, mu1s, no_mig, x0, x1,
                                   iters_warm, mixture_th, max_sq, lc0, lc1);
  }
  chain<T, HAS_PULSE>(g, sm, lc0 * Tt, lc1 * Tt, mu0s, mu1s, pu0, pu1, max_sq, pin, pa);
  if (live) {
    out[idx] = lc0;
    out[plane + idx] = lc1;
#pragma unroll
    for (int k = 0; k < 6; ++k) out[(2 + k) * plane + idx] = pa[k];
  }
}

template <typename T, bool CPFIT, bool SNM, bool PULSE>
cudaError_t launch(const T* inp, T* out, int s, int B, T mth, int rounds, int iters0,
                   int iters_warm, int max_sq, cudaStream_t stream) {
  int L = 1;
  while (L * 2 * s <= kMaxThreads && L * 2 <= 32) L *= 2;
  dim3 block(L * s), grid((B + L - 1) / L);
  size_t shm = 9 * (size_t)s * L * sizeof(T);
  sweep_kernel<T, CPFIT, SNM, PULSE><<<grid, block, shm, stream>>>(
      inp, out, s, B, L, mth, rounds, iters0, iters_warm, max_sq);
  return cudaGetLastError();
}

double factorial(int k) {
  double f = 1.0;
  for (int i = 2; i <= k; ++i) f *= i;
  return f;
}

// the Taylor tables go to each device's constant bank once per process
cudaError_t upload_coeffs() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  Coeffs h;
  for (int k = 0; k < 19; ++k) {
    h.ce[k] = 1.0 / factorial(k);
    h.c1[k] = 1.0 / factorial(k + 1);
    h.cphi[k] = k == 0 ? 0.0 : 1.0 / factorial(k);
    h.cj[k] = k == 0 ? 0.0 : k / (2.0 * factorial(k + 2));
  }
  err = cudaMemcpyToSymbol(kC, &h, sizeof(Coeffs));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

}  // namespace

// C entry point: inp (7, s, B) and out (8, s, B) device pointers of
// MISTI_T, launched on `stream`.  Returns the CUDA error code (0 = launched).
extern "C" int misti_correction_sweep(const void* inp, void* out, int s, int B,
                                      int static_no_mig, int has_pulse,
                                      double mixture_th, int rounds, int iters0,
                                      int iters_warm, int max_squarings, void* stream) {
  using T = MISTI_T;
  constexpr bool CP = MISTI_CPFIT != 0;
  if (s < 1 || s > kMaxThreads || B < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = upload_coeffs();
  if (err != cudaSuccess) return (int)err;
  const T* in = static_cast<const T*>(inp);
  T* o = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T mth = (T)mixture_th;
  if (static_no_mig && has_pulse)
    err = launch<T, CP, true, true>(in, o, s, B, mth, rounds, iters0, iters_warm, max_squarings, st);
  else if (static_no_mig)
    err = launch<T, CP, true, false>(in, o, s, B, mth, rounds, iters0, iters_warm, max_squarings, st);
  else if (has_pulse)
    err = launch<T, CP, false, true>(in, o, s, B, mth, rounds, iters0, iters_warm, max_squarings, st);
  else
    err = launch<T, CP, false, false>(in, o, s, B, mth, rounds, iters0, iters_warm, max_squarings, st);
  return (int)err;
}
