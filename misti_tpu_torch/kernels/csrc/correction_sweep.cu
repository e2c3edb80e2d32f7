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
// outputs per interval (120 bytes) but spends thousands of dependent 3x3
// flops per LM iteration, so the card's FP64 non-tensor rate and the
// latency of the dependent chains set the time, not HBM.
// What the design does about it:
//   * one thread per (interval, lane): the expm and LM work of a round is
//     independent across intervals, so 28 intervals x 4096 lanes give
//     ~115k threads of straight-line register arithmetic;
//   * a block holds L lanes x all s intervals (L a power of two, L*s <= 256);
//     each round the 3x3 interval propagators go to shared memory once and
//     the ordered product C_t = G_t ... G_0 is formed by the same
//     Hillis-Steele doubling as the JAX kernel (log2(s) steps), so the
//     association order is the plain version's;
//   * the LM Jacobian comes from dual numbers: the residual code is written
//     once, generic over the scalar type, and instantiated on T for the
//     chain and on Dual<T, N> for the residuals (what jax.linearize shared
//     in the TPU kernel);
//   * registers set the occupancy, so the live set is kept small: the
//     degree-18 Taylor series is evaluated by Paterson-Stockmeyer in base
//     b^3 (three powers live) with each block formed where the outer Horner
//     step adds it, the Taylor tables are constants of type T, the ECT
//     moments are formed one series at a time (E - I only where a doubling
//     needs it), and the residual's inputs and the interval's rates sit in
//     shared memory;
//   * a thread leaves its LM loop once converged; every update after
//     convergence was masked in the TPU kernel, so the numbers are the same.
// Built with FMA contraction (nvcc's default): the products contract to
// fused multiply-adds, so the kernel matches its plain version to a
// tolerance (rtol 1e-6 / atol 1e-9, chip_smoke.py), not bitwise; the
// operation order is the plain version's.
//
// Layout: inp (7, s, B) = T, lh0, lh1, mi0, mi1, pu0, pu1; out (8, s, B) =
// lc0, lc1, p_after (2 genomes x 3 states); the lane index is fastest.
// Float64 only: every path gives it the likelihood's float64 tables
// (config.LLH_DTYPE).  Compile-time variants: residual mode (cpfit or
// expected coalescence time, -DMISTI_CPFIT), and inside each library the
// template flags STATIC_NO_MIG and HAS_PULSE.

#include <cuda_runtime.h>
#include <math.h>

#ifndef MISTI_CPFIT
#define MISTI_CPFIT 1
#endif

namespace {

constexpr int kMaxThreads = 256;
constexpr int kDeg = 18;             // Taylor degree of every series
constexpr int kPS = 3;               // Paterson-Stockmeyer base
constexpr int kTangents = 2;  // tangent components per residual pass
constexpr int kMinBlocks = 1;  // resident blocks per SM the registers are set for
static_assert(kDeg % kPS == 0, "the Paterson-Stockmeyer base must divide the degree");

// ---------------------------------------------------------------- scalars

__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ double m_log2(double x) { return log2(x); }
__device__ __forceinline__ double m_exp2(double x) { return exp2(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ double m_ceil(double x) { return ceil(x); }
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

// v + sum_i d[i] e_i: a value and N forward-mode tangent components.  Each
// component is computed apart from the others, so one pass with N = 2 and
// two passes with N = 1 give the same numbers.
template <typename T, int N>
struct Dual {
  T v, d[N];
  __device__ Dual() {}
  __device__ Dual(T x) : v(x) {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = T(0);
  }
};

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator+(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> o;
  o.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) o.d[i] = a.d[i] + b.d[i];
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> o;
  o.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) o.d[i] = a.d[i] - b.d[i];
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a) {
  Dual<T, N> o;
  o.v = -a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) o.d[i] = -a.d[i];
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator*(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> o;
  o.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) o.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator/(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> o;
  o.v = a.v / b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) o.d[i] = (a.d[i] - o.v * b.d[i]) / b.v;
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator+(const Dual<T, N>& a, T b) {
  Dual<T, N> o = a;
  o.v = a.v + b;
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator+(T a, const Dual<T, N>& b) {
  Dual<T, N> o = b;
  o.v = a + b.v;
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a, T b) {
  Dual<T, N> o = a;
  o.v = a.v - b;
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(T a, const Dual<T, N>& b) {
  Dual<T, N> o = -b;
  o.v = a - b.v;
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator*(const Dual<T, N>& a, T b) {
  Dual<T, N> o;
  o.v = a.v * b;
#pragma unroll
  for (int i = 0; i < N; ++i) o.d[i] = a.d[i] * b;
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator*(T a, const Dual<T, N>& b) {
  Dual<T, N> o;
  o.v = a * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) o.d[i] = a * b.d[i];
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator/(const Dual<T, N>& a, T b) {
  Dual<T, N> o;
  o.v = a.v / b;
#pragma unroll
  for (int i = 0; i < N; ++i) o.d[i] = a.d[i] / b;
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator/(T a, const Dual<T, N>& b) {
  Dual<T, N> o;
  o.v = a / b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) o.d[i] = (-o.v * b.d[i]) / b.v;
  return o;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> m_exp(const Dual<T, N>& a) {
  Dual<T, N> o;
  o.v = m_exp(a.v);
#pragma unroll
  for (int i = 0; i < N; ++i) o.d[i] = o.v * a.d[i];
  return o;
}

template <typename T> struct Val { __device__ static T get(T x) { return x; } };
template <typename T, int N> struct Val<Dual<T, N>> {
  __device__ static T get(const Dual<T, N>& x) { return x.v; }
};
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

// Taylor coefficients, computed in double and rounded to T once, as the
// plain version's python floats are: e^b, phi1(b) = (e^b - I)/b, E - I,
// centred moment J.
enum { SER_E = 0, SER_1 = 1, SER_PHI = 2, SER_J = 3 };

__host__ __device__ constexpr double factorial(int k) { return k < 2 ? 1.0 : factorial(k - 1) * k; }

struct Taylor {
  double c[4][kDeg + 1];
};

__host__ __device__ constexpr Taylor taylor_tables() {
  Taylor t{};
  for (int k = 0; k <= kDeg; ++k) {
    t.c[SER_E][k] = 1.0 / factorial(k);
    t.c[SER_1][k] = 1.0 / factorial(k + 1);
    t.c[SER_PHI][k] = k == 0 ? 0.0 : 1.0 / factorial(k);
    t.c[SER_J][k] = k == 0 ? 0.0 : k / (2.0 * factorial(k + 2));
  }
  return t;
}

__constant__ Taylor kTaylor = taylor_tables();

// Paterson-Stockmeyer powers b^1 .. b^kPS (b^0 = I is implicit below)
template <typename S>
__device__ __forceinline__ void ps_powers(const M3<S>& b, M3<S> (&p)[kPS + 1]) {
  p[1] = b;
#pragma unroll
  for (int k = 2; k <= kPS; ++k) p[k] = m3_mul(p[k - 1], b);
}

// entry k of the block sum_{j < kPS} c[k0 + j] b^j
template <typename S, typename T, int SER>
__device__ __forceinline__ S ps_block(const M3<S> (&p)[kPS + 1], int k0, int k) {
  S o = T(kTaylor.c[SER][k0]) * S(T((k % 4) == 0 ? 1 : 0));
#pragma unroll
  for (int j = 1; j < kPS; ++j) o = o + T(kTaylor.c[SER][k0 + j]) * p[j].a[k];
  return o;
}

// sum_k c[k] b^k (k <= kDeg) in base b^kPS, outer Horner from the top block;
// each block is formed where its step adds it, so only the powers, the
// running sum and one product are live
template <typename S, typename T, int SER>
__device__ __forceinline__ M3<S> ps_horner(const M3<S> (&p)[kPS + 1]) {
  M3<S> acc;
#pragma unroll
  for (int k = 0; k < 9; ++k)
    acc.a[k] = ps_block<S, T, SER>(p, kDeg - kPS, k) + T(kTaylor.c[SER][kDeg]) * p[kPS].a[k];
#pragma unroll
  for (int q = kDeg / kPS - 2; q >= 0; --q) {
    M3<S> t = m3_mul(p[kPS], acc);
#pragma unroll
    for (int k = 0; k < 9; ++k) acc.a[k] = ps_block<S, T, SER>(p, kPS * q, k) + t.a[k];
  }
  return acc;
}

template <typename S, typename T>
__device__ __forceinline__ M3<S> expm3(const M3<S>& a, int max_sq) {
  int ns;
  T sc;
  scaling<S, T>(a, max_sq, ns, sc);
  M3<S> p[kPS + 1];
  ps_powers(m3_scale(a, sc), p);
  M3<S> e = ps_horner<S, T, SER_E>(p);
  for (int i = 0; i < ns; ++i) e = m3_mul(e, e);
  return e;
}

// Phi = e^a - I without cancellation: Phi(2h) = Phi^2 + 2 Phi
template <typename S, typename T>
__device__ __forceinline__ M3<S> expm3_m1(const M3<S>& a, int max_sq) {
  int ns;
  T sc;
  scaling<S, T>(a, max_sq, ns, sc);
  M3<S> p[kPS + 1];
  ps_powers(m3_scale(a, sc), p);
  M3<S> phi = ps_horner<S, T, SER_PHI>(p);
  for (int i = 0; i < ns; ++i) {
    M3<S> sq = m3_mul(phi, phi);
#pragma unroll
    for (int k = 0; k < 9; ++k) phi.a[k] = sq.a[k] + T(2.0) * phi.a[k];
  }
  return phi;
}

// (N1, J) of the stretched generator: N1 = int_0^1 e^{as} ds and the
// centred first moment J = int_0^1 (s - 1/2) e^{as} ds.  One series at a
// time; Phi = E - I only where a doubling step needs it.
template <typename S, typename T>
__device__ __forceinline__ void expm3_nc_moments(const M3<S>& a, int max_sq, M3<S>& n1, M3<S>& j) {
  int ns;
  T h;
  scaling<S, T>(a, max_sq, ns, h);
  M3<S> p[kPS + 1];
  ps_powers(m3_scale(a, h), p);
  {
    M3<S> jr = ps_horner<S, T, SER_J>(p);
#pragma unroll
    for (int k = 0; k < 9; ++k) j.a[k] = (h * h) * jr.a[k];
  }
  {
    M3<S> phi1 = ps_horner<S, T, SER_1>(p);
#pragma unroll
    for (int k = 0; k < 9; ++k) n1.a[k] = h * phi1.a[k];
  }
  if (ns == 0) return;
  M3<S> phim = ps_horner<S, T, SER_PHI>(p);
  for (int i = 0; i < ns; ++i) {
    {
      M3<S> tmp = m3_mul(phim, n1);
      M3<S> pj = m3_mul(phim, j);
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        j.a[k] = T(2.0) * j.a[k] + pj.a[k] + (T(0.5) * h) * tmp.a[k];
        n1.a[k] = T(2.0) * n1.a[k] + tmp.a[k];
      }
    }
    M3<S> pp = m3_mul(phim, phim);
#pragma unroll
    for (int k = 0; k < 9; ++k) phim.a[k] = pp.a[k] + T(2.0) * phim.a[k];
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

// A thread's rarely read state lives in shared memory, one column per
// thread, read through a volatile pointer where it is used, so it holds no
// registers across the LM iterations: the residual's inputs (cpfit reads the
// entry state p, the others its normalised pn; the targets are cpfit's
// s * em1m(lh T) or ECT's ect_dev), the stretched migration rates, and the
// interval's length, rates and pulses.
enum { F_Q00, F_Q01, F_Q02, F_Q10, F_Q11, F_Q12, F_T0, F_T1, F_MU0, F_MU1,
       F_TT, F_LH0, F_LH1, F_PU0, F_PU1, kCold };

__device__ __forceinline__ double lds(unsigned a, double) {
  double v;
  asm volatile("ld.shared.f64 %0, [%1];" : "=d"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts(unsigned a, double v) {
  asm volatile("st.shared.f64 [%0], %1;" ::"r"(a), "d"(v) : "memory");
}

template <typename T>
struct Ctx {
  unsigned col;   // shared address of this thread's field 0
  unsigned step;  // bytes between fields
  int max_sq;
  __device__ T operator[](int f) const { return lds(col + f * step, T()); }
  __device__ void set(int f, T v) const { sts(col + f * step, v); }
};

// cpfit: no-coalescence masses as deviations from the total mass
template <typename S, typename T>
__device__ __forceinline__ void res_cp(const Ctx<T>& c, const S& a0, const S& a1, S& r0, S& r1) {
  M3<S> phi = expm3_m1<S, T>(corr_mat<S, T>(a0, a1, c[F_MU0], c[F_MU1]), c.max_sq);
  S cs0 = phi.a[0] + phi.a[3] + phi.a[6];
  S cs1 = phi.a[1] + phi.a[4] + phi.a[7];
  S cs2 = phi.a[2] + phi.a[5] + phi.a[8];
  r0 = cs0 * c[F_Q00] + cs1 * c[F_Q01] + cs2 * c[F_Q02] + S(c[F_T0]);
  r1 = cs0 * c[F_Q10] + cs1 * c[F_Q11] + cs2 * c[F_Q12] + S(c[F_T1]);
}

// expected coalescence time with migration: conditional mean minus its
// T/2 baseline, 1 - pnc == a0 (N1 p)_0 + a1 (N1 p)_1
template <typename S, typename T>
__device__ __forceinline__ void res_ect(const Ctx<T>& c, const S& a0, const S& a1, S& r0, S& r1) {
  M3<S> n1, jm;
  expm3_nc_moments<S, T>(corr_mat<S, T>(a0, a1, c[F_MU0], c[F_MU1]), c.max_sq, n1, jm);
  const T q00 = c[F_Q00], q01 = c[F_Q01], q02 = c[F_Q02];
  const T q10 = c[F_Q10], q11 = c[F_Q11], q12 = c[F_Q12];
  S n1p00 = n1.a[0] * q00 + n1.a[1] * q01 + n1.a[2] * q02;
  S n1p01 = n1.a[3] * q00 + n1.a[4] * q01 + n1.a[5] * q02;
  S n1p10 = n1.a[0] * q10 + n1.a[1] * q11 + n1.a[2] * q12;
  S n1p11 = n1.a[3] * q10 + n1.a[4] * q11 + n1.a[5] * q12;
  S jp00 = jm.a[0] * q00 + jm.a[1] * q01 + jm.a[2] * q02;
  S jp01 = jm.a[3] * q00 + jm.a[4] * q01 + jm.a[5] * q02;
  S jp10 = jm.a[0] * q10 + jm.a[1] * q11 + jm.a[2] * q12;
  S jp11 = jm.a[3] * q10 + jm.a[4] * q11 + jm.a[5] * q12;
  S den0 = a0 * n1p00 + a1 * n1p01;
  S den1 = a0 * n1p10 + a1 * n1p11;
  S t2_0 = (a0 * jp00 + a1 * jp01) / den0;
  S t2_1 = (a0 * jp10 + a1 * jp11) / den1;
  r0 = t2_0 - c[F_T0];
  r1 = t2_1 - c[F_T1];
}

// expected coalescence time without migration
template <typename S, typename T>
__device__ __forceinline__ void res_nomig(const Ctx<T>& c, const S& a0, const S& a1, S& r0, S& r1) {
  S d0 = em1m<S, T>(a0);
  S d1 = em1m<S, T>(a1);
  S q0 = ectnc_dev<S, T>(a0);
  S q1 = ectnc_dev<S, T>(a1);
  const T q00 = c[F_Q00], q01 = c[F_Q01], q10 = c[F_Q10], q11 = c[F_Q11];
  S den0 = q00 * d0 + q01 * d1;
  S den1 = q10 * d0 + q11 * d1;
  S ct0 = (q00 * q0 + q01 * q1) / den0;
  S ct1 = (q10 * q0 + q11 * q1) / den1;
  r0 = ct0 - c[F_T0];
  r1 = ct1 - c[F_T1];
}

enum { RES_CP = 0, RES_ECT = 1, RES_NOMIG = 2 };

template <int MODE, typename S, typename T>
__device__ __forceinline__ void residual(const Ctx<T>& c, const S& a0, const S& a1, S& r0, S& r1) {
  if constexpr (MODE == RES_CP) res_cp<S, T>(c, a0, a1, r0, r1);
  if constexpr (MODE == RES_ECT) res_ect<S, T>(c, a0, a1, r0, r1);
  if constexpr (MODE == RES_NOMIG) res_nomig<S, T>(c, a0, a1, r0, r1);
}

// residual and 2x2 Jacobian by forward mode: column k of the Jacobian is
// the tangent along x_k, kTangents of them a pass
template <int MODE, typename T>
__device__ __forceinline__ void lin_at(const Ctx<T>& c, T x0, T x1, T& r0, T& r1, T& j00,
                                       T& j10, T& j01, T& j11) {
  using S = Dual<T, kTangents>;
#pragma unroll 1
  for (int k0 = 0; k0 < 2; k0 += kTangents) {
    S a0(x0), a1(x1), o0, o1;
#pragma unroll
    for (int i = 0; i < kTangents; ++i) {
      a0.d[i] = T(k0 + i == 0 ? 1 : 0);
      a1.d[i] = T(k0 + i == 1 ? 1 : 0);
    }
    residual<MODE, S, T>(c, a0, a1, o0, o1);
    r0 = o0.v;
    r1 = o1.v;
#pragma unroll
    for (int i = 0; i < kTangents; ++i) {
      if (k0 + i == 0) {
        j00 = o0.d[i];
        j10 = o1.d[i];
      } else {
        j01 = o0.d[i];
        j11 = o1.d[i];
      }
    }
  }
}

// Fixed-budget 2-unknown Levenberg-Marquardt (damping 1e-3 with x0.25/x4,
// trust region x2/x0.5, accept on decrease); leaves the loop once converged
template <int MODE, typename T>
__device__ __forceinline__ void lm2(const Ctx<T>& c, T& x0, T& x1, int n_iters, T lower0, T lower1) {
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
__device__ __forceinline__ void chain(const Geometry& g, T* sm, const Ctx<T>& cx, T x0s, T x1s,
                                      T (&pin)[6], T (&pa)[6]) {
  M3<T> gm = expm3<T, T>(corr_mat<T, T>(x0s, x1s, cx[F_MU0], cx[F_MU1]), cx.max_sq);
  if constexpr (HAS_PULSE) {
    // pulses act before the exponential: P = PU1 @ PU0, column by column
    const T pu0 = cx[F_PU0], pu1 = cx[F_PU1];
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
      pulse_cols(q0, q1, q2, cx[F_PU0], 0);
      pulse_cols(q0, q1, q2, cx[F_PU1], 1);
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
__device__ __forceinline__ void solve(const T (&pin)[6], const Ctx<T>& c, bool no_mig, T x0, T x1,
                                      int n_iters, T mixture_th, T& lc0, T& lc1) {
  const T Tt = c[F_TT], lh0 = c[F_LH0], lh1 = c[F_LH1];
  const T p00 = pin[0], p01 = pin[1], p02 = pin[2];
  const T p10 = pin[3], p11 = pin[4], p12 = pin[5];
  const T s0 = p00 + p01 + p02;
  const T s1 = p10 + p11 + p12;
  const T pn00 = p00 / s0, pn01 = p01 / s0, pn02 = p02 / s0;
  const T pn10 = p10 / s1, pn11 = p11 / s1, pn12 = p12 / s1;
  T nv0 = m_sqrt(p00 * p00 + p01 * p01 + p02 * p02);
  T nv1 = m_sqrt(p10 * p10 + p11 * p11 + p12 * p12);
  T e0 = p00 - p10, e1 = p01 - p11, e2 = p02 - p12;
  T nd = m_sqrt(e0 * e0 + e1 * e1 + e2 * e2);
  bool merge = nd < T(0.02) * jmin(nv0, nv1);
  T lh_raw_s0 = lh0 * Tt, lh_raw_s1 = lh1 * Tt;
  T lh_mid = T(0.5) * (lh0 + lh1) * Tt;
  T lh_s0 = merge ? lh_mid : lh_raw_s0;
  T lh_s1 = merge ? lh_mid : lh_raw_s1;
  // the mixture bail-out, decided before the solve so pn need not stay live
  bool bail = false;
  if (mixture_th > T(0)) {
    T f0 = pn00 - pn10, f1 = pn01 - pn11, f2 = pn02 - pn12;
    bail = m_sqrt(f0 * f0 + f1 * f1 + f2 * f2) < mixture_th;
  }

  if constexpr (CPFIT) {
    // no-migration closed form (CorrectLambda.py:213-235), unstretched
    T det = pn00 * pn11 - pn01 * pn10;
    if (det == T(0)) det = T(1.0);
    T em0 = em1m<T, T>(lh0 * Tt);
    T em1v = em1m<T, T>(lh1 * Tt);
    T dy1 = (pn01 * em1v - pn11 * em0) / det;
    T dy2 = (pn10 * em0 - pn00 * em1v) / det;
    bool good = (dy1 > T(-1.0)) && (dy2 > T(-1.0));
    lc0 = good ? -log1p_c(dy1) / Tt : T(-1.0);
    lc1 = good ? -log1p_c(dy2) / Tt : T(-1.0);
    if (!STATIC_NO_MIG && !no_mig) {
      c.set(F_Q00, p00);
      c.set(F_Q01, p01);
      c.set(F_Q02, p02);
      c.set(F_Q10, p10);
      c.set(F_Q11, p11);
      c.set(F_Q12, p12);
      c.set(F_T0, s0 * em1m<T, T>(lh_s0));
      c.set(F_T1, s1 * em1m<T, T>(lh_s1));
      lm2<RES_CP, T>(c, x0, x1, n_iters, T(-INFINITY), T(-INFINITY));
      lc0 = x0 / c[F_TT];
      lc1 = x1 / c[F_TT];
    }
  } else {
    c.set(F_Q00, pn00);
    c.set(F_Q01, pn01);
    c.set(F_Q02, pn02);
    c.set(F_Q10, pn10);
    c.set(F_Q11, pn11);
    c.set(F_Q12, pn12);
    if (STATIC_NO_MIG || no_mig) {
      c.set(F_T0, ect_dev(lh_raw_s0));
      c.set(F_T1, ect_dev(lh_raw_s1));
      T lower_nm = T(0.01) * jmin(lh_raw_s0, lh_raw_s1);
      lm2<RES_NOMIG, T>(c, x0, x1, n_iters, lower_nm, lower_nm);
    } else {
      c.set(F_T0, ect_dev(lh_s0));
      c.set(F_T1, ect_dev(lh_s1));
      lm2<RES_ECT, T>(c, x0, x1, n_iters, T(-INFINITY), T(-INFINITY));
    }
    lc0 = x0 / c[F_TT];
    lc1 = x1 / c[F_TT];
  }
  if (bail) {
    lc0 = T(-1.0);
    lc1 = T(-1.0);
  }
  // zero-length (padding) intervals: lc = 1, an exact no-op in the chain
  if (c[F_TT] == T(0)) {
    lc0 = T(1.0);
    lc1 = T(1.0);
  }
}

template <typename T, bool CPFIT, bool STATIC_NO_MIG, bool HAS_PULSE>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
sweep_kernel(const T* __restrict__ inp, T* __restrict__ out, int s, int B, int L,
             T mixture_th, int rounds, int iters0, int iters_warm, int max_sq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);  // scan [9][s][L], then the cold state [kCold][s][L]
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
  Ctx<T> cx;
  cx.step = s * L * sizeof(T);
  cx.col = (unsigned)__cvta_generic_to_shared(sm + 9 * s * L + threadIdx.x);
  cx.max_sq = max_sq;
  const T Tt = inp[idx];
  const T lh0 = inp[plane + idx];
  const T lh1 = inp[2 * plane + idx];
  const T mi0 = inp[3 * plane + idx];
  const T mi1 = inp[4 * plane + idx];
  cx.set(F_TT, Tt);
  cx.set(F_LH0, lh0);
  cx.set(F_LH1, lh1);
  cx.set(F_MU0, mi0 * Tt);
  cx.set(F_MU1, mi1 * Tt);
  if (HAS_PULSE) {
    cx.set(F_PU0, inp[5 * plane + idx]);
    cx.set(F_PU1, inp[6 * plane + idx]);
  }
  const bool no_mig = (mi0 + mi1) < T(1e-10);

  T pin[6], pa[6], lc0, lc1;
  T x0 = lh0 * Tt, x1 = lh1 * Tt;
  chain<T, HAS_PULSE>(g, sm, cx, x0, x1, pin, pa);
  solve<T, CPFIT, STATIC_NO_MIG>(pin, cx, no_mig, x0, x1, iters0, mixture_th, lc0, lc1);
  for (int r = 1; r < rounds; ++r) {
    x0 = lc0 * cx[F_TT];
    x1 = lc1 * cx[F_TT];
    chain<T, HAS_PULSE>(g, sm, cx, x0, x1, pin, pa);
    solve<T, CPFIT, STATIC_NO_MIG>(pin, cx, no_mig, x0, x1, iters_warm, mixture_th, lc0, lc1);
  }
  chain<T, HAS_PULSE>(g, sm, cx, lc0 * cx[F_TT], lc1 * cx[F_TT], pin, pa);
  if (live) {
    out[idx] = lc0;
    out[plane + idx] = lc1;
#pragma unroll
    for (int k = 0; k < 6; ++k) out[(2 + k) * plane + idx] = pa[k];
  }
}

// lanes per block: a power of two, at most 32, with L * s <= kMaxThreads
int lanes_per_block(int s) {
  int L = 1;
  while (L * 2 * s <= kMaxThreads && L * 2 <= 32) L *= 2;
  return L;
}

template <typename T>
size_t smem_bytes(int s, int L) { return (9 + kCold) * (size_t)s * L * sizeof(T); }

template <typename T, bool CPFIT, bool SNM, bool PULSE>
cudaError_t launch(const T* inp, T* out, int s, int B, T mth, int rounds, int iters0,
                   int iters_warm, int max_sq, cudaStream_t stream) {
  const int L = lanes_per_block(s);
  dim3 block(L * s), grid((B + L - 1) / L);
  sweep_kernel<T, CPFIT, SNM, PULSE><<<grid, block, smem_bytes<T>(s, L), stream>>>(
      inp, out, s, B, L, mth, rounds, iters0, iters_warm, max_sq);
  return cudaGetLastError();
}

// registers, local (spill) bytes and resident blocks per SM of one instance
template <typename T, bool CPFIT, bool SNM, bool PULSE>
cudaError_t attrs(int s, int* o) {
  auto fn = sweep_kernel<T, CPFIT, SNM, PULSE>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return err;
  const int L = lanes_per_block(s);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, L * s, smem_bytes<T>(s, L));
  o[0] = SNM;
  o[1] = PULSE;
  o[2] = fa.numRegs;
  o[3] = (int)fa.localSizeBytes;
  o[4] = blocks;
  return err;
}

}  // namespace

// C entry point: inp (7, s, B) and out (8, s, B) device pointers of
// double, launched on `stream`.  Returns the CUDA error code (0 = launched).
extern "C" int misti_correction_sweep(const void* inp, void* out, int s, int B,
                                      int static_no_mig, int has_pulse,
                                      double mixture_th, int rounds, int iters0,
                                      int iters_warm, int max_squarings, void* stream) {
  using T = double;
  constexpr bool CP = MISTI_CPFIT != 0;
  if (s < 1 || s > kMaxThreads || B < 1) return (int)cudaErrorInvalidValue;
  const T* in = static_cast<const T*>(inp);
  T* o = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T mth = (T)mixture_th;
  cudaError_t err;
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

// Per template instance (static_no_mig, has_pulse) = (0,0), (0,1), (1,0),
// (1,1): out[5 i .. 5 i + 4] = static_no_mig, has_pulse, registers per
// thread, local memory bytes per thread, resident blocks per SM at the
// launch's block size and shared memory for s intervals.
extern "C" int misti_correction_sweep_attrs(int s, int* out) {
  using T = double;
  constexpr bool CP = MISTI_CPFIT != 0;
  if (s < 1 || s > kMaxThreads) return (int)cudaErrorInvalidValue;
  cudaError_t err = attrs<T, CP, false, false>(s, out);
  if (err == cudaSuccess) err = attrs<T, CP, false, true>(s, out + 5);
  if (err == cudaSuccess) err = attrs<T, CP, true, false>(s, out + 10);
  if (err == cudaSuccess) err = attrs<T, CP, true, true>(s, out + 15);
  return (int)err;
}
