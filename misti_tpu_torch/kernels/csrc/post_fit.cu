// The likelihood's post-split fit, for Hopper (sm_90a): every lane's
// post-split single-population rates and final carry in one launch.
// Float64 only: the likelihood's dtype (config.LLH_DTYPE).
//
// For lane b with pre-split carry nc[b] (the two genomes' log no-coalescence
// masses) and post-split intervals t < n of length T[t] and rates lh[t, :]
// (per lane, or one table for every lane: a lane stride of 0), it returns
// lc[b, t, :] (both genomes' rate, the same value) and the final carry
// nc_fin[b, :] = nc[b, :] - sum_t T[t] lc[b, t].  A T == 0 row gets lc = 1
// and leaves the carry as it is (the reference's rule,
// MigrationInference.py:357-359).  Two residual modes:
// * cpfit: the closed form of MigrationInference.py:366 in deviation form,
//   row by row, each row's carry from the previous one;
// * ECT: 6 Jacobi rounds.  Each round takes, per interval, the carry at its
//   start from the previous round's rates (the exclusive prefix of T * lc,
//   left to right, as torch.cumsum sums it), the weights exp(nc_t - max),
//   and solves ECT(lam, T) = sum_i w_i ECT(lh_i, T) for lam by the port's
//   bracket expansion and bisection (kernels/correction.py
//   `fit_single_pop`: the raw-rate lam > 100 guard, the root on x0's
//   branch, 40 expansions capped at 100 on the lower branch, 60 halvings,
//   the float64 Bernoulli switch at x = 1/4).
//
// Replaces: engine/likelihood.py `post_split_fit_plain`, a loop of torch
// ops (~22,300 launches per ECT call on the card, ~26 per row in cpfit:
// scripts/torch_ab_trees.py's per-call counts); the JAX package
// runs the same stage as plain XLA inside its one compiled likelihood
// (misti_tpu/engine/likelihood.py:328-346, misti_tpu/kernels/correction.py
// :375-428; no pallas_call).
//
// Design.  What bounds it is the latency of each root solve: ~105 dependent
// evaluations of the residual (an expm1 and two divisions each), 6 rounds
// in a row.  So the ECT kernel gives each (lane, interval) its own thread:
// a block holds lpb = 256 / n whole lanes (lpb * n of its 256 threads
// busy: 245 at n = 35, 231 at n = 33), the lanes' T * lc in shared memory,
// double-buffered by round, so one __syncthreads per round separates a
// round's writes from the next round's prefix reads.  Each thread sums its
// own prefix serially (at most n - 1 adds, against ~105 residual
// evaluations).  A T == 0 row runs no solve.  The expansion stops once hi
// no longer moves, which leaves it where the fixed 40 steps would.  The
// cpfit kernel is serial over a lane's rows, so it runs a thread per lane.
//
// A lane's value does not depend on its batch, and lc is the value the
// plain version gives on the card: the same operations in the same order,
// each add, product and division rounded on its own (__d*_rn: never
// contracted into FMAs), CUDA's exp / expm1 / log1p as torch's kernels call
// them, and NaN carried through min and max as torch.minimum / maximum
// carry it.  The final carry sums T * lc left to right; the plain
// version's torch reduction picks its own order, so nc_fin agrees with it
// to rounding.

#include <cuda_runtime.h>

namespace {

using T = double;
constexpr int kItems = 256;    // (lane, interval) items per ECT block
constexpr int kLaneThreads = 128;  // lanes per cpfit block
constexpr int kOuters = 6;     // Jacobi rounds (_POST_OUTERS)
constexpr int kExpand = 40;    // _EXPAND_ITERS
constexpr int kBisect = 60;    // _BISECT_ITERS

__device__ __forceinline__ T add_rn(T a, T b) { return __dadd_rn(a, b); }
__device__ __forceinline__ T sub_rn(T a, T b) { return __dsub_rn(a, b); }
__device__ __forceinline__ T mul_rn(T a, T b) { return __dmul_rn(a, b); }
__device__ __forceinline__ T div_rn(T a, T b) { return __ddiv_rn(a, b); }
// torch.minimum / torch.maximum: a NaN operand gives NaN
__device__ __forceinline__ T tmin(T a, T b) {
  return isnan(a) ? a : isnan(b) ? b : (a < b ? a : b);
}
__device__ __forceinline__ T tmax(T a, T b) {
  return isnan(a) ? a : isnan(b) ? b : (a > b ? a : b);
}

// ECT(lam, T)/T - 1/2 of x = lam * T (kernels/correction.py `_ect_dev`,
// float64): the Bernoulli series below x = 1/4, else 1/x - 1/expm1(x) - 1/2
// with the tail dropped past x = 100
__device__ T ect_dev(T x) {
  if (x < T(0.25)) {
    const T x2 = mul_rn(x, x);
    T s = add_rn(mul_rn(x2, -1.0 / 47900160.0), 1.0 / 1209600.0);
    s = add_rn(mul_rn(x2, s), -1.0 / 30240.0);
    s = add_rn(mul_rn(x2, s), 1.0 / 720.0);
    s = add_rn(mul_rn(x2, s), -1.0 / 12.0);
    return mul_rn(x, s);
  }
  const T tail = x > T(100) ? T(0) : div_rn(T(1), expm1(x));
  return sub_rn(sub_rn(div_rn(T(1), x), tail), T(0.5));
}

// the residual's two branches of the raw-rate guard, at interval length t
__device__ __forceinline__ T dev_up(T lam, T t) {
  return sub_rn(div_rn(T(1), mul_rn(lam, t)), T(0.5));
}
__device__ __forceinline__ T dev_low(T lam, T t) { return ect_dev(mul_rn(lam, t)); }
__device__ __forceinline__ T dev_of(T lam, T t) {
  return lam > T(100) ? dev_up(lam, t) : dev_low(lam, t);
}

// kernels/correction.py `fit_single_pop` of one interval: solve
// ECT(lam, t) = sum_i w_i ECT(lh_i, t), weights w unnormalised
__device__ T fit_single_pop(T lh0, T lh1, T t, T w0, T w1) {
  const T ws = add_rn(w0, w1);
  const T a0 = div_rn(w0, ws), a1 = div_rn(w1, ws);
  const T te = add_rn(mul_rn(a0, dev_of(lh0, t)), mul_rn(a1, dev_of(lh1, t)));
  const T x0 = add_rn(mul_rn(a0, lh0), mul_rn(a1, lh1));
  const T lower = mul_rn(T(0.01), tmin(lh0, lh1));
  const T lo_up = tmax(lower, T(100));
  const bool root_up = sub_rn(dev_up(lo_up, t), te) >= T(0);
  const bool root_low = lower < T(100) && sub_rn(dev_low(lower, t), te) >= T(0) &&
                        sub_rn(dev_low(T(100), t), te) < T(0);
  const bool up = root_up && (x0 > T(100) || !root_low);
  T lo = up ? lo_up : lower;
  T hi = tmax(x0, mul_rn(lower, T(2)));
  const T cap = up ? T(__longlong_as_double(0x7ff0000000000000LL)) : tmax(T(100), lower);
  hi = up ? tmax(hi, lo_up) : tmin(hi, cap);
  // decreasing on the lane's branch
  auto g = [&](T lam) { return sub_rn(up ? dev_up(lam, t) : dev_low(lam, t), te); };
  for (int k = 0; k < kExpand; ++k) {
    if (!(g(hi) >= T(0))) break;
    const T next = tmin(mul_rn(hi, T(2)), cap);
    if (next == hi) break;  // at the cap: no later step moves it
    hi = next;
  }
  for (int k = 0; k < kBisect; ++k) {
    const T mid = mul_rn(T(0.5), add_rn(lo, hi));
    if (g(mid) >= T(0))
      lo = mid;
    else
      hi = mid;
  }
  return mul_rn(T(0.5), add_rn(lo, hi));
}

// ECT: a thread per (lane, interval), lpb whole lanes a block
__global__ void __launch_bounds__(kItems)
post_fit_ect(const T* __restrict__ nc, long long nc_sb, long long nc_sk,
             const T* __restrict__ lh, long long lh_sl, long long lh_st, long long lh_sk,
             const T* __restrict__ tp, long long t_sl, long long t_st, T* __restrict__ out,
             int B, int n, int lpb) {
  __shared__ T s_dec[2][kItems];
  const int tid = threadIdx.x;
  const int grp = tid / n;  // the lane's place in the block
  const int t = tid - grp * n;
  const long long lane = (long long)blockIdx.x * lpb + grp;
  const bool live = grp < lpb && lane < B;
  const T* dec0 = &s_dec[0][grp * n];
  const T* dec1 = &s_dec[1][grp * n];

  T tt = T(0), lh0 = T(0), lh1 = T(0), n0 = T(0), n1 = T(0);
  if (live) {
    tt = tp[lane * t_sl + t * t_st];
    lh0 = lh[lane * lh_sl + t * lh_st];
    lh1 = lh[lane * lh_sl + t * lh_st + lh_sk];
    n0 = nc[lane * nc_sb];
    n1 = nc[lane * nc_sb + nc_sk];
  }
  const bool zero = tt == T(0);
  // the first round's guess: the mean of the two rates
  T lc = mul_rn(add_rn(lh0, lh1), T(0.5));
  for (int r = 0; r < kOuters; ++r) {
    const int buf = r & 1;
    if (live) s_dec[buf][tid] = mul_rn(tt, lc);
    __syncthreads();
    if (live && !zero) {
      // the carry at the interval's start: nc less the exclusive prefix
      const T* dec = buf ? dec1 : dec0;
      T pre = T(0);
      if (t > 0) {
        pre = dec[0];
        for (int u = 1; u < t; ++u) pre = add_rn(pre, dec[u]);
      }
      const T c0 = sub_rn(n0, pre), c1 = sub_rn(n1, pre);
      const T m = tmax(c0, c1);
      lc = fit_single_pop(lh0, lh1, tt, exp(sub_rn(c0, m)), exp(sub_rn(c1, m)));
    } else {
      lc = T(1);
    }
  }
  const int buf = kOuters & 1;
  if (live) s_dec[buf][tid] = mul_rn(tt, lc);
  __syncthreads();
  if (!live) return;
  const long long ld = 2LL * n + 2;
  out[lane * ld + 2 * t] = lc;
  out[lane * ld + 2 * t + 1] = lc;
  if (t == 0) {
    // the final carry: T * lc summed left to right
    const T* dec = buf ? dec1 : dec0;
    T s = dec[0];
    for (int u = 1; u < n; ++u) s = add_rn(s, dec[u]);
    out[lane * ld + 2 * n] = sub_rn(n0, s);
    out[lane * ld + 2 * n + 1] = sub_rn(n1, s);
  }
}

// cpfit (and n == 0): a thread per lane, serial over its rows
__global__ void __launch_bounds__(kLaneThreads)
post_fit_cpfit(const T* __restrict__ nc, long long nc_sb, long long nc_sk,
               const T* __restrict__ lh, long long lh_sl, long long lh_st, long long lh_sk,
               const T* __restrict__ tp, long long t_sl, long long t_st, T* __restrict__ out,
               int B, int n) {
  const long long lane = (long long)blockIdx.x * kLaneThreads + threadIdx.x;
  if (lane >= B) return;
  T n0 = nc[lane * nc_sb], n1 = nc[lane * nc_sb + nc_sk];
  const long long ld = 2LL * n + 2;
  for (int t = 0; t < n; ++t) {
    const T tt = tp[lane * t_sl + t * t_st];
    const T lh0 = lh[lane * lh_sl + t * lh_st], lh1 = lh[lane * lh_sl + t * lh_st + lh_sk];
    const bool zero = tt == T(0);
    // pnc - 1 from expm1 masses, then -log1p (engine/likelihood.py)
    const T ed = exp(sub_rn(n1, n0));
    const T a = -expm1(mul_rn(-tt, lh0));
    const T b = -expm1(mul_rn(-tt, lh1));
    const T dpnc = div_rn(-add_rn(a, mul_rn(ed, b)), add_rn(ed, T(1)));
    T lam = div_rn(-log1p(dpnc), zero ? T(1) : tt);
    lam = zero ? T(1) : lam;
    const T d = mul_rn(tt, lam);
    n0 = sub_rn(n0, d);
    n1 = sub_rn(n1, d);
    out[lane * ld + 2 * t] = lam;
    out[lane * ld + 2 * t + 1] = lam;
  }
  out[lane * ld + 2 * n] = n0;
  out[lane * ld + 2 * n + 1] = n1;
}

template <typename K>
void attrs_of(K kernel, int threads, int* out) {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, kernel) != cudaSuccess) {
    out[0] = out[1] = out[2] = -1;
    return;
  }
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
}

}  // namespace

// nc (B, 2) with element strides (nc_sb, nc_sk); lh (L, n, 2) and tp (L, n)
// with element strides, a lane stride of 0 for one table shared by every
// lane; out (B, 2n + 2) contiguous: lc (B, n, 2) then nc_fin (B, 2) per
// row.  cpfit != 0 selects the closed form; 0 < n <= 256 for ECT.
// Launches on `device` (made current for the call) and `stream`.  Returns
// the CUDA error of the launch.
extern "C" int misti_post_fit(const void* nc, long long nc_sb, long long nc_sk, const void* lh,
                              long long lh_sl, long long lh_st, long long lh_sk, const void* tp,
                              long long t_sl, long long t_st, void* out, int B, int n, int cpfit,
                              int device, void* stream) {
  if (B < 1 || n < 0 || (!cpfit && n > kItems)) return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  auto st = static_cast<cudaStream_t>(stream);
  auto ncp = static_cast<const T*>(nc);
  auto lhp = static_cast<const T*>(lh);
  auto tpp = static_cast<const T*>(tp);
  auto o = static_cast<T*>(out);
  if (cpfit || n == 0) {
    const unsigned blocks = (unsigned)((B + kLaneThreads - 1) / kLaneThreads);
    post_fit_cpfit<<<blocks, kLaneThreads, 0, st>>>(ncp, nc_sb, nc_sk, lhp, lh_sl, lh_st, lh_sk,
                                                    tpp, t_sl, t_st, o, B, n);
  } else {
    const int lpb = kItems / n;
    const int threads = (lpb * n + 31) / 32 * 32;
    const unsigned blocks = (unsigned)((B + lpb - 1) / lpb);
    post_fit_ect<<<blocks, threads, 0, st>>>(ncp, nc_sb, nc_sk, lhp, lh_sl, lh_st, lh_sk, tpp,
                                             t_sl, t_st, o, B, n, lpb);
  }
  const int err = (int)cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return err;
}

// The ECT kernel at 256 threads, then the cpfit kernel at 128: registers per
// thread, local (spill) bytes per thread, resident blocks per SM.
extern "C" int misti_post_fit_attrs(int* out) {
  attrs_of(post_fit_ect, kItems, out);
  attrs_of(post_fit_cpfit, kLaneThreads, out + 3);
  return (int)cudaGetLastError();
}
