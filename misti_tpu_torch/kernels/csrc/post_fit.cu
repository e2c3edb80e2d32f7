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
// What bounds it.  ECT: the latency of each root solve, ~65 dependent
// evaluations of the residual (the series, or an expm1 and two divisions),
// 6 rounds in a row, and at wide batches the FP64 rate of the card; cpfit:
// the serial chain of a lane's rows.
//
// ECT design.  The sweep's lanes come in runs that share a split, so lanes
// next to each other at one interval solve alike; intervals next to each
// other do not (x = lam T crosses the series switch along a lane).  So a
// warp takes one interval of consecutive lanes ("lane-major"): its solves
// take one form of the residual and one branch of the guard, and a warp
// whose interval has T == 0 in every lane skips the solve.  A block holds
// `warps` intervals (at most kMaxWarps: 18 at G = 1, so that two blocks
// share an SM at the paths' widths; 32 at G > 1) of S lanes; a lane's n
// intervals
// span a thread-block cluster of C = ceil(n / h) blocks (C <= 8, h
// intervals each), and a block reads the T * lc of the intervals before
// its own from its cluster's other blocks through distributed shared
// memory, one cluster barrier per round (a plain barrier where C = 1).
// Each round's T * lc is double-buffered by round; each thread sums its
// interval's prefix serially, left to right, reading kUnroll terms ahead.
// At G = 1 past n = 18 * 8 a warp takes two intervals of 16 lanes (K = 2).
//
// Two shortcuts keep every bit.  A halving that leaves the bracket's bits
// as they were is a fixed point: the next one takes the same midpoint and
// the same sign, so the rest of the 60 are skipped.  An interval whose
// prefix is the last round's, bit for bit, has the last round's weights
// and so its rate (every round from the t-th on for interval t, by
// induction; ~80% of rounds 2-6's solves on the paths' inputs): its solve
// is skipped.
//
// Narrow batches (the single fit: 6 lanes, 180 solves) fill a few SMs and
// leave each solve's chain of evaluations exposed, so a group of G = 2^k
// threads (the warp's lanes j mod G) runs each solve: the four costly
// set-up evaluations on four threads; the expansion G doublings at a time
// (thread j tests hi * 2^j capped, which is hi doubled j times with the cap,
// and the group takes the first j whose test stops the loop); and the 60
// halvings as 60 / k steps down a k-level bisection tree: thread j takes
// node j (heap order), walks to it from the bracket by the bits of j with
// the serial loop's own midpoints, evaluates the residual at its midpoint,
// and the group walks k levels by the ballot of the signs.  Every
// evaluation on the path is the serial loop's, on the same value, so every
// G gives the bits of G = 1.  The wrapper picks G (kernels/post_fit.py
// `threads_per_solve`) to fill the card's resident threads.
//
// cpfit design.  A block of 32 lanes; its four warps first compute every
// (lane, row)'s interval length and the two carry-independent masses
// -expm1(-T lh) into shared memory, reading the tables row-fastest; one
// warp then runs each lane's serial chain (exp, a division, log1p, a
// division, a product and two subtractions a row); all four write the
// rates back row-fastest.
//
// A lane's value does not depend on its batch (nor on G), and lc follows
// the plain version: the same operations in the same order, each add,
// product and division rounded on its own (__d*_rn: never contracted into
// FMAs), CUDA's exp / expm1 / log1p as torch's kernels call them, and NaN
// carried through min and max as torch.minimum / maximum carry it.  cpfit's
// lc is the plain version's on the card bit for bit; ECT's agrees to ~1e-15
// relative (which operation parts them is not isolated).  The final carry
// sums T * lc left to right; the plain version's torch reduction picks its
// own order, so nc_fin agrees with it to rounding.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

using T = double;
constexpr unsigned kFull = 0xffffffffu;
// intervals (warps) of an ECT block: at G = 1 two blocks an SM (the card
// full at the paths' widths), else one of up to 1024 threads
template <int G>
constexpr int kMaxWarps = G == 1 ? 18 : 32;
constexpr int kUnroll = 8;       // prefix terms read ahead of their adds
constexpr int kMaxCluster = 8;   // blocks of a cluster (the portable limit)
constexpr int kMaxIntervals = 256;  // MAX_ECT_INTERVALS
constexpr int kCpLanes = 32;     // lanes of a cpfit block
constexpr int kCpThreads = 128;  // threads of a cpfit block
constexpr int kCpRows = 32;      // rows of a cpfit block's shared tables
constexpr int kOuters = 6;       // Jacobi rounds (_POST_OUTERS)
constexpr int kExpand = 40;      // _EXPAND_ITERS
constexpr int kBisect = 60;      // _BISECT_ITERS: a multiple of k = 1..5

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
// the same bits
__device__ __forceinline__ bool same(T a, T b) {
  return __double_as_longlong(a) == __double_as_longlong(b);
}
// 2^e, exact, 0 <= e <= 32
__device__ __forceinline__ T pow2(int e) { return __longlong_as_double((1023LL + e) << 52); }

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
// ECT(lam, t) = sum_i w_i ECT(lh_i, t), weights w unnormalised.  G threads
// (the warp's lanes j mod G, j = this thread's place in its group) run one
// solve and all return its root; G > 1 needs the whole warp here.
template <int G>
__device__ T fit_single_pop(T lh0, T lh1, T t, T w0, T w1, int j) {
  const T ws = add_rn(w0, w1);
  const T a0 = div_rn(w0, ws), a1 = div_rn(w1, ws);
  const T lower = mul_rn(T(0.01), tmin(lh0, lh1));
  // the set-up's residuals at lh0, lh1 (either branch), lower and 100 (the
  // lower branch); x = lam t on both branches
  T te;
  bool root_low;
  if constexpr (G == 1) {
    te = add_rn(mul_rn(a0, dev_of(lh0, t)), mul_rn(a1, dev_of(lh1, t)));
    root_low = lower < T(100) && sub_rn(dev_low(lower, t), te) >= T(0) &&
               sub_rn(dev_low(T(100), t), te) < T(0);
  } else {
    // G >= 4: thread j < 4 takes item j; G == 2: thread j items j and j + 2
    auto item = [&](int i) {
      const T lam = i == 0 ? lh0 : i == 1 ? lh1 : i == 2 ? lower : T(100);
      return i < 2 && lam > T(100) ? dev_up(lam, t) : dev_low(lam, t);
    };
    const T d = item(j);
    te = add_rn(mul_rn(a0, __shfl_sync(kFull, d, 0, G)), mul_rn(a1, __shfl_sync(kFull, d, 1, G)));
    const T e = G >= 4 ? d : item(j + 2);
    const T d_lower = __shfl_sync(kFull, e, G >= 4 ? 2 : 0, G);
    const T d_100 = __shfl_sync(kFull, e, G >= 4 ? 3 : 1, G);
    root_low = lower < T(100) && sub_rn(d_lower, te) >= T(0) && sub_rn(d_100, te) < T(0);
  }
  const T x0 = add_rn(mul_rn(a0, lh0), mul_rn(a1, lh1));
  const T lo_up = tmax(lower, T(100));
  const bool root_up = sub_rn(dev_up(lo_up, t), te) >= T(0);
  const bool up = root_up && (x0 > T(100) || !root_low);
  T lo = up ? lo_up : lower;
  T hi = tmax(x0, mul_rn(lower, T(2)));
  const T cap = up ? T(__longlong_as_double(0x7ff0000000000000LL)) : tmax(T(100), lower);
  hi = up ? tmax(hi, lo_up) : tmin(hi, cap);
  // decreasing on the lane's branch
  auto g = [&](T lam) { return sub_rn(up ? dev_up(lam, t) : dev_low(lam, t), te); };
  if constexpr (G == 1) {
    for (int k = 0; k < kExpand; ++k) {
      if (!(g(hi) >= T(0))) break;
      const T next = tmin(mul_rn(hi, T(2)), cap);
      if (next == hi) break;  // at the cap: no later step moves it
      hi = next;
    }
    for (int k = 0; k < kBisect; ++k) {
      const T mid = mul_rn(T(0.5), add_rn(lo, hi));
      const bool rise = g(mid) >= T(0);
      if (same(mid, rise ? lo : hi)) break;  // a fixed point (below)
      if (rise)
        lo = mid;
      else
        hi = mid;
    }
  } else {
    constexpr int kLevels = G == 2 ? 1 : G == 4 ? 2 : G == 8 ? 3 : G == 16 ? 4 : 5;
    const int base = (threadIdx.x & 31) & ~(G - 1);  // the group's first lane
    const unsigned gmask = G == 32 ? kFull : ((1u << G) - 1u);
    // expansion: step i0 + j on thread j; the serial loop stops at step i
    // when g(h_i) < 0 or h_{i+1} == h_i, and ends at h_40 if no step stops
    bool done = false;
    for (int i0 = 0; __any_sync(kFull, !done); i0 += G) {
      const T hj = j == 0 ? hi : tmin(mul_rn(hi, pow2(j)), cap);
      const T hn = tmin(mul_rn(hi, pow2(j + 1)), cap);
      const bool stop = i0 + j < kExpand && (!(g(hj) >= T(0)) || hn == hj);
      const unsigned bits = (__ballot_sync(kFull, stop) >> base) & gmask;
      const T at_stop = __shfl_sync(kFull, hj, bits ? __ffs(bits) - 1 : 0, G);
      const int last = kExpand - i0 < G ? kExpand - i0 - 1 : G - 1;
      const T at_end = __shfl_sync(kFull, hn, last, G);
      if (!done) {
        hi = bits ? at_stop : at_end;
        done = bits != 0 || i0 + G >= kExpand;
      }
    }
    // bisection, k = kLevels halvings a step, until every solve of the warp
    // is at a fixed point (below)
    const int depth = j ? 31 - __clz(j) : 0;
    for (int s = 0; s < kBisect / kLevels; ++s) {
      const T lo0 = lo, hi0 = hi;
      T a = lo, b = hi;
      for (int d = depth - 1; d >= 0; --d) {
        const T m = mul_rn(T(0.5), add_rn(a, b));
        if ((j >> d) & 1)
          a = m;
        else
          b = m;
      }
      const bool rise = g(mul_rn(T(0.5), add_rn(a, b))) >= T(0);
      const unsigned bits = (__ballot_sync(kFull, rise) >> base) & gmask;
      int node = 1;
#pragma unroll
      for (int l = 0; l < kLevels; ++l) {
        const T mid = mul_rn(T(0.5), add_rn(lo, hi));
        const int r = (bits >> node) & 1;
        if (r)
          lo = mid;
        else
          hi = mid;
        node = 2 * node + r;
      }
      if (__all_sync(kFull, same(lo, lo0) && same(hi, hi0))) break;
    }
  }
  return mul_rn(T(0.5), add_rn(lo, hi));
}

// block r's T * lc table, p being this block's (rank q of a cluster of C)
__device__ __forceinline__ const T* block_dec(T* p, int r, int q, int C) {
  return r == q || C == 1 ? p : cg::this_cluster().map_shared_rank(p, r);
}

// sum of dec[u], u < t, left to right: a lane's intervals, h per block of
// its cluster, at column s (stride S) of each block's table `p`
__device__ __forceinline__ T prefix(T* p, int q, int C, int t, int h, int S, int s) {
  T pre = T(0);
  bool first = true;
  for (int r = 0; r * h < t; ++r) {
    const T* dec = block_dec(p, r, q, C) + s;
    const int end = t < (r + 1) * h ? t - r * h : h;
    for (int u0 = 0; u0 < end; u0 += kUnroll) {
      T v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) v[k] = u0 + k < end ? dec[(u0 + k) * S] : T(0);
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (u0 + k < end) pre = first ? v[k] : add_rn(pre, v[k]);
        first = false;
      }
    }
  }
  return pre;
}

// ECT: a cluster of C blocks per S lanes, `warps` warps a block, K
// intervals a warp (S = 32 / (G K) lanes of G threads each); block rank q
// of the cluster holds intervals [q h, (q + 1) h)
template <int G>
__global__ void __launch_bounds__(kMaxWarps<G> * 32, G == 1 ? 2 : 1)
post_fit_ect(const T* __restrict__ nc, long long nc_sb, long long nc_sk,
             const T* __restrict__ lh, long long lh_sl, long long lh_st, long long lh_sk,
             const T* __restrict__ tp, long long t_sl, long long t_st, T* __restrict__ out,
             int B, int n, int K, int C, int h) {
  // T * lc by (round parity, interval of the block, lane of the block)
  __shared__ T s_dec[2][kMaxWarps<G> * 32];
  const int S = 32 / (G * K);
  const int q = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int tid = threadIdx.x, wl = tid & 31;
  const int j = wl & (G - 1);
  const int s = (wl / G) % S;
  const int tl = (tid >> 5) * K + wl / (G * S);  // the interval's place in the block
  const int t = q * h + tl;
  const long long lane = (long long)(blockIdx.x / C) * S + s;
  const bool live = tl < h && t < n && lane < B;
  const int slot = tl * S + s;

  // the rates and carries are read again where they are needed, so that
  // they hold no registers through the solves
  const long long at = lane * lh_sl + t * lh_st;
  auto rate = [&](int k) { return live ? lh[at + k * lh_sk] : T(0); };
  auto carry = [&](int k) { return live ? nc[lane * nc_sb + k * nc_sk] : T(0); };
  const T tt = live ? tp[lane * t_sl + t * t_st] : T(0);
  const bool solve = live && tt != T(0);
  auto sync = [&] {
    if (C > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
  };
  // the first round's guess: the mean of the two rates
  T lc = mul_rn(add_rn(rate(0), rate(1)), T(0.5));
  long long pre_bits = -1;  // the last round's prefix, bit for bit (none yet)
  for (int r = 0; r < kOuters; ++r) {
    const int buf = r & 1;
    if (live && j == 0) s_dec[buf][slot] = mul_rn(tt, lc);
    sync();
    // the carry at the interval's start: nc less the exclusive prefix; a
    // prefix the last round had gives the last round's rate again
    const T pre = solve && t > 0 ? prefix(s_dec[buf], q, C, t, h, S, s) : T(0);
    const bool again = r > 0 && __double_as_longlong(pre) == pre_bits;
    pre_bits = __double_as_longlong(pre);
    if (G == 1 ? solve && !again : __any_sync(kFull, solve && !again)) {
      const T c0 = sub_rn(carry(0), pre), c1 = sub_rn(carry(1), pre);
      const T m = tmax(c0, c1);
      const T fit = fit_single_pop<G>(rate(0), rate(1), solve ? tt : T(1), exp(sub_rn(c0, m)),
                                      exp(sub_rn(c1, m)), j);
      lc = solve ? fit : T(1);
    } else if (!solve) {
      lc = T(1);
    }
  }
  const int buf = kOuters & 1;
  if (live && j == 0) s_dec[buf][slot] = mul_rn(tt, lc);
  sync();
  if (live && j == 0) {
    const long long ld = 2LL * n + 2;
    out[lane * ld + 2 * t] = lc;
    out[lane * ld + 2 * t + 1] = lc;
    if (t == 0) {
      // the final carry: T * lc summed left to right
      const T sum = prefix(s_dec[buf], q, C, n, h, S, s);
      out[lane * ld + 2 * n] = sub_rn(carry(0), sum);
      out[lane * ld + 2 * n + 1] = sub_rn(carry(1), sum);
    }
  }
  if (C > 1) sync();  // no block leaves while another reads its shared memory
}

// cpfit (and n == 0): a block per 32 lanes; the masses in parallel, then a
// thread per lane serial over its rows
__global__ void __launch_bounds__(kCpThreads)
post_fit_cpfit(const T* __restrict__ nc, long long nc_sb, long long nc_sk,
               const T* __restrict__ lh, long long lh_sl, long long lh_st, long long lh_sk,
               const T* __restrict__ tp, long long t_sl, long long t_st, T* __restrict__ out,
               int B, int n) {
  // per (lane, row) of a chunk: T, then -expm1(-T lh0) (later the rate),
  // -expm1(-T lh1); a row of kCpRows + 1 keeps the two phases' reads apart
  // in the banks
  __shared__ T s_t[kCpLanes][kCpRows + 1], s_a[kCpLanes][kCpRows + 1],
      s_b[kCpLanes][kCpRows + 1];
  const long long lane0 = (long long)blockIdx.x * kCpLanes;
  const int tid = threadIdx.x;
  const long long lane = lane0 + tid;
  const bool chain = tid < kCpLanes && lane < B;
  const long long ld = 2LL * n + 2;
  T n0 = T(0), n1 = T(0);
  if (chain) {
    n0 = nc[lane * nc_sb];
    n1 = nc[lane * nc_sb + nc_sk];
  }
  for (int r0 = 0; r0 < n; r0 += kCpRows) {
    const int rows = n - r0 < kCpRows ? n - r0 : kCpRows;
    for (int i = tid; i < rows * kCpLanes; i += kCpThreads) {
      const int l = i / rows, row = i - l * rows;
      if (lane0 + l >= B) continue;
      const long long b = lane0 + l;
      const int t = r0 + row;
      const T tt = tp[b * t_sl + t * t_st];
      s_t[l][row] = tt;
      // pnc - 1 from expm1 masses, then -log1p (engine/likelihood.py)
      s_a[l][row] = -expm1(mul_rn(-tt, lh[b * lh_sl + t * lh_st]));
      s_b[l][row] = -expm1(mul_rn(-tt, lh[b * lh_sl + t * lh_st + lh_sk]));
    }
    __syncthreads();
    if (chain) {
      for (int row = 0; row < rows; ++row) {
        const T tt = s_t[tid][row];
        const bool zero = tt == T(0);
        const T ed = exp(sub_rn(n1, n0));
        const T dpnc = div_rn(-add_rn(s_a[tid][row], mul_rn(ed, s_b[tid][row])),
                              add_rn(ed, T(1)));
        T lam = div_rn(-log1p(dpnc), zero ? T(1) : tt);
        lam = zero ? T(1) : lam;
        const T d = mul_rn(tt, lam);
        n0 = sub_rn(n0, d);
        n1 = sub_rn(n1, d);
        s_a[tid][row] = lam;
      }
    }
    __syncthreads();
    for (int i = tid; i < rows * kCpLanes; i += kCpThreads) {
      const int l = i / rows, row = i - l * rows;
      if (lane0 + l >= B) continue;
      const T lam = s_a[l][row];
      *reinterpret_cast<double2*>(out + (lane0 + l) * ld + 2 * (r0 + row)) = make_double2(lam, lam);
    }
    __syncthreads();
  }
  if (chain) *reinterpret_cast<double2*>(out + lane * ld + 2 * n) = make_double2(n0, n1);
}

using EctKernel = void (*)(const T*, long long, long long, const T*, long long, long long,
                           long long, const T*, long long, long long, T*, int, int, int, int,
                           int);

EctKernel ect_kernel(int G) {
  switch (G) {
    case 1: return post_fit_ect<1>;
    case 2: return post_fit_ect<2>;
    case 4: return post_fit_ect<4>;
    case 8: return post_fit_ect<8>;
    case 16: return post_fit_ect<16>;
    case 32: return post_fit_ect<32>;
    default: return nullptr;
  }
}

// registers, local bytes, resident blocks per SM at `threads`; and, for a
// cluster size `cluster` > 0, resident clusters on the card
template <typename K>
void attrs_of(K kernel, int threads, int cluster, int* out) {
  cudaFuncAttributes a;
  out[0] = out[1] = out[2] = out[3] = -1;
  if (cudaFuncGetAttributes(&a, kernel) != cudaSuccess) return;
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
  out[3] = 0;
  if (cluster > 0) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(threads);
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) == cudaSuccess)
      out[3] = clusters;
  }
}

}  // namespace

// nc (B, 2) with element strides (nc_sb, nc_sk); lh (L, n, 2) and tp (L, n)
// with element strides, a lane stride of 0 for one table shared by every
// lane; out (B, 2n + 2) contiguous: lc (B, n, 2) then nc_fin (B, 2) per
// row.  cpfit != 0 selects the closed form.  ECT (0 < n <= 256): G threads
// a solve (1, 2, ..., 32), K intervals a warp (1 or 2), clusters of C <= 8
// blocks of h intervals each (C h >= n, ceil(h / K) <= 18 warps, G K <= 32).
// Launches on `device` (made current for the call) and `stream`.  Returns
// the CUDA error of the launch.
extern "C" int misti_post_fit(const void* nc, long long nc_sb, long long nc_sk, const void* lh,
                              long long lh_sl, long long lh_st, long long lh_sk, const void* tp,
                              long long t_sl, long long t_st, void* out, int B, int n, int cpfit,
                              int G, int K, int C, int h, int device, void* stream) {
  const bool ect = !cpfit && n > 0;
  if (B < 1 || n < 0) return (int)cudaErrorInvalidValue;
  EctKernel kernel = ect ? ect_kernel(G) : nullptr;
  const int warps = ect && K > 0 ? (h + K - 1) / K : 0;
  if (ect && (!kernel || n > kMaxIntervals || (K != 1 && K != 2) || G * K > 32 || C < 1 ||
              C > kMaxCluster || h < 1 || (long long)C * h < n || (C - 1) * h >= n ||
              warps > (G == 1 ? kMaxWarps<1> : kMaxWarps<2>)))
    return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  auto st = static_cast<cudaStream_t>(stream);
  auto ncp = static_cast<const T*>(nc);
  auto lhp = static_cast<const T*>(lh);
  auto tpp = static_cast<const T*>(tp);
  auto o = static_cast<T*>(out);
  if (!ect) {
    const unsigned blocks = (unsigned)((B + kCpLanes - 1) / kCpLanes);
    post_fit_cpfit<<<blocks, kCpThreads, 0, st>>>(ncp, nc_sb, nc_sk, lhp, lh_sl, lh_st, lh_sk,
                                                  tpp, t_sl, t_st, o, B, n);
  } else {
    const int S = 32 / (G * K);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)((B + S - 1) / S) * C);
    cfg.blockDim = dim3(32 * warps);
    cfg.stream = st;
    cfg.attrs = &attr;
    cfg.numAttrs = C > 1;
    cudaLaunchKernelEx(&cfg, kernel, ncp, nc_sb, nc_sk, lhp, lh_sl, lh_st, lh_sk, tpp, t_sl,
                       t_st, o, B, n, K, C, h);
  }
  const int err = (int)cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return err;
}

// Per ECT variant G = 1, 2, ..., 32 at its largest block (18 warps at G =
// 1, else 32) and a cluster of 2, then the cpfit kernel at its 128 threads: registers per
// thread, local (spill) bytes per thread, resident blocks per SM, resident
// clusters on the card (0 for cpfit): 4 ints each, 28 in all.
extern "C" int misti_post_fit_attrs(int* out) {
  for (int i = 0; i < 6; ++i)
    attrs_of(ect_kernel(1 << i), (i ? kMaxWarps<2> : kMaxWarps<1>)*32, 2, out + 4 * i);
  attrs_of(post_fit_cpfit, kCpThreads, 0, out + 24);
  return (int)cudaGetLastError();
}

// The same 4 ints for one launch shape: the ECT kernel of G threads a solve
// (G = 0: the cpfit kernel) at `threads` a block in clusters of `cluster`.
extern "C" int misti_post_fit_occupancy(int G, int threads, int cluster, int* out) {
  if (G == 0)
    attrs_of(post_fit_cpfit, threads, 0, out);
  else if (ect_kernel(G))
    attrs_of(ect_kernel(G), threads, cluster > 1 ? cluster : 0, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
