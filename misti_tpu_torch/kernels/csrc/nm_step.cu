// The Nelder-Mead simplex update of a lockstep batch of fits, for Hopper
// (sm_90a): one launch per iteration, one thread per lane.
//
// engine/optimize.py `nelder_mead` runs B fits in lockstep: every lane keeps
// its own (n+1, n) simplex, and each iteration evaluates every lane's n+5
// trial points in one objective call.  Around that call the plain loop
// spends ~115 small torch launches an iteration.  This kernel does all of
// it in one launch, a lane per thread:
//
//   start (once a run, on the start or resumed state): order the vertices;
//   step (after each objective call, with its values `fall` (B, n+5) and aux
//   vectors `auxall` (B, n+5, naux)): add the point count and the aux sums
//   of the live lanes, then scipy's decision tree (reflection, expansion,
//   the two contractions, the shrink), the ordering of the new simplex, the
//   freezing of halted lanes and `it += live`;
//   both: the convergence test, `live = !converged && it < maxiter`, the
//   next iteration's n+5 trial points from the simplex (halted lanes' too,
//   as the plain loop evaluates them), and the count of live lanes, which
//   the host reads once an iteration.
//
// Instances: for n = 1..kMaxN the lane's simplex and its candidate live in
// registers (at most 5 x 4 values each); one generic instance takes every
// larger n, working on the state in place and on a scratch buffer of the
// candidate simplex (`work`, `fwork`).  Both run the same code, so they
// round alike.
//
// Bitwise the plain loop on the card, with float64 and float32 simplexes
// (the dtype S, also the aux counters') and the objective's values in
// float64 (F, the likelihood's dtype, config.LLH_DTYPE).  The library is
// built with --fmad=false, so no product is fused into a sum, and each
// expression rounds as the torch op it stands for:
// * xbar: torch's sum over a non-innermost axis runs in one thread with four
//   accumulators, value i into accumulator i % 4, summed in order; torch
//   divides by the Python scalar n as a product with its reciprocal;
// * the expansion and outer-contraction vertices follow `_fused_mul_add`'s
//   exact product split and compensated sums, op for op (not fma(), which
//   can differ from it at a tie);
// * the vertices are ordered as torch.argsort(stable=True) orders them:
//   NaN after every number, ties (+inf at failed evaluations) in order;
// * `amax(|d|) <= tol` is read as every |d| <= tol: a NaN fails both.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxN = 4;  // the largest n with a register instance

struct Args {
  const void* in_sim;   // start: the state to order, (B, n+1, n)
  const void* in_fsim;  // (B, n+1)
  const void* in_it;    // (B,) int64
  const void* in_nfev;  // (B,) int64
  const void* in_aux;   // (B, naux)
  const void* fall;     // step: the trial points' values (B, n+5)
  const void* auxall;   // step: their aux vectors (B, n+5, naux), dtype S
  void* sim;            // the state, written (a step reads it first)
  void* fsim;
  void* it;
  void* nfev;
  void* aux;
  void* live;    // bool (B,)
  void* conv;    // bool (B,)
  void* points;  // (B, n+5, n), written
  void* count;   // int32 [2]: live lanes added to count[slot], count[1 - slot] zeroed
  void* work;    // generic instance: (B, n+1, n) dtype S, the candidate simplex
  void* fwork;   // generic instance: (B, n+1) float64, its values
  long long B, n, naux, start, slot, maxiter, s_f64;
  double xatol, fatol;
};

using F = double;  // the objective's values

__device__ __forceinline__ bool is_nan(F x) { return x != x; }

// whether a comes before b in torch's sort: NaN after every number
__device__ __forceinline__ bool before(F a, F b) { return (is_nan(b) && !is_nan(a)) || a < b; }

// torch's CUDA sum of `count` values over a non-innermost axis, value i
// being at(i): accumulator i % 4, then the four in order
template <typename T, typename At>
__device__ __forceinline__ T torch_sum(int count, At at) {
  T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
  int i = 0;
#pragma unroll
  for (; i + 4 <= count; i += 4) {
    a0 = a0 + at(i);
    a1 = a1 + at(i + 1);
    a2 = a2 + at(i + 2);
    a3 = a3 + at(i + 3);
  }
  if (i < count) a0 = a0 + at(i);
  if (i + 1 < count) a1 = a1 + at(i + 1);
  if (i + 2 < count) a2 = a2 + at(i + 2);
  return ((a0 + a1) + a2) + a3;
}

// engine/optimize.py `_fused_mul_add(c, x, t)`: c * x + t rounded once
template <typename S>
__device__ __forceinline__ S fused_mul_add(S c, S x, S t) {
  const S big = sizeof(S) == 8 ? S(134217729.0) : S(4097.0);
  const S p = c * x;
  const S g = big * x;
  const S xh = g - (g - x);
  const S e = (xh * c - p) + (x - xh) * c;
  const S s = p + t;
  const S tv = s - p;
  const S r = (p - (s - tv)) + (t - tv);
  return s + (r + e);
}

// the place of vertex i among the V values fs in a stable sort
__device__ __forceinline__ int rank_of(const F* fs, int i, int V) {
  int r = 0;
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (j < i)
      r += !before(fs[i], fs[j]);
    else if (j > i)
      r += before(fs[j], fs[i]);
  return r;
}

// engine/optimize.py `_order`: the vertices xs (V, n) and their values fs,
// stably sorted by value into x and f (not aliasing xs, fs)
template <typename S, int N>
__device__ __forceinline__ void order_into(const S* xs, const F* fs, S* x, F* f, int n) {
  const int V = n + 1;
  if constexpr (N == 1) {  // one comparison (the ranks put a lane's values in local memory)
    const bool swap = before(fs[1], fs[0]);
    f[0] = swap ? fs[1] : fs[0];
    f[1] = swap ? fs[0] : fs[1];
    x[0] = swap ? xs[1] : xs[0];
    x[1] = swap ? xs[0] : xs[1];
  } else if constexpr (N > 1) {  // constant indices only, so x and f stay in registers
    int rank[N + 1];
#pragma unroll
    for (int i = 0; i < V; ++i) rank[i] = rank_of(fs, i, V);
#pragma unroll
    for (int r = 0; r < V; ++r)
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (rank[i] == r) {
          f[r] = fs[i];
#pragma unroll
          for (int k = 0; k < n; ++k) x[r * n + k] = xs[i * n + k];
        }
  } else {
    for (int i = 0; i < V; ++i) {
      const int r = rank_of(fs, i, V);
      f[r] = fs[i];
      for (int k = 0; k < n; ++k) x[r * n + k] = xs[i * n + k];
    }
  }
}

// coordinate k of the centroid of the n best vertices
template <typename S>
__device__ __forceinline__ S xbar(const S* x, int n, int k) {
  return torch_sum<S>(n, [&](int i) { return x[i * n + k]; }) * (S(1) / S(n));
}

// vertex i of the shrunk simplex, coordinate k
template <typename S>
__device__ __forceinline__ S shrunk(const S* x, int n, int i, int k) {
  return x[k] + S(0.5) * (x[i * n + k] - x[k]);
}

template <typename S>
__device__ __forceinline__ bool converged(const S* x, const F* f, int n, S xatol, F fatol) {
  bool ok = isfinite(f[0]);
#pragma unroll
  for (int i = 1; i <= n; ++i) {
#pragma unroll
    for (int k = 0; k < n; ++k) ok &= fabs(x[i * n + k] - x[k]) <= xatol;
    ok &= fabs(f[0] - f[i]) <= fatol;
  }
  return ok;
}

// one lane: returns whether it is live after the launch.  N is n for a
// register instance, 0 for the generic one.
template <typename S, int N>
__device__ __forceinline__ bool lane(const Args& a, long long b) {
  const int n = N > 0 ? N : (int)a.n;
  const int V = n + 1, P = n + 5, naux = (int)a.naux;
  constexpr int kX = N > 0 ? (N + 1) * N : 1, kF = N > 0 ? N + 1 : 1;
  S* osim = static_cast<S*>(a.sim) + b * V * n;
  F* ofsim = static_cast<F*>(a.fsim) + b * V;
  S* oaux = static_cast<S*>(a.aux) + b * naux;
  // the simplex x, f and the candidate y, g: registers, or the state itself and the scratch
  S xl[kX], yl[kX];
  F fl[kF], gl[kF];
  S *x = xl, *y = yl;
  F *f = fl, *g = gl;
  if constexpr (N == 0) {
    x = osim;
    f = ofsim;
    y = static_cast<S*>(a.work) + b * V * n;
    g = static_cast<F*>(a.fwork) + b * V;
  }
  long long it, nfev;

  if (a.start) {
    order_into<S, N>(static_cast<const S*>(a.in_sim) + b * V * n,
                     static_cast<const F*>(a.in_fsim) + b * V, x, f, n);
    const S* iaux = static_cast<const S*>(a.in_aux) + b * naux;
    for (int k = 0; k < naux; ++k) oaux[k] = iaux[k];
    it = static_cast<const long long*>(a.in_it)[b];
    nfev = static_cast<const long long*>(a.in_nfev)[b];
  } else {
    if constexpr (N > 0) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        f[i] = ofsim[i];
#pragma unroll
        for (int k = 0; k < n; ++k) x[i * n + k] = osim[i * n + k];
      }
    }
    it = static_cast<const long long*>(a.it)[b];
    nfev = static_cast<const long long*>(a.nfev)[b];
    const bool live = static_cast<const bool*>(a.live)[b];
    const F* fa = static_cast<const F*>(a.fall) + b * P;
    if (live) nfev += P;
    const S* aa = static_cast<const S*>(a.auxall) + b * P * naux;
    for (int k = 0; k < naux; ++k)
      oaux[k] = oaux[k] + (live ? torch_sum<S>(P, [&](int i) { return aa[i * naux + k]; }) : S(0));

    const F fxr = fa[0], fxe = fa[1], fxc = fa[2], fxcc = fa[3];
    const F f0 = f[0], f_2 = f[n - 1], f_1 = f[n];
    // scipy's _minimize_neldermead decision tree, as the plain loop selects it
    const bool take_xe = (fxr < f0) && (fxe < fxr);
    const bool take_xr = ((fxr < f0) && !(fxe < fxr)) || ((fxr >= f0) && (fxr < f_2));
    const bool inside = (fxr >= f0) && (fxr >= f_2);
    const bool take_xc = inside && (fxr < f_1) && (fxc <= fxr);
    const bool take_xcc = inside && (fxr >= f_1) && (fxcc < f_1);
    const bool doshrink =
        inside && (((fxr < f_1) && !(fxc <= fxr)) || ((fxr >= f_1) && !(fxcc < f_1)));

    // the candidate: the n best vertices, then the selected trial vertex or the worst
#pragma unroll
    for (int i = 0; i < n; ++i) {
      g[i] = f[i];
#pragma unroll
      for (int k = 0; k < n; ++k) y[i * n + k] = x[i * n + k];
    }
    g[n] = take_xe ? fxe : take_xr ? fxr : take_xc ? fxc : take_xcc ? fxcc : f_1;
#pragma unroll
    for (int k = 0; k < n; ++k) {
      const S c = xbar(x, n, k), w = x[n * n + k];
      const S xr = S(2) * c - S(1) * w, xe = fused_mul_add(S(3), c, S(-2) * w);
      const S xc = fused_mul_add(S(1.5), c, S(-0.5) * w), xcc = S(0.5) * c + S(0.5) * w;
      y[n * n + k] = take_xe ? xe : take_xr ? xr : take_xc ? xc : take_xcc ? xcc : w;
    }
    if (doshrink) {
#pragma unroll
      for (int i = 1; i < V; ++i) {
        g[i] = fa[4 + i];
#pragma unroll
        for (int k = 0; k < n; ++k) y[i * n + k] = shrunk(x, n, i, k);
      }
    }
    if (live) {
      order_into<S, N>(y, g, x, f, n);
      it += 1;
    }
  }

  const bool conv = converged(x, f, n, S(a.xatol), F(a.fatol));
  const bool live = !conv && it < a.maxiter;

  if constexpr (N > 0) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      ofsim[i] = f[i];
#pragma unroll
      for (int k = 0; k < n; ++k) osim[i * n + k] = x[i * n + k];
    }
  }
  static_cast<long long*>(a.it)[b] = it;
  static_cast<long long*>(a.nfev)[b] = nfev;
  static_cast<bool*>(a.live)[b] = live;
  static_cast<bool*>(a.conv)[b] = conv;

  // the next objective call's points: xr, xe, xc, xcc, then the n+1 shrunk vertices
  S* pts = static_cast<S*>(a.points) + b * P * n;
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const S c = xbar(x, n, k), w = x[n * n + k];
    pts[k] = S(2) * c - S(1) * w;
    pts[n + k] = fused_mul_add(S(3), c, S(-2) * w);
    pts[2 * n + k] = fused_mul_add(S(1.5), c, S(-0.5) * w);
    pts[3 * n + k] = S(0.5) * c + S(0.5) * w;
  }
#pragma unroll
  for (int i = 0; i < V; ++i)
#pragma unroll
    for (int k = 0; k < n; ++k) pts[(4 + i) * n + k] = shrunk(x, n, i, k);
  return live;
}

template <typename S, int N>
__global__ void __launch_bounds__(kThreads) nm_step_kernel(const Args a) {
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = b < a.B && lane<S, N>(a, b);
  const int c = __syncthreads_count(live);
  if (threadIdx.x == 0) {
    int* count = static_cast<int*>(a.count);
    if (c) atomicAdd(count + a.slot, c);
    if (blockIdx.x == 0) count[1 - a.slot] = 0;
  }
}

template <typename S>
const void* kernel_for(long long n) {
  switch (n) {
    case 1: return reinterpret_cast<const void*>(nm_step_kernel<S, 1>);
    case 2: return reinterpret_cast<const void*>(nm_step_kernel<S, 2>);
    case 3: return reinterpret_cast<const void*>(nm_step_kernel<S, 3>);
    case 4: return reinterpret_cast<const void*>(nm_step_kernel<S, 4>);
    default: return reinterpret_cast<const void*>(nm_step_kernel<S, 0>);
  }
}

// the instance for the simplex's dtype and n: the generic one past kMaxN
const void* kernel_for(long long s_f64, long long n) {
  return s_f64 ? kernel_for<double>(n) : kernel_for<float>(n);
}

}  // namespace

// Launches on `device` (made current for the call) and `stream`; a start
// first zeroes both count slots.  Returns the CUDA error of the launch.
extern "C" int misti_nm_step(const void* args, int device, void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  if (a.B < 1 || a.n < 1 || a.naux < 0 || (a.slot != 0 && a.slot != 1) ||
      (!a.start && a.fall == nullptr) || (!a.start && a.naux && a.auxall == nullptr) ||
      (a.n > kMaxN && (a.work == nullptr || a.fwork == nullptr)))
    return (int)cudaErrorInvalidValue;
  const void* fn = kernel_for(a.s_f64, a.n);
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.start) e = cudaMemsetAsync(a.count, 0, 2 * sizeof(int), st);
  if (e == cudaSuccess) {
    Args copy = a;
    void* params[] = {&copy};
    const unsigned blocks = (unsigned)((a.B + kThreads - 1) / kThreads);
    e = cudaLaunchKernel(fn, dim3(blocks), dim3(kThreads), params, 0, st);
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)e;
}

// sizeof(Args), for the host's mirror to check its layout against
extern "C" int misti_nm_step_args_size() { return (int)sizeof(Args); }

// The largest n with a register instance.
extern "C" int misti_nm_step_max_n() { return kMaxN; }

// Per instance, float64 simplexes then float32, each for n = 1..kMaxN and
// then the generic instance: registers per thread and local (spill) bytes
// per thread.
extern "C" int misti_nm_step_attrs(int* out) {
  for (int p = 0; p < 2; ++p)
    for (int n = 1; n <= kMaxN + 1; ++n) {
      cudaFuncAttributes fa;
      cudaError_t e = cudaFuncGetAttributes(&fa, kernel_for(p == 0, n));
      if (e != cudaSuccess) return (int)e;
      const int i = p * (kMaxN + 1) + n - 1;
      out[2 * i] = fa.numRegs;
      out[2 * i + 1] = (int)fa.localSizeBytes;
    }
  return 0;
}
