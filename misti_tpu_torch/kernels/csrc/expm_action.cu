// The spectrum's per-interval action (E p0, N1 p0) of a CTMC generator, for
// Hopper (sm_90a): one launch per interval, a warp per lane.  Float64 only:
// the likelihood's dtype (config.LLH_DTYPE).
//
// For lane b with rates coeffs[b, :] (C of them), the generator is
// M_b = sum_c coeffs[b, c] * B_c over a constant stacked basis, and over an
// interval of length t[b] this computes E p0 = e^{M t} p0 and
// N1 p0 = int_0^t e^{M u} p0 du (row vectors, p0 (B, n)) by m Taylor
// sub-steps of degree `degree`: m = clamp(ceil(||M t||_1 / theta), 1, cap)
// (with ||M t||_1 bounded by sum_c |coeffs_c| * ||B_c||_1 * t), h = t / m,
// cs = coeffs * h, G = sum_c cs_c B_c, and per sub-step
//   term = p; ev = p; pv = p
//   for k = 1..degree: term = (term @ G^T) / k; ev += term; pv += term / (k+1)
//   p = ev; acc += h * pv.
// A lane past theta * cap (or with NaN rates) returns NaN in both; a lane
// with t == 0 returns p0 and 0 (NaN where p0 is not finite).  Optionally the
// epilogue projects N1 p0 onto the JSFS categories:
// proj[b, q] = (sum_k acc[b, k] * jsfs[k, q]) * catmask[b, q].
//
// Replaces: kernels/expm.py `expm_action_pair_plain` as a loop of torch ops
// (the JAX package's XLA loop, misti_tpu/kernels/expm.py:235-310; no
// pallas_call).
//
// The basis comes as its nonzeros (kernels/expm.py `SparseBasis`): output
// state j sums term[src[j, l]] * G[slot[j, l]] over l < L, padded with a
// zero term entry (src = n) and a zero slot (slot = nnz).  At n = 44 the
// four bases' union has 196 nonzeros (L = 5), at n = 8 it has 18 (L = 3):
// the work per term is that of the lane's own sparse generator, not C dense
// (n, n) matvecs over the stacked basis.
//
// Design.  What bounds it is latency: per lane a chain of m * degree
// dependent matvecs of a few hundred flops.  So many independent lanes are
// in flight, each on as few threads as share a term:
// * a warp per lane at n = 44 (thread g owns states g and g + 32), and at
//   n = 8 four lanes per warp, in 8-thread groups (a state each);
// * each thread forms its states' generator entries once per launch (C
//   products and adds each) and keeps them, and their sources, in registers;
// * a term passes through the group's own double buffer in shared memory
//   (n + 1 words, the last a zero for the pads) with one __syncwarp per
//   term: no block-wide barrier, so a group runs to its own lane's m;
// * a lane past the cap, or with t == 0 and a finite p0 (a vote over the
//   group), skips the series: the series would give NaN, or p0 and 0.
// Shared memory is static and small (under 4 KB a block), so no attribute
// is set and many blocks fit on an SM.
//
// No tensor cores: every lane has its own sparse generator, and an FP64 mma
// would have to multiply by the dense stacked basis, ~27x the operations
// this does.
//
// A lane's value does not depend on its batch, and each value is the one
// the plain version gives on the card: it forms G in the same order (a
// product, then for each further basis a product and an add), sums each
// column's nonzeros in order, and rounds each add and product on its own
// (__*_rn: never contracted into FMAs), as torch's elementwise ops do;
// torch's division by a Python scalar is its product with the reciprocal.
// The projection is row_matmul's FMA chain (the plain version calls it).

#include <cuda_runtime.h>

namespace {

using T = double;
constexpr int kThreads = 128;  // 4 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDegree = 32;

__device__ __forceinline__ T add_rn(T a, T b) { return __dadd_rn(a, b); }
__device__ __forceinline__ T mul_rn(T a, T b) { return __dmul_rn(a, b); }
__device__ __forceinline__ T div_rn(T a, T b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ T quiet_nan() { return __longlong_as_double(0x7ff8000000000000LL); }

// threads per lane (a warp at n = 44, n at n = 8), states per thread
template <int N>
constexpr int kGroup = N > 16 ? 32 : N;
template <int N>
constexpr int kSpt = (N + kGroup<N> - 1) / kGroup<N>;
template <int N>
constexpr int kLanes = kThreads / kGroup<N>;  // lanes per block

template <int N, int C, int L>
__global__ void __launch_bounds__(kThreads)
expm_action_kernel(const int* __restrict__ src, const int* __restrict__ slot,
                   const T* __restrict__ vals, int nnz, const T* __restrict__ coeffs,
                   long long c_ld, const T* __restrict__ norms, const T* __restrict__ tv,
                   long long t_ld, const T* __restrict__ p0, const T* __restrict__ jsfs, int Q,
                   const T* __restrict__ catmask, long long cm_ld, T* __restrict__ ep,
                   T* __restrict__ n1p, T* __restrict__ proj, int B, T inv_theta, T nb_cap,
                   int cap, int degree) {
  constexpr int G = kGroup<N>;
  constexpr int SPT = kSpt<N>;
  constexpr int kBuf = N + 1;  // a term and the zero the pads read
  __shared__ T s_inv[kWarps][kMaxDegree + 2];
  __shared__ T s_buf[kLanes<N>][2][kBuf];

  const int tid = threadIdx.x;
  const int wl = tid & 31;
  const int grp = tid / G;     // the lane's place in the block
  const int g = tid - grp * G;  // the thread's place in its lane
  const long long lane = (long long)blockIdx.x * kLanes<N> + grp;
  const unsigned mask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (wl - g);

  // 1/k, k = 0..degree+1, per warp; each group's zero entries
  T* inv = s_inv[tid >> 5];
  for (int k = wl; k <= degree + 1; k += 32) inv[k] = k ? div_rn(T(1), T(k)) : T(0);
  T* buf = &s_buf[grp][0][0];
  if (g == 0) buf[N] = buf[kBuf + N] = T(0);
  __syncwarp();
  if (lane >= B) return;

  // the lane's sub-step count m, step h and scaled rates cs = coeffs * h
  // (kernels/expm.py `substep_counts`), computed alike by its threads
  const T* cl = coeffs + lane * c_ld;
  const T t = tv[lane * t_ld];
  T nb = mul_rn(fabs(cl[0]), norms[0]);
#pragma unroll
  for (int c = 1; c < C; ++c) nb = add_rn(nb, mul_rn(fabs(cl[c]), norms[c]));
  nb = mul_rn(nb, t);
  const bool over = !(nb <= nb_cap);  // NaN rates too
  if (over) nb = T(0);
  const T mf = fmin(fmax(ceil(mul_rn(nb, inv_theta)), T(1)), T(cap));
  const int m = (int)mf;
  const T h = div_rn(t, mf);

  int js[SPT];
  T p[SPT], acc[SPT];
  bool finite = true;
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    js[s] = g + s * G;
    p[s] = js[s] < N ? p0[lane * N + js[s]] : T(0);
    acc[s] = T(0);
    finite = finite && isfinite(p[s]);
  }
  const bool all_finite = __all_sync(mask, finite);

  int phase = 0;
  if (!over && !(t == T(0) && all_finite)) {
    // this thread's states' generator entries and their sources, formed once
    T cs[C];
#pragma unroll
    for (int c = 0; c < C; ++c) cs[c] = mul_rn(cl[c], h);
    T gv[SPT][L];
    int gi[SPT][L];
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const bool live = js[s] < N;
        const int sl = live ? slot[js[s] * L + l] : nnz;
        gi[s][l] = live ? src[js[s] * L + l] : N;
        T v = T(0);
        if (sl < nnz) {
          v = mul_rn(cs[0], vals[sl]);
#pragma unroll
          for (int c = 1; c < C; ++c) v = add_rn(v, mul_rn(cs[c], vals[c * nnz + sl]));
        }
        gv[s][l] = v;
      }
    }
    for (int st = 0; st < m; ++st) {
      T term[SPT], ev[SPT], pv[SPT];
#pragma unroll
      for (int s = 0; s < SPT; ++s) term[s] = ev[s] = pv[s] = p[s];
      for (int k = 1; k <= degree; ++k) {
        T* cur = buf + phase * kBuf;
        phase ^= 1;
#pragma unroll
        for (int s = 0; s < SPT; ++s)
          if (js[s] < N) cur[js[s]] = term[s];
        __syncwarp(mask);
        const T ik = inv[k], ik1 = inv[k + 1];
#pragma unroll
        for (int s = 0; s < SPT; ++s) {
          T a = mul_rn(cur[gi[s][0]], gv[s][0]);
#pragma unroll
          for (int l = 1; l < L; ++l) a = add_rn(a, mul_rn(cur[gi[s][l]], gv[s][l]));
          term[s] = mul_rn(a, ik);
          ev[s] = add_rn(ev[s], term[s]);
          pv[s] = add_rn(pv[s], mul_rn(term[s], ik1));
        }
      }
#pragma unroll
      for (int s = 0; s < SPT; ++s) {
        p[s] = ev[s];
        acc[s] = add_rn(acc[s], mul_rn(h, pv[s]));
      }
    }
  }
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    if (over) p[s] = acc[s] = quiet_nan();
    if (js[s] < N) {
      ep[lane * N + js[s]] = p[s];
      n1p[lane * N + js[s]] = acc[s];
    }
  }
  if (proj != nullptr) {
    // the buffer the last term did not use: every thread is past its reads
    T* cur = buf + phase * kBuf;
#pragma unroll
    for (int s = 0; s < SPT; ++s)
      if (js[s] < N) cur[js[s]] = acc[s];
    __syncwarp(mask);
    for (int q = g; q < Q; q += G) {
      T a = T(0);
#pragma unroll
      for (int i = 0; i < N; ++i) a = fma(cur[i], __ldg(jsfs + i * Q + q), a);
      if (catmask != nullptr) a = mul_rn(a, catmask[lane * cm_ld + q]);
      proj[lane * Q + q] = a;
    }
  }
}

template <int N, int C, int L>
int launch(const void* src, const void* slot, const void* vals, int nnz, const void* coeffs,
           long long c_ld, const void* norms, const void* tv, long long t_ld, const void* p0,
           const void* jsfs, int Q, const void* catmask, long long cm_ld, void* ep, void* n1p,
           void* proj, int B, double theta, int cap, int degree, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((B + kLanes<N> - 1) / kLanes<N>);
  // torch divides a tensor by a Python scalar as a product with its reciprocal
  const T inv_theta = T(1) / T(theta);
  expm_action_kernel<N, C, L><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(src), static_cast<const int*>(slot), static_cast<const T*>(vals),
      nnz, static_cast<const T*>(coeffs), c_ld, static_cast<const T*>(norms),
      static_cast<const T*>(tv), t_ld, static_cast<const T*>(p0), static_cast<const T*>(jsfs), Q,
      static_cast<const T*>(catmask), cm_ld, static_cast<T*>(ep), static_cast<T*>(n1p),
      static_cast<T*>(proj), B, inv_theta, T(theta * cap), cap, degree);
  return (int)cudaGetLastError();
}

template <int N, int C, int L>
void attrs_of(int* out) {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, expm_action_kernel<N, C, L>) != cudaSuccess) {
    out[0] = out[1] = out[2] = -1;
    return;
  }
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, expm_action_kernel<N, C, L>, kThreads,
                                                0);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
}

}  // namespace

// (n, C, L) is (44, 4, 5) (the pre-split basis) or (8, 1, 3) (the post-split
// one).  src, slot (n, L) int32 and vals (C, nnz): the basis's nonzeros;
// coeffs (B, C) with lane stride c_ld; t with lane stride t_ld (0: one t for
// every lane); p0, ep, n1p (B, n) contiguous; jsfs (n, Q) or null (then proj
// is not written); catmask (Q) per lane with stride cm_ld (0: shared) or
// null.  Launches on `device` (made current for the call) and `stream`.
// Returns the CUDA error of the launch.
extern "C" int misti_expm_action(const void* src, const void* slot, const void* vals, int nnz,
                                 int L, const void* coeffs, long long c_ld, const void* norms,
                                 const void* tv, long long t_ld, const void* p0, const void* jsfs,
                                 int Q, const void* catmask, long long cm_ld, void* ep, void* n1p,
                                 void* proj, int B, int n, int C, double theta, int cap,
                                 int degree, int device, void* stream) {
  if (B < 1 || nnz < 1 || degree < 1 || degree > kMaxDegree || cap < 1 || !(theta > 0) ||
      (jsfs == nullptr) != (proj == nullptr) || Q < 0 || Q > n || (jsfs == nullptr && Q != 0))
    return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  auto st = static_cast<cudaStream_t>(stream);
  int err = (int)cudaErrorInvalidValue;
  if (n == 44 && C == 4 && L == 5)
    err = launch<44, 4, 5>(src, slot, vals, nnz, coeffs, c_ld, norms, tv, t_ld, p0, jsfs, Q,
                           catmask, cm_ld, ep, n1p, proj, B, theta, cap, degree, st);
  else if (n == 8 && C == 1 && L == 3)
    err = launch<8, 1, 3>(src, slot, vals, nnz, coeffs, c_ld, norms, tv, t_ld, p0, jsfs, Q,
                          catmask, cm_ld, ep, n1p, proj, B, theta, cap, degree, st);
  if (prev != device) cudaSetDevice(prev);
  return err;
}

// Per instance ((44, 4, 5), then (8, 1, 3)): registers per thread, local
// (spill) bytes per thread, resident blocks per SM.
extern "C" int misti_expm_action_attrs(int* out) {
  attrs_of<44, 4, 5>(out);
  attrs_of<8, 1, 3>(out + 3);
  return (int)cudaGetLastError();
}
