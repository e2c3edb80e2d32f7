// The spectrum's per-interval action (E p0, N1 p0) of a CTMC generator, for
// Hopper (sm_90a): one launch per interval instead of a launch per Taylor
// term.  Float64 only: the likelihood's dtype (config.LLH_DTYPE).
//
// For lane b with rates coeffs[b, :] (C of them), the generator is
// M_b = sum_c coeffs[b, c] * B_c over a constant stacked basis
// kmat = [B_0^T | ... | B_{C-1}^T] (n, C*n), and over an interval of length
// t[b] this computes E p0 = e^{M t} p0 and N1 p0 = int_0^t e^{M u} p0 du
// (row vectors, p0 (B, n)) by m Taylor sub-steps of degree `degree`:
// m = clamp(ceil(||M t||_1 / theta), 1, cap) (with ||M t||_1 bounded by
// sum_c |coeffs_c| * ||B_c||_1 * t), h = t / m, and per sub-step
//   term = p; ev = p; pv = p
//   for k = 1..degree: term = (term @ M h) / k; ev += term; pv += term / (k+1)
//   p = ev; acc += h * pv.
// A lane past theta * cap (or with NaN rates) returns NaN in both; a lane
// with t == 0 takes one zero-length sub-step and returns p0 and 0 exactly.
// Optionally the epilogue projects N1 p0 onto the JSFS categories:
// proj[b, q] = (sum_k acc[b, k] * jsfs[k, q]) * catmask[b, q].
//
// Replaces: kernels/expm.py `expm_action_pair_plain`, a loop of one
// row_matmul launch and four elementwise launches per Taylor term (the JAX
// package's XLA loop, misti_tpu/kernels/expm.py:235-310; no pallas_call).
//
// Design.  A block holds L = 384 / n lanes (8 at n = 44, 48 at n = 8), one
// thread per (lane, state j), which keeps term_j, ev_j, pv_j and acc_j in
// registers.  The basis is staged once in shared memory (44 x 176: 61,952 B)
// and read from there for every term of every sub-step; a term vector is
// published through a double buffer in shared memory, one barrier per term.
// The block runs to the largest m of its own lanes; a lane past its own m
// keeps its state.  Per lane, sub-step and term it does C dense (n, n)
// matvecs, one per basis (the plain loop's order): C times the work of one
// matvec with the lane's generator, more still over the bases' zeros.  No
// tensor cores.
//
// A lane's value does not depend on its batch, and each value is the one
// the plain loop gives on the card: the matvec is row_matmul's order (for
// each c an FMA chain over k from 0, then the c terms, the first a product
// and the rest FMAs), torch's division by a Python scalar is its product
// with the reciprocal, and the adds and products of the loop are rounded
// one by one (__*_rn: never contracted into FMAs).

#include <cuda_runtime.h>

namespace {

using T = double;
constexpr int kThreads = 384;  // lanes per block = kThreads / n
constexpr int kMaxDegree = 32;

__device__ __forceinline__ T add_rn(T a, T b) { return __dadd_rn(a, b); }
__device__ __forceinline__ T mul_rn(T a, T b) { return __dmul_rn(a, b); }
__device__ __forceinline__ T div_rn(T a, T b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ T quiet_nan() { return __longlong_as_double(0x7ff8000000000000LL); }

template <int N>
constexpr int kLanes = kThreads / N;  // lanes per block

template <int N, int C>
constexpr size_t smem_bytes(int Q) {
  return sizeof(T) * ((size_t)N * C * N + (size_t)N * Q + 2 * (size_t)kLanes<N> * N +
                      (kMaxDegree + 2));
}

template <int N, int C>
__global__ void __launch_bounds__(kLanes<N> * N)
expm_action_kernel(const T* __restrict__ kmat, const T* __restrict__ coeffs, long long c_ld,
                   const T* __restrict__ norms, const T* __restrict__ tv, long long t_ld,
                   const T* __restrict__ p0, const T* __restrict__ jsfs, int Q,
                   const T* __restrict__ catmask, long long cm_ld, T* __restrict__ ep,
                   T* __restrict__ n1p, T* __restrict__ proj, int B, T inv_theta, T nb_cap,
                   int cap, int degree) {
  constexpr int L = kLanes<N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // (N, C*N)
  T* js = ks + N * C * N;                  // (N, Q)
  T* buf = js + N * Q;                     // 2 x (L, N)
  T* inv = buf + 2 * L * N;                // 1/k, k = 0..degree+1
  __shared__ int s_mmax;

  const int tid = threadIdx.x;
  const int ll = tid / N;
  const int j = tid - ll * N;
  const long long lane = (long long)blockIdx.x * L + ll;
  const bool act = lane < B;

  for (int i = tid; i < N * C * N; i += L * N) ks[i] = kmat[i];
  for (int i = tid; i < N * Q; i += L * N) js[i] = jsfs[i];
  if (tid <= degree + 1) inv[tid] = tid ? div_rn(T(1), T(tid)) : T(0);
  if (tid == 0) s_mmax = 1;

  // the lane's sub-step count m, step h and scaled rates cs = coeffs * h
  // (kernels/expm.py `substep_counts`), computed alike by its n threads
  T cs[C];
  T h = T(0);
  int m = 0;
  bool over = false;
  T p = T(0);
  if (act) {
    const T* cl = coeffs + lane * c_ld;
    const T t = tv[lane * t_ld];
    T nb = mul_rn(fabs(cl[0]), norms[0]);
#pragma unroll
    for (int c = 1; c < C; ++c) nb = add_rn(nb, mul_rn(fabs(cl[c]), norms[c]));
    nb = mul_rn(nb, t);
    over = !(nb <= nb_cap);  // NaN rates too
    if (over) nb = T(0);
    const T mf = fmin(fmax(ceil(mul_rn(nb, inv_theta)), T(1)), T(cap));
    m = (int)mf;
    h = div_rn(t, mf);
#pragma unroll
    for (int c = 0; c < C; ++c) cs[c] = mul_rn(cl[c], h);
    p = p0[lane * N + j];
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) cs[c] = T(0);
  }
  __syncthreads();
  if (act && j == 0) atomicMax(&s_mmax, m);
  __syncthreads();
  const int mmax = s_mmax;

  T acc = T(0);
  int phase = 0;
  for (int s = 0; s < mmax; ++s) {
    T term = p, ev = p, pv = p;
    for (int k = 1; k <= degree; ++k) {
      T* cur = buf + phase * (L * N) + ll * N;
      phase ^= 1;
      cur[j] = term;
      __syncthreads();
      T res = T(0);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const T* kc = ks + c * N + j;
        T a = T(0);
#pragma unroll
        for (int i = 0; i < N; ++i) a = fma(cur[i], kc[i * (C * N)], a);
        res = (c == 0) ? mul_rn(cs[0], a) : fma(cs[c], a, res);
      }
      term = mul_rn(res, inv[k]);
      ev = add_rn(ev, term);
      pv = add_rn(pv, mul_rn(term, inv[k + 1]));
    }
    if (s < m) {
      p = ev;
      acc = add_rn(acc, mul_rn(h, pv));
    }
  }
  if (over) {
    p = quiet_nan();
    acc = quiet_nan();
  }
  if (act) {
    ep[lane * N + j] = p;
    n1p[lane * N + j] = acc;
  }
  if (proj != nullptr) {  // uniform over the block
    T* cur = buf + phase * (L * N) + ll * N;
    cur[j] = acc;
    __syncthreads();
    if (act && j < Q) {
      T a = T(0);
#pragma unroll
      for (int i = 0; i < N; ++i) a = fma(cur[i], js[i * Q + j], a);
      if (catmask != nullptr) a = mul_rn(a, catmask[lane * cm_ld + j]);
      proj[lane * Q + j] = a;
    }
  }
}

template <int N, int C>
int launch(const void* kmat, const void* coeffs, long long c_ld, const void* norms,
           const void* tv, long long t_ld, const void* p0, const void* jsfs, int Q,
           const void* catmask, long long cm_ld, void* ep, void* n1p, void* proj, int B,
           double theta, int cap, int degree, cudaStream_t stream) {
  auto kern = expm_action_kernel<N, C>;
  const size_t bytes = smem_bytes<N, C>(Q);
  // the attribute holds per device: set it for the current one at every launch
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<N, C>(N));
  if (e != cudaSuccess) return (int)e;
  constexpr int L = kLanes<N>;
  const unsigned blocks = (unsigned)((B + L - 1) / L);
  // torch divides a tensor by a Python scalar as a product with its reciprocal
  const T inv_theta = T(1) / T(theta);
  kern<<<blocks, L * N, bytes, stream>>>(
      static_cast<const T*>(kmat), static_cast<const T*>(coeffs), c_ld,
      static_cast<const T*>(norms), static_cast<const T*>(tv), t_ld,
      static_cast<const T*>(p0), static_cast<const T*>(jsfs), Q,
      static_cast<const T*>(catmask), cm_ld, static_cast<T*>(ep), static_cast<T*>(n1p),
      static_cast<T*>(proj), B, inv_theta, T(theta * cap), cap, degree);
  return (int)cudaGetLastError();
}

template <int N, int C>
void attrs_of(int* out) {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, expm_action_kernel<N, C>) != cudaSuccess) {
    out[0] = out[1] = out[2] = -1;
    return;
  }
  cudaFuncSetAttribute(expm_action_kernel<N, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_bytes<N, C>(N));
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, expm_action_kernel<N, C>, kLanes<N> * N, smem_bytes<N, C>(7));
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
}

}  // namespace

// (n, C) is (44, 4) (the pre-split basis) or (8, 1) (the post-split one).
// coeffs (B, C) with lane stride c_ld; t with lane stride t_ld (0: one t for
// every lane); p0, ep, n1p (B, n) contiguous; jsfs (n, Q) or null (then
// proj is not written); catmask (Q) per lane with stride cm_ld (0: shared)
// or null.  Returns the CUDA error of the launch.
extern "C" int misti_expm_action(const void* kmat, const void* coeffs, long long c_ld,
                                 const void* norms, const void* tv, long long t_ld,
                                 const void* p0, const void* jsfs, int Q, const void* catmask,
                                 long long cm_ld, void* ep, void* n1p, void* proj, int B, int n,
                                 int C, double theta, int cap, int degree, void* stream) {
  if (B < 1 || degree < 1 || degree > kMaxDegree || cap < 1 || !(theta > 0) ||
      (jsfs == nullptr) != (proj == nullptr) || Q < 0 || Q > n || (jsfs == nullptr && Q != 0))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (n == 44 && C == 4)
    return launch<44, 4>(kmat, coeffs, c_ld, norms, tv, t_ld, p0, jsfs, Q, catmask, cm_ld,
                            ep, n1p, proj, B, theta, cap, degree, st);
  if (n == 8 && C == 1)
    return launch<8, 1>(kmat, coeffs, c_ld, norms, tv, t_ld, p0, jsfs, Q, catmask, cm_ld, ep,
                           n1p, proj, B, theta, cap, degree, st);
  return (int)cudaErrorInvalidValue;
}

// Per instance ((44, 4), then (8, 1)): registers per thread, local (spill)
// bytes per thread, resident blocks per SM with a 7-category projection.
extern "C" int misti_expm_action_attrs(int* out) {
  attrs_of<44, 4>(out);
  attrs_of<8, 1>(out + 3);
  return (int)cudaGetLastError();
}
