// The spectrum's per-interval action (E p0, N1 p0) of a CTMC generator, for
// Hopper (sm_90a): one launch per interval, a warp per lane, on the
// spectrum's per-interval path (the plain version of the one-launch spectrum,
// spectrum.cu).  Float64 only: the likelihood's dtype (config.LLH_DTYPE).
//
// For lane b with rates coeffs[b, :] (C of them) and interval length t[b]
// this runs one interval of the series in expm_series.cuh (shared with the
// one-launch spectrum, spectrum.cu, so that each interval's values are the
// same in both) and writes E p0 and N1 p0.  Optionally the epilogue projects
// N1 p0 onto the JSFS categories:
// proj[b, q] = (sum_k acc[b, k] * jsfs[k, q]) * catmask[b, q].
//
// Replaces: kernels/expm.py `expm_action_pair_plain` as a loop of torch ops
// (the JAX package's XLA loop, misti_tpu/kernels/expm.py:235-310; no
// pallas_call).
//
// At n = 44 the four bases' union has 196 nonzeros (L = 5), at n = 8 it
// has 18 (L = 3): the work per term is that of the lane's own sparse
// generator, not C dense (n, n) matvecs over the stacked basis.
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
// the plain version gives on the card (the order and roundings are set out
// in expm_series.cuh).  The projection is row_matmul's FMA chain (the plain
// version calls it).

#include "expm_series.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps a block
constexpr int kWarps = kThreads / 32;
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
  fill_inverses(inv, degree, wl);
  T* buf = &s_buf[grp][0][0];
  if (g == 0) buf[N] = buf[kBuf + N] = T(0);
  __syncwarp();
  if (lane >= B) return;

  const T* cl = coeffs + lane * c_ld;
  T rate[C];
#pragma unroll
  for (int c = 0; c < C; ++c) rate[c] = cl[c];
  T p[SPT], acc[SPT];
#pragma unroll
  for (int s = 0; s < SPT; ++s) p[s] = g + s * G < N ? p0[lane * N + g + s * G] : T(0);
  int phase = 0;
  interval<N, C, L>(src, slot, vals, nnz, rate, norms, tv[lane * t_ld], inv_theta, nb_cap, cap,
                    degree, inv, buf, phase, mask, g, p, acc);
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    const int j = g + s * G;
    if (j < N) {
      ep[lane * N + j] = p[s];
      n1p[lane * N + j] = acc[s];
    }
  }
  if (proj != nullptr) {
    const T* cur = stage<N>(acc, buf, phase, mask, g);
    for (int q = g; q < Q; q += G) {
      T a = fma_chain<N>(cur, 1, jsfs, Q, q);
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
