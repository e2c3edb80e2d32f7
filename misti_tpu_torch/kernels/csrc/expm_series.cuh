// The spectrum's per-interval series, as the one-launch spectrum
// (spectrum.cu) runs it for every interval.  Float64 only.
//
// For a lane with rates r[0..C-1] the generator is M = sum_c r_c B_c over
// a constant stacked basis, and over an interval of length t the series
// takes (E p0, N1 p0) = (e^{M t} p0, int_0^t e^{M u} p0 du) (row vectors)
// in m Taylor sub-steps of degree `degree`:
// m = clamp(ceil(||M t||_1 / theta), 1, cap) (||M t||_1 bounded by
// sum_c |r_c| * ||B_c||_1 * t), h = t / m, cs = r * h, G = sum_c cs_c B_c,
// and per sub-step
//   term = p; ev = p; pv = p
//   for k = 1..degree: term = (term @ G^T) / k; ev += term; pv += term / (k+1)
//   p = ev; acc += h * pv.
// A lane past theta * cap (or with NaN rates) gets NaN in both; a lane with
// t == 0 keeps p0 and gets 0 (NaN where p0 is not finite).
//
// The basis comes as its nonzeros (kernels/expm.py `SparseBasis`): output
// state j sums term[src[j, l]] * G[slot[j, l]] over l < L, padded with a
// zero term entry (src = n) and a zero slot (slot = nnz).
//
// A lane is a group of kGroup<N> threads (a warp at n = 44, 8 threads at
// n = 8); thread g of the group owns states g, g + G, ...  A term passes
// through the group's double buffer in shared memory (n + 1 words, the last
// a zero for the pads) with one __syncwarp per term.  Every use of the
// buffer flips `phase`, so a write never meets a read of the same half
// that has not passed a __syncwarp.
//
// Each value is the one the plain version (kernels/expm.py
// `expm_action_pair_plain`) gives on the card: G is formed in
// the same order (a product, then for each further basis a product and an
// add), each column's nonzeros are summed in order, and each add and
// product is rounded on its own (__*_rn: never contracted into FMAs), as
// torch's elementwise ops do; torch's division by a Python scalar is its
// product with the reciprocal.  A product with a constant matrix is
// row_matmul's FMA chain (`fma_chain`).

#pragma once

#include <cuda_runtime.h>

namespace {

using T = double;
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

// 1/k, k = 0..degree+1, into a warp's table (`wl` the thread's place in it)
__device__ __forceinline__ void fill_inverses(T* inv, int degree, int wl) {
  for (int k = wl; k <= degree + 1; k += 32) inv[k] = k ? div_rn(T(1), T(k)) : T(0);
}

// The group writes its states `x` into the half `phase` of its buffer and
// syncs; returns that half (n values and the pads' zero) and flips `phase`.
template <int N>
__device__ __forceinline__ const T* stage(const T (&x)[kSpt<N>], T* buf, int& phase,
                                          unsigned mask, int g) {
  T* cur = buf + phase * (N + 1);
  phase ^= 1;
#pragma unroll
  for (int s = 0; s < kSpt<N>; ++s)
    if (g + s * kGroup<N> < N) cur[g + s * kGroup<N>] = x[s];
  __syncwarp(mask);
  return cur;
}

// sum_i v[i * vs] * K[i * ld + col] over i < N: row_matmul's chain of
// fused multiply-adds from 0, in order
template <int N>
__device__ __forceinline__ T fma_chain(const T* v, int vs, const T* __restrict__ K, int ld,
                                       int col) {
  T a = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i) a = fma(v[i * vs], __ldg(K + i * ld + col), a);
  return a;
}

// One interval for one lane on its group: p holds the thread's states of p0
// on entry (0 where a slot is past n) and E p0 on return; acc gets N1 p0.
// rate: the lane's C rates; t: its interval length.
template <int N, int C, int L>
__device__ __forceinline__ void interval(const int* __restrict__ src, const int* __restrict__ slot,
                                         const T* __restrict__ vals, int nnz, const T (&rate)[C],
                                         const T* __restrict__ norms, T t, T inv_theta, T nb_cap,
                                         int cap, int degree, const T* inv, T* buf, int& phase,
                                         unsigned mask, int g, T (&p)[kSpt<N>],
                                         T (&acc)[kSpt<N>]) {
  constexpr int G = kGroup<N>;
  constexpr int SPT = kSpt<N>;
  constexpr int kBuf = N + 1;
  // the sub-step count m, step h and scaled rates cs = rate * h
  // (kernels/expm.py `substep_counts`), computed alike by the group's threads
  T nb = mul_rn(fabs(rate[0]), norms[0]);
#pragma unroll
  for (int c = 1; c < C; ++c) nb = add_rn(nb, mul_rn(fabs(rate[c]), norms[c]));
  nb = mul_rn(nb, t);
  const bool over = !(nb <= nb_cap);  // NaN rates too
  if (over) nb = T(0);
  const T mf = fmin(fmax(ceil(mul_rn(nb, inv_theta)), T(1)), T(cap));
  const int m = (int)mf;
  const T h = div_rn(t, mf);

  int js[SPT];
  bool finite = true;
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    js[s] = g + s * G;
    acc[s] = T(0);
    finite = finite && isfinite(p[s]);
  }
  const bool all_finite = __all_sync(mask, finite);

  if (!over && !(t == T(0) && all_finite)) {
    // this thread's states' generator entries and their sources, formed once
    T cs[C];
#pragma unroll
    for (int c = 0; c < C; ++c) cs[c] = mul_rn(rate[c], h);
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
  if (over) {
#pragma unroll
    for (int s = 0; s < SPT; ++s)
      if (js[s] < N) p[s] = acc[s] = quiet_nan();
  }
}

}  // namespace
