// The whole JSFS spectrum of a likelihood call in one launch, for Hopper
// (sm_90a): a warp per lane.  Float64 only: the likelihood's dtype
// (config.LLH_DTYPE).
//
// Per lane (engine/likelihood.py `jafs_spectrum_plain`, JAFSpectrum in
// MigrationInference.py:467-506):
// 1. p0 = e_2 over the 44 two-population states; for each of the s
//    pre-split intervals t: the ancient-sample map (p0 @ ancient^T) where
//    the sample enters the lane before t, the pulse operators P(pu[t, pop])
//    where pulse_site[t, pop] is set, then one interval of the series
//    (expm_series.cuh) at rates (lc[t, 0], lc[t, 1], mi[t, 0], mi[t, 1]) and
//    length T_pre[t], and the term (N1 p0 @ jsfs2) * catmask[t];
// 2. the ancient map where the sample enters at the split, then the
//    collapse onto the 8 one-population states (p0 @ collapse^T);
// 3. for each of the n_post post-split intervals: the series at rate
//    lc[s + t, 0] and length T_post[t], and the term N1 p0 @ jsfs1;
// 4. the last interval, T = infinity: the occupancy x = -M^-1 p0 of
//    M = lc[s + n_post, 0] * C1 (an 8 x 8 elimination with partial
//    pivoting), and its term x @ jsfs1;
// 5. out = (pre-split terms left to right) + ((post-split terms left to
//    right) + the last term).
// Nothing per interval leaves the chip: the lane's state stays in
// registers and its group's shared buffer, the sums in registers, and only
// the (B, 7) spectrum is written.
//
// Replaces: the host's loop over intervals in `jafs_spectrum_plain` on the
// card (a launch per interval, row_matmul for the ancient map, the collapse
// and the last term, torch ops for the pulses, the last interval's solve and
// ~54 adds).  No JAX counterpart is a pallas_call: the JAX package runs the
// spectrum as XLA loops (misti_tpu/kernels/expm.py:235-310).
//
// Design.  What bounds it is latency: per lane a chain of some hundreds of
// dependent sparse matvecs (each interval's sub-steps times the degree),
// the same chain the per-interval launches ran, now without a launch, an
// allocation and an HBM round trip between links.  So many independent
// lanes are in flight, each on as few threads as share a term:
// * a warp per lane for the 44-state intervals (thread g owns states g and
//   g + 32);
// * the lane stays on its warp for the 8-state intervals, on its first 8
//   threads (a state each; the other 24 leave).  Regrouping four lanes into
//   one warp would need a block-wide barrier after the lanes' 44-state
//   chains, which differ in length from lane to lane; the 8-state chain is
//   the shorter part;
// * every interval runs expm_series.cuh, whose values are those of its
//   plain version (kernels/expm.py expm_action_pair_plain) on the card, bit
//   for bit; the products with constant matrices are row_matmul's FMA
//   chains, so the carried state and the summed terms are bitwise those of
//   the per-interval path (jafs_spectrum_plain on the card).  The pulses
//   and the last interval's elimination follow their plain
//   versions' arithmetic, not their library's order: equal to a tolerance;
// * tables are read in place with a lane stride (0: one row for every
//   lane), so the host makes no copy.
// Shared memory is static and small (under 6 KB a block).

#include "expm_series.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps a block, a lane each
constexpr int kWarps = kThreads / 32;
constexpr int kN2 = 44, kC2 = 4, kL2 = 5;  // the pre-split basis
constexpr int kN1 = 8, kC1 = 1, kL1 = 3;   // the post-split basis
constexpr int kQ = 7;                      // JSFS categories
constexpr int kPulseA = 5;                 // powers r^0 .. r^4 of a pulse rate

// Every field is 8 bytes wide, so the host's ctypes mirror
// (kernels/spectrum.py `_Args`) has the same layout.
struct Args {
  // the constant tables (engine/likelihood.py `SpectrumBasis`)
  const int* src2;
  const int* slot2;
  const T* vals2;
  long long nnz2;
  const int* src1;
  const int* slot1;
  const T* vals1;
  long long nnz1;
  const T* norms2;
  const T* norms1;
  const T* ancT;     // (44, 44): ancient^T
  const T* colT;     // (44, 8): collapse^T
  const T* jsfs2;    // (44, 7)
  const T* jsfs1;    // (8, 7)
  const T* k1;       // (8, 8): C1^T
  const int* pidx;   // (2, 44, pulse_len, 3): src, a, k_src - a of each nonzero
  const T* pcoef;    // (2, 44, pulse_len): its count
  long long pulse_len;
  // per-call inputs: a lane stride (0: shared) and a row stride, in elements
  const T* lc;
  long long lc_ld, lc_rs;
  const T* mi;
  long long mi_ld, mi_rs;
  const T* pu;
  long long pu_ld, pu_rs;
  const T* t_pre;
  long long tp_ld;
  const T* t_post;
  long long tq_ld;
  const T* catmask;
  long long cm_ld, cm_rs;
  long long sample_row;             // -1: no sample before the split
  const unsigned char* sample;      // (lanes) with stride sample_ld; null: every lane
  long long sample_ld;
  long long rebase;                 // 1: the sample may enter at the split
  const unsigned char* rebase_mask; // null: every lane
  long long rebase_ld;
  const unsigned char* pulse_site;  // (s, 2); null: no pulse
  T* out;                           // (B, 7)
  T* parts;                         // (B, 3, 8) or null: the pre-split sum, the
                                    // post-split sum, p0 after the collapse's intervals
  long long B, s, n_post;
  double theta;
  long long cap, degree;
};

// p0 @ K (K (44, 44) row-major): each state its FMA chain, on the warp
template <int N>
__device__ __forceinline__ void map_states(T (&p)[kSpt<N>], const T* __restrict__ K, T* buf,
                                           int& phase, unsigned mask, int g) {
  const T* cur = stage<N>(p, buf, phase, mask, g);
#pragma unroll
  for (int s = 0; s < kSpt<N>; ++s) {
    const int j = g + s * kGroup<N>;
    if (j < N) p[s] = fma_chain<N>(cur, 1, K, N, j);
  }
}

// The pulse operator P(r) of source population `pop` on the lane's state:
// p'[d] = sum over row d's nonzeros (src, a) of
// count * r^a (1 - r)^(k_src - a) * p[src].  Where r^4 or p is not finite
// every state is NaN, as the dense product of the plain version gives.
__device__ __forceinline__ void pulse(T (&p)[2], T r, int pop, const Args& a, T* buf,
                                      int& phase, int g) {
  bool finite = isfinite(p[0]) && isfinite(p[1]);
  const T* cur = stage<kN2>(p, buf, phase, 0xffffffffu, g);
  T rp[kPulseA], qp[kPulseA];
  rp[0] = qp[0] = T(1);
  const T q = T(1) - r;
#pragma unroll
  for (int i = 1; i < kPulseA; ++i) {
    rp[i] = rp[i - 1] * r;
    qp[i] = qp[i - 1] * q;
  }
  const bool bad = !__all_sync(0xffffffffu, finite) || !isfinite(rp[kPulseA - 1]);
  const int len = (int)a.pulse_len;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int d = g + 32 * s;
    if (d >= kN2) continue;
    const int* e = a.pidx + ((long long)(pop * kN2 + d) * len) * 3;
    const T* c = a.pcoef + (long long)(pop * kN2 + d) * len;
    T v = T(0);
    for (int l = 0; l < len; ++l)
      v += c[l] * (rp[e[3 * l + 1]] * qp[e[3 * l + 2]]) * cur[e[3 * l]];
    p[s] = bad ? quiet_nan() : v;
  }
}

// x = A^-1 b by Gaussian elimination with partial pivoting, in place in
// the augmented (8, 9) matrix m (row stride 9); one thread
__device__ __forceinline__ void solve8(T* m) {
  for (int k = 0; k < kN1; ++k) {
    int piv = k;
    T big = fabs(m[k * 9 + k]);
    for (int i = k + 1; i < kN1; ++i)
      if (fabs(m[i * 9 + k]) > big) {
        big = fabs(m[i * 9 + k]);
        piv = i;
      }
    if (piv != k)
      for (int j = k; j <= kN1; ++j) {
        const T tmp = m[k * 9 + j];
        m[k * 9 + j] = m[piv * 9 + j];
        m[piv * 9 + j] = tmp;
      }
    for (int i = k + 1; i < kN1; ++i) {
      const T l = m[i * 9 + k] / m[k * 9 + k];
      for (int j = k + 1; j <= kN1; ++j) m[i * 9 + j] = fma(-l, m[k * 9 + j], m[i * 9 + j]);
    }
  }
  for (int i = kN1 - 1; i >= 0; --i) {
    T x = m[i * 9 + kN1];
    for (int j = i + 1; j < kN1; ++j) x = fma(-m[i * 9 + j], m[j * 9 + kN1], x);
    m[i * 9 + kN1] = x / m[i * 9 + i];
  }
}

__global__ void __launch_bounds__(kThreads) spectrum_kernel(const Args a, T inv_theta, T nb_cap) {
  __shared__ T s_inv[kWarps][kMaxDegree + 2];
  __shared__ T s_buf2[kWarps][2 * (kN2 + 1)];
  __shared__ T s_buf1[kWarps][2 * (kN1 + 1)];

  const int tid = threadIdx.x;
  const int g = tid & 31;  // the thread's place in its lane
  const int w = tid >> 5;
  const long long lane = (long long)blockIdx.x * kWarps + w;
  const int cap = (int)a.cap, degree = (int)a.degree;
  T* inv = s_inv[w];
  fill_inverses(inv, degree, g);
  T* buf2 = s_buf2[w];
  T* buf1 = s_buf1[w];
  if (g == 0) buf2[kN2] = buf2[2 * kN2 + 1] = buf1[kN1] = buf1[2 * kN1 + 1] = T(0);
  __syncwarp();
  if (lane >= a.B) return;

  const long long s_n = a.s, n_post = a.n_post;
  const T* lc = a.lc + lane * a.lc_ld;
  const T* mi = a.mi + lane * a.mi_ld;
  const T* pu = a.pu + lane * a.pu_ld;
  const T* cm = a.catmask + lane * a.cm_ld;

  // 1. the pre-split intervals on the warp
  T p[2] = {g == 2 ? T(1) : T(0), T(0)};
  T acc[2];
  T pre = T(0);  // on thread q < 7: the pre-split terms' sum of category q
  int phase = 0;
  for (long long t = 0; t < s_n; ++t) {
    if (t == a.sample_row && (a.sample == nullptr || a.sample[lane * a.sample_ld]))
      map_states<kN2>(p, a.ancT, buf2, phase, 0xffffffffu, g);
    if (a.pulse_site != nullptr)
      for (int pop = 0; pop < 2; ++pop)
        if (a.pulse_site[2 * t + pop])
          pulse(p, pu[t * a.pu_rs + pop], pop, a, buf2, phase, g);
    const T rate[kC2] = {lc[t * a.lc_rs], lc[t * a.lc_rs + 1], mi[t * a.mi_rs],
                         mi[t * a.mi_rs + 1]};
    interval<kN2, kC2, kL2>(a.src2, a.slot2, a.vals2, (int)a.nnz2, rate, a.norms2,
                            a.t_pre[lane * a.tp_ld + t], inv_theta, nb_cap, cap, degree, inv,
                            buf2, phase, 0xffffffffu, g, p, acc);
    const T* cur = stage<kN2>(acc, buf2, phase, 0xffffffffu, g);
    if (g < kQ) {
      const T term = mul_rn(fma_chain<kN2>(cur, 1, a.jsfs2, kQ, g), cm[t * a.cm_rs + g]);
      pre = t == 0 ? term : add_rn(pre, term);
    }
  }

  // 2. the sample at the split, the collapse to 8 states
  if (a.rebase && (a.rebase_mask == nullptr || a.rebase_mask[lane * a.rebase_ld]))
    map_states<kN2>(p, a.ancT, buf2, phase, 0xffffffffu, g);
  const T* cur2 = stage<kN2>(p, buf2, phase, 0xffffffffu, g);
  if (g >= kN1) return;
  T p1[1] = {fma_chain<kN2>(cur2, 1, a.colT, kN1, g)};

  // 3. the post-split intervals on the lane's first 8 threads
  constexpr unsigned m8 = 0xffu;
  T acc1[1];
  T post = T(0);
  int phase1 = 0;
  for (long long t = 0; t < n_post; ++t) {
    const T rate[kC1] = {lc[(s_n + t) * a.lc_rs]};
    interval<kN1, kC1, kL1>(a.src1, a.slot1, a.vals1, (int)a.nnz1, rate, a.norms1,
                            a.t_post[lane * a.tq_ld + t], inv_theta, nb_cap, cap, degree, inv,
                            buf1, phase1, m8, g, p1, acc1);
    const T* cur = stage<kN1>(acc1, buf1, phase1, m8, g);
    if (g < kQ) {
      const T term = fma_chain<kN1>(cur, 1, a.jsfs1, kQ, g);
      post = t == 0 ? term : add_rn(post, term);
    }
  }

  // 4. the last interval: M x = -p0 with M = lam * C1, one thread solving
  // in the 44-state buffer, which every thread has passed
  const T lam = lc[(s_n + n_post) * a.lc_rs];
  __syncwarp(m8);
  T* m = buf2;
#pragma unroll
  for (int j = 0; j < kN1; ++j) m[g * 9 + j] = mul_rn(lam, __ldg(a.k1 + j * kN1 + g));
  m[g * 9 + kN1] = -p1[0];
  __syncwarp(m8);
  if (g == 0) solve8(m);
  __syncwarp(m8);

  // 5. the terms in order
  if (g < kQ) {
    T tot = fma_chain<kN1>(m + kN1, 9, a.jsfs1, kQ, g);
    if (n_post > 0) tot = add_rn(post, tot);
    if (s_n > 0) tot = add_rn(pre, tot);
    a.out[lane * kQ + g] = tot;
  }
  if (a.parts != nullptr) {
    T* pt = a.parts + lane * 3 * kN1;
    pt[g] = g < kQ ? pre : T(0);
    pt[kN1 + g] = g < kQ ? post : T(0);
    pt[2 * kN1 + g] = p1[0];
  }
}

}  // namespace

// `args` points at an `Args` (a void pointer: a C function may not take a
// type of this file's anonymous namespace).  Launches on `device` (made
// current for the call) and `stream`; returns the CUDA error of the launch.
extern "C" int misti_spectrum(const void* args, int device, void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  if (a.B < 1 || a.s < 0 || a.n_post < 0 || a.degree < 1 || a.degree > kMaxDegree ||
      a.cap < 1 || !(a.theta > 0) || a.out == nullptr || (a.pulse_site && a.pulse_len < 1))
    return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((a.B + kWarps - 1) / kWarps);
  // torch divides a tensor by a Python scalar as a product with its reciprocal
  spectrum_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, T(1) / T(a.theta), T(a.theta * a.cap));
  e = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)e;
}

// sizeof(Args), for the host's mirror to check its layout against
extern "C" int misti_spectrum_args_size() { return (int)sizeof(Args); }

// Registers per thread, local (spill) bytes per thread, resident blocks per SM.
extern "C" int misti_spectrum_attrs(int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, spectrum_kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, spectrum_kernel, kThreads, 0);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = blocks;
  return (int)e;
}
