// Row-vector products of the spectrum, for Hopper (sm_90a), with a result
// per lane that does not depend on the batch.
//
//   out[b, j] = sum_c cs[b, c] * (sum_k v[b, k] * K[k, c*m + j])
//
// v (B, n), K (n, C*m) and cs (B, C) row-major; cs may be null (C = 1,
// weight 1).  This is the spectrum's Taylor sub-step matvec (the stacked
// basis [B_0^T | ... | B_{C-1}^T], kernels/expm.py `expm_action_pair`) and
// its other small products with a constant matrix (the JSFS projections,
// the ancient-sample and collapse maps), n <= 44, C*m <= 176.
//
// Why a kernel: a library GEMM picks its algorithm (tile shape, split of
// the reduction) by the problem's size, so a lane's float32 product, and
// with it the lane's llh, changed with the number of lanes in the batch.
// The sweep's staged compaction resumes a few cells in a narrow batch and
// needs each lane's value to be the one it had in the wide batch.  Here one
// thread computes one output with a fixed order: for each c a chain of
// fused multiply-adds over k = 0..n-1, then the c terms in order c = 0..C-1.
// The products are a few hundred flops per output and the card's time is
// the launch, so the simple form costs nothing against the library call.
//
// Matches its plain version (the same sums in torch ops) to a tolerance,
// not bitwise: FMA contraction and the library's order differ.

#include <cuda_runtime.h>

#ifndef MISTI_T
#define MISTI_T float
#endif

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_matmul_kernel(const T* __restrict__ v, const T* __restrict__ K,
                  const T* __restrict__ cs, T* __restrict__ out, int B, int n, int m, int C) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)B * m) return;
  const int b = (int)(i / m);
  const int j = (int)(i - (long long)b * m);
  const T* vb = v + (long long)b * n;
  const int ld = C * m;
  T res = T(0);
  for (int c = 0; c < C; ++c) {
    const T* kc = K + c * m + j;
    T acc = T(0);
    for (int k = 0; k < n; ++k) acc = fma(__ldg(vb + k), __ldg(kc + (long long)k * ld), acc);
    if (cs == nullptr) {
      res = acc;
    } else {
      const T w = __ldg(cs + (long long)b * C + c);
      res = (c == 0) ? w * acc : fma(w, acc, res);
    }
  }
  out[i] = res;
}

}  // namespace

extern "C" int misti_row_matmul(const void* v, const void* K, const void* cs, void* out,
                                int B, int n, int m, int C, void* stream) {
  using T = MISTI_T;
  if (B < 1 || n < 1 || m < 1 || C < 1 || (cs == nullptr && C != 1))
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * m;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  row_matmul_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(v), static_cast<const T*>(K), static_cast<const T*>(cs),
      static_cast<T*>(out), B, n, m, C);
  return (int)cudaGetLastError();
}
