// Row-vector products of the spectrum, for Hopper (sm_90a), with a result
// per lane that does not depend on the batch.  Float64 only: the
// likelihood's dtype (config.LLH_DTYPE).
//
//   out[b, j] = sum_c cs[b, c] * (sum_k v[b, k] * K[k, c*m + j])
//
// v (B, n), K (n, C*m) and cs (B, C) row-major; cs may be null (C = 1,
// weight 1).  Its one job: the products with a constant matrix of the
// spectrum's per-interval path (engine/likelihood.py jafs_spectrum_plain),
// which on the card is the reference the one-launch spectrum (spectrum.cu)
// is held to: the collapse map (B, 44) @ (44, 8), the last interval's
// (B, 8) @ (8, 7), the ancient-sample map (B, 44) @ (44, 44) and each
// interval's JSFS projection (B, 44) @ (44, 7) and (B, 8) @ (8, 7).  No
// path of the program launches it.  The weighted form (the stacked basis,
// C = 4) serves the width probe.
//
// Why a kernel: spectrum.cu computes these products as this kernel's
// chains (expm_series.cuh fma_chain), so the reference keeps the kernel's
// bits; a library GEMM picks its algorithm (tile shape, split of the
// reduction) by the problem's size, so its product is neither that chain
// nor the same for a lane in every batch width.  Here every output has a
// fixed order: for each c a chain of fused multiply-adds over k = 0..n-1,
// then the c terms in order c = 0..C-1.
//
// What bounds it: a few hundred flops per output and a few KB per call, so
// the launch and the host's wrapper.  The design keeps the device side to
// one pass of coalesced loads: a block of kThreads threads takes kRows
// lanes, stages K (at most 44 x 44 on the path, 15.5 KB) and its lanes' v
// rows (and weights) in shared memory with neighbouring threads on
// neighbouring words, then each thread computes outputs from there.  A K
// past 48 KB (the stacked basis, 62 KB) takes the dynamic shared-memory
// attribute at its launch.
//
// Matches its plain version (the same sums in torch ops) to a tolerance,
// not bitwise: FMA contraction and the library's order differ.

#include <cuda_runtime.h>

namespace {

using T = double;
constexpr int kThreads = 256;
constexpr int kRows = 32;  // lanes per block
constexpr size_t kStaticLimit = 48 * 1024;
constexpr size_t kMaxShared = 227 * 1024;

size_t smem_bytes(int n, int m, int C) {
  return sizeof(T) * ((size_t)n * C * m + (size_t)kRows * n + (size_t)kRows * C);
}

__global__ void __launch_bounds__(kThreads)
row_matmul_kernel(const T* __restrict__ v, const T* __restrict__ K, const T* __restrict__ cs,
                  T* __restrict__ out, int B, int n, int m, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = C * m;
  T* ks = reinterpret_cast<T*>(smem_raw);  // (n, C*m)
  T* vs = ks + n * ld;                     // (kRows, n)
  T* ws = vs + kRows * n;                  // (kRows, C)
  const long long b0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, (long long)B - b0);
  for (int i = threadIdx.x; i < n * ld; i += kThreads) ks[i] = __ldg(K + i);
  for (int i = threadIdx.x; i < rows * n; i += kThreads) vs[i] = __ldg(v + b0 * n + i);
  if (cs != nullptr)
    for (int i = threadIdx.x; i < rows * C; i += kThreads) ws[i] = __ldg(cs + b0 * C + i);
  __syncthreads();
  for (int o = threadIdx.x; o < rows * m; o += kThreads) {
    const int r = o / m;
    const int j = o - r * m;
    const T* vr = vs + r * n;
    T res = T(0);
    for (int c = 0; c < C; ++c) {
      const T* kc = ks + c * m + j;
      T acc = T(0);
      for (int k = 0; k < n; ++k) acc = fma(vr[k], kc[k * ld], acc);
      if (cs == nullptr) {
        res = acc;
      } else {
        const T w = ws[r * C + c];
        res = (c == 0) ? w * acc : fma(w, acc, res);
      }
    }
    out[(b0 + r) * m + j] = res;
  }
}

}  // namespace

// Launches on `device` (made current for the call) and `stream`; returns
// the CUDA error of the launch.
extern "C" int misti_row_matmul(const void* v, const void* K, const void* cs, void* out, int B,
                                int n, int m, int C, int device, void* stream) {
  if (B < 1 || n < 1 || m < 1 || C < 1 || (cs == nullptr && C != 1))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(n, m, C);
  if (bytes > kMaxShared) return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  // the attribute holds per device: set it for this one when it is needed
  if (e == cudaSuccess && bytes > kStaticLimit)
    e = cudaFuncSetAttribute(row_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (e == cudaSuccess) {
    const unsigned blocks = (unsigned)((B + kRows - 1) / kRows);
    row_matmul_kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(v), static_cast<const T*>(K), static_cast<const T*>(cs),
        static_cast<T*>(out), B, n, m, C);
    e = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)e;
}

// Registers per thread, local (spill) bytes per thread and resident blocks
// per SM at the path's largest product, (B, 44) @ (44, 44).
extern "C" int misti_row_matmul_attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, row_matmul_kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, row_matmul_kernel, kThreads,
                                                    smem_bytes(44, 44, 1));
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
  return (int)e;
}
