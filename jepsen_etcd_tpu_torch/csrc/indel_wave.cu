// Indel edit distance by an anti-diagonal wavefront, for Hopper (sm_90a).
//
// Replaces the reference's Pallas kernel jepsen_etcd_tpu/ops/edit_distance.py
// _wavefront_pallas (kernel body :103-159): for K logs b_k against one
// canonical log a, D[n, m_k] = n + m_k - 2 * LCS(a, b_k), the insert/delete
// distance with no substitution. It returns the same int32 per pair and is
// held against the plain PyTorch version wavefront_reference in
// ops/edit_distance.py.
//
// Shape: one thread block per pair, and a loop over the anti-diagonals
// kd = i + j = 0 .. n + m_k inside the block in place of the TPU kernel's
// in-kernel fori_loop. Diagonal kd holds D[i, kd - i] for the live lanes
// i in [max(0, kd - m), min(n, kd)] only; each thread takes every
// blockDim-th lane, and one __syncthreads() ends the step. Three rotating
// diagonals (kd, kd - 1, kd - 2) of n + 1 int32 lanes each live in shared
// memory when they fit (3 * (n + 1) * 4 bytes up to the opt-in limit,
// about n = 19,000 on an H100) and otherwise in a per-block slice of a
// global scratch buffer the wrapper allocates; __syncthreads() orders the
// block's global writes as it does its shared ones. a[i - 1] and
// b[kd - 1 - i] are read straight from device memory: neighbouring
// threads read neighbouring addresses (b backwards), so the loads
// coalesce. None of the TPU layout (the 8-row sublane pad, the 128-lane
// padding, the 128-aligned sliding window of b) carries over.
//
// What bounds it: the serial chain of n + m barrier-separated steps, not
// bytes or operations. A 12,000 x 12,000 pair is 24,000 steps of at most
// 12,001 cells each, about 12 cells per thread per step; five such pairs
// use five of the 132 SMs. A tiled or bit-parallel LCS that needs fewer
// block-wide barriers is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 1024;

template <bool SMEM>
__global__ void __launch_bounds__(MAX_THREADS)
indel_wave_kernel(const int32_t* __restrict__ a, int n,
                  const int32_t* __restrict__ b, int b_stride,
                  const int32_t* __restrict__ m_of,
                  int32_t* __restrict__ out, int32_t* scratch) {
  extern __shared__ int32_t dsm[];
  const int pair = blockIdx.x;
  const int m = m_of[pair];
  const int32_t* bp = b + (size_t)pair * b_stride;
  const int len = n + 1;
  int32_t* diag = SMEM ? dsm : scratch + (size_t)pair * 3 * len;
  for (int kd = 0; kd <= n + m; ++kd) {
    int32_t* cur = diag + (kd % 3) * len;
    const int32_t* prev1 = diag + ((kd + 2) % 3) * len;  // diagonal kd - 1
    const int32_t* prev2 = diag + ((kd + 1) % 3) * len;  // diagonal kd - 2
    const int lo = kd > m ? kd - m : 0;
    const int hi = kd < n ? kd : n;
    for (int i = lo + (int)threadIdx.x; i <= hi; i += blockDim.x) {
      const int j = kd - i;
      int32_t d;
      if (i == 0) {
        d = j;
      } else if (j == 0) {
        d = i;
      } else if (a[i - 1] == bp[j - 1]) {
        d = prev2[i - 1];                      // D[i-1, j-1]
      } else {
        d = min(prev1[i - 1], prev1[i]) + 1;   // D[i-1, j], D[i, j-1]
      }
      cur[i] = d;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[pair] = diag[((n + m) % 3) * len + n];
}

}  // namespace

extern "C" {

// Largest dynamic shared memory one block may opt in to on `device`.
int indel_wave_smem_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return bytes;
}

// a [n], b [K, b_stride], m [K] -> out [K], all int32 on the current
// device; scratch is K * 3 * (n + 1) int32 when use_smem is 0, else
// unused. Returns the launch's cudaError_t (0 = launched).
int indel_wave_launch(const int32_t* a, int n, const int32_t* b,
                      int b_stride, const int32_t* m, int32_t* out, int K,
                      int32_t* scratch, int use_smem, int threads,
                      void* stream) {
  if (K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_smem) {
    const size_t smem = (size_t)3 * (n + 1) * sizeof(int32_t);
    cudaError_t err = cudaFuncSetAttribute(
        indel_wave_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    indel_wave_kernel<true><<<K, threads, smem, s>>>(a, n, b, b_stride, m,
                                                     out, nullptr);
  } else {
    indel_wave_kernel<false><<<K, threads, 0, s>>>(a, n, b, b_stride, m,
                                                   out, scratch);
  }
  return (int)cudaGetLastError();
}

const char* indel_wave_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
