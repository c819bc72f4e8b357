// The epoch-v3 generator's register drain, one thread per seed, for Hopper
// (sm_90a).
//
// Replaces the reference's XLA scan jepsen_etcd_tpu/simbatch/engine_jax.py
// _drain_register (:159): one lax.scan step per completion, in drain order,
// every seed advanced at once. The carry is each seed's register machine:
// for K keys the version and value, and the previous pair that a stale read
// returns (ver, val, pver, pval). Step n of seed s reads the completion's
// key, f, write value, CAS old and new values, its timeout flag and its
// stale gate, updates the machine and emits five int32: the type code, the
// payload kind and the three payload slots (tc, pk, va, vb, vc). A timed-out
// completion leaves the machine as it was and emits TC_OK, PK_REG_CAS_FAIL,
// va = co, vb = cn, vc = -1, as the scan does; the host overlays those rows
// afterwards. The plain PyTorch version is drain_register_reference in
// simbatch/engine_v3.py, and the kernel equals it on all five planes at
// every row.
//
// Layout: inputs and outputs are (N, S) planes, row n the n-th completion
// of every seed, so the S threads of a step read and write adjacent words.
// A thread loops over its seed's N completions; the machine lives in shared
// memory, word (j * K + k) * blockDim.x + thread for state j (ver, val, pver,
// pval) of key k, so the threads of a warp touch distinct banks. When
// 16 * K * blockDim.x bytes exceed drain_register_smem_max(), the wrapper
// hands a global scratch of 4 * K * S words instead, laid out (j * K + k) * S
// + seed; the launch refuses a state that does not fit rather than cut it.
//
// What bounds it on this card: the chain of N dependent steps of each seed
// (a step's state read depends on the previous step's write to the same
// key), not bytes: the planes are 42 bytes a (step, seed) against the
// card's 3.35 TB/s, and a launch uses ceil(S / blockDim.x) SMs. Each step's
// plane loads do not depend on the state, so they may issue ahead of it.
// Prefetching blocks of steps into shared memory is left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// engine.py's codes (copied into the port's simbatch/engine.py)
constexpr int FC_READ = 0, FC_WRITE = 1, FC_CAS = 2;
constexpr int TC_OK = 1, TC_FAIL = 2;
constexpr int PK_REG_RD_OK = 2, PK_REG_WR_OK = 4, PK_REG_CAS_OK = 6,
              PK_REG_CAS_FAIL = 7;
// shared memory a block may take without opting in to more
constexpr int SMEM_MAX = 48 * 1024;

__global__ void drain_register_kernel(
    const int32_t* __restrict__ ver0, const int32_t* __restrict__ val0,
    const int32_t* __restrict__ pver0, const int32_t* __restrict__ pval0,
    const int32_t* __restrict__ k_seq, const int32_t* __restrict__ f_seq,
    const int32_t* __restrict__ wv_seq, const int32_t* __restrict__ co_seq,
    const int32_t* __restrict__ cn_seq, const uint8_t* __restrict__ to_seq,
    const uint8_t* __restrict__ sg_seq, int32_t* __restrict__ out,
    int32_t* __restrict__ scratch, int N, int S, int K) {
  extern __shared__ int32_t smem[];
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  int32_t* st;
  long long stride;
  if (scratch == nullptr) {
    st = smem + threadIdx.x;
    stride = blockDim.x;
  } else {
    st = scratch + s;
    stride = S;
  }
  int32_t* ver = st;
  int32_t* val = st + (long long)K * stride;
  int32_t* pver = st + 2LL * K * stride;
  int32_t* pval = st + 3LL * K * stride;
  for (int k = 0; k < K; ++k) {
    ver[k * stride] = ver0[(long long)s * K + k];
    val[k * stride] = val0[(long long)s * K + k];
    pver[k * stride] = pver0[(long long)s * K + k];
    pval[k * stride] = pval0[(long long)s * K + k];
  }
  const long long plane = (long long)N * S;
  for (int n = 0; n < N; ++n) {
    const long long i = (long long)n * S + s;
    const int k = k_seq[i];
    const int f = f_seq[i];
    const int32_t wv = wv_seq[i];
    const int32_t co = co_seq[i];
    const int32_t cn = cn_seq[i];
    const bool ok = to_seq[i] == 0;
    const bool sg = sg_seq[i] != 0;
    const long long at = (long long)k * stride;
    const int32_t cv = ver[at];
    const int32_t cl = val[at];
    const bool is_r = ok && f == FC_READ;
    const bool is_w = ok && f == FC_WRITE;
    const bool is_c = ok && f == FC_CAS;
    const bool rd_stale = sg && is_r;
    const int32_t rv = rd_stale ? pver[at] : cv;
    const int32_t rl = rd_stale ? pval[at] : cl;
    const bool cas_ok = is_c && cl == co;
    const int32_t nv = cv + 1;
    if (is_w || cas_ok) {
      pver[at] = cv;
      pval[at] = cl;
      ver[at] = nv;
      val[at] = is_w ? wv : cn;
    }
    out[i] = (is_c && !cas_ok) ? TC_FAIL : TC_OK;
    out[plane + i] = is_r ? PK_REG_RD_OK
                          : is_w ? PK_REG_WR_OK
                                 : cas_ok ? PK_REG_CAS_OK : PK_REG_CAS_FAIL;
    out[2 * plane + i] = is_r ? rv : (is_w || cas_ok) ? nv : co;
    out[3 * plane + i] = is_r ? rl : is_w ? wv : cas_ok ? co : cn;
    out[4 * plane + i] = cas_ok ? cn : -1;
  }
}

}  // namespace

extern "C" {

// Bytes of shared memory the machine of one block may take; past it the
// launch needs a global scratch.
int drain_register_smem_max() { return SMEM_MAX; }

// ver0, val0, pver0, pval0 [S, K]; k, f, wv, co, cn [N, S] int32; to, sg
// [N, S] bytes (0 or 1) -> out [5, N, S] int32 (tc, pk, va, vb, vc), all on
// the current device, keys in [0, K). scratch: null for the machine in
// shared memory (refused past drain_register_smem_max()), else [4, K, S]
// int32. threads: a block's threads, a multiple of 32 up to 1024. Returns
// the launch's cudaError_t (0 = launched).
int drain_register_launch(const int32_t* ver0, const int32_t* val0,
                          const int32_t* pver0, const int32_t* pval0,
                          const int32_t* k_seq, const int32_t* f_seq,
                          const int32_t* wv_seq, const int32_t* co_seq,
                          const int32_t* cn_seq, const uint8_t* to_seq,
                          const uint8_t* sg_seq, int32_t* out,
                          int32_t* scratch, int N, int S, int K, int threads,
                          void* stream) {
  if (N < 0 || S < 0 || K < 1 || threads < 32 || threads > 1024 ||
      threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (N == 0 || S == 0) return 0;
  size_t smem = 0;
  if (scratch == nullptr) {
    smem = (size_t)16 * K * threads;
    if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (S + threads - 1) / threads;
  drain_register_kernel<<<blocks, threads, smem, st>>>(
      ver0, val0, pver0, pval0, k_seq, f_seq, wv_seq, co_seq, cn_seq, to_seq,
      sg_seq, out, scratch, N, S, K);
  return (int)cudaGetLastError();
}

const char* drain_register_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
