// B3 rung for Hopper (sm_90a): a rung run's whole wave loop in one launch.
//
// Replaces, for rung runs whose window is one word (w = 32) and whose
// capacity F is at most 128, the reference's XLA rung
// jepsen_etcd_tpu/ops/wgl.py _expand / _wgl_loop (:1415 / :1669), which
// the port runs as PyTorch ops (ops/wgl.py _expand / _wgl_loop /
// _graph_waves: some 170 small operations a wave, replayed from CUDA
// graphs). It computes the same (accepted, overflow, k, peak, frontier)
// to the bit; those PyTorch ops stay its plain version, and the route of
// every other shape (w = 64 and 128, rungs of 256 and up).
//
// What bounds it: the latency of one wave, times the waves. A wave needs
// the frontier the last one left, so a rung run is a serial chain of up
// to R + I + 1 links; the work of a link is tiny (F states times 32 + C
// candidates, a few table rows that stay in L1 and L2 after first use).
//
// What the design does about it. One block of 32 warps runs the loop,
// with the frontier, the candidates and the dedupe set in shared memory,
// and three barriers a wave:
//
// - Expansion: a warp per frontier state (states s = warp + 32 t), a lane
//   per window op, and lane c also takes info class c (C <= 32, its
//   fields in registers for the whole run). Version, ceiling prune and
//   the state's death are warp reductions; the valid candidates compact
//   into a shared array through two ballots and one atomic a warp, as
//   key words: d, the mask word, the count words, v, with d and v biased
//   by 2**31 so that unsigned order is _lex_order's.
// - Dedupe (after barrier 1): each candidate is inserted into an
//   open-addressing set of 16-bit candidate indices, at least twice as
//   many slots as the wave can have candidates. An insert that claims an
//   empty slot is a distinct candidate and appends itself to a list (a
//   ballot and one atomic a warp); the list's length is n_new, exact
//   above F too, as peak wants on the wave that overflows.
// - Rank (after barrier 2): unless the wave overflows (then the
//   pre-expansion frontier stays), a warp takes a distinct candidate and
//   its lanes count the distinct candidates below it; ranks below F
//   become the next frontier's rows, in order, sentinel rows after them.
//   The set is cleared for the next wave.
// - The stop tests are read in the block after barrier 3: accepted, dead
//   frontier, overflow, k == lim. The host reads (accepted, overflow, k,
//   peak, n_alive) and the frontier once, after the launch.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W = 32;                   // window ops: a warp's lanes
constexpr int NWARPS = 32;
constexpr int THREADS = NWARPS * 32;
constexpr int F_CAP = 128;              // the largest capacity taken
constexpr int C_CAP = 32;               // info classes: a lane each
constexpr int NI_CAP = 2;               // count words
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t BIAS = 0x80000000u;
constexpr int32_t SENT_D = 0x7FFFFFFF;
constexpr uint32_t SENT_W = 0xFFFFFFFFu;
constexpr int READ = 0, WRITE = 1, CAS = 2;
constexpr int32_t NO_ASSERT = -(1 << 30);
constexpr int32_t CEIL_INF = 1 << 30;
constexpr int32_t WILDCARD = -1;
constexpr uint32_t EMPTY = 0xFFFFu;

// A depth's row of the tables (int32): per window op fsk (static_ok ?
// 1 + f_code : 0), a1, a2, ver, pred word, ceiling; then shift,
// u_forced, ceil_beyond and the update-mask word.
constexpr int T_FSK = 0, T_A1 = W, T_A2 = 2 * W, T_VER = 3 * W;
constexpr int T_PRED = 4 * W, T_CEIL = 5 * W, T_SHIFT = 6 * W;
constexpr int T_UF = T_SHIFT + 1, T_CEILB = T_SHIFT + 2, T_UPD = T_SHIFT + 3;
constexpr int ROW = T_SHIFT + 4;
// An info class's row (int32): f, a1, a2, size, first member, count word
// (clamped to the count words), shift, mask, then the NI increment words.
constexpr int K_F = 0, K_A1 = 1, K_A2 = 2, K_SIZE = 3, K_OFF = 4;
constexpr int K_WORD = 5, K_SHIFT = 6, K_MASK = 7, K_INC = 8;

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// The dynamic shared memory of a launch, in bytes from its start.
struct Layout {
  int cap;        // candidates a wave can have: F * (W + c_pad)
  int hsize;      // the set's slots: a power of two >= 2 * cap
  size_t cand;    // [KW][cap] uint32 candidate key words
  size_t fr0;     // [KW][F] uint32 the frontier's key words, two buffers
  size_t fr1;
  size_t set;     // [hsize] uint16 candidate indices, EMPTY when free
  size_t uniq;    // [cap] uint16 the distinct candidates
  size_t total;
};

__host__ __device__ inline Layout layout(int f, int c_pad, int ni) {
  Layout L{};
  const int kw = 3 + ni;
  L.cap = f * (W + c_pad);
  L.hsize = 64;
  while (L.hsize < 2 * L.cap) L.hsize *= 2;
  size_t o = 0;
  L.cand = o;
  o = align16(o + (size_t)kw * L.cap * 4);
  L.fr0 = o;
  o = align16(o + (size_t)kw * f * 4);
  L.fr1 = o;
  o = align16(o + (size_t)kw * f * 4);
  L.set = o;
  o = align16(o + (size_t)L.hsize * 2);
  L.uniq = o;
  o = align16(o + (size_t)L.cap * 2);
  L.total = o;
  return L;
}

// compare-and-swap of a 16-bit slot, through the 32-bit word holding it
__device__ __forceinline__ uint32_t cas16(uint16_t* p, uint32_t cmp,
                                          uint32_t val) {
  uint32_t* word = reinterpret_cast<uint32_t*>(
      reinterpret_cast<uintptr_t>(p) & ~uintptr_t(3));
  const int sh = (reinterpret_cast<uintptr_t>(p) & 2) ? 16 : 0;
  uint32_t old = *reinterpret_cast<volatile uint32_t*>(word);
  while (true) {
    const uint32_t cur = (old >> sh) & 0xFFFFu;
    if (cur != cmp) return cur;
    const uint32_t next = (old & ~(0xFFFFu << sh)) | (val << sh);
    const uint32_t prev = atomicCAS(word, old, next);
    if (prev == old) return cmp;
    old = prev;
  }
}

template <int KW>
__device__ __forceinline__ uint32_t hash_key(const uint32_t (&key)[KW]) {
  uint32_t h = 0x9E3779B9u;
#pragma unroll
  for (int q = 0; q < KW; ++q) {
    h ^= key[q];
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
  }
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// candidate y's key against `key`: -1 below, 0 equal, 1 above
template <int KW>
__device__ __forceinline__ int cmp_key(const uint32_t* cand, int cap, int y,
                                       const uint32_t (&key)[KW]) {
#pragma unroll
  for (int q = 0; q < KW; ++q) {
    const uint32_t a = cand[q * cap + y];
    if (a != key[q]) return a < key[q] ? -1 : 1;
  }
  return 0;
}

template <int NI>
__global__ void __launch_bounds__(THREADS, 1)
wgl_rung_kernel(const int32_t* __restrict__ rows,
                const int32_t* __restrict__ info, int i_tab,
                const int32_t* __restrict__ cls, int c_pad,
                const long long* __restrict__ fr_in,
                const long long* __restrict__ n_alive_in,
                long long* __restrict__ fr_out, long long* __restrict__ res,
                int f, int R, int k0, int lim) {
  constexpr int KW = 3 + NI;
  constexpr int NIA = NI > 0 ? NI : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(f, c_pad, NI);
  const int cap = L.cap;
  const uint32_t hmask = (uint32_t)L.hsize - 1u;
  uint32_t* cand = reinterpret_cast<uint32_t*>(smem + L.cand);
  // the frontier's two buffers: fc the current one, fn the next
  uint32_t* fc = reinterpret_cast<uint32_t*>(smem + L.fr0);
  uint32_t* fn = reinterpret_cast<uint32_t*>(smem + L.fr1);
  uint16_t* set = reinterpret_cast<uint16_t*>(smem + L.set);
  uint16_t* uniq = reinterpret_cast<uint16_t*>(smem + L.uniq);
  // per wave parity: candidates, distinct candidates, accepted
  __shared__ int counters[2][3];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;

  // lane c's info class, for the whole run
  int cf = 0, ca1 = 0, ca2 = 0, csize = 0, coff = 0, cword = 0, cshift = 0;
  uint32_t cmask = 0u;
  uint32_t cinc[NIA] = {};
  if (NI > 0 && lane < c_pad) {
    const int32_t* cr = cls + lane * (K_INC + NI);
    cf = cr[K_F];
    ca1 = cr[K_A1];
    ca2 = cr[K_A2];
    csize = cr[K_SIZE];
    coff = cr[K_OFF];
    cword = cr[K_WORD];
    cshift = cr[K_SHIFT];
    cmask = (uint32_t)cr[K_MASK];
#pragma unroll
    for (int q = 0; q < NI; ++q) cinc[q] = (uint32_t)cr[K_INC + q];
  }

  // the frontier in, as key words
  for (int s = tid; s < f; s += THREADS) {
    const long long* r = fr_in + (size_t)s * KW;
    fc[s] = (uint32_t)(int32_t)r[0] ^ BIAS;
#pragma unroll
    for (int q = 1; q < KW - 1; ++q) fc[q * f + s] = (uint32_t)r[q];
    fc[(KW - 1) * f + s] = (uint32_t)(int32_t)r[KW - 1] ^ BIAS;
  }
  for (int x = tid; x < L.hsize; x += THREADS) set[x] = (uint16_t)EMPTY;
  if (tid < 6) counters[tid / 3][tid % 3] = 0;
  __syncthreads();

  int k = k0;
  int n_alive = (int)*n_alive_in;
  int peak = n_alive;
  bool ovf = false;
  bool acc = R == 0;
  int par = 0;
  while (!acc && n_alive > 0 && !ovf && k < lim) {
    int* ctr = counters[par];

    // -- expansion: warp per state, lane per op (and per class)
    for (int s = warp; s < f; s += NWARPS) {
      const int d = (int)(fc[s] ^ BIAS);
      if (d == SENT_D || d >= R) continue;
      const uint32_t w = fc[f + s];
      uint32_t iw[NIA];
#pragma unroll
      for (int q = 0; q < NI; ++q) iw[q] = fc[(2 + q) * f + s];
      const int v = (int)(fc[(KW - 1) * f + s] ^ BIAS);
      const int32_t* row = rows + (size_t)d * ROW;
      const int fsk = __ldg(row + T_FSK + lane);
      const int a1 = __ldg(row + T_A1 + lane);
      const int a2 = __ldg(row + T_A2 + lane);
      const int rver = __ldg(row + T_VER + lane);
      const uint32_t pred = (uint32_t)__ldg(row + T_PRED + lane);
      const int ceil = __ldg(row + T_CEIL + lane);
      const int shift = __ldg(row + T_SHIFT);
      const int uf = __ldg(row + T_UF);
      const int ceilb = __ldg(row + T_CEILB);
      const uint32_t upd = (uint32_t)__ldg(row + T_UPD);

      // the state's version: forced updates, its own, its classes' counts
      uint32_t cnt = 0u;
      if (NI > 0 && lane < c_pad) {
        uint32_t word = iw[0];
#pragma unroll
        for (int q = 1; q < NI; ++q)
          if (cword == q) word = iw[q];
        cnt = (word >> cshift) & cmask;
      }
      const int version =
          uf + __popc(w & upd) + (int)__reduce_add_sync(FULL, cnt);
      // the ceiling prune: the least ceiling of an op not yet linearized
      const bool not_set = ((w >> lane) & 1u) == 0u;
      const int min_ceil =
          min(__reduce_min_sync(FULL, not_set ? ceil : CEIL_INF), ceilb);
      if (version > min_ceil) continue;

      // lane j's op candidate
      const bool is_read = fsk == 1 + READ;
      const bool is_write = fsk == 1 + WRITE;
      const bool is_cas = fsk == 1 + CAS;
      const bool ver_ok =
          rver == NO_ASSERT || rver == (is_read ? version : version + 1);
      const bool model_ok = (is_read && (a1 == WILDCARD || a1 == v)) ||
                            is_write || (is_cas && a1 == v);
      const uint32_t nwv = w | (1u << lane);
      // the slide drops the `shift` lowest bits: they must all be set
      const uint32_t low =
          shift <= 0 ? 0u : (shift >= 32 ? FULL : (1u << shift) - 1u);
      const bool valid = fsk > 0 && not_set && (w & pred) == pred &&
                         ver_ok && model_ok && (nwv & low) == low;

      // lane c's class candidate: fire the class's next member
      bool ivalid = false;
      if (NI > 0 && lane < c_pad && (long long)cnt < csize) {
        const int member =
            (int)min(max((long long)coff + cnt, 0LL), (long long)i_tab - 1);
        const int32_t* irow = info + (size_t)d * 2 * i_tab;
        const uint32_t ip = (uint32_t)__ldg(irow + member);
        const bool istat = __ldg(irow + i_tab + member) != 0;
        ivalid = istat && (w & ip) == ip &&
                 (cf == WRITE || (cf == CAS && ca1 == v)) &&
                 version + 1 <= min_ceil;
      }

      const unsigned bo = __ballot_sync(FULL, valid);
      const unsigned bc = __ballot_sync(FULL, ivalid);
      const int n = __popc(bo) + __popc(bc);
      if (n == 0) continue;
      int base = 0;
      if (lane == 0) base = atomicAdd(&ctr[0], n);
      base = __shfl_sync(FULL, base, 0);
      if (valid) {
        const int x = base + __popc(bo & lt);
        cand[x] = (uint32_t)(d + 1) ^ BIAS;
        cand[cap + x] = (shift >= 0 && shift < 32) ? nwv >> shift : 0u;
#pragma unroll
        for (int q = 0; q < NI; ++q) cand[(2 + q) * cap + x] = iw[q];
        const int nv = is_read ? v : (is_write ? a1 : a2);
        cand[(KW - 1) * cap + x] = (uint32_t)nv ^ BIAS;
        if (d + 1 == R) ctr[2] = 1;
      }
      if (ivalid) {
        const int x = base + __popc(bo) + __popc(bc & lt);
        cand[x] = (uint32_t)d ^ BIAS;
        cand[cap + x] = w;
#pragma unroll
        for (int q = 0; q < NI; ++q) cand[(2 + q) * cap + x] = iw[q] + cinc[q];
        cand[(KW - 1) * cap + x] =
            (uint32_t)(cf == WRITE ? ca1 : ca2) ^ BIAS;
      }
    }
    __syncthreads();                   // 1: the candidates

    // -- dedupe: the distinct candidates, and their count
    const int n_cand = ctr[0];
    for (int b = warp * 32; b < n_cand; b += THREADS) {
      const int x = b + lane;
      bool fresh = false;
      if (x < n_cand) {
        uint32_t key[KW];
#pragma unroll
        for (int q = 0; q < KW; ++q) key[q] = cand[q * cap + x];
        uint32_t h = hash_key<KW>(key) & hmask;
        while (true) {
          const uint32_t old = cas16(set + h, EMPTY, (uint32_t)x);
          if (old == EMPTY) {
            fresh = true;
            break;
          }
          if (cmp_key<KW>(cand, cap, (int)old, key) == 0) break;
          h = (h + 1u) & hmask;
        }
      }
      const unsigned bf = __ballot_sync(FULL, fresh);
      int base = 0;
      if (lane == 0 && bf) base = atomicAdd(&ctr[1], __popc(bf));
      base = __shfl_sync(FULL, base, 0);
      if (fresh) uniq[base + __popc(bf & lt)] = (uint16_t)x;
    }
    __syncthreads();                   // 2: the distinct candidates

    // -- rank, and the stop tests
    const int n_new = ctr[1];
    const bool acc_now = ctr[2] != 0;
    const bool ovf_now = n_new > f && !acc_now;
    peak = max(peak, n_new);
    if (!ovf_now) {
      for (int u = warp; u < n_new; u += NWARPS) {
        const int x = uniq[u];
        uint32_t key[KW];
#pragma unroll
        for (int q = 0; q < KW; ++q) key[q] = cand[q * cap + x];
        int below = 0;
        for (int u2 = lane; u2 < n_new; u2 += 32)
          below += cmp_key<KW>(cand, cap, uniq[u2], key) < 0;
        const int rank = __reduce_add_sync(FULL, below);
        if (rank < f && lane < KW) fn[lane * f + rank] = cand[lane * cap + x];
      }
      const int m = min(n_new, f);
      for (int r = m + tid; r < f; r += THREADS) {
        fn[r] = (uint32_t)SENT_D ^ BIAS;
        fn[f + r] = SENT_W;
#pragma unroll
        for (int q = 0; q < NI; ++q) fn[(2 + q) * f + r] = 0u;
        fn[(KW - 1) * f + r] = (uint32_t)SENT_D ^ BIAS;  // SENTINEL_V
      }
      k += 1;
      n_alive = m;
      uint32_t* t = fc;
      fc = fn;
      fn = t;
    }
    ovf = ovf || ovf_now;
    acc = acc || acc_now;
    // the set empty again, and the next wave's counters zero
    uint4* set4 = reinterpret_cast<uint4*>(set);
    for (int x = tid; x < L.hsize / 8; x += THREADS)
      set4[x] = make_uint4(FULL, FULL, FULL, FULL);
    if (tid < 3) counters[par ^ 1][tid] = 0;
    par ^= 1;
    __syncthreads();                   // 3: the next frontier
  }

  for (int s = tid; s < f; s += THREADS) {
    long long* r = fr_out + (size_t)s * KW;
    r[0] = (long long)(int32_t)(fc[s] ^ BIAS);
#pragma unroll
    for (int q = 1; q < KW - 1; ++q) r[q] = (long long)fc[q * f + s];
    r[KW - 1] = (long long)(int32_t)(fc[(KW - 1) * f + s] ^ BIAS);
  }
  if (tid == 0) {
    res[0] = acc;
    res[1] = ovf;
    res[2] = k;
    res[3] = peak;
    res[4] = n_alive;
  }
}

template <int NI>
int launch(const int32_t* rows, const int32_t* info, int i_tab,
           const int32_t* cls, int c_pad, const long long* fr_in,
           const long long* n_alive, long long* fr_out, long long* res, int f,
           int R, int k0, int lim, cudaStream_t stream) {
  // every launch asks for the instance's largest layout, so threads that
  // launch at once never set the attribute below another's need
  const cudaError_t e = cudaFuncSetAttribute(
      wgl_rung_kernel<NI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)layout(F_CAP, C_CAP, NI).total);
  if (e != cudaSuccess) return (int)e;
  wgl_rung_kernel<NI><<<1, THREADS, layout(f, c_pad, NI).total, stream>>>(
      rows, info, i_tab, cls, c_pad, fr_in, n_alive, fr_out, res, f, R, k0,
      lim);
  return (int)cudaGetLastError();
}

}  // namespace

// One rung run on `stream`: rows [r_pad, 196] int32 (a depth's row, above),
// info [r_pad, 2 * i_tab] int32 (member pred words, then static_ok),
// cls [c_pad, 8 + ni] int32, fr_in [f, 3 + ni] int64 (d, mask word, ni
// count words, v) and n_alive [1] int64 -> fr_out [f, 3 + ni] int64 and
// res [5] int64 (accepted, overflow, k, peak, n_alive). Waves run from k0
// while the frontier lives, nothing is accepted or overflows and k < lim.
// Returns the launch's cudaError_t (0 = launched); f, c_pad and ni up to
// wgl_rung_limit's, else cudaErrorInvalidValue.
extern "C" int wgl_rung_launch(const void* rows, const void* info, int i_tab,
                               const void* cls, int c_pad, int ni,
                               const void* fr_in, const void* n_alive,
                               void* fr_out, void* res, int f, int R, int k0,
                               int lim, void* stream) {
  if (f < 1 || f > F_CAP || c_pad < 0 || c_pad > C_CAP || ni < 0 ||
      ni > NI_CAP || (c_pad > 0 && i_tab < 1))
    return (int)cudaErrorInvalidValue;
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* in = static_cast<const int32_t*>(info);
  const auto* c = static_cast<const int32_t*>(cls);
  const auto* fi = static_cast<const long long*>(fr_in);
  const auto* na = static_cast<const long long*>(n_alive);
  auto* fo = static_cast<long long*>(fr_out);
  auto* rs = static_cast<long long*>(res);
  auto st = static_cast<cudaStream_t>(stream);
  switch (ni) {
    case 0:
      return launch<0>(r, in, i_tab, c, 0, fi, na, fo, rs, f, R, k0, lim, st);
    case 1:
      return launch<1>(r, in, i_tab, c, c_pad, fi, na, fo, rs, f, R, k0, lim,
                       st);
    case 2:
      return launch<2>(r, in, i_tab, c, c_pad, fi, na, fo, rs, f, R, k0, lim,
                       st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The largest capacity (which = 0), info classes (1) and count words (2)
// wgl_rung_launch takes; -1 for any other `which`. The route reads them.
extern "C" int wgl_rung_limit(int which) {
  return which == 0 ? F_CAP : which == 1 ? C_CAP : which == 2 ? NI_CAP : -1;
}

extern "C" const char* wgl_rung_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
