// Indel edit distance by a bit-parallel LCS, one warp per log, for Hopper
// (sm_90a).
//
// Replaces the reference's Pallas kernel jepsen_etcd_tpu/ops/edit_distance.py
// _wavefront_pallas (:90): for K logs b_k against one canonical log a,
// out[k] = n + m_k - 2 * LCS(a, b_k[:m_k]), the insert/delete distance with
// no substitution. It returns the same int32 per pair as the reference's
// anti-diagonal DP and is held against its plain PyTorch version
// lcs_bits_reference in ops/edit_distance.py.
//
// The algorithm (Allison-Dix 1986, in the form of Crochemore et al. 2001 and
// Hyyro 2004): a bit vector V of n bits, bit i for a[i], starts all ones;
// step j, with M the bits i where a[i] == b[k, j], sets
// V <- (V + (V & M)) | (V & ~M); LCS is the number of zero bits of V below
// n. Carries move only up, so the bits past n start as ones and are left
// out of the count.
//
// Shape: one block of one warp per log, one launch for all K logs. Lane t
// owns the contiguous words [t * L, (t + 1) * L) of V (L = lane_words(n)
// below) and a bitmap of which of them are all ones (FL = ceil(L / 64)
// words), both stored lane-interleaved (a lane's i-th word at i * 32 + t,
// so a warp's i-th words fall in distinct banks): in shared memory when
// they fit the opt-in limit, otherwise in the log's slice of a global
// scratch buffer the wrapper allocates (indel_bits_state_words gives its
// size; this file is the layout's one definition). A lane reads and writes only
// its own words, so no barrier orders the memory: the warp talks through
// ballots and shuffles.
//
// A step's add: each lane adds its words with carry-in 0 and records G (it
// carries out) and P (its sum is all ones, so a carry-in passes through).
// With G and P ballots of the warp, the carry into lane t is bit t of
// ((G | P) + G) ^ P. A lane with a match position never has P (with U a
// non-empty subset of V, V + U is never all ones), and one without has
// P = "all its words are all ones". A step changes few words: a word with
// no match and carry-in 0 keeps its value; with carry-in 1 it becomes
// v | (v + 1), and passes the carry on only if it was all ones, which
// leaves it all ones. So a lane walks only its matched words, ascending,
// and, where a carry leaves one, jumps by the bitmap to the first word
// that is not all ones. Both passes (G without writing, then the write
// with the carry-in) cost O(matched words + FL), not O(L). A step with
// one match position, as every step of a watch log's is, takes one pass:
// no lane below its lane carries, so that lane writes at once (Lane::flip)
// and the carry, if it leaves the lane, sets the lowest zero bit of the
// next lane that is not all ones.
//
// The match mask comes from a sorted index of a (match_index in
// ops/edit_distance.py): step j matches the positions order[lo[j]:hi[j]],
// ascending. Watch logs hold distinct values, so a step has one position or
// none, and a dense mask table would take n^2 / 8 bytes. lo, hi and each
// step's first and last position do not depend on V: lane s holds step
// j + s's for a batch of 32 steps (its lo and hi read one batch ahead), and
// each step takes them from their lane by __shfl_sync. A lane whose range
// starts inside (first, last] finds its first position by binary search in
// order (small alphabets only).
//
// What bounds it on this card: the serial chain of max m_k dependent steps,
// not bytes or operations. A step is two ballots, four shuffles and a few
// words touched, where the anti-diagonal kernel it replaces ended each of
// its n + m steps in a block-wide __syncthreads() over every live cell; one
// 64-bit word operation covers 64 DP cells. K logs use K of the 132 SMs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr uint64_t ONES = ~0ull;

// 64-bit words of V each lane owns for a canonical log of n codes, and the
// state's words for one log (V and the all-ones bitmaps of all 32 lanes)
__host__ __device__ constexpr int lane_words(int n) {
  return ((n + 63) / 64 + 31) / 32;
}
__host__ __device__ constexpr int bitmap_words(int L) {
  return (L + 63) / 64;
}
__host__ __device__ constexpr long long state_words(int n) {
  return 32ll * (lane_words(n) + bitmap_words(lane_words(n)));
}

// The match positions of one step: order[l .. h), ascending from first to
// last (read ahead, so a step of one or two positions loads nothing).
struct Step {
  const int32_t* order;
  int l, h, first, last;
  __device__ __forceinline__ int at(int q) const {
    return q == l ? first : q == h - 1 ? last : __ldg(order + q);
  }
};

// One lane's share of the state: its words of V at V[i * 32] (i < L) and
// its all-ones bitmap at F[c * 32] (bit i % 64 of F[(i / 64) * 32] says
// word i is all ones); base is the position of its first bit.
struct Lane {
  uint64_t* V;
  uint64_t* F;
  int L, base;

  // the least word index in [a, b) that is not all ones, b if none
  __device__ __forceinline__ int first_not_full(int a, int b) const {
    if (a >= b) return b;
    for (int c = a >> 6; c <= (b - 1) >> 6; ++c) {
      uint64_t bits = ~F[c * 32];
      const int w0 = c * 64;
      if (a > w0) bits &= ONES << (a - w0);
      if (b - w0 < 64) bits &= (1ull << (b - w0)) - 1;
      if (bits) return w0 + __ffsll((long long)bits) - 1;
    }
    return b;
  }

  __device__ __forceinline__ void put(int i, uint64_t v) const {
    V[i * 32] = v;
    uint64_t& f = F[(i >> 6) * 32];
    const uint64_t bit = 1ull << (i & 63);
    f = v == ONES ? (f | bit) : (f & ~bit);
  }

  // a carry into words [a, b), none of which has a match: it passes the
  // all-ones words and stops at the first other one, whose lowest zero
  // bit it sets (STORE). Returns the carry out of word b - 1.
  template <bool STORE>
  __device__ __forceinline__ bool pass(bool carry, int a, int b) const {
    if (!carry) return false;
    const int f = first_not_full(a, b);
    if (f == b) return true;
    if (STORE) {
      const uint64_t v = V[f * 32];
      put(f, v | (v + 1));
    }
    return false;
  }

  // A step whose one match position p lies in this lane: if bit p of V
  // is set, V + 2^p clears it and sets the lowest zero bit above it, and
  // the OR with V & ~M puts back the ones in between, so V loses bit p
  // and gains that zero bit; if it is clear, V stays. No lane below
  // carries, so this lane writes at once. Returns the carry out of the
  // lane (no zero bit above p in it).
  __device__ __forceinline__ bool flip(int p) const {
    const int w = (p - base) >> 6;
    const int b = p & 63;
    uint64_t v = V[w * 32];
    if (!((v >> b) & 1)) return false;
    v &= ~(1ull << b);
    const uint64_t above = b == 63 ? 0 : ~v & (ONES << (b + 1));
    put(w, v | (above & (~above + 1)));
    return !above && pass<true>(true, w + 1, L);
  }

  // The lane's part of V + (V & M) + carry, with the step's match
  // positions from index q on (q == s.h: none in this lane); STORE writes
  // (sum | (V & ~M)) back and keeps the bitmap. Returns the carry out.
  template <bool STORE>
  __device__ __forceinline__ bool add(const Step& s, int q,
                                      bool carry) const {
    int next = 0;  // the lowest word not yet passed
    while (q < s.h) {
      int pos = s.at(q);
      const int w = (pos - base) >> 6;
      if (w >= L) break;
      const int end = base + (w + 1) * 64;
      uint64_t mask = 0;
      do {
        mask |= 1ull << (pos & 63);
        if (++q == s.h) break;
        pos = s.at(q);
      } while (pos < end);
      carry = pass<STORE>(carry, next, w);
      const uint64_t v = V[w * 32];
      const uint64_t s1 = v + (v & mask);
      const uint64_t sum = s1 + (carry ? 1ull : 0ull);
      carry = (s1 < v) | (sum < s1);
      if (STORE) put(w, sum | (v & ~mask));
      next = w + 1;
    }
    return pass<STORE>(carry, next, L);
  }
};

template <bool SMEM>
__global__ void __launch_bounds__(32)
indel_bits_kernel(const int32_t* __restrict__ order, int n,
                  const int32_t* __restrict__ lo,
                  const int32_t* __restrict__ hi, int stride,
                  const int32_t* __restrict__ m_of,
                  int32_t* __restrict__ out, uint64_t* scratch) {
  extern __shared__ uint64_t vsm[];
  const int t = threadIdx.x;
  const int k = blockIdx.x;
  const int L = lane_words(n);
  const int FL = bitmap_words(L);
  uint64_t* state = SMEM ? vsm : scratch + (size_t)k * state_words(n);
  const Lane ln{state + t, state + 32 * L + t, L, t * L * 64};
  for (int i = 0; i < L + FL; ++i) state[i * 32 + t] = ONES;
  bool ones = true;              // every word of this lane is all ones
  const int base = ln.base;
  const int end = base + L * 64;
  const int m = m_of[k];
  const int32_t* lok = lo + (size_t)k * stride;
  const int32_t* hik = hi + (size_t)k * stride;
  // lane s holds step j + s's (lo, hi) and first and last position for the
  // batch of 32 steps from j, and reads the next batch's (lo, hi) ahead
  int next_l = 0, next_h = 0;
  if (t < m) {
    next_l = lok[t];
    next_h = hik[t];
  }
  int ahead_l = 0, ahead_h = 0, ahead_first = 0, ahead_last = 0;
  for (int j = 0; j < m; ++j) {
    const int src = j & 31;
    if (src == 0) {
      ahead_l = next_l;
      ahead_h = next_h;
      if (ahead_h > ahead_l) {
        ahead_first = __ldg(order + ahead_l);
        ahead_last = __ldg(order + ahead_h - 1);
      }
      next_l = next_h = 0;
      if (j + 32 + t < m) {
        next_l = lok[j + 32 + t];
        next_h = hik[j + 32 + t];
      }
    }
    const Step s{order, __shfl_sync(FULL, ahead_l, src),
                 __shfl_sync(FULL, ahead_h, src),
                 __shfl_sync(FULL, ahead_first, src),
                 __shfl_sync(FULL, ahead_last, src)};
    if (s.h == s.l) continue;  // no match: V stays
    if (s.h - s.l == 1) {      // one match position: its lane writes first
      const bool mine = s.first >= base && s.first < end;
      const bool g = mine && ln.flip(s.first);
      ones &= !mine;
      const unsigned G = __ballot_sync(FULL, g);
      const unsigned P = __ballot_sync(FULL, ones);
      // the carry passes the all-ones lanes and stops at the next other
      if (!ones && ((((G | P) + G) ^ P) >> t) & 1u) {
        ln.pass<true>(true, 0, L);
        ones = ln.first_not_full(0, L) == L;
      }
      continue;
    }
    // q: the index of this lane's first match position, s.h if none
    int q = s.h;
    if (s.first < end && s.last >= base) {
      if (s.first >= base) {
        q = s.l;
      } else {  // first < base <= last: the least q in (l, h) at or past base
        int a = s.l + 1, b = s.h - 1;
        while (a < b) {
          const int mid = (a + b) >> 1;
          if (s.at(mid) >= base) {
            b = mid;
          } else {
            a = mid + 1;
          }
        }
        if (s.at(a) < end) q = a;
      }
    }
    const bool match = q < s.h;
    const bool g = match && ln.add<false>(s, q, false);
    const unsigned G = __ballot_sync(FULL, g);
    const unsigned P = __ballot_sync(FULL, !match && ones);
    const bool carry = ((((G | P) + G) ^ P) >> t) & 1u;
    if (match || carry) {
      ln.add<true>(s, q, carry);
      ones = ln.first_not_full(0, L) == L;
    }
  }
  int zeros = 0;
  for (int i = 0; i < L; ++i) {
    const int bit0 = base + i * 64;
    if (bit0 >= n) break;
    const uint64_t live = n - bit0 >= 64 ? ONES : (1ull << (n - bit0)) - 1;
    zeros += __popcll(~ln.V[i * 32] & live);
  }
  zeros = __reduce_add_sync(FULL, zeros);
  if (t == 0) out[k] = n + m - 2 * zeros;
}

}  // namespace

extern "C" {

// Largest dynamic shared memory one block may opt in to on `device`.
int indel_bits_smem_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return bytes;
}

// 64-bit words of one log's state for a canonical log of n codes: the size
// of the log's slice of the global scratch (times 8: the bytes of shared
// memory it takes).
long long indel_bits_state_words(int n) { return state_words(n); }

// order [n], lo and hi [K, stride], m [K] -> out [K], all int32 on the
// current device. scratch_words = 0: the state in shared memory (scratch
// unused); otherwise scratch holds K slices of scratch_words 64-bit words,
// which must be indel_bits_state_words(n). Returns the launch's cudaError_t
// (0 = launched).
int indel_bits_launch(const int32_t* order, int n, const int32_t* lo,
                      const int32_t* hi, int stride, const int32_t* m,
                      int32_t* out, int K, uint64_t* scratch,
                      long long scratch_words, void* stream) {
  if (K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long words = state_words(n);
  if (scratch_words == 0) {
    const size_t smem = (size_t)words * sizeof(uint64_t);
    cudaError_t err = cudaFuncSetAttribute(
        indel_bits_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    indel_bits_kernel<true><<<K, 32, smem, s>>>(order, n, lo, hi, stride, m,
                                                out, nullptr);
  } else {
    if (scratch_words != words || scratch == nullptr) {
      return (int)cudaErrorInvalidValue;
    }
    indel_bits_kernel<false><<<K, 32, 0, s>>>(order, n, lo, hi, stride, m,
                                              out, scratch);
  }
  return (int)cudaGetLastError();
}

const char* indel_bits_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
