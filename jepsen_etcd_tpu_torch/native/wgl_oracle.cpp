// Native WGL linearizability oracle (C++ core of checkers/linearizable).
//
// The reference's Knossos search runs on the JVM with a 24 GB heap
// (project.clj:21-23); our CPU fallback path is this C++ depth-first
// search over (linearized-mask, register-value) configurations with a
// memoizing visited set — the same semantics as the Python oracle
// (checkers/linearizable.py, differential-tested against it), roughly
// two orders of magnitude faster. It handles histories the TPU kernel
// cannot pack (window > 64, info ops > 32) before any "unknown" verdict
// is accepted.
//
// Register language (matches ops/wgl.py packing):
//   f: 0 read / 1 write / 2 cas
//   a1: read expected value (or WILDCARD) / write value / cas old
//   a2: cas new
//   ver: version assertion (NO_ASSERT when absent). Version semantics are
//        VersionedRegister's (models/versioned_register.py): updates
//        assert version+1, reads assert version; version is DERIVED —
//        the count of linearized updates, a function of the mask — it
//        rides in the frame word beside the value for cheap access and
//        adds no distinct states to the visited set.
//   inv/ret: total-order positions; ret = INT64_MAX for :info ops.
//   req: 1 for :ok ops (must linearize), 0 for :info (may, or never).
//   sym_pred: canonical-order predecessor for interchangeable info ops
//        (identical f/a1/a2); -1 when none. Restricting the search to
//        fire each class in order collapses 2^I symmetric subsets.
//
// Returns 1 valid, 0 invalid, 2 search budget exceeded.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <utility>
#include <vector>

namespace {

constexpr int32_t NO_ASSERT = -(1 << 30);
constexpr int32_t WILDCARD = -1;
constexpr int8_t F_READ = 0, F_WRITE = 1, F_CAS = 2;

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

// Open-addressing hash set over fixed-width uint64 keys.
struct KeySet {
  size_t kw = 0, cap = 0, cnt = 0, mask = 0;
  std::vector<uint64_t> slots;
  std::vector<uint8_t> used;

  void init(size_t key_words, size_t cap0) {
    kw = key_words;
    cap = 64;
    while (cap < cap0) cap <<= 1;
    mask = cap - 1;
    slots.assign(cap * kw, 0);
    used.assign(cap, 0);
    cnt = 0;
  }

  uint64_t hash(const uint64_t* key) const {
    uint64_t h = 0x2545f4914f6cdd1dULL;
    for (size_t i = 0; i < kw; i++) h = splitmix64(h ^ key[i]);
    return h;
  }

  void grow() {
    std::vector<uint64_t> old_slots;
    std::vector<uint8_t> old_used;
    old_slots.swap(slots);
    old_used.swap(used);
    size_t old_cap = cap;
    cap <<= 1;
    mask = cap - 1;
    slots.assign(cap * kw, 0);
    used.assign(cap, 0);
    for (size_t i = 0; i < old_cap; i++) {
      if (!old_used[i]) continue;
      const uint64_t* key = &old_slots[i * kw];
      size_t j = hash(key) & mask;
      while (used[j]) j = (j + 1) & mask;
      std::memcpy(&slots[j * kw], key, kw * 8);
      used[j] = 1;
    }
  }

  // true iff the key was newly inserted.
  bool insert(const uint64_t* key) {
    size_t i = hash(key) & mask;
    while (used[i]) {
      if (!std::memcmp(&slots[i * kw], key, kw * 8)) return false;
      i = (i + 1) & mask;
    }
    std::memcpy(&slots[i * kw], key, kw * 8);
    used[i] = 1;
    cnt++;
    if (cnt * 10 > cap * 7) grow();
    return true;
  }
};

inline bool get_bit(const uint64_t* m, int32_t i) {
  return (m[i >> 6] >> (i & 63)) & 1ULL;
}

}  // namespace

extern "C" int32_t wgl_oracle_check(
    int32_t n, const int8_t* f, const int32_t* a1, const int32_t* a2,
    const int32_t* ver, const int64_t* inv, const int64_t* ret,
    const uint8_t* req, const int32_t* sym_pred, int64_t max_configs,
    int64_t* configs_out, int32_t* blocked_op_out, int32_t* best_depth_out,
    int32_t* blocked_version_out, int32_t* blocked_value_out) {
  const size_t nw = (static_cast<size_t>(n) + 63) / 64;
  const size_t fw = nw + 1;  // frame: mask words + (value<<32 | version)

  // required ops ordered by return position (for the min-ret scan)
  std::vector<int32_t> req_order;
  req_order.reserve(n);
  for (int32_t i = 0; i < n; i++)
    if (req[i]) req_order.push_back(i);
  for (size_t i = 1; i < req_order.size(); i++) {  // insertion sort by ret
    int32_t v = req_order[i];
    size_t j = i;
    while (j > 0 && ret[req_order[j - 1]] > ret[v]) {
      req_order[j] = req_order[j - 1];
      j--;
    }
    req_order[j] = v;
  }

  // version ceilings: a required op asserting a version can only fire
  // while the register version is below/at its ceiling (read: ver,
  // update: ver-1). Version never decreases, so any state whose
  // version exceeds the MINIMUM ceiling among unlinearized required
  // ops is dead — the prune that stops info-heavy searches from
  // wandering through count combinations no future assertion can
  // match (the dominant blowup for faulted register histories).
  std::vector<std::pair<int32_t, int32_t>> ceil_order;  // (ceiling, e)
  for (int32_t e = 0; e < n; e++) {
    if (req[e] && ver[e] != NO_ASSERT)
      ceil_order.emplace_back(f[e] == F_READ ? ver[e] : ver[e] - 1, e);
  }
  std::sort(ceil_order.begin(), ceil_order.end());
  std::vector<size_t> ceil_rank(n, 0);  // entry -> index in ceil_order
  for (size_t r = 0; r < ceil_order.size(); r++)
    ceil_rank[ceil_order[r].second] = r;

  // enabled-candidate prefix masks: pre[r] = entries with inv < the
  // r-th-by-ret required op's ret. The per-config candidate walk then
  // iterates only (pre[min_ret_op] & ~mask) set bits — O(n/64 + #cand)
  // instead of an O(n) scan, the difference between 0.2M and 2M
  // configs/s on 2000-entry histories.
  std::vector<size_t> rank_of(n, 0);  // entry -> index in req_order
  for (size_t r = 0; r < req_order.size(); r++) rank_of[req_order[r]] = r;
  std::vector<uint64_t> pre(req_order.size() * nw, 0);
  for (size_t r = 0; r < req_order.size(); r++) {
    const int64_t bound = ret[req_order[r]];
    uint64_t* row = &pre[r * nw];
    for (int32_t e = 0; e < n; e++)
      if (inv[e] < bound) row[e >> 6] |= 1ULL << (e & 63);
  }

  // frame layout:
  //   [mask: nw][value<<32|version: 1][pmask: nw_req][cmask: nw_ceil]
  // pmask/cmask mirror the mask permuted into ret-rank / ceiling-rank
  // order over required ops (bits past the rank count pre-set), so the
  // min-ret and min-ceiling scans are word-wise first-zero searches
  // instead of O(depth) bit walks. The visited key is the fw-word
  // prefix only — both permuted masks are functions of the mask.
  const size_t n_req = req_order.size();
  const size_t nw_req = (n_req + 63) / 64;
  const size_t n_ceil = ceil_order.size();
  const size_t nw_ceil = (n_ceil + 63) / 64;
  const size_t fs = fw + nw_req + nw_ceil;  // full stack-frame width

  KeySet visited;
  visited.init(fw, 1 << 16);
  std::vector<uint64_t> stack;  // frames, popped from the back
  stack.assign(fs, 0);          // initial: empty mask, value 0, version 0
  for (size_t b = n_req; b < nw_req * 64; b++)
    stack[fw + (b >> 6)] |= 1ULL << (b & 63);
  for (size_t b = n_ceil; b < nw_ceil * 64; b++)
    stack[fw + nw_req + (b >> 6)] |= 1ULL << (b & 63);

  int64_t configs = 0;
  int32_t best_depth = -1, blocked_op = -1;
  int32_t blocked_version = 0, blocked_value = 0;
  std::vector<uint64_t> frame(fs), child(fs);

  visited.insert(stack.data());  // dedup happens at PUSH time: a state
  // reachable through many parents is stacked (and its frame copied)
  // only once, instead of being pushed repeatedly and discarded on pop
  while (!stack.empty()) {
    std::memcpy(frame.data(), stack.data() + stack.size() - fs, fs * 8);
    stack.resize(stack.size() - fs);
    if (++configs > max_configs) {
      *configs_out = configs;
      return 2;
    }
    const uint64_t* m = frame.data();
    const uint64_t* pm = frame.data() + fw;
    const int32_t value = static_cast<int32_t>(frame[nw] >> 32);
    const int32_t version =
        static_cast<int32_t>(frame[nw] & 0xffffffffULL);

    size_t r_min = n_req;  // rank of the first unlinearized required op
    for (size_t w = 0; w < nw_req; w++) {
      if (pm[w] != ~0ULL) {
        r_min = (w << 6) + __builtin_ctzll(~pm[w]);
        break;
      }
    }
    if (r_min >= n_req) {  // every required op linearized
      *configs_out = configs;
      *blocked_version_out = version;
      *blocked_value_out = value;
      return 1;
    }

    int32_t min_ceil = INT32_MAX;
    int32_t min_ceil_op = -1;
    const uint64_t* cm = frame.data() + fw + nw_req;
    for (size_t w = 0; w < nw_ceil; w++) {
      if (cm[w] != ~0ULL) {
        const size_t r = (w << 6) + __builtin_ctzll(~cm[w]);
        min_ceil = ceil_order[r].first;
        min_ceil_op = ceil_order[r].second;
        break;
      }
    }
    if (version > min_ceil) {
      // dead: that op can never fire. Keep the counterexample
      // diagnostics the candidate walk would have produced.
      int32_t d = 0;
      for (size_t ww = 0; ww < nw; ww++)
        d += __builtin_popcountll(m[ww]);
      if (d >= best_depth) {
        best_depth = d;
        blocked_op = min_ceil_op;
        blocked_version = version;
        blocked_value = value;
      }
      continue;
    }

    // Two passes: info candidates pushed first, required last, so the
    // LIFO pop explores required ops first — greedy progress on the
    // forced schedule, with crashed ops interleaved only when a
    // required op is blocked. With id-order pushes an info-heavy
    // history makes the DFS burrow through 2^I crashed-op subsets
    // before advancing the schedule at all; witness search on valid
    // histories goes from budget-exhausting to near-linear.
    const uint64_t* enabled = &pre[r_min * nw];
    for (int pass = 0; pass < 2; pass++) {
    for (size_t w = 0; w < nw; w++) {
      uint64_t cand = enabled[w] & ~m[w];
      while (cand) {
        const int32_t e =
            static_cast<int32_t>((w << 6) + __builtin_ctzll(cand));
        cand &= cand - 1;
        if ((pass == 0) == static_cast<bool>(req[e])) continue;
        if (sym_pred[e] >= 0 && !get_bit(m, sym_pred[e])) continue;
        bool ok;
        int32_t nval;
        if (f[e] == F_READ) {
          ok = (ver[e] == NO_ASSERT || ver[e] == version) &&
               (a1[e] == WILDCARD || a1[e] == value);
          nval = value;
        } else if (f[e] == F_WRITE) {
          ok = (ver[e] == NO_ASSERT || ver[e] == version + 1);
          nval = a1[e];
        } else {
          ok = (ver[e] == NO_ASSERT || ver[e] == version + 1) &&
               a1[e] == value;
          nval = a2[e];
        }
        if (!ok) {
          if (req[e]) {
            int32_t d = 0;
            for (size_t ww = 0; ww < nw; ww++)
              d += __builtin_popcountll(m[ww]);
            if (d >= best_depth) {
              best_depth = d;
              blocked_op = e;
              blocked_version = version;
              blocked_value = value;
            }
          }
          continue;
        }
        const int32_t nver = (f[e] == F_READ) ? version : version + 1;
        std::memcpy(child.data(), frame.data(), fs * 8);
        child[e >> 6] |= 1ULL << (e & 63);
        child[nw] =
            (static_cast<uint64_t>(static_cast<uint32_t>(nval)) << 32) |
            static_cast<uint32_t>(nver);
        if (req[e]) {
          const size_t r = rank_of[e];
          child[fw + (r >> 6)] |= 1ULL << (r & 63);
          if (ver[e] != NO_ASSERT) {
            const size_t cr = ceil_rank[e];
            child[fw + nw_req + (cr >> 6)] |= 1ULL << (cr & 63);
          }
        }
        if (visited.insert(child.data()))
          stack.insert(stack.end(), child.begin(), child.end());
      }
    }
    }
  }

  *configs_out = configs;
  *blocked_op_out = blocked_op;
  *best_depth_out = best_depth;
  *blocked_version_out = blocked_version;
  *blocked_value_out = blocked_value;
  return 0;
}
