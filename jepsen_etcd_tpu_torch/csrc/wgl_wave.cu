// WGL frontier wave search for Hopper (sm_90a).
//
// Replaces the reference's Pallas kernel jepsen_etcd_tpu/ops/wgl_mxu.py
// _make_kernel / _wave_body (one BFS wave per grid step over packed
// (nr, 128) planes, with MXU one-hot matmuls for ranks and compaction).
// It computes the same [accepted, overflowed, peak, waves] vector per
// key, bit for bit, and is held against the plain PyTorch version
// wave_search_reference in ops/wgl_mxu.py.
//
// What bounds it: the latency of one wave, times the waves. A wave needs
// the frontier the last one left, so a check is a serial chain of
// (waves) links; the table's bytes (about 8 MB for a 10k-op history at
// wk = 32) and the candidates' operations are each microseconds of the
// card's time in all. Within a link, what the SM issues: 32 warps on 4
// schedulers, so work every warp repeats costs 8 warps' worth of issue.
//
// What the design does about it. One block of 32 warps per key:
//
// - Warp w owns frontier state s(w) = NR*(w % SEGK) + w/SEGK, the w-th
//   run of wk candidate slots in the reference's plane order (candidate
//   (s, o) at idx = p*128 + q, s = NR*(q/wk) + p, o = q % wk), its lanes
//   taking ops o = j*32 + lane. Version, ceiling prune and slide are
//   warp-local. Only the warps of filled states work: the frontier is
//   usually a few states, so a wave costs a few warps' issue.
// - Lane r of each such warp holds frontier row r in registers. The
//   partial dedupe compares states, not candidates: two valid
//   candidates of one op have equal successors exactly when their
//   states' mask words are equal (the slide keeps the low bits it drops
//   set) and, for a read or a CAS, their values are (a write's value is
//   its own). Each lane compares its row with the warp's state, two
//   ballots give the answer for every op: no candidate array is written.
// - Ranks: each warp ballots its kept candidates and writes its total;
//   after barrier 1 lane i of every warp reads total i, one
//   __reduce_add_sync gives the count and another the warp's base, and
//   the candidates ranked below F write their rows.
// - After barrier 2 the warps whose state is below min(count, F) read
//   the rows, lane r row r, and find equal rows with __match_any_sync: a
//   filled row survives when it is the lowest lane of its group, the
//   reference's "killed by an identical lower-ranked filled row". Row r
//   is filled iff r < min(count, F), so nothing is reset; row 0 always
//   survives, so the death test is count == 0 and the waves are the
//   waves run.
// - Two barriers a wave (the old kernel took eight). The totals are
//   rewritten only after barrier 2 and the rows only after barrier 1 of
//   the next wave, each after every reader has passed, so no buffer is
//   doubled.
// - Table rows arrive ahead of use: a ring of STAGES rows (with their
//   scal rows) filled by TMA bulk copies that one thread issues, each
//   stage with an mbarrier the working warps wait on (warp 0's state 0
//   is filled in every wave run, so every row's copy is waited for). A
//   stage is refilled after barrier 1 of the wave that read it, never
//   past row r_pad - 1, and a block that stops early waits out its
//   copies in flight.
//
// A profiling instantiation (PROF) sums, in thread 0, the SM cycles of
// each phase of a wave (clock64 at the boundaries), the frontier's
// filled states and the kept candidates over the waves: wgl_wave_profile.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int F = 32;
constexpr int NWARPS = 32;              // one warp per frontier state
constexpr int THREADS = NWARPS * 32;
constexpr int SCAL_COLS = 8;
constexpr int S_SHIFT = 0, S_CEILB = 1, S_UPD0 = 2, S_R = 6;
constexpr int READ = 0, WRITE = 1, CAS = 2;
constexpr int STAGES = 8;               // table rows in flight
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t UNFILLED = 0x10000u; // a value key no filled row has
constexpr int NPH = 6;
// the thread that issues the ring's copies: lane 0 of the last warp,
// whose state (the highest of its plane column) is the last to fill
constexpr int PRODUCER = THREADS - 32;

template <int WK>
struct Dims {
  static constexpr int NW = WK / 32;            // mask words
  static constexpr int NR = F * WK / 128;       // plane rows
  static constexpr int SEGK = 128 / WK;         // states per plane row
  static constexpr int TL = (WK * (3 + NW) + 127) / 128 * 128;
  static constexpr int NDUP = NR < 8 ? NR : 8;  // partial-dedupe rows
  static constexpr int STAGE = TL + SCAL_COLS;  // ints per ring stage
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: expect a stage's bytes and issue its table and scal rows.
__device__ __forceinline__ void fetch(int32_t* dst, const int32_t* trow,
                                      const int32_t* srow, uint32_t tbytes,
                                      uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(b), "r"(tbytes + SCAL_COLS * 4) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(trow), "r"(tbytes), "r"(b) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst + tbytes / 4)), "l"(srow), "r"(SCAL_COLS * 4),
         "r"(b) : "memory");
}

__device__ __forceinline__ void wait_stage(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
  } while (!done);
}

// lanes holding equal (words, value) keys, as __match_any_sync masks
template <int NW>
__device__ __forceinline__ unsigned match_rows(const uint32_t (&w)[NW],
                                               uint32_t v) {
  if constexpr (NW == 1) {
    return __match_any_sync(FULL, (unsigned long long)w[0] << 32 | v);
  } else {
    unsigned m = __match_any_sync(FULL, v);
#pragma unroll
    for (int i = 0; i < NW; i += 2)
      m &= __match_any_sync(FULL, (unsigned long long)w[i] << 32 | w[i + 1]);
    return m;
  }
}

template <int WK, bool PROF>
__global__ void __launch_bounds__(THREADS, 1)
wgl_wave_kernel(const int32_t* __restrict__ tab,
                const int32_t* __restrict__ scal, int r_pad,
                int32_t* __restrict__ out, long long* __restrict__ prof) {
  using D = Dims<WK>;
  constexpr int NW = D::NW, NR = D::NR, SEGK = D::SEGK, TL = D::TL;
  constexpr uint32_t TBYTES = TL * 4;

  __shared__ __align__(128) int32_t ring[STAGES][D::STAGE];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ uint32_t fw[NW][F];     // the wave's compacted rows
  __shared__ uint32_t fv[F];
  __shared__ int32_t tot[NWARPS];    // kept candidates per warp

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t key = blockIdx.x;
  tab += key * (size_t)r_pad * TL;
  scal += key * (size_t)r_pad * SCAL_COLS;

  if (tid == PRODUCER) {
    for (int st = 0; st < STAGES; ++st)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&full[st])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int kk = 0; kk < STAGES && kk < r_pad; ++kk)
      fetch(ring[kk], tab + (size_t)kk * TL, scal + (size_t)kk * SCAL_COLS,
            TBYTES, &full[kk]);
  }
  const int R = scal[S_R];
  __syncthreads();

  // the warp's state and the rows of its partial-dedupe set: states
  // s - d (d plane rows up) and s - NR*gs (wk*gs lanes left)
  const int s = NR * (warp % SEGK) + warp / SEGK;
  uint32_t dset = 0u;
#pragma unroll
  for (int d = 1; d < D::NDUP; ++d)
    if (s % NR >= d) dset |= 1u << (s - d);
#pragma unroll
  for (int gs = 1; gs < SEGK; ++gs)
    if (s / NR >= gs) dset |= 1u << (s - NR * gs);
  const bool in_dset = (dset >> lane) & 1u;
  const unsigned lt = (1u << lane) - 1u;
  const uint32_t bit = 1u << lane;

  // lane r holds frontier row r (in the warps of filled states); (mw,
  // mv, mf) is the warp's own state. The frontier is rows r < min(count,
  // F) less the dedupe's holes: one row at first.
  bool rfill = lane == 0;
  uint32_t rw[NW], mw[NW];
#pragma unroll
  for (int wi = 0; wi < NW; ++wi) rw[wi] = mw[wi] = 0u;
  uint32_t rv = lane == 0 ? 1u : 0u;        // biased NONE value
  uint32_t mv = s == 0 ? 1u : 0u;
  bool mf = s == 0;
  int count = 1, acc = 0, ovf = 0, peak = 1;

  long long ph[NPH] = {}, tc = 0, nfilled = 0, nkept = 0;
  auto mark = [&](int i) {
    if (PROF && tid == 0) {
      const long long n = clock64();
      ph[i] += n - tc;
      tc = n;
    }
  };

  int kk = 0;
  for (; kk < r_pad; ++kk) {
    if (PROF && tid == 0) tc = clock64();
    // a dead frontier stays dead: row 0 is filled iff the last wave kept
    // a candidate (no lower row can kill it)
    if (count == 0) break;
    const int st = kk % STAGES;
    const int32_t* row = ring[st];
    const int32_t* srow = row + TL;
    unsigned keep[NW];
    uint32_t val[NW];
    int total = 0, sh = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) keep[j] = val[j] = 0u;
    // only the warps of filled states expand them (warp 0's, state 0, is
    // filled in every wave the loop runs: it waits for every row)
    if (mf) {
      wait_stage(&full[st], (kk / STAGES) & 1);
      mark(0);
      // per state: version, ceiling, and the low bits the slide drops
      int ver = 0;
#pragma unroll
      for (int wi = 0; wi < NW; ++wi)
        ver += __popc(mw[wi] & (uint32_t)srow[S_UPD0 + wi]);
      const bool st_ok = ver <= srow[S_CEILB];
      sh = srow[S_SHIFT];
      uint32_t missing[NW];
#pragma unroll
      for (int wi = 0; wi < NW; ++wi) {
        const int k = min(max(sh - 32 * wi, 0), 32);
        missing[wi] = (k >= 32 ? FULL : (1u << k) - 1u) & ~mw[wi];
      }

      // candidates (s, o), o = j*32 + lane
      bool segbad = false;
      bool valid[NW], isw[NW];
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int o = j * 32 + lane;
        const int av = row[o];
        const int vc = row[WK + o];
        const int fsk = row[WK * (2 + NW) + o] & 0xFFFF;
        const uint32_t a1 = av & 0xFFFF, a2 = (av >> 16) & 0xFFFF;
        const int rver = (int)(int16_t)(vc & 0xFFFF);
        const int rceil = vc >> 16;
        const bool not_set = (mw[j] & bit) == 0u;
        // a state dies when any not-yet-linearized op's ceiling is below
        // its version
        segbad = segbad || (not_set && rceil < ver);
        bool preds_in = true, slide_ok = true;
#pragma unroll
        for (int wi = 0; wi < NW; ++wi) {
          const uint32_t pm = (uint32_t)row[WK * (2 + wi) + o];
          preds_in = preds_in && (mw[wi] & pm) == pm;
          slide_ok = slide_ok && (missing[wi] & ~(wi == j ? bit : 0u)) == 0u;
        }
        const bool is_read = fsk == 1 + READ;
        const bool is_write = fsk == 1 + WRITE;
        const bool is_cas = fsk == 1 + CAS;
        const bool ver_ok = rver == -32768 || (is_read && rver == ver) ||
                            ((is_write || is_cas) && rver == ver + 1);
        const bool model_ok = (is_read && (a1 == 0u || a1 == mv)) ||
                              is_write || (is_cas && a1 == mv);
        valid[j] = fsk > 0 && not_set && preds_in && ver_ok && model_ok &&
                   slide_ok;
        val[j] = is_read ? mv : (is_write ? a1 : a2);
        isw[j] = is_write;
      }
      const bool alive = st_ok && !__any_sync(FULL, segbad);

      // partial dedupe against the dedupe set's states: equal words kill
      // a write's candidate, equal words and value any candidate
      bool eqw = rfill && in_dset;
#pragma unroll
      for (int wi = 0; wi < NW; ++wi) eqw = eqw && rw[wi] == mw[wi];
      const bool dup_w = __any_sync(FULL, eqw);
      const bool dup_v = __any_sync(FULL, eqw && rv == mv);
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        keep[j] = __ballot_sync(
            FULL, alive && valid[j] && !(isw[j] ? dup_w : dup_v));
        total += __popc(keep[j]);
      }
    }
    if (lane == 0) tot[warp] = total;
    mark(1);
    __syncthreads();                   // 1: the warp totals
    mark(2);

    if (tid == PRODUCER && kk + STAGES < r_pad) {
      // warp 0 has waited for stage st and every reader of it is past
      // barrier 1: it takes row kk + STAGES
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      fetch(ring[st], tab + (size_t)(kk + STAGES) * TL,
            scal + (size_t)(kk + STAGES) * SCAL_COLS, TBYTES, &full[st]);
    }
    // lane i reads warp i's total: the count, and the warp's base
    const int t = tot[lane];
    count = __reduce_add_sync(FULL, t);
    // flags before truncation: acceptance is witness-based; overflow =
    // some candidate ranked past capacity; peak = max rank + 1
    peak = max(peak, count);
    ovf |= count > F;
    acc |= kk == R - 1 && count > 0;

    if (total) {
      // compaction: the candidate ranked r < F becomes row r, its window
      // (state | bit o) >> sh word by word (no shift by >= 32)
      int base = __reduce_add_sync(FULL, lane < warp ? t : 0);
      const int k_off = sh >> 5, r_off = sh & 31;
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int r = base + __popc(keep[j] & lt);
        if (((keep[j] >> lane) & 1u) && r < F) {
          uint32_t nwf[NW];
#pragma unroll
          for (int wi = 0; wi < NW; ++wi)
            nwf[wi] = mw[wi] | (wi == j ? bit : 0u);
#pragma unroll
          for (int i = 0; i < NW; ++i) {
            uint32_t lo_w = 0u, hi_w = 0u;
#pragma unroll
            for (int ko = 0; ko <= NW; ++ko) {
              if (k_off == ko) {
                lo_w = i + ko < NW ? nwf[i + ko] : 0u;
                hi_w = i + ko + 1 < NW ? nwf[i + ko + 1] : 0u;
              }
            }
            fw[i][r] = (lo_w >> r_off) |
                       (r_off == 0 ? 0u : hi_w << (32 - r_off));
          }
          fv[r] = val[j] & 0xFFFFu;
        }
        base += __popc(keep[j]);
      }
    }
    mark(3);
    __syncthreads();                   // 2: the compacted rows
    mark(4);

    // the next wave's frontier: rows r < min(count, F); only the warps
    // whose state may be filled take them. Exact dedupe: a row dies
    // when an identical row sits in a lower lane.
    const int nf = min(count, F);
    mf = false;
    if (s < nf) {
      const bool filled = lane < nf;
      uint32_t kw[NW];
#pragma unroll
      for (int wi = 0; wi < NW; ++wi) kw[wi] = filled ? fw[wi][lane] : 0u;
      const uint32_t kv = filled ? fv[lane] : UNFILLED;
      const unsigned same = match_rows<NW>(kw, kv);
      rfill = filled && __ffs(same) - 1 == lane;
#pragma unroll
      for (int wi = 0; wi < NW; ++wi) {
        rw[wi] = rfill ? kw[wi] : 0u;
        mw[wi] = __shfl_sync(FULL, rw[wi], s);
      }
      rv = rfill ? kv : 0u;
      mv = __shfl_sync(FULL, rv, s);
      mf = __shfl_sync(FULL, (int)rfill, s) != 0;
    }
    if (PROF && warp == 0) {
      // warp 0's rows are this wave's (its state 0 is below nf > 0)
      const int rows = __popc(__ballot_sync(FULL, rfill && nf > 0));
      nfilled += rows;
      nkept += count;
    }
    mark(5);
  }

  if (tid == PRODUCER) {
    // copies still in flight when the frontier died early
    for (int x = kk; x < r_pad && x < kk + STAGES; ++x)
      wait_stage(&full[x % STAGES], (x / STAGES) & 1);
  }
  if (tid == 0) {
    // row 0 was filled in each wave run: the most waves any row lived
    out[key * 4 + 0] = acc;
    out[key * 4 + 1] = ovf;
    out[key * 4 + 2] = peak;
    out[key * 4 + 3] = kk;
    if (PROF) {
      long long* pk = prof + key * (NPH + 2);
      for (int i = 0; i < NPH; ++i) pk[i] = ph[i];
      pk[NPH] = nfilled;
      pk[NPH + 1] = nkept;
    }
  }
}

template <bool PROF>
int launch(const int32_t* tab, const int32_t* scal, int32_t* out,
           long long* prof, int k, int r_pad, int wk, cudaStream_t stream) {
  switch (wk) {
    case 32:
      wgl_wave_kernel<32, PROF><<<k, THREADS, 0, stream>>>(tab, scal, r_pad,
                                                          out, prof);
      break;
    case 64:
      wgl_wave_kernel<64, PROF><<<k, THREADS, 0, stream>>>(tab, scal, r_pad,
                                                          out, prof);
      break;
    case 128:
      wgl_wave_kernel<128, PROF><<<k, THREADS, 0, stream>>>(tab, scal, r_pad,
                                                           out, prof);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// tab [k, r_pad, TLANES] int32, scal [k, r_pad, 8] int32 -> out [k, 4]
// int32 on `stream`; tab and scal 16-byte aligned (bulk copies). Returns
// the launch's cudaError_t (0 = launched).
extern "C" int wgl_wave_launch(const void* tab, const void* scal, void* out,
                               int k, int r_pad, int wk, void* stream) {
  return launch<false>(static_cast<const int32_t*>(tab),
                       static_cast<const int32_t*>(scal),
                       static_cast<int32_t*>(out), nullptr, k, r_pad, wk,
                       static_cast<cudaStream_t>(stream));
}

// The same search, and into prof [k, wgl_wave_phases() + 2] int64 the SM
// cycles thread 0 of each block spent in each phase, summed over waves,
// then the frontier's filled states and the kept candidates, summed over
// waves.
extern "C" int wgl_wave_profile(const void* tab, const void* scal, void* out,
                                void* prof, int k, int r_pad, int wk,
                                void* stream) {
  return launch<true>(static_cast<const int32_t*>(tab),
                      static_cast<const int32_t*>(scal),
                      static_cast<int32_t*>(out),
                      static_cast<long long*>(prof), k, r_pad, wk,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int wgl_wave_phases(void) { return NPH; }

extern "C" const char* wgl_wave_phase_name(int i) {
  static const char* names[NPH] = {
      "death test and row wait",
      "per-state facts, candidates and partial dedupe (filled states)",
      "barrier 1 (warp totals)",
      "count, refill and compaction",
      "barrier 2 (compacted rows)",
      "exact dedupe and hand-off (the next wave's states)"};
  return i >= 0 && i < NPH ? names[i] : "";
}

extern "C" const char* wgl_wave_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
