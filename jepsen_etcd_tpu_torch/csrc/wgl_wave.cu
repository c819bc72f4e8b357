// WGL frontier wave search for Hopper (sm_90a).
//
// Replaces the reference's Pallas kernel jepsen_etcd_tpu/ops/wgl_mxu.py
// _make_kernel / _wave_body (one BFS wave per grid step over packed
// (nr, 128) planes, with MXU one-hot matmuls for ranks and compaction).
// It computes the same [accepted, overflowed, peak, waves] vector per
// key, bit for bit, and is held against the plain PyTorch version
// wave_search_reference in ops/wgl_mxu.py.
//
// Shape: one thread block per key, and a loop over the r_pad waves
// inside the block in place of the TPU's sequential grid axis. The
// frontier (F = 32 states: nw mask words, a value id, an alive flag)
// lives in shared memory; each wave reads its table row from device
// memory. The F*wk candidates (1,024 / 2,048 / 4,096) map to the
// block's 1,024 threads, 1 to 4 each, in the reference's plane order:
// candidate (state s, op o) sits at plane position idx = p*128 + q with
// s = nr*(q/wk) + p and o = q % wk.
//
// Exact integer logic replaces the MXU tricks: dense ranks come from
// __ballot_sync/__popc warp prefix sums plus a block-level prefix over
// warp totals (in row-major plane order, as the reference ranks), the
// compaction is a direct scatter of the candidate ranked r into frontier
// row r, and the exact row dedupe over the 32 compacted rows is one
// warp.
//
// What bounds it: the serial chain of waves, not bytes. The table is
// r_pad * TLANES * 4 bytes (about 8 MB for a 10k-op history at wk = 32,
// a few microseconds of HBM time), but each wave depends on the last,
// so a check costs (waves) x (one wave's latency: a row load and eight
// block barriers). One block per key leaves a single-key check on one of
// the 132 SMs; batches of keys fill the card. Making one key fast
// (several blocks or a cluster per key, row prefetch, fewer barriers) is
// later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int F = 32;
constexpr int THREADS = 1024;
constexpr int NWARPS = THREADS / 32;
constexpr int SCAL_COLS = 8;
constexpr int S_SHIFT = 0, S_CEILB = 1, S_UPD0 = 2, S_R = 6;
constexpr int READ = 0, WRITE = 1, CAS = 2;

template <int WK>
struct Dims {
  static constexpr int NW = WK / 32;            // mask words
  static constexpr int NR = F * WK / 128;       // plane rows
  static constexpr int NP = F * WK;             // candidate slots
  static constexpr int SEGK = 128 / WK;         // states per plane row
  static constexpr int TL = (WK * (3 + NW) + 127) / 128 * 128;
  static constexpr int PER = NP / THREADS;      // candidates per thread
  static constexpr int NDUP = NR < 8 ? NR : 8;  // partial-dedupe rows
  // dynamic shared memory: candidate words [NW][NP] + values [NP]
  static constexpr size_t SMEM = (size_t)(NW + 1) * NP * sizeof(uint32_t);
};

template <int WK>
__global__ void __launch_bounds__(THREADS)
wgl_wave_kernel(const int32_t* __restrict__ tab,
                const int32_t* __restrict__ scal, int r_pad,
                int32_t* __restrict__ out) {
  using D = Dims<WK>;
  constexpr int NW = D::NW, NR = D::NR, NP = D::NP, TL = D::TL;

  extern __shared__ uint32_t dsm[];
  uint32_t* cw = dsm;                                  // [NW][NP]
  int32_t* cv = reinterpret_cast<int32_t*>(dsm + NW * NP);  // [NP], -1 = invalid

  __shared__ int32_t row[TL];
  __shared__ int32_t srow[SCAL_COLS];
  __shared__ uint32_t fw[NW][F];     // frontier mask words
  __shared__ int32_t fv[F];          // frontier value ids (biased)
  __shared__ int32_t falive[F];
  __shared__ uint32_t nfw[NW][F];    // compacted rows of this wave
  __shared__ int32_t nfv[F];
  __shared__ int32_t nfill[F];
  __shared__ int32_t version[F];
  __shared__ int32_t st_ok[F];       // alive and under the ceilings
  __shared__ int32_t segbad[F];
  __shared__ int32_t wav[F];         // waves each state slot was alive
  __shared__ int32_t wtot[D::PER * NWARPS];
  __shared__ int32_t wpre[D::PER * NWARPS];
  __shared__ int32_t s_count;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t key = blockIdx.x;
  tab += key * (size_t)r_pad * TL;
  scal += key * (size_t)r_pad * SCAL_COLS;
  const int R = scal[S_R];

  if (tid < F) {
    for (int wi = 0; wi < NW; ++wi) fw[wi][tid] = 0u;
    fv[tid] = tid == 0 ? 1 : 0;      // biased NONE value
    falive[tid] = tid == 0 ? 1 : 0;
    wav[tid] = 0;
  }
  int acc = 0, ovf = 0, peak = 1;    // meaningful in thread 0 only

  for (int kk = 0; kk < r_pad; ++kk) {
    // a dead frontier stays dead: stop at the first wave without one
    if (!__syncthreads_or(tid < F ? falive[tid] : 0)) break;
    const int32_t* trow = tab + (size_t)kk * TL;
    for (int i = tid; i < TL; i += THREADS) row[i] = trow[i];
    if (tid < SCAL_COLS) srow[tid] = scal[(size_t)kk * SCAL_COLS + tid];
    __syncthreads();

    // per state: derived version, version-ceiling prune, wave count
    if (tid < F) {
      const int alive = falive[tid];
      wav[tid] += alive;
      int ver = 0;
      for (int wi = 0; wi < NW; ++wi)
        ver += __popc(fw[wi][tid] & (uint32_t)srow[S_UPD0 + wi]);
      version[tid] = ver;
      st_ok[tid] = alive && ver <= srow[S_CEILB];
      segbad[tid] = 0;
      nfill[tid] = 0;
    }
    __syncthreads();

    // per-state ceiling prune: a state dies when any not-yet-linearized
    // window op has a ceiling below its version
    for (int j = 0; j < D::PER; ++j) {
      const int idx = j * THREADS + tid;
      const int p = idx >> 7, q = idx & 127;
      const int s = NR * (q / WK) + p, o = q % WK;
      const bool not_set = ((fw[o >> 5][s] >> (o & 31)) & 1u) == 0u;
      const int rceil = row[WK + o] >> 16;
      if (not_set && rceil < version[s]) segbad[s] = 1;
    }
    __syncthreads();

    // successor validity and the successor state of every candidate
    const int sh = srow[S_SHIFT];
    for (int j = 0; j < D::PER; ++j) {
      const int idx = j * THREADS + tid;
      const int p = idx >> 7, q = idx & 127;
      const int s = NR * (q / WK) + p, o = q % WK;
      const int av = row[o];
      const int a1 = av & 0xFFFF;
      const int a2 = (av >> 16) & 0xFFFF;
      const int vc = row[WK + o];
      const int rver = (int)(int16_t)(vc & 0xFFFF);
      const int fsk = row[WK * (2 + NW) + o] & 0xFFFF;
      const int ver = version[s];
      const int sv = fv[s];
      uint32_t sw[NW], nwf[NW];
      bool preds_in = true;
#pragma unroll
      for (int wi = 0; wi < NW; ++wi) {
        sw[wi] = fw[wi][s];
        const uint32_t pm = (uint32_t)row[WK * (2 + wi) + o];
        preds_in = preds_in && (sw[wi] & pm) == pm;
        nwf[wi] = sw[wi] | (wi == (o >> 5) ? 1u << (o & 31) : 0u);
      }
      const bool not_set = ((fw[o >> 5][s] >> (o & 31)) & 1u) == 0u;
      const bool alive = st_ok[s] && !segbad[s];
      const bool is_read = fsk == 1 + READ;
      const bool is_write = fsk == 1 + WRITE;
      const bool is_cas = fsk == 1 + CAS;
      const bool ver_ok = rver == -32768 || (is_read && rver == ver) ||
                          ((is_write || is_cas) && rver == ver + 1);
      const bool model_ok = (is_read && (a1 == 0 || a1 == sv)) ||
                            is_write || (is_cas && a1 == sv);
      // slide: the `sh` lowest window bits fall off and must all be set
      bool slide_ok = true;
#pragma unroll
      for (int wi = 0; wi < NW; ++wi) {
        const int k = min(max(sh - 32 * wi, 0), 32);
        const uint32_t lm = k >= 32 ? 0xFFFFFFFFu : (1u << k) - 1u;
        slide_ok = slide_ok && (nwf[wi] & lm) == lm;
      }
      // shifted window (w_hi..w_lo) >> sh, word-wise; no shift by >= 32
      const int k_off = sh >> 5, r_off = sh & 31;
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
        const uint32_t carry = r_off == 0 ? 0u : hi_w << (32 - r_off);
        cw[i * NP + idx] = (lo_w >> r_off) | carry;
      }
      const bool valid = alive && fsk > 0 && not_set && preds_in &&
                         ver_ok && model_ok && slide_ok;
      cv[idx] = valid ? (is_read ? sv : (is_write ? a1 : a2)) : -1;
    }
    __syncthreads();

    // partial candidate dedupe against a fixed set of candidates with
    // the same op: d plane rows above, and wk*gs lanes to the left.
    // Then ballot the survivors for their ranks.
    unsigned ballots[D::PER];
#pragma unroll
    for (int j = 0; j < D::PER; ++j) {
      const int idx = j * THREADS + tid;
      const int p = idx >> 7, q = idx & 127;
      const int v = cv[idx];
      bool keep = v >= 0;
      if (keep) {
        for (int d = 1; d < D::NDUP && keep; ++d) {
          if (p < d) break;
          const int other = idx - d * 128;
          bool eq = cv[other] == v;
          for (int wi = 0; wi < NW; ++wi)
            eq = eq && cw[wi * NP + other] == cw[wi * NP + idx];
          keep = !eq;
        }
        for (int gs = 1; gs < D::SEGK && keep; ++gs) {
          if (q < WK * gs) break;
          const int other = idx - WK * gs;
          bool eq = cv[other] == v;
          for (int wi = 0; wi < NW; ++wi)
            eq = eq && cw[wi * NP + other] == cw[wi * NP + idx];
          keep = !eq;
        }
      }
      ballots[j] = __ballot_sync(0xFFFFFFFFu, keep);
      if (lane == 0) wtot[j * NWARPS + warp] = __popc(ballots[j]);
    }
    __syncthreads();

    // exclusive prefix over the warp totals in plane order (one warp)
    if (warp == 0) {
      int base = 0;
      for (int j = 0; j < D::PER; ++j) {
        const int t = wtot[j * NWARPS + lane];
        int incl = t;
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(0xFFFFFFFFu, incl, off);
          if (lane >= off) incl += y;
        }
        wpre[j * NWARPS + lane] = base + incl - t;
        base += __shfl_sync(0xFFFFFFFFu, incl, 31);
      }
      if (lane == 0) s_count = base;
    }
    __syncthreads();

    // compaction: the candidate ranked r < F becomes frontier row r
    const unsigned lt = (1u << lane) - 1u;
#pragma unroll
    for (int j = 0; j < D::PER; ++j) {
      if (!((ballots[j] >> lane) & 1u)) continue;
      const int rank = wpre[j * NWARPS + warp] + __popc(ballots[j] & lt);
      if (rank < F) {
        const int idx = j * THREADS + tid;
        for (int wi = 0; wi < NW; ++wi) nfw[wi][rank] = cw[wi * NP + idx];
        nfv[rank] = cv[idx] & 0xFFFF;
        nfill[rank] = 1;
      }
    }
    if (tid == 0) {
      // flags before truncation: acceptance is witness-based; overflow
      // = some candidate ranked past capacity; peak = max rank + 1
      const int count = s_count;
      if (count > peak) peak = count;
      if (count > F) ovf = 1;
      if (kk == R - 1 && count > 0) acc = 1;
    }
    __syncthreads();

    // exact frontier dedupe: kill a row identical to a lower-ranked
    // filled row; killed rows stay as holes
    if (warp == 0) {
      const int r = lane;
      uint32_t kw[NW];
#pragma unroll
      for (int wi = 0; wi < NW; ++wi) kw[wi] = nfw[wi][r];
      const int kv = nfv[r];
      bool filled = nfill[r] != 0;
      for (int r2 = 0; r2 < r && filled; ++r2) {
        bool eq = nfill[r2] != 0 && nfv[r2] == kv;
#pragma unroll
        for (int wi = 0; wi < NW; ++wi) eq = eq && nfw[wi][r2] == kw[wi];
        if (eq) filled = false;
      }
      for (int wi = 0; wi < NW; ++wi) fw[wi][r] = filled ? kw[wi] : 0u;
      fv[r] = filled ? kv : 0;
      falive[r] = filled ? 1 : 0;
    }
  }
  __syncthreads();

  if (tid == 0) {
    int waves = 0;
    for (int s = 0; s < F; ++s) waves = max(waves, wav[s]);
    out[key * 4 + 0] = acc;
    out[key * 4 + 1] = ovf;
    out[key * 4 + 2] = peak;
    out[key * 4 + 3] = waves;
  }
}

template <int WK>
int launch(const int32_t* tab, const int32_t* scal, int32_t* out, int k,
           int r_pad, cudaStream_t stream) {
  const size_t smem = Dims<WK>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      wgl_wave_kernel<WK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  wgl_wave_kernel<WK><<<k, THREADS, smem, stream>>>(tab, scal, r_pad, out);
  return (int)cudaGetLastError();
}

}  // namespace

// tab [k, r_pad, TLANES] int32, scal [k, r_pad, 8] int32 -> out [k, 4]
// int32 on `stream`. Returns the launch's cudaError_t (0 = launched).
extern "C" int wgl_wave_launch(const void* tab, const void* scal, void* out,
                               int k, int r_pad, int wk, void* stream) {
  const auto* t = static_cast<const int32_t*>(tab);
  const auto* s = static_cast<const int32_t*>(scal);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (wk) {
    case 32: return launch<32>(t, s, o, k, r_pad, st);
    case 64: return launch<64>(t, s, o, k, r_pad, st);
    case 128: return launch<128>(t, s, o, k, r_pad, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* wgl_wave_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
