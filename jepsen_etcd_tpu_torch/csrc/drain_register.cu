// The epoch-v3 generator's register drain for Hopper (sm_90a): a lane
// per (seed, key) with its machine in registers, fed by worker warps that
// stage the planes and sort them into the lanes' lists a tile ahead.
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
// Design. A step reads and writes only the machine of its own key, so
// every (seed, key) pair is an independent chain. A block owns SB seeds and
// KB keys (the host picks them, engine_v3.drain_blocking) and walks the N
// rows in tiles of T. Its first warps are the lanes, lane s * KB + k holding
// ver, val, pver, pval of key k of seed s in registers; the other warps are
// workers. While the lanes walk tile t, the workers
//
// - write the five output planes of tile t - 1, coalesced, from its
//   records and the pairs the lanes stored;
// - wait for their copies of tile t + 1, turn each (row, seed) entry of it
//   into a record (class bits and key, the CAS old value, the value a write
//   or CAS stores) and, unless it is timed out, set its bit in its (seed,
//   key)'s bit list (a word per 32 rows, shared-memory atomicOr);
// - start the copies of tile t + 2: each worker copies its own entries'
//   seven values into a slot of shared memory with 4-byte cp.async, so
//   they land while tile t + 1 is sorted and tile t walked. The workers
//   take the entries in the order of device memory: seeds fastest for
//   (N, S) planes, rows fastest for seed-major ones (an [S, N] tensor
//   seen transposed, as the generator builds them), so a warp's copies
//   and stores are contiguous even in a block of one seed. An int32 plane
//   is always aligned; a flag is copied as the aligned word that holds it,
//   and only a word that crosses either end of its plane is read byte by
//   byte with a plain load, so no alignment of S or of the tensors is
//   needed;
// - count the bit lists (one warp: a prefix over each list's words and a
//   scan over the lanes) and scatter each record to its rank in its lane's
//   list, so a lane's list is its rows in order, contiguous.
//
// A lane then takes its list BATCH records at a time, all loads before the
// steps, and stores for each step only the pair the outputs need (the stale
// or current pair of a read, the current pair of a write or CAS).
//
// What bounds it on this card: neither bytes (42 a (step, seed) against
// 3.35 TB/s) nor a lane's chain (its writes and CASes that are not timed
// out, four dependent operations each: compare, and, or, select), but the
// workers' passes over each tile, latency-bound with a few entries a
// thread, beside which the lanes' walk (N / K steps a lane, BATCH records
// loaded ahead) finishes. So the host spreads the (seed, key) pairs over
// every SM (engine_v3.drain_lanes), and the workers load a batch of
// entries before they store any.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// engine.py's codes (copied into the port's simbatch/engine.py)
constexpr int FC_READ = 0, FC_WRITE = 1, FC_CAS = 2;
constexpr int TC_OK = 1, TC_FAIL = 2;
constexpr int PK_REG_RD_OK = 2, PK_REG_WR_OK = 4, PK_REG_CAS_OK = 6,
              PK_REG_CAS_FAIL = 7;
// threads of a block: the lanes' warps first, at least two worker warps
constexpr int THREADS = 256;
constexpr int MAX_LANES = THREADS - 64;
// records a lane loads before it steps through them, and entries a worker
// loads before it computes and stores any (the stores to shared memory
// would otherwise hold every next load back)
constexpr int BATCH = 8, WBATCH = 4;
// bit-list words of a (seed, key) at most: T <= 512 rows
constexpr int MAX_WORDS = 16;
// a record's class bits; the key sits above KEY_SHIFT
constexpr int R_READ = 1, R_WRITE = 2, R_CAS = 4, R_STALE = 8, R_MINE = 16;
constexpr int R_OP = R_READ | R_WRITE | R_CAS;
constexpr int KEY_SHIFT = 8;
constexpr int KEY_MAX = 1 << 23;
// planes: k, f, wv, co, cn (int32), then to, sg (bytes)
constexpr int NPLANES = 7;
// shared memory a block may take without opting in to more
constexpr int SMEM_DEFAULT = 48 * 1024;

struct Args {
  const int32_t* state[4];  // ver0, val0, pver0, pval0 [S, K]
  const char* plane[NPLANES];
  int32_t* out;             // [5, N, S]
  int N, S, K, SB, KB, T;
  int seed_major;           // planes and out laid out [S, N]
};

// Byte offsets of a block's shared memory, from (SB, KB, T) alone: a
// staging slot of 8 words per entry, the entries' records (class word,
// (co, nl) pair) for three tiles, the lanes' stored pairs (and one slot
// that the steps of no entry store to) for two, the
// lanes' sorted lists (entry, class, co, nl) and their (start, length)
// for two, and the bit lists with their copies and word prefixes.
struct Layout {
  int stage, cls[3], conl[3], res[2], lrec[2], base[2], tot[2];
  int mask, word, pre, bytes;
};

__host__ __device__ inline int region(int* off, int bytes) {
  const int at = *off;
  *off += (bytes + 15) / 16 * 16;
  return at;
}

__host__ __device__ inline Layout layout(int SB, int KB, int T) {
  const int entries = T * SB, lanes = SB * KB, words = lanes * (T / 32);
  Layout L;
  int off = 0;
  L.stage = region(&off, entries * 32);
  for (int b = 0; b < 3; ++b) L.cls[b] = region(&off, entries * 4);
  for (int b = 0; b < 3; ++b) L.conl[b] = region(&off, entries * 8);
  for (int b = 0; b < 2; ++b) {
    L.res[b] = region(&off, (entries + 1) * 8);  // + a slot for no entry
    L.lrec[b] = region(&off, entries * 16);
    L.base[b] = region(&off, lanes * 4);
    L.tot[b] = region(&off, lanes * 4);
  }
  L.mask = region(&off, words * 4);
  L.word = region(&off, words * 4);
  L.pre = region(&off, words * 4);
  L.bytes = off;
  return L;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the workers' own barrier (named barrier 1; the block's is 0)
__device__ __forceinline__ void workers_sync(int nwork) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nwork) : "memory");
}

__global__ void __launch_bounds__(THREADS)
    drain_register_kernel(const Args a) {
  extern __shared__ __align__(16) char smem[];
  const Layout L = layout(a.SB, a.KB, a.T);
  const int s0 = blockIdx.x * a.SB, k0 = blockIdx.y * a.KB;
  const int sbn = min(a.SB, a.S - s0), kbn = min(a.KB, a.K - k0);
  const int lanes = sbn * kbn, C = a.T / 32;
  const int nwalk = (lanes + 31) / 32 * 32, nwork = THREADS - nwalk;
  const bool walker = threadIdx.x < nwalk;
  const int lane = threadIdx.x, wt = threadIdx.x - nwalk;
  const int ls = lane / kbn, lk = lane - ls * kbn;
  const int ntiles = (a.N + a.T - 1) / a.T;
  const long long plane_out = (long long)a.N * a.S;
  const auto cls_of = [&](int t) {
    return reinterpret_cast<int32_t*>(smem + L.cls[t % 3]);
  };
  const auto conl_of = [&](int t) {
    return reinterpret_cast<int2*>(smem + L.conl[t % 3]);
  };
  const auto res_of = [&](int t) {
    return reinterpret_cast<int2*>(smem + L.res[t & 1]);
  };
  const auto lrec_of = [&](int t) {
    return reinterpret_cast<int4*>(smem + L.lrec[t & 1]);
  };
  const auto base_of = [&](int t) {
    return reinterpret_cast<int32_t*>(smem + L.base[t & 1]);
  };
  const auto tot_of = [&](int t) {
    return reinterpret_cast<int32_t*>(smem + L.tot[t & 1]);
  };
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + L.mask);
  uint32_t* word = reinterpret_cast<uint32_t*>(smem + L.word);
  int32_t* pre = reinterpret_cast<int32_t*>(smem + L.pre);
  int32_t* stage = reinterpret_cast<int32_t*>(smem + L.stage);

  // the lane's machine, in registers
  int32_t cv = 0, cl = 0, pv = 0, pl = 0;
  if (lane < lanes) {
    const long long at = (long long)(s0 + ls) * a.K + k0 + lk;
    cv = a.state[0][at];
    cl = a.state[1][at];
    pv = a.state[2][at];
    pl = a.state[3][at];
  }

  // entry q of a worker's pass over the tile at row r0 of `rows` rows:
  // its row and seed in the order that walks device memory contiguously
  // (seeds fastest in the (N, S) layout, rows fastest in the seed-major
  // one), and its index in a plane
  const auto locate = [&](int r0, int rows, int q, int& row,
                          int& s) -> long long {
    if (a.seed_major) {
      s = q / rows;
      row = q - s * rows;
      return (long long)(s0 + s) * a.N + r0 + row;
    }
    row = q / sbn;
    s = q - row * sbn;
    return (long long)(r0 + row) * a.S + s0 + s;
  };

  // a worker's copies of its entries of tile u into their slots
  const auto stage_tile = [&](int u) {
    const int r0 = u * a.T, rows = min(a.T, a.N - r0), n = rows * sbn;
#pragma unroll 2
    for (int q = wt; q < n; q += nwork) {
      int row, s;
      const long long i = locate(r0, rows, q, row, s);
      int32_t* slot = stage + 8 * (row * sbn + s);
      for (int p = 0; p < 5; ++p) {
        cp_async4(slot + p, a.plane[p] + 4 * i);
      }
      for (int p = 5; p < NPLANES; ++p) {
        const uintptr_t lo = reinterpret_cast<uintptr_t>(a.plane[p]);
        const uintptr_t at = lo + (uintptr_t)i;
        const uintptr_t w = at & ~(uintptr_t)3;
        if (w >= lo && w + 4 <= lo + (uintptr_t)plane_out) {
          cp_async4(slot + p, reinterpret_cast<const void*>(w));
        } else {
          reinterpret_cast<char*>(slot + p)[at & 3] =
              *reinterpret_cast<const char*>(at);
        }
      }
    }
    cp_async_commit();
  };

  // one step of the lane's machine on record (w, v) of entry e, without
  // a branch: a step of no entry has w = 0 and stores to the spare slot
  const auto step = [&](int2* res, int e, int w, int2 v) {
    const bool stale = (w & R_STALE) != 0, wrt = (w & R_WRITE) != 0;
    const bool cas = (w & R_CAS) != 0;
    res[e] = stale ? make_int2(pv, pl) : make_int2(cv, cl);
    const bool up = wrt | (cas & (cl == v.x));
    pv = up ? cv : pv;
    pl = up ? cl : pl;
    cv = up ? cv + 1 : cv;
    cl = up ? v.y : cl;
  };

  if (!walker) {
    stage_tile(0);
    for (int i = wt; i < lanes * C; i += nwork) mask[i] = 0;
    workers_sync(nwork);
  }
  for (int t = -1; t <= ntiles; ++t) {
    if (walker) {
      // -- the walk of tile t ---------------------------------------------
      if (t >= 0 && t < ntiles && lane < lanes) {
        int2* res = res_of(t);
        const int spare = a.T * a.SB;
        const int4* rec = lrec_of(t) + base_of(t)[lane];
        const int n = tot_of(t)[lane];
        for (int i = 0; i < n; i += BATCH) {
          int4 r[BATCH];
#pragma unroll
          for (int j = 0; j < BATCH; ++j) {
            r[j] = i + j < n ? rec[i + j] : make_int4(spare, 0, 0, 0);
          }
#pragma unroll
          for (int j = 0; j < BATCH; ++j) {
            step(res, r[j].x, r[j].y, make_int2(r[j].z, r[j].w));
          }
        }
      }
    } else {
      // -- the outputs of tile t - 1, coalesced ---------------------------
      if (t >= 1) {
        const int r0 = (t - 1) * a.T, rows = min(a.T, a.N - r0);
        const int32_t* cls = cls_of(t - 1);
        const int2* conl = conl_of(t - 1);
        const int2* res = res_of(t - 1);
        for (int q0 = wt; q0 < rows * sbn; q0 += WBATCH * nwork) {
          long long i[WBATCH];
          int w[WBATCH];
          int2 v[WBATCH], r[WBATCH];
#pragma unroll
          for (int j = 0; j < WBATCH; ++j) {
            const int q = q0 + j * nwork;
            int row = 0, s = 0;
            i[j] = q < rows * sbn ? locate(r0, rows, q, row, s) : -1;
            const int e = row * sbn + s;
            w[j] = i[j] >= 0 ? cls[e] : 0;
            v[j] = conl[e];
            r[j] = res[e];
          }
#pragma unroll
          for (int j = 0; j < WBATCH; ++j) {
            if (!(w[j] & R_MINE)) continue;
            const bool is_r = w[j] & R_READ, is_w = w[j] & R_WRITE;
            const bool is_c = w[j] & R_CAS;
            const bool cas_ok = is_c && r[j].y == v[j].x;
            const bool wr = is_w || cas_ok;
            int32_t* o = a.out + i[j];
            o[0] = (is_c && !cas_ok) ? TC_FAIL : TC_OK;
            o[plane_out] = is_r     ? PK_REG_RD_OK
                           : is_w   ? PK_REG_WR_OK
                           : cas_ok ? PK_REG_CAS_OK
                                    : PK_REG_CAS_FAIL;
            o[2 * plane_out] = is_r ? r[j].x : wr ? r[j].x + 1 : v[j].x;
            o[3 * plane_out] = is_r ? r[j].y : cas_ok ? v[j].x : v[j].y;
            o[4 * plane_out] = cas_ok ? v[j].y : -1;
          }
        }
      }
      if (t + 1 < ntiles) {
        // -- tile t + 1's records and bit lists -------------------------
        const int u = t + 1, r0 = u * a.T, rows = min(a.T, a.N - r0);
        const int n = rows * sbn;
        int32_t* cls = cls_of(u);
        int2* conl = conl_of(u);
        cp_async_wait_all();
        const int sh5 = (int)(reinterpret_cast<uintptr_t>(a.plane[5]) & 3);
        const int sh6 = (int)(reinterpret_cast<uintptr_t>(a.plane[6]) & 3);
        for (int q0 = wt; q0 < n; q0 += WBATCH * nwork) {
          int row[WBATCH], s[WBATCH], i3[WBATCH];
          int4 x[WBATCH], y[WBATCH];
#pragma unroll
          for (int j = 0; j < WBATCH; ++j) {
            const int q = q0 + j * nwork;
            row[j] = s[j] = 0;
            // a flag's byte in its word: the tensor's offset plus the index
            i3[j] = q < n ? (int)(locate(r0, rows, q, row[j], s[j]) & 3) : -1;
            const int e = row[j] * sbn + s[j];
            x[j] = reinterpret_cast<const int4*>(stage)[2 * e];
            y[j] = reinterpret_cast<const int4*>(stage)[2 * e + 1];
          }
#pragma unroll
          for (int j = 0; j < WBATCH; ++j) {
            if (i3[j] < 0) continue;
            const int k = x[j].x, f = x[j].y, wv = x[j].z, co = x[j].w;
            const int cn = y[j].x;
            const bool ok =
                ((y[j].y >> (8 * ((sh5 + i3[j]) & 3))) & 0xff) == 0;
            const bool sg =
                ((y[j].z >> (8 * ((sh6 + i3[j]) & 3))) & 0xff) != 0;
            const bool is_r = ok && f == FC_READ, is_w = ok && f == FC_WRITE;
            const bool is_c = ok && f == FC_CAS;
            const int kk = k - k0;
            const bool mine = kk >= 0 && kk < kbn;
            const int w = (is_r ? R_READ : 0) | (is_w ? R_WRITE : 0) |
                          (is_c ? R_CAS : 0) | (sg && is_r ? R_STALE : 0) |
                          (mine ? R_MINE : 0) | (k << KEY_SHIFT);
            const int e = row[j] * sbn + s[j];
            cls[e] = w;
            conl[e] = make_int2(co, is_w ? wv : cn);
            if (mine && (w & R_OP)) {
              atomicOr(&mask[(s[j] * kbn + kk) * C + (row[j] >> 5)],
                       1u << (row[j] & 31));
            }
          }
        }
        // every slot is read before the next copies land in it (the last
        // tile's entries may fall to other workers)
        workers_sync(nwork);
        if (t + 2 < ntiles) stage_tile(t + 2);
        // -- the lanes' lists: counts, starts, then each record's rank
        int32_t* base = base_of(u);
        int32_t* tot = tot_of(u);
        if (wt < 32) {
          int carry = 0;
          for (int g = 0; g < lanes; g += 32) {
            const int l = g + wt;
            int run = 0;
            if (l < lanes) {
              uint32_t m[MAX_WORDS];
#pragma unroll
              for (int c = 0; c < MAX_WORDS; ++c) {
                m[c] = c < C ? mask[l * C + c] : 0;
              }
#pragma unroll
              for (int c = 0; c < MAX_WORDS; ++c) {
                if (c < C) {
                  word[l * C + c] = m[c];
                  mask[l * C + c] = 0;
                  pre[l * C + c] = run;
                  run += __popc(m[c]);
                }
              }
            }
            int incl = run;
            for (int d = 1; d < 32; d <<= 1) {
              const int v = __shfl_up_sync(0xffffffffu, incl, d);
              if (wt >= d) incl += v;
            }
            if (l < lanes) {
              base[l] = carry + incl - run;
              tot[l] = run;
            }
            carry += __shfl_sync(0xffffffffu, incl, 31);
          }
        }
        workers_sync(nwork);
        int4* lrec = lrec_of(u);
        for (int e0 = wt; e0 < n; e0 += WBATCH * nwork) {
          int w[WBATCH], at[WBATCH];
          int2 v[WBATCH];
#pragma unroll
          for (int j = 0; j < WBATCH; ++j) {
            const int e = min(e0 + j * nwork, n - 1);
            w[j] = e0 + j * nwork < n ? cls[e] : 0;
            v[j] = conl[e];
          }
          int rank[WBATCH];
#pragma unroll
          for (int j = 0; j < WBATCH; ++j) {
            const int e = min(e0 + j * nwork, n - 1);
            const int row = e / sbn, s = e - row * sbn;
            const bool take = (w[j] & R_MINE) && (w[j] & R_OP);
            const int l = take ? s * kbn + (w[j] >> KEY_SHIFT) - k0 : 0;
            at[j] = l * C + (row >> 5);
            rank[j] = base[l] + pre[at[j]] +
                      __popc(word[at[j]] & ((1u << (row & 31)) - 1));
            at[j] = take ? e : -1;  // w = 0 past n: no entry
          }
#pragma unroll
          for (int j = 0; j < WBATCH; ++j) {
            if (at[j] >= 0) {
              lrec[rank[j]] = make_int4(at[j], w[j], v[j].x, v[j].y);
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Bytes of shared memory a block takes with SB seeds and KB keys, tiles of
// T rows.
int drain_register_smem(int SB, int KB, int T) {
  return layout(SB, KB, T).bytes;
}

// Lanes a block may take: SB * KB may not exceed it.
int drain_register_max_lanes() { return MAX_LANES; }

// ver0, val0, pver0, pval0 [S, K]; k, f, wv, co, cn [N, S] int32; to, sg
// [N, S] bytes (0 or 1) -> out [5, N, S] int32 (tc, pk, va, vb, vc), all on
// the current device, keys in [0, K); seed_major != 0 lays the planes and
// each plane of out out [S, N] instead. A block owns SB seeds and KB keys
// (SB * KB <= drain_register_max_lanes()) and walks tiles of T rows (a
// multiple of 32). Returns the launch's cudaError_t (0 = launched).
int drain_register_launch(const int32_t* ver0, const int32_t* val0,
                          const int32_t* pver0, const int32_t* pval0,
                          const int32_t* k_seq, const int32_t* f_seq,
                          const int32_t* wv_seq, const int32_t* co_seq,
                          const int32_t* cn_seq, const uint8_t* to_seq,
                          const uint8_t* sg_seq, int32_t* out, int N, int S,
                          int K, int SB, int KB, int T, int seed_major,
                          void* stream) {
  if (N < 0 || S < 0 || K < 1 || K >= KEY_MAX || SB < 1 || KB < 1 ||
      KB > K || (long long)SB * KB > MAX_LANES || T < 32 || T % 32 != 0 ||
      T > 32 * MAX_WORDS ||
      (long long)N * S >= (1LL << 31) || (S > 0 && SB > S)) {
    return (int)cudaErrorInvalidValue;
  }
  if (N == 0 || S == 0) return 0;
  const Layout L = layout(SB, KB, T);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return (int)err;
  if (L.bytes > optin) return (int)cudaErrorInvalidValue;
  if (L.bytes > SMEM_DEFAULT) {
    err = cudaFuncSetAttribute(drain_register_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  Args a;
  const int32_t* state[4] = {ver0, val0, pver0, pval0};
  const void* planes[NPLANES] = {k_seq, f_seq, wv_seq, co_seq,
                                 cn_seq, to_seq, sg_seq};
  for (int i = 0; i < 4; ++i) a.state[i] = state[i];
  for (int p = 0; p < NPLANES; ++p) {
    a.plane[p] = static_cast<const char*>(planes[p]);
  }
  a.out = out;
  a.N = N;
  a.S = S;
  a.K = K;
  a.SB = SB;
  a.KB = KB;
  a.T = T;
  a.seed_major = seed_major != 0;
  drain_register_kernel<<<dim3((S + SB - 1) / SB, (K + KB - 1) / KB),
                          THREADS, L.bytes,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* drain_register_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
