// The B3 rung kernel's tables for Hopper (sm_90a), built on the card.
//
// Replaces no kernel of the reference: there the ladder's frames are
// numpy on the host (jepsen_etcd_tpu/ops/wgl.py ensure_frames), padded
// and copied to the TPU as they are. The port did the same and then
// narrowed them for csrc/wgl_rung.cu (ops/wgl.py _build_frames,
// pad_tables, _tables_to, _rung_kernel_tables): a key of 10,700 ops at
// I = 44 took ~130 ms of numpy and a 36 MB copy of int64 tables. This
// kernel writes the rung kernel's two large int32 tables straight from a
// key's per-op vectors (~0.5 MB), to the bit what that host path gives;
// the host path stays its plain version, and the route of every ladder
// the rung kernel does not begin (ops/wgl.py _check_packed_impl).
//
// What bounds it: the bytes it writes, [r_pad, 196] + [r_pad, 2 * i_tab]
// int32 (~21 MB at r_pad 16,384 and i_tab 64, a few microseconds at
// 3.35 TB/s). It reads each per-op vector a window at a time, from L2.
//
// What the design does about it. A warp per depth row d, a lane per
// window slot c (the window is one word, w = 32):
//
// - Lane c gathers rank lo[d] + c, clamped to R - 1, as the host's
//   clamped gathers do, and writes its slot of the row's six per-slot
//   fields: fsk (static_ok ? 1 + f : 0, static_ok = in range and every
//   required predecessor below depth d), a1, a2, ver, the pred word, and
//   the ceiling (2**30 out of range). Each field is one coalesced
//   128-byte store a warp.
// - Slot c's pred word, bit b = slot b in range and ret_b < inv_c, is one
//   ballot with inv_c broadcast by a shuffle: 32 ballots a row. The
//   update word is one more.
// - Info member j's pred word is the ballot of ret_b < i_inv[j]; its
//   static bit is last[j] < min(lo[d] + 32, R), last[j] the highest rank
//   r with ret[r] < i_inv[j] (the host computes it once a key): no
//   required op before member j lies past the window. Lane j % 32 keeps
//   the word, so each 32 members are one coalesced store.
// - Rows from R to r_pad are written here too (zeros, the ceilings
//   2**30), so no memset runs before the launch.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W = 32;                   // window slots: a warp's lanes
constexpr int WARPS = 8;                // depth rows a block
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WRITE = 1, CAS = 2;
constexpr int32_t CEIL_INF = 1 << 30;

// A depth's row (int32), as csrc/wgl_rung.cu reads it: per window slot
// fsk, a1, a2, ver, pred word, ceiling; then shift, u_forced,
// ceil_beyond and the update-mask word.
constexpr int T_FSK = 0, T_A1 = W, T_A2 = 2 * W, T_VER = 3 * W;
constexpr int T_PRED = 4 * W, T_CEIL = 5 * W, T_SHIFT = 6 * W;
constexpr int T_CEILB = T_SHIFT + 2;
constexpr int ROW = T_SHIFT + 4;

// The input (int32), vectors of R in this order, then i_inv [I] and
// last [I] (ops/wgl.py _frame_inputs writes it).
enum { S_PRED, S_INV, S_RET, S_F, S_A1, S_A2, S_VER, S_CEIL, S_LO,
       S_SHIFT, S_UF, S_CEILB, S_VECS };

__global__ void __launch_bounds__(THREADS)
wgl_frames_kernel(const int32_t* __restrict__ in, int R, int I, int i_tab,
                  int r_pad, int32_t* __restrict__ rows,
                  int32_t* __restrict__ info) {
  const int lane = threadIdx.x & 31;
  const int d = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (d >= r_pad) return;                  // the whole warp
  int32_t* row = rows + (size_t)d * ROW;
  int32_t* irow = info + (size_t)d * 2 * i_tab;

  if (d >= R) {
    row[T_FSK + lane] = 0;
    row[T_A1 + lane] = 0;
    row[T_A2 + lane] = 0;
    row[T_VER + lane] = 0;
    row[T_PRED + lane] = 0;
    row[T_CEIL + lane] = CEIL_INF;
    if (lane < 4)
      row[T_SHIFT + lane] = T_SHIFT + lane == T_CEILB ? CEIL_INF : 0;
    for (int j = lane; j < 2 * i_tab; j += 32) irow[j] = 0;
    return;
  }

  const int32_t* vec = in;
  const int lo = __ldg(vec + (size_t)S_LO * R + d);
  const bool in_range = lo + lane < R;
  const int x = min(lo + lane, R - 1);
  const int pred = __ldg(vec + (size_t)S_PRED * R + x);
  const int inv = __ldg(vec + (size_t)S_INV * R + x);
  const int ret = __ldg(vec + (size_t)S_RET * R + x);
  const int f = __ldg(vec + (size_t)S_F * R + x);
  row[T_FSK + lane] = in_range && pred <= d ? f + 1 : 0;
  row[T_A1 + lane] = __ldg(vec + (size_t)S_A1 * R + x);
  row[T_A2 + lane] = __ldg(vec + (size_t)S_A2 * R + x);
  row[T_VER + lane] = __ldg(vec + (size_t)S_VER * R + x);
  row[T_CEIL + lane] =
      in_range ? __ldg(vec + (size_t)S_CEIL * R + x) : CEIL_INF;

  uint32_t word = 0u;
#pragma unroll 8
  for (int c = 0; c < W; ++c) {
    const int inv_c = __shfl_sync(FULL, inv, c);
    const unsigned b = __ballot_sync(FULL, in_range && ret < inv_c);
    if (lane == c) word = b;
  }
  row[T_PRED + lane] = (int32_t)word;
  const unsigned upd =
      __ballot_sync(FULL, in_range && (f == WRITE || f == CAS));
  if (lane < 3)
    row[T_SHIFT + lane] = __ldg(vec + (size_t)(S_SHIFT + lane) * R + d);
  else if (lane == 3)
    row[T_SHIFT + 3] = (int32_t)upd;

  if (i_tab == 0) return;
  const int32_t* i_inv = vec + (size_t)S_VECS * R;
  const int32_t* last = i_inv + I;
  const int hi = min(lo + W, R);
  for (int j0 = 0; j0 < i_tab; j0 += 32) {
    const int n = min(32, I - j0);         // the warp's members, maybe none
    uint32_t mine = 0u;
    for (int t = 0; t < n; ++t) {
      const unsigned b =
          __ballot_sync(FULL, in_range && ret < __ldg(i_inv + j0 + t));
      if (lane == t) mine = b;
    }
    const int j = j0 + lane;
    if (j < i_tab) {
      irow[j] = lane < n ? (int32_t)mine : 0;
      irow[i_tab + j] = lane < n ? (int32_t)(__ldg(last + j) < hi) : 0;
    }
  }
}

}  // namespace

// The rung kernel's rows [r_pad, 196] and, with i_tab > 0, info
// [r_pad, 2 * i_tab] (member pred words, then their static bits), int32,
// on `stream`, from `in` (the S_* vectors of R, then i_inv and last of
// I). Returns the launch's cudaError_t (0 = launched);
// cudaErrorInvalidValue for R < 1, r_pad < R, I < 0 or i_tab < I.
extern "C" int wgl_frames_launch(const void* in, int R, int I, int i_tab,
                                 int r_pad, void* rows, void* info,
                                 void* stream) {
  if (R < 1 || r_pad < R || I < 0 || i_tab < 0 || (i_tab > 0 && i_tab < I))
    return (int)cudaErrorInvalidValue;
  wgl_frames_kernel<<<(r_pad + WARPS - 1) / WARPS, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(in), R, I, i_tab, r_pad,
      static_cast<int32_t*>(rows), static_cast<int32_t*>(info));
  return (int)cudaGetLastError();
}

extern "C" const char* wgl_frames_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
