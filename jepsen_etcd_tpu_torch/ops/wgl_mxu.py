"""The wave search for the WGL frontier BFS: host packing, the device
frame builder, the plain PyTorch version of the wave kernel, and the
wrapper that launches the hand-written CUDA kernel (the port of the
reference's ``ops/wgl_mxu.py``).

One search keeps a frontier of at most F=32 states. A state is a
window bitmask over wk undecided ops (wk = 32, 64 or 128: nw = wk/32
uint32 words) plus the register's value id. Each wave expands every
state by every window op: F*wk candidates, checked for predecessor
containment, the version window and ceiling, the read/write/CAS model
and the window slide. Surviving candidates are partially deduped, get
dense ranks, and the first F by rank become the next frontier, deduped
exactly. Acceptance, overflow, peak frontier and wave counts fold into
one ``[accepted, overflowed, peak, waves]`` int32 vector per key.

Candidate order is the reference's plane layout: candidate (state s,
op o) sits at plane position (p, q) of an (nr, 128) plane, nr =
F*wk/128, with s = nr*(q//wk) + p and o = q % wk; ranks are an
exclusive prefix sum in row-major plane order (p*128 + q). Which
candidates survive an overflow, the frontier row order, and so
``peak-frontier`` and ``waves``, all follow from that order.

Soundness contract (the reference's): accepted=True is witnessed by a
surviving path; accepted=False is reported only when no wave
overflowed; anything else degrades to ``{"overflow": True}``.

A batch of keys (``launch_packed_batch_mxu``) is packed key-major,
padded to the lane geometry of ``_batch_geometry`` and split evenly over
the lanes of ``batch_lanes``: one kernel launch per lane, each on its
own device and stream, the counterpart of the reference's
``_call_batch_sharded`` over a ``("key",)`` device mesh.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from ..device import resolve_device
from ..runner import telemetry
from .wgl import CAS, NO_ASSERT, READ, WILDCARD, WRITE, Packed, bucket

F = 32            # frontier capacity (states)
#: keys per batched launch chunk: bounds the padded batch of a huge
#: group; a (r_pad, wk) group normally launches once per lane
BATCH_CHUNK = 1024
W_SUPPORTED = (32, 64, 128)
TSUB = 8          # smallest r_pad
DONE_EVERY = 8    # waves between frontier-death checks (plain version)
V_SENT = np.int16(-32768)   # "never matches" relative version
C_INF = np.int16(32767)     # "no ceiling" relative ceiling
VAL_MAX = 2 ** 16 - 3       # value-id budget (uint16 biased +1)

# table lane-segment layout (each segment is wk lanes):
# 0: a1|a2 pair, 1: ver|ceil pair, 2..2+NW-1: pred words, last: fsk
# scal columns (S_UPD0..S_UPD0+NW-1 hold the update-mask words)
S_SHIFT, S_CEILB, S_UPD0, S_UPD1, S_UPD2, S_UPD3, S_R = range(7)
SCAL_COLS = 8

U16_NOASSERT = 65535
U16_INF = 65534
U16_NEVER = 65533   # version assertion that can never match
# uint16 per-op col layout
C_A1, C_A2, C_VER, C_FSK1, C_PRED, C_CEIL, C_LO, C_SHIFT, C_CEILB, \
    C_UF, C_R, C_SPARE = range(12)

_M32 = 0xFFFFFFFF

#: launches of the CUDA wave kernel in this process (the wrapper adds
#: one per launch; a caller may reset it to 0 to count one run)
LAUNCHES = 0
_launch_lock = threading.Lock()
_launched_here = threading.local()


#: frame builds (``build_tables``) on the card in this process, counted
#: as LAUNCHES is
BUILDS = 0


def thread_launches() -> int:
    """Launches of the CUDA wave kernel made by the calling thread (the
    checker service's lane workers count their own jobs' launches)."""
    return getattr(_launched_here, "n", 0)


def _dims(wk: int):
    """Derived layout constants for a window width."""
    nw = wk // 32            # mask words
    nr = F * wk // 128       # plane rows (candidate slots = F*wk)
    np_ = F * wk             # packed candidate slots
    segk = 128 // wk         # states per plane row
    tlanes = wk * (3 + nw)
    tlanes = -(-tlanes // 128) * 128    # lane-tile align
    return nw, nr, np_, segk, tlanes


def supported(p: Packed) -> bool:
    """Preconditions: packed OK, one/two/four-word window, no info ops,
    value ids and history length within the uint16 shipping budget."""
    return (bool(p.ok) and p.w in W_SUPPORTED and p.I == 0 and p.R > 0
            and p.n_values < VAL_MAX and p.R < 65000
            and int(np.max(p.shift, initial=0)) < 65536)


def pack_tables(p: Packed, r_pad: int):
    """Host reference packer: a Packed's per-depth frames as the
    kernel's [r_pad, TLANES] int32 table + [r_pad, SCAL_COLS] int32
    scal, with the canonical relative encodings the device builder
    shares (a reachable relative version is 0..wk+1, so any assertion
    outside [-1, wk+1] maps to the never-matching -32767; ceilings
    clamp into [-1, wk+1])."""
    from .wgl import ensure_frames
    ensure_frames(p)
    R, wk = p.R, p.w
    nw, tlanes = _dims(wk)[0], _dims(wk)[4]
    uf = p.u_forced.astype(np.int64)                      # [R]
    tab = np.zeros((r_pad, tlanes), dtype=np.int32)

    def pair(lo_u16, hi_u16):
        return (lo_u16.astype(np.uint32)
                | (hi_u16.astype(np.uint32) << 16)).view(np.int32)

    def seg(j):
        return tab[:R, wk * j:wk * j + wk]

    a1u = np.where(p.a1 == WILDCARD, 0,
                   p.a1 + 1).astype(np.uint16)            # biased
    a2u = (p.a2 + 1).astype(np.uint16)
    seg(0)[...] = pair(a1u, a2u)
    rel = p.ver.astype(np.int64) - uf[:, None]
    rel = np.where((rel < -1) | (rel > wk + 1), -32767, rel)
    rel = np.where(p.ver == NO_ASSERT, V_SENT, rel).astype(np.int16)
    relc = np.clip(p.ceil_frame.astype(np.int64) - uf[:, None],
                   -1, wk + 1)
    relc = np.where(p.ceil_frame >= 2 ** 30, C_INF, relc).astype(np.int16)
    seg(1)[...] = pair(rel.view(np.uint16), relc.view(np.uint16))
    for wi in range(nw):
        seg(2 + wi)[...] = p.pred_frame[:, :, wi].view(np.int32)
    fsk = np.where(p.static_ok, p.f_code.astype(np.uint16) + 1,
                   0).astype(np.uint16)
    seg(2 + nw)[...] = pair(fsk, np.zeros_like(fsk))

    scal = np.zeros((r_pad, SCAL_COLS), dtype=np.int32)
    scal[:R, S_SHIFT] = p.shift
    cb = np.clip(p.ceil_beyond.astype(np.int64) - uf, -1, wk + 1)
    scal[:R, S_CEILB] = np.where(p.ceil_beyond >= 2 ** 30, 2 ** 30, cb)
    for wi in range(nw):
        scal[:R, S_UPD0 + wi] = p.upd_mask[:, wi].view(np.int32)
    scal[:, S_R] = R
    return tab, scal


def pack_perop(p: Packed, r_pad: int):
    """Compact per-op arrays for the device frame builder: int32
    [r_pad, 4] (invoke/return time ranks) + uint16 [r_pad, 12].
    Width-agnostic — the window geometry is carried by lo/shift."""
    R = p.R
    i32 = np.zeros((r_pad, 4), dtype=np.int32)
    i32[:R, 0] = p.inv_rank
    i32[:R, 1] = p.ret_rank
    u16 = np.zeros((r_pad, 12), dtype=np.uint16)
    u16[:R, C_A1] = np.where(p.op_a1 == WILDCARD, 0, p.op_a1 + 1)
    u16[:R, C_A2] = p.op_a2 + 1
    # version assertions outside [0, 65000) can never match a reachable
    # version; ship the NEVER marker so the builder emits the same
    # canonical -32767 as pack_tables
    u16[:R, C_VER] = np.where(
        p.op_ver == NO_ASSERT, U16_NOASSERT,
        np.where((p.op_ver < 0) | (p.op_ver >= 65000), U16_NEVER,
                 p.op_ver + 1))
    u16[:R, C_FSK1] = p.op_f.astype(np.uint16) + 1
    u16[:R, C_PRED] = np.clip(p.op_pred_rank, 0, 65533)
    # ceilings are >= -1 (version - 1 of a version-0 update): bias +1
    u16[:R, C_CEIL] = np.where(p.op_ceiling >= 2 ** 30, U16_INF,
                               np.clip(p.op_ceiling + 1, 0, U16_INF - 1))
    u16[:R, C_LO] = p.lo[:R]
    u16[:R, C_SHIFT] = np.clip(p.shift, 0, 65535)
    uf = p.u_forced.astype(np.int64)
    relb = np.where(p.ceil_beyond >= 2 ** 30, U16_INF - 1,
                    np.clip(p.ceil_beyond.astype(np.int64) - uf,
                            -1, p.w + 1) + 1)   # biased +1, -1 -> 0
    u16[:R, C_CEILB] = relb
    u16[:R, C_UF] = uf
    u16[:, C_R] = R
    return i32, u16


def pack_perop_batch(packs: list, r_pad: int, k_pad: int | None = None):
    """Vectorized ``pack_perop`` over a whole launch chunk: ONE numpy
    pass over the concatenated per-op columns fills the [k_pad, r_pad,
    4] int32 and [k_pad, r_pad, 12] uint16 batch tensors, bit-identical
    to the per-key loop. A single fancy-index row scatter lands every
    key at ``kid * r_pad + row``; padding keys beyond ``len(packs)``
    stay all-zero (R = 0) rows."""
    K = len(packs)
    kp = K if k_pad is None else k_pad
    i32 = np.zeros((kp, r_pad, 4), dtype=np.int32)
    u16 = np.zeros((kp, r_pad, 12), dtype=np.uint16)
    if K == 0:
        return i32, u16
    Rs = np.fromiter((p.R for p in packs), dtype=np.int64, count=K)
    # C_R rides every row (real and pad) of a real key
    u16[:K, :, C_R] = Rs[:, None].astype(np.uint16)
    N = int(Rs.sum())
    if N == 0:
        return i32, u16
    kid = np.repeat(np.arange(K), Rs)                  # [N] key per op
    offs = np.concatenate(([0], np.cumsum(Rs)[:-1]))
    row = np.arange(N, dtype=np.int64) - offs[kid]     # [N] in-key row

    live = [p for p in packs if p.R]

    def cat(get):
        return np.concatenate([np.asarray(get(p), dtype=np.int64)
                               for p in live])

    inv = cat(lambda p: p.inv_rank)
    ret = cat(lambda p: p.ret_rank)
    a1 = cat(lambda p: p.op_a1)
    a2 = cat(lambda p: p.op_a2)
    ver = cat(lambda p: p.op_ver)
    f = cat(lambda p: p.op_f)
    pred = cat(lambda p: p.op_pred_rank)
    ceil = cat(lambda p: p.op_ceiling)
    lo = cat(lambda p: p.lo[:p.R])
    shift = cat(lambda p: p.shift)
    uf = cat(lambda p: p.u_forced)
    ceilb = cat(lambda p: p.ceil_beyond)
    wv = np.repeat(np.fromiter((p.w for p in live), dtype=np.int64,
                               count=len(live)),
                   Rs[Rs > 0])                         # [N] window width

    i32f = np.zeros((N, 4), dtype=np.int32)
    i32f[:, 0] = inv
    i32f[:, 1] = ret
    u16f = np.zeros((N, 12), dtype=np.uint16)
    u16f[:, C_A1] = np.where(a1 == WILDCARD, 0, a1 + 1)
    u16f[:, C_A2] = a2 + 1
    u16f[:, C_VER] = np.where(
        ver == NO_ASSERT, U16_NOASSERT,
        np.where((ver < 0) | (ver >= 65000), U16_NEVER, ver + 1))
    u16f[:, C_FSK1] = f + 1
    u16f[:, C_PRED] = np.clip(pred, 0, 65533)
    u16f[:, C_CEIL] = np.where(ceil >= 2 ** 30, U16_INF,
                               np.clip(ceil + 1, 0, U16_INF - 1))
    u16f[:, C_LO] = lo
    u16f[:, C_SHIFT] = np.clip(shift, 0, 65535)
    u16f[:, C_CEILB] = np.where(ceilb >= 2 ** 30, U16_INF - 1,
                                np.clip(ceilb - uf, -1, wv + 1) + 1)
    u16f[:, C_UF] = uf
    u16f[:, C_R] = Rs[kid]
    i32[kid, row] = i32f
    u16[kid, row] = u16f
    return i32, u16


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit pattern -> int32 with the same bits."""
    x = x & _M32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def build_tables(i32: torch.Tensor, u16: torch.Tensor, r_pad: int,
                 wk: int):
    """Device-side frame builder: per-op arrays ``i32`` [K, r_pad, 4]
    and ``u16`` [K, r_pad, 12] (uint16 values in any integer dtype) ->
    (tab [K, r_pad, TLANES] int32, scal [K, r_pad, SCAL_COLS] int32),
    bit-identical to ``pack_tables`` per key. Runs on the inputs'
    device.

    Every per-op column is gathered at the same sliding-window index
    lo_k + o; the reference rides that gather on the MXU as a one-hot
    bf16 matmul, here it is a plain index gather."""
    global BUILDS
    nw, tlanes = _dims(wk)[0], _dims(wk)[4]
    dev = i32.device
    if dev.type == "cuda":
        with _launch_lock:
            BUILDS += 1
    u = u16.to(torch.int64)
    t = i32.to(torch.int64)
    K = u.shape[0]
    R = u[:, 0, C_R][:, None, None]                       # [K, 1, 1]
    kr = torch.arange(r_pad, device=dev)[None, :, None]   # [1, r_pad, 1]
    o = torch.arange(wk, device=dev)[None, None, :]       # [1, 1, wk]
    pos = u[:, :, C_LO:C_LO + 1] + o                      # [K, r_pad, wk]
    in_range = (pos < R) & (kr < R)
    idx = torch.minimum(pos.clamp(min=0), (R - 1).clamp(min=0))
    flat = idx.reshape(K, r_pad * wk)

    def gather(col: torch.Tensor) -> torch.Tensor:        # [K, r_pad]
        return torch.gather(col, 1, flat).reshape(K, r_pad, wk)

    def g(c: int) -> torch.Tensor:
        return gather(u[:, :, c])

    invg = gather(t[:, :, 0])
    retg = gather(t[:, :, 1])
    fsk1 = g(C_FSK1)
    fsk = torch.where(in_range & (g(C_PRED) <= kr), fsk1, 0)
    a1p = g(C_A1)
    a2p = g(C_A2)
    uf = u[:, :, C_UF:C_UF + 1]
    verabs = g(C_VER)
    raw = (verabs - 1) - uf
    relver = torch.where(
        verabs == U16_NOASSERT, -32768,
        torch.where((verabs == U16_NEVER) | (raw < -1) | (raw > wk + 1),
                    -32767, raw))
    ceilabs = g(C_CEIL)
    relceil = torch.where((ceilabs == U16_INF) | ~in_range, 32767,
                          ((ceilabs - 1) - uf).clamp(-1, wk + 1))
    # predecessor mask words: bit b of candidate o's word b//32 is set
    # when window op b returned before o was invoked
    isupd = (fsk1 >= 2) & in_range
    pms = [torch.zeros_like(retg) for _ in range(nw)]
    ums = [torch.zeros((K, r_pad), dtype=torch.int64, device=dev)
           for _ in range(nw)]
    for b in range(wk):
        bit = ((retg[:, :, b:b + 1] < invg)
               & in_range[:, :, b:b + 1]).to(torch.int64)
        pms[b // 32] |= bit << (b % 32)
        ums[b // 32] |= isupd[:, :, b].to(torch.int64) << (b % 32)

    def pair(lo16, hi16):
        return _to_i32((lo16 & 0xFFFF) | (hi16 << 16))

    parts = [pair(a1p, a2p), pair(relver, relceil)]
    parts += [_to_i32(pm) for pm in pms]
    parts += [pair(fsk, torch.zeros_like(fsk))]
    tab = torch.cat(parts, dim=2)
    if tab.shape[2] < tlanes:
        tab = torch.nn.functional.pad(tab, (0, tlanes - tab.shape[2]))
    tab = torch.where(kr < R, tab, 0).to(torch.int32)
    # ceil_beyond decode: U16_INF-1 = INF marker, else biased by +1
    inrow = kr[:, :, 0] < R[:, :, 0]                      # [K, r_pad]
    relb = torch.where(u[:, :, C_CEILB] == U16_INF - 1, 2 ** 30,
                       u[:, :, C_CEILB] - 1)
    zero = torch.zeros((K, r_pad), dtype=torch.int64, device=dev)
    cols = [torch.where(inrow, u[:, :, C_SHIFT], 0),
            torch.where(inrow, relb, 0)]
    for wi in range(4):
        # graftlint: ignore[TORCH001] four fixed columns, once per batch: the loop only spells out four ops
        cols.append(torch.where(inrow, ums[wi], 0) if wi < nw else zero)
    cols.append(R[:, :, 0].expand(K, r_pad))
    cols += [zero] * (SCAL_COLS - len(cols))
    scal = _to_i32(torch.stack(cols, dim=2))
    return tab, scal


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of int64 tensors holding 32-bit words."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def wave_search_reference(tab: torch.Tensor, scal: torch.Tensor,
                          wk: int) -> torch.Tensor:
    """The plain PyTorch version of the wave kernel: tab [K, r_pad,
    TLANES] int32, scal [K, r_pad, SCAL_COLS] int32 -> [K, 4] int32
    ``[accepted, overflowed, peak, waves]``.

    It follows the reference's ``_wave_body`` step by step on the same
    (nr, 128) planes, batched over keys: mask words ride in int64 with
    explicit 32-bit masking, ranks are a cumulative sum in row-major
    plane order, and compaction is a scatter by rank. A frontier-death
    check every DONE_EVERY waves ends the loop early, as the reference
    skips dead grid steps."""
    nw, nr, np_, segk, _ = _dims(wk)
    dev = tab.device
    K, r_pad, _ = tab.shape
    i64 = torch.int64
    lane = torch.arange(128, device=dev)[None, None, :]   # [1, 1, 128]
    srow = torch.arange(nr, device=dev)[None, :, None]    # [1, nr, 1]
    o = lane % wk                        # window op index per slot
    obit = o % 32                        # bit within its mask word
    o_word = o // 32                     # which mask word holds the bit
    # frontier row r lives at the plane slots of state r
    smap = (nr * (lane // wk) + srow).expand(1, nr, 128)[0]   # [nr, 128]

    init = ((srow == 0) & (lane < wk)).to(i64).expand(K, nr, 128)
    alive_p = init.clone()
    stw = [torch.zeros((K, nr, 128), dtype=i64, device=dev)
           for _ in range(nw)]
    stv = init.clone()
    acc_p = torch.zeros((K, nr, 128), dtype=torch.bool, device=dev)
    ovf_p = torch.zeros_like(acc_p)
    peak_p = init.clone()
    wav_p = torch.zeros((K, nr, 128), dtype=i64, device=dev)
    tab64 = tab.to(i64)
    scal64 = scal.to(i64)
    R = scal64[:, 0, S_R][:, None, None]
    earlier = torch.arange(F, device=dev)
    earlier = earlier[None, :] < earlier[:, None]         # [F, F] r' < r

    for kk in range(r_pad):
        if kk % DONE_EVERY == 0 and not bool(alive_p.any()):
            break
        row = tab64[:, kk, :]

        def seg(j):
            return row[:, wk * j:wk * j + wk].repeat(1, segk)[:, None, :]

        g_av = seg(0)
        g_vc = seg(1)
        a1 = g_av & 0xFFFF                   # biased value ids (0 = wildcard)
        a2 = (g_av >> 16) & 0xFFFF
        rver = ((g_vc & 0xFFFF) ^ 0x8000) - 0x8000   # sign-extended int16
        rceil = g_vc >> 16                   # arithmetic shift: signed
        pmask = [seg(2 + wi) & _M32 for wi in range(nw)]
        fsk = seg(2 + nw) & 0xFFFF
        shift = scal64[:, kk, S_SHIFT][:, None, None]
        ceilb = scal64[:, kk, S_CEILB][:, None, None]
        upds = [scal64[:, kk, S_UPD0 + wi][:, None, None] & _M32
                for wi in range(nw)]

        sw = stw
        sv = stv
        alive = alive_p != 0
        mybits = sw[0] >> obit
        for wi in range(1, nw):
            mybits = torch.where(o_word == wi, sw[wi] >> obit, mybits)
        not_set = (mybits & 1) == 0
        preds_in = (sw[0] & pmask[0]) == pmask[0]
        version = _popcount32(sw[0] & upds[0])
        for wi in range(1, nw):
            preds_in = preds_in & ((sw[wi] & pmask[wi]) == pmask[wi])
            version = version + _popcount32(sw[wi] & upds[wi])
        # per-state ceiling prune: a state dies when any not-yet-
        # linearized window op has rceil < version
        bad = not_set & (rceil < version)
        segbad = bad.reshape(K, nr, segk, wk).any(-1, keepdim=True) \
            .expand(K, nr, segk, wk).reshape(K, nr, 128)
        alive = alive & (version <= ceilb) & ~segbad

        is_read = fsk == (1 + READ)
        is_write = fsk == (1 + WRITE)
        is_cas = fsk == (1 + CAS)
        no_assert = rver == -32768
        ver_ok = no_assert | (is_read & (rver == version)) | \
            ((is_write | is_cas) & (rver == version + 1))
        read_ok = is_read & ((a1 == 0) | (a1 == sv))
        model_ok = read_ok | is_write | (is_cas & (a1 == sv))

        bitb = torch.ones_like(obit) << obit
        nwf = [sw[wi] | torch.where(o_word == wi, bitb, 0)
               for wi in range(nw)]
        # slide: the `shift` lowest bits of the window fall off and
        # must all be set; per-word low masks with clamped shifts
        sh = shift

        def low_mask(wi):
            k = (sh - 32 * wi).clamp(0, 32)
            ks = k.clamp(max=31)
            return torch.where(k >= 32, _M32, (1 << ks) - 1)

        slide_ok = (nwf[0] & low_mask(0)) == low_mask(0)
        for wi in range(1, nw):
            slide_ok = slide_ok & ((nwf[wi] & low_mask(wi)) == low_mask(wi))
        # shifted window: (w_hi..w_lo) >> sh, word-wise, with clamped
        # lane shifts (no lane shifts by >= 32)
        zero_p = torch.zeros_like(nwf[0])
        k_off = sh // 32
        r_off = sh % 32
        rsafe = r_off.clamp(max=31)
        carry_amt = (32 - r_off).clamp(1, 31)
        padded = list(nwf) + [zero_p] * (nw + 1)
        new_w = []
        for i in range(nw):
            lo_w = zero_p
            hi_w = zero_p
            for ko in range(nw + 1):
                lo_w = torch.where(k_off == ko, padded[i + ko], lo_w)
                hi_w = torch.where(k_off == ko, padded[i + ko + 1], hi_w)
            carry = torch.where(r_off == 0, 0, (hi_w << carry_amt) & _M32)
            new_w.append((lo_w >> rsafe) | carry)

        valid = (alive & (fsk > 0) & not_set & preds_in
                 & ver_ok & model_ok & slide_ok)
        new_v = torch.where(is_read, sv, torch.where(is_write, a1, a2))

        # partial candidate dedupe: a candidate dies when it equals a
        # (pre-dedupe) valid candidate d rows above in its lane, or
        # wk*gs lanes to its left in its row
        def same_as(shift_by, dim, guard):
            eq = torch.roll(valid, shift_by, dim) & guard
            eq = eq & (new_v == torch.roll(new_v, shift_by, dim))
            for wi in range(nw):
                eq = eq & (new_w[wi] == torch.roll(new_w[wi], shift_by, dim))
            return eq

        dup = torch.zeros_like(valid)
        for d in range(1, min(nr, 8)):
            dup = dup | same_as(d, 1, srow >= d)
        for gs in range(1, segk):
            dup = dup | same_as(wk * gs, 2, lane >= wk * gs)
        valid = valid & ~dup

        # dense ranks: exclusive prefix sum in row-major slot order
        vflat = valid.reshape(K, np_).to(i64)
        rank = (torch.cumsum(vflat, 1) - vflat).reshape(K, nr, 128)

        # flags before compaction: acceptance is witness-based;
        # overflow = any candidate ranked past capacity
        acc_p = acc_p | (valid & (kk + 1 == R))
        ovf_p = ovf_p | (valid & (rank >= F))
        peak_p = torch.maximum(peak_p, torch.where(valid, rank + 1, 0))
        wav_p = wav_p + alive_p

        # compaction: the candidate ranked r becomes frontier row r
        # (slot F collects everything else and is dropped)
        dest = torch.where(valid & (rank < F), rank, F).reshape(K, np_)

        def compact(x):
            buf = torch.zeros((K, F + 1), dtype=i64, device=dev)
            return buf.scatter_(1, dest, x.reshape(K, np_))[:, :F]

        filled = compact(valid.to(i64)) != 0
        keys = [compact(w) for w in new_w] + [compact(new_v & 0xFFFF)]
        # exact frontier dedupe: kill a row identical to a lower-ranked
        # filled row (killed rows stay as holes)
        eq = earlier[None] & filled[:, None, :]
        for kx in keys:
            eq = eq & (kx[:, :, None] == kx[:, None, :])
        filled = filled & ~eq.any(-1)

        alive_p = filled[:, smap].to(i64)
        stw = [torch.where(filled, kx, 0)[:, smap] for kx in keys[:nw]]
        stv = torch.where(filled, keys[nw], 0)[:, smap]

    def fold(x):
        return x.reshape(K, np_).to(i64).amax(1)

    return torch.stack([fold(acc_p), fold(ovf_p), fold(peak_p),
                        fold(wav_p)], dim=1).to(torch.int32)


def _check_wave_inputs(tab: torch.Tensor, scal: torch.Tensor, wk: int):
    if wk not in W_SUPPORTED:
        raise ValueError(f"window width {wk} not in {W_SUPPORTED}")
    tlanes = _dims(wk)[4]
    if tab.dtype != torch.int32 or scal.dtype != torch.int32:
        raise TypeError("tab and scal must be int32")
    if tab.dim() != 3 or tab.shape[2] != tlanes:
        raise ValueError(f"tab must be [K, r_pad, {tlanes}], got "
                         f"{tuple(tab.shape)}")
    if scal.shape != (tab.shape[0], tab.shape[1], SCAL_COLS):
        raise ValueError(f"scal must be [K, r_pad, {SCAL_COLS}], got "
                         f"{tuple(scal.shape)}")
    if tab.device != scal.device:
        raise ValueError("tab and scal must be on one device")
    if not (tab.is_contiguous() and scal.is_contiguous()):
        raise ValueError("tab and scal must be contiguous")


def wave_search(tab: torch.Tensor, scal: torch.Tensor,
                wk: int) -> torch.Tensor:
    """The wave search over K keys: [K, 4] int32 ``[accepted,
    overflowed, peak, waves]``. CUDA tensors go to the hand-written
    kernel (csrc/wgl_wave.cu, one block per key, one launch); CPU
    tensors to ``wave_search_reference``."""
    global LAUNCHES
    _check_wave_inputs(tab, scal, wk)
    if tab.device.type == "cpu":
        return wave_search_reference(tab, scal, wk)
    if tab.device.type != "cuda":
        raise ValueError(f"unsupported device {tab.device}")
    if tab.data_ptr() % 16 or scal.data_ptr() % 16:
        raise ValueError("tab and scal must be 16-byte aligned: the kernel "
                         "copies their rows with bulk copies")
    from . import _cuda
    out = torch.empty((tab.shape[0], 4), dtype=torch.int32,
                      device=tab.device)
    _cuda.wgl_wave(tab, scal, out, wk)
    with _launch_lock:
        LAUNCHES += 1
    _launched_here.n = thread_launches() + 1
    return out


def _decode(out: np.ndarray, p: Packed) -> dict:
    acc = bool(out[0])
    ovf = bool(out[1])
    peak = int(out[2])
    waves = int(out[3])
    if acc:
        res = {"valid?": True, "waves": waves, "peak-frontier": peak,
               "ops": p.R, "info-ops": 0, "engine": "mxu-wave"}
        if ovf:
            res["overflowed-en-route"] = True
        return res
    if ovf:
        return {"valid?": "unknown", "overflow": True,
                "reason": f"mxu frontier overflow (capacity {F})",
                "waves": waves, "peak-frontier": peak}
    return {"valid?": False, "waves": waves, "peak-frontier": peak,
            "ops": p.R, "info-ops": 0, "engine": "mxu-wave",
            "stuck-at-depth": waves}


def batch_lanes(device=None) -> list:
    """The lanes a batched launch splits its keys over, one launch per
    lane (the reference's ``("key",)`` mesh of ``_call_batch_sharded``).
    With ``device`` named, one lane on it; with none, every visible CUDA
    card (the reference takes ``jax.devices()``), raising without one.
    Tests and ``chip_smoke.py`` substitute this helper to run several
    lanes on one device."""
    if device is not None:
        return [resolve_device(device)]
    resolve_device(None)
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def _batch_geometry(K: int, n_lanes: int):
    """(k_pad, n_dev) for a K-key chunk over ``n_lanes`` lanes: on one
    lane, the next power of two; over several, pow2-bucketed keys PER
    LANE times the lanes used (never more lanes than keys). Padding
    keys are all-zero rows (R = 0) whose searches die at once; their
    results are dropped at decode."""
    n_dev = min(n_lanes, K)
    if n_dev > 1:
        per_dev = 1
        while per_dev * n_dev < K:
            per_dev *= 2
        return per_dev * n_dev, n_dev
    k_pad = 1
    while k_pad < K:
        k_pad *= 2
    return k_pad, 1


def _launch_lane(i32: np.ndarray, u16: np.ndarray, r_pad: int, wk: int,
                 dev: torch.device, stream=None) -> torch.Tensor:
    """One lane's share of a launch: its key-major per-op slabs to
    ``dev``, the frame build, and ONE wave-search launch, all on
    ``stream`` (the current stream when None), which the caller's
    current stream then waits on. Returns the [k, 4] int32 result on
    ``dev`` without waiting for it."""
    with torch.cuda.stream(stream) if stream is not None \
            else contextlib.nullcontext():
        i32_t = torch.from_numpy(np.ascontiguousarray(i32)).to(dev)
        u16_t = torch.from_numpy(u16.astype(np.int32)).to(dev)
        tab, scal = build_tables(i32_t, u16_t, r_pad, wk)
        out = wave_search(tab, scal, wk)
    if stream is not None:
        torch.cuda.current_stream(dev).wait_stream(stream)
    return out


def launch_packed_batch_mxu(packs: list, device=None) -> list:
    """Stage and launch the supported packs: per (R-bucket, window
    width, BATCH_CHUNK) chunk, the key-major batch splits evenly over
    the lanes of ``batch_lanes(device)`` and each lane runs one kernel
    launch on its own device and stream (no collectives: keys are
    independent). Returns (index_chunk, lane_outputs, pack_chunk) launch
    records for ``collect_packed_batch_mxu``; every launch goes out
    before any readback, so a whole batch pays one synchronization."""
    lanes = batch_lanes(device)
    streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
               for d in lanes]
    groups: dict = {}
    for i, p in enumerate(packs):
        if supported(p):
            groups.setdefault((max(bucket(p.R), TSUB), p.w), []).append(i)
    launched = []
    tel = telemetry.current()
    with tel.span("mxu.launch", keys=len(packs)) as sp:
        for (r_pad, wk), idxs in groups.items():
            for lo_i in range(0, len(idxs), BATCH_CHUNK):
                chunk = idxs[lo_i:lo_i + BATCH_CHUNK]
                chunk_packs = [packs[i] for i in chunk]
                k_pad, n_dev = _batch_geometry(len(chunk), len(lanes))
                i32s, u16s = pack_perop_batch(chunk_packs, r_pad, k_pad)
                per = k_pad // n_dev
                outs = [_launch_lane(i32s[d * per:(d + 1) * per],
                                     u16s[d * per:(d + 1) * per], r_pad,
                                     wk, lanes[d], streams[d])
                        for d in range(n_dev)]
                launched.append((chunk, outs, chunk_packs))
        sp.set(chunks=len(launched),
               supported=sum(len(v) for v in groups.values()))
    # one dispatch a (R-bucket, width, chunk), however many lanes it
    # spans: the reference's count
    tel.counter("mxu.dispatches", len(launched))
    return launched


def readback(launched: list) -> list:
    """Wait for every launch record's lanes and return (index_chunk,
    [k_pad, 4] numpy, pack_chunk) records, the lanes' outputs
    concatenated in key order. The copies wait on the calling thread's
    streams, which the lanes' streams feed (``_launch_lane``), never on
    the whole device: another thread may be capturing a CUDA graph."""
    return [(chunk, torch.cat([o.cpu() for o in outs]).numpy(),
             chunk_packs) for chunk, outs, chunk_packs in launched]


def collect_packed_batch_mxu(launched: list, results: list) -> None:
    """Read back launch records from ``launch_packed_batch_mxu`` and
    decode into ``results`` (indexed as the original pack list);
    padding keys' rows are dropped. One ``mxu.collect`` span: the
    host's wait for the kernel, as the reference's."""
    with telemetry.current().span("mxu.collect", chunks=len(launched)):
        for chunk, out, chunk_packs in readback(launched):
            for j, (i, p) in enumerate(zip(chunk, chunk_packs)):
                results[i] = _decode(out[j], p)


def check_packed_mxu(p: Packed, device=None) -> dict | None:
    """Run the wave search on one packed history; None when
    unsupported, an overflow-unknown when capacity was exceeded."""
    dev = resolve_device(device)
    if not supported(p):
        return None
    r_pad = max(bucket(p.R), TSUB)
    tel = telemetry.current()
    with tel.span("mxu.dispatch", ops=p.R, w=p.w) as sp:
        out = _launch_lane(*pack_perop_batch([p], r_pad), r_pad, p.w, dev)
        res = _decode(out.cpu().numpy()[0], p)
        sp.set(valid=res.get("valid?"),
               peak_frontier=res.get("peak-frontier"))
    tel.counter("mxu.dispatches")
    return res


def check_packed_batch_mxu(packs: list, device=None) -> list | None:
    """Check many packed histories with one launch per lane per
    (R-bucket, window-width) chunk, all launched before any readback.
    Returns per-pack results aligned with input order; packs the kernel
    can't take get None entries. Returns None outright when NO pack is
    supported. ``device`` names the one lane; None spreads the keys
    over every visible card (``batch_lanes``, which raises without
    one)."""
    batch_lanes(device)
    if not packs or not any(supported(p) for p in packs):
        return None
    results: list = [None] * len(packs)
    collect_packed_batch_mxu(launch_packed_batch_mxu(packs, device=device),
                             results)
    return results
