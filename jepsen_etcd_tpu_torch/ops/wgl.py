"""Linearizability search for versioned-register histories: the host
packer and the device dispatch (the port of the reference's
``ops/wgl.py``).

The key insight making the search device-shaped: in a history with
bounded concurrency, sort the must-linearize (:ok) ops by invocation;
then any reachable "linearized set" consists of a *forced prefix* plus
a bitmask over a sliding window of at most W undecided ops (W
auto-selects 32, 64, or 128 — one, two, or four uint32 words — per
history). ``pack_register_history`` builds the per-op vectors and the
window geometry (``Packed``); ``ensure_frames`` materializes the
per-depth [R, W] frame tables the host reference packer reads; the
wave search itself is ops/wgl_mxu.py.

This slice ports the host half and the wave-kernel dispatch. The
reference's capacity ladder (``_expand`` / ``_wgl_loop``), its spill
BFS and ``check_prefix``, the batched SoA packer and the wire format
are not ported yet: where the reference would climb the ladder,
``check_packed`` answers ``{"valid?": "unknown", "overflow": True}``
and the checker's DFS-first overflow ordering takes over.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np

from ..checkers.linearizable import history_entries
from .common import UnsupportedValue, ValueIds, as_version, \
    register_value_sets

W = 32          # single-word window width (fast path)
W_MAX = 128     # widest window the kernel packs (4 uint32 words)
NI_MAX = 4      # count words per state (bit budget for info class fields)
I_TABLE_MAX = 256  # member-table width cap ([R, I, NW] memory)

READ, WRITE, CAS = 0, 1, 2
NO_ASSERT = -(2 ** 30)  # distinct from any real (possibly corrupted) version
NONE_VAL = 0     # value id for "key unset"
WILDCARD = -1    # read asserted nothing

#: the verdict reason where the reference would climb its capacity
#: ladder, which this port does not have yet
LADDER_NOT_PORTED = "ladder/spill not yet ported"


def pack_bits(bits: np.ndarray, nw: int) -> np.ndarray:
    """Pack a trailing bool axis of width w = 32*nw into nw
    little-endian uint32 words (new trailing axis replaces it)."""
    w = bits.shape[-1]
    assert w <= 32 * nw
    if w < 32 * nw:
        padded = np.zeros(bits.shape[:-1] + (32 * nw,), dtype=bool)
        padded[..., :w] = bits
        bits = padded
    by = np.packbits(np.ascontiguousarray(bits), axis=-1,
                     bitorder="little")
    return by.view(np.uint32).reshape(bits.shape[:-1] + (nw,)) \
        if by.dtype.byteorder in "|=" and np.little_endian \
        else (by.astype(np.uint32).reshape(bits.shape[:-1] + (nw, 4))
              * (np.uint32(1) << (8 * np.arange(4, dtype=np.uint32)))
              ).sum(-1, dtype=np.uint32)


@dataclass
class Packed:
    """Host-packed tables for one key's history (field for field the
    reference's ``Packed``)."""

    ok: bool
    reason: str = ""
    blowup: bool = False  # structurally past kernel capacity
    R: int = 0
    I: int = 0
    n_values: int = 0
    w: int = W      # window width (32 / 64 / 128 = 1, 2, 4 words)
    # required frame tables ([R, W] unless noted; NW = w // 32
    # little-endian uint32 mask words on the trailing axis) — lazy,
    # materialized by ensure_frames
    shift: Any = None         # [R] int32
    static_ok: Any = None     # [R, W] bool
    f_code: Any = None        # [R, W] int8
    a1: Any = None            # [R, W] int32 (read: rval / write: wval / cas: old)
    a2: Any = None            # [R, W] int32 (cas: new)
    ver: Any = None           # [R, W] int32 (version assertion or NO_ASSERT)
    pred_frame: Any = None    # [R, W, NW] uint32
    upd_mask: Any = None      # [R, NW] uint32
    u_forced: Any = None      # [R] int32
    ceil_frame: Any = None    # [R, W] int32 (version ceiling / CEIL_INF)
    ceil_beyond: Any = None   # [R] int32 (min ceiling past the window)
    # info tables: crashed updates grouped into symmetry classes whose
    # fired-prefix counts pack into NI uint32 words
    C: int = 0                # number of info symmetry classes
    ni: int = 0               # count words per state
    c_f: Any = None           # [C] int8 (WRITE or CAS)
    c_a1: Any = None          # [C] int32 (write val / cas old)
    c_a2: Any = None          # [C] int32 (cas new)
    c_size: Any = None        # [C] int32 (members per class)
    c_off: Any = None         # [C] int32 (first member index, class-major)
    c_word: Any = None        # [C] int32 (count word index)
    c_shift: Any = None       # [C] int32 (bit offset within the word)
    c_mask: Any = None        # [C] uint32 (count field mask)
    i_static_ok: Any = None   # [R, I] bool, class-major member order
    ipred_frame: Any = None   # [R, I, NW] uint32, class-major member order
    # per-op vectors (the compact source the frames are gathered from;
    # the device frame builder ships these)
    op_a1: Any = None         # [R] int32 (raw, WILDCARD = -1)
    op_a2: Any = None         # [R] int32
    op_ver: Any = None        # [R] int32 (NO_ASSERT sentinel)
    op_f: Any = None          # [R] int8
    op_pred_rank: Any = None  # [R] int32 (# required preds by ret<inv)
    op_ceiling: Any = None    # [R] int32 (version ceiling, INF 2**30)
    inv_rank: Any = None      # [R] int32 (invoke-time rank)
    ret_rank: Any = None      # [R] int32 (return-time rank)
    lo: Any = None            # [R+1] int64 (window base per depth)
    _i_inv_rank: Any = None   # [I] int64 (info invokes on the rank scale)

    @classmethod
    def from_numpy(cls, fields: dict) -> "Packed":
        """A Packed from a dict of numpy arrays and scalars keyed by
        field name (e.g. another packer's ``vars(packed)``); unknown
        keys are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in fields.items() if k in names})


MUTEX_LOCKED = "locked"


def mutex_adapter(f: str, value):
    """Express mutex ops as CAS register ops: a mutex IS a two-value CAS
    register (acquire = cas(None->locked), release = cas(locked->None),
    no version assertions)."""
    if f == "acquire":
        return "cas", [None, (None, MUTEX_LOCKED)]
    if f == "release":
        return "cas", [None, (MUTEX_LOCKED, None)]
    return None


def pack_mutex_history(history) -> Packed:
    """Pack a mutex (acquire/release) history for the kernel."""
    return pack_register_history(history, adapter=mutex_adapter)


def pack_register_history(history, adapter=None) -> Packed:
    """Build the per-op vectors and window geometry for the kernel.
    Returns ok=False with a reason when the history needs the CPU path.
    ``adapter`` (optional) maps each entry's (f, value) into
    register-language (f, value)."""
    try:
        return _pack_register_history(history, adapter=adapter)
    except UnsupportedValue as e:
        # a value/version whose == semantics the dense id encoding can't
        # carry: sound fallback to the Python oracle
        return Packed(ok=False, reason=f"unsupported value: {e}")


def _pack_register_history(history, adapter) -> Packed:
    entries = history_entries(history)
    if adapter is not None:
        adapted = {}
        for e in entries:
            m = adapter(e.f, e.value)
            if m is None:
                return Packed(ok=False,
                              reason=f"op f={e.f!r} not supported by adapter")
            adapted[e.i] = m

        def fv(e):
            return adapted[e.i]
    else:
        def fv(e):
            return e.f, e.value
    req = sorted([e for e in entries if e.required], key=lambda e: e.invoke)
    R = len(req)
    if R == 0:
        # with no required ops every history linearizes trivially
        return Packed(ok=True, R=0)

    # value id mapping: 0 = None (unset); concrete values from 1, with
    # id-equality iff Python == (ops/common.ValueIds)
    vids = ValueIds()
    val_id = vids.id

    inv = np.array([e.invoke for e in req], dtype=np.int64)
    ret = np.array([e.ret for e in req], dtype=np.int64)
    f_l = [0] * R
    a1_l = [0] * R
    a2_l = [0] * R
    ver_l = [NO_ASSERT] * R
    for i, e in enumerate(req):
        ef, ev = fv(e)
        if ef == "read":
            rv, rval = ev if ev is not None else (None, None)
            if rv is not None:
                ver_l[i] = as_version(rv)
            # A None read value asserts nothing (VersionedRegister.step
            # treats nil op-value as unchecked REGARDLESS of version)
            a1_l[i] = WILDCARD if rval is None else val_id(rval)
        elif ef == "write":
            f_l[i] = WRITE
            wv, wval = ev
            if wv is not None:
                ver_l[i] = as_version(wv)
            a1_l[i] = val_id(wval)
        elif ef == "cas":
            f_l[i] = CAS
            cv, (old, new) = ev
            if cv is not None:
                ver_l[i] = as_version(cv)
            a1_l[i] = val_id(old)
            a2_l[i] = val_id(new)
        else:
            return Packed(ok=False, reason=f"op f={ef!r} not supported")
    f = np.array(f_l, dtype=np.int8)
    a1 = np.array(a1_l, dtype=np.int32)
    a2 = np.array(a2_l, dtype=np.int32)
    ver = np.array(ver_l, dtype=np.int32)

    # --- info (indefinite) ops: may linearize any time after their
    # required predecessors, or never. Reads are droppable; so are ops
    # whose invoke follows every required return.
    sorted_ret = np.sort(ret)
    infos = []
    for e in entries:
        if e.required or fv(e)[0] == "read":
            continue
        npred = int(np.searchsorted(sorted_ret, e.invoke, side="left"))
        if npred >= R:
            continue
        infos.append((e, npred))
    I = len(infos)
    i_f = np.zeros(I, dtype=np.int8)
    i_a1 = np.zeros(I, dtype=np.int32)
    i_a2 = np.zeros(I, dtype=np.int32)
    i_inv = np.zeros(I, dtype=np.int64)
    i_npred = np.zeros(I, dtype=np.int64)
    for j, (e, npred) in enumerate(infos):
        i_inv[j] = e.invoke
        i_npred[j] = npred
        ef, ev = fv(e)
        val = ev if ev is not None else (None, None)
        if val[0] is not None:
            # the kernel's info tables carry no version assertion
            return Packed(ok=False,
                          reason="info op with version assertion")
        if ef == "write":
            i_f[j] = WRITE
            i_a1[j] = val_id(val[1])
        elif ef == "cas" and isinstance(val[1], (list, tuple)) \
                and len(val[1]) == 2:
            i_f[j] = CAS
            old, new = val[1]
            i_a1[j] = val_id(old)
            i_a2[j] = val_id(new)
        else:
            return Packed(ok=False, reason=f"info op f={ef!r} not supported")

    # --- value-space reductions (ops/common.register_value_sets):
    # merge dead values (producible, never asserted) into one id, and
    # drop info cas ops whose old value has no producer.
    triples = list(zip(f.tolist(), a1.tolist(), a2.tolist())) + \
        list(zip(i_f.tolist(), i_a1.tolist(), i_a2.tolist()))
    asserted, producible = register_value_sets(triples)
    dead = producible - asserted - {NONE_VAL}
    if len(dead) > 1:
        dead_id = min(dead)
        for i in range(R):
            if f[i] == WRITE and a1[i] in dead:
                a1[i] = dead_id
            elif f[i] == CAS and a2[i] in dead:
                a2[i] = dead_id
        for j in range(I):
            if i_f[j] == WRITE and i_a1[j] in dead:
                i_a1[j] = dead_id
            elif i_f[j] == CAS and i_a2[j] in dead:
                i_a2[j] = dead_id
    keep = [j for j in range(I)
            if not (i_f[j] == CAS and i_a1[j] != NONE_VAL
                    and int(i_a1[j]) not in producible)]
    if len(keep) < I:
        i_f, i_a1, i_a2 = i_f[keep], i_a1[keep], i_a2[keep]
        i_inv, i_npred = i_inv[keep], i_npred[keep]
        I = len(keep)
    # symmetry classes: info ops with identical (f, a1, a2) are
    # interchangeable and fire in canonical (npred, invoke) order, so
    # the reachable info states are per-class prefix COUNTS packed into
    # fixed bit fields (never straddling a word)
    order = sorted(range(I), key=lambda j: ((int(i_f[j]), int(i_a1[j]),
                                             int(i_a2[j])),
                                            (int(i_npred[j]),
                                             int(i_inv[j]), j)))
    i_f, i_a1, i_a2 = i_f[order], i_a1[order], i_a2[order]
    i_inv, i_npred = i_inv[order], i_npred[order]
    class_runs: list = []  # (key, start, size)
    for j in range(I):
        key_j = (int(i_f[j]), int(i_a1[j]), int(i_a2[j]))
        if class_runs and class_runs[-1][0] == key_j:
            class_runs[-1][2] += 1
        else:
            class_runs.append([key_j, j, 1])
    C = len(class_runs)
    c_f = np.array([k[0] for k, _, _ in class_runs], dtype=np.int8)
    c_a1 = np.array([k[1] for k, _, _ in class_runs], dtype=np.int32)
    c_a2 = np.array([k[2] for k, _, _ in class_runs], dtype=np.int32)
    c_off = np.array([off for _, off, _ in class_runs], dtype=np.int32)
    c_size = np.array([sz for _, _, sz in class_runs], dtype=np.int32)
    c_word = np.zeros(C, dtype=np.int32)
    c_shift = np.zeros(C, dtype=np.int32)
    c_mask = np.zeros(C, dtype=np.uint32)
    word, used = 0, 0
    for ci in range(C):
        bits = max(1, int(c_size[ci]).bit_length())
        if used + bits > 32:
            word, used = word + 1, 0
        c_word[ci] = word
        c_shift[ci] = used
        c_mask[ci] = (1 << bits) - 1
        used += bits
    ni = (word + 1) if C else 0
    if ni > NI_MAX:
        return Packed(ok=False, blowup=True,
                      reason=f"{I} info updates in {C} classes need "
                             f"{ni} count words > {NI_MAX}")
    if I > I_TABLE_MAX:
        return Packed(ok=False, blowup=True,
                      reason=f"{I} info updates > member-table cap "
                             f"{I_TABLE_MAX}")

    pred = np.searchsorted(sorted_ret, inv, side="left")  # ret[j] < inv[i]
    cap = np.searchsorted(inv, ret, side="left") - 1      # inv[j] < ret[i], j != i

    # lo[d] = first rank that can still be absent from a depth-d prefix
    # = the insertion point of d in the running prefix max of cap
    lo = np.searchsorted(np.maximum.accumulate(cap), np.arange(R + 1),
                         side="left").astype(np.int64)
    # feasibility: the window must hold all set bits and all enabled
    # candidates
    width_bits = np.max(np.arange(R + 1) - lo)
    first_lo = lo[np.minimum(pred, R)]
    width_cand = np.max(np.arange(R) - first_lo) + 1
    width = max(width_bits, width_cand)
    if width > W_MAX:
        return Packed(ok=False,
                      reason=f"window {width} > {W_MAX} "
                             f"(concurrency too high for kernel)")
    w = next(c for c in (W, 64, W_MAX) if width <= c)

    is_upd = (f == WRITE) | (f == CAS)
    cum_upd = np.concatenate([[0], np.cumsum(is_upd)])
    u_forced = cum_upd[lo[:R]].astype(np.int32)

    # version ceilings: op e with a version assertion can only fire
    # while the register version is <= its ceiling (read: ver, update:
    # ver-1); version never decreases, so a state whose version exceeds
    # the min ceiling among unlinearized required ops is dead
    CEIL_INF = np.int32(2 ** 30)
    ceiling = np.where(ver == NO_ASSERT, CEIL_INF,
                       np.where(f == READ, ver, ver - 1)).astype(np.int32)
    suffix_min = np.full(R + 1, CEIL_INF, dtype=np.int32)
    suffix_min[:R] = np.minimum.accumulate(ceiling[::-1])[::-1]
    ceil_beyond = suffix_min[np.minimum(lo[:R] + w, R)]       # [R]

    # rank-compress the invoke/return times jointly: pairwise
    # comparisons are order-preserved, and ranks fit int32
    all_times = np.concatenate([inv, ret])
    order = np.argsort(all_times, kind="stable")
    ranks = np.empty(2 * R, dtype=np.int32)
    ranks[order] = np.arange(2 * R, dtype=np.int32)

    p = Packed(
        ok=True, R=R, I=I, n_values=len(vids.rev), w=w,
        shift=(lo[1:] - lo[:-1]).astype(np.int32),
        u_forced=u_forced, ceil_beyond=ceil_beyond,
        C=C, ni=ni, c_f=c_f, c_a1=c_a1, c_a2=c_a2, c_size=c_size,
        c_off=c_off, c_word=c_word, c_shift=c_shift, c_mask=c_mask,
        op_a1=a1, op_a2=a2, op_ver=ver, op_f=f,
        op_pred_rank=pred.astype(np.int32), op_ceiling=ceiling,
        inv_rank=ranks[:R], ret_rank=ranks[R:], lo=lo,
    )
    p._i_inv_rank = (np.searchsorted(
        np.sort(all_times), i_inv, side="left").astype(np.int64)
        if I else np.zeros(0, dtype=np.int64))
    return p


def ensure_frames(p: Packed) -> None:
    """Materialize the [R, W] / [R, W, W] / [R, I] frame tables on the
    Packed (idempotent). The host reference packer
    ``wgl_mxu.pack_tables`` reads them."""
    if p.static_ok is not None or not p.ok or p.R == 0:
        return
    R, w, I = p.R, p.w, p.I
    nw = w // 32
    lo = p.lo
    pred = p.op_pred_rank.astype(np.int64)
    inv = p.inv_rank.astype(np.int64)
    ret = p.ret_rank.astype(np.int64)
    f = p.op_f
    d_idx = np.arange(R)[:, None]                       # [R, 1]
    b_idx = np.arange(w)[None, :]                       # [1, W]
    idx = np.minimum(lo[:R][:, None] + b_idx, R - 1)    # [R, W] clamped
    in_range = (lo[:R][:, None] + b_idx) < R
    p.static_ok = in_range & (pred[idx] <= d_idx)

    # predecessor bits within the frame: bit c <-> rank lo[d]+c, packed
    # into nw little-endian uint32 words (trailing axis)
    ret_frame = ret[idx]                                      # [R, W]
    inv_cand = inv[idx]                                       # [R, W]
    is_pred = (ret_frame[:, None, :] < inv_cand[:, :, None])  # [R, W, W]
    in_range_c = in_range[:, None, :]                         # [R, 1, W]
    p.pred_frame = pack_bits(is_pred & in_range_c, nw)

    is_upd = (f == WRITE) | (f == CAS)
    p.upd_mask = pack_bits(is_upd[idx] & in_range, nw)

    CEIL_INF = np.int32(2 ** 30)
    p.ceil_frame = np.where(in_range, p.op_ceiling[idx], CEIL_INF)
    p.f_code = f[idx].astype(np.int8)
    p.a1 = p.op_a1[idx]
    p.a2 = p.op_a2[idx]
    p.ver = p.op_ver[idx]

    # info predecessor tables: info j enabled at depth d iff every
    # required op with ret < inv_j is linearized
    if I:
        i_inv = p._i_inv_rank
        pred_in_win = in_range[:, :, None] & \
            (ret_frame[:, :, None] < i_inv[None, None, :])    # [R, W, I]
        p.ipred_frame = pack_bits(
            np.swapaxes(pred_in_win, 1, 2), nw)               # [R, I, NW]
        pf = (ret[:, None] < i_inv[None, :])                  # [R, I]
        cum_pf = np.concatenate([np.zeros((1, I), dtype=np.int64),
                                 np.cumsum(pf, axis=0)])      # [R+1, I]
        hi = np.minimum(lo[:R] + w, R)                        # [R]
        p.i_static_ok = cum_pf[hi] == cum_pf[R][None, :]      # [R, I]
    else:
        p.ipred_frame = np.zeros((R, 0, nw), dtype=np.uint32)
        p.i_static_ok = np.zeros((R, 0), dtype=bool)


def bucket(n: int) -> int:
    """Pad R to a power-of-two bucket (at least 16)."""
    b = 16
    while b < n:
        b *= 2
    return b


def check_packed(p: Packed, device=None) -> dict:
    """Run the wave kernel on one packed history. Definitive answers
    only: a history the kernel cannot take (info ops, id budget) or
    whose frontier overflowed comes back ``{"valid?": "unknown",
    "overflow": True}``, where the reference would climb its capacity
    ladder — the caller's DFS-first overflow ordering takes it from
    there."""
    from . import wgl_mxu

    if not p.ok:
        return {"valid?": "unknown", "reason": p.reason,
                "blowup": p.blowup}
    if p.R == 0:
        return {"valid?": True, "waves": 0}
    out = wgl_mxu.check_packed_mxu(p, device=device)
    if out is None:
        out = {"valid?": "unknown", "overflow": True,
               "reason": "shape outside the wave kernel; "
                         + LADDER_NOT_PORTED}
    return out
