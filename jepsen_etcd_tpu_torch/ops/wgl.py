"""Linearizability search for versioned-register histories: the host
packer, the capacity ladder and the device dispatch (the port of the
reference's ``ops/wgl.py``).

The key insight making the search device-shaped: in a history with
bounded concurrency, sort the must-linearize (:ok) ops by invocation;
then any reachable "linearized set" consists of a *forced prefix* plus
a bitmask over a sliding window of at most W undecided ops (W
auto-selects 32, 64, or 128 — one, two, or four uint32 words — per
history). ``pack_register_history`` builds the per-op vectors and the
window geometry (``Packed``); ``ensure_frames`` materializes the
per-depth [R, W] frame tables.

Engines, in the order ``check_packed`` tries them: the wave kernel
(ops/wgl_mxu.py, frontier 32, no info ops); the capacity ladder
(``_expand`` / ``_wgl_loop`` as PyTorch ops on the device, rungs 32 ->
4096, each rung resuming the frozen frontier of the last); past the top
rung the host-driven spill BFS (``_spill_bfs``), which is complete.
``check_prefix`` is the ladder paused every few waves (the streaming
API).

Many keys (the keyed register check) pack in one columnar pass
(``pack_register_histories_batched``); the wave kernel takes every key
it can (``wgl_mxu.launch_packed_batch_mxu``) and ``check_packed_batch``
runs the rest on one batched ladder rung per key group (on the card it
runs the wave kernel first itself, as the checker service calls it),
placed on one device or split over lanes. ``serialize_packed`` is the
wire format the service receives packs in.

Frontier rows carry uint32 mask and count words in int64 tensors, so
their unsigned order survives; every shift masks back to 32 bits.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..checkers.linearizable import history_entries
from ..core.history import TYPE_NAMES, History
from ..device import lane_stream, resolve_device
from ..runner import telemetry
from .common import UnsupportedValue, ValueIds, as_version, \
    register_value_sets

W = 32          # single-word window width (fast path)
W_MAX = 128     # widest window the kernel packs (4 uint32 words)
NI_MAX = 4      # count words per state (bit budget for info class fields)
I_TABLE_MAX = 256  # member-table width cap ([R, I, NW] memory)
F_MAX = 512     # frontier capacity per wave (middle of the ladder)
F_MAX_BIG = 4096  # top of the ladder; past it the spill BFS takes over
#: frontier capacities the ladder climbs; a search settles at the
#: smallest rung that holds its peak frontier (copied from the reference)
LADDER = [32, 128, 256, F_MAX, 1024, 2048, F_MAX_BIG]
SENTINEL_D = 2 ** 31 - 1        # int32 max: "no state" depth
SENTINEL_W = 0xFFFFFFFF         # uint32 max: "no state" mask word
SENTINEL_V = 2 ** 31 - 1        # int32 max: "no state" value

READ, WRITE, CAS = 0, 1, 2
NO_ASSERT = -(2 ** 30)  # distinct from any real (possibly corrupted) version
NONE_VAL = 0     # value id for "key unset"
WILDCARD = -1    # read asserted nothing

# spill-mode limits (copied from the reference): chunk size per expand
# call, frontier cap (past it BFS cannot win; the DFS oracle takes the
# history), and total-state budget; histories with many info ops get a
# smaller budget so hopeless cases exit in seconds
SPILL_CHUNK = 4096
SPILL_FRONTIER_LIMIT = 400_000
SPILL_STATE_BUDGET = 3_000_000
SPILL_I_LIMIT = 24
SPILL_STATE_BUDGET_HIGH_I = 1_000_000
SPILL_WALL_BUDGET_S = 60.0  # hopeless-width searches must fail fast

#: rung runs (``_wgl_loop`` calls) on the card in this process; a caller
#: may reset it to 0 to count one run
RUNG_LAUNCHES = 0

#: waves between host reads of the ladder's loop condition. Waves past
#: the end are masked no-ops, so any value gives the same result.
SYNC_EVERY = 8
#: on the card, a rung with at least GRAPH_MIN_WAVES waves to go runs
#: them GRAPH_WAVES at a time from a captured CUDA graph: the eager loop
#: issues about 220 small operations a wave and waits on their launches
GRAPH_MIN_WAVES = 256
GRAPH_WAVES = 32
#: held while a CUDA graph is captured: captures never overlap, even
#: from the checker service's lane threads
_CAPTURE_LOCK = threading.Lock()
#: lanes run by the sharded batched rung in this process (one per lane
#: that had keys, per group; a caller may reset it to 0 to count a run)
SHARDED_LAUNCHES = 0
_sharded_lock = threading.Lock()

_M32 = 0xFFFFFFFF


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
    register-language (f, value).

    Adapter-less histories route through the columnar fast path of
    ``pack_register_histories_batched``, as in the reference;
    ``_pack_reference`` is the per-key packer it is held against (and
    the one adapters and the keys the fast path cannot express take)."""
    if adapter is not None:
        return _pack_reference(history, adapter=adapter)
    return pack_register_histories_batched({0: history})[0]


def _pack_reference(history, adapter=None) -> Packed:
    """The per-key reference packer with the UnsupportedValue guard: the
    delegation target for keys the batched fast path can't express."""
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


# ---------------------------------------------------------------------------
# batched SoA packing (the host side of the keyed check)


class _Delegate(Exception):
    """A key's history needs semantics the columnar fast path doesn't
    carry; re-pack it through the per-key reference packer."""


def _classify_info(pos, f, ev, ilists):
    """Classify one indefinite update (info completion or still-open
    invoke; value is the INVOCATION's, per history_entries) into the
    columnar info lists. Raises _Delegate whenever only the reference's
    handling applies — its ok=False rejections (version-asserting
    infos, unsupported fs, bad cas shapes) and its own exceptions on
    malformed values — so delegation reproduces them exactly."""
    if ev is None:
        va = payload = None
    elif (type(ev) is tuple or type(ev) is list) and len(ev) == 2:
        va, payload = ev
    else:
        raise _Delegate
    if va is not None:
        raise _Delegate           # "info op with version assertion"
    if f == "write":
        fc = WRITE
        if payload is None:
            t1 = x1 = 0
        elif type(payload) is int:
            t1, x1 = 2, payload
        else:
            raise _Delegate       # non-int payload: interning needs ==
        t2 = x2 = 0
    elif f == "cas":
        if not (isinstance(payload, (list, tuple)) and len(payload) == 2):
            raise _Delegate       # "info op f='cas' not supported"
        fc = CAS
        old, new = payload
        if old is None:
            t1 = x1 = 0
        elif type(old) is int:
            t1, x1 = 2, old
        else:
            raise _Delegate
        if new is None:
            t2 = x2 = 0
        elif type(new) is int:
            t2, x2 = 2, new
        else:
            raise _Delegate
    else:
        raise _Delegate           # "info op f=... not supported"
    ipos_l, if_l, i1t_l, i1v_l, i2t_l, i2v_l = ilists
    ipos_l.append(pos)
    if_l.append(fc)
    i1t_l.append(t1)
    i1v_l.append(x1)
    i2t_l.append(t2)
    i2v_l.append(x2)


def _rows_from_ops(ops):
    """Parallel (procs, types, fs, vals) row lists from dict ops — the
    dict front-end of _extract_key_columns. One pass of dict lookups,
    the same count the fused loop used to pay inline."""
    procs, types, fs, vals = [], [], [], []
    for op in ops:
        procs.append(op.get("process"))
        types.append(op.get("type"))
        fs.append(op.get("f"))
        vals.append(op.get("value"))
    return procs, types, fs, vals


def _rows_from_columns(cols):
    """Parallel row lists straight from SoA columns (core/history.py
    OpColumns) — zero per-op dict access: type/f decode through their
    intern tables, non-int processes decode from proc_table, and the
    values list is shared by reference (per-key sub-columns already
    hold unwrapped payloads, exactly what the dict subhistory path
    feeds the extraction loop)."""
    types = [TYPE_NAMES[c] for c in cols.type_code.tolist()]
    pt = cols.proc_table
    procs = [p if p >= 0 else pt[-1 - p] for p in cols.proc.tolist()]
    ft = cols.f_table
    fs = [ft[c] for c in cols.f_code.tolist()]
    return procs, types, fs, cols.values


class _KeyExtract:
    """Resumable form of the merged extraction pass over ONE key's raw
    ops: invoke/completion pairing (history_entries), required-op
    classification, and register-language field extraction fused into a
    single loop, feedable in row chunks (the streaming packer's
    per-chunk drain) or in one shot (:func:`_extract_key_columns`).

    The state carried between ``feed`` calls — open invocations (each
    held as ``(pos, f, value)`` so the completion may land in a later
    chunk), the running int-process row position, and the required-op
    count — is exactly the loop state of the one-shot pass, so chunked
    feeding is bit-identical to one pass over the concatenation.
    ``finish`` runs the history-end sweep (still-open ops become
    indefinite updates) and must be called exactly once."""

    __slots__ = ("lists", "ilists", "open_by", "pos", "n_req")

    def __init__(self, lists=None, ilists=None):
        self.lists = lists if lists is not None \
            else tuple([] for _ in range(8))
        self.ilists = ilists if ilists is not None \
            else tuple([] for _ in range(6))
        self.open_by: dict = {}
        self.pos = 0
        self.n_req = 0

    def feed(self, rows) -> None:
        """Consume one (procs, types, fs, vals) row-chunk. Raises
        _Delegate / TypeError / ValueError exactly where the one-shot
        pass would; the caller owns rollback of shared lists."""
        procs, types, fs, vals = rows
        inv_l, ret_l, f_l, ver_l, v1t_l, v1v_l, v2t_l, v2v_l = self.lists
        ilists = self.ilists
        open_by = self.open_by
        pos = self.pos
        n_req = self.n_req
        lo_ver, hi_ver = -(2 ** 29), 2 ** 29
        try:
            for i, proc in enumerate(procs):
                if not isinstance(proc, int):
                    continue
                pos += 1
                t = types[i]
                if t == "invoke":
                    open_by[proc] = (pos, fs[i], vals[i])
                    continue
                got = open_by.pop(proc, None)
                if got is None or t == "fail":
                    continue
                if t == "ok":
                    f = got[1]
                    ev = vals[i]
                    # 2-unpacks mirror the reference exactly (it
                    # unpacks any 2-iterable); failures surface as
                    # TypeError/ValueError, which the caller converts
                    # to delegation — and the reference then re-raises
                    # the identical error
                    if f == "read":
                        fc = READ
                        if ev is None:
                            rv = rval = None
                        else:
                            rv, rval = ev
                        if rval is None:
                            t1, x1 = 0, 0  # wildcard: asserts nothing
                        elif type(rval) is int:
                            t1, x1 = 2, rval
                        else:
                            raise _Delegate
                        t2 = x2 = 0
                    elif f == "write":
                        fc = WRITE
                        rv, wval = ev
                        if wval is None:
                            t1, x1 = 1, 0
                        elif type(wval) is int:
                            t1, x1 = 2, wval
                        else:
                            raise _Delegate
                        t2 = x2 = 0
                    elif f == "cas":
                        fc = CAS
                        rv, (old, new) = ev
                        if old is None:
                            t1, x1 = 1, 0
                        elif type(old) is int:
                            t1, x1 = 2, old
                        else:
                            raise _Delegate
                        if new is None:
                            t2, x2 = 1, 0
                        elif type(new) is int:
                            t2, x2 = 2, new
                        else:
                            raise _Delegate
                    else:
                        raise _Delegate  # unsupported f: per-key msg
                    if rv is None:
                        ver = NO_ASSERT
                    elif type(rv) is int and lo_ver < rv < hi_ver:
                        ver = rv
                    else:
                        raise _Delegate  # as_version semantics / range
                    inv_l.append(got[0])
                    ret_l.append(pos)
                    f_l.append(fc)
                    ver_l.append(ver)
                    v1t_l.append(t1)
                    v1v_l.append(x1)
                    v2t_l.append(t2)
                    v2v_l.append(x2)
                    n_req += 1
                elif t == "info":
                    f = got[1]
                    if f != "read":    # indefinite update
                        _classify_info(got[0], f, got[2], ilists)
                    # info reads are dropped up front (assert nothing)
                else:
                    open_by[proc] = got  # ad-hoc type: leave op open
        finally:
            self.pos = pos
            self.n_req = n_req

    def finish(self) -> int:
        """History end: ops still open are indefinite, like :info
        completions. Returns the key's required-op count."""
        for ppos, f, val in self.open_by.values():
            if f != "read":
                _classify_info(ppos, f, val, self.ilists)
        return self.n_req


def _extract_key_columns(rows, lists, ilists):
    """ONE merged pass over a key's raw ops — the one-shot form of
    :class:`_KeyExtract`. ``rows`` is the (procs, types, fs, vals)
    parallel-list form of the ops — built by _rows_from_ops (dict
    histories) or _rows_from_columns (SoA-backed histories, no dict
    round-trip).
    Appends required-op columns to the shared flat ``lists`` (and
    indefinite updates to ``ilists``); returns the number of required
    ops appended. Raises _Delegate on anything the vectorized phase
    can't express bit-identically: non-int payload values (interning
    needs Python == semantics), non-int or out-of-range version
    assertions, unsupported fs, and malformed value shapes."""
    st = _KeyExtract(lists, ilists)
    st.feed(rows)
    return st.finish()


def _intern_values_batched(key_of, ridx, v1t, v1v, v2t, v2v,
                           ikey, i1t, i1v, i2t, i2v, n_keys):
    """Vectorized per-key value-id interning with ValueIds' exact
    semantics restricted to int payloads: id 0 is None, concrete values
    get dense ids in FIRST-APPEARANCE order of the per-key interning
    stream — required ops by invoke, then indefinite updates in entry
    order, a1 before a2 within an op. Returns (a1, a2, ia1, ia2,
    n_values) with WILDCARD = -1 reads preserved."""
    N = len(key_of)
    m1 = v1t == 2
    m2 = v2t == 2
    j1 = i1t == 2
    j2 = i2t == 2
    n1 = int(np.count_nonzero(m1))
    n2 = int(np.count_nonzero(m2))
    n3 = int(np.count_nonzero(j1))
    iidx = np.arange(len(ikey), dtype=np.int64)
    ibase = np.int64(2 * N)       # infos intern after every required op
    s_key = np.concatenate([key_of[m1], key_of[m2], ikey[j1], ikey[j2]])
    s_val = np.concatenate([v1v[m1], v2v[m2], i1v[j1], i2v[j2]])
    s_seq = np.concatenate([2 * ridx[m1], 2 * ridx[m2] + 1,
                            ibase + 2 * iidx[j1],
                            ibase + 2 * iidx[j2] + 1])
    ids = np.empty(len(s_key), dtype=np.int64)
    if len(s_key):
        order = np.lexsort((s_seq, s_val, s_key))
        sk, sv = s_key[order], s_val[order]
        newg = np.ones(len(sk), dtype=bool)
        newg[1:] = (sk[1:] != sk[:-1]) | (sv[1:] != sv[:-1])
        heads = np.flatnonzero(newg)
        hk, hs = sk[heads], s_seq[order][heads]
        horder = np.lexsort((hs, hk))          # first-appearance order
        hk_s = hk[horder]
        firstk = np.ones(len(heads), dtype=bool)
        firstk[1:] = hk_s[1:] != hk_s[:-1]
        hpos = np.arange(len(heads), dtype=np.int64)
        kstart = np.maximum.accumulate(np.where(firstk, hpos, 0))
        gid = np.empty(len(heads), dtype=np.int64)
        gid[horder] = hpos - kstart + 1
        ids[order] = gid[np.cumsum(newg) - 1]
        n_values = np.bincount(hk, minlength=n_keys) + 1
    else:
        n_values = np.ones(n_keys, dtype=np.int64)
    a1 = np.where(v1t == 0, np.int64(WILDCARD), np.int64(0))
    a1[m1] = ids[:n1]
    a2 = np.zeros(len(v2t), dtype=np.int64)
    a2[m2] = ids[n1:n1 + n2]
    ia1 = np.zeros(len(ikey), dtype=np.int64)
    ia1[j1] = ids[n1 + n2:n1 + n2 + n3]
    ia2 = np.zeros(len(ikey), dtype=np.int64)
    ia2[j2] = ids[n1 + n2 + n3:]
    return a1, a2, ia1, ia2, n_values


def _merge_dead_values_batched(key_of, fcode, a1, a2, n_values):
    """Vectorized dead-value merge (register_value_sets semantics over
    required AND indefinite ops): per key, producible-but-never-
    asserted ids collapse to the smallest such id when there is more
    than one. Mutates a1/a2 in place; returns (vbase, prod_mask) — the
    per-key id-space offsets and the PRE-merge producible mask the
    reference uses for its never-fires info-cas drop."""
    n_keys = len(n_values)
    vbase = np.zeros(n_keys, dtype=np.int64)
    np.cumsum(n_values[:-1], out=vbase[1:])
    V = int(vbase[-1] + n_values[-1]) if n_keys else 0
    isread = fcode == READ
    iswrite = fcode == WRITE
    iscas = fcode == CAS
    kb = vbase[key_of]
    ga1 = a1 + kb
    ga2 = a2 + kb
    assert_mask = np.zeros(V, dtype=bool)
    assert_mask[ga1[(isread & (a1 != WILDCARD)) | iscas]] = True
    prod_mask = np.zeros(V, dtype=bool)
    prod_mask[ga1[iswrite]] = True
    prod_mask[ga2[iscas]] = True
    dead = prod_mask & ~assert_mask
    dead[vbase] = False                       # id 0 (None) never merges
    vkey = np.repeat(np.arange(n_keys), n_values)
    dead_counts = np.bincount(vkey[dead], minlength=n_keys)
    if not np.any(dead_counts > 1):
        return vbase, prod_mask
    didx = np.flatnonzero(dead)
    dk = vkey[didx]
    firstd = np.ones(len(didx), dtype=bool)
    firstd[1:] = dk[1:] != dk[:-1]
    dead_min = np.zeros(n_keys, dtype=np.int64)
    dead_min[dk[firstd]] = didx[firstd] - vbase[dk[firstd]]
    rem = (dead_counts > 1)[key_of]
    hit1 = rem & iswrite & dead[np.where(iswrite, ga1, 0)]
    a1[hit1] = dead_min[key_of[hit1]]
    hit2 = rem & iscas & dead[ga2]
    a2[hit2] = dead_min[key_of[hit2]]
    return vbase, prod_mask


def pack_register_histories_batched(subhistories: dict,
                                    adapter=None) -> dict:
    """Batched structure-of-arrays form of ``pack_register_history``
    over a keyed dict of subhistories — the host side of the key-DP
    axis. One merged Python pass per op does pairing + classification +
    field extraction; everything downstream (value-id interning, dead-
    value merge, predecessor/window geometry, version ceilings, time
    rank compression) runs as single numpy calls vectorized ACROSS all
    keys, using per-key segment offsets so every per-key searchsorted /
    prefix-scan becomes one global operation on globally-sorted data.

    Per-key results are bit-identical to ``pack_register_history``
    (differentially tested in tests/test_wgl_batch_pack.py), including
    indefinite updates (info/crashed writes and cas, their symmetry
    classes and count-word layout). Keys the columnar path can't
    express (adapters, non-int payload values, non-int/out-of-range
    version assertions, malformed shapes, version-asserting infos)
    silently delegate to the per-key packer, so only the constant
    factor ever changes. Returns ``{key: Packed}``."""
    out: dict = {}
    fast_keys: list = []
    seg_R_l: list = []
    seg_I_l: list = []
    lists = tuple([] for _ in range(8))
    ilists = tuple([] for _ in range(6))
    alllists = lists + ilists
    (inv_l, ret_l, f_l, ver_l, v1t_l, v1v_l, v2t_l, v2v_l) = lists
    (ipos_l, if_l, i1t_l, i1v_l, i2t_l, i2v_l) = ilists
    for key, h in subhistories.items():
        if adapter is not None:
            out[key] = _pack_reference(h, adapter=adapter)
            continue
        # column-backed per-key histories (Independent's split of a
        # recorded run) extract straight from the SoA arrays — the
        # dict op stream is never materialized on this path
        cols = getattr(h, "columns", None) if isinstance(h, History) \
            else None
        if cols is not None:
            rows = _rows_from_columns(cols)
        else:
            # graftlint: ignore[COL001] explicit non-columnar delegation: raw op lists land here
            rows = _rows_from_ops(h.ops if isinstance(h, History) else h)
        marks = [len(c) for c in alllists]
        imark = len(ipos_l)
        try:
            n_req = _extract_key_columns(rows, lists, ilists)
        except (_Delegate, TypeError, ValueError):
            # TypeError/ValueError: a value didn't 2-unpack the way the
            # op's ``f`` demands — the reference raises the identical
            # error (or returns its Packed) for the same history
            for c, m in zip(alllists, marks):
                del c[m:]
            out[key] = _pack_reference(h)
            continue
        if n_req == 0:
            # with no required ops every history linearizes trivially,
            # before any indefinite op is even considered
            for c, m in zip(alllists, marks):
                del c[m:]
            out[key] = Packed(ok=True, R=0)
            continue
        fast_keys.append(key)
        seg_R_l.append(n_req)
        seg_I_l.append(len(ipos_l) - imark)
    if not fast_keys:
        return out
    return _pack_batched_tail(fast_keys, seg_R_l, seg_I_l,
                              lists, ilists, out)


def _pack_batched_tail(fast_keys, seg_R_l, seg_I_l, lists, ilists,
                       out: dict) -> dict:
    """The vectorized phase of :func:`pack_register_histories_batched`:
    given the flat per-key-contiguous extraction lists (keys in the
    order of ``fast_keys``, required ops sorted by invoke within each
    key's segment), run interning, dead-value merge, window geometry,
    ceilings, rank compression and per-key Packed assembly (shared with
    the streaming packer :class:`PackStream`)."""
    (inv_l, ret_l, f_l, ver_l, v1t_l, v1v_l, v2t_l, v2v_l) = lists
    (ipos_l, if_l, i1t_l, i1v_l, i2t_l, i2v_l) = ilists

    Kf = len(fast_keys)
    seg_R = np.array(seg_R_l, dtype=np.int64)
    starts = np.zeros(Kf, dtype=np.int64)
    np.cumsum(seg_R[:-1], out=starts[1:])
    N = int(starts[-1] + seg_R[-1])
    key_of = np.repeat(np.arange(Kf), seg_R)
    ridx = np.arange(N, dtype=np.int64)
    i_within = ridx - starts[key_of]

    inv64 = np.array(inv_l, dtype=np.int64)
    ret64 = np.array(ret_l, dtype=np.int64)
    fcode = np.array(f_l, dtype=np.int8)
    ver = np.array(ver_l, dtype=np.int32)
    v1t = np.array(v1t_l, dtype=np.int8)
    v1v = np.array(v1v_l, dtype=np.int64)
    v2t = np.array(v2t_l, dtype=np.int8)
    v2v = np.array(v2v_l, dtype=np.int64)

    # required ops sort by invoke within each key (stable; invokes are
    # distinct per key, so this matches the per-key sorted())
    perm = np.lexsort((inv64, key_of))
    inv64, ret64 = inv64[perm], ret64[perm]
    fcode, ver = fcode[perm], ver[perm]
    v1t, v1v, v2t, v2v = v1t[perm], v1v[perm], v2t[perm], v2v[perm]

    # per-key searchsorted via segment time offsets: key k's times move
    # to a disjoint band k * T_OFF, so ONE global searchsorted against
    # the concatenation of per-key-sorted arrays answers all keys
    T_OFF = np.int64(2) ** 32
    tbase = key_of * T_OFF
    ginv = inv64 + tbase                     # sorted (invoke order)
    gret_sorted = np.sort(ret64 + tbase)
    pred = np.searchsorted(gret_sorted, ginv, side="left") - starts[key_of]
    cap = np.searchsorted(ginv, ret64 + tbase, side="left") \
        - starts[key_of] - 1

    # indefinite updates: npred = count of required rets before the
    # invoke; ops that could only linearize after depth R are dropped
    # BEFORE interning (the reference never interns their values)
    seg_I = np.array(seg_I_l, dtype=np.int64)
    ikey = np.repeat(np.arange(Kf), seg_I)
    ipos = np.array(ipos_l, dtype=np.int64)
    if8 = np.array(if_l, dtype=np.int8)
    i1t = np.array(i1t_l, dtype=np.int8)
    i1v = np.array(i1v_l, dtype=np.int64)
    i2t = np.array(i2t_l, dtype=np.int8)
    i2v = np.array(i2v_l, dtype=np.int64)
    npred = np.searchsorted(gret_sorted, ipos + ikey * T_OFF,
                            side="left") - starts[ikey]
    keep = npred < seg_R[ikey]
    if not np.all(keep):
        ikey, ipos, npred = ikey[keep], ipos[keep], npred[keep]
        if8, i1t, i1v = if8[keep], i1t[keep], i1v[keep]
        i2t, i2v = i2t[keep], i2v[keep]

    a1, a2, ia1, ia2, n_values = _intern_values_batched(
        key_of, ridx, v1t, v1v, v2t, v2v, ikey, i1t, i1v, i2t, i2v, Kf)
    # dead-value merge over required + indefinite triples jointly, then
    # the reference's never-fires drop: an info cas whose old value has
    # no producer (pre-merge producible set) can never linearize
    gkeys = np.concatenate([key_of, ikey])
    gfc = np.concatenate([fcode, if8])
    ga1 = np.concatenate([a1, ia1])
    ga2 = np.concatenate([a2, ia2])
    vbase, producible = _merge_dead_values_batched(
        gkeys, gfc, ga1, ga2, n_values)
    a1, ia1 = ga1[:N], ga1[N:]
    a2, ia2 = ga2[:N], ga2[N:]
    keep = ~((if8 == CAS) & (ia1 != NONE_VAL)
             & ~producible[vbase[ikey] + ia1])
    if not np.all(keep):
        ikey, ipos, npred = ikey[keep], ipos[keep], npred[keep]
        if8, ia1, ia2 = if8[keep], ia1[keep], ia2[keep]
    seg_I = np.bincount(ikey, minlength=Kf).astype(np.int64)

    # lo[d] per depth d in 0..R_k: insertion of d into the running
    # prefix max of cap — the ragged [R_k + 1] query axis flattens to
    # one M-array with per-key offsets (qstart_k = starts_k + k)
    gpm = np.maximum.accumulate(cap + tbase)
    M = N + Kf
    qstarts = starts + np.arange(Kf)
    qkey = np.repeat(np.arange(Kf), seg_R + 1)
    qd = np.arange(M, dtype=np.int64) - qstarts[qkey]
    glo = (np.searchsorted(gpm, qd + qkey * T_OFF, side="left")
           - starts[qkey]).astype(np.int64)

    # window feasibility / width selection (per-key maxima via reduceat)
    width_bits = np.maximum.reduceat(qd - glo, qstarts)
    lo_R = glo[ridx + key_of]                # lo[:R] rows, N-aligned
    first_lo = glo[qstarts[key_of] + np.minimum(pred, seg_R[key_of])]
    width_cand = np.maximum.reduceat(i_within - first_lo, starts) + 1
    width = np.maximum(width_bits, width_cand)
    w_key = np.where(width <= W, W, np.where(width <= 64, 64, W_MAX))

    # forced update counts: per-key exclusive prefix sums of update ops
    is_upd = (fcode == WRITE) | (fcode == CAS)
    pcs = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(is_upd, out=pcs[1:])
    u_forced = (pcs[starts[key_of] + lo_R]
                - pcs[starts[key_of]]).astype(np.int32)

    # version ceilings + per-key suffix min (offset-banded accumulate)
    CEIL_INF = np.int32(2 ** 30)
    ceiling = np.where(ver == NO_ASSERT, CEIL_INF,
                       np.where(fcode == READ, ver, ver - 1)) \
        .astype(np.int32)
    gsuf = np.minimum.accumulate(
        (ceiling.astype(np.int64) + tbase)[::-1])[::-1] - tbase
    tgt = lo_R + w_key[key_of]
    ceil_beyond = np.where(
        tgt >= seg_R[key_of], np.int64(CEIL_INF),
        gsuf[np.clip(starts[key_of] + tgt, 0, N - 1)]).astype(np.int32)

    # joint rank compression of invoke/return times per key: one stable
    # global lexsort, ranks rebased to each key's 2R block
    t_all = np.concatenate([inv64, ret64])
    tk = np.concatenate([key_of, key_of])
    tpos = np.concatenate([i_within, i_within + seg_R[key_of]])
    sorder = np.lexsort((tpos, t_all, tk))
    ranks_flat = np.empty(2 * N, dtype=np.int64)
    ranks_flat[sorder] = np.arange(2 * N, dtype=np.int64) \
        - 2 * starts[tk[sorder]]
    inv_rank = ranks_flat[:N].astype(np.int32)
    ret_rank = ranks_flat[N:].astype(np.int32)

    shift = (glo[ridx + key_of + 1] - glo[ridx + key_of]) \
        .astype(np.int32)
    a1_32 = a1.astype(np.int32)
    a2_32 = a2.astype(np.int32)
    pred_32 = pred.astype(np.int32)

    # info symmetry classes: per key, sort members by ((f, a1, a2),
    # (npred, invoke)) — stable, so ties keep entry order like the
    # reference's explicit j tiebreak — and take run boundaries as
    # class heads. _i_inv_rank ranks each member's invoke among the
    # key's 2R required times, in this class-sorted member order.
    istarts = np.zeros(Kf, dtype=np.int64)
    np.cumsum(seg_I[:-1], out=istarts[1:])
    NI_tot = len(ikey)
    if NI_tot:
        corder = np.lexsort((ipos, npred, ia2, ia1, if8, ikey))
        sk, sf = ikey[corder], if8[corder]
        sa1, sa2 = ia1[corder], ia2[corder]
        sip = ipos[corder]
        newc = np.ones(NI_tot, dtype=bool)
        newc[1:] = (sk[1:] != sk[:-1]) | (sf[1:] != sf[:-1]) \
            | (sa1[1:] != sa1[:-1]) | (sa2[1:] != sa2[:-1])
        rstarts = np.flatnonzero(newc)
        rsizes = np.diff(np.append(rstarts, NI_tot))
        ckey = sk[rstarts]
        c_f_all = sf[rstarts]
        c_a1_all = sa1[rstarts].astype(np.int32)
        c_a2_all = sa2[rstarts].astype(np.int32)
        c_off_all = (rstarts - istarts[ckey]).astype(np.int32)
        c_size_all = rsizes.astype(np.int32)
        cstarts = np.searchsorted(ckey, np.arange(Kf), side="left")
        cends = np.searchsorted(ckey, np.arange(Kf), side="right")
        g_all_sorted = t_all[sorder] + tk[sorder] * T_OFF
        i_inv_rank_all = (np.searchsorted(g_all_sorted,
                                          sip + sk * T_OFF, side="left")
                          - 2 * starts[sk]).astype(np.int64)

    empty8 = np.zeros(0, dtype=np.int8)
    empty32 = np.zeros(0, dtype=np.int32)
    emptyu32 = np.zeros(0, dtype=np.uint32)
    empty64 = np.zeros(0, dtype=np.int64)
    for j, key in enumerate(fast_keys):
        R = int(seg_R[j])
        I = int(seg_I[j])
        if I:
            cs, ce = int(cstarts[j]), int(cends[j])
            C = ce - cs
            c_size = c_size_all[cs:ce]
            # bit layout: each class's count field is
            # ceil(log2(size+1)) bits, placed in the first word with
            # room (fields never cross words) — the C-length greedy
            # scan is the reference's, verbatim (C is tiny)
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
            ni = word + 1
            if ni > NI_MAX:
                out[key] = Packed(
                    ok=False, blowup=True,
                    reason=f"{I} info updates in {C} classes need "
                           f"{ni} count words > {NI_MAX}")
                continue
            if I > I_TABLE_MAX:
                out[key] = Packed(
                    ok=False, blowup=True,
                    reason=f"{I} info updates > member-table cap "
                           f"{I_TABLE_MAX}")
                continue
        else:
            C, ni = 0, 0
        if width[j] > W_MAX:
            out[key] = Packed(
                ok=False,
                reason=f"window {int(width[j])} > {W_MAX} "
                       f"(concurrency too high for kernel)")
            continue
        s, e = int(starts[j]), int(starts[j] + R)
        qs = int(qstarts[j])
        p = Packed(
            ok=True, R=R, I=I, n_values=int(n_values[j]),
            w=int(w_key[j]),
            shift=shift[s:e], u_forced=u_forced[s:e],
            ceil_beyond=ceil_beyond[s:e],
            C=C, ni=ni,
            c_f=c_f_all[cs:ce] if I else empty8,
            c_a1=c_a1_all[cs:ce] if I else empty32,
            c_a2=c_a2_all[cs:ce] if I else empty32,
            c_size=c_size if I else empty32,
            c_off=c_off_all[cs:ce] if I else empty32,
            c_word=c_word if I else empty32,
            c_shift=c_shift if I else empty32,
            c_mask=c_mask if I else emptyu32,
            op_a1=a1_32[s:e], op_a2=a2_32[s:e], op_ver=ver[s:e],
            op_f=fcode[s:e], op_pred_rank=pred_32[s:e],
            op_ceiling=ceiling[s:e],
            inv_rank=inv_rank[s:e], ret_rank=ret_rank[s:e],
            lo=glo[qs:qs + R + 1],
        )
        iis = int(istarts[j])
        p._i_inv_rank = i_inv_rank_all[iis:iis + I] if I else empty64
        out[key] = p
    return out


class PackStream:
    """Streaming front-end of the batched register packer: ``feed``
    columnar op-stream chunks (core/history.py OpColumns — e.g. the
    ``ColumnsBuilder.take_chunk`` drain) while generation proceeds;
    ``finish()`` returns the same ``{key: Packed}`` dict
    :func:`pack_register_histories_batched` produces over the completed
    history's per-key split.

    Bit-identity argument: the per-op extraction pass is chunk-resumable
    (:class:`_KeyExtract` carries the one-shot loop's exact state), keys
    accumulate in first-seen order (matching ``split_by_key``'s group
    order), and ``finish`` concatenates each key's lists into the same
    per-key-contiguous flat arrays before running the SAME vectorized
    tail (:func:`_pack_batched_tail`). The tail itself cannot run per
    chunk — suffix-min version ceilings, dead-value merges and info
    symmetry classes all depend on the history's future — so only the
    per-op Python pass overlaps generation.

    Any key the columnar path can't express (reference-delegation
    semantics, malformed shapes) invalidates the whole stream: ``ok``
    flips False, further feeds no-op, and ``finish`` returns None — the
    checker then packs post-hoc exactly as before. Streaming is a pure
    reuse hint, never a correctness dependency."""

    def __init__(self):
        self._keys: list = []
        self._st: dict = {}
        self.ok = True
        #: total column rows consumed (ALL events, keyed or not) — the
        #: consumer's guard that the stream saw the complete history
        self.n_rows = 0
        self.chunks = 0

    def feed(self, cols) -> None:
        if cols is None or not self.ok:
            return
        self.n_rows += len(cols)
        self.chunks += 1
        try:
            for key, sub in cols.split_by_key().items():
                st = self._st.get(key)
                if st is None:
                    st = self._st[key] = _KeyExtract()
                    self._keys.append(key)
                st.feed(_rows_from_columns(sub))
        except (_Delegate, TypeError, ValueError):
            self.ok = False

    def finish(self) -> Optional[dict]:
        if not self.ok:
            return None
        out: dict = {}
        fast_keys: list = []
        seg_R_l: list = []
        seg_I_l: list = []
        lists = tuple([] for _ in range(8))
        ilists = tuple([] for _ in range(6))
        try:
            for key in self._keys:
                st = self._st[key]
                n_req = st.finish()
                if n_req == 0:
                    # no required ops: trivially linearizable, before
                    # any indefinite op is even considered (mirrors the
                    # batched packer's early out)
                    out[key] = Packed(ok=True, R=0)
                    continue
                fast_keys.append(key)
                seg_R_l.append(n_req)
                seg_I_l.append(len(st.ilists[0]))
                for dst, src in zip(lists, st.lists):
                    dst.extend(src)
                for dst, src in zip(ilists, st.ilists):
                    dst.extend(src)
        except (_Delegate, TypeError, ValueError):
            self.ok = False
            return None
        if fast_keys:
            _pack_batched_tail(fast_keys, seg_R_l, seg_I_l,
                               lists, ilists, out)
        return out


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


# ---------------------------------------------------------------------------
# Packed wire format (the checker service's): a runner packs once and
# ships the compact per-op vectors (~32 B/op); the frame tables are the
# lazy fields ensure_frames rebuilds from them, so they never travel.
# The bytes equal the reference's for the same history.

#: the lazy frame tables ensure_frames materializes — never serialized
FRAME_FIELDS = frozenset((
    "static_ok", "f_code", "a1", "a2", "ver", "pred_frame", "upd_mask",
    "ceil_frame", "i_static_ok", "ipred_frame",
))


def serialize_packed(p: Packed) -> bytes:
    """One Packed -> bytes: a JSON header (scalars + array manifest)
    followed by the raw C-contiguous array payloads, no pickle."""
    scalars: dict = {}
    arrays: list = []
    blobs: list = []
    for f in dataclasses.fields(Packed):
        if f.name in FRAME_FIELDS:
            continue
        v = getattr(p, f.name)
        if v is None or isinstance(v, (bool, int, str)):
            scalars[f.name] = v
        else:
            a = np.ascontiguousarray(v)
            arrays.append([f.name, a.dtype.str, list(a.shape)])
            blobs.append(a.tobytes())
    head = json.dumps({"v": 1, "scalars": scalars,
                       "arrays": arrays}).encode()
    return head + b"\n" + b"".join(blobs)


def deserialize_packed(buf: bytes) -> Packed:
    """Inverse of serialize_packed; the frame tables stay lazy.

    The manifest is validated against the payload before any array is
    built: field names must be real non-frame Packed fields (a hostile
    header cannot set arbitrary attributes), shapes non-negative
    integers, and the manifest's byte count must equal the payload's.
    Raises ValueError otherwise (the service answers it with an error
    reply and keeps the connection)."""
    nl = buf.index(b"\n")
    head = json.loads(buf[:nl].decode())
    if head.get("v") != 1:
        raise ValueError(f"unknown Packed wire version {head.get('v')}")
    wire_fields = {f.name for f in dataclasses.fields(Packed)} \
        - FRAME_FIELDS
    scalars = head.get("scalars")
    arrays = head.get("arrays")
    if not isinstance(scalars, dict) or not isinstance(arrays, list):
        raise ValueError("malformed Packed header")
    off = nl + 1
    manifest = []
    for entry in arrays:
        name, dtype, shape = entry
        if name not in wire_fields:
            raise ValueError(f"unknown Packed field {name!r}")
        if not isinstance(shape, list) \
                or any(not isinstance(d, int) or d < 0 for d in shape):
            raise ValueError(f"bad shape for {name!r}: {shape!r}")
        dt = np.dtype(dtype)
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        manifest.append((name, dt, shape, n, off))
        off += n * dt.itemsize
    if off != len(buf):
        raise ValueError(
            f"Packed payload length mismatch: manifest claims "
            f"{off - nl - 1} bytes, got {len(buf) - nl - 1}")
    p = Packed(ok=False)
    for name, v in scalars.items():
        if name not in wire_fields:
            raise ValueError(f"unknown Packed field {name!r}")
        setattr(p, name, v)
    for name, dt, shape, n, at in manifest:
        setattr(p, name, np.frombuffer(buf, dtype=dt, count=n,
                                       offset=at).reshape(shape).copy())
    return p


def bucket(n: int) -> int:
    """Pad R to a power-of-two bucket (at least 16)."""
    b = 16
    while b < n:
        b *= 2
    return b


def info_dims(p: Packed) -> tuple[int, int, int]:
    """Bucketed (c_pad, ni_pad, i_tab): padded class count, count words,
    and member-table width. All zero for info-free histories."""
    if p.C == 0:
        return 0, 0, 0
    c_pad = 8
    while c_pad < p.C:
        c_pad *= 2
    ni_pad = 1
    while ni_pad < p.ni:
        ni_pad *= 2
    i_tab = 8
    while i_tab < p.I:
        i_tab *= 2
    return c_pad, ni_pad, i_tab


def pad_tables(p: Packed, r_pad: int, info: tuple = None) -> dict:
    """The per-depth tables padded to bucketed lengths, as numpy arrays
    (the ladder's input; ``device_tables`` moves them to a device)."""
    ensure_frames(p)
    if info is None:
        info = info_dims(p)
    c_pad, ni_pad, i_tab = info

    def padded(a, rows=r_pad):
        out = np.zeros((rows,) + a.shape[1:], dtype=a.dtype)
        out[:a.shape[0]] = a
        return out

    def padded_c(a):
        out = np.zeros((c_pad,), dtype=a.dtype)
        out[:p.C] = a
        return out

    def padded_ri(a):
        out = np.zeros((r_pad, i_tab) + a.shape[2:], dtype=a.dtype)
        out[:a.shape[0], :p.I] = a
        return out

    t = {
        "shift": padded(p.shift), "static_ok": padded(p.static_ok),
        "f_code": padded(p.f_code), "a1": padded(p.a1), "a2": padded(p.a2),
        "ver": padded(p.ver), "pred_frame": padded(p.pred_frame),
        "upd_mask": padded(p.upd_mask), "u_forced": padded(p.u_forced),
        "ceil_frame": padded(p.ceil_frame),
        "ceil_beyond": padded(p.ceil_beyond),
    }
    # ceiling padding must be +inf, not 0 (a zero ceiling would prune
    # clamped-gather rows)
    t["ceil_frame"][p.ceil_frame.shape[0]:] = 2 ** 30
    t["ceil_beyond"][p.ceil_beyond.shape[0]:] = 2 ** 30
    if c_pad:
        inc = np.zeros((c_pad, ni_pad), dtype=np.uint32)
        inc[np.arange(p.C), p.c_word] = \
            np.uint32(1) << p.c_shift.astype(np.uint32)
        t.update({
            "c_f": padded_c(p.c_f), "c_a1": padded_c(p.c_a1),
            "c_a2": padded_c(p.c_a2), "c_size": padded_c(p.c_size),
            "c_off": padded_c(p.c_off), "c_word": padded_c(p.c_word),
            "c_shift": padded_c(p.c_shift), "c_mask": padded_c(p.c_mask),
            "c_inc": inc,
            "i_static_ok": padded_ri(p.i_static_ok),
            "ipred_frame": padded_ri(p.ipred_frame),
        })
    return t


def _tables_to(tables: dict, dev: torch.device) -> dict:
    """Numpy tables on ``dev``: bool tables stay bool, every integer
    table (uint32 words included, unsigned) becomes int64."""
    out = {}
    for k, v in tables.items():
        a = np.asarray(v)
        # graftlint: ignore[TORCH002] one transfer per table: a fixed dozen of differing dtypes and shapes, once per check
        out[k] = torch.from_numpy(
            a if a.dtype == bool else a.astype(np.int64)).to(dev)
    return out


def device_tables(p: Packed, dev: torch.device) -> dict:
    """``pad_tables`` on ``dev`` (see ``_tables_to``)."""
    return _tables_to(pad_tables(p, bucket(p.R)), dev)


def _lex_order(keys: list) -> torch.Tensor:
    """The permutation that sorts rows lexicographically by ``keys``
    (1-D int64 tensors of 32-bit values, most significant first; int32
    keys biased by 2**31 so their signed order holds). Keys pair into
    int64s two at a time, then stable sorts chain from the least
    significant pair up — ``lax.sort(ops, num_keys=len(ops))``."""
    pairs = []
    for j in range(0, len(keys), 2):
        if j + 1 < len(keys):
            pairs.append((keys[j] - 2 ** 31) * 2 ** 32 + keys[j + 1])
        else:
            pairs.append(keys[j])
    perm = None
    for key in reversed(pairs):
        k = key if perm is None else key[perm]
        order = torch.sort(k, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def _expand(dvec, wvec, ivec, vvec, tables, R: int, I: int, w: int,
            f_out: int):
    """One BFS wave: expand a frontier into its deduped successor set,
    truncated to ``f_out`` rows.

    Frontier: dvec [F] depths, wvec [F, NW] uint32 mask words, ivec
    [F, NI] uint32 info count words, vvec [F] value ids, all int64 on
    the tables' device; sentinel rows mark empty slots. Returns (out_d,
    out_w, out_i, out_v, n_new, accepted), the last two as 0-d tensors.
    ``accepted`` is computed on the full candidate set before
    truncation, so a reached goal is never lost to overflow."""
    from .wgl_mxu import _popcount32

    dev = dvec.device
    f_in = dvec.shape[0]
    nw = wvec.shape[1]
    bit = torch.arange(w, device=dev)
    B = torch.where(bit[:, None] // 32 == torch.arange(nw, device=dev),
                    1 << (bit[:, None] % 32), 0)           # [W, NW]

    alive = (dvec != SENTINEL_D) & (dvec < R)              # [F]
    d_cl = dvec.clamp(0, tables["shift"].shape[0] - 1)

    def row(name):
        return tables[name][d_cl]

    s_ok = row("static_ok")                                # [F, W]
    fc = row("f_code")
    ra1 = row("a1")
    ra2 = row("a2")
    rver = row("ver")
    rpred = row("pred_frame")                              # [F, W, NW]
    rupd = row("upd_mask")                                 # [F, NW]
    ruf = row("u_forced")                                  # [F]
    rshift = row("shift")                                  # [F]

    wm = wvec[:, None, :]                                  # [F, 1, NW]
    not_set = ~((wm & B[None]) != 0).any(-1)               # [F, W]
    preds_in = ((wm & rpred) == rpred).all(-1)             # [F, W]
    ni = ivec.shape[1]
    c_pad = tables["c_size"].shape[-1] if ni else 0
    if c_pad:
        cw = tables["c_word"].clamp(0, ni - 1)             # [C]
        counts = (ivec[:, cw] >> tables["c_shift"][None, :]) \
            & tables["c_mask"][None, :]                    # [F, C]
        info_total = counts.sum(1)                         # [F]
    else:
        info_total = 0
    version = ruf + _popcount32(wvec & rupd).sum(-1) + info_total
    # dead-state prune: version never decreases, so a state whose
    # version exceeds the min ceiling among unlinearized required ops
    # can never linearize them
    min_ceil = torch.minimum(
        torch.where(not_set, row("ceil_frame"), 2 ** 30).amin(1),
        row("ceil_beyond"))                                # [F]
    alive = alive & (version <= min_ceil)
    ver_b = version[:, None]
    v = vvec[:, None]                                      # [F, 1]

    is_read = fc == READ
    is_write = fc == WRITE
    is_cas = fc == CAS
    no_assert = rver == NO_ASSERT
    ver_ok = torch.where(is_read, no_assert | (rver == ver_b),
                         no_assert | (rver == ver_b + 1))
    read_ok = is_read & ((ra1 == WILDCARD) | (ra1 == v))
    cas_ok = is_cas & (ra1 == v)
    model_ok = read_ok | is_write | cas_ok
    req_valid = (alive[:, None] & s_ok & not_set & preds_in & ver_ok
                 & model_ok)

    new_w = wm | B[None]                                   # [F, W, NW]
    # slide feasibility: the rshift lowest bits (which fall off the
    # window) must all be set; shift amounts are clamped so no lane
    # shifts by >= 32
    s_amt = rshift[:, None]                                # [F, 1]

    def low_mask_word(wi):
        k = (s_amt - 32 * wi).clamp(0, 32)
        ksafe = k.clamp(max=31)
        return torch.where(k >= 32, _M32, (1 << ksafe) - 1)

    low = torch.stack([low_mask_word(wi) for wi in range(nw)], -1)
    slide_ok = ((new_w & low) == low).all(-1)              # [F, W]
    req_valid = req_valid & slide_ok

    def rshift_words(words, s):
        """Shift the NW-word value right by s in [0, 32*nw], word-wise
        with clamped lane shifts (s = 32*k + r)."""
        k = s >> 5
        r = s & 31
        rsafe = r.clamp(max=31)
        carry_amt = (32 - rsafe).clamp(max=31)
        zero = torch.zeros_like(words[0])
        padded = list(words) + [zero] * (nw + 1)
        out = []
        for i in range(nw):
            lo_w = zero
            hi_w = zero
            for kk in range(nw + 1):
                lo_w = torch.where(k == kk, padded[i + kk], lo_w)
                hi_w = torch.where(k == kk, padded[i + kk + 1], hi_w)
            carry = torch.where(r == 0, 0, (hi_w << carry_amt) & _M32)
            out.append((lo_w >> rsafe) | carry)
        return out

    new_w = torch.stack(rshift_words([new_w[:, :, wi] for wi in range(nw)],
                                     s_amt), -1)           # [F, W, NW]
    req_d = (dvec[:, None] + 1).expand(f_in, w)
    req_i = ivec[:, None, :].expand(f_in, w, ni)
    req_v = torch.where(is_read, v, torch.where(is_write, ra1, ra2))
    accepted = (req_valid & (req_d == R)).any()

    rv3 = req_valid[:, :, None]
    cand_d = [torch.where(req_valid, req_d, SENTINEL_D)]
    cand_w = [torch.where(rv3, new_w, SENTINEL_W)]
    cand_i = [req_i]
    cand_v = [torch.where(req_valid, req_v, SENTINEL_V)]

    if c_pad:
        # class candidates: fire each class's NEXT member (the count-th
        # in canonical order); the count field increments in place
        can_more = counts < tables["c_size"][None, :]
        i_tab = tables["i_static_ok"].shape[-1]
        member = (tables["c_off"][None, :] + counts).clamp(0, i_tab - 1)
        # one advanced-index gather straight to [F, C(, NW)]
        istat = tables["i_static_ok"][d_cl[:, None], member]   # [F, C]
        ipredf = tables["ipred_frame"][d_cl[:, None], member]  # [F, C, NW]
        ipred_in = ((wm & ipredf) == ipredf).all(-1)            # [F, C]
        cfc = tables["c_f"][None, :]
        ca1 = tables["c_a1"][None, :]
        ca2 = tables["c_a2"][None, :]
        c_is_w = cfc == WRITE
        i_model_ok = c_is_w | ((cfc == CAS) & (ca1 == v))
        i_valid = (alive[:, None] & can_more & istat & ipred_in
                   & i_model_ok
                   # the child (version+1, same required set) would be
                   # ceiling-dead: don't spend a frontier slot on it
                   & ((version + 1) <= min_ceil)[:, None])
        i_new_i = (ivec[:, None, :] + tables["c_inc"][None, :, :]) & _M32
        i_new_v = torch.where(c_is_w, ca1, ca2).expand(f_in, c_pad)
        cand_d.append(torch.where(i_valid,
                                  dvec[:, None].expand(f_in, c_pad),
                                  SENTINEL_D))
        cand_w.append(torch.where(i_valid[:, :, None],
                                  wvec[:, None, :].expand(f_in, c_pad, nw),
                                  SENTINEL_W))
        cand_i.append(torch.where(i_valid[:, :, None], i_new_i,
                                  ivec[:, None, :].expand(f_in, c_pad, ni)))
        cand_v.append(torch.where(i_valid, i_new_v, SENTINEL_V))

    flat_d = torch.cat(cand_d, 1).reshape(-1)
    n_cand = flat_d.shape[0]
    flat_w = torch.cat(cand_w, 1).reshape(n_cand, nw)
    flat_i = torch.cat(cand_i, 1).reshape(n_cand, ni)
    flat_v = torch.cat(cand_v, 1).reshape(-1)

    keys = ([flat_d + 2 ** 31] + [flat_w[:, wi] for wi in range(nw)]
            + [flat_i[:, iw] for iw in range(ni)] + [flat_v + 2 ** 31])
    perm = _lex_order(keys)
    sd = flat_d[perm]
    sw = flat_w[perm]
    si = flat_i[perm]
    sv = flat_v[perm]
    is_real = sd != SENTINEL_D
    change = ((sd[1:] != sd[:-1]) | (sv[1:] != sv[:-1])
              | (sw[1:] != sw[:-1]).any(1) | (si[1:] != si[:-1]).any(1))
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       change])
    uniq = is_real & first
    pos = torch.cumsum(uniq.to(torch.int64), 0) - 1
    n_new = uniq.sum()
    # slot f_out of an f_out + 1 buffer collects the dropped rows
    pos = torch.where(uniq & (pos < f_out), pos, f_out)
    i64 = torch.int64
    out_d = torch.full((f_out + 1,), SENTINEL_D, dtype=i64, device=dev)
    out_w = torch.full((f_out + 1, nw), SENTINEL_W, dtype=i64, device=dev)
    out_i = torch.zeros((f_out + 1, ni), dtype=i64, device=dev)
    out_v = torch.full((f_out + 1,), SENTINEL_V, dtype=i64, device=dev)
    out_d[pos] = sd
    out_w[pos] = sw
    if ni:
        out_i[pos] = si
    out_v[pos] = sv
    return (out_d[:f_out], out_w[:f_out], out_i[:f_out], out_v[:f_out],
            n_new, accepted)


def _initial_frontier(f: int, nw: int, ni: int, dev: torch.device):
    """The search's start: one state at depth 0 with nothing linearized
    and the key unset, then f - 1 empty slots; n_alive = 1."""
    i64 = torch.int64
    d0 = torch.full((f,), SENTINEL_D, dtype=i64, device=dev)
    d0[0] = 0
    w0 = torch.full((f, nw), SENTINEL_W, dtype=i64, device=dev)
    w0[0] = 0
    i0 = torch.zeros((f, ni), dtype=i64, device=dev)
    v0 = torch.full((f,), SENTINEL_V, dtype=i64, device=dev)
    v0[0] = NONE_VAL
    return d0, w0, i0, v0, torch.ones((), dtype=i64, device=dev)


def _grow(frontier, f_next: int):
    """Pad a frozen frontier with empty slots up to the next rung."""
    dvec, wvec, ivec, vvec, n_alive = frontier
    grow = f_next - dvec.shape[0]
    dev = dvec.device
    i64 = torch.int64
    return (torch.cat([dvec, torch.full((grow,), SENTINEL_D, dtype=i64,
                                        device=dev)]),
            torch.cat([wvec, torch.full((grow, wvec.shape[1]), SENTINEL_W,
                                        dtype=i64, device=dev)]),
            torch.cat([ivec, torch.zeros((grow, ivec.shape[1]), dtype=i64,
                                         device=dev)]),
            torch.cat([vvec, torch.full((grow,), SENTINEL_V, dtype=i64,
                                        device=dev)]),
            n_alive)


def _wgl_loop(tables: dict, R: int, I: int, f_max: int, w: int, init0,
              k_stop: Optional[int] = None):
    """The wave loop at one rung, resumed from ``init0 = (k0, dvec,
    wvec, ivec, vvec, n_alive)``: expand until accepted, a dead
    frontier, overflow (the pre-expansion frontier is frozen for the
    next rung or the spill) or ``k_stop`` waves (the streaming pause;
    None keeps the R + I + 1 exhaustion bound).

    Every carry is masked by ``active`` (the reference's vmap-safety
    guard), so waves run past the end are no-ops: the host reads the
    loop condition only every ``SYNC_EVERY`` waves, and on the card a
    long run replays batches of waves from a CUDA graph
    (``_graph_waves``). Returns (accepted, overflow, k, peak, frontier)
    with the first four as Python values and the frontier's tensors on
    the device."""
    global RUNG_LAUNCHES
    k0, dvec, wvec, ivec, vvec, n_alive = init0
    dev = dvec.device
    if dev.type == "cuda":
        with _sharded_lock:
            RUNG_LAUNCHES += 1
    lim = (R + I + 1) if k_stop is None else min(k_stop, R + I + 1)
    i64 = torch.int64
    n_alive = torch.as_tensor(n_alive, dtype=i64, device=dev)
    # carry: k, dvec, wvec, ivec, vvec, n_alive, peak, overflow, accepted
    carry = [torch.tensor(k0, dtype=i64, device=dev), dvec, wvec, ivec,
             vvec, n_alive, n_alive.clone(),
             torch.zeros((), dtype=torch.bool, device=dev),
             torch.tensor(R == 0, device=dev)]

    def running(c):
        k, n_alive, overflow, accepted = c[0], c[5], c[7], c[8]
        return (~accepted) & (n_alive > 0) & (~overflow) & (k < lim)

    def wave(c):
        k, dvec, wvec, ivec, vvec, n_alive, peak, overflow, accepted = c
        active = running(c)
        out_d, out_w, out_i, out_v, n_new, acc_now = _expand(
            dvec, wvec, ivec, vvec, tables, R, I, w, f_max)
        ovf_now = (n_new > f_max) & (~acc_now)
        advance = active & (~ovf_now)
        return [torch.where(advance, k + 1, k),
                torch.where(advance, out_d, dvec),
                torch.where(advance, out_w, wvec),
                torch.where(advance, out_i, ivec),
                torch.where(advance, out_v, vvec),
                torch.where(advance, torch.clamp(n_new, max=f_max),
                            n_alive),
                torch.where(active, torch.maximum(peak, n_new), peak),
                torch.where(active, overflow | ovf_now, overflow),
                torch.where(active, accepted | acc_now, accepted)]

    # each active wave advances k or stops the loop, so lim - k0 waves
    # always suffice
    n_waves = max(0, lim - k0)
    done = 0
    if dev.type == "cuda" and n_waves >= GRAPH_MIN_WAVES:
        carry, done = _graph_waves(wave, running, carry, n_waves)
    for it in range(done, n_waves):
        if (it - done) % SYNC_EVERY == 0 and not bool(running(carry)):
            break
        carry = wave(carry)
    k, dvec, wvec, ivec, vvec, n_alive, peak, overflow, accepted = carry
    return (bool(accepted), bool(overflow), int(k), int(peak),
            (dvec, wvec, ivec, vvec, n_alive))


def _graph_waves(wave, running, carry: list, n_waves: int):
    """Run waves on the card from one captured CUDA graph of
    ``GRAPH_WAVES`` waves, replayed while the loop runs and whole
    batches fit in ``n_waves``: the same operations as the eager loop
    (so the same results), without the host's per-operation launch
    cost. Returns (carry, waves run); the caller runs the rest."""
    static = [c.clone() for c in carry]
    side = torch.cuda.Stream(device=static[0].device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        # one eager wave first, as CUDA graphs want before a capture
        for dst, src in zip(static, wave(static)):
            dst.copy_(src)
    torch.cuda.current_stream().wait_stream(side)
    done = 1
    # graftlint: ignore[TORCH003] one capture per rung run by design: only runs of GRAPH_MIN_WAVES waves or more capture, and the capture holds the rung's own tables
    graph = torch.cuda.CUDAGraph()
    # one capture at a time in the process (PyTorch's rule), on this
    # call's own stream, never the capture stream torch.cuda.graph
    # shares between threads; thread-local, so other threads may go on
    # issuing work and allocating on the card meanwhile (the fused
    # pipeline's generator, the service's other lanes)
    with _CAPTURE_LOCK, torch.cuda.graph(
            graph, stream=side, capture_error_mode="thread_local"):
        c = static
        for _ in range(GRAPH_WAVES):
            c = wave(c)
        for dst, src in zip(static, c):
            dst.copy_(src)
    while done + GRAPH_WAVES <= n_waves and bool(running(static)):
        graph.replay()
        done += GRAPH_WAVES
    return static, done


def _ladder(p: Packed, f_max: Optional[int]) -> list:
    """The rungs a search climbs: from ``f_max`` (default the bottom
    rung) up; W=128 windows stop at F_MAX and skip 256, as in the
    reference (their overflows are almost always combinatorial blowup,
    which the DFS-first overflow path takes)."""
    ladder = LADDER if f_max is None else \
        [f_max] + [f for f in LADDER if f > f_max]
    if p.w == W_MAX:
        ladder = [f for f in ladder if f <= F_MAX and f != 256] \
            or [ladder[0]]
    return ladder


def _overflow_result(p: Packed, peak: int, rungs: int, resume) -> dict:
    return {"valid?": "unknown", "overflow": True,
            "reason": "frontier overflow past the top rung",
            "peak-frontier": peak, "ops": p.R, "info-ops": p.I,
            "rungs": rungs, "engine": "jnp-ladder", "_resume": resume}


def _spilled_result(p: Packed, tables, frontier, k: int, peak: int,
                    rungs: int) -> dict:
    out = spill_packed(p, tables, frontier, k)
    out["peak-frontier"] = max(peak, out.get("peak-frontier", 0))
    out["rungs"] = rungs
    out.setdefault("engine", "jnp-ladder")
    return out


def _ladder_result(p: Packed, valid: bool, k: int, peak: int,
                   rungs: int) -> dict:
    return {"valid?": valid, "waves": k, "peak-frontier": peak,
            "ops": p.R, "info-ops": p.I, "rungs": rungs,
            "engine": "jnp-ladder",
            **({} if valid else {"stuck-at-depth": k})}


def check_packed(p: Packed, f_max: Optional[int] = None,
                 spill: bool = True, device=None) -> dict:
    """Telemetry shell around :func:`_check_packed_impl`, as the
    reference's: one ``wgl.check_packed`` span a call, plus the routing
    counters a run's results.json surfaces (dispatch count, rung total,
    peak frontier and wave depth across the run)."""
    tel = telemetry.current()
    with tel.span("wgl.check_packed", ops=getattr(p, "R", None),
                  w=getattr(p, "w", None)) as sp:
        out = _check_packed_impl(p, f_max=f_max, spill=spill,
                                 device=device)
        sp.set(engine=out.get("engine"), valid=out.get("valid?"),
               rungs=out.get("rungs"), waves=out.get("waves"),
               peak_frontier=out.get("peak-frontier"))
    tel.counter("wgl.dispatches")
    if out.get("rungs"):
        tel.counter("wgl.rungs", out["rungs"])
    if out.get("waves"):
        tel.counter("wgl.waves", out["waves"], mode="max")
    if out.get("peak-frontier"):
        tel.counter("wgl.max-frontier", out["peak-frontier"], mode="max")
    return out


def _check_packed_impl(p: Packed, f_max: Optional[int] = None,
                       spill: bool = True, device=None) -> dict:
    """Check one packed history on ``device`` (``cuda`` unless named).

    With ``f_max`` None the wave kernel (ops/wgl_mxu.py) goes first; a
    history it cannot take (info ops, id budget) or whose frontier
    overflows its 32 slots climbs the capacity ladder from rung 32. On
    overflow the frozen pre-expansion frontier resumes at the next rung
    (earlier waves are never redone). Past the top rung the spill BFS
    takes over from the same frontier — unless ``spill=False``, which
    returns ``{"valid?": "unknown", "overflow": True, "_resume": ...}``
    so the caller can try the DFS first and then ``spill_packed(p,
    *out["_resume"])``. A wave-kernel failure on the card raises."""
    dev = resolve_device(device)
    if not p.ok:
        return {"valid?": "unknown", "reason": p.reason,
                "blowup": p.blowup}
    if p.R == 0:
        return {"valid?": True, "waves": 0}
    if f_max is None:
        from . import wgl_mxu
        out = wgl_mxu.check_packed_mxu(p, device=dev)
        if out is not None and not out.get("overflow"):
            return out
    ladder = _ladder(p, f_max)
    ni = info_dims(p)[1]
    tables = device_tables(p, dev)
    # one histogram sample per rung attempt, value = the rung's
    # frontier budget (the guided coverage vector's wave histogram)
    telemetry.current().hist("wgl.rung_waves", ladder[0])
    valid, overflow, k, peak, frontier = _wgl_loop(
        tables, p.R, p.I, ladder[0], p.w,
        (0, *_initial_frontier(ladder[0], p.w // 32, ni, dev)))
    peak_all = max(1, peak)
    rungs = 1
    for f_next in ladder[1:]:
        if not overflow:
            break
        rungs += 1
        telemetry.current().hist("wgl.rung_waves", f_next)
        valid, overflow, k, peak, frontier = _wgl_loop(
            tables, p.R, p.I, f_next, p.w, (k, *_grow(frontier, f_next)))
        peak_all = max(peak_all, peak)
    if overflow:
        if not spill:
            return _overflow_result(p, peak_all, rungs,
                                    (tables, frontier, k))
        return _spilled_result(p, tables, frontier, k, peak_all, rungs)
    return _ladder_result(p, valid, k, peak_all, rungs)


def group_key(p: Packed) -> tuple:
    """The (R-bucket, info dims, window width) group key: keys sharing
    it share padded table shapes and ride one batched ladder rung; the
    checker service places groups on its lanes by it."""
    return (bucket(p.R), info_dims(p), p.w)


class PreparedGroup(Mapping):
    """The host half of one batched-rung dispatch: a same-``group_key``
    key group's tables, padded to the group's shapes and stacked on the
    key axis (``stacked``: table name -> [k_pad, ...] numpy array), with
    each row's R and I. The key axis pads to a power of two per lane
    times ``lanes`` (1 for one device, the lane count when the rung is
    split over lanes); padding rows have R = 0 and are never searched.
    As a mapping it gives each table's rows of the group's ``n`` real
    keys. The checker service builds tick N+1's groups on its
    dispatcher thread while tick N's run on their lanes."""

    __slots__ = ("key", "n", "lanes", "k_pad", "stacked", "Rs", "Is")

    def __init__(self, key, n, lanes, k_pad, stacked, Rs, Is):
        self.key = key
        self.n = n
        self.lanes = lanes
        self.k_pad = k_pad
        self.stacked = stacked
        self.Rs = Rs
        self.Is = Is

    def __getitem__(self, name):
        return self.stacked[name][:self.n]

    def __iter__(self):
        return iter(self.stacked)

    def __len__(self):
        return len(self.stacked)

    def fits(self, packs: list, idxs: list, key: tuple,
             lanes: int) -> bool:
        """Whether this group was prepared for exactly these keys."""
        return (self.n == len(idxs) and self.lanes == lanes
                and self.key == key
                and all(packs[i].R == int(self.Rs[j])
                        for j, i in enumerate(idxs)))


def prepare_bucket_group(packs: list, idxs: list, r_pad: int,
                         info: tuple, lanes: int = 1) -> PreparedGroup:
    """Pad and stack a key group's tables on the host, key j being
    ``packs[idxs[j]]`` (see PreparedGroup)."""
    K = len(idxs)
    per_lane = 1
    while per_lane * lanes < K:
        per_lane *= 2
    k_pad = per_lane * lanes
    per_key = [pad_tables(packs[i], r_pad, info) for i in idxs]
    stacked = {}
    for name in per_key[0]:
        first = per_key[0][name]
        out = np.zeros((k_pad,) + first.shape, dtype=first.dtype)
        for j, t in enumerate(per_key):
            out[j] = t[name]
        stacked[name] = out
    Rs = np.zeros(k_pad, dtype=np.int32)  # padding keys: R = 0
    Is = np.zeros(k_pad, dtype=np.int32)
    for j, i in enumerate(idxs):
        Rs[j] = packs[i].R
        Is[j] = packs[i].I
    return PreparedGroup((r_pad, info, packs[idxs[0]].w), K, lanes,
                         k_pad, stacked, Rs, Is)


def _b1_first(device) -> bool:
    """Whether ``check_packed_batch`` runs the wave kernel before the
    ladder: when its lanes (``device``, or every lane of
    ``wgl_mxu.batch_lanes``) are CUDA devices, as the reference's
    ``_run_fused`` runs it on its TPU; on the CPU the batch stays on the
    ladder, as the reference's does there."""
    from . import wgl_mxu
    return all(d.type == "cuda" for d in wgl_mxu.batch_lanes(device))


def check_packed_batch(packs: list, f_max: Optional[int] = None,
                       try_fused: bool = True, device=None,
                       shard: bool = False, prepared=None,
                       device_for=None) -> list:
    """Check K per-key packed histories, one result dict per pack in
    input order.

    With ``f_max`` None and ``try_fused``, on the card the wave kernel
    takes every key it can first (``wgl_mxu.check_packed_batch_mxu``:
    one launch per lane per (R-bucket, width) group); the keys it cannot
    take or whose frontier overflowed go on to the ladder. A kernel
    failure raises. ``try_fused=False`` means the caller already ran the
    kernel (``TPULinearizableChecker.check_batch``) and these packs are
    its leftovers.

    The ladder keys group by ``group_key``: a lone key climbs the
    ladder through ``check_packed`` (from rung 32; the kernel is not
    retried); a group of several runs the batched rung at the group's
    fixed capacity (128 unless ``f_max`` is given), each key's waves
    until it finishes — the reference's vmapped ``_wgl_kernel``, whose
    finished keys are masked, gives the same per-key dicts, labelled
    ``batched: True``. A key that overflows the batched rung climbs from
    F_MAX. Spill is deferred (``{"overflow": True, "_resume": ...}``)
    so the checker can interpose its DFS.

    Placement (the checker service's): ``device`` commits every group
    to one lane; ``device_for`` is a ``group_key -> device`` callback
    for groups when ``device`` is None; ``shard=True`` splits each
    group's key axis over every lane of ``wgl_mxu.batch_lanes`` (the
    reference's ``_batched_kernel_sharded``); ``prepared`` maps group
    keys to ``PreparedGroup``s built ahead, rebuilt when they do not
    fit. Otherwise a group runs on ``cuda`` (one device)."""
    results: list = [None] * len(packs)
    if f_max is None and try_fused and \
            any(p.ok and p.R > 0 for p in packs) and _b1_first(device):
        from . import wgl_mxu
        mxu_out = wgl_mxu.check_packed_batch_mxu(packs, device=device)
        if mxu_out is not None:
            for i, out in enumerate(mxu_out):
                if out is not None and not out.get("overflow"):
                    results[i] = out
    groups: dict = {}
    for i, p in enumerate(packs):
        if results[i] is not None:
            continue
        if not p.ok:
            results[i] = {"valid?": "unknown", "reason": p.reason,
                          "blowup": p.blowup}
        elif p.R == 0:
            results[i] = {"valid?": True, "waves": 0}
        else:
            groups.setdefault(group_key(p), []).append(i)
    for key, idxs in groups.items():
        dev = device
        if dev is None and device_for is not None:
            dev = device_for(key)
        prep = None if prepared is None else prepared.get(key)
        _check_bucket_group(packs, results, idxs, *key, f_max,
                            device=dev, shard=shard, prepared=prep)
    return results


def _check_bucket_group(packs: list, results: list, idxs: list,
                        r_pad: int, info: tuple, w: int,
                        f_max: Optional[int], device=None,
                        shard: bool = False, prepared=None) -> None:
    """The batched rung for one same-``group_key`` key group; results
    written in place. With ``shard`` (and no ``device``) the key axis
    splits evenly over the lanes of ``wgl_mxu.batch_lanes`` and each
    lane runs its keys on a thread and a CUDA stream of its own (the
    reference's ``_batched_kernel_sharded``, whose shard_map runs each
    device's keys apart); otherwise the group runs on ``device``.
    Either way each key's loop reads its own rows of the group's
    tables, so the dicts do not depend on the lanes."""
    if len(idxs) == 1 and not shard:
        # a lone pack rides the rung ladder (early exit beats the
        # fixed-capacity batched rung)
        results[idxs[0]] = check_packed(
            packs[idxs[0]], f_max=LADDER[0] if f_max is None else f_max,
            spill=False, device=device)
        return
    if f_max is None:
        f_max = 128
    if shard and device is None:
        from . import wgl_mxu
        lanes = wgl_mxu.batch_lanes()
    else:
        lanes = [resolve_device(device)]
    K = len(idxs)
    if prepared is None or not prepared.fits(packs, idxs,
                                             (r_pad, info, w), len(lanes)):
        prepared = prepare_bucket_group(packs, idxs, r_pad, info,
                                        lanes=len(lanes))
    per = prepared.k_pad // len(lanes)
    tel = telemetry.current()
    for _ in idxs:
        # every key in the group attempts the batched rung
        tel.hist("wgl.rung_waves", f_max)
    # (peak, waves) of every key's batched rung, overflowed or not
    rung_stats: list = []

    def lane(d: int) -> list:
        """Lane d's real keys (rows d*per onward), searched in order."""
        rows = range(d * per, min((d + 1) * per, K))
        if not rows:
            return []
        dev = lanes[d]
        stacked = _tables_to({name: a[rows.start:rows.stop]
                              for name, a in prepared.stacked.items()}, dev)
        out = []
        for j in rows:
            p = packs[idxs[j]]
            valid, overflow, k, peak, _ = _wgl_loop(
                {name: t[j - rows.start] for name, t in stacked.items()},
                p.R, p.I, f_max, w,
                (0, *_initial_frontier(f_max, w // 32, info[1], dev)))
            rung_stats.append((peak, k))
            if overflow:
                # climb the remaining rungs per key; spill deferred
                out.append(check_packed(p, f_max=F_MAX, spill=False,
                                        device=dev))
            else:
                out.append({
                    "valid?": valid, "waves": k, "peak-frontier": peak,
                    "ops": p.R, "info-ops": p.I, "batched": True,
                    **({} if valid else {"stuck-at-depth": k})})
        return out

    with tel.span("wgl.batch-dispatch", keys=K, w=w, f_max=f_max):
        lane_outs = _run_lanes(lanes, lane)
    tel.counter("wgl.dispatches")
    if rung_stats:
        tel.counter("wgl.max-frontier", max(pk for pk, _ in rung_stats),
                    mode="max")
        tel.counter("wgl.waves", max(k for _, k in rung_stats),
                    mode="max")
    if shard and device is None:
        global SHARDED_LAUNCHES
        with _sharded_lock:
            SHARDED_LAUNCHES += sum(1 for outs in lane_outs if outs)
    for d, outs in enumerate(lane_outs):
        for j, out in enumerate(outs):
            results[idxs[d * per + j]] = out


def _run_lanes(lanes: list, work) -> list:
    """``[work(d) for d in range(len(lanes))]``, each lane on a thread
    and (on the card) a stream of its own; one lane runs on the
    caller's thread and stream. The first failure raises."""
    if len(lanes) == 1:
        return [work(0)]
    from concurrent.futures import ThreadPoolExecutor
    # the lanes record into the caller's recorder (a service tick's),
    # not the process's
    tel = telemetry.current()

    def on_lane(d: int) -> list:
        telemetry.set_thread_current(tel)
        try:
            with lane_stream(lanes[d]):
                return work(d)
        finally:
            telemetry.set_thread_current(None)

    with ThreadPoolExecutor(len(lanes),
                            thread_name_prefix="wgl-lane") as pool:
        return list(pool.map(on_lane, range(len(lanes))))


def spill_packed(p: Packed, tables, frontier, waves_done: int) -> dict:
    """Budgeted spill continuation from a frozen frontier — the entry
    point for resuming a ``check_packed(..., spill=False)`` overflow
    (its ``_resume`` payload) without re-climbing the ladder."""
    tel = telemetry.current()
    tel.counter("wgl.host-spill")
    with tel.span("wgl.spill", ops=p.R, w=p.w) as sp:
        out = _spill_bfs(p, tables, frontier, waves_done,
                         state_budget=SPILL_STATE_BUDGET
                         if p.I < SPILL_I_LIMIT
                         else SPILL_STATE_BUDGET_HIGH_I)
        sp.set(valid=out.get("valid?"),
               peak_frontier=out.get("peak-frontier"),
               states=out.get("states"))
    if out.get("peak-frontier"):
        tel.counter("wgl.max-frontier", out["peak-frontier"], mode="max")
    return out


def _spill_bfs(p: Packed, tables, frontier, waves_done: int,
               state_budget: int = SPILL_STATE_BUDGET,
               wall_budget_s: float = SPILL_WALL_BUDGET_S) -> dict:
    """Host-driven chunked BFS after the ladder's top rung overflowed.

    The frontier lives on the host as int64 rows (d, w-words, i-words,
    v); each wave expands it on the device in SPILL_CHUNK-row chunks at
    full output capacity (a chunk of f_in rows has at most f_in * (W +
    classes) successors, so nothing is dropped), then merges the chunks
    with ``np.unique`` over rows. Sound and complete: the only exits
    without a verdict are the explicit state, frontier and wall
    budgets."""
    c_pad, ni, _ = info_dims(p)
    nw = p.w // 32
    dev = tables["shift"].device
    f_in = SPILL_CHUNK if p.w < W_MAX else 1024
    width = p.w + max(c_pad, 1)
    dvec, wvec, ivec, vvec, n_alive = frontier
    n = int(n_alive)
    fr = torch.cat([dvec[:n, None], wvec[:n], ivec[:n], vvec[:n, None]],
                   1).cpu().numpy()                    # [n, 2 + nw + ni]
    # graftlint: ignore[DET001] explicit wall budget: returns valid?=unknown (never flips a verdict), the Knossos-timeout analog
    t_start = time.monotonic()
    states_total = n
    peak = n
    waves = waves_done
    max_waves = p.R + p.I + 1
    while fr.shape[0] and waves < max_waves:
        # graftlint: ignore[DET001] explicit wall budget: returns valid?=unknown (never flips a verdict), the Knossos-timeout analog
        if time.monotonic() - t_start > wall_budget_s:
            return {"valid?": "unknown", "blowup": True,
                    "reason": f"spill wall budget {wall_budget_s:.0f}s "
                              "exceeded",
                    "peak-frontier": peak, "spilled": True}
        succs = []
        for s in range(0, fr.shape[0], f_in):
            # graftlint: ignore[TORCH002] spill engine: one transfer per host chunk is its design
            chunk = torch.from_numpy(fr[s:s + f_in]).to(dev)
            out_d, out_w, out_i, out_v, n_new, accepted = _expand(
                chunk[:, 0], chunk[:, 1:1 + nw],
                chunk[:, 1 + nw:1 + nw + ni],
                chunk[:, 1 + nw + ni], tables, p.R, p.I, p.w,
                chunk.shape[0] * width)
            if bool(accepted):
                return {"valid?": True, "waves": waves + 1,
                        "peak-frontier": peak, "ops": p.R,
                        "info-ops": p.I, "spilled": True,
                        "states": states_total}
            m = int(n_new)
            if m:
                # graftlint: ignore[TORCH001,TORCH002] spill engine: host merge per chunk is its design
                succs.append(torch.cat(
                    [out_d[:m, None], out_w[:m], out_i[:m],
                     out_v[:m, None]], 1).cpu().numpy())
        if not succs:
            fr = np.zeros((0, 2 + nw + ni), dtype=np.int64)
            break
        fr = np.unique(np.concatenate(succs, axis=0), axis=0)
        waves += 1
        states_total += fr.shape[0]
        peak = max(peak, fr.shape[0])
        if fr.shape[0] > SPILL_FRONTIER_LIMIT:
            return {"valid?": "unknown", "blowup": True,
                    "reason": f"spill frontier {fr.shape[0]} > "
                              f"{SPILL_FRONTIER_LIMIT}",
                    "peak-frontier": peak, "spilled": True}
        if states_total > state_budget:
            return {"valid?": "unknown", "blowup": True,
                    "reason": f"spill budget exceeded "
                              f"({states_total} states)",
                    "peak-frontier": peak, "spilled": True}
    if fr.shape[0]:
        # the wave backstop tripped with work remaining: cannot happen
        # for a well-formed pack (levels are bounded by R + I)
        return {"valid?": "unknown", "reason": "spill wave budget exceeded",
                "peak-frontier": peak, "spilled": True}
    return {"valid?": False, "waves": waves, "peak-frontier": peak,
            "ops": p.R, "info-ops": p.I, "spilled": True,
            "states": states_total, "stuck-at-depth": waves}


class FrontierState:
    """Resumable cursor for :func:`check_prefix`: the device tables, the
    frozen pre-expansion frontier, the cumulative wave counter, the
    current ladder rung and the run accounting. ``done`` flips once the
    search concludes; ``result`` then holds the same dict the one-shot
    ladder produces."""

    __slots__ = ("p", "tables", "ladder", "rung_i", "k", "frontier",
                 "peak", "rungs", "waves_run", "done", "result", "spill")

    def __init__(self):
        self.done = False
        self.result = None
        self.waves_run = 0


def check_prefix(p: Packed, state: Optional[FrontierState] = None,
                 max_waves: int = 64, spill: bool = True,
                 device=None) -> FrontierState:
    """Chunked form of the ladder: advance the BFS by at most
    ``max_waves`` waves and return the (possibly finished) state. Call
    with ``state=None`` to start (on ``device``, ``cuda`` unless named);
    poll ``state.done`` / ``state.result``.

    The wave budget only chooses where the loop pauses: frontier
    contents, rung escalations, the spill hand-off and the final dict
    equal the one-shot ladder's for every budget. The wave kernel is not
    tried here (pausing is a host-driven loop by construction)."""
    if state is None:
        dev = resolve_device(device)
        state = FrontierState()
        state.p = p
        state.spill = spill
        if not p.ok:
            state.done = True
            state.result = {"valid?": "unknown", "reason": p.reason,
                            "blowup": p.blowup}
            return state
        if p.R == 0:
            state.done = True
            state.result = {"valid?": True, "waves": 0}
            return state
        state.ladder = _ladder(p, None)
        state.tables = device_tables(p, dev)
        state.rung_i = 0
        state.frontier = _initial_frontier(state.ladder[0], p.w // 32,
                                           info_dims(p)[1], dev)
        state.k = 0
        state.peak = 1
        state.rungs = 1
        # rung attempt sample (not per budget chunk)
        telemetry.current().hist("wgl.rung_waves", state.ladder[0])
    if state.done:
        return state
    p = state.p
    k_before = state.k
    valid, overflow, k, peak, frontier = _wgl_loop(
        state.tables, p.R, p.I, state.ladder[state.rung_i], p.w,
        (k_before, *state.frontier),
        k_stop=k_before + max(1, max_waves))
    state.peak = max(state.peak, peak)
    state.k, state.frontier = k, frontier
    state.waves_run += k - k_before
    if overflow:
        if state.rung_i + 1 < len(state.ladder):
            # climb one rung: pad the frozen frontier in place, exactly
            # like the one-shot ladder
            state.rung_i += 1
            state.rungs += 1
            telemetry.current().counter("stream.resume_rungs")
            telemetry.current().hist("wgl.rung_waves",
                                     state.ladder[state.rung_i])
            state.frontier = _grow(frontier, state.ladder[state.rung_i])
            return state
        state.done = True
        if state.spill:
            state.result = _spilled_result(p, state.tables, state.frontier,
                                           state.k, state.peak, state.rungs)
        else:
            state.result = _overflow_result(
                p, state.peak, state.rungs,
                (state.tables, state.frontier, state.k))
        return state
    if valid or int(frontier[4]) == 0 or k >= p.R + p.I + 1:
        state.done = True
        state.result = _ladder_result(p, valid, k, state.peak, state.rungs)
    return state
