"""The set-full checker: full lifecycle analysis of set elements.

Re-implements the jepsen library checker the reference binds at
``set.clj:46`` and ``lock.clj:258`` (``checker/set-full
{:linearizable? true}``). The history contains ``add`` ops (one element
each) and ``read`` ops (whole set). For every attempted element we track
its lifecycle against all reads:

- an element becomes **known** once its add completes :ok, or once any
  :ok read observes it (whichever is earliest);
- reads *invoked after* the known point must observe it; a read that
  misses it is an **absent observation**;
- outcome per element:
    * ``stable``     — known, and every read after the known point saw it;
    * ``lost``       — known, and the last read(s) no longer see it
                       (absent with no later present observation);
    * ``stale``      — known, temporarily absent, but visible again later
                       (legal only for non-linearizable sets);
    * ``never-read`` — possibly present (add :ok or :info) but no read
                       after it ever ran / observed it — proves nothing;
    * ``unknown``    — add :info and never observed (may simply not have
                       happened).

``valid?`` is false when any element is lost, or (with
``linearizable=True``) when any stale window exists; it is ``"unknown"``
when nothing was ever read (no information).

Timing: stale windows are measured in virtual nanoseconds between the
known time and the first subsequent present read, matching the spirit of
the reference checker's ``:worst-stale`` report.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from ..core.history import History, TYPE_NAMES
from .core import Checker


@dataclass
class _Element:
    value: Any
    add_invoke: Optional[int] = None      # history index
    add_type: Optional[str] = None        # ok | fail | info
    known_index: Optional[int] = None     # index where presence is proven
    known_time: Optional[int] = None
    present_after_absent: bool = False
    stale_until: Optional[int] = None     # time first re-observed


class _NonColumnar(Exception):
    """Values outside the int fast path (floats, ad-hoc objects):
    lifecycle analysis needs Python == semantics, use the set sweep."""


def _increment_of(prev: list, vals: list) -> Optional[list]:
    """The elements inserted into ``prev`` to produce ``vals``, or None.

    A growing sorted set changes by insertion, so consecutive read
    views differ by a handful of elements; finding them costs
    O(d log n) probes (first-mismatch binary search, valid for
    strictly increasing lists) plus one O(n) slice-equality
    reconstruction check that keeps the answer exact for arbitrary
    lists — a wrong candidate from unsorted input just fails the
    check and the caller falls back to a full conversion."""
    lp, lv = len(prev), len(vals)
    d = lv - lp
    if d <= 0 or d > 64:
        return None
    ins = []
    cuts = []                # insert positions in vals
    po = vo = 0
    while len(ins) < d:
        m = lp - po          # remaining common span
        lo, hi = 0, m
        while lo < hi:       # first i with vals[vo+i] != prev[po+i]
            mid = (lo + hi) // 2
            if vals[vo + mid] == prev[po + mid]:
                lo = mid + 1
            else:
                hi = mid
        ins.append(vals[vo + lo])
        cuts.append(vo + lo)
        vo += lo + 1
        po += lo
    # exact reconstruction: vals minus the cut positions == prev
    a = b = 0
    for c in cuts:
        if vals[a:c] != prev[b:b + (c - a)]:
            return None
        b += c - a
        a = c + 1
    if vals[a:] != prev[b:]:
        return None
    return ins


def analyze(history, _scan=None) -> dict:
    """Element-lifecycle analysis; see module docstring for outcomes.

    Int-valued workloads (every real set workload) run the columnar
    numpy path: one element x read presence matrix, known points via
    first-true, lost/stale via suffix comparisons — the per-read set
    arithmetic of the sweep becomes a handful of matrix reductions.
    Anything else falls back to the reference sweep; both produce
    identical results (differentially tested in tests/test_set.py).

    ``_scan`` is a precomputed event-scan tuple (a finished
    :class:`ColumnScan` fed incrementally by the streaming runner); it
    replaces the scan pass only — the vectorized tail still runs here,
    so the result is bit-identical to the post-hoc path by
    construction."""
    h = history if isinstance(history, History) else History(history)
    try:
        return _analyze_columnar(h, _scan=_scan)
    except _NonColumnar:
        return _analyze_reference(h)


def _analyze_reference(h: History) -> dict:
    """Single forward sweep with set arithmetic.

    Every read covers every element already known when it was invoked,
    so per-read state is maintained with whole-set operations (C speed)
    instead of a per-element scan of all reads — the naive formulation
    is O(elements x reads), quadratic on set-workload histories.
    """
    elements: dict[Any, _Element] = {}
    # reads: (invoke_index, invoke_time, ok_index, value-as-set, dup-list)
    reads: list[tuple[int, int, int, frozenset, list]] = []
    duplicated: dict[Any, int] = {}

    for op in h:
        if not op.is_client_op:
            continue
        if op.f == "add":
            x = op.value
            el = elements.get(x)
            if el is None:
                el = elements[x] = _Element(value=x)
            if op.is_invoke:
                el.add_invoke = op.index
            else:
                el.add_type = op["type"]
        elif op.f == "read" and op.is_ok and op.value is not None:
            # graftlint: ignore[COL002] reference dict sweep: the guarded fallback behind _NonColumnar
            inv = h.invocation(op)
            vals = list(op.value)
            vset = frozenset(vals)
            if len(vals) != len(vset):
                seen: set = set()
                for v in vals:
                    if v in seen:
                        duplicated[v] = duplicated.get(v, 0) + 1
                    seen.add(v)
            reads.append((inv.index if inv is not None else op.index,
                          (inv or op).time or 0, op.index, vset, vals))

    # pass 1: establish known points (add :ok completion or first read
    # observation, whichever proves presence earliest in history order)
    for op in h:
        if op.f == "add" and op.is_ok:
            el = elements[op.value]
            if el.known_index is None:
                el.known_index = op.index
                el.known_time = op.time or 0
    observed: set = set()
    for ri, rt, ok_i, vset, _vals in sorted(reads, key=lambda r: r[2]):
        for x in vset - observed:   # first observation = min ok_i
            el = elements.get(x)
            if el is None:
                el = elements[x] = _Element(value=x)
            if el.known_index is None or ok_i < el.known_index:
                el.known_index = ok_i
                el.known_time = rt
        observed |= vset

    # pass 2: sweep reads in invoke order; each read covers exactly the
    # elements known before its invoke
    reads.sort()
    by_known = sorted((el for el in elements.values()
                       if el.known_index is not None),
                      key=lambda e: e.known_index)
    ptr = 0
    known_now: set = set()
    absent_last: set = set()       # missing in their latest covering read
    absent_count: dict[Any, int] = {}
    for ri, rt, ok_i, vset, _vals in reads:
        while ptr < len(by_known) and by_known[ptr].known_index < ri:
            known_now.add(by_known[ptr].value)
            ptr += 1
        if not known_now:
            continue
        for x in absent_last & vset:      # reappeared: stale transition
            el = elements[x]
            if not el.present_after_absent:
                el.present_after_absent = True
                el.stale_until = rt
        miss = known_now - vset
        for x in miss:
            absent_count[x] = absent_count.get(x, 0) + 1
        absent_last = miss
    # known_now only grows, so after the sweep it is exactly the set of
    # elements covered by at least one read
    covered = known_now

    stable, lost, never_read, stale, unknown = [], [], [], [], []
    attempts = 0
    for x, el in sorted(elements.items(), key=lambda kv: repr(kv[0])):
        if el.add_invoke is not None:
            attempts += 1
        if el.known_index is None:
            if el.add_type == "ok":
                never_read.append(x)     # confirmed added, never observed
            elif el.add_type in ("info", None):
                unknown.append(x)        # may never have happened
            # fail: definitely absent; ignore
            continue
        if x in absent_last:
            lost.append(x)               # still missing at the final read
        elif absent_count.get(x):
            stale.append(x)
        elif x not in covered:
            never_read.append(x)         # known but no read ever covered it
        else:
            stable.append(x)

    worst_stale = []
    for x in stale:
        el = elements[x]
        dur = (el.stale_until or 0) - (el.known_time or 0)
        worst_stale.append({"element": x, "stale-ns": dur,
                            "absent-reads": absent_count.get(x, 0)})
    worst_stale.sort(key=lambda d: -d["stale-ns"])

    return {
        "attempt-count": attempts,
        "stable-count": len(stable),
        "lost": lost, "lost-count": len(lost),
        "stale": stale, "stale-count": len(stale),
        "worst-stale": worst_stale[:8],
        "never-read": never_read[:64], "never-read-count": len(never_read),
        "unknown-count": len(unknown),
        "duplicated": dict(sorted(duplicated.items(),
                                  key=lambda kv: repr(kv[0]))[:16]),
        "duplicated-count": sum(duplicated.values()),
        "read-count": len(reads),
    }


def _scan_ops(h: History):
    """Event scan over dict ops: adds + read views with chain/increment
    compression (see _analyze_columnar's docstring). Returns
    (adds, r_ri, r_rt, r_ok, views, payloads, anchor, mono)."""
    adds: dict = {}    # x -> [add_invoke, add_type, first_ok_idx, ok_time]
    r_ri: list = []          # read invoke index
    r_rt: list = []          # read invoke time
    r_ok: list = []          # read ok index
    views: list = []         # raw per-read value lists
    payloads: list = []      # full list (anchor read) or new-element tail
    anchor: list = []        # True: payload is the read's full value set
    prev: list = []
    mono = True              # r_ok ascending in scan order
    last_ok = None
    for op in h:
        f = op.get("f")
        if f == "add":
            if not isinstance(op.get("process"), int):
                continue
            x = op.get("value")
            if type(x) is not int:
                raise _NonColumnar
            rec = adds.get(x)
            if rec is None:
                rec = adds[x] = [None, None, None, 0]
            t = op.get("type")
            if t == "invoke":
                rec[0] = op["index"]
            else:
                rec[1] = t
                if t == "ok" and rec[2] is None:
                    rec[2] = op["index"]   # first :ok completion
                    rec[3] = op.get("time") or 0
        elif f == "read" and op.get("type") == "ok":
            v = op.get("value")
            if v is None or not isinstance(op.get("process"), int):
                continue
            vals = v if type(v) is list else list(v)
            # chain detection: a growing set means consecutive reads
            # share their prefix, and list == compares shared int
            # objects by identity at C speed — only the tail of new
            # elements ever needs numpy conversion
            lp = len(prev)
            if views and len(vals) >= lp and vals[:lp] == prev:
                payloads.append(vals[lp:])
                anchor.append(False)
            else:
                inc = _increment_of(prev, vals) if views else None
                if inc is not None:
                    payloads.append(inc)
                    anchor.append(False)
                else:
                    payloads.append(vals)
                    anchor.append(True)
            prev = vals
            views.append(vals)
            # graftlint: ignore[COL002] reference dict sweep: the guarded fallback behind _NonColumnar
            inv = h.invocation(op)
            oki = op["index"]
            if last_ok is not None and oki < last_ok:
                mono = False
            last_ok = oki
            r_ri.append(inv["index"] if inv is not None else oki)
            r_rt.append((inv if inv is not None else op).get("time") or 0)
            r_ok.append(oki)
    return adds, r_ri, r_rt, r_ok, views, payloads, anchor, mono


class ColumnScan:
    """Resumable form of the columnar event scan: ``feed`` OpColumns
    chunks as generation proceeds (the streaming set path — the
    incremental half of the running-max presence pipeline); ``finish``
    returns the same (adds, r_ri, r_rt, r_ok, views, payloads, anchor,
    mono) tuple one pass over the complete columns produces. Open
    invocations carry their (index, time) across chunk boundaries, and
    chain detection's ``prev`` view spans chunks unchanged, so chunked
    feeding is bit-identical to the one-shot scan (``_scan_columns``
    is now just the one-shot wrapper). ``feed`` raises _NonColumnar
    exactly where the one-shot scan would; the streaming driver treats
    that as stream invalidation while post-hoc callers fall back to
    the reference sweep as before."""

    __slots__ = ("adds", "r_ri", "r_rt", "r_ok", "views", "payloads",
                 "anchor", "prev", "mono", "last_ok", "open_by",
                 "n_rows")

    def __init__(self):
        self.adds: dict = {}
        self.r_ri: list = []
        self.r_rt: list = []
        self.r_ok: list = []
        self.views: list = []
        self.payloads: list = []
        self.anchor: list = []
        self.prev: list = []
        self.mono = True
        self.last_ok = None
        self.open_by: dict = {}   # process code -> (invoke idx, time)
        self.n_rows = 0           # total column rows consumed

    def feed(self, cols) -> None:
        self.n_rows += len(cols)
        adds = self.adds
        r_ri, r_rt, r_ok = self.r_ri, self.r_rt, self.r_ok
        views, payloads, anchor = self.views, self.payloads, self.anchor
        prev = self.prev
        mono = self.mono
        last_ok = self.last_ok
        open_by = self.open_by
        tc = cols.type_code.tolist()
        pr = cols.proc.tolist()
        fcl = cols.f_code.tolist()
        ft = cols.f_table
        idx = cols.index.tolist()
        tm = cols.time.tolist()
        vals_col = cols.values
        pt = cols.proc_table
        try:
            for i, t in enumerate(tc):
                p = pr[i]
                if t == 0:
                    open_by[p] = (idx[i], tm[i])
                    inv = None
                else:
                    inv = open_by.pop(p, None)
                f = ft[fcl[i]]
                if f == "add":
                    if p < 0 and not isinstance(pt[-1 - p], int):
                        continue
                    x = vals_col[i]
                    if type(x) is not int:
                        raise _NonColumnar
                    rec = adds.get(x)
                    if rec is None:
                        rec = adds[x] = [None, None, None, 0]
                    if t == 0:
                        rec[0] = idx[i]
                    else:
                        rec[1] = TYPE_NAMES[t]
                        if t == 1 and rec[2] is None:
                            rec[2] = idx[i]    # first :ok completion
                            rec[3] = tm[i] or 0
                elif f == "read" and t == 1:
                    v = vals_col[i]
                    if v is None or (p < 0
                                     and not isinstance(pt[-1 - p], int)):
                        continue
                    vals = v if type(v) is list else list(v)
                    lp = len(prev)
                    if views and len(vals) >= lp and vals[:lp] == prev:
                        payloads.append(vals[lp:])
                        anchor.append(False)
                    else:
                        inc = _increment_of(prev, vals) if views else None
                        if inc is not None:
                            payloads.append(inc)
                            anchor.append(False)
                        else:
                            payloads.append(vals)
                            anchor.append(True)
                    prev = vals
                    views.append(vals)
                    oki = idx[i]
                    if last_ok is not None and oki < last_ok:
                        mono = False
                    last_ok = oki
                    r_ri.append(inv[0] if inv is not None else oki)
                    r_rt.append((inv[1] if inv is not None
                                 else tm[i]) or 0)
                    r_ok.append(oki)
        finally:
            self.prev = prev
            self.mono = mono
            self.last_ok = last_ok

    def finish(self):
        return (self.adds, self.r_ri, self.r_rt, self.r_ok, self.views,
                self.payloads, self.anchor, self.mono)


def _scan_columns(cols):
    """_scan_ops over SoA columns (core/history.py OpColumns): the same
    event scan fed from typed arrays and intern tables — no per-op dict
    access, and read invocations pair by an inline per-process walk
    instead of History.pairs (which would materialize dict ops on a
    column-only history). One-shot wrapper of :class:`ColumnScan`."""
    s = ColumnScan()
    s.feed(cols)
    return s.finish()


def _analyze_columnar(h: History, _scan=None) -> dict:
    """Vectorized analyze(): element x read presence matrix in numpy.

    The host floor for set histories is the read payload: ~24k ops
    carry ~15M observed values, and converting (or even type-checking)
    every one costs more than the whole analysis budget. The pipeline
    dodges the floor structurally: a growing set means consecutive
    views share their prefix (compared by C-level list ==, which
    short-circuits and compares shared int objects by identity) or
    differ by a few insertions (_increment_of), so only arrival events
    — new elements — are ever converted; runs of identical views
    collapse into one presence row. Known points come from a reversed
    first-arrival scatter, coverage from one broadcast compare of
    known indices against invoke indices, and presence from a single
    running-max fill over the row axis.

    Exactness contract with the sweep: element values must be plain
    ints (floats/Decimals/ad-hoc objects raise _NonColumnar and take
    the sweep; bools alias their int values exactly as Python == does
    in the sweep's set arithmetic). Histories the fast algebra cannot
    express exactly — duplicate observations, reads that miss covered
    elements, out-of-order ok indices — retry in full mode with one
    row per read, which is bit-identical to the sweep by the
    differential fuzz in tests/test_set.py."""
    if _scan is not None:
        scan = _scan
    else:
        cols = getattr(h, "columns", None)
        if cols is not None:
            scan = _scan_columns(cols)
        else:
            scan = _scan_ops(h)
    adds, r_ri, r_rt, r_ok, views, payloads, anchor, mono = scan
    nR = len(r_ok)

    def _to_i64(vals: list) -> np.ndarray:
        # sum() walks the list at C speed and its result type exposes
        # any float/Decimal/np-scalar contamination that np.asarray
        # with a fixed dtype would silently truncate; non-numerics
        # raise TypeError. (Bools alias their int values exactly as
        # Python == does in the sweep's set arithmetic.)
        if vals:
            try:
                if type(sum(vals)) not in (int, bool):
                    raise _NonColumnar
            except TypeError:
                raise _NonColumnar
        try:
            return np.asarray(vals, dtype=np.int64)
        except (OverflowError, ValueError, TypeError):
            raise _NonColumnar   # ints beyond int64 etc.: sweep handles

    try:
        add_arr = np.fromiter(adds.keys(), dtype=np.int64, count=len(adds))
    except OverflowError:
        raise _NonColumnar
    BIG = np.int64(2) ** 62
    r_ok_a = np.array(r_ok, dtype=np.int64)
    r_ri_a = np.array(r_ri, dtype=np.int64)
    r_rt_a = np.array(r_rt, dtype=np.int64)

    # ---- event pipeline -------------------------------------------------
    # Rows are distinct presence states, not reads: in chain mode a run
    # of consecutive reads with identical views (empty tails) shares one
    # row — the store only changes when an add commits, so reads
    # outnumber distinct views. Coverage per row uses the run's widest
    # invoke (miss detection is monotone in the invoke index), which is
    # exact for the miss/no-miss verdict; any actual miss — and any
    # duplicate, whose accounting is per read — retries in full mode
    # with one row per read. Out-of-order ok indices skip chain mode.
    use_chain = mono
    duplicated: dict = {}
    lens_read = np.fromiter(map(len, views), dtype=np.int64, count=nR)
    while True:
        if use_chain:
            plens_pay = np.fromiter(map(len, payloads), dtype=np.int64,
                                    count=nR)
            anchor_np = np.asarray(anchor, dtype=bool)
            hf = anchor_np | (plens_pay > 0)     # run heads
            if nR:
                hf[0] = True
            heads = np.flatnonzero(hf)
            nrows = len(heads)
            row_of_read = (np.cumsum(hf) - 1) if nR else heads
            parrs = [_to_i64(payloads[r]) for r in heads.tolist()]
            anchor_rows = anchor_np[heads]
            row_ok = r_ok_a[heads]
            row_rt = r_rt_a[heads]
            row_ri = np.maximum.reduceat(r_ri_a, heads) if nrows \
                else r_ri_a
        else:
            nrows = nR
            row_of_read = np.arange(nR, dtype=np.int64)
            parrs = [_to_i64(vals) for vals in views]
            anchor_rows = np.ones(nR, dtype=bool)
            row_ok = r_ok_a
            row_rt = r_rt_a
            row_ri = r_ri_a
        plens = np.fromiter(map(len, parrs), dtype=np.int64, count=nrows)
        total = int(plens.sum()) if nrows else 0
        flat = np.concatenate(parrs) if total else np.zeros(
            0, dtype=np.int64)
        rid = np.repeat(np.arange(nrows, dtype=np.int64), plens)

        # element universe: everything added + everything ever
        # observed (chain prefixes are == earlier events, so events
        # alone span it). Small non-negative domains — every real
        # workload: elements are a dense counter — get an O(domain)
        # lookup table; anything else one global sort + searchsorted.
        if total or len(add_arr):
            allv = np.concatenate([flat, add_arr])
            lo = int(allv.min())
            hi = int(allv.max())
            if 0 <= lo and hi < max(4 * allv.size, 1 << 16):
                mask = np.zeros(hi + 1, dtype=bool)
                mask[flat] = True
                mask[add_arr] = True
                uniq = np.flatnonzero(mask).astype(np.int64)
                lut = np.zeros(hi + 1, dtype=np.int64)
                lut[uniq] = np.arange(len(uniq), dtype=np.int64)
                eid = lut[flat]
                add_e = lut[add_arr]
            else:
                uniq = np.unique(allv)
                eid = np.searchsorted(uniq, flat)
                add_e = np.searchsorted(uniq, add_arr)
        else:
            uniq = np.zeros(0, dtype=np.int64)
            eid = np.zeros(0, dtype=np.int64)
            add_e = np.zeros(0, dtype=np.int64)
        E = len(uniq)

        # presence matrix. Chain rows forward-fill from the previous
        # row (anchors reset presence to their own set): present at
        # row r = last arrival row >= r's segment start, one running
        # max over the whole matrix instead of a per-segment loop.
        if nrows and E and not anchor_rows.all():
            A = np.full((nrows, E), -1, dtype=np.int32)
            if total:
                A[rid, eid] = rid
            np.maximum.accumulate(A, axis=0, out=A)
            seg0 = np.where(anchor_rows,
                            np.arange(nrows, dtype=np.int32),
                            np.int32(-1))
            np.maximum.accumulate(seg0, out=seg0)
            P = A >= seg0[:, None]
        else:
            P = np.zeros((nrows, E), dtype=bool)
            if total:
                P[rid, eid] = True

        # duplicate observations: a read with more values than its row
        # has distinct elements repeats one
        rowsum = P.sum(axis=1)
        dup_reads = np.flatnonzero(lens_read != rowsum[row_of_read])
        if dup_reads.size and use_chain:
            use_chain = False    # dup accounting is per read
            continue
        if dup_reads.size:
            starts = np.zeros(nR + 1, dtype=np.int64)
            np.cumsum(plens, out=starts[1:])
            dsum = np.zeros(E, dtype=np.int64)
            for r in dup_reads.tolist():
                u, c = np.unique(eid[starts[r]:starts[r + 1]],
                                 return_counts=True)
                dupm = c > 1
                dsum[u[dupm]] += c[dupm] - 1
            duplicated = {int(uniq[e]): int(dsum[e])
                          for e in np.flatnonzero(dsum)}

        # known points: first :ok add completion vs first observation
        # (min). First observation = the element's first arrival event
        # in :ok order; with ascending rows a reversed scatter keeps
        # the earliest write per element — no [rows, E] argmax pass.
        known_idx = np.full(E, BIG, dtype=np.int64)
        known_time = np.zeros(E, dtype=np.int64)
        if total:
            firstr = np.full(E, -1, dtype=np.int64)
            if mono:
                firstr[eid[::-1]] = rid[::-1]
            else:
                rnk = np.empty(nrows, dtype=np.int64)
                rnk[np.argsort(row_ok, kind="stable")] = np.arange(
                    nrows, dtype=np.int64)
                order = np.argsort(rnk[rid], kind="stable")
                firstr[eid[order][::-1]] = rid[order][::-1]
            seen = firstr >= 0
            known_idx[seen] = row_ok[firstr[seen]]
            known_time[seen] = row_rt[firstr[seen]]
        if adds:
            big = int(BIG)
            ok_i = np.fromiter((big if rec[2] is None else rec[2]
                                for rec in adds.values()),
                               dtype=np.int64, count=len(adds))
            ok_t = np.fromiter((rec[3] for rec in adds.values()),
                               dtype=np.int64, count=len(adds))
            has_ok = ok_i < BIG
            e_ok = add_e[has_ok]
            better = ok_i[has_ok] < known_idx[e_ok]
            known_idx[e_ok[better]] = ok_i[has_ok][better]
            known_time[e_ok[better]] = ok_t[has_ok][better]

        # coverage: miss = covered (known before invoke) but not present
        if use_chain:
            # row-wise miss detection only — exact because a collapsed
            # run's widest invoke dominates; per-read absent counts are
            # all zero whenever no row misses
            if nrows:
                K = known_idx[None, :] < row_ri[:, None]
                if (K & ~P).any():
                    use_chain = False
                    continue     # real misses: redo with per-read rows
            absent_count = np.zeros(E, dtype=np.int64)
            absent_last = np.zeros(E, dtype=bool)
            covered = (known_idx < int(r_ri_a.max())) if nR \
                else np.zeros(E, dtype=bool)
            stale_until = np.zeros(E, dtype=np.int64)
        elif nR:
            if np.any(np.diff(r_ri_a) < 0):
                order_inv = np.argsort(r_ri_a, kind="stable")
                Pi = P[order_inv]
                ri_s = r_ri_a[order_inv]
                rt_s = r_rt_a[order_inv]
            else:
                Pi, ri_s, rt_s = P, r_ri_a, r_rt_a
            K = known_idx[None, :] < ri_s[:, None]      # [nR, E]
            miss = K & ~Pi
            absent_count = miss.sum(axis=0)
            absent_last = miss[-1]
            covered = K[-1]
            # stale transition: absent in the previous covering read,
            # back in this one; rows before anything is known have no
            # coverage, so their all-False miss rows make the shifted
            # AND exact. Only columns with absences can transition.
            stale_until = np.zeros(E, dtype=np.int64)
            if nR > 1:
                cols = np.flatnonzero(absent_count)
                if cols.size:
                    trans = miss[:-1][:, cols] & Pi[1:][:, cols]
                    ht = trans.any(axis=0)
                    ft = np.argmax(trans, axis=0) + 1
                    stale_until[cols[ht]] = rt_s[ft[ht]]
        else:
            absent_count = np.zeros(E, dtype=np.int64)
            absent_last = np.zeros(E, dtype=bool)
            covered = np.zeros(E, dtype=bool)
            stale_until = np.zeros(E, dtype=np.int64)
        break

    # classification, elements in repr order like the sweep's report
    uvals = uniq.tolist()
    ki_l = known_idx.tolist()
    kt_l = known_time.tolist()
    ac_l = absent_count.tolist()
    al_l = absent_last.tolist()
    cov_l = covered.tolist()
    su_l = stale_until.tolist()
    big = int(BIG)
    order_repr = sorted(range(E), key=lambda e: repr(uvals[e]))
    stable, lost, never_read, stale, unknown = [], [], [], [], []
    stale_rows = []
    attempts = 0
    for e in order_repr:
        x = uvals[e]
        rec = adds.get(x)
        if rec is not None and rec[0] is not None:
            attempts += 1
        if ki_l[e] == big:
            at = rec[1] if rec is not None else None
            if at == "ok":
                never_read.append(x)     # confirmed added, never observed
            elif at in ("info", None):
                unknown.append(x)        # may never have happened
            # fail: definitely absent; ignore
            continue
        if al_l[e]:
            lost.append(x)               # still missing at the final read
        elif ac_l[e]:
            stale.append(x)
            stale_rows.append(
                {"element": x,
                 "stale-ns": su_l[e] - kt_l[e],
                 "absent-reads": ac_l[e]})
        elif not cov_l[e]:
            never_read.append(x)         # known but no read covered it
        else:
            stable.append(x)
    stale_rows.sort(key=lambda d: -d["stale-ns"])

    return {
        "attempt-count": attempts,
        "stable-count": len(stable),
        "lost": lost, "lost-count": len(lost),
        "stale": stale, "stale-count": len(stale),
        "worst-stale": stale_rows[:8],
        "never-read": never_read[:64], "never-read-count": len(never_read),
        "unknown-count": len(unknown),
        "duplicated": dict(sorted(duplicated.items(),
                                  key=lambda kv: repr(kv[0]))[:16]),
        "duplicated-count": sum(duplicated.values()),
        "read-count": nR,
    }


class SetFull(Checker):
    """checker/set-full analog; linearizable=True makes staleness illegal
    (set.clj:46 passes {:linearizable? true})."""

    def __init__(self, linearizable: bool = False):
        self.linearizable = linearizable

    def check(self, test, history, opts=None) -> dict:
        # streaming reuse: the runner installs a finished incremental
        # event scan on the test when it consumed the WHOLE history the
        # checker is now handed (row-count guard re-checked here); the
        # vectorized tail still runs below, so verdicts stay
        # bit-identical to the post-hoc path by construction
        from .core import stream_hint
        res = analyze(history, _scan=stream_hint(test, history,
                                                 "set_scan"))
        if res["read-count"] == 0:
            valid: Any = "unknown"
        elif res["lost-count"] or res["duplicated-count"] or (
                self.linearizable and res["stale-count"]):
            valid = False
        elif res["stable-count"] == 0 and res["attempt-count"] > 0:
            valid = "unknown"   # nothing confirmed either way
        else:
            valid = True
        return {"valid?": valid, "linearizable?": self.linearizable, **res}


def set_full(linearizable: bool = False) -> SetFull:
    return SetFull(linearizable=linearizable)
