"""Revisioned MVCC model of the store, built columnar-natively.

The consistency-surface checkers (checkers/mvcc.py) all need the same
substrate: *when could version v of key k have been current?* This
module builds that model in one pass over an ``OpColumns`` view —
per-key **version chains** (version -> the acked write's invoke/ok
interval), the **global revision counter** (acked write revisions),
and the **compaction watermark** ledger (acked compactions) — plus the
run's nemesis fault windows, so checkers can attribute an anomaly to
an open fault instead of calling it definite.

Soundness conventions (every checker rule leans on these):

- A write acked with version ``v`` committed somewhere inside its
  ``[invoke, ok]`` interval, so version ``v`` is *possibly current*
  from its write's invoke until the ok of the write acked ``v+1``
  (missing successor => unbounded). Timed-out (info) writes may have
  committed, so they appear in ``write_invokes`` (lower bounds) but
  never in chains (upper bounds) — unknowns always *widen* intervals.
- Sessions are process incarnations (jepsen: a crashed process never
  returns), so grouping by the ``proc`` column is the session model,
  exactly as in checkers/session.py. The lease model leans on this
  HARDER than the read rules do: ``_lease_sessions`` closes a proc's
  held lease at that same proc's next release invoke, which is only
  sound while proc == session — one incarnation never holds two
  leases, because a second acquire would have come from a NEW proc
  (timeouts retire the incarnation). Both sim epochs guarantee this
  by construction (lease lanes strictly alternate acquire/release,
  and every timeout bumps the proc); live etcd lease ids carry NO
  such guarantee (a real client can re-acquire under one process id),
  so the walk asserts the assumption and raises a diagnostic instead
  of silently merging two leases into one session span.

Times are the history's own clock (virtual ns in both generator
epochs); nothing here reads a wall clock.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

#: sentinel for "no upper bound" interval ends
T_INF = np.iinfo(np.int64).max


def history_columns(history):
    """The columnar view of a history, rebuilding one from a dict
    stream only when no columns exist (hand-built fixtures)."""
    cols = getattr(history, "columns", None)
    if cols is not None:
        return cols
    from .history import History, columns_of
    if isinstance(history, History):
        # graftlint: ignore[COL001] dict-only fallback — no columns exist yet, this path builds them
        ops = history.ops
    else:
        ops = list(history)
    return columns_of(ops)


def _int(v) -> Optional[int]:
    return int(v) if isinstance(v, (int, np.integer)) else None


class MvccModel:
    """One history's MVCC surface: version chains, revision ledger,
    compaction watermark, lease sessions, watch observations, fault
    windows. Built once, shared by every consistency checker."""

    __slots__ = ("chains", "write_invokes", "reads", "ranges",
                 "sessions", "watches", "revisions", "compactions",
                 "windows", "writes", "events")

    def __init__(self):
        #: key -> {"ver": int64[], "inv": int64[], "ok": int64[]}
        #: sorted by version (acked writes only)
        self.chains: dict = {}
        #: key -> sorted int64[] of ALL write invoke times (any
        #: outcome: an info write may have committed)
        self.write_invokes: dict = {}
        #: read observations: (idx, proc, key, version, inv, ok)
        self.reads: list = []
        #: range observations: (idx, proc, inv, ok, [(key, ver), ...])
        self.ranges: list = []
        #: lease sessions: (idx, proc, acq_inv, acq_ok, rel_inv|None)
        self.sessions: list = []
        #: watch observations: (idx, proc, from_rev, revs, gaps)
        self.watches: list = []
        #: acked global revisions (the revision counter's observed
        #: points), sorted
        self.revisions: np.ndarray = np.zeros(0, np.int64)
        #: compaction watermark ledger: (ok_time, revision) acks
        self.compactions: list = []
        #: nemesis fault windows [(open, close)], close may be T_INF
        self.windows: list = []
        self.writes = 0
        self.events = 0

    # -- construction --------------------------------------------------------

    @classmethod
    def from_columns(cls, cols) -> "MvccModel":
        m = cls()
        m.events = len(cols)
        ft = list(cols.f_table)
        vals = cols.values
        tc = cols.type_code
        times = cols.time
        proc = cols.proc
        fc = cols.f_code
        chains: dict = {}
        # invoke -> completion pairing drives every interval below
        for inv_i, cmp_i in cols.client_pairs():
            f = ft[fc[inv_i]]
            inv_t = int(times[inv_i])
            if f == "write":
                v_inv = vals[inv_i]
                if (isinstance(v_inv, (list, tuple)) and len(v_inv) == 3
                        and _int(v_inv[0]) is not None):
                    m.write_invokes.setdefault(
                        _int(v_inv[0]), []).append(inv_t)
            if cmp_i < 0 or tc[cmp_i] != 1:     # never completed / not ok
                continue
            v = vals[cmp_i]
            ok_t = int(times[cmp_i])
            p = int(proc[cmp_i])
            if f == "write":
                if not isinstance(v, (list, tuple)):
                    continue
                if len(v) == 3 and _int(v[0]) is not None \
                        and _int(v[1]) is not None:
                    # [key, version, value]: a version-chain link
                    chains.setdefault(_int(v[0]), []).append(
                        (_int(v[1]), inv_t, ok_t))
                    m.writes += 1
                elif len(v) == 2 and _int(v[0]) is not None:
                    # [revision, value]: a revision-counter observation
                    m.revisions = np.append(m.revisions, _int(v[0]))
                    m.writes += 1
            elif f == "read":
                if (isinstance(v, (list, tuple)) and len(v) == 3
                        and _int(v[0]) is not None
                        and _int(v[1]) is not None):
                    m.reads.append((int(cols.index[cmp_i]), p,
                                    _int(v[0]), _int(v[1]), inv_t, ok_t))
            elif f == "range":
                if isinstance(v, (list, tuple)):
                    pairs = [( _int(e[0]), _int(e[1]))
                             for e in v
                             if isinstance(e, (list, tuple))
                             and len(e) >= 2 and _int(e[0]) is not None
                             and _int(e[1]) is not None]
                    if pairs:
                        m.ranges.append((int(cols.index[cmp_i]), p,
                                         inv_t, ok_t, pairs))
            elif f == "compact":
                r = _int(v)
                if r is not None:
                    m.compactions.append((ok_t, r))
            elif f == "watch":
                if isinstance(v, dict) and _int(v.get("from")) is not None:
                    revs = [r for r in (v.get("revs") or [])
                            if _int(r) is not None]
                    gaps = [(int(g[0]), int(g[1]))
                            for g in (v.get("gaps") or [])
                            if isinstance(g, (list, tuple))
                            and len(g) == 2]
                    m.watches.append((int(cols.index[cmp_i]), p,
                                      _int(v["from"]), revs, gaps))
        for k, links in chains.items():
            links.sort()
            # host-side numpy only: per-key chains are tiny and never
            # cross a device boundary
            arr = np.array(links, np.int64).reshape(len(links), 3)
            m.chains[k] = {"ver": arr[:, 0], "inv": arr[:, 1],
                           "ok": arr[:, 2]}
        for k in m.write_invokes:
            m.write_invokes[k] = np.sort(
                np.array(m.write_invokes[k], np.int64))
        m.revisions = np.unique(m.revisions)
        m.windows = _fault_windows(cols)
        # lease sessions: per-proc acquire/release state machine (one
        # ordered pass; rows are already in history order)
        m.sessions = _lease_sessions(cols)
        return m

    @classmethod
    def of_history(cls, history) -> Optional["MvccModel"]:
        cols = history_columns(history)
        return None if cols is None else cls.from_columns(cols)

    # -- version-chain queries ----------------------------------------------

    def chain_link(self, key: int, version: int):
        """``(inv, ok)`` of the acked write of ``version`` on ``key``,
        or None if that write never acked (unknown commit point)."""
        ch = self.chains.get(key)
        if ch is None:
            return None
        i = int(np.searchsorted(ch["ver"], version))
        if i >= len(ch["ver"]) or int(ch["ver"][i]) != version:
            return None
        return int(ch["inv"][i]), int(ch["ok"][i])

    def version_window(self, key: int, version: int) -> tuple:
        """The possibly-current interval of (key, version): from the
        version's write invoke (0 for version 0) to the ok of the
        acked successor write (T_INF when the successor is unknown) —
        unknowns widen, so intersecting these windows is sound."""
        if version <= 0:
            lo = 0
        else:
            link = self.chain_link(key, version)
            lo = 0 if link is None else link[0]
        nxt = self.chain_link(key, version + 1)
        hi = T_INF if nxt is None else nxt[1]
        return lo, hi

    def writes_invoked_before(self, key: int, t: int) -> int:
        """How many writes on ``key`` had invoked by time ``t`` (any
        outcome) — the ceiling on any version readable at ``t``."""
        w = self.write_invokes.get(key)
        if w is None:
            return 0
        return int(np.searchsorted(w, t, side="right"))

    # -- compaction / fault-window queries -----------------------------------

    def horizon(self) -> int:
        """Highest acked compaction revision (0 = never compacted)."""
        return max((r for _, r in self.compactions), default=0)

    def window_overlaps(self, lo: int, hi: int) -> bool:
        """Did any fault window intersect ``[lo, hi]``? Checkers use
        this to excuse anomalies a fault can legitimately cause."""
        return any(w_lo <= hi and lo <= w_hi
                   for w_lo, w_hi in self.windows)


#: epoch-v1 process-fault op names (nemesis/faults.py
#: _process_package): onset/heal pairs that don't follow the
#: start-<kind>/stop-<kind> convention the batched generator uses
_V1_ONSETS = {"kill": "kill", "pause": "pause"}
_V1_HEALS = {"start": "kill", "resume": "pause"}


def _fault_windows(cols) -> list:
    """Nemesis windows from fault onset/heal rows, widened to the
    whole burst (first onset .. last heal): wider windows only ever
    excuse more, which is the sound direction. Both generator epochs'
    vocabularies are recognized: ``start-<kind>``/``stop-<kind>``
    (epoch-v2, and epoch-v1 network faults) plus epoch-v1's
    ``kill``/``start`` and ``pause``/``resume`` process faults."""
    ft = list(cols.f_table)
    fc = cols.f_code
    times = cols.time
    by_kind: dict = {}
    for i in range(len(cols)):
        f = ft[fc[i]]
        if f.startswith("start-"):
            by_kind.setdefault(f[6:], []).append((int(times[i]), True))
        elif f.startswith("stop-"):
            by_kind.setdefault(f[5:], []).append((int(times[i]), False))
        elif f in _V1_ONSETS:
            by_kind.setdefault(_V1_ONSETS[f], []).append(
                (int(times[i]), True))
        elif f in _V1_HEALS:
            by_kind.setdefault(_V1_HEALS[f], []).append(
                (int(times[i]), False))
    windows = []
    for rows in by_kind.values():
        rows.sort()
        cur_open = None
        last_stop = None
        for t, is_start in rows:
            if is_start:
                if cur_open is not None and last_stop is not None:
                    windows.append((cur_open, last_stop))
                    cur_open, last_stop = t, None
                elif cur_open is None:
                    cur_open = t
            else:
                last_stop = t
        if cur_open is not None:
            windows.append((cur_open,
                            last_stop if last_stop is not None else T_INF))
    windows.sort()
    return windows


def _lease_sessions(cols) -> list:
    """Acquire/release spans per session: ``(idx, proc, acq_inv,
    acq_ok, rel_inv|None)`` for every acked acquire, closed by the
    same proc's next release *invoke* (the client stops claiming the
    lock the instant it asks to release — outcome irrelevant)."""
    ft = list(cols.f_table)
    if "acquire" not in ft:
        return []
    fc = cols.f_code
    tc = cols.type_code
    times = cols.time
    proc = cols.proc
    acq = ft.index("acquire")
    rel = ft.index("release") if "release" in ft else -1
    open_inv: dict = {}         # proc -> pending acquire invoke time
    held: dict = {}             # proc -> open session list ref
    out: list = []
    for i in range(len(cols)):
        p = int(proc[i])
        if p < 0:
            continue
        f = fc[i]
        t = int(times[i])
        if f == acq:
            if tc[i] == 0:
                open_inv[p] = t
            elif tc[i] == 1:
                if p in held:
                    # proc==session assumption violated: this proc
                    # acked a second acquire while its first lease was
                    # still open (no intervening release invoke). True
                    # in both sim epochs by construction; live etcd
                    # lease ids can re-acquire under one process id,
                    # which this model cannot attribute — refuse
                    # loudly rather than merge two leases into one
                    # session span (module docstring, soundness
                    # conventions).
                    raise ValueError(
                        "lease session model requires proc==session: "
                        f"proc {p} acked acquire at row "
                        f"{int(cols.index[i])} while already holding "
                        f"a lease (acquired at row {held[p][0]}) — "
                        "histories with per-process lease re-acquire "
                        "(live etcd lease ids) need fresh procs per "
                        "acquire before the MVCC lease checkers apply")
                inv_t = open_inv.pop(p, t)
                sess = [int(cols.index[i]), p, inv_t, t, None]
                held[p] = sess
                out.append(sess)
            else:
                open_inv.pop(p, None)
        elif f == rel and tc[i] == 0:
            sess = held.pop(p, None)
            if sess is not None:
                sess[4] = t
    return [tuple(s) for s in out]
