"""Consistency-surface checkers over the MVCC model (core/mvcc.py).

Four weaker-than-linearizable surfaces, each with its own definite
verdict class and each regression-tested against a simbatch injection
that provably trips it (tests/test_mvcc.py):

- :class:`BoundedStaleness` — serializable reads must be *recent*:
  never from the future (``future-read``), monotone per session
  unless a fault window separates the two reads — a restarted or
  partitioned node legitimately serves its recovering snapshot
  (``nonmonotone-session``) — and within the staleness bound unless a
  fault window explains the lag (``stale-beyond-bound``; injection:
  ``inject_stale_snapshot``).
- :class:`SnapshotRanges` — a multi-key range must be a snapshot:
  the observed versions' possibly-current windows must share an
  instant (``torn-range``; injection: ``inject_torn_range``).
- :class:`LeaseChurn` — no two sessions certainly hold the lock at
  once: certain-hold windows are clipped by the lease TTL, so
  expired-lease re-grants (pause faults) are excused by construction
  (``double-grant``; injection: ``inject_double_grant``).
- :class:`CompactionWatch` — every event a watcher missed must be
  attributed to a recorded compaction gap or lie under the compaction
  horizon; anything else is definite (``lost-event``; injection:
  ``inject_compaction_swallow``).

Every rule leans on the model's widening convention (unknown commit
points stretch intervals), so a verdict of invalid is always definite
evidence — fault schedules can only ever *excuse*, never convict.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.mvcc import MvccModel, T_INF, history_columns
from ..runner import telemetry
from .core import Checker

#: violations reported per run (the rest are counted, not listed)
_MAX_REPORT = 8

#: default staleness bound (virtual seconds) when opts carry none
DEFAULT_STALENESS_BOUND_S = 8.0

#: default lease TTL (ms) when opts carry none — matches the
#: lock-lease workload's churn TTL
DEFAULT_LEASE_TTL_MS = 1500


def _model_of(history) -> Optional[MvccModel]:
    cols = history_columns(history)
    return None if cols is None else MvccModel.from_columns(cols)


def _result(violations: list, counted: dict) -> dict:
    telemetry.current().counter("mvcc.violations", len(violations))
    out = {"valid?": not violations}
    out.update(counted)
    if violations:
        out["violation-count"] = len(violations)
        out["violations"] = violations[:_MAX_REPORT]
    return out


class BoundedStaleness(Checker):
    """Reads carry ``[key, version, value]``; verify every ok read is
    plausible (not future), per-session monotone, and no staler than
    the bound unless a fault window overlaps the lag."""

    def __init__(self, bound_s: Optional[float] = None):
        self.bound_s = bound_s

    def check(self, test, history, opts: Optional[dict] = None) -> dict:
        m = _model_of(history)
        if m is None:
            return {"valid?": "unknown",
                    "error": "history has no columnar view"}
        bound_s = self.bound_s
        if bound_s is None:
            bound_s = (test or {}).get("staleness_bound_s") \
                or DEFAULT_STALENESS_BOUND_S
        bound_ns = int(float(bound_s) * 1e9)
        telemetry.current().counter("mvcc.reads", len(m.reads))
        telemetry.current().counter("mvcc.keys", len(m.chains))
        telemetry.current().counter("mvcc.writes", m.writes)
        violations: list = []
        excused = 0
        excused_nonmono = 0
        # (proc, key) -> (running max ver, its read's ok time)
        last_seen: dict = {}
        for idx, p, k, ver, inv_t, ok_t in m.reads:
            # future-read: version v needs >= v writes invoked by the
            # read's completion (info writes count — they may commit)
            if ver > m.writes_invoked_before(k, ok_t):
                violations.append({
                    "class": "future-read", "index": idx, "process": p,
                    "key": k, "version": ver,
                    "writes-invoked": m.writes_invoked_before(k, ok_t)})
                continue
            prior, prior_ok = last_seen.get((p, k), (-1, 0))
            if ver < prior:
                # a fault between the two reads excuses the regression:
                # a killed-and-restarted (or partitioned) node serves
                # its recovering snapshot until it catches up
                if m.window_overlaps(prior_ok, ok_t):
                    excused_nonmono += 1
                else:
                    violations.append({
                        "class": "nonmonotone-session", "index": idx,
                        "process": p, "key": k, "version": ver,
                        "prior-read-max": prior})
                continue
            last_seen[(p, k)] = (ver, ok_t)
            # stale-beyond-bound: the successor write completed more
            # than the bound before this read even started, and no
            # fault window can explain the replica lag
            nxt = m.chain_link(k, ver + 1)
            if nxt is not None and inv_t - nxt[1] > bound_ns:
                if m.window_overlaps(inv_t - bound_ns, inv_t):
                    excused += 1
                else:
                    violations.append({
                        "class": "stale-beyond-bound", "index": idx,
                        "process": p, "key": k, "version": ver,
                        "lag-ns": int(inv_t - nxt[1]),
                        "bound-ns": bound_ns})
        return _result(violations, {
            "reads": len(m.reads), "keys": len(m.chains),
            "writes": m.writes, "excused-stale": excused,
            "excused-nonmonotone": excused_nonmono,
            "bound-s": float(bound_s)})


class SnapshotRanges(Checker):
    """Ranges carry ``[[key, version], ...]``; verify each observed
    version vector admits a common instant (no torn ranges)."""

    def check(self, test, history, opts: Optional[dict] = None) -> dict:
        m = _model_of(history)
        if m is None:
            return {"valid?": "unknown",
                    "error": "history has no columnar view"}
        telemetry.current().counter("mvcc.ranges", len(m.ranges))
        violations: list = []
        for idx, p, inv_t, ok_t, pairs in m.ranges:
            lo, hi = 0, T_INF
            lo_k = hi_k = None
            for k, ver in pairs:
                w_lo, w_hi = m.version_window(k, ver)
                if w_lo > lo:
                    lo, lo_k = w_lo, (k, ver)
                if w_hi < hi:
                    hi, hi_k = w_hi, (k, ver)
            if lo > hi:
                violations.append({
                    "class": "torn-range", "index": idx, "process": p,
                    "newest": lo_k, "stalest": hi_k,
                    "window-ns": [int(lo), int(hi)]})
        return _result(violations, {
            "ranges": len(m.ranges), "keys": len(m.chains),
            "writes": m.writes})


class LeaseChurn(Checker):
    """No two sessions certainly hold the lock at once. A session
    certainly holds from its acquire-ok until ``min(release invoke,
    acquire invoke + TTL)`` — the lease countdown starts no earlier
    than the grant request, so the TTL clip never overshoots the real
    expiry, and an expired-lease re-grant is excused by construction."""

    def __init__(self, ttl_ms: Optional[float] = None):
        self.ttl_ms = ttl_ms

    def check(self, test, history, opts: Optional[dict] = None) -> dict:
        m = _model_of(history)
        if m is None:
            return {"valid?": "unknown",
                    "error": "history has no columnar view"}
        ttl_ms = self.ttl_ms
        if ttl_ms is None:
            ttl_ms = (test or {}).get("lease_ttl_ms") \
                or DEFAULT_LEASE_TTL_MS
        ttl_ns = int(float(ttl_ms) * 1e6)
        telemetry.current().counter("mvcc.grants", len(m.sessions))
        holds = []
        for idx, p, acq_inv, acq_ok, rel_inv in m.sessions:
            end = acq_inv + ttl_ns
            if rel_inv is not None:
                end = min(end, rel_inv)
            if end > acq_ok:
                holds.append((acq_ok, end, p, idx))
        holds.sort()
        violations: list = []
        prev_end, prev_p, prev_idx = -1, None, None
        for start, end, p, idx in holds:
            if start < prev_end:
                violations.append({
                    "class": "double-grant", "index": idx, "process": p,
                    "overlaps-process": prev_p,
                    "overlaps-index": prev_idx,
                    "overlap-ns": int(prev_end - start)})
            if end > prev_end:
                prev_end, prev_p, prev_idx = end, p, idx
        return _result(violations, {
            "grants": len(m.sessions), "holds": len(holds),
            "ttl-ms": float(ttl_ms)})


class CompactionWatch(Checker):
    """Watch ops carry ``{"from", "revs", "gaps"}``; every acked
    revision a watcher's span covers must be delivered, inside a
    recorded compaction gap, or under the compaction horizon
    (attributed) — anything else is a definite lost event."""

    def check(self, test, history, opts: Optional[dict] = None) -> dict:
        m = _model_of(history)
        if m is None:
            return {"valid?": "unknown",
                    "error": "history has no columnar view"}
        horizon = m.horizon()
        canonical = m.revisions
        telemetry.current().counter("mvcc.watches", len(m.watches))
        telemetry.current().counter("mvcc.compactions",
                                    len(m.compactions))
        violations: list = []
        delivered = 0
        gap_attributed = 0
        horizon_attributed = 0
        for idx, p, from_rev, revs, gaps in m.watches:
            delivered += len(revs)
            hi = max([from_rev] + revs + [g[1] for g in gaps])
            if hi <= from_rev:
                continue
            j0 = int(np.searchsorted(canonical, from_rev, side="right"))
            j1 = int(np.searchsorted(canonical, hi, side="right"))
            expected = canonical[j0:j1]
            seen = set(revs)
            for r in expected.tolist():
                if r in seen:
                    continue
                if any(g_lo < r <= g_hi for g_lo, g_hi in gaps):
                    gap_attributed += 1
                elif r <= horizon:
                    horizon_attributed += 1
                else:
                    violations.append({
                        "class": "lost-event", "index": idx,
                        "process": p, "revision": int(r),
                        "span": [int(from_rev), int(hi)],
                        "horizon": int(horizon)})
        telemetry.current().counter("mvcc.watch-events", delivered)
        return _result(violations, {
            "watches": len(m.watches), "events": delivered,
            "acked-revisions": int(len(canonical)),
            "compactions": len(m.compactions), "horizon": horizon,
            "gap-attributed": gap_attributed,
            "horizon-attributed": horizon_attributed})
