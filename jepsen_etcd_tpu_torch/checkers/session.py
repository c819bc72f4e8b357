"""Session-guarantee checker: monotone reads and writes-follow-reads,
one vectorized pass over OpColumns (the port of the reference's
``checkers/session.py``, the register workload's second checker).

Register histories carry ``[version, value]`` payloads, so two of the
classic session guarantees (Terry et al., PDIS 1994) reduce to
per-session version arithmetic — no search, no state-machine replay:

- **monotone reads**: successive reads in one session must observe
  non-decreasing versions (a read below the session's running read-max
  is a stale read).
- **writes-follow-reads**: a write acknowledged at version ``v`` was
  ordered after every write the session had already read, i.e. ``v``
  must exceed the session's prior read-max.

A *session* is one process incarnation (jepsen semantics: a crashed
process never returns — its thread continues as a NEW process, which is
exactly a new session), so grouping by the ``proc`` column is the whole
session model. Both guarantees then fall out of one segmented
running-max over completion versions: sort rows by (session, history
order), offset each group's versions into a disjoint band
(``gid * BAND``), and ``np.maximum.accumulate`` yields every row's
prior-read-max in O(n log n) with no Python loop over ops.

Weaker than linearizability — a history can pass here and still fail
the linear checker — but the pass is cheap enough to run on every
history, and it localizes *which session* observed the anomaly, which
a global linearizability verdict does not.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .core import Checker

#: per-group version band for the segmented running max; versions are
#: write counts per key and histories are far below this
_BAND = np.int64(2) ** 40

#: violations reported per run (the rest are counted, not listed)
_MAX_REPORT = 8


def _versions(cols) -> tuple:
    """Completion versions per row: ``(vers, is_read, is_write)`` with
    ``vers[i] = -1`` for rows that carry no version (invokes, infos,
    failed cas, non-register payloads)."""
    n = len(cols)
    vers = np.full(n, -1, np.int64)
    is_read = np.zeros(n, bool)
    is_write = np.zeros(n, bool)
    ft = list(cols.f_table)
    rd = ft.index("read") if "read" in ft else -1
    wr = ft.index("write") if "write" in ft else -1
    cs = ft.index("cas") if "cas" in ft else -1
    # version payloads exist only under the register schema ([version,
    # value] pairs); a history whose f table has reads but no
    # write/cas (e.g. the set workload, where a read's value is a
    # snapshot LIST) carries no versions to check
    if rd < 0 or (wr < 0 and cs < 0):
        return vers, is_read, is_write
    ok = cols.type_code == 1
    fc = cols.f_code
    cand = np.flatnonzero(ok & ((fc == rd) | (fc == wr) | (fc == cs)))
    vals = cols.values
    fcl = fc[cand].tolist()
    for i, f in zip(cand.tolist(), fcl):
        v = vals[i]
        if not isinstance(v, (list, tuple)) or not v:
            continue
        ver = v[0]
        if not isinstance(ver, (int, np.integer)):
            continue
        vers[i] = int(ver)
        if f == rd:
            is_read[i] = True
        else:
            is_write[i] = True
    return vers, is_read, is_write


class SessionGuarantees(Checker):
    """Monotone-reads + writes-follow-reads over version payloads."""

    def check(self, test, history, opts: Optional[dict] = None) -> dict:
        cols = getattr(history, "columns", None)
        if cols is None:
            # dict-only histories (hand-built test fixtures) have no
            # columnar view; the guarantees still apply, so rebuild one
            # from the dict stream rather than skipping the check
            from ..core.history import History, columns_of
            if isinstance(history, History):
                # graftlint: ignore[COL001] dict-only fallback — no columns exist yet, this path builds them
                ops = history.ops
            else:
                ops = list(history)
            cols = columns_of(ops)
            if cols is None:
                return {"valid?": "unknown",
                        "error": "history has no columnar view"}
        vers, is_read, is_write = _versions(cols)
        rows = np.flatnonzero(is_read | is_write)
        n_read = int(is_read.sum())
        if rows.size == 0 or n_read == 0:
            # no reads -> both guarantees hold vacuously: True, not
            # "unknown" (nothing was left unchecked)
            return {"valid?": True, "sessions": 0, "reads": n_read,
                    "writes": int(is_write.sum())}
        # sessions: (proc, key) groups — under the independent split
        # key_id is uniformly -1 and this degrades to proc alone
        proc = cols.proc[rows]
        kid = cols.key_id[rows]
        sess = np.unique(proc)
        pgid = np.searchsorted(sess, proc)
        kuniq = np.unique(kid)
        kgid = np.searchsorted(kuniq, kid)
        gid = pgid * len(kuniq) + kgid
        # segmented exclusive running max of READ versions, in history
        # order within each group: band-offset + maximum.accumulate
        order = np.argsort(gid, kind="stable")  # rows already time-sorted
        g = gid[order]
        v = vers[rows][order]
        r = is_read[rows][order]
        w = is_write[rows][order]
        banded = g * _BAND + np.where(r, v, -1)
        acc = np.maximum.accumulate(banded)
        prior = np.empty_like(acc)
        prior[0] = -1
        # acc[i-1] for a group's first row comes from an earlier group's
        # band, lands below g*_BAND, and clamps to "no prior read"
        prior[1:] = acc[:-1] - g[1:] * _BAND
        prior = np.maximum(prior, -1)
        mr_bad = r & (v < prior)
        wfr_bad = w & (v >= 0) & (v <= prior)
        bad = np.flatnonzero(mr_bad | wfr_bad)
        result = {
            "valid?": bad.size == 0,
            "sessions": int(len(sess)),
            "reads": n_read,
            "writes": int(is_write.sum()),
        }
        if bad.size:
            report = []
            for b in bad[:_MAX_REPORT].tolist():
                i = int(rows[order[b]])
                report.append({
                    "guarantee": ("monotone-reads" if mr_bad[b]
                                  else "writes-follow-reads"),
                    "index": int(cols.index[i]),
                    "process": cols.process_at(i),
                    "f": cols.f_table[cols.f_code[i]],
                    "version": int(v[b]),
                    "prior-read-max": int(prior[b]),
                })
            result["violation-count"] = int(bad.size)
            result["violations"] = report
        return result


def session_guarantees() -> SessionGuarantees:
    return SessionGuarantees()
