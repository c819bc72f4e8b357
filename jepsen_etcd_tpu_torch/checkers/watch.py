"""Watch checker: all watchers saw the same values in the same order
(the port of the reference's ``checkers/watch.py``, same verdict logic,
dict keys and ordering).

Re-design of the Clojure checker (watch.clj:274-357):

- group ok ``watch``/``final-watch`` ops by *thread* (``process mod
  concurrency`` — processes recycle onto threads, watch.clj:281-282) and
  concatenate their observed value logs;
- pick a canonical log: the most common log, else the longest
  (watch.clj:304-318);
- any thread whose log differs (nonzero edit distance, computed by the
  wavefront kernel on the card, ops/edit_distance.py) is a delta ->
  invalid;
- threads that recorded a compaction gap (final-watch restarted past the
  compact horizon, watch.clj:243-267 semantics) are held to a weaker but
  still sound standard: their log must be an in-order subsequence of
  canonical and every canonical value they missed must have a revision
  inside one of their recorded gap windows — omissions are forgiven
  only where compaction provably destroyed the events;
- any ``nonmonotonic-watch`` error in history -> invalid
  (watch.clj:320-326, 347-350);
- if threads' final revisions are unequal the test didn't converge, so
  missing entries prove nothing: verdict :unknown (watch.clj:348-351).
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Optional

from ..core.history import History
from ..device import resolve_device
from ..ops.edit_distance import edit_distance_batch, diff_report
from .core import Checker


def per_thread_watches(test, history) -> dict:
    conc = test.get("concurrency", 1) if isinstance(test, dict) else 1
    h = history if isinstance(history, History) else History(history)
    out: dict = defaultdict(list)
    for op in h.client_ops():
        if op.is_ok and op.get("f") in ("watch", "final-watch"):
            out[op["process"] % conc].append(op)
    return dict(out)


def per_thread_logs(test, history) -> dict:
    return {thread: [v for op in ops
                     for v in ((op.value or {}).get("log") or [])]
            for thread, ops in per_thread_watches(test, history).items()}


def per_thread_revs(test, history) -> dict:
    """Per-thread event-revision logs (parallel to per_thread_logs)."""
    return {thread: [r for op in ops
                     for r in ((op.value or {}).get("revs") or [])]
            for thread, ops in per_thread_watches(test, history).items()}


def per_thread_gaps(test, history) -> dict:
    """Per-thread compaction-gap windows [(from_rev, to_rev], ...]: the
    unobservable window recorded when a final-watch restarted past the
    compact horizon (watch.clj:243-267 semantics)."""
    return {thread: [tuple(g) for op in ops
                     for g in ((op.value or {}).get("gaps") or [])]
            for thread, ops in per_thread_watches(test, history).items()}


def is_subsequence(sub: list, seq: list) -> bool:
    it = iter(seq)
    return all(any(x == y for y in it) for x in sub)


def per_thread_revisions(test, history) -> dict:
    return {thread: max([(op.value or {}).get("revision", 0)
                         for op in ops] + [0])
            for thread, ops in per_thread_watches(test, history).items()}


def canonical_log(logs: list) -> list:
    """The mode log if one repeats, else the longest (watch.clj:304-318)."""
    if not logs:
        return []
    counts = Counter(tuple(l) for l in logs)
    (top, freq), = counts.most_common(1)
    if freq > 1:
        return list(top)
    return max(logs, key=len)


class WatchChecker(Checker):
    """``use_tpu`` is the reference's tri-state, passed on as
    ``force_device``: True forces the device, False the Python DP, None
    picks by log length. ``device`` is where the wavefront runs:
    ``cuda`` unless the caller passes another (``"cpu"`` runs its plain
    version)."""

    def __init__(self, use_tpu: Optional[bool] = None, device=None):
        self.use_tpu = use_tpu
        self.device = resolve_device(device)

    def check(self, test, history, opts=None) -> dict:
        h = history if isinstance(history, History) else History(history)
        logs = per_thread_logs(test, h)
        revs = per_thread_revs(test, h)
        gaps = per_thread_gaps(test, h)
        revisions = per_thread_revisions(test, h)
        full = sorted(t for t in logs if not gaps.get(t))
        gapped = sorted(t for t in logs if gaps.get(t))
        # canonical from complete logs when any exist: a gapped log is
        # legitimately missing its compacted window and must not define
        # the consensus. With EVERY thread gapped, no single log can
        # serve (each may be missing values another saw outside its own
        # window) — merge all observations by server revision instead
        if full:
            canonical = canonical_log([logs[t] for t in full])
        else:
            by_rev: dict = {}
            for t in gapped:
                for v, r in zip(logs[t], revs.get(t, [])):
                    by_rev.setdefault(r, v)
            canonical = [v for _, v in sorted(by_rev.items())]
        deltas = []
        dists = edit_distance_batch(canonical, [logs[t] for t in full],
                                    force_device=self.use_tpu,
                                    device=self.device)
        for thread, ed in zip(full, dists):
            if ed:
                deltas.append({"thread": thread, "edit-distance": ed,
                               "diff": diff_report(canonical,
                                                   logs[thread])})
        # a gapped thread may omit exactly the values that fell inside a
        # recorded compaction window — everything it DID see must still
        # be in canonical order, and every canonical value it missed
        # must be attributable to a gap. Attribution is by OCCURRENCE
        # (value, revision), not a first-seen value->rev map: were the
        # same value ever written twice, a miss of the later occurrence
        # must be judged against ITS revision, not the earlier one's.
        value_revs: dict = defaultdict(set)
        for t in logs:
            for v, r in zip(logs[t], revs.get(t, [])):
                value_revs[v].add(r)
        sorted_revs = {v: sorted(rs) for v, rs in value_revs.items()}

        def canonical_occurrence_revs():
            nth: Counter = Counter()
            out = []
            for v in canonical:
                rl = sorted_revs.get(v)
                k = nth[v]
                nth[v] += 1
                out.append(rl[min(k, len(rl) - 1)] if rl else None)
            return out

        crevs = canonical_occurrence_revs()
        ccount = Counter(canonical)
        dup_values = any(c > 1 for c in ccount.values())

        def greedy_missing(thread, reverse=False):
            have: Counter = Counter(logs[thread])
            taken: Counter = Counter()
            pairs = list(zip(canonical, crevs))
            if reverse:
                pairs = pairs[::-1]
            out = []
            for v, r in pairs:
                if taken[v] < have[v]:
                    taken[v] += 1
                else:
                    out.append((v, r))
            return out[::-1] if reverse else out

        def unattributed_of(thread, pairs):
            return [v for v, r in pairs
                    if r is None or not any(lo < r <= hi
                                            for lo, hi in gaps[thread])]

        for thread in gapped:
            trevs = revs.get(thread, [])
            missing_pairs = []
            indefinite = False
            if len(trevs) == len(logs[thread]):
                # match by the thread's OWN recorded (value, revision)
                # pairs: a thread that saw only the LATER of two writes
                # of the same value must have the EARLIER occurrence
                # marked missing (attributable to its gap), not the
                # later one
                avail: Counter = Counter(zip(logs[thread], trevs))
                for v, r in zip(canonical, crevs):
                    if avail[(v, r)] > 0:
                        avail[(v, r)] -= 1
                    else:
                        missing_pairs.append((v, r))
            else:
                # no per-event revisions recorded: greedy value-count
                # matching (exact while the workload writes unique
                # values). With duplicate values the start-anchored
                # assignment can hand a sighting to the wrong
                # occurrence, so also try the end-anchored one; if
                # neither attributes every miss to a gap, the evidence
                # is ambiguous — downgrade to indefinite rather than
                # report a possibly-false violation
                missing_pairs = greedy_missing(thread)
                if dup_values and unattributed_of(thread, missing_pairs):
                    alt = greedy_missing(thread, reverse=True)
                    if len(unattributed_of(thread, alt)) < \
                            len(unattributed_of(thread, missing_pairs)):
                        missing_pairs = alt
                    rest = unattributed_of(thread, missing_pairs)
                    # only assignment ambiguity is indefinite: a missed
                    # value is reassignable only when canonical repeats
                    # it AND the thread sighted it at least once —
                    # otherwise every occurrence is missing under every
                    # assignment and the miss is determined, so it
                    # stays a definite violation
                    have: Counter = Counter(logs[thread])
                    if rest and all(ccount[v] > 1 and have[v] > 0
                                    for v in rest):
                        indefinite = True
            unattributed = unattributed_of(thread, missing_pairs)
            if not is_subsequence(logs[thread], canonical) or unattributed:
                delta = {"thread": thread,
                         "edit-distance": len(unattributed) or 1,
                         "gaps": gaps[thread],
                         "unattributed-missing": unattributed[:32],
                         "diff": diff_report(canonical,
                                             logs[thread])}
                # out-of-order sightings stay definite violations even
                # under duplicate values; only pure attribution
                # ambiguity is indefinite
                if indefinite and is_subsequence(logs[thread], canonical):
                    delta["indefinite"] = True
                deltas.append(delta)
        deltas.sort(key=lambda d: -d["edit-distance"])
        nm_errors = [op["error"] for op in h
                     if isinstance(op.get("error"), (list, tuple))
                     and op["error"] and op["error"][0] == "nonmonotonic-watch"]
        definite_deltas = [d for d in deltas if not d.get("indefinite")]
        if nm_errors:
            valid = False
        elif len(set(revisions.values())) > 1:
            valid = "unknown"
        elif definite_deltas:
            valid = False
        elif deltas:
            valid = "unknown"
        else:
            valid = True
        out = {"valid?": valid, "revisions": revisions}
        if valid is not True:
            out.update({"logs": {t: l[:200] for t, l in logs.items()},
                        "canonical": canonical[:200],
                        "deltas": deltas[:8],
                        "nonmonotonic-errors": nm_errors[:8]})
        return out
