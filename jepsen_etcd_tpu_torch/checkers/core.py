"""The checker protocol and the composite/stat checkers (the port of the
reference's ``checkers/core.py``: ``Checker``, ``Compose`` with its
per-key batch entry, and ``Stats``).

Mirrors the jepsen.checker stack the reference composes at
``etcd.clj:128-141``. The reference's per-checker telemetry spans wait
for the port's telemetry layer, its ``stream_hint`` for a streaming
feed that produces hints.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Any, Optional

from ..core.history import History


class Checker:
    def check(self, test: Any, history, opts: Optional[dict] = None) -> dict:
        raise NotImplementedError


def _merge_valid(vals: list) -> Any:
    """jepsen merge-valid: false < unknown < true."""
    if any(v is False for v in vals):
        return False
    if any(v == "unknown" for v in vals):
        return "unknown"
    return True


class Compose(Checker):
    def __init__(self, checkers: dict):
        self.checkers = checkers

    def check(self, test, history, opts=None) -> dict:
        results = {name: c.check(test, history, opts)
                   for name, c in self.checkers.items()}
        return {"valid?": _merge_valid([r.get("valid?") for r in
                                        results.values()]),
                **results}

    def check_batch(self, test, subhistories: dict, opts=None) -> dict:
        """Per-key batch entry (called by checkers.Independent): children
        that are batch-aware (the device checker) get the whole key batch
        in one call; the rest run per key."""
        per_key: dict = {k: {} for k in subhistories}
        for name, c in self.checkers.items():
            if hasattr(c, "check_batch"):
                outs = c.check_batch(test, subhistories, opts)
            else:
                outs = {k: c.check(test, sub, opts)
                        for k, sub in subhistories.items()}
            for k, r in outs.items():
                per_key[k][name] = r
        return {k: {"valid?": _merge_valid([r.get("valid?")
                                            for r in rs.values()]), **rs}
                for k, rs in per_key.items()}


def compose(checkers: dict) -> Compose:
    return Compose(checkers)


class Stats(Checker):
    """checker/stats: ok/fail/info counts, per f (etcd.clj:131)."""

    def check(self, test, history, opts=None) -> dict:
        h = history if isinstance(history, History) else History(history)
        by_f: dict = defaultdict(Counter)
        total = Counter()
        for op in h.client_ops():
            if op.is_completion:
                by_f[op.f][op["type"]] += 1
                total[op["type"]] += 1
        # valid if every f had at least one ok (jepsen's heuristic:
        # a workload where some op class never succeeds is suspicious)
        valid = all(c.get("ok", 0) > 0 for c in by_f.values()) \
            if by_f else True
        return {"valid?": True if valid else "unknown",
                "count": sum(total.values()),
                "ok-count": total.get("ok", 0),
                "fail-count": total.get("fail", 0),
                "info-count": total.get("info", 0),
                "by-f": {f: dict(c) for f, c in by_f.items()}}
