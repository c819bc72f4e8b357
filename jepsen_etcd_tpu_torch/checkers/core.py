"""The checker protocol and the composite/stat checkers.

Mirrors the jepsen.checker stack the reference composes at
``etcd.clj:128-141``: compose{perf, clock, stats, exceptions,
crash(log-file-pattern), workload-checker}.
"""

from __future__ import annotations

import re
from collections import Counter, defaultdict
from typing import Any, Optional

from ..core.history import History
from ..runner import telemetry


class Checker:
    def check(self, test: Any, history, opts: Optional[dict] = None) -> dict:
        raise NotImplementedError


def stream_hint(test: Any, history, name: str):
    """Fetch a streaming-precomputed artifact (runner/stream.py installs
    ``test["_stream"]`` = {name: (artifact, n_rows), ...}) if — and only
    if — it provably covers THIS history: the feed consumed exactly
    ``len(history)`` rows and the history still carries the columns the
    artifact was extracted from. Returns the artifact or None; hints
    are pure reuse, never a correctness dependency — a None simply
    means the checker recomputes from scratch."""
    hint = test.get("_stream") if isinstance(test, dict) else None
    if not hint or getattr(history, "columns", None) is None:
        return None
    got = hint.get(name)
    if got is None or got[1] != len(history):
        return None
    telemetry.current().counter(f"stream.{name}_reuse")
    return got[0]


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
        tel = telemetry.current()
        results = {}
        for name, c in self.checkers.items():
            with tel.span("checker:" + str(name)):
                results[name] = c.check(test, history, opts)
        return {"valid?": _merge_valid([r.get("valid?") for r in
                                        results.values()]),
                **results}

    def check_batch(self, test, subhistories: dict, opts=None) -> dict:
        """Per-key batch entry (called by checkers.Independent): children
        that are batch-aware (the TPU kernel) get the whole key batch in
        one call; the rest run per key."""
        tel = telemetry.current()
        per_key: dict = {k: {} for k in subhistories}
        for name, c in self.checkers.items():
            with tel.span("checker:" + str(name), keys=len(subhistories)):
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


class UnhandledExceptions(Checker):
    """checker/unhandled-exceptions: collect worker-crash errors
    (etcd.clj:133)."""

    def check(self, test, history, opts=None) -> dict:
        h = history if isinstance(history, History) else History(history)
        crashes = [dict(op) for op in h
                   if isinstance(op.get("error"), (list, tuple))
                   and len(op["error"]) == 2
                   and op["error"][0] == "worker-crash"]
        return {"valid?": True if not crashes else False,
                "exceptions": crashes[:16],
                "count": len(crashes)}


class LogFilePattern(Checker):
    """checker/log-file-pattern: scan SUT logs for crash signatures
    (etcd.clj:134-140), with the reference's false-positive carve-out for
    membership-change restarts ("couldn't find local name")."""

    def __init__(self,
                 pattern: str = r'"level":"(fatal|panic)"|panic:'
                                r'|^signal SIG',
                 exclude: str = r"couldn't find local name",
                 log_file: str = "etcd.log"):
        # default matches the reference's regex (etcd.clj:139): JSON
        # fatal/panic levels, literal "panic:", or a line-leading signal
        # — NOT bare substrings like "fatal"/"SIG", which false-match
        # fault-injection markers
        self.pattern = re.compile(pattern)
        self.exclude = re.compile(exclude)
        self.log_file = log_file

    def check(self, test, history, opts=None) -> dict:
        matches = []
        cluster = test.get("cluster") if isinstance(test, dict) else None
        if cluster is not None:
            for name, node in cluster.nodes.items():
                for line in node.etcd_log:
                    if self.pattern.search(line) and \
                            not self.exclude.search(line):
                        matches.append({"node": name, "line": line})
        return {"valid?": True if not matches else False,
                "matches": matches[:32],
                "count": len(matches)}


class ClockPlot(Checker):
    """checker/clock-plot: renders per-node clock offsets over time to
    clock.png (like the reference's plot, not data-only), reconstructed
    from the recorded clock-nemesis ops."""

    def check(self, test, history, opts=None) -> dict:
        h = history if isinstance(history, History) else History(history)
        points = [(op.time, op.f, op.value) for op in h.nemesis_ops()
                  if op.f in ("bump-clock", "strobe-clock", "reset-clock")
                  and op.is_completion]
        result = {"valid?": True,
                  "points": [(t, v) for t, _, v in points][:1000]}
        store_dir = (opts or {}).get("store_dir")
        if store_dir and points:
            try:
                self._plot(points, store_dir)
                result["plots"] = ["clock.png"]
            except Exception as e:  # plotting must never fail a test run
                result["plot-error"] = repr(e)
        return result

    def _plot(self, points, store_dir):
        import os
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from collections import defaultdict

        # reconstruct cumulative offset per node from bump/reset events;
        # strobes render as shaded oscillation windows
        series = defaultdict(lambda: [(0.0, 0.0)])
        strobes = []
        for t, f, v in points:
            ts = (t or 0) / 1e9
            if f == "bump-clock" and isinstance(v, dict):
                for node, delta_ms in v.items():
                    prev = series[node][-1][1]
                    series[node].append((ts, prev))
                    series[node].append((ts, prev + delta_ms))
            elif f == "reset-clock":
                for node in list(series) or list(v or []):
                    prev = series[node][-1][1]
                    series[node].append((ts, prev))
                    series[node].append((ts, 0.0))
            elif f == "strobe-clock" and isinstance(v, dict):
                # the op completes AFTER oscillating for duration-ms, so
                # the window it strobed is (completion - duration,
                # completion)
                dur = v.get("duration-ms", 0) / 1e3
                strobes.append((ts - dur, ts, v.get("delta-ms", 0)))
        fig, ax = plt.subplots(figsize=(10, 3))
        for lo, hi, delta in strobes:
            ax.axvspan(lo, hi, alpha=0.2, color="#FFDB9A")
        for node in sorted(series):
            xs = [x for x, _ in series[node]]
            ys = [y for _, y in series[node]]
            ax.plot(xs, ys, label=node, drawstyle="steps-post")
        ax.set_xlabel("time (s)")
        ax.set_ylabel("clock offset (ms)")
        ax.legend(fontsize=6, ncol=3)
        fig.savefig(os.path.join(store_dir, "clock.png"), dpi=100)
        plt.close(fig)


class Noop(Checker):
    def check(self, test, history, opts=None) -> dict:
        return {"valid?": True}
