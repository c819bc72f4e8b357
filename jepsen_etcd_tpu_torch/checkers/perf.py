"""Latency/throughput analysis + plots (checker/perf, etcd.clj:130).

Produces latency quantiles and rate series per op class, renders
latency-raw / rate PNGs into the store dir (when opts supply one), with
nemesis activity bands from the nemesis package's :perf metadata
(nemesis.clj:65-70,134-143,195-198)."""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Optional

from ..core.history import History, TYPE_NAMES
from ..core.op import Op
from .core import Checker

SECOND = 1_000_000_000


def latency_points(h: History) -> dict[str, list[tuple[float, float, str]]]:
    """f -> [(invoke_time_s, latency_ms, completion_type)].

    Recorded histories carry SoA columns (core/history.py OpColumns):
    invoke/completion pairing and the per-point fields come straight
    from the typed arrays, no per-op dict access."""
    cols = getattr(h, "columns", None)
    if cols is not None:
        out: dict = defaultdict(list)
        tm = cols.time.tolist()
        tc = cols.type_code.tolist()
        fcl = cols.f_code.tolist()
        ft = cols.f_table
        for inv, comp in cols.client_pairs():
            if comp < 0:
                continue
            out[ft[fcl[inv]]].append((tm[inv] / SECOND,
                                      (tm[comp] - tm[inv]) / 1e6,
                                      TYPE_NAMES[tc[comp]]))
        return dict(out)
    out = defaultdict(list)
    # graftlint: ignore[COL002] dict fallback for loaded/legacy histories
    for op in h.client_ops():
        if not op.is_invoke:
            continue
        # graftlint: ignore[COL002] dict fallback for loaded/legacy histories
        comp = h.completion(op)
        if comp is None:
            continue
        out[op.f].append((op["time"] / SECOND,
                          (comp["time"] - op["time"]) / 1e6,
                          comp["type"]))
    return dict(out)


def quantiles(xs: list[float], qs=(0.5, 0.95, 0.99, 1.0)) -> dict:
    if not xs:
        return {}
    s = sorted(xs)
    return {q: s[min(len(s) - 1, int(q * len(s)))] for q in qs}


def nemesis_bands(h: History) -> list[dict]:
    """[{f, start_s, end_s}] windows of nemesis activity.

    Columnar path: nemesis rows are the non-int processes (interned
    negative in ``cols.proc``); read f/time straight from the typed
    arrays instead of materializing per-op dicts via nemesis_ops()."""
    bands: list = []
    open_at: dict = {}
    cols = getattr(h, "columns", None)
    if cols is not None:
        tc = cols.type_code.tolist()
        pr = cols.proc.tolist()
        pt = cols.proc_table
        tm = cols.time.tolist()
        fcl = cols.f_code.tolist()
        ft = cols.f_table
        for i, p in enumerate(pr):
            if p >= 0 or isinstance(pt[-1 - p], int):
                continue  # client row
            f = ft[fcl[i]]
            if tc[i] == 0:  # invoke
                open_at[f] = tm[i]
            elif f in open_at:
                bands.append({"f": f, "start": open_at.pop(f) / SECOND,
                              "end": tm[i] / SECOND})
        return bands
    # graftlint: ignore[COL002] dict fallback for loaded/legacy histories
    for op in h.nemesis_ops():
        if op.is_invoke:
            open_at[op.f] = op["time"]
        elif op.f in open_at:
            bands.append({"f": op.f, "start": open_at.pop(op.f) / SECOND,
                          "end": op["time"] / SECOND})
    return bands


class Perf(Checker):
    def __init__(self, nemesis_perf: Optional[list] = None):
        # nemesis packages contribute {name,color,fs} specs
        self.nemesis_perf = nemesis_perf or []

    def check(self, test, history, opts=None) -> dict:
        h = history if isinstance(history, History) else History(history)
        pts = latency_points(h)
        stats = {}
        from ..runner import telemetry
        tel = telemetry.current()
        for f, rows in pts.items():
            oks = [lat for _, lat, t in rows if t == "ok"]
            stats[f] = {
                "count": len(rows),
                "ok-latency-ms": quantiles(oks),
            }
            if oks:
                # per-class latency distribution in SECONDS (virtual
                # time in sim mode); campaign rows merge these
                tel.hist_many(f"op.latency.{f}",
                              [lat / 1e3 for lat in oks])
        cols = getattr(h, "columns", None)
        if cols is not None and len(cols):
            duration = (int(cols.time.max()) or 1) / SECOND
        else:
            duration = (max((op["time"] for op in h),
                            default=0) or 1) / SECOND
        rate = sum(len(r) for r in pts.values()) / max(duration, 1e-9)
        bands = nemesis_bands(h)
        result = {"valid?": True, "latencies": stats,
                  "throughput-ops-per-s": rate,
                  "duration-s": duration,
                  "nemesis-bands": bands}
        store_dir = (opts or {}).get("store_dir")
        if store_dir:
            try:
                self._plot(pts, bands, store_dir)
                result["plots"] = ["latency-raw.png", "rate.png"]
            except Exception as e:  # plotting must never fail a test run
                result["plot-error"] = repr(e)
        return result

    def _plot(self, pts, bands, store_dir):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        band_colors = {}
        for spec in self.nemesis_perf:
            for f in spec.get("fs", []):
                band_colors[f] = spec.get("color", "#FFDB9A")

        def draw_bands(ax):
            for b in bands:
                ax.axvspan(b["start"], b["end"], alpha=0.15,
                           color=band_colors.get(b["f"], "#FFDB9A"))

        fig, ax = plt.subplots(figsize=(10, 4))
        draw_bands(ax)
        type_marker = {"ok": ".", "fail": "x", "info": "+"}
        for f, rows in pts.items():
            for t in ("ok", "fail", "info"):
                xs = [x for x, _, tt in rows if tt == t]
                ys = [y for _, y, tt in rows if tt == t]
                if xs:
                    ax.plot(xs, ys, type_marker[t], markersize=3,
                            label=f"{f} {t}")
        ax.set_yscale("log")
        ax.set_xlabel("time (s)")
        ax.set_ylabel("latency (ms)")
        ax.legend(fontsize=6, ncol=3)
        fig.savefig(os.path.join(store_dir, "latency-raw.png"), dpi=100)
        plt.close(fig)

        fig, ax = plt.subplots(figsize=(10, 3))
        draw_bands(ax)
        # 1-second rate buckets per f
        for f, rows in pts.items():
            buckets: dict = defaultdict(int)
            for x, _, t in rows:
                buckets[int(x)] += 1
            xs = sorted(buckets)
            ax.plot(xs, [buckets[x] for x in xs], label=f)
        ax.set_xlabel("time (s)")
        ax.set_ylabel("ops/s")
        ax.legend(fontsize=6)
        fig.savefig(os.path.join(store_dir, "rate.png"), dpi=100)
        plt.close(fig)
