"""Per-process op timeline HTML (jepsen.checker.timeline, used at
register.clj:112, lock.clj:245,259).

Real positioned rendering (VERDICT #7): one column per process, each op
an absolutely positioned box spanning invoke→complete on a shared
vertical time axis — so overlapping ops sit side by side and a lock
run's blocked acquires are visibly long. Nemesis activity windows
(the same :perf metadata checkers/perf.py extracts) render as
full-width bands behind the columns; hover any box for the op's full
detail (values, completion, error, latency).
"""

from __future__ import annotations

import html
import math
import os

from ..core.history import History
from .core import Checker
from .perf import nemesis_bands

SECOND = 1_000_000_000

COLORS = {"ok": "#B3F3B5", "info": "#F3EAB3", "fail": "#F3B3B3"}

#: layout constants: vertical px per second picked to land near this
#: total height, a fixed column width, and a left gutter for the axis
TARGET_HEIGHT_PX = 3000
MIN_PX_PER_S = 2.0
MAX_PX_PER_S = 2000.0
COL_W = 130
AXIS_W = 70
HEAD_H = 22
MIN_BOX_PX = 3
#: render cap — a 50k-op history still loads in a browser; the page
#: says how many ops were cut
MAX_OPS = 20_000

_CSS = """
body{font:12px monospace;margin:8px;background:#fafafa}
.meta{color:#444;margin:4px 0 10px}
.legend span{padding:1px 6px;margin-right:6px;border:1px solid #999}
.tl{position:relative;background:#fff;border:1px solid #ccc;
    overflow:hidden}
.colhead{position:absolute;top:0;height:%(head)dpx;width:%(colw)dpx;
    text-align:center;font-weight:bold;background:#eee;
    border-left:1px solid #ddd;z-index:3;overflow:hidden}
.op{position:absolute;width:%(opw)dpx;box-sizing:border-box;
    border:1px solid rgba(0,0,0,.25);overflow:hidden;z-index:2;
    font-size:10px;line-height:11px;padding:0 2px}
.op.open{border-style:dashed;opacity:.8}
.grid{position:absolute;left:0;right:0;height:0;
    border-top:1px solid #eee;z-index:0}
.tick{position:absolute;left:2px;width:%(axis)dpx;color:#999;
    font-size:10px;z-index:1}
.band{position:absolute;left:0;right:0;opacity:.18;z-index:1}
.bandlabel{position:absolute;right:4px;font-size:10px;color:#a40;
    z-index:1}
""" % {"head": HEAD_H, "colw": COL_W, "opw": COL_W - 8, "axis": AXIS_W}


def _tick_step(duration_s: float) -> float:
    """A round gridline step giving ~8-15 ticks."""
    if duration_s <= 0:
        return 1.0
    step = 10.0 ** max(-3, round(math.log10(max(duration_s / 10,
                                               1e-9))))
    while duration_s / step > 15:
        step *= 2
    while duration_s / step < 4 and step > 1e-3:
        step /= 2
    return step


class TimelineHtml(Checker):
    def __init__(self, nemesis_perf=None):
        # nemesis packages contribute {name,color,fs} specs, same shape
        # perf.Perf consumes for its plot bands
        self.nemesis_perf = nemesis_perf or []

    def _band_color(self, f) -> str:
        for spec in self.nemesis_perf:
            if f in spec.get("fs", []):
                return spec.get("color", "#FFDB9A")
        return "#FFDB9A"

    def check(self, test, history, opts=None) -> dict:
        store_dir = (opts or {}).get("store_dir")
        if not store_dir:
            return {"valid?": True}
        h = history if isinstance(history, History) else History(history)
        doc = self.render(test, h)
        path = os.path.join(store_dir, "timeline.html")
        with open(path, "w") as f:
            f.write(doc)
        return {"valid?": True, "file": path}

    def _box_rows(self, h: History) -> list[tuple]:
        """One row per client invoke, in invoke order:
        ``(process, f, value, t0_ns, t1_ns|None, typ|None, error)`` —
        value/typ from the completion when one exists (the completion's
        view of the op is what the reference timeline shows). Columnar
        when the history carries SoA columns: pairing and every field
        come from the typed arrays, no per-op dict access."""
        cols = getattr(h, "columns", None)
        if cols is not None:
            from ..core.history import TYPE_NAMES
            tm = cols.time.tolist()
            tc = cols.type_code.tolist()
            fcl = cols.f_code.tolist()
            ft = cols.f_table
            ex = cols.extras
            rows = []
            for inv, comp in cols.client_pairs():
                f = ft[fcl[inv]]
                p = cols.process_at(inv)
                if comp >= 0:
                    err = (ex.get(comp) or {}).get("error")
                    rows.append((p, f, cols.value_at(comp), tm[inv],
                                 tm[comp], TYPE_NAMES[tc[comp]], err))
                else:
                    rows.append((p, f, cols.value_at(inv), tm[inv],
                                 None, None, None))
            return rows
        rows = []
        # graftlint: ignore[COL002] dict fallback for loaded/legacy histories
        for op in h.client_ops():
            if not op.is_invoke:
                continue
            # graftlint: ignore[COL002] dict fallback for loaded/legacy histories
            comp = h.completion(op)
            if comp is not None:
                rows.append((op["process"], op.f, comp.get("value"),
                             op["time"], comp["time"], comp["type"],
                             comp.get("error")))
            else:
                rows.append((op["process"], op.f, op.get("value"),
                             op["time"], None, None, None))
        return rows

    def render(self, test, h: History) -> str:
        boxes = self._box_rows(h)
        truncated = max(0, len(boxes) - MAX_OPS)
        boxes = boxes[:MAX_OPS]
        bands = nemesis_bands(h)

        cols = getattr(h, "columns", None)
        if cols is not None:
            t_min = (int(cols.time.min()) if len(cols) else 0) / SECOND
            t_max = (int(cols.time.max()) if len(cols) else 0) / SECOND
        else:
            times = [op["time"] for op in h
                     if op.get("time") is not None]
            t_min = (min(times) if times else 0) / SECOND
            t_max = (max(times) if times else 0) / SECOND
        duration = max(t_max - t_min, 1e-9)
        px_per_s = min(MAX_PX_PER_S,
                       max(MIN_PX_PER_S, TARGET_HEIGHT_PX / duration))
        height = int(duration * px_per_s) + HEAD_H + 20

        def y(ts: float) -> int:
            return HEAD_H + int((ts - t_min) * px_per_s)

        processes = sorted({b[0] for b in boxes}, key=str)
        col_x = {p: AXIS_W + i * COL_W for i, p in enumerate(processes)}
        width = AXIS_W + max(1, len(processes)) * COL_W

        parts = []
        # time gridlines + tick labels
        step = _tick_step(duration)
        t = t_min - (t_min % step)
        while t <= t_max + step:
            if t >= t_min:
                parts.append(
                    f"<div class='grid' style='top:{y(t)}px'></div>"
                    f"<div class='tick' style='top:{y(t)}px'>"
                    f"{t:.3g}s</div>")
            t += step
        # nemesis bands behind the columns
        for b in bands:
            top, bot = y(b["start"]), y(b["end"])
            parts.append(
                f"<div class='band' style='top:{top}px;"
                f"height:{max(bot - top, 2)}px;"
                f"background:{self._band_color(b['f'])}'></div>"
                f"<div class='bandlabel' style='top:{top}px'>"
                f"{html.escape(str(b['f']))}</div>")
        # column headers
        for p in processes:
            parts.append(
                f"<div class='colhead' style='left:{col_x[p]}px'>"
                f"{html.escape(str(p))}</div>")
        # op boxes
        for p, f, val, t0n, t1n, typc, err in boxes:
            done = t1n is not None
            t0 = t0n / SECOND
            t1 = t1n / SECOND if done else t_max
            typ = typc if done else "info"
            top = y(t0)
            hgt = max(MIN_BOX_PX, y(t1) - top)
            title = (f"process {p} · {f} "
                     f"{val!r}\n[{t0:.4f}s → "
                     + (f"{t1:.4f}s] {typ} "
                        f"({(t1 - t0) * 1e3:.1f} ms)" if done
                        else "⋯] never completed"))
            if done and err:
                title += f"\nerror: {err!r}"
            label = f"{f} {val!r}"
            parts.append(
                f"<div class='op{'' if done else ' open'}' "
                f"style='left:{col_x[p] + 4}px;"
                f"top:{top}px;height:{hgt}px;"
                f"background:{COLORS.get(typ, '#ddd')}' "
                f"title='{html.escape(title, quote=True)}'>"
                f"{html.escape(label)}</div>")

        name = html.escape(str((test or {}).get("name", "run"))
                           if isinstance(test, dict) else "run")
        legend = "".join(
            f"<span style='background:{c}'>{k}</span>"
            for k, c in COLORS.items())
        note = (f" · <b>{truncated} ops past the {MAX_OPS}-op render "
                f"cap not drawn</b>" if truncated else "")
        return (
            "<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>timeline — {name}</title>"
            f"<style>{_CSS}</style></head><body>"
            f"<h2>timeline — {name}</h2>"
            f"<div class='meta'>{len(boxes)} ops · "
            f"{len(processes)} processes · {duration:.3f}s · "
            f"<span class='legend'>{legend}</span>"
            f"<span style='border:1px dashed #999;padding:1px 6px'>"
            f"open (never completed)</span>{note}</div>"
            f"<div class='tl' style='height:{height}px;"
            f"width:{width}px'>" + "".join(parts) +
            "</div></body></html>")
