"""``serve``: browse saved test runs over local HTTP.

Re-designs the reference's ``lein run serve`` (etcd.clj:250-252, jepsen's
built-in web server): ``/`` renders a run index (name, time, ops,
valid? badge); each run dir renders a report page — test parameters,
per-checker verdicts, telemetry phase/counter summary, inline
perf/clock plots, artifact links — with plain file serving below it
(``?files`` forces the raw listing, ``?trace`` a trace.jsonl event
viewer). ``/aggregate`` is the cross-run dashboard: a pass/fail matrix
over workload × nemesis × db, per-run phase-breakdown bars from
telemetry, and failure dedupe by checker verdict signature — the seed
of the campaign summary page (ROADMAP direction 2).
"""

from __future__ import annotations

import html
import json
import os
import time
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import quote

_CSS = """
body{font-family:sans-serif;margin:2em;max-width:75em}
table{border-collapse:collapse}
td,th{border:1px solid #ccc;padding:4px 8px;text-align:left}
.ok{color:#2a2;font-weight:bold}
.bad{color:#c22;font-weight:bold}
.unk{color:#b80;font-weight:bold}
img{max-width:100%;border:1px solid #ddd;margin:4px 0}
code{background:#f4f4f4;padding:1px 4px}
.bar{display:inline-block;height:12px;vertical-align:middle}
.barbox{display:inline-block;width:320px;background:#f4f4f4;
    border:1px solid #ddd;font-size:0;line-height:0}
.dim{color:#888}
"""

#: run-phase display order and bar colors (phases map keys come from
#: runner/telemetry.py's ``phase:<name>`` spans)
_PHASES = (("setup", "#9ab8d8"), ("generate", "#8fc98f"),
           ("stream-finalize", "#6fc4bc"), ("teardown", "#d8d8d8"),
           ("check", "#e0a848"), ("save", "#b8a0d0"))


def _badge(v) -> str:
    cls = {"True": "ok", True: "ok", False: "bad", "False": "bad"}.get(
        v, "unk")
    return f'<span class="{cls}">{html.escape(str(v))}</span>'


def _load_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError, ValueError):
        return None


# Row derivation lives in runner/store_index.py now: the index writer
# and these walk fallbacks call the SAME builders, so index-backed
# pages replay bit-identically to a fresh tree walk. The old private
# names stay importable (tel_cli and shrink import _failure_signature;
# the canonical implementation is runner/store.failure_signature).
from .runner.store import failure_signature as _failure_signature  # noqa: E402
from .runner.store_index import (  # noqa: E402
    SURFACES as _SURFACES,
    chip_util as _chip_util,
    consistency_surface as _consistency_surface,
    host_ledger as _host_ledger,
    overlap_ratio as _overlap_ratio,
)


def _run_rows(store_base: str) -> list[dict]:
    from .runner import store_index
    fold = store_index.fold(store_base)
    if fold is not None:
        return store_index.serve_run_rows(fold)
    from .forensics import all_runs
    rows = []
    for rdir in all_runs(store_base):
        rel = os.path.relpath(rdir, store_base)
        results = _load_json(os.path.join(rdir, "results.json")) or {}
        test = _load_json(os.path.join(rdir, "test.json")) or {}
        try:
            mtime = os.path.getmtime(rdir)
        except OSError:
            mtime = 0
        rows.append(store_index.run_row(rel, results, test, mtime))
    rows.sort(key=lambda r: r["mtime"], reverse=True)
    return rows


def _campaign_rows(store_base: str) -> list[dict]:
    """Campaign summaries under the store: every
    ``<store>/<name>/<id>/campaign.json`` written by
    runner/campaign.run_campaign. (Campaign dirs carry no
    history.jsonl, so the run index never lists them — this is their
    only dashboard surface.) Sorted oldest-first: the table reads as a
    trend over successive campaigns."""
    from .runner import store_index
    fold = store_index.fold(store_base)
    if fold is not None:
        return store_index.serve_campaign_rows(fold)
    rows = []
    try:
        names = sorted(os.listdir(store_base))
    except OSError:
        return rows
    for name in names:
        ndir = os.path.join(store_base, name)
        if not os.path.isdir(ndir):
            continue
        try:
            ids = sorted(os.listdir(ndir))
        except OSError:
            continue
        for rid in ids:
            if os.path.islink(os.path.join(ndir, rid)):
                continue  # the `latest` convenience symlink
            cpath = os.path.join(ndir, rid, "campaign.json")
            summary = _load_json(cpath)
            if not isinstance(summary, dict) or "runs" not in summary:
                continue
            try:
                mtime = os.path.getmtime(cpath)
            except OSError:
                mtime = 0
            rows.append(store_index.campaign_row(
                os.path.join(name, rid), summary, mtime))
    rows.sort(key=lambda r: r["mtime"])
    return rows


def _guided_rows(store_base: str) -> list[dict]:
    """Guided-campaign summaries under the store: every
    ``<store>/<name>/<id>/guided.json`` written by
    runner/guided.run_guided. Same two-level walk as
    ``_campaign_rows`` (guided dirs carry no history.jsonl either).
    Sorted oldest-first."""
    from .runner import store_index
    fold = store_index.fold(store_base)
    if fold is not None:
        return store_index.serve_guided_rows(fold)
    rows = []
    try:
        names = sorted(os.listdir(store_base))
    except OSError:
        return rows
    for name in names:
        ndir = os.path.join(store_base, name)
        if not os.path.isdir(ndir):
            continue
        try:
            ids = sorted(os.listdir(ndir))
        except OSError:
            continue
        for rid in ids:
            if os.path.islink(os.path.join(ndir, rid)):
                continue  # the `latest` convenience symlink
            gpath = os.path.join(ndir, rid, "guided.json")
            summary = _load_json(gpath)
            if not isinstance(summary, dict) or \
                    summary.get("kind") != "guided":
                continue
            try:
                mtime = os.path.getmtime(gpath)
            except OSError:
                mtime = 0
            rows.append(store_index.guided_row(
                os.path.join(name, rid), summary, mtime))
    rows.sort(key=lambda r: r["mtime"])
    return rows


def _shrink_rows(store_base: str) -> list[dict]:
    """Minimized-repro artifacts: every run dir carrying a
    ``shrink.json`` written by runner/shrink.shrink_run. A full walk,
    not forensics.all_runs — guided campaigns nest their runs one
    level deeper (``<store>/<name>/<id>/gen<N>/<run>``) than the
    two-level run index. Newest first."""
    from .runner import store_index
    fold = store_index.fold(store_base)
    if fold is not None:
        return store_index.serve_shrink_rows(fold, store_base)
    rows = []
    for root, dirs, files in os.walk(store_base, followlinks=False):
        dirs[:] = [d for d in dirs
                   if not os.path.islink(os.path.join(root, d))]
        if "shrink.json" not in files:
            continue
        rdir = root
        art = _load_json(os.path.join(rdir, "shrink.json"))
        if not isinstance(art, dict) or "signature" not in art:
            continue
        try:
            mtime = os.path.getmtime(os.path.join(rdir, "shrink.json"))
        except OSError:
            mtime = 0
        rows.append(store_index.shrink_row(
            os.path.relpath(rdir, store_base), art, mtime))
    rows.sort(key=lambda r: r["mtime"], reverse=True)
    return rows


def _fmt_s(v) -> str:
    """Compact seconds: us/ms/s by magnitude."""
    if not isinstance(v, (int, float)):
        return "—"
    if v < 1e-3:
        return f"{v * 1e6:.0f}us"
    if v < 1.0:
        return f"{v * 1e3:.1f}ms"
    return f"{v:.2f}s"


def _percentile_cell(p: dict) -> str:
    """One table cell of p95 gen/check/queue-wait (p50 and p99 in the
    title), from a campaign summary's merged-histogram ``p`` map."""
    labels = ("gen", "check", "queue_wait")
    if not any(isinstance(p.get(k), list) and len(p[k]) == 3
               for k in labels):
        return "<td class='dim'>—</td>"
    shown, titled = [], []
    for k in labels:
        tri = p.get(k)
        if isinstance(tri, list) and len(tri) == 3:
            shown.append(_fmt_s(tri[1]))
            titled.append(f"{k}: p50 {_fmt_s(tri[0])}, "
                          f"p95 {_fmt_s(tri[1])}, p99 {_fmt_s(tri[2])}")
        else:
            shown.append("—")
    return (f"<td title='{html.escape('; '.join(titled))}'>"
            + "&thinsp;/&thinsp;".join(shown) + "</td>")


def _phase_bar(phases: dict) -> str:
    """A stacked horizontal bar of the run's phase wall times."""
    total = sum(v for v in phases.values()
                if isinstance(v, (int, float)))
    if not total:
        return "<span class='dim'>no telemetry</span>"
    segs = []
    for name, color in _PHASES:
        v = phases.get(name)
        if not v:
            continue
        pct = 100.0 * v / total
        segs.append(
            f"<span class='bar' style='width:{pct:.2f}%;"
            f"background:{color}' "
            f"title='{html.escape(name)}: {v:.3f}s "
            f"({pct:.0f}%)'></span>")
    return (f"<span class='barbox'>{''.join(segs)}</span> "
            f"<span class='dim'>{total:.2f}s</span>")


def index_html(store_base: str) -> str:
    rows = []
    for r in _run_rows(store_base):
        when = time.strftime("%Y-%m-%d %H:%M:%S",
                             time.localtime(r["mtime"]))
        rows.append(
            f'<tr><td><a href="/{quote(r["dir"])}/">'
            f'{html.escape(r["dir"])}</a></td>'
            f"<td>{html.escape(when)}</td>"
            f"<td>{_badge(r['valid?'])}</td>"
            f"<td>{r['ops'] if r['ops'] is not None else ''}</td></tr>")
    return (f"<!doctype html><title>jepsen_etcd_tpu_torch store</title>"
            f"<style>{_CSS}</style>"
            "<h1>Test runs</h1>"
            '<p><a href="/aggregate">cross-run dashboard &rarr;</a></p>'
            "<table><tr><th>run</th><th>time</th>"
            "<th>valid?</th><th>ops</th></tr>"
            + "".join(rows) + "</table>")


#: /aggregate pagination: the pass/fail matrix always aggregates ALL
#: runs, but the per-run phase table and the failure tables window at
#: ``per`` rows (?page=/?per=) so a 10k-run store renders flat
_DEF_PER = 200
_MAX_PER = 1000

#: per-process render cache for index-backed /aggregate pages:
#: (base, page, per) -> (fold generation vector, html). Unindexed
#: stores are never cached — there is no cheap invalidation signal.
_AGG_CACHE: dict = {}


def _agg_gens(store_base: str):
    """Generation vector covering every fold /aggregate reads: the
    base index plus each guided sub-index feeding the shrink table.
    Any committed index write bumps a component. None when the store
    is unindexed."""
    from .runner import store_index
    fold = store_index.fold(store_base)
    if fold is None:
        return None
    gens = [fold.gen]
    for d in store_index.kind_dirs(fold, "guided"):
        sub = store_index.fold(os.path.join(store_base, d))
        gens.append(-1 if sub is None else sub.gen)
    return tuple(gens)


def _page_window(total: int, page, per):
    """Clamped (lo, hi, page, pages, per) for one table's window."""
    try:
        per = int(per) if per else _DEF_PER
    except (TypeError, ValueError):
        per = _DEF_PER
    per = max(1, min(per, _MAX_PER))
    try:
        page = int(page) if page else 1
    except (TypeError, ValueError):
        page = 1
    pages = max(1, -(-total // per))
    page = max(1, min(page, pages))
    lo = (page - 1) * per
    return lo, min(lo + per, total), page, pages, per


def _pager(lo: int, hi: int, page: int, pages: int, per: int,
           total: int) -> str:
    if pages <= 1:
        return ""
    bits = [f"<p class='dim'>rows {lo + 1}–{hi} of {total} · "]
    if page > 1:
        bits.append(f'<a href="/aggregate?page={page - 1}'
                    f'&amp;per={per}">&larr; prev</a> · ')
    bits.append(f"page {page}/{pages}")
    if page < pages:
        bits.append(f' · <a href="/aggregate?page={page + 1}'
                    f'&amp;per={per}">next &rarr;</a>')
    bits.append("</p>")
    return "".join(bits)


def aggregate_html(store_base: str, page=1, per=None) -> str:
    """The cross-run dashboard: pass/fail matrix over workload ×
    (nemesis, db), per-run telemetry phase bars, and failure dedupe by
    checker verdict signature. The per-run and failure tables window
    at ``per`` rows (?page=/?per=); index-backed renders are cached
    per (page, per) until the index generation moves."""
    gens = _agg_gens(store_base)
    cache_key = (os.path.abspath(store_base), page, per)
    if gens is not None:
        hit = _AGG_CACHE.get(cache_key)
        if hit is not None and hit[0] == gens:
            return hit[1]
    rows = _run_rows(store_base)
    out = ["<!doctype html>"
           "<title>aggregate — jepsen_etcd_tpu_torch</title>",
           f"<style>{_CSS}</style>",
           '<p><a href="/">&larr; all runs</a></p>',
           f"<h1>Cross-run dashboard</h1>",
           f"<p>{len(rows)} runs</p>"]

    # -- pass/fail matrix: workload rows × (nemesis, db) columns -------------
    cols = sorted({(r["nemesis"], r["db"]) for r in rows})
    workloads = sorted({r["workload"] for r in rows}, key=str)
    cells: dict = {}
    for r in rows:
        cells.setdefault(
            (r["workload"], (r["nemesis"], r["db"])), []).append(r)
    out.append("<h2>Pass/fail matrix</h2><table><tr><th>workload</th>")
    out.extend(f"<th>{html.escape(str(n))}<br>"
               f"<span class='dim'>{html.escape(str(d))}</span></th>"
               for n, d in cols)
    out.append("</tr>")
    for w in workloads:
        out.append(f"<tr><th>{html.escape(str(w))}</th>")
        for c in cols:
            runs = cells.get((w, c), [])
            if not runs:
                out.append("<td class='dim'>—</td>")
                continue
            npass = sum(1 for r in runs if r["valid?"] is True)
            nfail = sum(1 for r in runs if r["valid?"] is False)
            nunk = len(runs) - npass - nfail
            bits = []
            if npass:
                bits.append(f"<span class='ok'>{npass}&nbsp;pass</span>")
            if nfail:
                bits.append(f"<span class='bad'>{nfail}&nbsp;fail</span>")
            if nunk:
                bits.append(f"<span class='unk'>{nunk}&nbsp;unk</span>")
            links = " ".join(
                f'<a href="/{quote(r["dir"])}/">'
                f'{html.escape(os.path.basename(r["dir"]))}</a>'
                for r in runs[:8])
            out.append(f"<td>{' '.join(bits)}<br>"
                       f"<span class='dim'>{links}</span></td>")
        out.append("</tr>")
    out.append("</table>")

    # -- per-run phase breakdown bars ----------------------------------------
    lo, hi, pg, pages, per_n = _page_window(len(rows), page, per)
    out.append("<h2>Phase breakdown (wall time per run)</h2>")
    out.append(_pager(lo, hi, pg, pages, per_n, len(rows)))
    out.append("<table><tr><th>run</th><th>valid?</th>"
               "<th>consistency</th>"
               "<th>gen ops/s</th><th>e2e/gen</th><th>phases</th></tr>")
    for r in rows[lo:hi]:
        rate = r.get("gen_rate")
        rate_td = (f"<td>{rate:,.0f}</td>"
                   if isinstance(rate, (int, float))
                   else "<td class='dim'>—</td>")
        ov = r.get("overlap")
        # streamed runs only: how much wall time verification added on
        # top of generation (1.00x = checking came free)
        ov_td = (f"<td title='(generate + stream-finalize + check) / "
                 f"generate'>{ov:.2f}&times;</td>"
                 if isinstance(ov, (int, float))
                 else "<td class='dim'>—</td>")
        surf = r.get("consistency") or {}
        if surf:
            # per-surface verdicts of the MVCC consistency checkers
            # (checkers/mvcc.py) composed into this run's workload
            surf_td = "<td>" + " ".join(
                f"{html.escape(label)}&nbsp;{_badge(s['valid'])}"
                + (f"<span class='bad'>({s['violations']})</span>"
                   if s["violations"] else "")
                for label, s in surf.items()) + "</td>"
        else:
            surf_td = "<td class='dim'>—</td>"
        out.append(
            f'<tr><td><a href="/{quote(r["dir"])}/">'
            f'{html.escape(r["dir"])}</a></td>'
            f"<td>{_badge(r['valid?'])}</td>"
            f"{surf_td}"
            f"{rate_td}{ov_td}"
            f"<td>{_phase_bar(r['phases'])}</td></tr>")
    out.append("</table><p class='dim'>"
               + " ".join(f"<span class='bar' style='width:12px;"
                          f"background:{c}'></span> {html.escape(n)}"
                          for n, c in _PHASES) + "</p>")

    # -- campaign perf trends across rounds ----------------------------------
    camps = _campaign_rows(store_base)
    if camps:
        out.append(
            "<h2>Campaign perf trends</h2>"
            "<p class='dim'>successive campaigns, oldest first — "
            "dispatch amortization is submitted packs vs batched "
            "device dispatches (1 per (bucket, width, tick); "
            "PERF.md §campaign)</p>"
            "<table><tr><th>campaign</th><th>time</th><th>runs</th>"
            "<th>pool</th><th>valid?</th><th>wall</th>"
            "<th>gen ops/s</th><th>batched gen ops/s</th>"
            "<th>check wall</th>"
            "<th>p95 gen/check/queue</th><th>net</th>"
            "<th>dispatches</th><th>amortization</th>"
            "<th>chips</th><th>hosts</th></tr>")
        for c in camps:
            when = time.strftime("%Y-%m-%d %H:%M",
                                 time.localtime(c["mtime"]))
            rate = c["gen_rate"]
            rate_td = (f"<td>{rate:,.0f}</td>"
                       if isinstance(rate, (int, float))
                       else "<td class='dim'>—</td>")
            gb = c.get("genbatch") or {}
            gb_rate = gb.get("ops_per_s")
            gb_td = (f"<td title='{gb.get('seeds')} seeds over "
                     f"{gb.get('cells')} cells, {gb.get('epoch')}'>"
                     f"{gb_rate:,.0f}</td>"
                     if isinstance(gb_rate, (int, float)) and gb_rate
                     else "<td class='dim'>—</td>")
            p_td = _percentile_cell(c.get("p") or {})
            net = c.get("net") or {}
            if any(net.values()):
                net_td = (
                    "<td title='dropped chunks / accept errors / "
                    "delayed bytes (net.* counters)'>"
                    f"{net.get('dropped_chunks', 0)}&thinsp;/&thinsp;"
                    f"{net.get('accept_errors', 0)}&thinsp;/&thinsp;"
                    f"{net.get('delayed_bytes', 0)}</td>")
            else:
                net_td = "<td class='dim'>—</td>"
            if c["submitted"]:
                amort = (f"{c['submitted']} packs &rarr; "
                         f"{c['group_ticks']} dispatches, "
                         f"occupancy&nbsp;{c['occupancy']}")
                if c["fallbacks"]:
                    amort += (f" <span class='bad'>"
                              f"({c['fallbacks']} fallbacks)</span>")
            else:
                amort = "<span class='dim'>per-run checking</span>"
            chips = c.get("chips")
            if chips:
                bal = chips.get("balance")
                bal_s = (f"{bal:.1f}&times;"
                         if isinstance(bal, (int, float)) else "&infin;")
                title = ", ".join(
                    f"{d}: {n} dispatches"
                    f" ({_fmt_s(chips['busy_s'].get(d))} busy)"
                    for d, n in sorted(chips["dispatches"].items()))
                occ = chips.get("occupancy")
                sh = chips.get("sharded_ticks")
                chips_td = (
                    f"<td title='{html.escape(title)}'>"
                    f"{chips['devices']} chips, "
                    f"occ&nbsp;{occ if occ is not None else '?'}, "
                    f"balance&nbsp;{bal_s}"
                    + (f", {sh} sharded" if sh else "") + "</td>")
            else:
                chips_td = "<td class='dim'>—</td>"
            hosts = c.get("hosts")
            if hosts:
                # the ledger join per host: rows' shipped (producer)
                # vs the service's host_submitted (consumer)
                balanced = all(
                    st.get("submitted") is None
                    or st.get("shipped") == st.get("submitted")
                    for st in hosts.values())
                title = ", ".join(
                    f"{h}: {st.get('runs', 0)} runs, "
                    f"shipped {st.get('shipped', 0)} vs "
                    f"submitted {st.get('submitted', '?')}"
                    for h, st in sorted(hosts.items()))
                rq = c.get("agent_requeues")
                hosts_td = (
                    f"<td title='{html.escape(title)}'>"
                    f"{len(hosts)} hosts, ledger "
                    + ("<span class='ok'>balanced</span>" if balanced
                       else "<span class='bad'>MISMATCH</span>")
                    + (f", {rq} requeues" if rq else "") + "</td>")
            else:
                hosts_td = "<td class='dim'>—</td>"
            out.append(
                f'<tr><td><a href="/{quote(c["dir"])}/?files">'
                f'{html.escape(c["dir"])}</a></td>'
                f"<td>{html.escape(when)}</td>"
                f"<td>{c['count']}</td><td>{c['pool']}</td>"
                f"<td>{_badge(c['valid?'])}</td>"
                f"<td>{c['wall_s']}s</td>{rate_td}{gb_td}"
                f"<td>{c['check_s']:.2f}s</td>{p_td}{net_td}"
                f"<td>{c['dispatches']}</td><td>{amort}</td>"
                f"{chips_td}{hosts_td}</tr>")
        out.append("</table>")

    # -- guided campaigns ----------------------------------------------------
    guided = _guided_rows(store_base)
    if guided:
        out.append(
            "<h2>Guided campaigns</h2>"
            "<p class='dim'>coverage-guided fault search "
            "(campaign --guided N) — novelty-scored corpus evolution; "
            "first failing run and distinct verdict signatures per "
            "budget</p>"
            "<table><tr><th>campaign</th><th>time</th><th>budget</th>"
            "<th>runs</th><th>gens</th><th>first failure</th>"
            "<th>signatures</th><th>corpus</th><th>minimized</th>"
            "<th>wall</th></tr>")
        for g in guided:
            when = time.strftime("%Y-%m-%d %H:%M",
                                 time.localtime(g["mtime"]))
            ff = g["first_failure_run"]
            ff_td = (f"<td>run {ff}</td>" if isinstance(ff, int)
                     else "<td class='dim'>none</td>")
            sigs = g["signatures"]
            sig_td = (
                "<td title='"
                + html.escape("; ".join(
                    f"{s} @ run {r}" for s, r in sorted(sigs.items())))
                + f"'>{len(sigs)}</td>" if sigs
                else "<td class='dim'>0</td>")
            mins = g["minimized"]
            min_td = (f"<td>{len(mins)}</td>" if mins
                      else "<td class='dim'>0</td>")
            out.append(
                f'<tr><td><a href="/{quote(g["dir"])}/?files">'
                f'{html.escape(g["dir"])}</a></td>'
                f"<td>{html.escape(when)}</td>"
                f"<td>{g['budget']}</td><td>{g['runs']}</td>"
                f"<td>{g['generations']}</td>{ff_td}{sig_td}"
                f"<td>{g['corpus']}</td>{min_td}"
                f"<td>{g['wall_s']}s</td></tr>")
        out.append("</table>")

    # -- minimized repros ----------------------------------------------------
    shrunk = _shrink_rows(store_base)
    if shrunk:
        out.append(
            "<h2>Minimized repros</h2>"
            "<p class='dim'>delta-debugged failing schedules "
            "(runner/shrink) — smallest nemesis schedule that still "
            "reproduces the verdict signature, with its replay "
            "command</p>"
            "<table><tr><th>run</th><th>signature</th>"
            "<th>windows</th><th>nemesis ops</th><th>executions</th>"
            "<th>repro</th></tr>")
        for s in shrunk:
            out.append(
                f'<tr><td><a href="/{quote(s["dir"])}/">'
                f'{html.escape(s["dir"])}</a></td>'
                f"<td><code>{html.escape(str(s['signature']))}</code>"
                f"</td><td>{s['original_windows']}&rarr;"
                f"{s['windows']}</td>"
                f"<td>{s['nemesis_ops']}</td>"
                f"<td>{s['executions']}</td>"
                f"<td><code>{html.escape(str(s['repro']))}</code>"
                f"</td></tr>")
        out.append("</table>")

    # -- failure dedupe by verdict signature ---------------------------------
    # Runs with a checker signature are real verdicts; runs that
    # failed with no signature at all (crashed harness, truncated
    # results.json, setup errors) are infrastructure noise and get
    # their own section so verdict groups — and anything consuming
    # them, like guided's novelty scoring — never mix the two.
    failing = [r for r in rows if r["valid?"] is not True]
    verdicts = [r for r in failing if r["signature"]]
    infra = [r for r in failing if not r["signature"]]
    out.append("<h2>Failure dedupe</h2>")
    if not verdicts:
        out.append("<p class='ok'>no failing checker verdicts</p>")
    else:
        groups: dict = {}
        for r in verdicts:
            groups.setdefault(r["signature"], []).append(r)
        grouped = sorted(groups.items(), key=lambda kv: -len(kv[1]))
        glo, ghi, gpg, gpages, gper = _page_window(len(grouped),
                                                   page, per)
        out.append(_pager(glo, ghi, gpg, gpages, gper, len(grouped)))
        out.append("<table><tr><th>verdict signature</th>"
                   "<th>runs</th><th>dirs</th></tr>")
        for sig, rs in grouped[glo:ghi]:
            links = " ".join(
                f'<a href="/{quote(r["dir"])}/">'
                f'{html.escape(r["dir"])}</a>' for r in rs[:12])
            out.append(f"<tr><td><code>{html.escape(sig)}</code></td>"
                       f"<td>{len(rs)}</td><td>{links}</td></tr>")
        out.append("</table>")
    if infra:
        ilo, ihi, ipg, ipages, iper = _page_window(len(infra),
                                                   page, per)
        out.append(
            "<h2>Infrastructure / harness errors</h2>"
            "<p class='dim'>failing runs with no checker verdict — "
            "harness noise, not consistency results; excluded from "
            "the verdict dedupe above</p>")
        out.append(_pager(ilo, ihi, ipg, ipages, iper, len(infra)))
        out.append("<table><tr><th>run</th><th>valid?</th></tr>")
        for r in infra[ilo:ihi]:
            out.append(
                f'<tr><td><a href="/{quote(r["dir"])}/">'
                f'{html.escape(r["dir"])}</a></td>'
                f"<td>{_badge(r['valid?'])}</td></tr>")
        out.append("</table>")
    body = "".join(out)
    if gens is not None:
        _AGG_CACHE[cache_key] = (gens, body)
        if len(_AGG_CACHE) > 64:  # a scraper walking ?page= must not
            _AGG_CACHE.clear()    # grow the cache unboundedly
    return body


#: test.json keys shown in the run page's parameter table, in order
_PARAM_KEYS = ("workload", "nemesis_spec", "nemesis_interval",
               "time_limit", "rate", "ops_per_key", "concurrency",
               "serializable", "lazyfs", "client_type", "snapshot_count",
               "unsafe_no_fsync", "corrupt_check", "version", "seed",
               "nodes")

#: trace-viewer row cap per page load
_TRACE_ROWS = 500


def trace_html(store_base: str, rel: str, kind: str = "") -> str:
    """The trace.jsonl event viewer: first ``_TRACE_ROWS`` events
    (optionally filtered to one kind), with per-kind totals from the
    run's results.json net-trace summary."""
    rdir = os.path.join(store_base, rel)
    results = _load_json(os.path.join(rdir, "results.json")) or {}
    nt = results.get("net-trace") or {}
    out = [f"<!doctype html><title>trace — {html.escape(rel)}</title>",
           f"<style>{_CSS}</style>",
           f'<p><a href="/{quote(rel)}/">&larr; run</a></p>',
           f"<h1>trace — {html.escape(rel)}</h1>"]
    counts = nt.get("counts") or {}
    if counts:
        out.append("<p>filter: "
                   + " ".join(
                       f'<a href="/{quote(rel)}/?trace={quote(k)}">'
                       f"{html.escape(k)}</a>"
                       f"&nbsp;<span class='dim'>({v})</span>"
                       for k, v in sorted(counts.items()))
                   + f' · <a href="/{quote(rel)}/?trace">all</a></p>')
    if nt.get("dropped"):
        out.append(f"<p class='bad'>{nt['dropped']} events dropped "
                   "past the recorder cap</p>")
    path = os.path.join(rdir, "trace.jsonl")
    rows, shown, total = [], 0, 0
    try:
        with open(path) as f:
            for line in f:
                try:
                    e = json.loads(line)
                except ValueError:
                    continue
                if "kind" not in e:
                    continue  # the trailing truncation marker
                total += 1
                if kind and e.get("kind") != kind:
                    continue
                if shown >= _TRACE_ROWS:
                    continue
                shown += 1
                info = {k: v for k, v in e.items()
                        if k not in ("t", "kind", "src", "dst")}
                rows.append(
                    f"<tr><td>{(e.get('t') or 0) / 1e9:.6f}</td>"
                    f"<td>{html.escape(str(e.get('kind')))}</td>"
                    f"<td>{html.escape(str(e.get('src')))}</td>"
                    f"<td>{html.escape(str(e.get('dst')))}</td>"
                    f"<td><code>{html.escape(json.dumps(info, default=repr)[:400])}"
                    f"</code></td></tr>")
    except OSError:
        out.append("<p class='unk'>no trace.jsonl in this run "
                   "(pass --tcpdump)</p>")
        return "".join(out)
    out.append(f"<p>{shown} of {total} events shown"
               + (f" (kind <code>{html.escape(kind)}</code>)" if kind
                  else "") + "</p>")
    out.append("<table><tr><th>t (s)</th><th>kind</th><th>src</th>"
               "<th>dst</th><th>info</th></tr>"
               + "".join(rows) + "</table>")
    return "".join(out)


def run_html(store_base: str, rel: str) -> str:
    """The per-run report page (jepsen's run view: params, checker
    verdicts, telemetry, plots, artifacts)."""
    rdir = os.path.join(store_base, rel)
    results = _load_json(os.path.join(rdir, "results.json")) or {}
    test = _load_json(os.path.join(rdir, "test.json")) or {}
    out = [f"<!doctype html><title>{html.escape(rel)}</title>",
           f"<style>{_CSS}</style>",
           f'<p><a href="/">&larr; all runs</a> &middot; '
           f'<a href="/aggregate">dashboard</a> &middot; '
           f'<a href="/{quote(rel)}/?files">raw files</a></p>',
           f"<h1>{html.escape(str(test.get('name', rel)))} "
           f"{_badge(results.get('valid?', '?'))}</h1>"]
    # parameters
    params = [(k, test[k]) for k in _PARAM_KEYS if k in test]
    if params:
        out.append("<h2>Parameters</h2><table>")
        out.extend(
            f"<tr><th>{html.escape(k)}</th>"
            f"<td><code>{html.escape(json.dumps(v))}</code></td></tr>"
            for k, v in params)
        out.append("</table>")
    # checker verdicts
    checkers = [(k, v) for k, v in sorted(results.items())
                if isinstance(v, dict) and "valid?" in v]
    if checkers:
        out.append("<h2>Checkers</h2><table>"
                   "<tr><th>checker</th><th>valid?</th><th>detail</th></tr>")
        for k, v in checkers:
            detail = {dk: dv for dk, dv in v.items() if dk != "valid?"}
            blob = html.escape(json.dumps(detail, default=repr)[:2000])
            out.append(f"<tr><td>{html.escape(k)}</td>"
                       f"<td>{_badge(v.get('valid?'))}</td>"
                       f"<td><code>{blob}</code></td></tr>")
        out.append("</table>")
    # telemetry summary (phase bar, checker span totals, counters)
    tel = results.get("telemetry") or {}
    if tel:
        out.append("<h2>Telemetry</h2>")
        out.append(f"<p>{_phase_bar(tel.get('phases') or {})}</p>")
        spans = tel.get("spans") or {}
        if spans:
            out.append("<table><tr><th>span</th><th>count</th>"
                       "<th>total (s)</th></tr>")
            for name, v in spans.items():
                out.append(
                    f"<tr><td><code>{html.escape(str(name))}</code></td>"
                    f"<td>{v.get('count')}</td>"
                    f"<td>{v.get('total_s', 0):.4f}</td></tr>")
            out.append("</table>")
        counters = tel.get("counters") or {}
        if counters:
            out.append("<p>"
                       + " · ".join(
                           f"<code>{html.escape(str(k))}</code>={v}"
                           for k, v in sorted(counters.items()))
                       + "</p>")
        if counters.get("net.links"):
            # the userspace proxy plane ran: call out its fault totals
            out.append("<p class='dim'>net proxy plane: "
                       f"{counters.get('net.links', 0)} links fronted, "
                       f"{counters.get('net.dropped_conns', 0)} conns "
                       "dropped/blackholed, "
                       f"{counters.get('net.delayed_bytes', 0)} bytes "
                       "delayed, peak "
                       f"{counters.get('net.active_rules', 0)} active "
                       "rules</p>")
        if tel.get("dropped"):
            out.append(f"<p class='bad'>{tel['dropped']} telemetry "
                       "records dropped past the cap</p>")
    # net-trace summary
    nt = results.get("net-trace") or {}
    if nt:
        out.append("<h2>Network trace</h2>"
                   f"<p>{nt.get('events', 0)} events"
                   + (f", <span class='bad'>{nt['dropped']} "
                      "dropped</span>" if nt.get("dropped") else "")
                   + (f' · <a href="/{quote(rel)}/?trace">'
                      "event viewer</a>"
                      if os.path.exists(os.path.join(rdir,
                                                     "trace.jsonl"))
                      else "") + "</p>")
        if nt.get("counts"):
            out.append("<p class='dim'>"
                       + " · ".join(
                           f"{html.escape(str(k))}: {v}"
                           for k, v in sorted(nt["counts"].items()))
                       + "</p>")
    # plots inline
    plots = [f for f in ("latency-raw.png", "rate.png", "clock.png")
             if os.path.exists(os.path.join(rdir, f))]
    if plots:
        out.append("<h2>Plots</h2>")
        out.extend(f'<img src="/{quote(rel)}/{quote(f)}" '
                   f'alt="{html.escape(f)}">'
                   for f in plots)
    # artifacts
    out.append("<h2>Artifacts</h2><ul>")
    for fn in sorted(os.listdir(rdir)):
        p = os.path.join(rdir, fn)
        label = fn + ("/" if os.path.isdir(p) else "")
        out.append(f'<li><a href="/{quote(rel)}/{quote(fn)}">'
                   f"{html.escape(label)}</a></li>")
    out.append("</ul>")
    return "".join(out)


# -- live campaign view ------------------------------------------------------

#: an SSE stream ends once the snapshot stops refreshing for this long
#: (campaign finished without a done marker, or died) — always after
#: serving at least one event
LIVE_STALE_S = 15.0

#: hard bound on events per SSE connection (a forgotten browser tab
#: must not pin a handler thread forever)
LIVE_MAX_EVENTS = 3600


def _live_snapshot(store_base: str):
    """``(snapshot, mtime, rel_dir)`` of the NEWEST ``live.json``
    under the store (the running — or most recent — campaign's
    collector output), or None when no campaign ever ran live.

    Indexed stores stat only the registered candidates (campaigns
    note themselves via store_index.note_live the moment their
    LiveCollector starts), so each SSE tick is O(campaigns) instead
    of a store-wide two-level listdir."""
    from .runner import store_index
    cands = store_index.live_candidates(store_base)
    if cands is not None:
        best = None
        for rel in cands:
            p = os.path.join(store_base, rel, "live.json")
            try:
                mtime = os.path.getmtime(p)
            except OSError:
                continue
            if best is None or mtime > best[1]:
                best = (p, mtime, rel)
        if best is None:
            return None
        snap = _load_json(best[0])
        if not isinstance(snap, dict):
            return None
        return snap, best[1], best[2]
    best = None
    try:
        names = os.listdir(store_base)
    except OSError:
        return None
    for name in names:
        ndir = os.path.join(store_base, name)
        if not os.path.isdir(ndir):
            continue
        try:
            ids = os.listdir(ndir)
        except OSError:
            continue
        for rid in ids:
            if os.path.islink(os.path.join(ndir, rid)):
                continue  # the `latest` convenience symlink
            p = os.path.join(ndir, rid, "live.json")
            try:
                mtime = os.path.getmtime(p)
            except OSError:
                continue
            if best is None or mtime > best[1]:
                best = (p, mtime, os.path.join(name, rid))
    if best is None:
        return None
    snap = _load_json(best[0])  # atomic rename: never torn, but a
    if not isinstance(snap, dict):  # vanished campaign dir reads None
        return None
    return snap, best[1], best[2]


def live_html() -> str:
    """The /live dashboard shell: an EventSource client that renders
    each SSE snapshot (run states, service occupancy, histogram
    sparklines). Static page — all data arrives over /live?sse=1."""
    return ("<!doctype html><title>live — jepsen_etcd_tpu_torch</title>"
            f"<style>{_CSS}"
            ".spark{font-family:monospace;letter-spacing:1px}"
            "</style>"
            '<p><a href="/">&larr; all runs</a> &middot; '
            '<a href="/aggregate">dashboard</a></p>'
            "<h1>Live campaign</h1>"
            '<div id="s" class="dim">connecting…</div>'
            "<script>\n"
            "const BLOCKS='▁▂▃▄▅▆▇█';\n"
            "function spark(b){const ks=Object.keys(b||{})"
            ".map(Number);if(!ks.length)return'<span class=dim>"
            "(empty)</span>';const lo=Math.min(...ks),"
            "hi=Math.max(...ks);let m=0,out='';"
            "for(let i=lo;i<=hi;i++)m=Math.max(m,b[i]||0);"
            "for(let i=lo;i<=hi;i++){const c=b[i]||0;"
            "out+=BLOCKS[c?Math.min(7,1+Math.floor(6*c/m)):0];}"
            "return'<span class=spark>'+out+'</span>';}\n"
            "function fs(v){if(v==null)return'—';"
            "if(v<1e-3)return(v*1e6).toFixed(0)+'us';"
            "if(v<1)return(v*1e3).toFixed(1)+'ms';"
            "return v.toFixed(2)+'s';}\n"
            "function render(d){\n"
            " if(!d.active&&!d.campaign){document.getElementById('s')"
            ".innerHTML='<p class=unk>no live campaign</p>';return;}\n"
            " let h='<p><b>'+(d.campaign||'?')+'</b> — '+"
            "(d.done?'<span class=ok>finished</span>':"
            "(d.active?'<span class=ok>running</span>':"
            "'<span class=unk>stale</span>'))+"
            "' · '+d.records+' records'+"
            "(d.dropped?' · <span class=bad>'+d.dropped+"
            "' dropped</span>':'')+'</p>';\n"
            " const runs=Object.entries(d.runs||{});\n"
            " h+='<h2>Runs ('+runs.length+')</h2><table><tr>"
            "<th>trace</th><th>host</th><th>status</th><th>phase</th>"
            "<th>spans</th><th>valid</th></tr>';\n"
            " runs.sort();\n"
            " for(const[t,r]of runs){h+='<tr><td><code>'+t+"
            "'</code></td><td>'+(r.host||'—')+'</td><td>'+"
            "(r.status||'running')+'</td><td>'+"
            "(r.phase||'—')+'</td><td>'+(r.spans||0)+'</td><td>'+"
            "(r.valid===true?'<span class=ok>true</span>':"
            "(r.valid===false?'<span class=bad>false</span>':'—'))+"
            "'</td></tr>';}\n"
            " h+='</table>';\n"
            " const s=d.service||{};\n"
            " if(s.ticks)h+='<h2>Checker service</h2><p>'+s.ticks+"
            "' ticks · last: '+(s.packs||0)+' packs from '+"
            "(s.requests||0)+' requests in '+(s.groups||0)+"
            "' groups on <code>'+(s.device||'?')+'</code>'+"
            "(s.runs?' · runs '+s.runs.join(', '):'')+"
            "(s.placement?'<br>chips: '+Object.entries(s.placement)"
            ".sort().map(([d,n])=>'<code>'+d+'</code>&times;'+n)"
            ".join(' · ')+(s.sharded?' · <b>sharded</b>':''):'')+"
            "'</p>';\n"
            " const hists=Object.entries(d.hists||{});\n"
            " if(hists.length){h+='<h2>Distributions</h2><table>"
            "<tr><th>hist</th><th>n</th><th>p50</th><th>p95</th>"
            "<th>sparkline (log2 buckets)</th></tr>';\n"
            "  for(const[n,v]of hists){h+='<tr><td><code>'+n+"
            "'</code></td><td>'+v.count+'</td><td>'+fs(v.p50)+"
            "'</td><td>'+fs(v.p95)+'</td><td>'+spark(v.buckets)+"
            "'</td></tr>';}h+='</table>';}\n"
            " const ctr=Object.entries(d.counters||{});\n"
            " if(ctr.length){h+='<p class=dim>'+ctr.sort()"
            ".map(([k,v])=>k+'='+v).join(' · ')+'</p>';}\n"
            " document.getElementById('s').innerHTML=h;}\n"
            "const es=new EventSource('/live?sse=1');\n"
            "es.onmessage=e=>{const d=JSON.parse(e.data);render(d);"
            "if(d.done||!d.active)es.close();};\n"
            "es.onerror=()=>{es.close();};\n"
            "</script>")


class StoreHandler(SimpleHTTPRequestHandler):
    """Serves the store dir; '/' renders the run index, '/aggregate'
    the cross-run dashboard, run dirs render report pages (?files for
    the raw listing, ?trace for the trace.jsonl viewer)."""

    store_base = "store"

    def __init__(self, *args, **kw):
        super().__init__(*args, directory=self.store_base, **kw)

    def _html(self, body: str) -> None:
        data = body.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _sse_live(self) -> None:
        """``/live?sse=1``: push the live.json snapshot as SSE events
        (~1/s) until the campaign is done, the snapshot goes stale, or
        the client disconnects. Always serves at least one event —
        ``{"active": false}`` when no campaign ever ran live."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        sent = 0
        try:
            while True:
                found = _live_snapshot(self.store_base)
                if found is None:
                    payload, last = {"active": False}, True
                else:
                    snap, mtime, rel = found
                    stale = time.time() - mtime > LIVE_STALE_S
                    done = bool(snap.get("done"))
                    payload = dict(snap, dir=rel,
                                   active=not (done or stale))
                    last = done or stale
                self.wfile.write(
                    b"data: "
                    + json.dumps(payload, default=repr).encode()
                    + b"\n\n")
                self.wfile.flush()
                sent += 1
                if last or sent >= LIVE_MAX_EVENTS:
                    return
                time.sleep(1.0)
        except (BrokenPipeError, ConnectionResetError, OSError):
            return  # client went away: normal for a live view

    def do_GET(self):
        from urllib.parse import parse_qs
        path, _, query = self.path.partition("?")
        if path in ("/", "/index.html"):
            return self._html(index_html(self.store_base))
        if path in ("/aggregate", "/aggregate/"):
            aq = parse_qs(query, keep_blank_values=True)
            return self._html(aggregate_html(
                self.store_base,
                page=(aq.get("page") or [1])[0],
                per=(aq.get("per") or [None])[0]))
        if path in ("/live", "/live/"):
            if "sse" in parse_qs(query, keep_blank_values=True):
                return self._sse_live()
            return self._html(live_html())
        qs = parse_qs(query, keep_blank_values=True)
        if path.endswith("/") and "files" not in qs:
            rel = os.path.normpath(path.strip("/"))
            rdir = os.path.join(self.store_base, rel)
            # only render report pages for real run dirs inside the store
            if not rel.startswith("..") and \
                    os.path.exists(os.path.join(rdir, "results.json")):
                if "trace" in qs:
                    kind = (qs["trace"][0] or "").strip()
                    return self._html(
                        trace_html(self.store_base, rel, kind))
                return self._html(run_html(self.store_base, rel))
        super().do_GET()

    def log_message(self, fmt, *args):  # quiet by default
        pass


def make_server(store_base: str, port: int = 0,
                bind: str = "127.0.0.1") -> ThreadingHTTPServer:
    handler = type("Handler", (StoreHandler,), {"store_base": store_base})
    return ThreadingHTTPServer((bind, port), handler)


def serve_store(store_base: str, port: int = 8080,
                bind: str = "127.0.0.1") -> int:
    srv = make_server(store_base, port, bind)
    host, p = srv.server_address[:2]
    print(f"Serving {store_base} at http://{host}:{p}/ (ctrl-c to stop)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0
