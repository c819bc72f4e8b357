"""Telemetry mining CLI (``python -m jepsen_etcd_tpu_torch tel``).

Queries telemetry artifacts offline — plain jsonl/json reads, no device
work, safe on any host. Four actions over one or many
``telemetry.jsonl`` / ``service.jsonl`` / ``campaign.json`` files:

  (default)    per-span percentile tables, merged hist records, and
               counter totals across every input
  --diff A B   side-by-side span comparison of exactly two inputs
  --ledger D   campaign ledger verification: Σ rows' shipped packs ==
               the service's submitted counter, per-run queue-wait
               attribution re-sums to the service total, and every
               shipping run's trace id appears in some service tick
               span (the cross-process join the trace plane exists
               to make checkable)
  --coverage P per-run + aggregate coverage vector (peak search
               frontier, rung escalations, host spills, verdict
               signatures) — the features the guided
               campaign scheduler will consume

All readers are torn-line tolerant (runner.telemetry.load_jsonl) and
report how many lines they skipped; a killed run must still be
minable.
"""

from __future__ import annotations

import json
import os
from collections import Counter

from .runner.telemetry import Hist, load_jsonl

#: |Σ per-run queue waits − service total| tolerance: the waits are
#: rounded to 1e-6 once at the service and reused verbatim on both
#: sides, so only float summation order can introduce drift
LEDGER_WAIT_TOL = 1e-3


def _fmt_s(v) -> str:
    """Human duration: 1.0e-6 -> '1.0us', 0.012 -> '12.0ms'."""
    if v is None:
        return "-"
    v = float(v)
    if v < 1e-3:
        return f"{v * 1e6:.1f}us"
    if v < 1.0:
        return f"{v * 1e3:.1f}ms"
    return f"{v:.3f}s"


def _resolve(path: str) -> list:
    """A CLI operand names either a jsonl file or a dir holding
    telemetry.jsonl / service.jsonl (run dirs and campaign dirs both
    qualify)."""
    if os.path.isfile(path):
        return [path]
    if os.path.isdir(path):
        found = [os.path.join(path, n)
                 for n in ("telemetry.jsonl", "service.jsonl")
                 if os.path.isfile(os.path.join(path, n))]
        if found:
            return found
    raise SystemExit(f"tel: no telemetry artifacts at {path!r}")


def scan(paths: list) -> dict:
    """Fold a set of jsonl files into one profile: per-span duration
    Hists, merged ``hist`` records, summed counters, trace ids seen,
    and the skipped-line count."""
    prof: dict = {"files": 0, "records": 0, "skipped": 0,
                  "spans": {}, "hists": {}, "counters": {},
                  "traces": set()}
    for p in paths:
        recs, skipped = load_jsonl(p)
        prof["files"] += 1
        prof["skipped"] += skipped
        for rec in recs:
            prof["records"] += 1
            trace = rec.get("trace")
            if trace is not None:
                prof["traces"].add(trace)
            kind = rec.get("kind")
            name = rec.get("name")
            if kind == "span" and isinstance(rec.get("dur_s"),
                                             (int, float)):
                prof["spans"].setdefault(name, Hist()).record(
                    rec["dur_s"])
            elif kind == "counter" and isinstance(rec.get("value"),
                                                  (int, float)):
                prof["counters"][name] = \
                    prof["counters"].get(name, 0) + rec["value"]
            elif kind == "hist":
                prof["hists"].setdefault(name, Hist()).merge(
                    Hist.from_dict(rec))
    return prof


def _span_rows(prof: dict) -> list:
    rows = []
    for name in sorted(prof["spans"]):
        h = prof["spans"][name]
        rows.append({"span": name, "count": h.count,
                     "total_s": round(h.sum, 6),
                     "p50": h.percentile(50), "p95": h.percentile(95),
                     "p99": h.percentile(99)})
    rows.sort(key=lambda r: -r["total_s"])
    return rows


def _print_span_table(rows: list) -> None:
    if not rows:
        print("  (no spans)")
        return
    w = max(len(r["span"]) for r in rows)
    print(f"  {'span':<{w}}  {'count':>7}  {'total':>9}  "
          f"{'p50':>9}  {'p95':>9}  {'p99':>9}")
    for r in rows:
        print(f"  {r['span']:<{w}}  {r['count']:>7}  "
              f"{_fmt_s(r['total_s']):>9}  {_fmt_s(r['p50']):>9}  "
              f"{_fmt_s(r['p95']):>9}  {_fmt_s(r['p99']):>9}")


def cmd_spans(paths: list, as_json: bool) -> int:
    files: list = []
    for p in paths:
        files.extend(_resolve(p))
    prof = scan(files)
    if as_json:
        print(json.dumps({
            "files": prof["files"], "records": prof["records"],
            "skipped": prof["skipped"],
            "traces": sorted(prof["traces"]),
            "spans": {n: dict(h.to_dict(), name=n)
                      for n, h in prof["spans"].items()},
            "hists": {n: h.to_dict()
                      for n, h in prof["hists"].items()},
            "counters": prof["counters"]}, indent=2, sort_keys=True))
        return 0
    print(f"{prof['files']} file(s), {prof['records']} records"
          f" ({prof['skipped']} torn/skipped lines),"
          f" {len(prof['traces'])} trace id(s)")
    print("spans:")
    _print_span_table(_span_rows(prof))
    if prof["hists"]:
        print("hist records:")
        for n in sorted(prof["hists"]):
            d = prof["hists"][n].to_dict()
            print(f"  {n}: count={d['count']} "
                  f"p50={_fmt_s(d['p50'])} p95={_fmt_s(d['p95'])} "
                  f"p99={_fmt_s(d['p99'])}")
    if prof["counters"]:
        print("counters:")
        for n in sorted(prof["counters"]):
            v = prof["counters"][n]
            v = round(v, 6) if isinstance(v, float) else v
            print(f"  {n} = {v}")
    return 0


def _merge_profiles(profs: list) -> dict:
    """Fold per-file profiles into one. Bit-identical to a single
    scan() over the same files for everything --diff prints: counts
    are ints and percentiles derive from bucket counts + exact
    min/max, none of which depend on float-summation order."""
    out: dict = {"files": 0, "records": 0, "skipped": 0,
                 "spans": {}, "hists": {}, "counters": {},
                 "traces": set()}
    for p in profs:
        out["files"] += p["files"]
        out["records"] += p["records"]
        out["skipped"] += p["skipped"]
        for n, h in p["spans"].items():
            out["spans"].setdefault(n, Hist()).merge(h)
        for n, h in p["hists"].items():
            out["hists"].setdefault(n, Hist()).merge(h)
        for n, v in p["counters"].items():
            out["counters"][n] = out["counters"].get(n, 0) + v
        out["traces"] |= p["traces"]
    return out


def _scan_cached(files: list, use_index: bool) -> dict:
    """scan(), but each file's profile is served from its store
    index's tel_cache when fresh (runner/store_index.tel_profile) —
    repeat diffs against a hot store re-read nothing."""
    if not use_index:
        return scan(files)
    from .runner import store_index
    return _merge_profiles(
        [store_index.tel_profile(f, scan) for f in files])


def cmd_diff(paths: list, as_json: bool,
             use_index: bool = True) -> int:
    if len(paths) != 2:
        raise SystemExit("tel --diff takes exactly two inputs")
    pa = _scan_cached(_resolve(paths[0]), use_index)
    pb = _scan_cached(_resolve(paths[1]), use_index)
    names = sorted(set(pa["spans"]) | set(pb["spans"]))
    delta = []
    for n in names:
        ha, hb = pa["spans"].get(n), pb["spans"].get(n)
        a95 = ha.percentile(95) if ha else None
        b95 = hb.percentile(95) if hb else None
        ratio = (b95 / a95) if a95 and b95 else None
        delta.append({"span": n,
                      "count_a": ha.count if ha else 0,
                      "count_b": hb.count if hb else 0,
                      "p95_a": a95, "p95_b": b95,
                      "p95_ratio": (round(ratio, 3)
                                    if ratio is not None else None)})
    if as_json:
        print(json.dumps({"a": paths[0], "b": paths[1],
                          "skipped": [pa["skipped"], pb["skipped"]],
                          "spans": delta}, indent=2, sort_keys=True))
        return 0
    print(f"A = {paths[0]}  ({pa['records']} records, "
          f"{pa['skipped']} skipped)")
    print(f"B = {paths[1]}  ({pb['records']} records, "
          f"{pb['skipped']} skipped)")
    if not delta:
        print("  (no spans on either side)")
        return 0
    w = max(len(d["span"]) for d in delta)
    print(f"  {'span':<{w}}  {'n(A)':>6}  {'n(B)':>6}  "
          f"{'p95(A)':>9}  {'p95(B)':>9}  {'B/A':>6}")
    for d in delta:
        r = "-" if d["p95_ratio"] is None else f"{d['p95_ratio']:.2f}x"
        print(f"  {d['span']:<{w}}  {d['count_a']:>6}  "
              f"{d['count_b']:>6}  {_fmt_s(d['p95_a']):>9}  "
              f"{_fmt_s(d['p95_b']):>9}  {r:>6}")
    return 0


def _load_campaign(path: str) -> tuple:
    """(campaign dir, summary dict) from a dir or campaign.json path."""
    if os.path.isdir(path):
        cpath = os.path.join(path, "campaign.json")
    else:
        cpath, path = path, os.path.dirname(path) or "."
    try:
        with open(cpath) as fh:
            summary = json.load(fh)
    except (OSError, json.JSONDecodeError, ValueError) as e:
        raise SystemExit(f"tel: cannot read {cpath!r}: {e}")
    if not isinstance(summary, dict) or "runs" not in summary:
        raise SystemExit(f"tel: {cpath!r} is not a campaign summary")
    return path, summary


def ledger(path: str, use_index: bool = True) -> dict:
    """Verify the campaign's cross-process accounting. Three checks:
    shipped-pack conservation, queue-wait attribution, and the
    trace join between runner rows and service tick spans."""
    cdir, summary = _load_campaign(path)
    rows = [r for r in (summary.get("runs") or [])
            if isinstance(r, dict)]
    done = [r for r in rows if r.get("status") == "done"]
    sctr = (summary.get("service") or {}).get("counters") or {}
    checks = []

    shipped = sum(int(r.get("service_shipped") or 0) for r in done)
    submitted = int(sctr.get("service.submitted", 0))
    checks.append({"check": "shipped==submitted",
                   "ok": shipped == submitted,
                   "detail": f"rows shipped {shipped}, "
                             f"service submitted {submitted}"})

    row_wait = sum(float(r.get("service_queue_wait_s") or 0.0)
                   for r in done)
    svc_wait = float(sctr.get("service.queue_wait_s", 0.0))
    checks.append({"check": "queue_wait attribution",
                   "ok": abs(row_wait - svc_wait) <= LEDGER_WAIT_TOL,
                   "detail": f"rows {round(row_wait, 6)}s, "
                             f"service {round(svc_wait, 6)}s"})

    svc_log = os.path.join(cdir, "service.jsonl")
    if os.path.isfile(svc_log):
        # the index row captured the tick-span trace join at campaign
        # fold time (service.jsonl is complete then); it is used only
        # while the file's fingerprint still matches
        cached = None
        if use_index:
            from .runner import store_index
            cached = store_index.ledger_ticks(cdir)
        if cached is not None:
            ticked, skipped = cached
        else:
            recs, skipped = load_jsonl(svc_log)
            ticked = set()
            for rec in recs:
                if rec.get("kind") == "span" and \
                        rec.get("name") == "service.tick":
                    ticked.update((rec.get("attrs") or {})
                                  .get("runs") or ())
        shippers = {r.get("trace") for r in done
                    if int(r.get("service_shipped") or 0) > 0
                    and r.get("trace") is not None}
        missing = sorted(shippers - ticked)
        checks.append({"check": "trace join (rows ⊆ tick spans)",
                       "ok": not missing,
                       "detail": f"{len(shippers)} shipping run(s), "
                                 f"{len(ticked)} trace(s) in tick "
                                 f"spans, {skipped} torn line(s)"
                                 + (f"; missing {missing}"
                                    if missing else "")})
    else:
        checks.append({"check": "trace join (rows ⊆ tick spans)",
                       "ok": None,
                       "detail": "no service.jsonl (service "
                                 "disabled or inline runs)"})
    return {"campaign": summary.get("trace") or summary.get("name"),
            "dir": cdir, "runs": len(rows), "done": len(done),
            "checks": checks,
            "ok": all(c["ok"] is not False for c in checks)}


def cmd_ledger(paths: list, as_json: bool,
               use_index: bool = True) -> int:
    out = ledger(paths[0], use_index=use_index)
    if as_json:
        print(json.dumps(out, indent=2, sort_keys=True))
        return 0 if out["ok"] else 1
    print(f"ledger: {out['campaign']}  "
          f"({out['done']}/{out['runs']} runs done)")
    for c in out["checks"]:
        mark = {True: "ok  ", False: "FAIL", None: "skip"}[c["ok"]]
        print(f"  [{mark}] {c['check']}: {c['detail']}")
    print("ledger verified" if out["ok"] else "LEDGER MISMATCH")
    return 0 if out["ok"] else 1


def _coverage_dirs(path: str) -> list:
    """Run dirs behind a coverage operand: a campaign dir (rows'
    dirs), a single run dir, or a store base (every run under it)."""
    if os.path.isfile(os.path.join(path, "campaign.json")) or \
            path.endswith("campaign.json"):
        cdir, summary = _load_campaign(path)
        out = []
        for r in summary.get("runs") or []:
            if isinstance(r, dict) and r.get("dir"):
                d = r["dir"]
                out.append(d if os.path.isabs(d)
                           else os.path.join(cdir, d))
        return out
    if os.path.isfile(os.path.join(path, "results.json")):
        return [path]
    out = []
    for root, dirs, files in os.walk(path, followlinks=False):
        dirs[:] = [d for d in dirs
                   if not os.path.islink(os.path.join(root, d))]
        if "results.json" in files:
            out.append(root)
            dirs[:] = []
    return sorted(out)


def _read_vector(rdir: str):
    """One run's coverage vector straight from its results.json;
    None when unreadable (the walk skips those)."""
    from .runner.store_index import coverage_fields
    try:
        with open(os.path.join(rdir, "results.json")) as fh:
            results = json.load(fh)
    except (OSError, json.JSONDecodeError, ValueError):
        return None
    return coverage_fields(results)


def coverage(path: str, use_index: bool = True) -> dict:
    """The guided-campaign feature vector: how hard the checker had
    to work (frontier/rungs/spills) and what verdicts the fleet
    produced (failure-signature histogram). Vector derivation lives
    in runner/store_index.coverage_fields — shared with the index
    writer, so the index path below is bit-identical to the walk.

    A multi-host campaign's rows are tolerated, not required, to have
    artifacts on this machine: error rows (agent deaths past the
    requeue cap, crashed epilogues) carry no ``dir``, and a re-queued
    or inline-stranded run may lack ``telemetry.jsonl``/``results.json``
    — those fold into ``aggregate.skipped`` instead of erroring, and
    the rows' per-host column folds into ``aggregate.hosts``."""
    from .runner import store_index
    rows_meta = None
    is_campaign = os.path.isfile(
        os.path.join(path, "campaign.json")) or \
        path.endswith("campaign.json")
    if is_campaign:
        _, summary = _load_campaign(path)
        rows_meta = [r for r in (summary.get("runs") or [])
                     if isinstance(r, dict)]
    runs = []
    if not is_campaign and use_index and \
            not os.path.isfile(os.path.join(path, "results.json")):
        # store-base operand: replay the index (recursing into guided
        # sub-indexes) instead of walking the tree
        pairs = store_index.coverage_run_vectors(path)
        if pairs is not None:
            runs = [dict(dir=d, **vec) for d, vec in pairs]
    if not runs:
        for rdir in _coverage_dirs(path):
            vec = store_index.run_vector(rdir) if use_index else None
            if vec is None:
                vec = _read_vector(rdir)
            if vec is None:
                continue
            runs.append(dict(dir=rdir, **vec))
    sigs = Counter(r["signature"] for r in runs if r["signature"])
    buckets: Counter = Counter()
    for r in runs:
        buckets.update(r["wave_hist"])
    agg = {"count": len(runs),
           "peak_frontier": max((r["frontier"] for r in runs),
                                default=0),
           "peak_waves": max((r["waves"] for r in runs), default=0),
           "rungs": sum(r["rungs"] for r in runs),
           "spills": sum(r["spills"] for r in runs),
           "invalid": sum(1 for r in runs
                          if r["valid"] is not True),
           "wave_hist": dict(sorted(buckets.items())),
           "signatures": dict(sorted(sigs.items()))}
    if rows_meta is not None:
        agg["rows"] = len(rows_meta)
        agg["skipped"] = max(0, len(rows_meta) - len(runs))
        hosts: dict = {}
        for r in rows_meta:
            st = hosts.setdefault(r.get("host") or "local",
                                  {"runs": 0, "invalid": 0,
                                   "errors": 0})
            st["runs"] += 1
            if r.get("status") != "done":
                st["errors"] += 1
            elif r.get("valid") is not True:
                st["invalid"] += 1
        agg["hosts"] = hosts
    return {"runs": runs, "aggregate": agg}


def cmd_coverage(paths: list, as_json: bool,
                 use_index: bool = True) -> int:
    out = coverage(paths[0], use_index=use_index)
    if as_json:
        print(json.dumps(out, indent=2, sort_keys=True))
        return 0
    agg = out["aggregate"]
    print(f"coverage over {agg['count']} run(s):")
    for r in out["runs"]:
        sig = f"  [{r['signature']}]" if r["signature"] else ""
        print(f"  {os.path.basename(r['dir'])}: "
              f"valid={r['valid']} frontier={r['frontier']} "
              f"waves={r['waves']} "
              f"rungs={r['rungs']} spills={r['spills']}{sig}")
    print(f"aggregate: peak_frontier={agg['peak_frontier']} "
          f"peak_waves={agg['peak_waves']} "
          f"rungs={agg['rungs']} spills={agg['spills']} "
          f"invalid={agg['invalid']}")
    if "rows" in agg:
        print(f"  campaign rows: {agg['rows']} "
              f"({agg['skipped']} without local artifacts)")
        for host, st in sorted(agg.get("hosts", {}).items()):
            print(f"  host {host}: runs={st['runs']} "
                  f"invalid={st['invalid']} errors={st['errors']}")
    for sig, n in agg["signatures"].items():
        print(f"  signature x{n}: {sig}")
    return 0


def _find_guided(path: str, use_index: bool = True) -> str:
    """Resolve a --corpus operand to a guided.json: the file itself, a
    guided dir containing one, or a store base (newest guided run,
    answered by the store index when one exists)."""
    if os.path.isfile(path) and path.endswith("guided.json"):
        return path
    direct = os.path.join(path, "guided.json")
    if os.path.isfile(direct):
        return direct
    if use_index:
        from .runner import store_index
        got = store_index.newest_guided(path)
        if got is not None:
            return got[1]
    cands = []
    for root, dirs, files in os.walk(path, followlinks=False):
        dirs[:] = [d for d in dirs
                   if not os.path.islink(os.path.join(root, d))]
        if "guided.json" in files:
            p = os.path.join(root, "guided.json")
            cands.append((os.path.getmtime(p), p))
            dirs[:] = []
    if not cands:
        raise SystemExit(f"tel: no guided.json under {path!r}")
    return max(cands)[1]


def corpus(path: str, use_index: bool = True) -> dict:
    """A guided campaign's search summary (guided.json)."""
    gpath = _find_guided(path, use_index=use_index)
    try:
        with open(gpath) as fh:
            out = json.load(fh)
    except (OSError, json.JSONDecodeError, ValueError) as e:
        raise SystemExit(f"tel: unreadable guided summary "
                         f"{gpath!r}: {e}")
    out["path"] = gpath
    return out


def cmd_corpus(paths: list, as_json: bool,
               use_index: bool = True) -> int:
    out = corpus(paths[0], use_index=use_index)
    if as_json:
        print(json.dumps(out, indent=2, sort_keys=True))
        return 0
    print(f"guided campaign {out.get('name')}: "
          f"{out.get('runs')}/{out.get('budget')} runs over "
          f"{out.get('generations')} generation(s), "
          f"master seed {out.get('master_seed')}")
    sigs = out.get("signatures") or {}
    for sig, run_no in sorted(sigs.items(), key=lambda kv: kv[1]):
        print(f"  signature @run {run_no}: {sig}")
    ff = out.get("first_failure_run")
    print(f"  first failure: "
          f"{'run %d' % ff if ff else '(none)'}  "
          f"envelope={out.get('envelope')}")
    for c in out.get("corpus") or []:
        print(f"  ancestor @run {c.get('run')}: "
              f"{c.get('opts', {}).get('workload')}/"
              f"{','.join(c.get('opts', {}).get('nemesis') or []) or '-'}"
              f" seed={c.get('seed')} score={c.get('score')}"
              + (f" [{c['signature']}]" if c.get("signature") else ""))
    for m in out.get("minimized") or []:
        print(f"  minimized @run {m.get('run')}: "
              f"{m.get('original_windows')}→{m.get('windows')} "
              f"window(s), {m.get('nemesis_ops')} nemesis op(s) "
              f"[{m.get('signature')}]")
        print(f"    repro: {m.get('repro')}")
    return 0


def run(args) -> int:
    """Entry point for the ``tel`` subcommand (cli.main dispatches
    before any device work)."""
    use_index = not getattr(args, "no_index", False)
    try:
        if args.ledger:
            return cmd_ledger(args.paths, args.as_json,
                              use_index=use_index)
        if getattr(args, "corpus", False):
            return cmd_corpus(args.paths, args.as_json,
                              use_index=use_index)
        if args.coverage:
            return cmd_coverage(args.paths, args.as_json,
                                use_index=use_index)
        if args.diff:
            return cmd_diff(args.paths, args.as_json,
                            use_index=use_index)
        return cmd_spans(args.paths, args.as_json)
    except BrokenPipeError:
        # `tel ... | head` closing stdout early is normal usage
        return 0
