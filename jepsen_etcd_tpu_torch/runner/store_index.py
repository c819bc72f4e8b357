"""The indexed artifact store: a sqlite run index under each store base.

The reference harness re-reads every run's artifacts wholesale on each
``/aggregate`` request and each ``tel`` invocation — O(all runs ever)
per query, fatal at fleet scale (ROADMAP direction 5). This module
keeps one append-only index per store base (``<base>/index.sqlite``,
WAL mode): one row per run/campaign/guided/shrink artifact holding the
EXACT summary dict the dashboards consume, written at
``save_run``/campaign-fold time and replayed incrementally by readers
through a per-process high-water-mark fold.

Layout facts the index encodes (runner/campaign.py:595): every run
lands exactly TWO levels below its store base, so a run's index lives
at ``dirname(dirname(run_dir))/index.sqlite``. Guided campaigns pass
``store_base=<guided dir>``, which makes each guided dir its own index
base; readers that need the full tree (``tel --coverage``, the shrink
table) recurse through the base index's guided rows into those
sub-indexes.

Row derivation is shared with the tree-walk paths (serve.py and
tel_cli.py call :func:`run_row` / :func:`coverage_fields` / … on both
sides), so index-backed output is bit-identical to a walk by
construction — the property tests/test_store_index.py pins.

Change feed: every insert/update/tombstone bumps a monotonically
increasing ``seq`` inside the write transaction; a reader folds
``seq > hwm`` only. A full ``rebuild`` bumps the ``epoch`` meta key so
stale folds drop their cache instead of merging across generations.

No wall clock, no randomness, no device work — safe to import
anywhere.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sqlite3
from typing import Any, Optional

from .store import failure_signature
from .telemetry import Hist, load_jsonl

INDEX_NAME = "index.sqlite"
SCHEMA_VERSION = 1

#: artifacts `store compact` keeps in a demoted passing run — the
#: summaries every reader consumes. Everything else in the run dir
#: (history.jsonl, telemetry.jsonl, trace.jsonl, plots, node log
#: dirs) is deleted; FAILING runs are never touched at all.
COMPACT_KEEP = ("results.json", "test.json", "shrink.json")

#: newest runs `store compact` always spares, regardless of verdict
COMPACT_KEEP_NEWEST = 32

_DDL = """
CREATE TABLE IF NOT EXISTS rows (
    kind TEXT NOT NULL,
    dir TEXT NOT NULL,
    seq INTEGER NOT NULL,
    mtime REAL,
    deleted INTEGER NOT NULL DEFAULT 0,
    compacted INTEGER NOT NULL DEFAULT 0,
    row TEXT NOT NULL,
    PRIMARY KEY (kind, dir));
CREATE INDEX IF NOT EXISTS rows_seq ON rows (seq);
CREATE TABLE IF NOT EXISTS tel_cache (
    path TEXT PRIMARY KEY,
    mtime_ns INTEGER,
    size INTEGER,
    profile TEXT);
CREATE TABLE IF NOT EXISTS meta (
    key TEXT PRIMARY KEY,
    value TEXT);
"""


# -- row derivation (shared by index writers AND tree-walk readers) ----------

def overlap_ratio(phases: dict, counters: dict):
    """End-to-end-over-generation ratio for streamed runs: how close
    checking came to free. (generate + stream-finalize + check) /
    generate — 1.0 means verification added no wall time beyond
    generation. None for runs that never streamed a chunk."""
    if not counters.get("stream.chunks"):
        return None
    gen = phases.get("generate")
    if not isinstance(gen, (int, float)) or gen <= 0:
        return None
    extra = sum(phases.get(k) or 0 for k in ("stream-finalize", "check"))
    return (gen + extra) / gen


#: MVCC consistency-surface checker keys (checkers/mvcc.py) surfaced
#: as their own /aggregate column: surface name -> short label
SURFACES = {"staleness": "stale", "ranges": "ranges",
            "lease": "lease", "watch-mvcc": "watch"}


def consistency_surface(results: dict) -> dict:
    """``{label: {"valid": verdict, "violations": n}}`` for every MVCC
    surface checker that ran in this run's composed workload result."""
    wlr = results.get("workload")
    out = {}
    if isinstance(wlr, dict):
        for key, label in SURFACES.items():
            sub = wlr.get(key)
            if isinstance(sub, dict) and "valid?" in sub:
                out[label] = {
                    "valid": sub.get("valid?"),
                    "violations": sub.get("violation-count", 0)}
    return out


def run_row(rel: str, results: dict, test: dict, mtime: float) -> dict:
    """The /aggregate run row for one saved run — the single source
    serve.py's walk path and the index writer both call, so stored
    rows replay bit-identically."""
    ops = (results.get("stats") or {}).get("count")
    tel = results.get("telemetry") or {}
    nem = test.get("nemesis_spec") or []
    if isinstance(nem, (list, tuple)):
        nem = ",".join(str(n) for n in nem)
    return {"dir": rel, "mtime": mtime,
            "valid?": results.get("valid?", "?"),
            "name": test.get("name", rel.split(os.sep)[0]),
            "workload": test.get("workload", "?"),
            "nemesis": nem or "none",
            "db": test.get("db_mode") or "sim",
            "time_limit": test.get("time_limit"),
            "ops": ops,
            "phases": tel.get("phases") or {},
            "gen_rate": (tel.get("counters") or {})
            .get("generate.ops_per_s"),
            "overlap": overlap_ratio(
                tel.get("phases") or {},
                tel.get("counters") or {}),
            "consistency": consistency_surface(results),
            "signature": failure_signature(results)}


def host_ledger(summary: dict, sctr: dict) -> Optional[dict]:
    """Per-host attribution for a multi-host campaign: the rows' fold
    (runs + shipped per host, producer side) joined with the service's
    ``service.host_submitted.<host>`` counters (consumer side). The
    two shipped numbers must agree — that is the cross-host
    shipped==submitted ledger. None for single-host campaigns."""
    hosts = summary.get("hosts")
    if not isinstance(hosts, dict) or not hosts:
        return None
    out = {}
    for h, st in sorted(hosts.items()):
        st = dict(st) if isinstance(st, dict) else {}
        st["submitted"] = sctr.get("service.host_submitted." + h)
        out[h] = st
    return out


def chip_util(sctr: dict) -> Optional[dict]:
    """Per-chip utilization summary from a campaign's folded service
    counters (the sharded dispatcher's ledger): group dispatches and
    busy wall per device, the max/min dispatch balance ratio, and peak
    per-tick device occupancy. None for single-device/legacy
    campaigns, which recorded no per-device dispatch series."""
    pfx_d = "service.device_dispatches."
    pfx_b = "service.device_busy_s."
    disp = {k[len(pfx_d):]: int(v or 0) for k, v in sctr.items()
            if k.startswith(pfx_d)}
    if not disp:
        return None
    busy = {k[len(pfx_b):]: float(v or 0.0) for k, v in sctr.items()
            if k.startswith(pfx_b)}
    lo = min(disp.values())
    return {
        "devices": len(disp),
        "dispatches": disp,
        "busy_s": busy,
        "balance": (max(disp.values()) / lo) if lo else None,
        "occupancy": sctr.get("service.device_occupancy"),
        "sharded_ticks": sctr.get("service.sharded_ticks"),
    }


def campaign_row(rel: str, summary: dict, mtime: float) -> dict:
    """The /aggregate campaign-trend row for one campaign.json."""
    runs = [r for r in (summary.get("runs") or [])
            if isinstance(r, dict)]
    done = [r for r in runs if r.get("status") == "done"]
    rates = [r["gen_ops_per_s"] for r in done
             if isinstance(r.get("gen_ops_per_s"), (int, float))]
    sctr = ((summary.get("service") or {}).get("counters") or {})
    svc_disp = sum(int(sctr.get(k, 0) or 0)
                   for k in ("wgl.dispatches", "mxu.dispatches"))
    local_disp = sum(int(r.get("dispatches") or 0) for r in done)
    # lossy-link diagnosis triple, summed over the rows' net.*
    # counters (runner/campaign._row_net)
    net = {"dropped_chunks": 0, "accept_errors": 0, "delayed_bytes": 0}
    for r in done:
        for k in net:
            try:
                net[k] += int((r.get("net") or {}).get(k) or 0)
            except (TypeError, ValueError):
                pass
    return {
        "dir": rel,
        "mtime": mtime, "name": summary.get("name",
                                            rel.split(os.sep)[0]),
        "count": summary.get("count"),
        "pool": summary.get("pool"),
        "valid?": summary.get("valid?", "?"),
        "wall_s": summary.get("wall_s"),
        "gen_rate": (sum(rates) / len(rates)) if rates else None,
        # batched lockstep generation (simbatch epoch-v2 routing):
        # aggregate events/s across each cell's seed batch, None for
        # epoch-v1-only campaigns
        "genbatch": summary.get("genbatch") or None,
        "check_s": sum(r.get("check_s") or 0 for r in done),
        "dispatches": svc_disp + local_disp,
        "submitted": sctr.get("service.submitted"),
        "group_ticks": sctr.get("service.group_ticks"),
        "occupancy": sctr.get("service.batch_occupancy"),
        "chips": chip_util(sctr),
        "fallbacks": sum(int(r.get("service_fallbacks") or 0)
                         for r in done),
        # multi-host campaigns: per-host run/shipped fold joined
        # against the service's per-host submitted series (the
        # cross-host ledger, runner/host_agent.py)
        "hosts": host_ledger(summary, sctr),
        "agent_requeues": int(summary.get("agent_requeues") or 0),
        # campaign-wide merged-histogram percentiles
        # ({label: [p50, p95, p99]}, seconds)
        "p": summary.get("p") if isinstance(summary.get("p"), dict)
        else {},
        "net": net,
    }


def guided_row(rel: str, summary: dict, mtime: float) -> dict:
    """The /aggregate guided-campaign row for one guided.json."""
    return {
        "dir": rel,
        "mtime": mtime,
        "name": summary.get("name", rel.split(os.sep)[0]),
        "budget": summary.get("budget"),
        "runs": summary.get("runs"),
        "generations": summary.get("generations"),
        "signatures": summary.get("signatures") or {},
        "first_failure_run": summary.get("first_failure_run"),
        "corpus": len(summary.get("corpus") or []),
        "minimized": summary.get("minimized") or [],
        "wall_s": summary.get("wall_s"),
    }


def shrink_row(rel: str, art: dict, mtime: float) -> dict:
    """The /aggregate minimized-repro row for one shrink.json."""
    return {
        "dir": rel,
        "mtime": mtime,
        "workload": art.get("workload"),
        "signature": art.get("signature"),
        "original_windows": art.get("original_windows"),
        "windows": art.get("windows"),
        "nemesis_ops": art.get("nemesis_ops"),
        "rounds": art.get("rounds"),
        "executions": art.get("executions"),
        "repro": art.get("repro"),
    }


def coverage_fields(results: Any) -> Optional[dict]:
    """The ``tel --coverage`` feature vector of one run (minus its
    ``dir``): checker effort (frontier/rungs/spills/wave depth), the
    per-rung dispatch-shape histogram, and the verdict signature.
    None for unreadable/non-dict results (the walk skips those)."""
    if not isinstance(results, dict):
        return None
    tel_sum = results.get("telemetry") or {}
    ctr = tel_sum.get("counters") or {}
    # per-rung dispatch shape: the wgl.rung_waves histogram puts each
    # ladder rung in its own log2 bucket, so {bucket: dispatches} IS
    # the search-depth distribution — guided novelty scores
    # newly-occupied buckets (+1 each)
    wave_hist = {
        int(b): int(c)
        for b, c in (((tel_sum.get("hists") or {})
                      .get("wgl.rung_waves") or {})
                     .get("buckets") or {}).items()}
    return {"valid": results.get("valid?"),
            "frontier": int(ctr.get("wgl.max-frontier", 0)),
            "rungs": int(ctr.get("wgl.rungs", 0)),
            "spills": int(ctr.get("wgl.host-spill", 0)),
            "waves": int(ctr.get("wgl.waves", 0)),
            "wave_hist": wave_hist,
            "signature": failure_signature(results)}


def _cov_restore(cov: dict) -> dict:
    """A coverage vector back from its JSON index row: wave_hist keys
    are ints in the live vector but strings after a JSON round-trip —
    ``json.dumps(sort_keys=True)`` orders int keys numerically and str
    keys lexically ("10" < "3"), so the restore is load-bearing for
    bit-identical ``tel --coverage`` output."""
    out = dict(cov)
    out["wave_hist"] = {int(b): int(c)
                        for b, c in (cov.get("wave_hist") or {}).items()}
    return out


def _load_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError, ValueError):
        return None


# -- sqlite plumbing ----------------------------------------------------------

def _db_path(base: str) -> str:
    return os.path.join(base, INDEX_NAME)


def has_index(base: str) -> bool:
    return os.path.isfile(_db_path(base))


def _connect(base: str, create: bool = False):
    """A WAL-mode connection to the base's index, or None when the
    index does not exist and ``create`` is False."""
    path = _db_path(base)
    if not create and not os.path.isfile(path):
        return None
    if create and not os.path.isdir(base):
        os.makedirs(base, exist_ok=True)
    con = sqlite3.connect(path, timeout=30.0)
    con.isolation_level = None  # explicit BEGIN/COMMIT only
    con.execute("PRAGMA journal_mode=WAL")
    con.execute("PRAGMA synchronous=NORMAL")
    con.executescript(_DDL)
    con.execute(
        "INSERT OR IGNORE INTO meta (key, value) VALUES ('schema', ?)",
        (str(SCHEMA_VERSION),))
    return con


def _counter(name: str, value: float = 1) -> None:
    from . import telemetry
    telemetry.current().counter(name, value)


def _next_seq(con) -> int:
    return int(con.execute(
        "SELECT COALESCE(MAX(seq), 0) FROM rows").fetchone()[0]) + 1


def _upsert(con, entries) -> int:
    """Write (kind, rel, mtime, deleted, compacted, row_dict) tuples
    under one already-open transaction, each with a fresh seq."""
    seq = _next_seq(con) - 1
    n = 0
    for kind, rel, mtime, deleted, compacted, row in entries:
        seq += 1
        con.execute(
            "INSERT INTO rows (kind, dir, seq, mtime, deleted, "
            "compacted, row) VALUES (?, ?, ?, ?, ?, ?, ?) "
            "ON CONFLICT (kind, dir) DO UPDATE SET "
            "seq=excluded.seq, mtime=excluded.mtime, "
            "deleted=excluded.deleted, compacted=excluded.compacted, "
            "row=excluded.row",
            (kind, rel, seq, mtime, int(bool(deleted)),
             int(bool(compacted)), json.dumps(row or {},
                                              sort_keys=True)))
        n += 1
    return n


def _write(base: str, entries, create: bool = True) -> int:
    """Transactionally upsert entries into the base's index;
    best-effort (a failed index write must never fail a run save).
    Returns the number of rows written (0 on any failure).

    First write into an UNINDEXED base triggers a full rebuild
    instead: upserting one row into a fresh index over a pre-existing
    tree would leave readers trusting a partial index. The rebuild
    already covers artifacts on disk; the upsert after it is an
    idempotent no-op for those and still lands not-yet-on-disk rows
    (note_live registrations)."""
    try:
        if create and not has_index(base):
            rebuild(base)
    except (sqlite3.Error, OSError):
        return 0
    try:
        con = _connect(base, create=create)
    except (sqlite3.Error, OSError):
        return 0
    if con is None:
        return 0
    try:
        con.execute("BEGIN IMMEDIATE")
        n = _upsert(con, entries)
        con.execute("COMMIT")
        if n:
            _counter("store.index_writes", n)
        return n
    except (sqlite3.Error, OSError):
        try:
            con.execute("ROLLBACK")
        except sqlite3.Error:
            pass
        return 0
    finally:
        con.close()


def mark_deleted(base: str, rels) -> None:
    """Tombstone every kind of row at the given relative dirs (store
    rotation removed them from disk)."""
    try:
        con = _connect(base, create=False)
    except (sqlite3.Error, OSError):
        return
    if con is None:
        return
    try:
        con.execute("BEGIN IMMEDIATE")
        seq = _next_seq(con)
        for rel in sorted(rels):
            con.execute(
                "UPDATE rows SET deleted=1, seq=? "
                "WHERE dir=? AND deleted=0", (seq, rel))
            seq += 1
        con.execute("COMMIT")
    except (sqlite3.Error, OSError):
        try:
            con.execute("ROLLBACK")
        except sqlite3.Error:
            pass
    finally:
        con.close()


# -- index writers (the save_run / fold-time hooks) ---------------------------

def _run_entry(base: str, rel: str):
    rdir = os.path.join(base, rel)
    results = _load_json(os.path.join(rdir, "results.json"))
    test = _load_json(os.path.join(rdir, "test.json"))
    try:
        mtime = os.path.getmtime(rdir)
    except OSError:
        mtime = 0
    serve = run_row(rel, results if isinstance(results, dict) else {},
                    test if isinstance(test, dict) else {}, mtime)
    compacted = not os.path.exists(os.path.join(rdir, "history.jsonl"))
    row = {"serve": serve, "cov": coverage_fields(results)}
    return ("run", rel, mtime, 0, compacted, row)


def record_run(store_dir: str) -> bool:
    """Index one saved run (called by store.save_run after the
    artifacts hit disk). The row is derived by re-reading the exact
    JSON just written, so it replays bit-identically to a tree walk."""
    store_dir = os.path.abspath(store_dir)
    base = os.path.dirname(os.path.dirname(store_dir))
    rel = os.path.relpath(store_dir, base)
    return _write(base, [_run_entry(base, rel)]) > 0


def _ledger_payload(cdir: str) -> dict:
    """The ``tel --ledger`` trace-join inputs, captured at campaign
    fold time (service.jsonl is complete then): every trace id named
    by a service.tick span, plus the torn-line count — with the file's
    fingerprint so readers can detect a post-fold rewrite."""
    svc = os.path.join(cdir, "service.jsonl")
    if not os.path.isfile(svc):
        return {"has_service": False}
    recs, skipped = load_jsonl(svc)
    ticked = set()
    for rec in recs:
        if rec.get("kind") == "span" and \
                rec.get("name") == "service.tick":
            ticked.update((rec.get("attrs") or {}).get("runs") or ())
    try:
        st = os.stat(svc)
        fp = [st.st_mtime_ns, st.st_size]
    except OSError:
        fp = None
    return {"has_service": True,
            "ticked": sorted(str(t) for t in ticked),
            "skipped": skipped, "fp": fp}


def _campaign_entry(base: str, rel: str):
    cdir = os.path.join(base, rel)
    cpath = os.path.join(cdir, "campaign.json")
    summary = _load_json(cpath)
    if not isinstance(summary, dict) or "runs" not in summary:
        return None
    try:
        mtime = os.path.getmtime(cpath)
    except OSError:
        mtime = 0
    row = {"serve": campaign_row(rel, summary, mtime),
           "ledger": _ledger_payload(cdir)}
    return ("campaign", rel, mtime, 0, 0, row)


def record_campaign(cdir: str) -> bool:
    """Index one folded campaign (called by run_campaign right after
    campaign.json lands). Also tombstones the dir's 'live' row — the
    campaign row takes over as the live-polling candidate."""
    cdir = os.path.abspath(cdir)
    base = os.path.dirname(os.path.dirname(cdir))
    rel = os.path.relpath(cdir, base)
    entry = _campaign_entry(base, rel)
    if entry is None:
        return False
    return _write(base, [entry,
                         ("live", rel, entry[2], 1, 0, None)]) > 0


def _guided_entry(base: str, rel: str):
    gpath = os.path.join(base, rel, "guided.json")
    summary = _load_json(gpath)
    if not isinstance(summary, dict) or summary.get("kind") != "guided":
        return None
    try:
        mtime = os.path.getmtime(gpath)
    except OSError:
        mtime = 0
    return ("guided", rel, mtime, 0, 0,
            {"serve": guided_row(rel, summary, mtime)})


def record_guided(gdir: str) -> bool:
    """Index one folded guided campaign (guided.json just written)."""
    gdir = os.path.abspath(gdir)
    base = os.path.dirname(os.path.dirname(gdir))
    rel = os.path.relpath(gdir, base)
    entry = _guided_entry(base, rel)
    if entry is None:
        return False
    return _write(base, [entry]) > 0


def _shrink_entry(base: str, rel: str):
    spath = os.path.join(base, rel, "shrink.json")
    art = _load_json(spath)
    if not isinstance(art, dict) or "signature" not in art:
        return None
    try:
        mtime = os.path.getmtime(spath)
    except OSError:
        mtime = 0
    return ("shrink", rel, mtime, 0, 0,
            {"serve": shrink_row(rel, art, mtime)})


def record_shrink(rdir: str) -> bool:
    """Index one shrink.json artifact (written into a run dir)."""
    rdir = os.path.abspath(rdir)
    base = os.path.dirname(os.path.dirname(rdir))
    rel = os.path.relpath(rdir, base)
    entry = _shrink_entry(base, rel)
    if entry is None:
        return False
    return _write(base, [entry]) > 0


def note_live(cdir: str) -> bool:
    """Register a campaign dir as a live-polling candidate the moment
    its LiveCollector starts — serve's SSE tick then stats exactly the
    registered candidates instead of listdir-ing the whole store."""
    cdir = os.path.abspath(cdir)
    base = os.path.dirname(os.path.dirname(cdir))
    rel = os.path.relpath(cdir, base)
    try:
        mtime = os.path.getmtime(cdir)
    except OSError:
        mtime = 0
    return _write(base, [("live", rel, mtime, 0, 0,
                          {"dir": rel})]) > 0


# -- rebuild / verify ---------------------------------------------------------

def _tree_entries(base: str):
    """(entries, guided_rels, stats) from a full two-level scan of the
    base — the backfill inventory for rebuild()."""
    entries = []
    guided_rels = []
    stats = {"runs": 0, "campaigns": 0, "guided": 0, "shrink": 0,
             "live": 0}
    try:
        names = sorted(os.listdir(base))
    except OSError:
        return entries, guided_rels, stats
    for name in names:
        ndir = os.path.join(base, name)
        if name == INDEX_NAME or os.path.islink(ndir) \
                or not os.path.isdir(ndir) or name == "latest":
            continue
        try:
            ids = sorted(os.listdir(ndir))
        except OSError:
            continue
        for rid in ids:
            rdir = os.path.join(ndir, rid)
            if rid == "latest" or os.path.islink(rdir) \
                    or not os.path.isdir(rdir):
                continue
            rel = os.path.join(name, rid)
            if os.path.exists(os.path.join(rdir, "history.jsonl")) or \
                    os.path.exists(os.path.join(rdir, "results.json")):
                entries.append(_run_entry(base, rel))
                stats["runs"] += 1
            if os.path.isfile(os.path.join(rdir, "campaign.json")):
                e = _campaign_entry(base, rel)
                if e is not None:
                    entries.append(e)
                    stats["campaigns"] += 1
            if os.path.isfile(os.path.join(rdir, "guided.json")):
                e = _guided_entry(base, rel)
                if e is not None:
                    entries.append(e)
                    guided_rels.append(rel)
                    stats["guided"] += 1
            if os.path.isfile(os.path.join(rdir, "shrink.json")):
                e = _shrink_entry(base, rel)
                if e is not None:
                    entries.append(e)
                    stats["shrink"] += 1
            if os.path.isfile(os.path.join(rdir, "live.json")) and \
                    not os.path.isfile(os.path.join(rdir,
                                                    "campaign.json")):
                try:
                    mtime = os.path.getmtime(rdir)
                except OSError:
                    mtime = 0
                entries.append(("live", rel, mtime, 0, 0, {"dir": rel}))
                stats["live"] += 1
    return entries, guided_rels, stats


def rebuild(base: str, recurse: bool = True) -> dict:
    """One-shot backfill: re-derive every index row from the tree in a
    single transaction, bumping the fold epoch so cached readers drop
    stale state. Recurses into guided sub-bases by default (their runs
    nest one level deeper than this base's two-level layout)."""
    entries, guided_rels, stats = _tree_entries(base)
    con = _connect(base, create=True)
    try:
        con.execute("BEGIN IMMEDIATE")
        seq0 = _next_seq(con) - 1
        con.execute("DELETE FROM rows")
        # re-insert above the old high-water mark under a new epoch:
        # an old fold must restart, never merge across a rebuild
        seq = seq0
        for kind, rel, mtime, deleted, compacted, row in entries:
            seq += 1
            con.execute(
                "INSERT INTO rows (kind, dir, seq, mtime, deleted, "
                "compacted, row) VALUES (?, ?, ?, ?, ?, ?, ?)",
                (kind, rel, seq, mtime, int(bool(deleted)),
                 int(bool(compacted)),
                 json.dumps(row or {}, sort_keys=True)))
        cur = con.execute("SELECT value FROM meta WHERE key='epoch'")
        got = cur.fetchone()
        epoch = (int(got[0]) if got else 0) + 1
        con.execute("INSERT OR REPLACE INTO meta (key, value) "
                    "VALUES ('epoch', ?)", (str(epoch),))
        con.execute("COMMIT")
    except (sqlite3.Error, OSError):
        try:
            con.execute("ROLLBACK")
        except sqlite3.Error:
            pass
        raise
    finally:
        con.close()
    _counter("store.index_rows", len(entries))
    out = {"ok": True, "base": base, "rows": len(entries), **stats}
    if recurse:
        subs = {}
        for rel in guided_rels:
            subs[rel] = rebuild(os.path.join(base, rel), recurse=False)
        if subs:
            out["sub_indexes"] = subs
    return out


def _fingerprint(rels) -> str:
    return hashlib.sha256(
        "\n".join(sorted(rels)).encode()).hexdigest()[:16]


def verify(base: str) -> dict:
    """The row-count/fingerprint consistency check against the tree:
    the index's live (non-deleted, non-compacted) run rows must name
    exactly the run dirs a fresh walk finds. Compacted rows are
    expected to be absent from the walk — their history.jsonl is gone
    by design."""
    from ..forensics import all_runs
    if not has_index(base):
        return {"ok": False, "base": base,
                "error": f"no {INDEX_NAME} under {base!r} "
                         "(run `store index --rebuild`)"}
    tree = {os.path.relpath(r, base) for r in all_runs(base)}
    f = fold(base)
    live_rows = sorted(d for (k, d), v in f.rows.items()
                       if k == "run" and not v["compacted"])
    compacted = sum(1 for (k, _d), v in f.rows.items()
                    if k == "run" and v["compacted"])
    missing = sorted(tree - set(live_rows))
    stale = sorted(set(live_rows) - tree)
    return {"ok": not missing and not stale, "base": base,
            "tree_runs": len(tree), "index_runs": len(live_rows),
            "compacted": compacted,
            "campaigns": sum(1 for (k, _d) in f.rows if k == "campaign"),
            "guided": sum(1 for (k, _d) in f.rows if k == "guided"),
            "shrink": sum(1 for (k, _d) in f.rows if k == "shrink"),
            "missing": missing, "stale": stale,
            "fingerprint": {"tree": _fingerprint(tree),
                            "index": _fingerprint(live_rows)}}


# -- incremental fold (the reader side) ---------------------------------------

class Fold:
    """Per-process incremental view of one index: the current row set
    plus the seq high-water mark and a generation counter bumped on
    every observed change (render caches key off ``gen``)."""

    __slots__ = ("base", "sig", "hwm", "epoch", "gen", "rows", "kinds")

    def __init__(self, base: str):
        self.base = base
        self.sig = None
        self.hwm = 0
        self.epoch = 0
        self.gen = 0
        #: (kind, rel) -> {"mtime", "compacted", "row"}
        self.rows: dict = {}
        #: kind -> set of live rels, kept in step with ``rows`` so
        #: per-kind reads (the warm /aggregate cache check, the SSE
        #: live scan) cost O(kind count), never O(all rows)
        self.kinds: dict = {}


_FOLDS: dict = {}


def _index_sig(base: str):
    """Cheap change detector: (mtime_ns, size) of the db and its WAL.
    Any committed write touches at least one of the two."""
    out = []
    for suffix in ("", "-wal"):
        try:
            st = os.stat(_db_path(base) + suffix)
            out.append((st.st_mtime_ns, st.st_size))
        except OSError:
            out.append(None)
    return tuple(out)


def fold(base: str) -> Optional[Fold]:
    """The incremental fold of the base's index, or None when no index
    exists (callers fall back to the tree walk). Warm calls cost two
    stats; a changed index replays only rows with ``seq > hwm``."""
    if not has_index(base):
        _FOLDS.pop(os.path.abspath(base), None)
        return None
    key = os.path.abspath(base)
    f = _FOLDS.get(key)
    sig = _index_sig(base)
    if f is not None and f.sig == sig:
        return f
    if f is None:
        f = Fold(key)
        _FOLDS[key] = f
    try:
        con = _connect(base, create=False)
    except (sqlite3.Error, OSError):
        return None
    if con is None:
        return None
    try:
        cur = con.execute("SELECT value FROM meta WHERE key='epoch'")
        got = cur.fetchone()
        epoch = int(got[0]) if got else 0
        if epoch != f.epoch:
            # a rebuild replaced the row set wholesale: restart
            f.rows.clear()
            f.kinds.clear()
            f.hwm = 0
            f.epoch = epoch
            f.gen += 1
        changed = 0
        cur = con.execute(
            "SELECT kind, dir, seq, mtime, deleted, compacted, row "
            "FROM rows WHERE seq > ? ORDER BY seq", (f.hwm,))
        for kind, rel, seq, mtime, deleted, compacted, rowtxt in cur:
            if seq > f.hwm:
                f.hwm = seq
            if deleted:
                f.rows.pop((kind, rel), None)
                f.kinds.get(kind, set()).discard(rel)
            else:
                try:
                    row = json.loads(rowtxt)
                except ValueError:
                    continue
                f.rows[(kind, rel)] = {"mtime": mtime,
                                       "compacted": bool(compacted),
                                       "row": row}
                f.kinds.setdefault(kind, set()).add(rel)
            changed += 1
        if changed:
            f.gen += 1
        f.sig = sig
    except (sqlite3.Error, OSError):
        return None
    finally:
        con.close()
    return f


def kind_dirs(f: Fold, kind: str) -> list:
    """Sorted live rels of one kind — O(kind count) via the registry,
    never a scan of the full row set."""
    return sorted(f.kinds.get(kind, ()))


def _kind_rows(f: Fold, kind: str):
    out = [(d, f.rows[(kind, d)]) for d in f.kinds.get(kind, ())]
    # presort by path components: lexicographic dir-string order and
    # the walks' sorted-listdir order disagree around os.sep ("a-x" <
    # "a/b" as strings, but test dir "a" lists first) — component
    # sorting reproduces the walk exactly, and makes the mtime sorts
    # below deterministic on ties
    out.sort(key=lambda t: t[0].split(os.sep))
    return out


def serve_run_rows(f: Fold) -> list:
    """The /aggregate run rows from the fold, ordered exactly like
    serve's walk path (newest first, walk order on mtime ties)."""
    rows = [dict(v["row"]["serve"]) for _d, v in _kind_rows(f, "run")]
    rows.sort(key=lambda r: r["mtime"], reverse=True)
    return rows


def serve_campaign_rows(f: Fold) -> list:
    rows = [dict(v["row"]["serve"])
            for _d, v in _kind_rows(f, "campaign")]
    rows.sort(key=lambda r: r["mtime"])
    return rows


def serve_guided_rows(f: Fold) -> list:
    rows = [dict(v["row"]["serve"]) for _d, v in _kind_rows(f, "guided")]
    rows.sort(key=lambda r: r["mtime"])
    return rows


def serve_shrink_rows(f: Fold, base: str) -> list:
    """Shrink rows across the whole tree: this base's rows plus every
    guided sub-index's (guided runs nest one level deeper than the
    two-level layout, which is why serve's walk path uses a full
    os.walk here)."""
    rows = [dict(v["row"]["serve"]) for _d, v in _kind_rows(f, "shrink")]
    for grel, _v in _kind_rows(f, "guided"):
        sub = fold(os.path.join(base, grel))
        if sub is None:
            continue
        for srel, sv in _kind_rows(sub, "shrink"):
            r = dict(sv["row"]["serve"])
            r["dir"] = os.path.join(grel, srel)
            rows.append(r)
    rows.sort(key=lambda r: r["dir"].split(os.sep))
    rows.sort(key=lambda r: r["mtime"], reverse=True)
    return rows


def live_candidates(base: str) -> Optional[list]:
    """Relative dirs worth statting for live.json on an SSE tick: the
    registered live rows plus folded campaigns — O(campaigns), never a
    store-wide listdir. None without an index (walk fallback)."""
    f = fold(base)
    if f is None:
        return None
    return sorted(set(f.kinds.get("live", ())) |
                  set(f.kinds.get("campaign", ())))


# -- tel readers --------------------------------------------------------------

def coverage_run_vectors(path: str) -> Optional[list]:
    """``(dir, vector)`` pairs for every indexed run under a store
    base, recursing through guided sub-indexes, dir strings joined to
    the operand exactly as os.walk would produce them. None when the
    base carries no index. Sorted by dir, matching
    tel_cli._coverage_dirs' sorted() walk."""
    f = fold(path)
    if f is None:
        return None
    out: list = []

    def _add(fobj: Fold, prefix: str) -> None:
        for rel, v in _kind_rows(fobj, "run"):
            cov = v["row"].get("cov")
            if cov is None:
                continue  # results.json unreadable at index time
            out.append((os.path.join(prefix, rel), _cov_restore(cov)))
        for grel, _v in _kind_rows(fobj, "guided"):
            gpath = os.path.join(prefix, grel)
            sub = fold(gpath)
            if sub is not None:
                _add(sub, gpath)
            else:
                # un-indexed guided subtree: targeted walk, same
                # pruning as tel_cli._coverage_dirs
                for root, dirs, files in os.walk(gpath,
                                                 followlinks=False):
                    dirs[:] = [d for d in dirs if not os.path.islink(
                        os.path.join(root, d))]
                    if "results.json" in files:
                        cov = coverage_fields(_load_json(
                            os.path.join(root, "results.json")))
                        if cov is not None:
                            out.append((root, cov))
                        dirs[:] = []

    _add(f, path)
    out.sort(key=lambda t: t[0])
    return out


def run_vector(rdir: str) -> Optional[dict]:
    """One run's indexed coverage vector, looked up through its base's
    fold; None when unindexed (caller reads results.json directly)."""
    rdir = os.path.abspath(rdir)
    base = os.path.dirname(os.path.dirname(rdir))
    f = fold(base)
    if f is None:
        return None
    v = f.rows.get(("run", os.path.relpath(rdir, base)))
    if v is None:
        return None
    cov = v["row"].get("cov")
    return None if cov is None else _cov_restore(cov)


def ledger_ticks(cdir: str) -> Optional[tuple]:
    """``(ticked_traces, skipped)`` for a campaign dir from its index
    row, validated against the service.jsonl fingerprint; None on any
    mismatch (caller rescans the file)."""
    cdir = os.path.abspath(cdir)
    base = os.path.dirname(os.path.dirname(cdir))
    f = fold(base)
    if f is None:
        return None
    v = f.rows.get(("campaign", os.path.relpath(cdir, base)))
    if v is None:
        return None
    payload = v["row"].get("ledger") or {}
    if not payload.get("has_service") or payload.get("fp") is None:
        return None
    try:
        st = os.stat(os.path.join(cdir, "service.jsonl"))
    except OSError:
        return None
    if [st.st_mtime_ns, st.st_size] != payload["fp"]:
        return None
    return set(payload.get("ticked") or ()), int(
        payload.get("skipped") or 0)


def newest_guided(path: str) -> Optional[tuple]:
    """``(mtime, guided.json path)`` of the newest indexed guided
    campaign under a store base; None when unindexed or none exist."""
    f = fold(path)
    if f is None:
        return None
    cands = [(v["mtime"], os.path.join(path, rel, "guided.json"))
             for rel, v in _kind_rows(f, "guided")]
    if not cands:
        return None
    return max(cands)


# -- tel profile cache (the --diff fast path) ---------------------------------

def _hist_exact(h: Hist) -> dict:
    """Lossless Hist serialization: to_dict() rounds sum/min/max to
    9 decimals, which would break bit-identical p95s after a cache
    round-trip; json round-trips raw floats exactly."""
    return {"count": h.count, "sum": h.sum,
            "min": None if h.count == 0 else h.min,
            "max": None if h.count == 0 else h.max,
            "buckets": {str(i): c for i, c in enumerate(h.counts)
                        if c}}


def _hist_from_exact(d: dict) -> Hist:
    h = Hist()
    for k, c in (d.get("buckets") or {}).items():
        h.counts[int(k)] += int(c)
    h.count = int(d.get("count") or 0)
    h.sum = float(d.get("sum") or 0.0)
    if d.get("min") is not None:
        h.min = float(d["min"])
    if d.get("max") is not None:
        h.max = float(d["max"])
    return h


def tel_profile(path: str, scan_fn) -> dict:
    """The scan() profile of one jsonl file, served from the owning
    base's tel_cache when the (mtime_ns, size) fingerprint matches,
    populated via ``scan_fn([path])`` on a miss. Falls back to a plain
    scan when the file lives under no indexed base."""
    apath = os.path.abspath(path)
    # telemetry.jsonl / service.jsonl live in run/campaign dirs two
    # levels under their base, so the index sits three dirnames up
    base = os.path.dirname(os.path.dirname(os.path.dirname(apath)))
    if not base or not has_index(base):
        return scan_fn([path])
    rel = os.path.relpath(apath, base)
    try:
        st = os.stat(apath)
        fp = (st.st_mtime_ns, st.st_size)
    except OSError:
        return scan_fn([path])
    try:
        con = _connect(base, create=False)
    except (sqlite3.Error, OSError):
        con = None
    if con is None:
        return scan_fn([path])
    try:
        try:
            got = con.execute(
                "SELECT mtime_ns, size, profile FROM tel_cache "
                "WHERE path=?", (rel,)).fetchone()
        except sqlite3.Error:
            got = None
        if got and (got[0], got[1]) == fp:
            try:
                blob = json.loads(got[2])
                return {
                    "files": 1,
                    "records": int(blob["records"]),
                    "skipped": int(blob["skipped"]),
                    "spans": {n: _hist_from_exact(d)
                              for n, d in blob["spans"].items()},
                    "hists": {n: _hist_from_exact(d)
                              for n, d in blob["hists"].items()},
                    "counters": dict(blob["counters"]),
                    "traces": set(blob["traces"]),
                }
            except (KeyError, TypeError, ValueError):
                pass  # unreadable cache row: rescan below
        prof = scan_fn([path])
        blob = json.dumps({
            "records": prof["records"], "skipped": prof["skipped"],
            "spans": {n: _hist_exact(h)
                      for n, h in prof["spans"].items()},
            "hists": {n: _hist_exact(h)
                      for n, h in prof["hists"].items()},
            "counters": prof["counters"],
            "traces": sorted(prof["traces"]),
        }, sort_keys=True)
        try:
            con.execute("BEGIN IMMEDIATE")
            con.execute(
                "INSERT OR REPLACE INTO tel_cache "
                "(path, mtime_ns, size, profile) VALUES (?, ?, ?, ?)",
                (rel, fp[0], fp[1], blob))
            con.execute("COMMIT")
        except (sqlite3.Error, OSError):
            try:
                con.execute("ROLLBACK")
            except sqlite3.Error:
                pass
        return prof
    finally:
        con.close()


# -- retention compaction -----------------------------------------------------

def compact(base: str, keep: int = COMPACT_KEEP_NEWEST,
            dry_run: bool = False) -> dict:
    """Demote old PASSING runs to index rows + summary files: delete
    everything in the run dir except results.json/test.json (and a
    shrink.json, which only failing runs carry anyway). The newest
    ``keep`` runs are spared regardless of verdict; failing or
    unknown-verdict runs are NEVER touched — their full artifacts are
    the evidence. Stored index rows (including mtimes) are left
    byte-identical; only the ``compacted`` flag flips."""
    if not has_index(base):
        rebuild(base)
    f = fold(base)
    runs = [(v["mtime"], rel, v) for rel, v in _kind_rows(f, "run")
            if not v["compacted"]]
    runs.sort(key=lambda t: (t[0], t[1].split(os.sep)))
    candidates = runs[:-keep] if keep > 0 else runs
    compacted, skipped_failures = [], 0
    removed_files = 0
    for _mtime, rel, v in candidates:
        if v["row"]["serve"].get("valid?") is not True:
            skipped_failures += 1
            continue
        rdir = os.path.join(base, rel)
        if not os.path.isdir(rdir):
            continue
        if not dry_run:
            for fn in sorted(os.listdir(rdir)):
                if fn in COMPACT_KEEP:
                    continue
                p = os.path.join(rdir, fn)
                try:
                    if os.path.islink(p) or os.path.isfile(p):
                        os.unlink(p)
                    elif os.path.isdir(p):
                        shutil.rmtree(p, ignore_errors=True)
                    removed_files += 1
                except OSError:
                    pass
        compacted.append(rel)
    if compacted and not dry_run:
        try:
            con = _connect(base, create=False)
            con.execute("BEGIN IMMEDIATE")
            seq = _next_seq(con)
            for rel in compacted:
                con.execute(
                    "UPDATE rows SET compacted=1, seq=? "
                    "WHERE kind='run' AND dir=?", (seq, rel))
                seq += 1
            con.execute("COMMIT")
            con.close()
        except (sqlite3.Error, OSError):
            pass
    _counter("store.compacted", len(compacted))
    _counter("store.compact_skipped_failures", skipped_failures)
    return {"ok": True, "base": base, "compacted": len(compacted),
            "compacted_dirs": compacted,
            "skipped_failures": skipped_failures,
            "kept_newest": min(keep, len(runs)) if keep > 0 else 0,
            "removed_entries": removed_files, "dry_run": dry_run}


# -- the `store` CLI subcommand ----------------------------------------------

def cli_store(args) -> int:
    """``python -m jepsen_etcd_tpu_torch store {index,compact}`` — the
    operator surface: backfill/verify the index, or run a retention
    pass. Dispatched by cli.main; does no device work."""
    from . import telemetry
    tel = telemetry.Telemetry(None)
    telemetry.set_current(tel)
    try:
        base = args.store
        if args.action == "index":
            out = rebuild(base) if args.rebuild else verify(base)
        else:
            out = compact(base, keep=args.keep, dry_run=args.dry_run)
        out = dict(out,
                   counters=dict((tel.summary() or {})
                                 .get("counters") or {}))
        print(json.dumps(out, indent=2, sort_keys=True))
        return 0 if out.get("ok") else 1
    finally:
        telemetry.set_current(telemetry.NULL)
        tel.close()
