"""The port's indexed artifact store (``runner/store_index.py``) and its
readers, on the shapes of ``tests/test_store_index.py``.

The contract under test: the sqlite run index is an ACCELERATOR, never
a second source of truth — every reader (the /aggregate dashboard, the
tel subcommands) must produce bit-identical output whether it replays
index rows or walks the tree, incremental writes must land the same
rows a full rebuild derives, `store index` must detect tree/index
drift, and retention compaction must be lossless for every summary
surface while never touching a failed run's artifacts. The parity of
these surfaces with the reference's over one store is
``tests/test_torch_readers.py``.
"""

import json
import os
import random
import shutil
import types

import pytest

from jepsen_etcd_tpu_torch import serve, tel_cli
from jepsen_etcd_tpu_torch.runner import store_index, telemetry
from jepsen_etcd_tpu_torch.runner.store import failure_signature, rotate_store


@pytest.fixture(autouse=True)
def _fresh_caches():
    """Per-process fold/render caches are keyed by abspath; tmp_path
    makes keys unique, but clear anyway so no test leaks cache state."""
    yield
    serve._AGG_CACHE.clear()
    store_index._FOLDS.clear()


def run_results(valid=True, count=100, frontier=3, rungs=2, spills=0,
                waves=4, buckets=None, gen_rate=1200.0):
    tel = {"phases": {"generate": 0.4, "check": 0.2},
           "counters": {"generate.ops_per_s": gen_rate,
                        "wgl.max-frontier": frontier,
                        "wgl.rungs": rungs,
                        "wgl.host-spill": spills,
                        "wgl.waves": waves},
           "hists": {}}
    if buckets:
        tel["hists"]["wgl.rung_waves"] = {
            "count": sum(buckets.values()),
            "buckets": {str(b): c for b, c in buckets.items()}}
    return {"valid?": valid, "stats": {"count": count},
            "workload": {"valid?": valid}, "telemetry": tel}


def mk_run(base, tname, rid, results=None, history=True, shrink=None,
           tel_lines=None):
    d = os.path.join(str(base), tname, rid)
    os.makedirs(d)
    if results is None:
        results = run_results()
    with open(os.path.join(d, "results.json"), "w") as f:
        json.dump(results, f)
    test = {"name": tname, "workload": "register",
            "nemesis_spec": ["kill"], "db_mode": "sim",
            "time_limit": 5, "seed": int(rid)}
    with open(os.path.join(d, "test.json"), "w") as f:
        json.dump(test, f)
    if history:
        with open(os.path.join(d, "history.jsonl"), "w") as f:
            f.write('{"type": "invoke", "f": "write", "value": 1}\n')
    if shrink is not None:
        with open(os.path.join(d, "shrink.json"), "w") as f:
            json.dump(shrink, f)
    if tel_lines is not None:
        with open(os.path.join(d, "telemetry.jsonl"), "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in tel_lines))
    return d


SHRINK = {"signature": "workload=False", "workload": "register",
          "original_windows": 4, "windows": 1, "nemesis_ops": 2,
          "rounds": 3, "executions": 9,
          "repro": {"seed": 2, "nem_schedule": [[0.1, 0.3]]}}


def mk_campaign(base, name, cid):
    cdir = os.path.join(str(base), name, cid)
    os.makedirs(cdir)
    rows = [{"status": "done", "trace": "tA", "service_shipped": 2,
             "service_queue_wait_s": 0.5, "gen_ops_per_s": 900.0,
             "dispatches": 3, "check_s": 0.2,
             "dir": os.path.join("..", "..", "reg", "00001")},
            {"status": "done", "trace": "tB", "service_shipped": 1,
             "service_queue_wait_s": 0.25, "gen_ops_per_s": 1100.0,
             "dispatches": 1, "check_s": 0.1},
            {"status": "error", "host": "h2"}]
    summary = {"name": name, "trace": "camp-1", "count": 3, "pool": 2,
               "valid?": False, "wall_s": 4.5, "runs": rows,
               "service": {"counters": {"service.submitted": 3,
                                        "service.queue_wait_s": 0.75,
                                        "wgl.dispatches": 4}}}
    with open(os.path.join(cdir, "campaign.json"), "w") as f:
        json.dump(summary, f)
    ticks = [{"kind": "span", "name": "service.tick", "dur_s": 0.01,
              "attrs": {"runs": ["tA"]}},
             {"kind": "span", "name": "service.tick", "dur_s": 0.02,
              "attrs": {"runs": ["tB"]}}]
    with open(os.path.join(cdir, "service.jsonl"), "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in ticks))
    return cdir


def mk_guided(base, name, gid):
    gdir = os.path.join(str(base), name, gid)
    os.makedirs(gdir)
    summary = {"kind": "guided", "name": name, "budget": 8, "runs": 6,
               "generations": 2, "master_seed": 7,
               "signatures": {"workload=False": 3},
               "first_failure_run": 3, "wall_s": 1.2,
               "envelope": {"frontier": 3},
               "corpus": [{"opts": {"workload": "register",
                                    "nemesis": ["kill"], "seed": 9},
                           "seed": 9, "run": 3, "score": 4,
                           "signature": "workload=False",
                           "vector": {"frontier": 3}}],
               "minimized": [dict(SHRINK, run=3)]}
    with open(os.path.join(gdir, "guided.json"), "w") as f:
        json.dump(summary, f)
    # the guided dir is its own index base: runs nest one level deeper
    mk_run(gdir, "g-reg", "00001",
           results=run_results(valid=False, count=40, frontier=5,
                               buckets={3: 2, 24: 1}),
           shrink=SHRINK)
    mk_run(gdir, "g-reg", "00002",
           results=run_results(count=44, buckets={2: 6}))
    return gdir


TEL_A = [{"kind": "span", "name": "phase:check",
          "dur_s": 0.012345678901234, "trace": "tA"},
         {"kind": "span", "name": "phase:check", "dur_s": 0.031},
         {"kind": "span", "name": "wgl.check_packed", "dur_s": 0.002},
         {"kind": "counter", "name": "wgl.rungs", "value": 3}]
TEL_B = [{"kind": "span", "name": "phase:check", "dur_s": 0.05,
          "trace": "tB"},
         {"kind": "hist", "name": "wgl.rung_waves", "count": 2,
          "sum": 9.0, "min": 3.0, "max": 6.0,
          "buckets": {"2": 1, "3": 1}},
         {"kind": "counter", "name": "wgl.rungs", "value": 4}]


@pytest.fixture
def store(tmp_path):
    base = str(tmp_path / "store")
    mk_run(base, "reg", "00001",
           results=run_results(count=120, buckets={3: 4, 10: 1}),
           tel_lines=TEL_A)
    mk_run(base, "reg", "00002",
           results=run_results(valid=False, count=80, frontier=6,
                               spills=1, buckets={10: 2}),
           shrink=SHRINK, tel_lines=TEL_B)
    mk_run(base, "kill", "00001",
           results=run_results(count=60, gen_rate=800.0))
    mk_campaign(base, "camp", "001")
    mk_guided(base, "fuzz", "001")
    return base


def _serve_rows(base):
    return {"runs": serve._run_rows(base),
            "campaigns": serve._campaign_rows(base),
            "guided": serve._guided_rows(base),
            "shrink": serve._shrink_rows(base)}


# -- rebuild / incremental / verify ------------------------------------------


def test_rebuild_replays_walk_rows_bit_identically(store):
    walk = _serve_rows(store)  # no index yet: pure tree walk
    assert len(walk["runs"]) == 3
    assert len(walk["shrink"]) == 2  # base run + guided-subtree run
    out = store_index.rebuild(store)
    assert out["ok"] and out["runs"] == 3 and out["campaigns"] == 1
    assert out["guided"] == 1 and out["shrink"] == 1
    assert "fuzz/001" in out["sub_indexes"]
    assert store_index.has_index(store)
    assert store_index.has_index(os.path.join(store, "fuzz", "001"))
    assert store_index.fold(store) is not None
    assert _serve_rows(store) == walk


def test_incremental_writes_match_rebuild(tmp_path):
    base = str(tmp_path / "inc")
    mk_run(base, "reg", "00001")
    # first hook into an unindexed tree backfills before upserting —
    # a fresh index must never start as a partial one
    mk_run(base, "reg", "00002")
    assert store_index.record_run(os.path.join(base, "reg", "00002"))
    f = store_index.fold(base)
    assert store_index.kind_dirs(f, "run") == \
        [os.path.join("reg", "00001"), os.path.join("reg", "00002")]

    rdir = mk_run(base, "kill", "00001",
                  results=run_results(valid=False), shrink=SHRINK)
    assert store_index.record_run(rdir)
    assert store_index.record_shrink(rdir)
    cdir = mk_campaign(base, "camp", "001")
    assert store_index.record_campaign(cdir)
    gdir = mk_guided(base, "fz", "001")
    assert store_index.record_guided(gdir)

    incremental = store_index.fold(base).rows.copy()
    store_index.rebuild(base)
    assert store_index.fold(base).rows == incremental


def test_verify_flags_missing_and_stale_rows(store):
    store_index.rebuild(store)
    v = store_index.verify(store)
    assert v["ok"] and v["tree_runs"] == v["index_runs"] == 3
    assert v["fingerprint"]["tree"] == v["fingerprint"]["index"]

    mk_run(store, "late", "00001")
    v = store_index.verify(store)
    assert not v["ok"]
    assert v["missing"] == [os.path.join("late", "00001")]
    store_index.record_run(os.path.join(store, "late", "00001"))
    assert store_index.verify(store)["ok"]

    shutil.rmtree(os.path.join(store, "late"))
    v = store_index.verify(store)
    assert not v["ok"] and v["stale"] == [os.path.join("late", "00001")]
    store_index.mark_deleted(store, [os.path.join("late", "00001")])
    assert store_index.verify(store)["ok"]


def test_rotation_tombstones_index_rows(tmp_path):
    base = str(tmp_path / "rot")
    for i in range(1, 4):
        d = mk_run(base, "reg", f"{i:05d}")
        with open(os.path.join(d, "history.jsonl"), "w") as f:
            f.write("x" * 4096)
        os.utime(d, (1000.0 * i, 1000.0 * i))
    store_index.rebuild(base)
    keep = os.path.join(base, "reg", "00003")
    removed = rotate_store(base, keep_dir=keep, max_bytes=6000)
    assert removed  # the oldest run(s) went
    rows = serve._run_rows(base)
    dirs = {r["dir"] for r in rows}
    assert os.path.join("reg", "00003") in dirs
    for rd in removed:
        assert os.path.relpath(rd, base) not in dirs
    assert store_index.verify(base)["ok"]


def test_live_registration_and_snapshot(tmp_path):
    base = str(tmp_path / "live")
    mk_run(base, "reg", "00001")
    cdir = os.path.join(base, "camp", "001")
    os.makedirs(cdir)
    with open(os.path.join(cdir, "live.json"), "w") as f:
        json.dump({"phase": "running", "done": 1}, f)
    assert store_index.note_live(cdir)
    assert store_index.live_candidates(base) == \
        [os.path.join("camp", "001")]
    snap, _mtime, rel = serve._live_snapshot(base)
    assert snap == {"phase": "running", "done": 1}
    assert rel == os.path.join("camp", "001")
    # folding the campaign tombstones the live row; the campaign row
    # keeps the dir on the SSE candidate list
    mk_campaign(base, "camp", "002")  # distinct dir, still live-less
    cdir2 = mk_campaign(base, "camp2", "001")
    store_index.record_campaign(cdir2)
    f = store_index.fold(base)
    assert ("live", os.path.join("camp", "001")) in f.rows
    assert ("campaign", os.path.join("camp2", "001")) in f.rows


# -- /aggregate serving -------------------------------------------------------


def test_aggregate_pagination_windows_and_clamps(tmp_path):
    base = str(tmp_path / "pg")
    for i in range(12):
        mk_run(base, f"t{i % 3}", f"{i:05d}",
               results=run_results(valid=i % 4 != 0))
    store_index.rebuild(base)
    p1 = serve.aggregate_html(base, page=1, per=5)
    assert "12 runs" in p1 and "rows 1–5 of 12" in p1
    assert 'href="/aggregate?page=2&amp;per=5"' in p1
    p3 = serve.aggregate_html(base, page=3, per=5)
    assert "rows 11–12 of 12" in p3 and "page 3/3" in p3
    # out-of-range and junk query args clamp instead of erroring
    assert "rows 11–12 of 12" in serve.aggregate_html(base, page="99",
                                                      per="5")
    assert "rows 1–5 of 12" in serve.aggregate_html(base, page="0",
                                                    per="5")
    one = serve.aggregate_html(base, page="junk", per="junk")
    assert "12 runs" in one and "rows " not in one  # single page
    assert serve._page_window(0, 1, 5) == (0, 0, 1, 1, 5)
    assert serve._page_window(12, 2, 10 ** 9)[4] == serve._MAX_PER


def test_aggregate_render_cache_invalidates_on_index_writes(tmp_path):
    base = str(tmp_path / "cache")
    for i in range(4):
        mk_run(base, "reg", f"{i:05d}")
    store_index.rebuild(base)
    p1 = serve.aggregate_html(base, page=1, per=2)
    assert serve.aggregate_html(base, page=1, per=2) is p1  # cache hit
    store_index.record_run(mk_run(base, "reg", "00099"))
    p2 = serve.aggregate_html(base, page=1, per=2)
    assert p2 is not p1 and "5 runs" in p2


# -- index-backed tel, bit-identical to the walks -----------------------------


def _capture(capsys, fn, *args, **kw):
    rc = fn(*args, **kw)
    out = capsys.readouterr().out
    assert out
    return rc, out


@pytest.mark.parametrize("as_json", [False, True])
def test_tel_coverage_index_matches_walk(store, as_json, capsys):
    store_index.rebuild(store)
    rc_i, via_index = _capture(capsys, tel_cli.cmd_coverage, [store],
                               as_json, use_index=True)
    rc_w, via_walk = _capture(capsys, tel_cli.cmd_coverage, [store],
                              as_json, use_index=False)
    assert rc_i == rc_w == 0
    assert via_index == via_walk
    # the guided subtree's runs are in the fold's answer (5 = 3 base
    # runs + 2 nested under fuzz/001)
    assert "workload=False" in via_index
    if as_json:
        got = json.loads(via_index)
        assert got["aggregate"]["count"] == 5
        assert sum("g-reg" in r["dir"] for r in got["runs"]) == 2
    else:
        assert "coverage over 5 run(s)" in via_index


@pytest.mark.parametrize("as_json", [False, True])
def test_tel_ledger_index_matches_walk(store, as_json, capsys):
    store_index.rebuild(store)
    cdir = os.path.join(store, "camp", "001")
    assert store_index.ledger_ticks(cdir) is not None
    rc_i, via_index = _capture(capsys, tel_cli.cmd_ledger, [cdir],
                               as_json, use_index=True)
    rc_w, via_walk = _capture(capsys, tel_cli.cmd_ledger, [cdir],
                              as_json, use_index=False)
    assert rc_i == rc_w == 0
    assert via_index == via_walk
    # a rewritten service.jsonl invalidates the cached trace join
    with open(os.path.join(cdir, "service.jsonl"), "a") as f:
        f.write(json.dumps({"kind": "span", "name": "service.tick",
                            "dur_s": 0.01, "attrs": {"runs": []}})
                + "\n")
    assert store_index.ledger_ticks(cdir) is None
    rc, _ = _capture(capsys, tel_cli.cmd_ledger, [cdir], as_json,
                     use_index=True)
    assert rc == 0  # falls back to the rescan, never serves stale


@pytest.mark.parametrize("as_json", [False, True])
def test_tel_diff_index_matches_walk(store, as_json, capsys):
    store_index.rebuild(store)
    a = os.path.join(store, "reg", "00001")
    b = os.path.join(store, "reg", "00002")
    _, cold = _capture(capsys, tel_cli.cmd_diff, [a, b], as_json,
                       use_index=True)
    _, cached = _capture(capsys, tel_cli.cmd_diff, [a, b], as_json,
                         use_index=True)
    _, walk = _capture(capsys, tel_cli.cmd_diff, [a, b], as_json,
                       use_index=False)
    assert cold == cached == walk
    con = store_index._connect(store)
    try:
        n = con.execute("SELECT COUNT(*) FROM tel_cache").fetchone()[0]
    finally:
        con.close()
    assert n == 2  # both operands' profiles are cached


@pytest.mark.parametrize("as_json", [False, True])
def test_tel_corpus_index_matches_walk(store, as_json, capsys):
    store_index.rebuild(store)
    rc_i, via_index = _capture(capsys, tel_cli.cmd_corpus, [store],
                               as_json, use_index=True)
    rc_w, via_walk = _capture(capsys, tel_cli.cmd_corpus, [store],
                              as_json, use_index=False)
    assert rc_i == rc_w == 0
    assert via_index == via_walk


def test_tel_profile_cache_serves_exact_profiles(store):
    store_index.rebuild(store)
    path = os.path.join(store, "reg", "00001", "telemetry.jsonl")
    calls = []

    def scan_fn(paths):
        calls.append(list(paths))
        return tel_cli.scan(paths)

    def flat(prof):
        return {"records": prof["records"], "skipped": prof["skipped"],
                "counters": prof["counters"],
                "traces": sorted(prof["traces"]),
                "spans": {n: store_index._hist_exact(h)
                          for n, h in prof["spans"].items()},
                "hists": {n: store_index._hist_exact(h)
                          for n, h in prof["hists"].items()}}

    p1 = store_index.tel_profile(path, scan_fn)
    p2 = store_index.tel_profile(path, scan_fn)
    assert len(calls) == 1  # second read served from the cache
    assert flat(p1) == flat(p2)
    # a rewrite changes the fingerprint: rescan, never stale
    with open(path, "a") as f:
        f.write(json.dumps({"kind": "counter", "name": "wgl.rungs",
                            "value": 1}) + "\n")
    p3 = store_index.tel_profile(path, scan_fn)
    assert len(calls) == 2
    assert p3["counters"]["wgl.rungs"] == \
        p1["counters"]["wgl.rungs"] + 1


# -- retention compaction -----------------------------------------------------


def _tree_bytes(d):
    out = {}
    for root, dirs, files in os.walk(d):
        dirs.sort()
        for fn in sorted(files):
            p = os.path.join(root, fn)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def test_compaction_is_lossless_fuzz(tmp_path, capsys):
    rng = random.Random(1234)
    for case in range(4):
        base = str(tmp_path / f"s{case}")
        n = rng.randrange(8, 18)
        failing = set()
        for i in range(n):
            valid = rng.random() >= 0.35
            if not valid:
                failing.add(os.path.join(f"t{i % 3}", f"{i:05d}"))
            buckets = {rng.randrange(1, 30): rng.randrange(1, 9)
                       for _ in range(rng.randrange(0, 4))}
            d = mk_run(base, f"t{i % 3}", f"{i:05d}",
                       results=run_results(
                           valid=valid, count=50 + i,
                           frontier=rng.randrange(1, 9),
                           rungs=rng.randrange(5),
                           spills=rng.randrange(2),
                           waves=rng.randrange(1, 6),
                           buckets=buckets),
                       shrink=SHRINK if (not valid and
                                         rng.random() < 0.5) else None)
            os.utime(d, (1000.0 + i, 1000.0 + i))
        store_index.rebuild(base)
        keep = rng.randrange(1, 5)

        serve._AGG_CACHE.clear()
        html_pre = serve.aggregate_html(base)
        rows_pre = serve._run_rows(base)
        cov_pre = tel_cli.coverage(base, use_index=True)
        failed_pre = {rel: _tree_bytes(os.path.join(base, rel))
                      for rel in failing}

        out = store_index.compact(base, keep=keep)
        assert out["ok"] and not out["dry_run"]
        assert not set(out["compacted_dirs"]) & failing

        # every summary surface replays identically after compaction
        serve._AGG_CACHE.clear()
        assert serve.aggregate_html(base) == html_pre
        assert serve._run_rows(base) == rows_pre
        assert tel_cli.coverage(base, use_index=True) == cov_pre
        assert tel_cli.coverage(base, use_index=False) == cov_pre

        # failed runs' artifacts are byte-untouched, never deleted
        for rel in sorted(failing):
            assert _tree_bytes(os.path.join(base, rel)) == \
                failed_pre[rel], rel
        # demoted passing runs keep ONLY the summary files
        for rel in out["compacted_dirs"]:
            left = set(os.listdir(os.path.join(base, rel)))
            assert left <= set(store_index.COMPACT_KEEP)
            assert "results.json" in left and "test.json" in left
        # candidate accounting: everything older than the spared tail
        # was either demoted or skipped as a failure
        assert out["compacted"] + out["skipped_failures"] == \
            max(0, n - keep)
        assert store_index.verify(base)["ok"]


def test_compact_dry_run_and_counters(tmp_path):
    base = str(tmp_path / "c")
    for i in range(6):
        d = mk_run(base, "reg", f"{i:05d}",
                   results=run_results(valid=i != 0))
        os.utime(d, (1000.0 + i, 1000.0 + i))
    store_index.rebuild(base)
    tel = telemetry.Telemetry(None)
    telemetry.set_current(tel)
    try:
        dry = store_index.compact(base, keep=2, dry_run=True)
        assert dry["dry_run"] and dry["compacted"] == 3
        assert dry["skipped_failures"] == 1  # run 0 failed, spared
        for i in range(6):  # nothing actually removed
            assert os.path.exists(os.path.join(
                base, "reg", f"{i:05d}", "history.jsonl"))
        out = store_index.compact(base, keep=2)
        assert out["compacted"] == 3 and out["skipped_failures"] == 1
    finally:
        telemetry.set_current(telemetry.NULL)
    ctr = tel.summary()["counters"]
    tel.close()
    assert ctr["store.compacted"] == 6  # dry + real pass both count
    assert ctr["store.compact_skipped_failures"] == 2
    # the demoted runs are now invisible to all_runs but still served
    assert len(serve._run_rows(base)) == 6
    v = store_index.verify(base)
    assert v["ok"] and v["compacted"] == 3 and v["tree_runs"] == 3


def test_new_counters_are_registered():
    reg = telemetry.REGISTRY["counters"]
    for name in ("store.index_rows", "store.index_writes",
                 "store.compacted", "store.compact_skipped_failures",
                 "guided.corpus_retired"):
        assert name in reg, name


# -- the `store` CLI ----------------------------------------------------------


def _cli(capsys, **kw):
    ns = types.SimpleNamespace(action="index", store=None,
                               rebuild=False, keep=32, dry_run=False)
    ns.__dict__.update(kw)
    rc = store_index.cli_store(ns)
    return rc, json.loads(capsys.readouterr().out)


def test_store_cli_index_and_compact(store, capsys):
    rc, out = _cli(capsys, store=store, rebuild=True)
    assert rc == 0 and out["ok"] and out["rows"] == 6
    assert out["counters"]["store.index_rows"] >= 6
    rc, out = _cli(capsys, store=store)  # verify mode
    assert rc == 0 and out["ok"] and out["index_runs"] == 3
    # keep=1 spares the newest run; of the two older ones the failing
    # reg/00002 is protected, so exactly one passing run demotes
    rc, out = _cli(capsys, store=store, action="compact", keep=1)
    assert rc == 0 and out["ok"] and out["compacted"] == 1
    assert out["skipped_failures"] == 1
    assert out["counters"]["store.compacted"] == 1
    # drift makes the verify exit nonzero (the CI hook contract)
    shutil.rmtree(os.path.join(store, "kill"))
    rc, out = _cli(capsys, store=store)
    assert rc == 1 and not out["ok"]


def test_store_cli_dispatches_through_main(store, capsys):
    from jepsen_etcd_tpu_torch.cli import main
    assert main(["store", "index", "--rebuild", "--store", store]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["ok"] and out["rows"] == 6


def test_failure_signature_is_canonical():
    res = {"valid?": False,
           "workload": {"valid?": False},
           "staleness": {"valid?": "unknown"},
           "perf": {"valid?": True},
           "stats": {"count": 3}}
    sig = failure_signature(res)
    assert sig == "staleness=unknown, workload=False"
    assert serve._failure_signature(res) == sig
    from jepsen_etcd_tpu_torch.runner.shrink import _signature
    assert _signature(res) == sig
