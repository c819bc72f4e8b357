"""The store's readers in the port (``serve.py``, ``forensics.py``,
``runner/store_index.cli_store``) against the JAX package's, on the CPU,
over one store the port wrote: a debug-mode ``wr`` run with a network
trace, a ``register`` run through the ``test`` command, a campaign with
the live plane on, a guided search with its shrunk repro, and a
hand-built multi-host, multi-chip campaign summary (the ledger and
chips cells). Over that store both packages render byte-equal pages
(the index, /aggregate and its pages, every run page, the trace viewer,
/live and its SSE event, directly and through ``make_server``) except
the package name in ``<title>``; their ``forensics`` helpers return
equal results; and ``cli_store`` prints equal JSON. The cases of
``tests/test_aux.py`` on debug provenance and forensics, and the
/aggregate checks of ``tests/test_campaign.py``, ``test_guided.py`` and
``test_host_fleet.py``, run here against the port."""

import json
import os
import re
import shutil
import threading
import types
import urllib.request

import pytest

from jepsen_etcd_tpu import forensics as ref_forensics
from jepsen_etcd_tpu import serve as ref_serve
from jepsen_etcd_tpu.core.op import Op as RefOp
from jepsen_etcd_tpu.runner import store_index as ref_store_index
from jepsen_etcd_tpu_torch import cli, forensics, serve
from jepsen_etcd_tpu_torch.compose import etcd_test
from jepsen_etcd_tpu_torch.core.op import Op
from jepsen_etcd_tpu_torch.runner import store_index
from jepsen_etcd_tpu_torch.runner.campaign import campaign_specs, run_campaign
from jepsen_etcd_tpu_torch.runner.guided import run_guided
from jepsen_etcd_tpu_torch.runner.test_runner import run_test
from test_torch_fixtures import one_torch_thread  # noqa: F401

#: the guided search's quarry (tests/test_guided.py): epoch-v2 sim runs
#: with the seeded stale-read bug, on the CPU
GUIDED_BASE = {"workload": "register", "nodes": ["n1", "n2", "n3"],
               "concurrency": 6, "rate": 100.0, "time_limit": 1.0,
               "inject_stale_reads": True, "gen_epoch": "epoch-v2",
               "device": "cpu"}
CELLS = [["kill"], ["pause"], ["latency"], ["member"], ["partition"]]

#: a two-host, two-chip campaign summary: the cross-host ledger balances
#: and the per-chip dispatches sum to group_ticks + shard_fanout
FLEET = {"name": "fleet", "trace": "fleet-00000", "count": 2, "pool": 0,
         "valid?": True, "wall_s": 3.25,
         "hosts": {"hostA": {"runs": 1, "shipped": 2, "fallbacks": 0},
                   "hostB": {"runs": 1, "shipped": 1, "fallbacks": 0}},
         "runs": [{"index": 0, "status": "done", "valid": True,
                   "host": "hostA", "service_shipped": 2,
                   "gen_ops_per_s": 900.0, "dispatches": 2},
                  {"index": 1, "status": "done", "valid": True,
                   "host": "hostB", "service_shipped": 1,
                   "gen_ops_per_s": 1100.0, "dispatches": 1}],
         "service": {"counters": {
             "service.submitted": 3, "service.group_ticks": 2,
             "service.shard_fanout": 1, "service.batch_occupancy": 2,
             "service.host_submitted.hostA": 2,
             "service.host_submitted.hostB": 1,
             "service.device_dispatches.cuda0": 2,
             "service.device_dispatches.cuda1": 1,
             "service.device_busy_s.cuda0": 0.5,
             "service.device_busy_s.cuda1": 0.25,
             "service.device_occupancy": 2,
             "service.sharded_ticks": 1}}}

_TITLE = re.compile(r"<title>(.*?)</title>", re.S)


def ref_view(page: str) -> str:
    """The port's page as the reference names itself: the package name
    swapped inside ``<title>`` only."""
    return _TITLE.sub(lambda m: "<title>" + m.group(1).replace(
        "jepsen_etcd_tpu_torch", "jepsen_etcd_tpu") + "</title>", page)


def run_dirs(base: str) -> list:
    """Every run dir under ``base`` at any depth (guided sub-stores
    nest theirs a level deeper), store-relative, sorted."""
    out = []
    for root, dirs, files in os.walk(base):
        dirs.sort()
        if "history.jsonl" in files and "results.json" in files:
            out.append(os.path.relpath(root, base))
    return sorted(out)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("readers") / "store")
    debug = run_test(etcd_test({
        "workload": "wr", "debug": True, "tcpdump": True,
        "nemesis": ["partition"], "nemesis_interval": 3,
        "time_limit": 10, "rate": 50, "seed": 3, "device": "cpu",
        "store_base": base}))
    assert debug["results"]["workload"]["valid?"] is True
    assert cli.main(["test", "-w", "register", "--time-limit", "3", "-r",
                     "50", "--seed", "7", "--device", "cpu", "--store",
                     base]) == 0
    camp = run_campaign(
        campaign_specs({"time_limit": 1, "rate": 100.0, "device": "cpu",
                        "nodes": ["n1", "n2", "n3"]},
                       ["register"], [[], ["kill"]], runs_per_cell=2,
                       seed0=7),
        pool=0, service=False, store_base=base, name="camp", live=True)
    assert camp["valid?"] is True
    guided = run_guided(GUIDED_BASE, ["register"], CELLS, budget=12,
                        seed0=7, pool=0, service=False, live=False,
                        store_base=base, name="hunt")
    assert guided["minimized"], "the guided search shrank no repro"
    fdir = os.path.join(base, "fleet", "00000")
    os.makedirs(fdir)
    with open(os.path.join(fdir, "campaign.json"), "w") as f:
        json.dump(FLEET, f)
    assert store_index.record_campaign(fdir)
    return types.SimpleNamespace(base=base, debug=debug, camp=camp,
                                 guided=guided)


@pytest.fixture(autouse=True)
def _fresh_caches():
    yield
    for mod in (serve, ref_serve):
        mod._AGG_CACHE.clear()
    for mod in (store_index, ref_store_index):
        mod._FOLDS.clear()


# -- pages: byte-equal to the reference's but for <title> ---------------------

def _pages(mod, base: str) -> dict:
    pages = {"index": mod.index_html(base),
             "aggregate": mod.aggregate_html(base),
             "aggregate-p1": mod.aggregate_html(base, page=1, per=3),
             "aggregate-p2": mod.aggregate_html(base, page=2, per=3),
             "live": mod.live_html()}
    for rel in run_dirs(base):
        pages["run:" + rel] = mod.run_html(base, rel)
    return pages


def test_pages_equal_the_references(store):
    port, ref = _pages(serve, store.base), _pages(ref_serve, store.base)
    assert sorted(port) == sorted(ref)
    assert len([k for k in port if k.startswith("run:")]) >= 16
    for name in sorted(port):
        assert ref_view(port[name]) == ref[name], name
    assert "rows 4–6 of" in port["aggregate-p2"]
    titles = {t for p in port.values() for t in _TITLE.findall(p)}
    assert "jepsen_etcd_tpu_torch store" in titles
    assert "aggregate — jepsen_etcd_tpu_torch" in titles
    assert "live — jepsen_etcd_tpu_torch" in titles


def test_pages_equal_the_references_on_the_walk_path(store, tmp_path):
    """With the indexes removed, both packages walk the tree — and
    still render what they rendered from the index."""
    indexed = _pages(serve, store.base)
    base = str(tmp_path / "walk")
    shutil.copytree(store.base, base, symlinks=True)
    for root, _, files in os.walk(base):
        for fn in files:
            if fn.startswith(store_index.INDEX_NAME):
                os.remove(os.path.join(root, fn))
    assert store_index.fold(base) is None
    port, ref = _pages(serve, base), _pages(ref_serve, base)
    for name in sorted(port):
        assert ref_view(port[name]) == ref[name], name
    # the walk's rows are the index's (run dir mtimes survive the copy)
    assert serve._run_rows(base) == store_index.serve_run_rows(
        store_index.fold(store.base))
    assert port["index"].replace(base, store.base) == indexed["index"]


@pytest.mark.parametrize("kind", ["", "append", "client-rpc"])
def test_trace_page_equals_the_references(store, kind):
    rel = os.path.relpath(store.debug["dir"], store.base)
    page = serve.trace_html(store.base, rel, kind)
    assert ref_view(page) == ref_serve.trace_html(store.base, rel, kind)
    assert "events shown" in page
    if kind:
        assert f"<td>{kind}</td>" in page


def test_live_snapshot_equals_the_references(store):
    got = serve._live_snapshot(store.base)
    assert got == ref_serve._live_snapshot(store.base)
    snap, _mtime, rel = got
    assert snap["done"] is True
    assert rel == os.path.relpath(store.camp["dir"], store.base)


def test_aggregate_surfaces_campaigns_guided_and_fleet(store):
    """The /aggregate checks of test_campaign.py, test_guided.py and
    test_host_fleet.py, on the port's store."""
    page = serve.aggregate_html(store.base)
    assert "Campaign perf trends" in page and "camp/" in page
    assert "Guided campaigns" in page and "hunt/" in page
    assert "Minimized repros" in page
    assert "jepsen_etcd_tpu_torch replay" in page
    assert "ledger" in page and "balanced" in page
    assert "2 chips" in page and "1 sharded" in page
    assert "cuda0: 2 dispatches" in page


def _get(url: str) -> str:
    return urllib.request.urlopen(url, timeout=30).read().decode()


def _sse(url: str) -> dict:
    resp = urllib.request.urlopen(url + "/live?sse=1", timeout=30)
    line = resp.readline()
    while line and not line.startswith(b"data: "):
        line = resp.readline()
    resp.close()
    return json.loads(line[len(b"data: "):].decode())


def test_servers_answer_as_the_references(store):
    """Both packages' ``make_server`` over the store answer every page,
    the raw files and the SSE tick alike."""
    debug_rel = os.path.relpath(store.debug["dir"], store.base)
    paths = ["/", "/aggregate", "/aggregate?page=2&per=3",
             "/aggregate?page=junk", "/live", f"/{debug_rel}/",
             f"/{debug_rel}/?trace", f"/{debug_rel}/?trace=append",
             f"/{debug_rel}/results.json", f"/{debug_rel}/?files"]
    paths += [f"/{rel}/" for rel in run_dirs(store.base)]
    servers = [mod.make_server(store.base, port=0)
               for mod in (serve, ref_serve)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in servers]
    for t in threads:
        t.start()
    try:
        urls = [f"http://127.0.0.1:{s.server_address[1]}" for s in servers]
        for path in paths:
            port, ref = (_get(u + path) for u in urls)
            assert ref_view(port) == ref, path
        port_ev, ref_ev = (_sse(u) for u in urls)
        assert port_ev == ref_ev
        assert port_ev["active"] is False and port_ev["done"] is True
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()


# -- forensics ----------------------------------------------------------------

def _dicts(history) -> list:
    return [dict(op) for op in history]


def test_forensics_equal_the_references(store):
    runs = forensics.all_runs(store.base)
    assert runs == ref_forensics.all_runs(store.base)
    assert store.debug["dir"] in runs
    assert forensics.all_runs(os.path.join(store.base, "nope")) == []
    for rdir in runs:
        assert forensics.load_history(rdir).to_jsonl() == \
            ref_forensics.load_history(rdir).to_jsonl()
    h = forensics.load_history(store.debug["dir"])
    rh = ref_forensics.load_history(store.debug["dir"])
    dirs = forensics.txn_dirs(h)
    assert dirs == ref_forensics.txn_dirs(rh)
    assert dirs == {os.path.relpath(store.debug["dir"], store.base)}
    assert forensics.all_txn_dirs(store.base) == \
        ref_forensics.all_txn_dirs(store.base)
    oks = [op for op in h if op.get("type") == "ok" and
           op.get("f") == "txn"]
    roks = [op for op in rh if op.get("type") == "ok" and
            op.get("f") == "txn"]
    assert oks and _dicts(oks) == _dicts(roks)
    assert forensics.wr_ops_revisions(oks) == \
        ref_forensics.wr_ops_revisions(roks)
    assert forensics.duplicate_revisions(oks) == \
        ref_forensics.duplicate_revisions(roks) == {}
    for k in sorted({m[1] for op in oks for m in op["value"]}):
        assert _dicts(forensics.ops_involving(k, h)) == \
            _dicts(ref_forensics.ops_involving(k, rh))


def test_index_run_rows_are_forensics_all_runs(store):
    f = store_index.fold(store.base)
    assert sorted(store_index.kind_dirs(f, "run")) == sorted(
        os.path.relpath(r, store.base)
        for r in forensics.all_runs(store.base))


def test_debug_provenance_wr(tmp_path):
    """test_aux.py's case on the port: committed txns carry raw
    responses, and forensics reads this run's dir back out of them."""
    out = run_test(etcd_test({"workload": "wr", "debug": True,
                              "time_limit": 10, "rate": 50, "seed": 4,
                              "device": "cpu",
                              "store_base": str(tmp_path)}))
    assert out["results"]["workload"]["valid?"] is True
    oks = [op for op in out["history"]
           if op.get("type") == "ok" and op.get("f") == "txn"]
    assert oks, "no committed txns"
    assert all(isinstance(op.get("debug"), dict)
               and "txn-res" in op["debug"] for op in oks)
    dirs = forensics.txn_dirs(out["history"])
    expected = (os.path.basename(os.path.dirname(out["dir"])) + "/"
                + os.path.basename(out["dir"]))
    assert dirs == {expected}
    revs = forensics.wr_ops_revisions(oks)
    assert revs and all(r["key"] is not None and
                        r["mod-revision"] is not None for r in revs)
    assert forensics.duplicate_revisions(oks) == {}
    # saved store: the reloaded history reads the same
    assert out["dir"] in forensics.all_runs(str(tmp_path))
    saved = forensics.load_history(out["dir"])
    assert forensics.txn_dirs(saved) == dirs
    assert out["dir"] in forensics.all_txn_dirs(str(tmp_path))


def test_duplicate_revisions_detects():
    # two reads observing the same (key, value) at different
    # mod-revisions — the anomaly the reference hunted (etcd.clj:337-346)
    def dbg_read(kv):
        return {"txn-res": {"results": [("get", kv)]}}

    got = []
    for op_cls, mod in ((Op, forensics), (RefOp, ref_forensics)):
        ops = [op_cls(type="ok", f="txn", index=1, value=[["r", "x", [1]]],
                      debug=dbg_read({"key": "x", "value": [1],
                                      "mod-revision": 5})),
               op_cls(type="ok", f="txn", index=2, value=[["r", "x", [1]]],
                      debug=dbg_read({"key": "x", "value": [1],
                                      "mod-revision": 9}))]
        dups = mod.duplicate_revisions(ops)
        assert mod.ops_involving("x", ops) == ops
        got.append(dups)
    assert got[0] == got[1]
    assert len(got[0]) == 1
    (key, _val), rms = next(iter(got[0].items()))
    assert key == "x" and {r["mod-revision"] for r in rms} == {5, 9}


# -- the `store` command --------------------------------------------------------

def _cli_json(capsys, mod, **kw) -> tuple:
    ns = types.SimpleNamespace(action="index", store=None, rebuild=False,
                               keep=32, dry_run=False)
    ns.__dict__.update(kw)
    rc = mod.cli_store(ns)
    return rc, json.loads(capsys.readouterr().out)


def test_cli_store_prints_the_references_json(store, tmp_path, capsys):
    base = str(tmp_path / "copy")
    shutil.copytree(store.base, base, symlinks=True)
    for kw in ({"rebuild": True}, {}, {"action": "compact",
                                       "dry_run": True}):
        got = [_cli_json(capsys, mod, store=base, **kw)
               for mod in (store_index, ref_store_index)]
        assert got[0] == got[1], kw
        rc, out = got[0]
        assert rc == 0 and out["ok"], kw
    assert out["dry_run"] and out["compacted"] == 0
    # through the command line, as a user types it
    assert cli.main(["store", "index", "--store", base]) == 0
    verify = json.loads(capsys.readouterr().out)
    assert verify["ok"] and verify["index_runs"] == len(
        forensics.all_runs(base))
