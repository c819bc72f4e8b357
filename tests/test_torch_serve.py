"""The port's ``serve.py`` over HTTP, on the shapes of
``tests/test_serve.py`` (a hand-built fixture store: index badges and
artifact links, the per-run report page, the /aggregate cross-run
dashboard, the ?trace event viewer, HTML escaping of run-controlled
strings), of the /live cases of ``tests/test_tel_plane.py`` (the page,
the inactive and the fresh SSE event, a pooled campaign's live plane
end to end on the CPU), and of ``tests/test_aux.py``'s serve case over
a run the port recorded."""

import glob
import json
import os
import threading
import time
import urllib.request

import pytest

from jepsen_etcd_tpu_torch.serve import make_server


def mk_run(base, test_name, run_name, results, test, history="",
           trace=None):
    d = base / test_name / run_name
    d.mkdir(parents=True)
    # all_runs only lists dirs that hold a history.jsonl
    (d / "history.jsonl").write_text(history)
    (d / "results.json").write_text(json.dumps(results))
    (d / "test.json").write_text(json.dumps(test))
    if trace is not None:
        (d / "trace.jsonl").write_text(
            "".join(json.dumps(e) + "\n" for e in trace))
    return d


TELEMETRY = {
    "schema": 1,
    "spans": {"phase:check": {"count": 1, "total_s": 0.5},
              "checker:workload": {"count": 1, "total_s": 0.4},
              "wgl.check_packed": {"count": 3, "total_s": 0.3}},
    "counters": {"engine.jnp-ladder": 3, "wgl.rungs": 7},
    "phases": {"setup": 0.1, "generate": 1.2, "teardown": 0.05,
               "check": 0.5},
    "checkers": {"workload": 0.4},
    "file": "telemetry.jsonl",
}


@pytest.fixture
def store(tmp_path):
    base = tmp_path / "store"
    mk_run(base, "etcd-register", "00001",
           {"valid?": True, "stats": {"valid?": True, "count": 120},
            "workload": {"valid?": True},
            "telemetry": TELEMETRY,
            "net-trace": {"events": 2, "dropped": 0,
                          "counts": {"send": 1, "deliver": 1}}},
           {"name": "etcd-register", "workload": "register",
            "nemesis_spec": [], "db_mode": "sim", "time_limit": 30,
            "rate": 200.0, "nodes": ["n1", "n2"]},
           trace=[{"t": 1_000_000, "kind": "send", "src": "n1",
                   "dst": "n2", "msg": "append"},
                  {"t": 2_000_000, "kind": "deliver", "src": "n2",
                   "dst": "n1", "msg": "append"},
                  {"truncated": 0}])
    mk_run(base, "etcd-register-kill", "00001",
           {"valid?": False, "stats": {"valid?": True, "count": 80},
            "workload": {"valid?": False}},
           {"name": "etcd-register-kill", "workload": "register",
            "nemesis_spec": ["kill"], "db_mode": "sim"})
    mk_run(base, "etcd-set-kill", "00001",
           {"valid?": False, "stats": {"valid?": True, "count": 60},
            "workload": {"valid?": False}},
           {"name": "etcd-set-kill", "workload": "set",
            "nemesis_spec": ["kill"], "db_mode": "sim"})
    mk_run(base, "weird", "00001",
           {"valid?": True, "stats": {"valid?": True, "count": 1}},
           {"name": "x<b>run</b>", "workload": "none",
            "nemesis_spec": [], "db_mode": "sim"})
    return base


@pytest.fixture
def server(store):
    srv = make_server(str(store), port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()


def get(url):
    return urllib.request.urlopen(url, timeout=10).read().decode()


def test_index(server):
    page = get(server + "/")
    assert 'class="ok">True' in page
    assert 'class="bad">False' in page
    assert 'href="/aggregate"' in page
    assert "etcd-register/00001" in page
    assert "<td>120</td>" in page      # op count column


def test_run_page(server):
    page = get(server + "/etcd-register/00001/")
    assert "Parameters" in page and "Checkers" in page
    # telemetry section: phase bar, span table, counters, file link
    assert "Telemetry" in page
    assert "class='barbox'" in page
    assert "wgl.check_packed" in page and "<td>3</td>" in page
    assert "engine.jnp-ladder</code>=3" in page
    # net-trace summary links to the event viewer
    assert "Network trace" in page and "2 events" in page
    assert "?trace" in page
    # artifact links
    assert "results.json" in page and "history.jsonl" in page


def test_aggregate_dashboard(server):
    page = get(server + "/aggregate")
    assert "Cross-run dashboard" in page and "4 runs" in page
    # matrix: workload rows x (nemesis, db) columns with counts
    assert "Pass/fail matrix" in page
    assert "<th>register</th>" in page and "<th>set</th>" in page
    assert "kill" in page
    assert "1&nbsp;pass" in page and "1&nbsp;fail" in page
    # phase breakdown bars from telemetry (and the no-telemetry dim)
    assert "Phase breakdown" in page
    assert "class='barbox'" in page
    assert "no telemetry" in page
    # failure dedupe: both kill runs share one verdict signature
    assert "Failure dedupe" in page
    assert "workload=False" in page
    assert "<td>2</td>" in page


def test_trace_viewer(server):
    page = get(server + "/etcd-register/00001/?trace")
    assert "2 of 2 events shown" in page
    assert "<td>send</td>" in page and "<td>deliver</td>" in page
    assert "n1" in page and "append" in page
    # per-kind filter
    page = get(server + "/etcd-register/00001/?trace=send")
    assert "1 of 2 events shown" in page
    assert "<td>send</td>" in page and "<td>deliver</td>" not in page
    # a run without trace.jsonl degrades gracefully
    page = get(server + "/weird/00001/?trace")
    assert "no trace.jsonl" in page


def test_escaping(server):
    # run-controlled strings (test name) must never reach the page raw
    page = get(server + "/weird/00001/")
    assert "<b>run</b>" not in page
    assert "x&lt;b&gt;run&lt;/b&gt;" in page


def test_raw_files_still_served(server):
    raw = get(server + "/etcd-register/00001/results.json")
    assert json.loads(raw)["valid?"] is True
    listing = get(server + "/etcd-register/00001/?files")
    assert "Directory listing" in listing
    assert "history.jsonl" in listing


# -- a run the port recorded (test_aux.py) ------------------------------------

def test_serve_store(tmp_path):
    from jepsen_etcd_tpu_torch.compose import etcd_test
    from jepsen_etcd_tpu_torch.runner.test_runner import run_test
    out = run_test(etcd_test({"workload": "register", "time_limit": 5,
                              "rate": 50, "seed": 4, "device": "cpu",
                              "store_base": str(tmp_path)}))
    srv = make_server(str(tmp_path), port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        port = srv.server_address[1]
        idx = get(f"http://127.0.0.1:{port}/")
        rel = os.path.relpath(out["dir"], str(tmp_path))
        assert rel in idx and "valid?" in idx
        # run report page: params, per-checker verdicts, artifacts
        page = get(f"http://127.0.0.1:{port}/{rel}/")
        assert "Parameters" in page and "Checkers" in page
        assert "results.json" in page and "workload" in page
        # raw artifacts still served
        res = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/{rel}/results.json", timeout=10)
        assert res.status == 200
        assert json.load(res).get("valid?") is True
        # ?files bypasses the report page for the raw listing
        raw = get(f"http://127.0.0.1:{port}/{rel}/?files")
        assert "history.jsonl" in raw
    finally:
        srv.shutdown()
        srv.server_close()


def test_aggregate_separates_infrastructure_errors(tmp_path):
    """Failure dedupe splits real checker verdicts from no-verdict
    harness noise instead of lumping both under one group
    (test_guided.py's case)."""
    from jepsen_etcd_tpu_torch.serve import aggregate_html

    def fake_run(name, results):
        rdir = tmp_path / name / "0001"
        rdir.mkdir(parents=True)
        (rdir / "history.jsonl").write_text("")
        (rdir / "results.json").write_text(json.dumps(results))

    fake_run("verdict", {"valid?": False,
                         "workload": {"valid?": False}})
    fake_run("infra", {"valid?": False})
    page = aggregate_html(str(tmp_path))
    assert "workload=False" in page
    assert "Infrastructure / harness errors" in page
    assert "(no checker verdict)" not in page
    assert "infra/0001" in page.split(
        "Infrastructure / harness errors")[1]


# -- /live SSE (test_tel_plane.py) --------------------------------------------

@pytest.fixture
def http_store(tmp_path):
    srv = make_server(str(tmp_path), port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", tmp_path
    finally:
        srv.shutdown()
        srv.server_close()


def test_live_page_and_inactive_sse(http_store):
    url, _ = http_store
    page = get(url + "/live")
    assert "EventSource" in page and "sse=1" in page
    assert "<title>live — jepsen_etcd_tpu_torch</title>" in page
    # no campaign ever ran live: exactly one terminal event
    body = get(url + "/live?sse=1")
    assert body.startswith("data: ")
    assert json.loads(body[len("data: "):].strip()) == \
        {"active": False}


def _first_event(url: str, timeout: float = 10) -> dict:
    resp = urllib.request.urlopen(url + "/live?sse=1", timeout=timeout)
    line = resp.readline()
    while line and not line.startswith(b"data: "):
        line = resp.readline()
    resp.close()
    return json.loads(line[len(b"data: "):].decode())


def test_live_sse_streams_fresh_snapshot(http_store):
    url, base = http_store
    cdir = base / "camp" / "00000"
    cdir.mkdir(parents=True)
    (cdir / "live.json").write_text(json.dumps({
        "campaign": "camp-00000", "records": 5, "dropped": 0,
        "bad": 0, "runs": {"camp-00000.r0": {"spans": 3,
                                             "phase": "generate"}},
        "service": {}, "counters": {}, "hists": {}, "done": False}))
    payload = _first_event(url)
    assert payload["active"] is True
    assert payload["campaign"] == "camp-00000"
    assert payload["runs"]["camp-00000.r0"]["phase"] == "generate"
    assert payload["dir"] == os.path.join("camp", "00000")


def test_pool_campaign_live_plane_e2e(tmp_path):
    """3 sim runs over a 2-worker pool with the live plane on, checked
    on the CPU: /live serves an SSE update while the campaign is still
    running, the collector's fold survives to campaign.json (trace ids,
    p50/95/99 triples, net counters), and the tel CLI's ledger +
    coverage both verify the artifacts."""
    from jepsen_etcd_tpu_torch import tel_cli
    from jepsen_etcd_tpu_torch.runner.campaign import run_campaign
    specs = [{"index": i,
              "opts": {"workload": "register", "time_limit": 1,
                       "rate": 100.0, "seed": 11 + i, "device": "cpu",
                       "nodes": ["n1", "n2", "n3"]}}
             for i in range(3)]
    res = {}

    def go():
        try:
            res["summary"] = run_campaign(
                specs, pool=2, service=False,
                store_base=str(tmp_path), name="livecamp")
        except BaseException as e:  # surfaced by the main thread
            res["err"] = e

    t = threading.Thread(target=go, daemon=True)
    t.start()
    live = None
    deadline = time.time() + 120
    while time.time() < deadline and not live:
        found = glob.glob(os.path.join(str(tmp_path), "livecamp",
                                       "*", "live.json"))
        live = found[0] if found else None
        time.sleep(0.1)
    assert live, "collector never published live.json"

    srv = make_server(str(tmp_path), port=0)
    st = threading.Thread(target=srv.serve_forever, daemon=True)
    st.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        payload = _first_event(url, timeout=30)
        assert "active" in payload and "runs" in payload
        assert payload["campaign"].startswith("livecamp-")
    finally:
        srv.shutdown()
        srv.server_close()

    t.join(timeout=600)
    assert not t.is_alive(), "campaign hung"
    assert "err" not in res, res.get("err")
    summary = res["summary"]
    assert summary["valid?"] is True
    ctr = summary["telemetry"]["counters"]
    assert ctr.get("live.records", 0) > 0
    assert ctr.get("live.dropped", 0) == 0
    for r in summary["runs"]:
        assert r["trace"] == f"{summary['trace']}.r{r['index']}"
        assert set(r["net"]) == {"dropped_chunks", "accept_errors",
                                 "delayed_bytes"}
        assert len(r["p"]["gen"]) == 3  # [p50, p95, p99]
        assert r["hists"]["gen"]["count"] > 0
    assert len(summary["p"]["gen"]) == 3
    snap = json.load(open(live))
    assert snap["done"] is True
    assert set(snap["runs"]) >= {r["trace"] for r in summary["runs"]}

    led = tel_cli.ledger(summary["dir"])
    assert led["ok"] is True, led
    cov = tel_cli.coverage(summary["dir"])
    assert cov["aggregate"]["count"] == 3
    assert cov["aggregate"]["invalid"] == 0
