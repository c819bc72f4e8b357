"""The port's ``tel`` command (``tel_cli.py``) and the campaign's
``LiveCollector`` against the JAX package's, on the CPU, on the tel-CLI
and collector cases of ``tests/test_tel_plane.py``: span tables, diffs,
the campaign ledger and the coverage vector print what the reference's
print on the same artifacts; the collector folds a worker's datagrams
into ``live.json`` as the reference's does; and a pooled campaign with
the live plane on carries trace ids, per-row percentiles and net
counters that ``tel --ledger`` and ``--coverage`` verify. The
reference's ``/live`` SSE cases run against the port's ``serve.py`` in
``tests/test_torch_serve.py``."""

import json
import os
import socket
import time

import pytest

from jepsen_etcd_tpu import tel_cli as ref_tel
from jepsen_etcd_tpu.runner.campaign import LiveCollector as RefCollector
from jepsen_etcd_tpu_torch import cli, tel_cli
from jepsen_etcd_tpu_torch.runner import telemetry
from jepsen_etcd_tpu_torch.runner.campaign import LiveCollector, run_campaign
from jepsen_etcd_tpu_torch.runner.telemetry import Telemetry
from test_torch_fixtures import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _isolate_current():
    telemetry.set_current(None)
    telemetry.set_thread_current(None)
    yield
    telemetry.set_current(None)
    telemetry.set_thread_current(None)


def both(capsys, fn_name, *args, **kw) -> tuple:
    """(rc, stdout) of the port's and the reference's tel function."""
    out = []
    for mod in (tel_cli, ref_tel):
        rc = getattr(mod, fn_name)(*args, **kw)
        out.append((rc, capsys.readouterr().out))
    return tuple(out)


def _wait_until(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


def _feed_collector(cls, cdir):
    col = cls(str(cdir), trace="camp").start()
    try:
        tel = Telemetry(str(cdir / "r0.jsonl"), trace="camp.r0",
                        parent="camp", sink=col.path)
        with tel.span("phase:generate"):
            pass
        tel.counter("net.dropped_chunks", 3)
        tel.hist("op.latency.write", 0.004)
        tel.close()
        assert tel.sink_dropped == 0
        assert _wait_until(lambda: col.records >= 3)
        s = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        s.sendto(b"not json", col.path)
        s.close()
        assert _wait_until(lambda: col.bad == 1)
        col.note_row({"trace": "camp.r0", "index": 0, "status": "done",
                      "valid": True})
    finally:
        stats = col.close()
    assert not os.path.exists(col.path), "socket not unlinked"
    with open(cdir / "live.json") as f:
        snap = json.load(f)
    return stats, snap


def test_live_collector_folds_worker_stream(tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    stats, snap = _feed_collector(LiveCollector, tmp_path / "p")
    ref_stats, ref_snap = _feed_collector(RefCollector, tmp_path / "r")
    assert stats == ref_stats
    assert stats["records"] >= 3 and stats["bad"] == 1
    assert stats["dropped"] == 0
    assert snap["done"] is True and snap["campaign"] == "camp"
    st = snap["runs"]["camp.r0"]
    assert st["status"] == "done" and st["valid"] is True
    assert snap["counters"] == ref_snap["counters"]
    assert snap["counters"].get("net.dropped_chunks") == 3
    assert snap["hists"]["op.latency.*"]["count"] == 1
    for k in ("runs", "hists"):
        assert set(snap[k]) == set(ref_snap[k])


def _mini_run(path, trace=None, lat=0.01):
    tel = Telemetry(str(path), trace=trace)
    with tel.span("phase:check"):
        pass
    tel.hist("service.queue_wait_s", lat)
    tel.close()


def test_tel_cli_spans_over_dir(tmp_path, capsys):
    _mini_run(tmp_path / "telemetry.jsonl", trace="t1")
    (rc, got), (ref_rc, want) = both(capsys, "cmd_spans",
                                     [str(tmp_path)], as_json=True)
    assert rc == ref_rc == 0
    assert json.loads(got) == json.loads(want)
    out = json.loads(got)
    assert out["traces"] == ["t1"] and "phase:check" in out["spans"]
    assert out["hists"]["service.queue_wait_s"]["count"] == 1
    with open(tmp_path / "telemetry.jsonl", "ab") as f:
        f.write(b'{"kind":"span","na')
    (rc, got), (_, want) = both(capsys, "cmd_spans", [str(tmp_path)],
                                as_json=False)
    assert rc == 0 and got == want and "1 torn/skipped" in got


def test_tel_cli_diff(tmp_path, capsys):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(), b.mkdir()
    _mini_run(a / "telemetry.jsonl")
    _mini_run(b / "telemetry.jsonl")
    (rc, got), (ref_rc, want) = both(capsys, "cmd_diff", [str(a), str(b)],
                                     as_json=True)
    assert rc == ref_rc == 0
    assert json.loads(got)["spans"][0]["count_a"] == 1
    assert [{k: v for k, v in d.items() if k in ("span", "count_a",
                                                 "count_b")}
            for d in json.loads(got)["spans"]] == \
        [{k: v for k, v in d.items() if k in ("span", "count_a",
                                              "count_b")}
         for d in json.loads(want)["spans"]]
    with pytest.raises(SystemExit):
        tel_cli.cmd_diff([str(a)], as_json=True)


def _bad_ledger(tmp_path):
    (tmp_path / "campaign.json").write_text(json.dumps({
        "trace": "c", "runs": [
            {"status": "done", "trace": "c.r0", "service_shipped": 5,
             "service_queue_wait_s": 0.5}],
        "service": {"counters": {"service.submitted": 4,
                                 "service.queue_wait_s": 0.5}}}))
    with open(tmp_path / "service.jsonl", "w") as f:
        f.write(json.dumps({"kind": "span", "name": "service.tick",
                            "t0": 0, "t1": 1, "dur_s": 1,
                            "attrs": {"runs": ["c.r9"]}}) + "\n")


@pytest.mark.parametrize("as_json", [True, False])
def test_tel_cli_ledger_flags_mismatches(tmp_path, capsys, as_json):
    _bad_ledger(tmp_path)
    (rc, got), (ref_rc, want) = both(capsys, "cmd_ledger",
                                     [str(tmp_path)], as_json=as_json)
    assert rc == ref_rc == 1
    assert got == want
    if as_json:
        by = {c["check"]: c["ok"] for c in json.loads(got)["checks"]}
        assert by == {"shipped==submitted": False,
                      "queue_wait attribution": True,
                      "trace join (rows ⊆ tick spans)": False}


def test_tel_cli_coverage_vector(tmp_path, capsys):
    rdir = tmp_path / "etcd-register" / "00001"
    rdir.mkdir(parents=True)
    (rdir / "results.json").write_text(json.dumps({
        "valid?": False, "workload": {"valid?": False},
        "telemetry": {"counters": {"wgl.max-frontier": 17,
                                   "wgl.rungs": 3,
                                   "wgl.host-spill": 1}}}))
    out = tel_cli.coverage(str(tmp_path))
    assert out == ref_tel.coverage(str(tmp_path))
    agg = out["aggregate"]
    assert (agg["count"], agg["peak_frontier"], agg["rungs"],
            agg["spills"], agg["invalid"]) == (1, 17, 3, 1, 1)
    assert agg["signatures"] == {"workload=False": 1}
    (rc, got), (_, want) = both(capsys, "cmd_coverage", [str(tmp_path)],
                                as_json=False)
    assert rc == 0 and got == want


def test_tel_command_through_the_cli(tmp_path, capsys):
    _mini_run(tmp_path / "telemetry.jsonl", trace="t1")
    assert cli.main(["tel", str(tmp_path), "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["traces"] == ["t1"]


def test_pool_campaign_live_plane_e2e(tmp_path, capsys):
    """3 sim runs over a pool of 2 with the live plane on: the
    collector's fold reaches campaign.json (trace ids, percentile
    triples, net counters), live.json ends done, and the port's and the
    reference's ``tel --ledger`` and ``--coverage`` verify the
    artifacts alike."""
    specs = [{"index": i,
              "opts": {"workload": "register", "time_limit": 1,
                       "rate": 100.0, "seed": 11 + i,
                       "nodes": ["n1", "n2", "n3"], "device": "cpu"}}
             for i in range(3)]
    summary = run_campaign(specs, pool=2, service=False,
                           store_base=str(tmp_path), name="livecamp")
    assert summary["valid?"] is True
    ctr = summary["telemetry"]["counters"]
    assert ctr.get("live.records", 0) > 0
    assert ctr.get("live.dropped", 0) == 0
    for r in summary["runs"]:
        assert r["trace"] == f"{summary['trace']}.r{r['index']}"
        assert set(r["net"]) == {"dropped_chunks", "accept_errors",
                                 "delayed_bytes"}
        assert len(r["p"]["gen"]) == 3
        assert r["hists"]["gen"]["count"] > 0
    assert len(summary["p"]["gen"]) == 3
    with open(os.path.join(summary["dir"], "live.json")) as f:
        snap = json.load(f)
    assert snap["done"] is True
    assert set(snap["runs"]) >= {r["trace"] for r in summary["runs"]}

    led = tel_cli.ledger(summary["dir"])
    assert led["ok"] is True, led
    assert led == ref_tel.ledger(summary["dir"])
    cov = tel_cli.coverage(summary["dir"])
    assert cov == ref_tel.coverage(summary["dir"])
    assert cov["aggregate"]["count"] == 3
    assert cov["aggregate"]["invalid"] == 0
