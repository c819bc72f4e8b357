"""The port's campaign runner (``runner/campaign.py``) against the JAX
package's, on the CPU, on the shapes of ``tests/test_campaign.py``:
the matrix expands to the same specs, a campaign's rows and
``campaign.json`` equal the reference's (timing fields, paths and trace
ids aside), pooled runs get their own store dirs, a crashed run is one
error row, epoch-v2 and epoch-v3 cells generate in one batched pass
each, and the 50-run campaign through one checker service coalesces
with its ledger balanced and every stored verdict equal to in-process
re-checks by both packages.

Every spec names ``device="cpu"``. The service runs on eight CPU lanes
(``wgl_mxu.batch_lanes`` substituted, as in
``tests/test_torch_checker_service_lanes.py``) with the wave kernel's
gate open (``wgl._b1_first``), so it runs the kernel's plain version as
the in-process check does. Off the TPU the reference's checker skips
its Pallas kernel; where its rows are compared on force-kernel runs,
its ``_run_fused`` is patched to call through (interpret mode), as the
port takes its kernel's plain version."""

import json
import os
import threading

import pytest
import torch

from jepsen_etcd_tpu.forensics import load_history as ref_load_history
from jepsen_etcd_tpu.ops import wgl as ref_wgl
from jepsen_etcd_tpu.runner import campaign as ref_campaign
from jepsen_etcd_tpu.workloads.register import workload as ref_workload
from jepsen_etcd_tpu_torch.core.history import History
from jepsen_etcd_tpu_torch.ops import wgl, wgl_mxu
from jepsen_etcd_tpu_torch.runner import campaign
from jepsen_etcd_tpu_torch.runner import checker_service as svc_mod
from jepsen_etcd_tpu_torch.runner.store import make_store_dir
from jepsen_etcd_tpu_torch.simbatch import generate_for_opts, history_sha
from jepsen_etcd_tpu_torch.workloads.register import workload
from test_torch_fixtures import one_torch_thread  # noqa: F401

#: verdict projection compared between a service-checked run and an
#: in-process re-check (the reference test's)
PROJECTION = ("valid?", "waves", "peak-frontier", "ops", "info-ops",
              "op", "error", "stuck-at-depth")

#: row fields read off a host clock, or naming where a run was stored
TIMING = ("dir", "trace", "wall_s", "gen_ops_per_s", "check_s",
          "service_queue_wait_s")
#: histogram groups of wall durations (gen is virtual time: compared)
WALL_HISTS = ("check", "queue_wait")

BASE = {"time_limit": 1, "rate": 100.0, "nodes": ["n1", "n2", "n3"]}


def port_specs(base, *args, **kw) -> list:
    return campaign.campaign_specs(dict(base, device="cpu"), *args, **kw)


def comparable_row(row: dict) -> dict:
    out = {k: v for k, v in row.items() if k not in TIMING}
    for key in ("hists", "p"):
        out[key] = {g: v for g, v in (row.get(key) or {}).items()
                    if g not in WALL_HISTS}
    return out


def assert_rows_equal(got: list, want: list) -> None:
    assert [comparable_row(r) for r in got] == \
        [comparable_row(r) for r in want]


def run_both(tmp_path, base, wls, nemeses, runs_per_cell, seed0,
             name) -> tuple:
    """The same campaign inline (pool 0, no service) through both
    packages."""
    want = ref_campaign.run_campaign(
        ref_campaign.campaign_specs(base, wls, nemeses, runs_per_cell,
                                    seed0),
        pool=0, service=False, store_base=str(tmp_path / "ref"),
        name=name)
    got = campaign.run_campaign(
        port_specs(base, wls, nemeses, runs_per_cell, seed0),
        pool=0, service=False, store_base=str(tmp_path / "port"),
        name=name)
    return got, want


def linear_view(results: dict) -> dict:
    return {str(k): {f: (v.get("linear") or {}).get(f) for f in PROJECTION}
            for k, v in results["workload"]["results"].items()}


def recheck_port(run_dir: str) -> dict:
    """The run's own checker in-process (no service) over its stored
    history, on the CPU."""
    with open(os.path.join(run_dir, "test.json")) as f:
        test = json.load(f)
    test.pop("checker_service", None)
    with open(os.path.join(run_dir, "history.jsonl")) as f:
        history = History.from_jsonl(f.read())
    res = workload(test)["checker"].check(test, history)
    return linear_view({"workload": res})


def recheck_reference(run_dir: str) -> dict:
    """The JAX package's checker over the port's stored history (its
    kernel patched on by the caller)."""
    with open(os.path.join(run_dir, "test.json")) as f:
        test = json.load(f)
    test.pop("checker_service", None)
    test.pop("device", None)
    res = ref_workload(test)["checker"].check(test,
                                              ref_load_history(run_dir))
    return linear_view({"workload": res})


def stored_view(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "results.json")) as f:
        return linear_view(json.load(f))


@pytest.fixture
def reference_kernel(monkeypatch):
    monkeypatch.setattr(ref_wgl, "_run_fused",
                        lambda broken, name, call: call())


@pytest.fixture
def service_lanes(monkeypatch):
    """Eight CPU lanes for the service, the wave kernel's gate open."""
    lanes = [torch.device("cpu")] * 8
    monkeypatch.setattr(
        wgl_mxu, "batch_lanes",
        lambda device=None: [torch.device(device)] if device is not None
        else list(lanes))
    monkeypatch.setattr(wgl, "_b1_first", lambda device: True)
    yield
    svc_mod.reset_clients()


def test_campaign_specs_expand_with_distinct_seeds():
    args = ({"rate": 5.0}, ["register", "set"], [[], ["kill"]])
    specs = campaign.campaign_specs(*args, runs_per_cell=3, seed0=10)
    assert specs == ref_campaign.campaign_specs(*args, runs_per_cell=3,
                                                seed0=10)
    assert len(specs) == 12
    assert [s["opts"]["seed"] for s in specs] == list(range(10, 22))


def test_store_dirs_are_collision_safe(tmp_path):
    """Concurrent make_store_dir calls (pooled workers racing on one
    base) never hand two callers the same directory."""
    dirs: list = []
    lock = threading.Lock()

    def claim():
        d = make_store_dir(str(tmp_path), "race")
        with lock:
            dirs.append(d)

    threads = [threading.Thread(target=claim) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(set(dirs)) == 16
    assert all(os.path.isdir(d) for d in dirs)


def test_campaign_pool_e2e(tmp_path):
    """12 sim runs over a pool of 3 spawned workers: every run its own
    store dir with its artifacts, rows indexed in order, and rows equal
    to the reference's inline campaign of the same specs."""
    specs = port_specs(BASE, ["register"], [[], ["kill"]],
                       runs_per_cell=6, seed0=7)
    summary = campaign.run_campaign(specs, pool=3, service=False,
                                    store_base=str(tmp_path), name="e2e")
    assert summary["valid?"] is True and summary["failures"] == []
    rows = summary["runs"]
    assert [r["index"] for r in rows] == list(range(12))
    assert all(r["status"] == "done" and r["valid"] is True
               for r in rows)
    assert len({r["dir"] for r in rows}) == 12
    for r in rows:
        for f in ("results.json", "history.jsonl"):
            assert os.path.isfile(os.path.join(r["dir"], f))
        assert r["ops"] > 0
    ctr = summary["telemetry"]["counters"]
    assert ctr.get("campaign.runs") == ctr.get("campaign.completed") == 12
    assert not ctr.get("campaign.failed")
    with open(os.path.join(summary["dir"], "campaign.json")) as f:
        assert json.load(f)["count"] == 12
    want = ref_campaign.run_campaign(
        ref_campaign.campaign_specs(BASE, ["register"], [[], ["kill"]],
                                    runs_per_cell=6, seed0=7),
        pool=0, service=False, store_base=str(tmp_path / "ref"),
        name="e2e")
    assert_rows_equal(rows, want["runs"])


def test_campaign_counts_errors_and_fails(tmp_path):
    """A crashing run is one error row, not a dead sweep, and it fails
    the campaign, as the reference's does."""
    ok = {"opts": dict(BASE, workload="register", rate=40.0, seed=3)}
    bad = {"opts": dict(BASE, workload="no-such-workload", rate=40.0,
                        seed=4)}
    want = ref_campaign.run_campaign([ok, bad], pool=0, service=False,
                                     store_base=str(tmp_path / "ref"),
                                     name="mixed")
    summary = campaign.run_campaign(
        [{"opts": dict(s["opts"], device="cpu")} for s in (ok, bad)],
        pool=0, service=False, store_base=str(tmp_path), name="mixed")
    rows = summary["runs"]
    assert rows[0]["status"] == "done" and rows[0]["valid"] is True
    assert rows[1]["status"] == "error"
    assert summary["valid?"] is False and len(summary["failures"]) == 1
    ctr = summary["telemetry"]["counters"]
    assert ctr.get("campaign.completed") == ctr.get("campaign.errors") == 1
    assert comparable_row(rows[0]) == comparable_row(want["runs"][0])
    assert [r["status"] for r in rows] == \
        [r["status"] for r in want["runs"]]


@pytest.mark.parametrize("opts", [
    {}, {"workload": "set"}, {"gen_epoch": "epoch-v1"},
    {"gen_epoch": "epoch-v3"}, {"client_type": "http"},
    {"db_mode": "local"}, {"db_mode": "sim"}, {"stream": True},
    {"soak": True}, {"workload": "watch"}, {"workload": "append"},
])
def test_batchable_gate(opts):
    """Only epoch-v2/v3 sim runs of the batched generator's workloads
    leave the pool, as in the reference."""
    spec = dict({"workload": "register", "gen_epoch": "epoch-v2"}, **opts)
    assert campaign._batchable(dict(spec)) is \
        ref_campaign._batchable(dict(spec))


def test_campaign_epoch_v2_batched_routing(tmp_path):
    """Epoch-v2: each (workload, nemesis) cell's seeds generate in one
    batched pass, the epoch is recorded per row, rows and the genbatch
    ledger equal the reference's, and every stored verdict equals an
    in-process re-check."""
    base = dict(BASE, gen_epoch="epoch-v2")
    got, want = run_both(tmp_path, base, ["register"], [[], ["kill"]],
                         3, 50, "batched")
    assert got["valid?"] is True, got["failures"]
    rows = got["runs"]
    assert len(rows) == 6
    assert all(r["status"] == "done" and r["valid"] is True
               and r["gen-epoch"] == "epoch-v2" for r in rows)
    gb = got["genbatch"]
    assert gb["cells"] == 2 and gb["seeds"] == 6 and gb["ops_per_s"] > 0
    assert {k: v for k, v in gb.items() if k != "ops_per_s"} == \
        {k: v for k, v in want["genbatch"].items() if k != "ops_per_s"}
    ctr = got["telemetry"]["counters"]
    assert ctr.get("genbatch.cells") == 2 and ctr.get("genbatch.seeds") == 6
    with open(os.path.join(got["dir"], "campaign.json")) as f:
        cjson = json.load(f)
    assert [r["gen-epoch"] for r in cjson["runs"]] == ["epoch-v2"] * 6
    assert_rows_equal(rows, want["runs"])
    for r in rows:
        assert stored_view(r["dir"]) == recheck_port(r["dir"])


def test_campaign_epoch_v3_generates_on_the_named_device(tmp_path):
    """Epoch-v3 cells generate through ``generate_for_opts`` on the
    spec's device: each run's stored history is the one a direct call
    gives, its row records epoch-v3, and its verdict equals an
    in-process re-check."""
    base = dict(BASE, gen_epoch="epoch-v3", device="cpu")
    specs = campaign.campaign_specs(base, ["register"], [["kill"]],
                                    runs_per_cell=3, seed0=20)
    summary = campaign.run_campaign(specs, pool=0, service=False,
                                    store_base=str(tmp_path), name="v3")
    assert summary["valid?"] is True, summary["failures"]
    assert summary["genbatch"]["epoch"] == "epoch-v3"
    direct = generate_for_opts(dict(specs[0]["opts"]), [20, 21, 22],
                               device="cpu")["histories"]
    for r, h in zip(summary["runs"], direct):
        assert r["gen-epoch"] == "epoch-v3"
        with open(os.path.join(r["dir"], "history.jsonl")) as f:
            stored = History.from_jsonl(f.read())
        assert history_sha(stored) == history_sha(h)
        assert stored_view(r["dir"]) == recheck_port(r["dir"])


def test_campaign_epoch_v1_rows_record_epoch(tmp_path):
    got, want = run_both(tmp_path, BASE, ["register"], [[]], 1, 7, "v1")
    assert got["runs"][0]["gen-epoch"] == "epoch-v1"
    assert got["genbatch"] is None and want["genbatch"] is None
    assert_rows_equal(got["runs"], want["runs"])


def test_force_kernel_rows_equal_the_references(tmp_path,
                                                reference_kernel):
    """With every key device-bound, the port's rows (engines and
    dispatch counts included) equal the reference's with its kernel
    on."""
    base = dict(BASE, force_kernel=True)
    got, want = run_both(tmp_path, base, ["register"], [[], ["kill"]],
                         2, 100, "fk")
    assert got["valid?"] is True
    assert all(r["engines"] == {"mxu-wave": 1} and r["dispatches"] >= 1
               for r in got["runs"])
    assert_rows_equal(got["runs"], want["runs"])


def test_campaign_without_a_card_raises_before_anything_starts(
        tmp_path, monkeypatch):
    """A spec that asks for the card, with none: one raise, before the
    collector, the service or the pool start, and no store dir."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    specs = campaign.campaign_specs(BASE, ["register"], [[]],
                                    runs_per_cell=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        campaign.run_campaign(specs, pool=2, service=True,
                              store_base=str(tmp_path), name="nocard")
    assert os.listdir(str(tmp_path)) == []


def test_campaign_coalescing_50_runs(tmp_path, service_lanes,
                                     reference_kernel):
    """The acceptance bar: 50 forced-kernel runs from 4 spawned workers
    through one service coalesce into at most one launch per (bucket,
    width, tick); the producer-side ledger balances; the lanes share
    the work; and every stored verdict equals in-process re-checks by
    the port and by the reference."""
    base = dict(BASE, force_kernel=True)
    specs = port_specs(base, ["register"], [[]], runs_per_cell=50,
                       seed0=100)
    summary = campaign.run_campaign(specs, pool=4, service=True,
                                    service_tick_s=0.05,
                                    store_base=str(tmp_path),
                                    name="coalesce")
    assert summary["valid?"] is True, summary["failures"]
    rows = summary["runs"]
    assert len(rows) == 50
    assert all(r["status"] == "done" and r["valid"] is True
               for r in rows)
    ctr = summary["telemetry"]["counters"]
    assert ctr.get("campaign.completed") == 50

    submitted = ctr.get("service.submitted", 0)
    group_ticks = ctr.get("service.group_ticks", 0)
    dispatches = ctr.get("wgl.dispatches", 0) + ctr.get("mxu.dispatches", 0)
    assert submitted >= 50, ctr
    assert 0 < group_ticks < submitted, ctr
    assert 0 < dispatches <= group_ticks, ctr
    assert ctr.get("service.batch_occupancy", 0) >= 2, ctr
    assert not ctr.get("service.fallback"), ctr
    assert sum(r["dispatches"] for r in rows) == 0
    assert sum(r["service_fallbacks"] for r in rows) == 0
    assert sum(r["service_shipped"] for r in rows) == submitted

    prefix = "service.device_dispatches."
    disp = {k[len(prefix):]: v for k, v in ctr.items()
            if k.startswith(prefix)}
    assert set(disp) == {f"cpu0.{i}" for i in range(8)}, disp
    assert max(disp.values()) <= 2 * min(disp.values()), disp
    assert sum(disp.values()) == \
        group_ticks + ctr.get("service.shard_fanout", 0), ctr
    assert ctr.get("service.device_occupancy") == 8, ctr

    for r in rows:
        got = stored_view(r["dir"])
        assert got == recheck_port(r["dir"]), r["dir"]
        assert got == recheck_reference(r["dir"]), r["dir"]
