"""Twin of the reference's ``tests/test_telemetry.py`` on the port's
``runner/telemetry.py``: the recorder's records and summaries (on a
fake clock) equal the reference's; a simulated run writes and
reconciles its telemetry, with the same spans, counters and records as
the reference's run on the same opts (wall-clock seconds aside); the
opt-out; the forced-kernel counters, on the wave kernel's route and on
the ladder's, equal the reference's; and the reference benchmark's cell
span, recorded by the port's recorder, has the run schema."""

import json
import os
import random

import pytest

from jepsen_etcd_tpu.checkers.tpu_linearizable import \
    TPULinearizableChecker as RefTPULinearizableChecker
from jepsen_etcd_tpu.core.history import History as RefHistory
from jepsen_etcd_tpu.models import VersionedRegister as RefVR
from jepsen_etcd_tpu.ops import wgl as ref_wgl
from jepsen_etcd_tpu.runner import telemetry as ref_telemetry
from jepsen_etcd_tpu_torch.checkers.independent import Independent
from jepsen_etcd_tpu_torch.checkers.linearizable import (
    LinearizableChecker, check_history)
from jepsen_etcd_tpu_torch.models import VersionedRegister
from jepsen_etcd_tpu_torch.ops import wgl as port_wgl, wgl_mxu
from jepsen_etcd_tpu_torch.runner import telemetry
from jepsen_etcd_tpu_torch.runner.telemetry import (
    Telemetry, NullTelemetry, NULL, SPAN_FIELDS, COUNTER_FIELDS,
    EVENT_FIELDS, HIST_FIELDS)
from jepsen_etcd_tpu_torch.testing import gen_history, \
    keyed_register_history
from test_torch_fixtures import as_json, both, mod, run_test_both
from test_torch_fixtures import one_torch_thread  # noqa: F401


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


class FakeClock:
    """Deterministic monotonic clock: +0.25 s per reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t


@pytest.fixture(autouse=True)
def _isolate_current():
    """No test may leak a process-current recorder."""
    yield
    telemetry.set_current(None)
    ref_telemetry.set_current(None)


# ---- recorder unit tests ----------------------------------------------------

def _span_records(pkg, tmp_path):
    path = str(tmp_path / f"{pkg}.jsonl")
    tel = mod(pkg, "runner.telemetry").Telemetry(path, clock=FakeClock())
    with tel.span("phase:check", ops=7):
        with tel.span("wgl.check_packed", w=3) as sp:
            sp.set(engine="jnp-ladder", rungs=2)
        with tel.span("wgl.check_packed"):
            pass
    tel.counter("wgl.dispatches", 2)
    tel.close()
    s = tel.summary()
    return read_jsonl(path), dict(s, file=None)


def test_span_records_reconcile_with_summary(tmp_path):
    recs, _ = both(_span_records, tmp_path)
    path = str(tmp_path / "t.jsonl")
    tel = Telemetry(path, clock=FakeClock())
    with tel.span("phase:check", ops=7):
        with tel.span("wgl.check_packed", w=3) as sp:
            sp.set(engine="jnp-ladder", rungs=2)
        with tel.span("wgl.check_packed"):
            pass
    tel.counter("wgl.dispatches", 2)
    tel.close()

    assert read_jsonl(path) == recs
    spans = [r for r in recs if r["kind"] == "span"]
    counters = [r for r in recs if r["kind"] == "counter"]
    assert all(tuple(r.keys()) == SPAN_FIELDS for r in spans)
    assert all(tuple(r.keys()) == COUNTER_FIELDS for r in counters)

    s = tel.summary()
    assert s["schema"] == telemetry.SCHEMA_VERSION == \
        ref_telemetry.SCHEMA_VERSION
    assert s["file"] == "t.jsonl"
    for name, agg in s["spans"].items():
        mine = [r for r in spans if r["name"] == name]
        assert len(mine) == agg["count"]
        assert sum(r["dur_s"] for r in mine) == \
            pytest.approx(agg["total_s"])
    assert s["spans"]["wgl.check_packed"]["count"] == 2
    assert s["phases"] == {"check": s["spans"]["phase:check"]["total_s"]}
    attrs = [r["attrs"] for r in spans if r["name"] == "wgl.check_packed"]
    assert {"w": 3, "engine": "jnp-ladder", "rungs": 2} in attrs
    assert {r["name"]: r["value"] for r in counters} == s["counters"] \
        == {"wgl.dispatches": 2}


def _counter_modes(pkg):
    tel = mod(pkg, "runner.telemetry").Telemetry()
    tel.counter("n")
    tel.counter("n", 4)
    tel.counter("peak", 7, mode="max")
    tel.counter("peak", 3, mode="max")
    tel.counter("peak", 9, mode="max")
    return tel.summary()["counters"]


def test_counter_sum_and_max_modes():
    assert both(_counter_modes) == {"n": 5, "peak": 9}


def test_null_outside_run():
    assert isinstance(telemetry.current(), NullTelemetry)
    assert telemetry.current() is NULL
    assert NULL.enabled is False
    with NULL.span("x", a=1) as sp:
        sp.set(b=2)
    NULL.counter("c")
    NULL.event("e")
    assert NULL.summary() == {} == ref_telemetry.NULL.summary()


def test_set_current_roundtrip():
    tel = Telemetry()
    telemetry.set_current(tel)
    assert telemetry.current() is tel
    # the two packages' recorders are each their own
    assert ref_telemetry.current() is ref_telemetry.NULL
    telemetry.set_current(None)
    assert telemetry.current() is NULL


def _max_records(pkg, tmp_path):
    path = str(tmp_path / f"{pkg}.jsonl")
    tel = mod(pkg, "runner.telemetry").Telemetry(
        path, clock=FakeClock(), max_records=3)
    for _ in range(5):
        with tel.span("s"):
            pass
    tel.close()
    return read_jsonl(path), dict(tel.summary(), file=None)


def test_max_records_drops_past_cap(tmp_path):
    recs, s = both(_max_records, tmp_path)
    assert s["dropped"] == 2
    assert s["spans"]["s"]["count"] == 5
    assert sum(1 for r in recs if r["kind"] == "span") == 3
    drop = [r for r in recs if r["kind"] == "event"
            and r["name"] == "telemetry.dropped"]
    assert drop and drop[0]["attrs"]["dropped"] == 2
    assert tuple(drop[0].keys()) == EVENT_FIELDS


def _close_twice(pkg, tmp_path):
    path = str(tmp_path / f"{pkg}.jsonl")
    tel = mod(pkg, "runner.telemetry").Telemetry(path, clock=FakeClock())
    with tel.span("s"):
        pass
    tel.close()
    tel.close()
    return read_jsonl(path)


def test_close_idempotent(tmp_path):
    assert len(both(_close_twice, tmp_path)) == 1


# ---- end-to-end: a sim run writes and reconciles telemetry ------------------

BASE = {"time_limit": 4, "rate": 50, "ops_per_key": 30, "seed": 11}


def run(tmp_path, **opts):
    port, ref, _, _ = run_test_both(tmp_path, dict(BASE, **opts))
    return port, ref


#: counters that read the host's clock
WALL_CLOCK_COUNTERS = ("generate.ops_per_s",)

#: spans only the port records: inside the ladder, around the split and
#: around the DFS
PORT_SPANS = ("wgl.tables", "wgl.frames", "wgl.graph-capture",
              "wgl.graph-replay", "wgl.eager", "independent.split",
              "oracle.dfs")


def shape(out) -> dict:
    """A run's telemetry without its seconds and the port's own spans:
    span counts, counters and the file's (kind, name) records."""
    tel = out["results"]["telemetry"]
    recs = read_jsonl(os.path.join(out["dir"], "telemetry.jsonl"))
    return {"spans": {k: v["count"] for k, v in tel["spans"].items()
                      if k not in PORT_SPANS},
            "counters": {k: v for k, v in tel["counters"].items()
                         if k not in WALL_CLOCK_COUNTERS},
            "phases": sorted(tel["phases"]),
            "checkers": sorted(tel["checkers"]),
            "records": sorted((r["kind"], r["name"]) for r in recs
                              if r["name"] not in PORT_SPANS)}


def test_run_writes_telemetry_and_reconciles(tmp_path):
    out, ref = run(tmp_path, workload="register")
    assert out["valid?"] is True
    assert shape(out) == shape(ref)
    path = os.path.join(out["dir"], "telemetry.jsonl")
    assert os.path.exists(path)

    tel = out["results"]["telemetry"]
    with open(os.path.join(out["dir"], "results.json")) as f:
        assert json.load(f)["telemetry"] == tel

    assert {"setup", "generate", "teardown", "check"} <= \
        set(tel["phases"])
    assert tel["phases"]["check"] > 0
    assert {"perf", "stats", "workload", "crash"} <= set(tel["checkers"])

    recs = read_jsonl(path)
    for r in recs:
        want = {"span": SPAN_FIELDS, "counter": COUNTER_FIELDS,
                "event": EVENT_FIELDS, "hist": HIST_FIELDS}[r["kind"]]
        assert tuple(r.keys()) == want
    assert any(r["kind"] == "hist" and r["name"].startswith("op.latency.")
               for r in recs)
    by_name = {}
    for r in recs:
        if r["kind"] == "span":
            agg = by_name.setdefault(r["name"], [0, 0.0])
            agg[0] += 1
            agg[1] += r["dur_s"]
    for name, v in tel["spans"].items():
        assert by_name[name][0] == v["count"], name
        assert by_name[name][1] == pytest.approx(v["total_s"]), name
    assert "phase:save" in by_name

    assert tel["counters"].get("engine.cpu-oracle", 0) >= 1
    assert {"independent.split", "oracle.dfs"} <= set(tel["spans"])
    file_counters = {r["name"]: r["value"] for r in recs
                     if r["kind"] == "counter"}
    assert set(file_counters) - set(tel["counters"]) <= \
        {"store.index_rows", "store.index_writes"}
    for name, v in tel["counters"].items():
        assert file_counters[name] == v, name

    assert telemetry.current() is NULL


def test_no_telemetry_opt_out(tmp_path):
    out, _ = run(tmp_path, workload="register", no_telemetry=True)
    assert out["valid?"] is True
    assert not os.path.exists(os.path.join(out["dir"], "telemetry.jsonl"))
    assert "telemetry" not in out["results"]
    with open(os.path.join(out["dir"], "results.json")) as f:
        assert "telemetry" not in json.load(f)


# ---- forced kernel path: the device route's counters ------------------------

def _writes_history():
    ops, t = [], 0
    for i in range(20):
        ops.append({"type": "invoke", "process": 0, "f": "write",
                    "value": [None, i], "time": t})
        ops.append({"type": "ok", "process": 0, "f": "write",
                    "value": [i + 1, i], "time": t + 1})
        t += 2
    return ops


def _forced(pkg, tmp_path, f_max):
    """The forced route's verdict, summary (seconds aside) and the
    dispatch spans' attrs, on package ``pkg``'s recorder."""
    tm = mod(pkg, "runner.telemetry")
    hist = mod(pkg, "core.history")
    op = mod(pkg, "core.op")
    h = hist.History([op.Op(o) for o in _writes_history()])
    path = str(tmp_path / f"{pkg}-{f_max}.jsonl")
    tel = tm.Telemetry(path)
    tm.set_current(tel)
    try:
        if pkg.endswith("_torch"):
            checker = mod(pkg, "checkers.tpu_linearizable") \
                .TPULinearizableChecker(
                    lambda: mod(pkg, "models").VersionedRegister(0, None),
                    cpu_cutoff=None, f_max=f_max, device="cpu")
        else:
            checker = RefTPULinearizableChecker(
                lambda: RefVR(0, None), cpu_cutoff=None, f_max=f_max)
        res = checker.check({}, h)
    finally:
        tm.set_current(None)
        tel.close()
    s = tel.summary()
    disp = [r["attrs"] for r in read_jsonl(path) if r["kind"] == "span"
            and r["name"] == "wgl.check_packed"]
    return as_json(res), s["counters"], \
        {k: v["count"] for k, v in s["spans"].items()
         if k not in PORT_SPANS}, disp, s


def test_forced_kernel_emits_tpu_counters(tmp_path, monkeypatch):
    """``cpu_cutoff=None`` pins the device route. On the port with
    ``device="cpu"`` that is the wave kernel's plain version (the
    reference's Pallas batch, patched open, runs it in interpret mode);
    with ``f_max`` it is the ladder, the route the reference takes on
    its CPU host. Both emit the device path's telemetry (engine
    counter, dispatch count, frontier width, pack and dispatch spans
    with wall times), equal to the reference's."""
    monkeypatch.setattr(ref_wgl, "_run_fused",
                        lambda broken, name, call: call())
    wave = both(lambda pkg: _forced(pkg, tmp_path, None)[:4])
    ladder = both(lambda pkg: _forced(pkg, tmp_path, 32)[:4])
    for (res, counters, spans, disp), engine in ((wave, "mxu-wave"),
                                                 (ladder, "jnp-ladder")):
        assert res["valid?"] is True
        assert counters.get(f"engine.{engine}") == 1
        assert counters.get("wgl.dispatches") == 1
        assert counters.get("wgl.max-frontier", 0) >= 1
        assert spans["wgl.pack"] == 1
        assert spans["wgl.check_packed"] == 1
        assert disp[0]["engine"] == engine
        assert disp[0]["valid"] is True
    assert ladder[1].get("wgl.rungs", 0) >= 1
    assert wave[1].get("mxu.dispatches") == 1
    s = _forced("jepsen_etcd_tpu_torch", tmp_path, 32)[4]
    assert s["spans"]["wgl.check_packed"]["total_s"] > 0


# ---- the port's spans inside the ladder, the split and the DFS --------------

def _info_key(n_ops: int):
    """A register key holding :info ops, packed: the wave kernel cannot
    take it, so it climbs the ladder; its waves grow with ``n_ops``."""
    p = port_wgl.pack_register_history(
        gen_history(random.Random(7), n_procs=4, n_ops=n_ops,
                    info_rate=0.1))
    assert p.I > 0
    return p


def _recorded(tmp_path, fn):
    """``fn()``'s result and every record a fresh recorder took
    meanwhile."""
    path = str(tmp_path / "recorded.jsonl")
    tel = Telemetry(path)
    telemetry.set_current(tel)
    try:
        out = fn()
    finally:
        telemetry.set_current(None)
        tel.close()
    return out, read_jsonl(path)


def _spans(recs, name) -> list:
    return [r for r in recs if r["kind"] == "span" and r["name"] == name]


def test_lone_ladder_spans_nest_in_check_packed(tmp_path):
    """On the CPU a lone ladder check runs its waves eagerly: its
    tables and its eager waves in one span each, inside
    ``wgl.check_packed``, and no graph span."""
    out, recs = _recorded(tmp_path, lambda: port_wgl.check_packed(
        _info_key(40), f_max=32, device="cpu"))
    assert out["engine"] == "jnp-ladder" and out["rungs"] == 1
    [outer] = _spans(recs, "wgl.check_packed")
    for name in ("wgl.tables", "wgl.eager"):
        [sp] = _spans(recs, name)
        assert outer["t0"] <= sp["t0"] <= sp["t1"] <= outer["t1"]
    assert _spans(recs, "wgl.tables")[0]["t1"] <= \
        _spans(recs, "wgl.eager")[0]["t0"]
    assert not _spans(recs, "wgl.graph-capture")
    assert not _spans(recs, "wgl.graph-replay")


@pytest.mark.parametrize("calls", [1, 3])
def test_independent_records_one_split_a_check(tmp_path, calls):
    h = keyed_register_history(n_keys=3, n_ops=20, n_procs=4, faulted=(),
                               corrupted=())
    checker = Independent(LinearizableChecker(
        lambda: VersionedRegister(0, None)))
    outs, recs = _recorded(tmp_path, lambda: [
        checker.check({}, h) for _ in range(calls)])
    assert all(o["valid?"] is True for o in outs)
    assert len(_spans(recs, "independent.split")) == calls
    # each key's check is one DFS
    assert len(_spans(recs, "oracle.dfs")) == 3 * calls


@pytest.mark.parametrize("calls", [1, 3])
def test_check_history_records_one_dfs_a_call(tmp_path, calls):
    h = gen_history(random.Random(3), n_procs=4, n_ops=30)
    outs, recs = _recorded(tmp_path, lambda: [
        check_history(VersionedRegister(0, None), h)
        for _ in range(calls)] + [
        check_history(VersionedRegister(0, None), [])])
    assert outs[0]["valid?"] is True and outs[-1]["ops"] == 0
    dfs = _spans(recs, "oracle.dfs")
    # the empty history has nothing to search, and no span
    assert len(dfs) == calls
    assert all(sp["attrs"] == {"ops": outs[0]["ops"]} for sp in dfs)


def test_collect_records_the_wait_for_the_wave_kernel(tmp_path):
    """B1's CPU route: one launch, then one ``mxu.collect`` over the
    chunks it launched."""
    packs = [port_wgl.pack_register_history(
        gen_history(random.Random(s), n_procs=4, n_ops=20))
        for s in (1, 2)]
    outs, recs = _recorded(tmp_path, lambda: wgl_mxu.check_packed_batch_mxu(
        packs, device="cpu"))
    assert [o["engine"] for o in outs] == ["mxu-wave", "mxu-wave"]
    [launch] = _spans(recs, "mxu.launch")
    [collect] = _spans(recs, "mxu.collect")
    assert collect["attrs"] == {"chunks": launch["attrs"]["chunks"]}
    assert launch["t1"] <= collect["t0"]


def test_ladder_records_do_not_grow_with_waves(tmp_path):
    """Two keys of different length, one rung each: the same records
    (spans, counters, histogram samples), whatever the waves."""
    def records(n_ops):
        out, recs = _recorded(tmp_path, lambda: port_wgl.check_packed(
            _info_key(n_ops), f_max=32, device="cpu"))
        return out, sorted((r["kind"], r["name"], r.get("count"))
                           for r in recs)

    (short, a), (long, b) = records(40), records(80)
    assert short["rungs"] == long["rungs"] == 1
    assert long["waves"] > 2 * short["waves"]
    assert a == b


# ---- bench cells share the run span schema ----------------------------------

def test_bench_cell_schema_equals_run_schema(tmp_path):
    """The reference benchmark's cell span (``bench._run_cell``),
    recorded by the port's recorder, has the run schema and the record
    the reference's recorder writes."""
    import bench

    def cell(pkg):
        path = str(tmp_path / f"bench-{pkg}.jsonl")
        tel = mod(pkg, "runner.telemetry").Telemetry(path,
                                                     clock=FakeClock())
        out = bench._run_cell(tel, "demo", lambda: {"ok": True, "n": 3,
                                                    "skip": [1, 2]})
        tel.close()
        assert out["ok"] is True
        return read_jsonl(path)[0]

    rec = both(cell)
    assert rec["kind"] == "span" and rec["name"] == "cell:demo"
    assert rec["attrs"] == {"ok": True, "n": 3}

    run_path = str(tmp_path / "run.jsonl")
    tel2 = Telemetry(run_path, clock=FakeClock())
    with tel2.span("phase:check", ops=1):
        pass
    tel2.close()
    run_rec = read_jsonl(run_path)[0]
    assert tuple(rec.keys()) == tuple(run_rec.keys()) == SPAN_FIELDS \
        == ref_telemetry.SPAN_FIELDS
