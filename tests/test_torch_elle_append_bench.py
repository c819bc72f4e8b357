"""The benchmark's ``elle_append`` deployment on the CPU: the entry
(``benchmark/entries/append.py``, the append workload's own checker on
a column-backed ``History``) held to the plain reference
(``benchmark/reference/append.py``) on the cell's generator
(``benchmark/traffic/append_pool.py``), the control, the generator's
shares at the cell's size, the Elle spans and the closure's roofline
count."""

import collections
import json
import os
import random

import pytest

from benchmark.entries import append as entry_mod
from benchmark.lib import spec
from benchmark.lib.context import Checked, Context
from benchmark.lib.trace import DeviceTrace
from benchmark.metrics import closure_roofline
from benchmark.reference import append as ref
from benchmark.traffic import append_pool
from jepsen_etcd_tpu_torch.ops import closure
from jepsen_etcd_tpu_torch.runner import telemetry

from test_torch_fixtures import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "elle_append.clean"


def history(txns: int, seed: int, plant=None, staleness=1,
            info_rate=0.01) -> append_pool.PoolHistory:
    ops = append_pool.gen_append_history(
        random.Random(seed), txns=txns, info_rate=info_rate, plant=plant,
        staleness=staleness, plant_rng=random.Random(seed + 1))
    return append_pool.PoolHistory("corrupt" if plant else "clean", seed,
                                   ops)


def checked(entry, ph) -> tuple:
    out = entry.check(entry.history([ph], 0))
    return out, entry.summarize(out, [ph], 0)


@pytest.mark.parametrize("plant", [None, "G1c", "G-single-realtime",
                                   "G1a"])
@pytest.mark.parametrize("txns", [300, 900])
def test_entry_agrees_with_the_reference(txns, plant):
    """Below the closure's CPU_CUTOFF (~270 committed txns: the host's
    numpy squaring) and above it (~810: the device route, float32 on
    the CPU), every compared number reads 0."""
    entry = entry_mod.Entry({"nodes": 5, "concurrency": 10},
                            device="cpu")
    ph = history(txns, 40 + txns, plant, info_rate=0.04)
    out, got = checked(entry, ph)
    g = ref.Graph(ph.ops)
    exp = g.verdict()
    wrong, unknown = ref.compare(got, exp, g)
    assert unknown == 0 and wrong == dict.fromkeys(ref.LIMITS, 0)
    assert (exp["committed-count"] >= closure.CPU_CUTOFF) is (txns == 900)
    if plant is None:
        assert got["valid?"] is True and not got["certificates"]
    else:
        assert got["valid?"] is False and plant in got["anomaly-types"]
    if plant in ("G1c", "G-single-realtime"):
        assert any(c["type"] == plant for c in got["certificates"])
    # some :info txn's append was observed, so it counts as committed
    assert any(t.status == "info" for t in g.committed)


def test_the_reference_refuses_a_wrong_certificate():
    entry = entry_mod.Entry({"nodes": 5, "concurrency": 10},
                            device="cpu")
    ph = history(300, 7, "G-single-realtime")
    _, got = checked(entry, ph)
    g = ref.Graph(ph.ops)
    cert = next(c for c in got["certificates"]
                if c["type"] == "G-single-realtime")
    assert g.certificate_ok(cert)
    relabelled = dict(cert, type="G-single")
    assert not g.certificate_ok(relabelled)
    retyped = dict(cert, steps=[dict(s, type="ww") for s in cert["steps"]])
    assert not g.certificate_ok(retyped)
    wrong, _ = ref.compare(dict(got, certificates=[relabelled]),
                           g.verdict(), g)
    assert wrong["certificates"] == 1


def small_cell(txns: int = 300):
    cell = spec.load(ROOT, CELL)
    cell.spec["params"].update(txns=txns)
    return cell


def test_the_control_reads_not_correct():
    """The reference without wr edges, judged as a run judges the
    system: the corrupted histories' G1c goes unseen."""
    cell = small_cell()
    reference = cell.module("reference")
    traffic = cell.traffic(2 ** 31 + 99)
    memo: dict = {}
    runs = [Checked(keys, 0.0, 0.0, 0.0, reference.control(keys, memo),
                    None)
            for keys in (traffic.history(i) for i in range(16))]
    wrong, failed = reference.judge(runs)
    assert failed == 0
    assert wrong["valid"] == 2 and wrong["types"] == 2
    assert not all(wrong[n] <= lim for n, lim in reference.LIMITS.items())


def test_the_cells_files():
    cell = spec.load(ROOT, CELL)
    assert cell.config["txns"] == 12_000 and cell.config["reduced"] == []
    assert cell.config["concurrency"] == 10
    assert cell.config["consistency_models"] == ["strict-serializable"]
    assert cell.chips == 1 and cell.spec["profile_seconds"] == 20
    names = {m["name"] for m, _ in cell.per_layer}
    assert {"elle_collect_ms", "elle_graph_ms", "closure_ms",
            "closure_roofline", "elle_certificates_ms",
            "device_idle_share"} <= names
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for m in bench["per_layer"]:
        if m["name"].startswith(("elle_", "closure_")):
            assert m["workloads"] == [CELL]


def test_generator_shares_at_the_cells_size():
    params = {**spec.load(ROOT, CELL).config,
              **spec.load(ROOT, CELL).spec["params"]}
    ops = append_pool.history_of(params, 2 ** 31 + 5, "clean", 0).ops
    again = append_pool.history_of(params, 2 ** 31 + 5, "clean", 0).ops
    assert json.dumps(ops) == json.dumps(again)
    invokes = [o for o in ops if o["type"] == "invoke"]
    done = [o for o in ops if o["type"] != "invoke"]
    assert len(invokes) == len(done) == 12_000 and len(ops) == 24_000
    by = collections.Counter(o["type"] for o in done)
    holding = [o for o in done
               if any(m[0] == "append" for m in o["value"])]
    fails = sum(o["type"] == "fail" for o in holding)
    assert 0.085 <= fails / len(holding) <= 0.11
    assert 0.0075 <= by["info"] / 12_000 <= 0.0125
    assert all(o["error"] == "didnt-succeed" for o in done
               if o["type"] == "fail")
    # 10 processes, each going on as process + 10 after an :info
    procs = {o["process"] for o in invokes}
    assert 10 <= len(procs) <= 10 + by["info"]
    last = {}
    for o in ops:
        t = o["process"] % 10
        if o["type"] == "invoke" and t in last:
            assert o["process"] == last[t]
        elif o["type"] != "invoke":
            last[t] = o["process"] + (10 if o["type"] == "info" else 0)
    appends = collections.defaultdict(list)
    for o in invokes:
        for f, k, v in o["value"]:
            assert 1 <= len(o["value"]) <= 4
            if f == "append":
                appends[k].append(v)
    for k, vs in appends.items():
        assert vs == list(range(1, len(vs) + 1)) and len(vs) <= 32
    assert sum(len(vs) == 32 for vs in appends.values()) >= \
        len(appends) - 3
    g = ref.Graph(ops)
    assert 10_700 <= g.n <= 11_300 and g.verdict()["valid?"] is True
    guard = append_pool.history_of(params, 2 ** 31 + 5, "corrupt", 0).ops
    differ = [i for i, (a, b) in enumerate(zip(ops, guard)) if a != b]
    assert len(guard) == len(ops) and 1 <= len(differ) <= 2


def test_one_span_of_each_a_check():
    entry = entry_mod.Entry({"nodes": 5, "concurrency": 10},
                            device="cpu")
    ph = history(900, 3, "G1c")
    tel = telemetry.Telemetry()
    telemetry.set_thread_current(tel)
    try:
        entry.check(entry.history([ph], 0))
    finally:
        telemetry.set_thread_current(None)
    spans = tel.summary()["spans"]
    tel.close()
    for name in ("elle.collect", "elle.graph", "closure.device",
                 "elle.certificates"):
        assert spans[name]["count"] == 1, name


def test_the_closure_roofline_count():
    assert closure_roofline.least_ops(1000) == 12 * 1000 ** 3
    n = 10_000
    least_s = closure_roofline.least_ops(n) / 1979e12
    h = Checked([[]], 0.0, 10.0, 12.0, {}, None)
    h.exp = {"committed-count": n}
    spans = [("closure.device", 10.1, 11.0), ("elle.graph", 10.0, 10.1)]
    # two operations inside the closure's span, one outside it
    ops = [("bmm", 10.2, 10.2 + 2 * least_s),
           ("gt", 10.5, 10.5 + 2 * least_s),
           ("other", 11.5, 11.9)]
    ctx = Context(1.0, 5.0, [h], spans=spans,
                  device=DeviceTrace(ops, 9.0, 13.0))
    assert closure_roofline.read(ctx) == pytest.approx(25.0)
    bare = Context(1.0, 5.0, [h], spans=spans[1:],
                   device=DeviceTrace(ops, 9.0, 13.0))
    assert closure_roofline.read(bare) is None
