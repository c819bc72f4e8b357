"""The port's lock and MVCC workloads (``workloads/lock.py``,
``workloads/mvcc.py``, ``core/mvcc.py``, ``checkers/mvcc.py``), its
thirteen-name registry and ``test-all``'s matrix against the
reference's, on the shapes of tests/test_lock.py and tests/test_mvcc.py.

The port runs on ``device="cpu"``. The lock workload's check reaches
the wave kernel's plain version through the Mutex adapter when
``force_kernel`` pins it (the reference's Pallas kernel runs in
interpret mode for the comparison). Each MVCC injection hook of the
batched generator flips its checker to ``valid? False`` with exactly
its class. Tolerance 0: dicts are equal once the wall-clock fields are
dropped.
"""

import contextlib
import io
import json

import pytest

from jepsen_etcd_tpu import cli as ref_cli
from jepsen_etcd_tpu import compose as ref_compose
from jepsen_etcd_tpu.checkers.linearizable import \
    check_history as ref_check_history
from jepsen_etcd_tpu.checkers.tpu_linearizable import \
    TPULinearizableChecker as RefTPULinearizableChecker
from jepsen_etcd_tpu.core.history import History as RefHistory
from jepsen_etcd_tpu.core.op import Op as RefOp
from jepsen_etcd_tpu.models import Mutex as RefMutex
from jepsen_etcd_tpu.ops import wgl as ref_wgl
from jepsen_etcd_tpu.runner import test_runner as ref_runner
from jepsen_etcd_tpu.runner.shrink import \
    checker_opts_from as ref_checker_opts_from
from jepsen_etcd_tpu.simbatch import BatchConfig as RefBatchConfig
from jepsen_etcd_tpu.simbatch import generate as ref_generate
from jepsen_etcd_tpu.workloads import ALL_WORKLOADS as REF_ALL
from jepsen_etcd_tpu.workloads import WORKLOADS_EXPECTED_TO_PASS as REF_PASS
from jepsen_etcd_tpu.workloads import workloads as ref_workloads
from jepsen_etcd_tpu_torch import cli, compose
from jepsen_etcd_tpu_torch.checkers.linearizable import check_history
from jepsen_etcd_tpu_torch.core.history import History
from jepsen_etcd_tpu_torch.core.op import Op
from jepsen_etcd_tpu_torch.models import Mutex
from jepsen_etcd_tpu_torch.runner import test_runner
from jepsen_etcd_tpu_torch.runner.shrink import checker_opts_from
from jepsen_etcd_tpu_torch.simbatch import BatchConfig, generate
from jepsen_etcd_tpu_torch.workloads import (ALL_WORKLOADS,
                                             WORKLOADS_EXPECTED_TO_PASS,
                                             workloads)
from jepsen_etcd_tpu_torch.workloads.lock import _is_not_held

from test_torch_fixtures import one_torch_thread  # noqa: F401

#: result fields that read the host's wall clock or name a file
SKIP_FIELDS = ("telemetry", "timeline")


def as_json(x):
    return json.loads(json.dumps(x, default=repr, sort_keys=True))


def comparable(out) -> dict:
    return as_json({k: v for k, v in out["results"].items()
                    if k not in SKIP_FIELDS})


def run_both(tmp_path, **opts):
    port = test_runner.run_test(compose.etcd_test(
        dict(opts, device="cpu", store_base=str(tmp_path / "p"))))
    ref = ref_runner.run_test(ref_compose.etcd_test(
        dict(opts, store_base=str(tmp_path / "r"))))
    assert port["history"].to_jsonl() == ref["history"].to_jsonl()
    assert comparable(port) == comparable(ref)
    return port, ref


def both(ops):
    return (History([Op(dict(o)) for o in ops]),
            RefHistory([RefOp(dict(o)) for o in ops]))


# -- tests/test_lock.py ------------------------------------------------------


DOUBLE_ACQUIRE = [
    {"type": "invoke", "process": 0, "f": "acquire", "value": None},
    {"type": "ok", "process": 0, "f": "acquire", "value": None},
    {"type": "invoke", "process": 1, "f": "acquire", "value": None},
    {"type": "ok", "process": 1, "f": "acquire", "value": None}]
HANDOFF = [
    {"type": "invoke", "process": 0, "f": "acquire", "value": None},
    {"type": "ok", "process": 0, "f": "acquire", "value": None},
    {"type": "invoke", "process": 0, "f": "release", "value": None},
    {"type": "ok", "process": 0, "f": "release", "value": None},
    {"type": "invoke", "process": 1, "f": "acquire", "value": None},
    {"type": "ok", "process": 1, "f": "acquire", "value": None}]


@pytest.mark.parametrize("ops,valid", [(DOUBLE_ACQUIRE, False),
                                       (HANDOFF, True)],
                         ids=["double-acquire", "handoff"])
def test_mutex_model_dicts_equal_the_references(ops, valid):
    h, rh = both(ops)
    got = check_history(Mutex(), h)
    assert as_json(got) == as_json(ref_check_history(RefMutex(), rh))
    assert got["valid?"] is valid


def test_is_not_held_shapes():
    assert _is_not_held("not-held")
    assert _is_not_held(["not-held", "not-held: k"])
    assert not _is_not_held(["timeout", "x"])
    assert not _is_not_held(None)


LOCK_BASE = {"time_limit": 10, "rate": 5, "seed": 17}


@pytest.mark.parametrize("workload,key,time_limit", [
    ("lock", "linear", 10), ("lock-set", "set", 12),
    ("lock-etcd-set", "set", 12)])
def test_lock_workloads_healthy_equal_the_references(tmp_path, workload,
                                                     key, time_limit):
    """tests/test_lock.py:51-70: without faults the lock workloads
    pass, with the reference's history bytes and dicts."""
    port, _ = run_both(tmp_path, **dict(LOCK_BASE, workload=workload,
                                        time_limit=time_limit))
    wl = port["results"]["workload"]
    assert wl[key]["valid?"] is True, wl[key]
    if workload == "lock":
        stats = port["results"]["stats"]["by-f"]
        assert stats["acquire"]["ok"] > 0 and stats["release"]["ok"] > 0


def test_lock_b1_verdict_equals_the_references(tmp_path, monkeypatch):
    """``force_kernel``: the lock history's Mutex pack goes to the wave
    kernel's plain version (engine ``mxu-wave``); its dict equals the
    reference's kernel-pinned checker (Pallas in interpret mode) on the
    same history, and its verdict the Python DFS's."""
    from jepsen_etcd_tpu_torch.ops import wgl
    monkeypatch.setattr(ref_wgl, "_run_fused",
                        lambda broken, name, call: call())
    launches = []
    orig = wgl.check_packed

    def counting(p, *a, **kw):
        launches.append(p.R)
        return orig(p, *a, **kw)
    monkeypatch.setattr(wgl, "check_packed", counting)
    opts = dict(LOCK_BASE, workload="lock", force_kernel=True, rate=20)
    port = test_runner.run_test(compose.etcd_test(
        dict(opts, device="cpu", store_base=str(tmp_path))))
    got = port["results"]["workload"]["linear"]
    assert got["engine"] == "mxu-wave" and len(launches) == 1
    h = port["history"]
    rh = RefHistory([RefOp(dict(o)) for o in h.ops])
    want = RefTPULinearizableChecker(RefMutex, cpu_cutoff=None).check(
        {}, rh)
    assert as_json(got) == as_json(want)
    assert got["valid?"] is check_history(Mutex(False), h)["valid?"] \
        is True
    # without force_kernel the lock workload routes by size, as the
    # reference's does
    routed = workloads()["lock"]({"device": "cpu"})["checker"]
    assert routed.checkers["linear"].cpu_cutoff is not None


# -- tests/test_mvcc.py ------------------------------------------------------


SURFACE_KEYS = {"register-stale": "staleness", "ranges": "ranges",
                "lock-lease": "lease", "compact-watch": "watch-mvcc"}

INJECTIONS = {
    "register-stale": ("inject_stale_snapshot", "stale-beyond-bound"),
    "ranges": ("inject_torn_range", "torn-range"),
    "lock-lease": ("inject_double_grant", "double-grant"),
    "compact-watch": ("inject_compaction_swallow", "lost-event"),
}


def _v2_opts(wl: str, **kw) -> dict:
    o = {"workload": wl, "nodes": ["n1", "n2", "n3"], "concurrency": 8,
         "rate": 200.0, "time_limit": 2.0, "gen_epoch": "epoch-v2"}
    if wl == "register-stale":
        o["staleness_bound_s"] = 0.5
    o.update(kw)
    return o


def _v2_verdicts(opts: dict, seeds, port=True) -> list:
    """Batched generation and the composed workload checker, as the
    reference's tests/test_mvcc.py:47-55 evaluates them."""
    if port:
        cfg = BatchConfig.from_opts(opts)
        copts = checker_opts_from(opts)
        checker = workloads()[cfg.workload](
            dict(copts, device="cpu"))["checker"]
        g = generate(cfg, list(seeds))
    else:
        cfg = RefBatchConfig.from_opts(opts)
        copts = ref_checker_opts_from(opts)
        checker = ref_workloads()[cfg.workload](dict(copts))["checker"]
        g = ref_generate(cfg, list(seeds))
    return [checker.check(dict(copts), h) for h in g["histories"]]


def _surface_verdict(sub: dict) -> tuple:
    classes = sorted({v["class"] for v in sub.get("violations", ())})
    return sub["valid?"], tuple(classes)


@pytest.mark.parametrize("wl", sorted(SURFACE_KEYS))
def test_injected_bug_trips_exactly_its_class(wl):
    """Flag off: 8 seeds pass. Flag on: every seed fails with the
    pinned class alone. Each dict equals the reference's."""
    flag, klass = INJECTIONS[wl]
    key = SURFACE_KEYS[wl]
    seeds = range(8)
    clean = _v2_verdicts(_v2_opts(wl), seeds)
    assert as_json(clean) == as_json(
        _v2_verdicts(_v2_opts(wl), seeds, port=False))
    for r in clean:
        assert r["valid?"] is True, (wl, r[key])
    hit = _v2_verdicts(_v2_opts(wl, **{flag: True}), seeds)
    assert as_json(hit) == as_json(
        _v2_verdicts(_v2_opts(wl, **{flag: True}), seeds, port=False))
    for r in hit:
        assert r["valid?"] is False and r[key]["valid?"] is False
        assert {v["class"] for v in r[key]["violations"]} == {klass}


def test_injections_are_isolated_per_surface():
    for r in _v2_verdicts(_v2_opts("register-stale",
                                   inject_torn_range=True), range(4)):
        assert r["valid?"] is True, r["staleness"]
    for r in _v2_verdicts(_v2_opts("ranges",
                                   inject_stale_snapshot=True), range(4)):
        assert r["valid?"] is True, r["ranges"]


_V1_BASE = {"nodes": ["n1", "n2", "n3"], "concurrency": 6,
            "time_limit": 12, "rate": 100.0, "nemesis_interval": 3,
            "seed": 5}

CELLS = [("register-stale", ()), ("ranges", ("kill",)),
         ("lock-lease", ("partition",)), ("compact-watch", ())]


@pytest.mark.parametrize("wl,nem", CELLS)
def test_cross_epoch_verdict_equality(tmp_path, wl, nem):
    """tests/test_mvcc.py:128-131: the epoch-v1 run (equal to the
    reference's, bytes and dicts) and the epoch-v2 history of the same
    cell give the same surface verdict, and it passes."""
    key = SURFACE_KEYS[wl]
    base = dict(_V1_BASE, workload=wl, nemesis=list(nem))
    port, _ = run_both(tmp_path, **base)
    v1 = port["results"]["workload"][key]
    v2 = _v2_verdicts(dict(base, gen_epoch="epoch-v2"),
                      [base["seed"]])[0][key]
    assert _surface_verdict(v1) == _surface_verdict(v2), (wl, nem)
    assert v1["valid?"] is True


def _lease_cols(rows):
    import numpy as np
    from jepsen_etcd_tpu_torch.core.history import OpColumns
    ft = ["acquire", "release"]
    n = len(rows)
    return OpColumns(
        np.array([r[0] for r in rows], np.int8),
        np.array([ft.index(r[2]) for r in rows], np.int32),
        np.array([r[1] for r in rows], np.int64),
        np.zeros(n, np.int64),
        np.array([r[3] for r in rows], np.int64),
        np.arange(n), [None] * n, {}, {}, ft, ["k"], [])


def test_lease_sessions_assert_proc_is_session():
    from jepsen_etcd_tpu.core.mvcc import _lease_sessions as ref_sessions
    from jepsen_etcd_tpu_torch.core.mvcc import _lease_sessions
    ok = _lease_cols([(0, 0, "acquire", 1), (1, 0, "acquire", 2),
                      (0, 0, "release", 3), (0, 0, "acquire", 4),
                      (1, 0, "acquire", 5)])
    sess = _lease_sessions(ok)
    assert sess == ref_sessions(ok)
    assert [s[1] for s in sess] == [0, 0]
    assert sess[0][4] == 3 and sess[1][4] is None
    bad = _lease_cols([(0, 0, "acquire", 1), (1, 0, "acquire", 2),
                       (0, 0, "acquire", 3), (1, 0, "acquire", 4)])
    with pytest.raises(ValueError, match="proc==session"):
        _lease_sessions(bad)


def test_mvcc_constants_equal_the_references():
    from jepsen_etcd_tpu.checkers import mvcc as ref_mvcc
    from jepsen_etcd_tpu.core import mvcc as ref_core
    from jepsen_etcd_tpu.workloads import mvcc as ref_wl
    from jepsen_etcd_tpu_torch.checkers import mvcc
    from jepsen_etcd_tpu_torch.core import mvcc as core
    from jepsen_etcd_tpu_torch.workloads import mvcc as wl
    assert mvcc.DEFAULT_LEASE_TTL_MS == ref_mvcc.DEFAULT_LEASE_TTL_MS
    assert mvcc.DEFAULT_STALENESS_BOUND_S == \
        ref_mvcc.DEFAULT_STALENESS_BOUND_S
    assert core.T_INF == ref_core.T_INF
    assert wl.DEFAULT_COMPACT_KEEP == ref_wl.DEFAULT_COMPACT_KEEP


# -- the registry, test-all and the options ----------------------------------


def test_registry_equals_the_references():
    assert sorted(workloads()) == sorted(ref_workloads()) and \
        len(workloads()) == 13
    assert ALL_WORKLOADS == REF_ALL
    assert WORKLOADS_EXPECTED_TO_PASS == REF_PASS


def _printed(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    rows = []
    for ln in buf.getvalue().splitlines():
        if ln.startswith("{"):
            row = json.loads(ln)
            rows.append({k: v for k, v in row.items()
                         if k not in ("wall-seconds", "dir")})
    return rc, rows


def test_test_all_matrix_equals_the_references(tmp_path):
    """``test-all`` over the twelve workloads (one nemesis combination,
    a small time limit): the same runs, verdicts, failure tally and
    exit code as the reference's; ``lock-etcd-set`` is expected to pass
    and its ``unknown`` counts as a failure in both."""
    argv = ["test-all", "--nemesis", "kill", "--time-limit", "2", "-r",
            "50", "--nodes", "n1,n2,n3"]
    rc, rows = _printed(cli.main, argv + ["--store", str(tmp_path / "p"),
                                          "--device", "cpu"])
    ref_rc, ref_rows = _printed(ref_cli.main,
                                argv + ["--store", str(tmp_path / "r")])
    assert (rc, rows) == (ref_rc, ref_rows)
    assert [r["test"] for r in rows[:-1]] == \
        [f"etcd-{w}-kill" for w in REF_ALL]
    assert "failures" in rows[-1]


@pytest.mark.parametrize("key,value", [
    ("stream", True), ("inject_stale_snapshot", True),
    ("inject_torn_range", True), ("inject_double_grant", True),
    ("inject_compaction_swallow", True), ("staleness_bound_s", 2.0),
    ("lease_ttl_ms", 500), ("compact_keep", 2),
])
def test_stream_and_mvcc_options_compose(key, value):
    """The options of this slice compose and are carried into the test
    map, as in the reference (they raised before the machinery was
    there)."""
    test = compose.etcd_test({key: value, "device": "cpu",
                              "workload": "register-stale"})
    want = ref_compose.etcd_test({key: value,
                                  "workload": "register-stale"})
    assert test[key] == want[key] == value


def test_mvcc_and_stream_flags_parse_to_the_references():
    argv = ["test", "-w", "lock-lease", "--stream", "--stream-chunk-ops",
            "7", "--staleness-bound-s", "2.5", "--lease-ttl-ms", "500",
            "--compact-keep", "3"]
    got = cli.opts_from_args(cli.build_parser().parse_args(argv))
    want = ref_cli.opts_from_args(ref_cli.build_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want
    assert (got["stream"], got["stream_chunk_ops"], got["lease_ttl_ms"]) \
        == (True, 7, 500.0)


@pytest.mark.parametrize("workload", sorted(set(REF_ALL) | {"none"}))
def test_every_reference_name_runs_on_the_cli(tmp_path, workload):
    """``python -m jepsen_etcd_tpu_torch test -w <name>`` accepts every
    name of the reference's registry."""
    rc, rows = _printed(cli.main, [
        "test", "-w", workload, "--time-limit", "1", "-r", "20",
        "--nodes", "n1,n2,n3", "--store", str(tmp_path), "--device",
        "cpu"])
    assert rows and rows[0]["test"] == f"etcd-{workload}"
    assert rc == (0 if rows[0]["valid?"] is True else 1)
