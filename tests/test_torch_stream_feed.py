"""The port's streaming check feed (``runner/stream.py`` ``StreamFeed``,
the interpreter's ``stream`` hook, ``run_test``'s ``_make_stream`` /
``_finish_stream``, and the reuse of its hints by ``Independent`` /
``check_batch`` and ``SetFull``) against the reference's.

The contract is the reference's (tests/test_stream.py,
tests/test_columns_equiv.py): hints only, so a streamed verdict is
bit-identical to the post-hoc one at every chunk size; a consumer that
cannot take the stream, fails, or saw fewer rows than the history
withdraws its hint and the checker recomputes from scratch. The port
runs on ``device="cpu"`` (its kernels' plain versions). Tolerance 0:
dicts compare as JSON once the wall-clock fields are dropped, packs
field by field.
"""

import dataclasses
import json

import numpy as np
import pytest

from jepsen_etcd_tpu import compose as ref_compose
from jepsen_etcd_tpu.checkers.core import Noop as RefNoop
from jepsen_etcd_tpu.core.history import ColumnsBuilder as RefBuilder
from jepsen_etcd_tpu.core.op import Op as RefOp
from jepsen_etcd_tpu.ops import wgl as ref_wgl
from jepsen_etcd_tpu.runner import stream as ref_stream
from jepsen_etcd_tpu.runner import test_runner as ref_runner
from jepsen_etcd_tpu_torch import cli, compose
from jepsen_etcd_tpu_torch.checkers.core import Noop
from jepsen_etcd_tpu_torch.core.history import ColumnsBuilder, History
from jepsen_etcd_tpu_torch.core.op import Op
from jepsen_etcd_tpu_torch.ops import wgl
from jepsen_etcd_tpu_torch.runner import stream, test_runner
from jepsen_etcd_tpu_torch.runner.stream import StreamFeed

from test_torch_fixtures import one_torch_thread  # noqa: F401

#: the reference's fuzz configs (tests/test_columns_equiv.py:31-37)
CONFIGS = {
    "register-nemesis": dict(workload="register",
                             nodes=["n1", "n2", "n3"],
                             time_limit=5, rate=200, seed=11,
                             nemesis=["kill", "partition"],
                             nemesis_interval=2),
    "set-nemesis": dict(workload="set", time_limit=4, rate=200, seed=19,
                        nemesis=["pause", "clock"], nemesis_interval=2),
}

#: chunk sizes swept (tests/test_columns_equiv.py:84); None = the whole
#: history in one flush
CHUNK_SIZES = (1, 64, 4096, None)

HINT_KEY = {"register-nemesis": "register_packs",
            "set-nemesis": "set_scan"}

#: result fields that read the host's wall clock
WALL_CLOCK_FIELDS = ("telemetry",)


def _strip(result) -> str:
    return json.dumps(result, sort_keys=True, default=repr)


def _record(store, name, port=True):
    """One run of the config with a Noop checker; returns (test,
    composed checker, history)."""
    cfg = dict(CONFIGS[name], store_base=str(store), no_telemetry=True)
    if port:
        test = compose.etcd_test(dict(cfg, device="cpu"))
        checker, test["checker"] = test["checker"], Noop()
        return test, checker, test_runner.run_test(test)["history"]
    test = ref_compose.etcd_test(cfg)
    checker, test["checker"] = test["checker"], RefNoop()
    return test, checker, ref_runner.run_test(test)["history"]


def _replay(feed_cls, builder_cls, test, h, chunk_ops):
    """Re-feed the recorded op stream through a fresh builder and feed
    at ``chunk_ops``: the column stream the interpreter produced."""
    carrier = {"workload": test.get("workload")}
    feed = feed_cls(carrier, chunk_ops=chunk_ops or (len(h) + 1))
    b = builder_cls()
    feed.attach(b)
    for op in h.ops:
        b.append(op)
        feed.on_record()
    hints = feed.finish(h)
    assert feed.error is None
    assert hints["stats"]["rows"] == len(h)
    if chunk_ops == 1:
        assert hints["stats"]["chunks"] == len(h)
    elif chunk_ops is None:
        assert hints["stats"]["chunks"] == 1
    assert carrier["_stream"] is hints
    return hints


def _same(a, b, path="artifact"):
    """Deep equality over hint artifacts of either package: dicts,
    tuples, numpy arrays, dataclasses compared field by field (the two
    packages' classes differ by module, not by fields)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(a, b), path
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for fld in dataclasses.fields(type(a)):
            _same(getattr(a, fld.name), getattr(b, fld.name),
                  f"{path}.{fld.name}")
    else:
        assert a == b, (path, a, b)


def _op(i, type, process, f, value, cls=Op):
    return cls(dict(type=type, process=process, f=f, value=value,
                    time=i * 10, index=i))


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """Each config recorded once by each package."""
    done = {}

    def get(name):
        if name not in done:
            done[name] = (
                _record(tmp_path_factory.mktemp("port"), name, True),
                _record(tmp_path_factory.mktemp("ref"), name, False))
        return done[name]
    return get


# -- the feed's shapes (tests/test_stream.py:284-325; take_chunk's own,
# :250-282, are tests/test_torch_stream.py's) -------------------------------


@pytest.mark.parametrize("side", ["port", "reference"])
def test_stream_feed_withdraws_hint_on_undelegatable_stream(side):
    """A register stream the columnar packer cannot express (a non-int
    payload) drops the register_packs hint: stats stay, no error."""
    feed_cls, builder_cls, op_cls = (
        (StreamFeed, ColumnsBuilder, Op) if side == "port" else
        (ref_stream.StreamFeed, RefBuilder, RefOp))
    ops = [_op(0, "invoke", 0, "write", (0, [None, "s"]), op_cls),
           _op(1, "ok", 0, "write", (0, [1, "s"]), op_cls)]
    h = History([Op(dict(o)) for o in ops])
    carrier = {"workload": "register"}
    feed = feed_cls(carrier, chunk_ops=1)
    b = builder_cls()
    feed.attach(b)
    for op in ops:
        b.append(op)
        feed.on_record()
    hints = feed.finish(h)
    assert feed.error is None
    assert hints == {"stats": {"chunks": 2, "rows": 2, "backlog_peak":
                               hints["stats"]["backlog_peak"],
                               "chunk_ops": 1}}
    assert carrier["_stream"] is hints


def test_stream_feed_short_feed_withdraws_artifacts():
    """Hints must cover the WHOLE history: a feed that saw fewer rows
    than the final history installs stats only, in both packages."""
    ops = [(0, "invoke", 0, "write", (0, [None, 1])),
           (1, "ok", 0, "write", (0, [1, 1]))]
    extra = (2, "invoke", 1, "read", (0, [None, None]))
    got = []
    for feed_cls, builder_cls, op_cls in (
            (StreamFeed, ColumnsBuilder, Op),
            (ref_stream.StreamFeed, RefBuilder, RefOp)):
        longer = History([_op(*o) for o in ops + [extra]])
        feed = feed_cls({"workload": "register"}, chunk_ops=1)
        b = builder_cls()
        feed.attach(b)
        for o in ops:
            b.append(_op(*o, cls=op_cls))
            feed.on_record()
        hints = feed.finish(longer)
        assert hints["stats"]["rows"] == 2
        assert "register_packs" not in hints
        got.append(sorted(hints))
    assert got[0] == got[1] == ["stats"]


def test_consumer_failure_withdraws_hints_and_the_check_recomputes(
        recorded, monkeypatch):
    """A host consumer that fails mid-stream withdraws its hint (the
    reference's stream.py:132-148): the error is kept, no artifact is
    installed, and the checker, packing from scratch, gives the
    post-hoc verdict."""
    (test, checker, h), _ = recorded("register-nemesis")

    def boom(self, cols):
        raise RuntimeError("consumer boom")
    monkeypatch.setattr(wgl.PackStream, "feed", boom)
    feed = StreamFeed({"workload": "register"}, chunk_ops=64)
    b = ColumnsBuilder()
    feed.attach(b)
    for op in h.ops:
        b.append(op)
        feed.on_record()
    hints = feed.finish(h)
    assert isinstance(feed.error, RuntimeError)
    assert sorted(hints) == ["stats"]
    monkeypatch.undo()
    test.pop("_stream", None)
    posthoc = _strip(checker.check(test, h))
    test["_stream"] = hints
    try:
        assert _strip(checker.check(test, h)) == posthoc
    finally:
        test.pop("_stream", None)


def test_wedged_worker_past_the_join_bound_withdraws(monkeypatch):
    """A worker that does not drain within JOIN_TIMEOUT_S is abandoned:
    finish() publishes stats only and the late worker installs
    nothing."""
    import threading
    release = threading.Event()
    monkeypatch.setattr(stream, "JOIN_TIMEOUT_S", 0.05)
    orig = wgl.PackStream.feed

    def slow(self, cols):
        release.wait(10)
        return orig(self, cols)
    monkeypatch.setattr(wgl.PackStream, "feed", slow)
    ops = [_op(0, "invoke", 0, "write", (0, [None, 1])),
           _op(1, "ok", 0, "write", (0, [1, 1]))]
    feed = StreamFeed({"workload": "register"}, chunk_ops=1)
    b = ColumnsBuilder()
    feed.attach(b)
    for op in ops:
        b.append(op)
        feed.on_record()
    hints = feed.finish(History(ops))
    release.set()
    feed._thread.join(10)
    assert not feed._thread.is_alive()
    assert sorted(hints) == ["stats"] and feed._abandoned
    assert feed._pack_result is None


def test_feeds_under_thread_pressure_lose_no_rows(recorded):
    """Twelve feeds, each with its worker, replayed from twelve threads
    at once with a short switch interval: every feed consumes every row
    (chunks of 7) and finishes to the one-shot packs."""
    import sys
    import threading
    (_, _, h), _ = recorded("register-nemesis")
    ops = h.ops[:700]
    want = wgl.PackStream()
    want.feed(_columns(ops))
    want = want.finish()
    got, errors = [None] * 12, []

    def one(i):
        try:
            got[i] = _replay(StreamFeed, ColumnsBuilder,
                             {"workload": "register"}, History(ops), 7)
        except BaseException as e:  # reported below, with its index
            errors.append((i, e))
            raise
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    for hints in got:
        assert hints["stats"]["rows"] == len(ops)
        assert hints["stats"]["chunks"] == -(-len(ops) // 7)
        packs, rows = hints["register_packs"]
        assert rows == len(ops)
        _same(dict(sorted(packs.items(), key=repr)),
              dict(sorted(want.items(), key=repr)))


def _columns(ops):
    from jepsen_etcd_tpu_torch.core.history import columns_of
    return columns_of(ops)


def test_feed_constants_equal_the_references():
    assert stream.DEFAULT_CHUNK_OPS == ref_stream.DEFAULT_CHUNK_OPS
    assert stream.JOIN_TIMEOUT_S == ref_stream.JOIN_TIMEOUT_S
    for wl, want in (("register", (True, False)), ("set", (False, True)),
                     ("watch", (False, False))):
        f, rf = StreamFeed({"workload": wl}), ref_stream.StreamFeed(
            {"workload": wl})
        assert (f._want_pack, f._want_scan) == \
            (rf._want_pack, rf._want_scan) == want
        assert f.chunk_ops == rf.chunk_ops


# -- the chunk-size fuzz (tests/test_columns_equiv.py:91-175) -----------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_streaming_verdicts_bit_identical_across_chunk_sizes(recorded, name):
    """At every chunk size the port's streamed verdict equals its
    post-hoc verdict and the reference's, and the artifacts equal one
    another across chunk sizes and the reference feed's."""
    (test, checker, h), (rtest, rchecker, rh) = recorded(name)
    assert h.to_jsonl() == rh.to_jsonl()
    key = HINT_KEY[name]
    test.pop("_stream", None)
    rtest.pop("_stream", None)
    posthoc = _strip(checker.check(test, h))
    assert posthoc == _strip(rchecker.check(rtest, rh))
    artifacts = {}
    for cs in CHUNK_SIZES:
        hints = _replay(StreamFeed, ColumnsBuilder, test, h, cs)
        assert key in hints, (cs, sorted(hints))
        test["_stream"] = hints
        try:
            assert _strip(checker.check(test, h)) == posthoc, cs
        finally:
            test.pop("_stream", None)
        artifacts[cs] = hints[key]
    for cs in CHUNK_SIZES[1:]:
        _same(artifacts[cs], artifacts[CHUNK_SIZES[0]], f"chunk={cs}")
    want = _replay(ref_stream.StreamFeed, RefBuilder, rtest, rh, 64)[key]
    _same(artifacts[64], want, "port vs reference")


def test_streamed_packs_are_the_batched_packers(recorded):
    """The feed's register packs equal the batched packer's over the
    key split, with no dict materialized on the way
    (tests/test_columns_equiv.py:177-221)."""
    from jepsen_etcd_tpu_torch.checkers.core import stream_hint
    (test, _, h), _ = recorded("register-nemesis")
    History.dict_materializations = 0
    ps = wgl.PackStream()
    b = ColumnsBuilder()
    for i, op in enumerate(h.ops, 1):
        b.append(op)
        if i % 256 == 0:
            ps.feed(b.take_chunk())
    ps.feed(b.take_chunk())
    packs = ps.finish()
    assert ps.ok and packs is not None and ps.n_rows == len(h)
    h2 = History.from_columns(h.columns)
    carrier = {"_stream": {"stats": {}, "register_packs": (packs,
                                                           ps.n_rows)}}
    assert stream_hint(carrier, h2, "register_packs") is packs
    assert History.dict_materializations == 0
    want = wgl.pack_register_histories_batched(h2.split_by_key())
    for k in want:
        wgl.ensure_frames(packs[k])
        wgl.ensure_frames(want[k])
    _same(dict(sorted(packs.items(), key=repr)),
          dict(sorted(want.items(), key=repr)))


# -- whole runs ---------------------------------------------------------------


BASE = {"time_limit": 6, "rate": 50, "ops_per_key": 30, "seed": 7}


def _comparable(out):
    return json.loads(_strip({k: v for k, v in out["results"].items()
                              if k not in WALL_CLOCK_FIELDS
                              and k != "timeline"}))


@pytest.mark.parametrize("case", [
    {"workload": "register", "force_kernel": True},
    {"workload": "register", "nemesis": ["kill", "partition"]},
    {"workload": "set"},
])
def test_stream_run_equals_the_references_and_post_hoc(tmp_path, case,
                                                       monkeypatch):
    """A ``--stream`` run: history bytes and verdict dicts equal the
    reference's ``--stream`` run and the port's post-hoc run; the hint
    is installed and, with force_kernel, every key's pack is reused by
    the wave kernel's batched launch (the reference's Pallas batch runs
    in interpret mode)."""
    monkeypatch.setattr(ref_wgl, "_run_fused",
                        lambda broken, name, call: call())
    opts = dict(BASE, stream=True, stream_chunk_ops=97, **case)
    test = compose.etcd_test(dict(opts, device="cpu",
                                  store_base=str(tmp_path / "p")))
    port = test_runner.run_test(test)
    ref = ref_runner.run_test(ref_compose.etcd_test(
        dict(opts, store_base=str(tmp_path / "r"))))
    post = test_runner.run_test(compose.etcd_test(
        dict(opts, stream=False, device="cpu",
             store_base=str(tmp_path / "q"))))
    assert port["history"].to_jsonl() == ref["history"].to_jsonl() == \
        post["history"].to_jsonl()
    assert _comparable(port) == _comparable(ref) == _comparable(post)
    assert port["valid?"] is True
    hints = test["_stream"]
    key = "set_scan" if case["workload"] == "set" else "register_packs"
    assert key in hints and hints["stats"]["rows"] == len(port["history"])
    ctr = port["results"]["telemetry"]["counters"]
    assert ctr["stream.chunks"] == hints["stats"]["chunks"] > 1
    assert "phase:stream-finalize" in port["results"]["telemetry"]["spans"]
    if case.get("force_kernel"):
        keys = port["results"]["workload"]["results"]
        assert ctr["stream.pack_reuse"] == len(keys) > 5
        assert all(r["linear"]["engine"] == "mxu-wave"
                   for r in keys.values())


def test_stream_cli_history_bytes_equal_the_references(tmp_path, capsys):
    """``python -m jepsen_etcd_tpu_torch test --stream`` and the
    reference's CLI write the same history.jsonl."""
    import os
    from jepsen_etcd_tpu import cli as ref_cli
    argv = ["test", "-w", "register", "--time-limit", "4", "-r", "50",
            "--ops-per-key", "30", "--seed", "3", "--stream",
            "--stream-chunk-ops", "50"]
    assert cli.main(argv + ["--store", str(tmp_path / "p"),
                            "--device", "cpu"]) == 0
    assert ref_cli.main(argv + ["--store", str(tmp_path / "r")]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 2
    with open(os.path.join(lines[0]["dir"], "history.jsonl"), "rb") as f:
        got = f.read()
    with open(os.path.join(lines[1]["dir"], "history.jsonl"), "rb") as f:
        assert f.read() == got and len(got) > 1000
    with open(os.path.join(lines[0]["dir"], "test.json")) as f:
        assert json.load(f)["stream"] is True


def test_make_stream_clears_a_stale_hint_map():
    test = {"workload": "register", "_stream": {"stats": {}}}
    assert test_runner._make_stream(test) is None
    assert "_stream" not in test
    feed = test_runner._make_stream({"workload": "set", "stream": True,
                                     "stream_chunk_ops": 5})
    assert isinstance(feed, StreamFeed) and feed.chunk_ops == 5
    assert test_runner._finish_stream(None, []) is None
