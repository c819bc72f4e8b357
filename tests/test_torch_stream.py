"""The port's streaming pieces against the reference's:
``ColumnsBuilder.take_chunk``, ``PackStream`` fed ``_slice_columns``
row windows, ``check_prefix`` driven from chunked packs, and the fused
gen->check pipeline (``runner/stream.py`` ``FusedPipeline``) on the
CPU.

The chunk-boundary wall is the reference's (tests/test_stream.py):
however the row stream is cut (a row a chunk, prime-width chunks,
cuts between an op's invoke and its completion) the per-key packs are
bit-identical to the one-shot feed, and every ``check_prefix`` pause
sees the same frontier bytes. The reference's v3 generator runs under
``jax.threefry_partitionable(False)``, the layout its pins were made
with. Tolerance 0: packs are compared field by field, array by array.
"""

import dataclasses

import jax
import numpy as np
import pytest

from jepsen_etcd_tpu.core.history import ColumnsBuilder as RefBuilder
from jepsen_etcd_tpu.core.op import Op as RefOp
from jepsen_etcd_tpu.ops import wgl as ref_wgl
from jepsen_etcd_tpu.runner import stream as ref_stream
from jepsen_etcd_tpu_torch.core.history import ColumnsBuilder, History
from jepsen_etcd_tpu_torch.core.op import Op
from jepsen_etcd_tpu_torch.ops import wgl
from jepsen_etcd_tpu_torch.runner.stream import (DEFAULT_CHUNK_OPS,
                                                 FusedPipeline,
                                                 _slice_columns)
from jepsen_etcd_tpu_torch.simbatch import BatchConfig, generate_jax

from test_torch_fixtures import one_torch_thread  # noqa: F401

CPU = "cpu"
BUDGETS = (1, 3, 64, 100_000)
#: bench.py _dry_fused_pipeline's shape
FUSED_OPTS = {"workload": "register", "nodes": ["n1", "n2", "n3"],
              "concurrency": 8, "rate": 200.0, "time_limit": 2.0}


def _fused_history(seed=5):
    cfg = BatchConfig(workload="register", lanes=6, ops_per_lane=40,
                      rate=500.0, keys=2)
    return generate_jax(cfg, [seed], device=CPU)["histories"][0]


def _pack_split(slicer, packer, cols, bounds):
    """Pack a column stream cut at the given row offsets."""
    ps = packer()
    cuts = [0] + sorted(set(bounds)) + [len(cols)]
    for lo, hi in zip(cuts, cuts[1:]):
        if hi > lo:
            ps.feed(slicer(cols, lo, hi))
    packs = ps.finish()
    assert packs is not None and ps.ok
    assert ps.n_rows == len(cols)
    return packs


def _mid_window_cuts(cols):
    """Row offsets that each split some op's invoke from its completion
    (after every 7th invoke whose completion lies later)."""
    open_rows, pairs = {}, []
    for i in range(len(cols)):
        p = int(cols.proc[i])
        if int(cols.type_code[i]) == 0:
            open_rows[p] = i
        elif p in open_rows:
            pairs.append((open_rows.pop(p), i))
    cuts = [inv + 1 for inv, comp in pairs if comp > inv + 1]
    assert cuts, "history has no spanning invoke windows"
    return cuts[::7] or cuts[:1]


def _same_packs(a: dict, b: dict, what, ordered=True):
    """Field-by-field equality of two ``{key: Packed}`` dicts (in the
    same key order unless ``ordered`` is False: a chunked feed meets the
    keys in stream order)."""
    assert (list(a) == list(b)) if ordered else (sorted(a) == sorted(b)), \
        what
    for key in a:
        x, y = a[key], b[key]
        for fld in dataclasses.fields(type(x)):
            u, v = getattr(x, fld.name), getattr(y, fld.name)
            if isinstance(u, np.ndarray) or isinstance(v, np.ndarray):
                assert np.array_equal(u, v), (what, key, fld.name)
                assert np.asarray(u).dtype == np.asarray(v).dtype
            else:
                assert u == v, (what, key, fld.name)


def _patterns(cols):
    n = len(cols)
    return {"per-row": list(range(1, n)), "prime": list(range(13, n, 13)),
            "mid-window": _mid_window_cuts(cols)}


@pytest.mark.parametrize("seed", [5, 9])
def test_packstream_chunk_boundaries_are_invisible(seed):
    h = _fused_history(seed)
    cols = h.columns
    ref = _pack_split(_slice_columns, wgl.PackStream, cols, [])
    # the one-shot feed equals the batched packer over the key split
    assert list(ref) == list(h.split_by_key())
    _same_packs(ref, wgl.pack_register_histories_batched(
        h.split_by_key()), "batched packer")
    for name, bounds in _patterns(cols).items():
        packs = _pack_split(_slice_columns, wgl.PackStream, cols, bounds)
        for p in list(packs.values()) + list(ref.values()):
            wgl.ensure_frames(p)
        _same_packs(packs, ref, name, ordered=False)


def test_packstream_equals_reference_packstream():
    """The port's PackStream over the port's slices equals the
    reference's over the reference's, on the same history's columns."""
    cols = _fused_history(9).columns
    for name, bounds in {"one shot": [], **_patterns(cols)}.items():
        got = _pack_split(_slice_columns, wgl.PackStream, cols, bounds)
        want = _pack_split(ref_stream._slice_columns, ref_wgl.PackStream,
                           cols, bounds)
        _same_packs(got, want, name)


def test_slice_columns_equals_reference():
    cols = _fused_history(5).columns
    cols.extras[3] = {"error": "x"}
    cols.missing[7] = ("time",)
    for lo, hi in ((0, 10), (3, 8), (5, 5), (-4, 10 ** 9), (40, 41)):
        a = _slice_columns(cols, lo, hi)
        b = ref_stream._slice_columns(cols, lo, hi)
        assert len(a) == len(b)
        for f in ("type_code", "f_code", "proc", "key_id", "time",
                  "index"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert (a.values, a.extras, a.missing) == \
            (b.values, b.extras, b.missing)
        assert a.f_table is cols.f_table and a.key_table is cols.key_table


def test_packstream_withdraws_on_unpackable_stream():
    ps = wgl.PackStream()
    h = History([Op(type="invoke", process=0, f="write",
                    value=(0, [None, {"a": 1}])),
                 Op(type="ok", process=0, f="write",
                    value=(0, [1, {"a": 1}]))])
    from jepsen_etcd_tpu_torch.core.history import columns_of
    ps.feed(columns_of(h.ops))
    ps.feed(None)
    rps = ref_wgl.PackStream()
    from jepsen_etcd_tpu.core.history import columns_of as ref_columns_of
    rps.feed(ref_columns_of([RefOp(dict(o)) for o in h.ops]))
    assert ps.ok == rps.ok
    assert (ps.finish() is None) == (rps.finish() is None)


def _prefix_trajectory(p, max_waves):
    """Every pause of a budgeted run: (k, rungs, waves, frontier bytes)."""
    import hashlib

    def snap(state):
        fr = b"".join(np.asarray(x).tobytes() for x in state.frontier) \
            if getattr(state, "frontier", None) is not None else b""
        return (int(state.k) if not state.done else None,
                state.rungs, state.waves_run,
                hashlib.sha256(fr).hexdigest())

    state = wgl.check_prefix(p, None, max_waves=max_waves, device=CPU)
    traj = [snap(state)]
    while not state.done:
        state = wgl.check_prefix(p, state, max_waves=max_waves)
        traj.append(snap(state))
        assert len(traj) < 100_000
    return traj, state


def test_check_prefix_resume_under_adversarial_boundaries():
    cols = _fused_history(seed=9).columns
    ref_packs = _pack_split(_slice_columns, wgl.PackStream, cols, [])
    split_packs = _pack_split(_slice_columns, wgl.PackStream, cols,
                              _mid_window_cuts(cols))
    for key in sorted(ref_packs):
        one_shot = wgl.check_packed(ref_packs[key], device=CPU)
        for budget in BUDGETS:
            t_ref, s_ref = _prefix_trajectory(ref_packs[key], budget)
            t_spl, s_spl = _prefix_trajectory(split_packs[key], budget)
            assert t_ref == t_spl, (key, budget)
            assert s_ref.result == s_spl.result
            assert s_ref.result["valid?"] is one_shot["valid?"] is True


def _op(i, type, process, f, value, cls=Op):
    return cls(dict(type=type, process=process, f=f, value=value,
                    time=i * 10, index=i))


@pytest.mark.parametrize("builder,op", [(ColumnsBuilder, Op),
                                        (RefBuilder, RefOp)],
                         ids=["port", "reference"])
def test_take_chunk_drains_and_preserves_finish(builder, op):
    b = builder()
    assert b.take_chunk() is None
    ops = [_op(0, "invoke", 0, "read", (0, [None, None]), op),
           _op(1, "ok", 0, "read", (0, [0, None]), op),
           _op(2, "invoke", 1, "write", (0, [None, 3]), op),
           _op(3, "ok", 1, "write", (0, [1, 3]), op)]
    for o in ops[:2]:
        b.append(o)
    c1 = b.take_chunk()
    assert c1 is not None and len(c1) == 2
    assert b.take_chunk() is None
    for o in ops[2:]:
        b.append(o)
    c2 = b.take_chunk()
    assert c2 is not None and len(c2) == 2
    assert c1.f_table is b.f_table and c2.key_table is b.key_table
    full = b.finish()
    assert full is not None and len(full) == 4
    dead = builder()
    dead.append(ops[0])
    dead.dead = True
    assert dead.take_chunk() is None


def test_take_chunk_equals_reference_on_a_simulated_stream():
    """Chunks drained every few rows from the port's builder equal the
    reference builder's, column for column, extras and missing keys
    included, and concatenate to ``finish()``."""
    ops = [dict(o) for o in _fused_history(5).ops]
    ops[4]["error"] = "timeout"
    del ops[6]["value"]
    b, rb = ColumnsBuilder(), RefBuilder()
    chunks = []
    for i, o in enumerate(ops):
        b.append(Op(o))
        rb.append(RefOp(o))
        if i % 11 == 10 or i == len(ops) - 1:
            c, rc = b.take_chunk(), rb.take_chunk()
            for f in ("type_code", "f_code", "proc", "key_id", "time",
                      "index"):
                assert np.array_equal(getattr(c, f), getattr(rc, f)), f
            assert (c.values, c.extras, c.missing) == \
                (rc.values, rc.extras, rc.missing)
            chunks.append(c)
    full = b.finish()
    assert sum(len(c) for c in chunks) == len(full) == len(ops)
    assert np.array_equal(np.concatenate([c.proc for c in chunks]),
                          full.proc)


def test_fused_pipeline_equals_reference():
    """bench.py _dry_fused_pipeline's shape: 4 seeds, sub-batches of 2,
    64-row chunks. The verdict map, packs and waves equal the
    reference's pipeline and the sequential twin's."""
    seeds = list(range(4))
    fused = FusedPipeline(FUSED_OPTS, sub_batch=2, chunk_rows=64,
                          device=CPU).run(seeds)
    with jax.threefry_partitionable(False):
        want = ref_stream.FusedPipeline(FUSED_OPTS, sub_batch=2,
                                        chunk_rows=64).run(seeds)
    assert fused["verdicts"] == want["verdicts"]
    assert sorted(fused["verdicts"]) == seeds
    assert (fused["packs"], fused["waves"]) == \
        (want["packs"], want["waves"])
    assert fused["packs"] >= len(seeds) and fused["waves"] > 0
    assert fused["e2e_s"] >= max(fused["gen_s"], fused["check_s"])
    twin = FusedPipeline(FUSED_OPTS, chunk_rows=64, device=CPU)
    gen = generate_jax(twin.config, seeds, device=CPU)
    seq = {sd: twin._check_history(sd, h)[0]
           for sd, h in zip(seeds, gen["histories"])}
    assert seq == fused["verdicts"]


def test_fused_pipeline_rejects_non_register_workloads():
    with pytest.raises(ValueError, match="checks register packs"):
        FusedPipeline(dict(FUSED_OPTS, workload="set"), device=CPU)
    assert FusedPipeline(FUSED_OPTS, device=CPU).chunk_rows == \
        DEFAULT_CHUNK_OPS == ref_stream.DEFAULT_CHUNK_OPS


def test_fused_pipeline_consumer_failure_raises(monkeypatch):
    """A consumer that fails surfaces its error from run(), after the
    producer has finished and the thread has joined."""
    pipe = FusedPipeline(FUSED_OPTS, sub_batch=1, device=CPU)

    def boom(seed, history):
        raise RuntimeError("consumer boom")
    monkeypatch.setattr(pipe, "_check_history", boom)
    with pytest.raises(RuntimeError, match="consumer boom"):
        pipe.run([1, 2])
