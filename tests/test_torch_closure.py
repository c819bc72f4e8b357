"""The port's Elle closure (``ops/closure.py``) against the reference's
on the CPU: the same seeded numpy inputs through the reference's
``_closure_numpy`` and jitted ``_closure_device`` (JAX on the CPU) and
the port's float32 squaring, bit-equal ``reach`` and ``on_cycle``; the
compact level-stack path (``closure_levels_lazy``) on typed edge lists
with and without the realtime vectors; ``EdgeAccumulator`` across its
chunk boundary; the telemetry spans both packages emit."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_etcd_tpu.ops import closure as ref
from jepsen_etcd_tpu.runner import telemetry as ref_tel
from jepsen_etcd_tpu_torch.ops import closure as port
from jepsen_etcd_tpu_torch.runner import telemetry as port_tel

from test_torch_fixtures import one_torch_thread  # noqa: F401

SIZES = [0, 1, 2, 5, 64, 200, 300]
BATCHES = [1, 3, 6]


def random_stack(seed: int, b: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.random((b, n, n)) < (2.0 / max(n, 1))


@pytest.mark.parametrize("force", [True, False])
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("n", SIZES)
def test_closure_batch_equals_reference(n, b, force):
    a = random_stack(100 * n + b, b, n)
    want_reach, want_cyc = ref.closure_batch(a, force_device=force)
    reach_fn, cyc = port.closure_batch_lazy(a, force_device=force,
                                            device="cpu")
    assert cyc.dtype == bool and reach_fn().dtype == bool
    assert np.array_equal(cyc, want_cyc)
    assert np.array_equal(reach_fn(), want_reach)
    reach, cyc2 = port.closure_batch(a, force_device=force, device="cpu")
    assert np.array_equal(reach, want_reach) and np.array_equal(cyc2, cyc)
    if n:
        np_reach, np_cyc = ref._closure_numpy(a)
        assert np.array_equal(reach, np_reach)
        assert np.array_equal(cyc, np_cyc)


@pytest.mark.parametrize("n", [5, 64, 200])
def test_closure_device_equals_reference_jit(n):
    """The port's squaring loop against the reference's jitted one on
    the same padded stack (m = bucket(n))."""
    a = random_stack(n, 6, n)
    m = port._bucket(n)
    pad = np.zeros((6, m, m), bool)
    pad[:, :n, :n] = a
    iters = max(1, math.ceil(math.log2(m)))
    want_reach, want_cyc = ref._closure_device(jnp.asarray(pad), iters)
    reach, cyc, squarings = port._closure_device(torch.from_numpy(pad),
                                                 iters)
    assert np.array_equal(reach.numpy(), np.asarray(want_reach))
    assert np.array_equal(cyc.numpy(), np.asarray(want_cyc))
    assert 1 <= squarings <= iters


def test_closure_no_overflow_at_256_paths():
    # 0 -> {1..256} -> 257: exactly 256 distinct paths
    n = 258
    a = np.zeros((1, n, n), bool)
    a[0, 0, 1:257] = True
    a[0, 1:257, 257] = True
    want, want_cyc = ref._closure_numpy(a)
    for force in (True, False):
        reach, cyc = port.closure_batch(a, force_device=force, device="cpu")
        assert reach[0, 0, 257]
        assert np.array_equal(reach, want) and np.array_equal(cyc, want_cyc)


def test_closure_simple_cycle_and_2d_input():
    a = np.zeros((4, 4), bool)
    a[0, 1] = a[1, 2] = a[2, 0] = True  # 0->1->2->0; 3 isolated
    reach, cyc = port.closure_batch(a, force_device=True, device="cpu")
    assert cyc[0].tolist() == [True, True, True, False]
    assert reach[0, 0, 2] and reach[0, 2, 1] and not reach[0, 3, 0]


def typed_edges(seed: int, n: int, empty_type=None) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for t in range(3):
        e = rng.integers(0, n, size=(int(rng.integers(0, 3 * n + 1)), 2))
        e = e[e[:, 0] != e[:, 1]]
        if t == empty_type:
            e = e[:0]
        out.append(np.unique(e.astype(np.int32), axis=0).reshape(-1, 2))
    return out


def rt_vectors(seed: int, n: int):
    rng = np.random.default_rng(seed)
    inv = np.sort(rng.integers(0, 4 * n, n)).astype(np.float64)
    comp = inv + rng.integers(1, 12, n)
    comp[rng.random(n) < 0.2] = np.inf   # indeterminate txns
    return inv, comp


def levels_mask(realtime: bool) -> np.ndarray:
    levels = [(0,), (0, 1), (0, 1, 2)]
    if realtime:
        levels += [(0, 3), (0, 1, 3), (0, 1, 2, 3)]
    return np.array([[t in lv for t in range(4)] for lv in levels])


def densify_of(edges, rt_vecs, mask, n):
    def densify():
        planes = []
        for row in mask:
            x = np.zeros((n, n), bool)
            for t in range(3):
                if row[t] and len(edges[t]):
                    x[edges[t][:, 0], edges[t][:, 1]] = True
            if row[3]:
                rt = rt_vecs[1][:, None] < rt_vecs[0][None, :]
                np.fill_diagonal(rt, False)
                x |= rt
            planes.append(x)
        return np.stack(planes)
    return densify


@pytest.mark.parametrize("force", [True, False])
@pytest.mark.parametrize("realtime", [True, False])
@pytest.mark.parametrize("n,empty_type", [(1, None), (5, 1), (60, None),
                                          (200, 0), (300, 2)])
def test_closure_levels_lazy_equals_reference(n, empty_type, realtime,
                                              force):
    edges = typed_edges(n, n, empty_type)
    rt_vecs = rt_vectors(n, n) if realtime else None
    mask = levels_mask(realtime)
    densify = densify_of(edges, rt_vecs, mask, n)
    want_fn, want_cyc = ref.closure_levels_lazy(edges, mask, n, rt_vecs,
                                                densify, force_device=force)
    got_fn, got_cyc = port.closure_levels_lazy(edges, mask, n, rt_vecs,
                                               densify, force_device=force,
                                               device="cpu")
    assert np.array_equal(got_cyc, want_cyc)
    assert np.array_equal(got_fn(), want_fn())


def test_closure_levels_lazy_realtime_above_2_24():
    """History indices past 2^24 round in float32; the port compares the
    same float32 values as the reference, so the relation matches."""
    n = 40
    inv = (2 ** 24 + np.arange(n) * 0.75).round()
    comp = inv + np.tile([0.0, 1.0, 2.0, 3.0], n // 4)
    edges = [np.zeros((0, 2), np.int32)] * 3
    mask = levels_mask(True)
    densify = densify_of(edges, (inv, comp), mask, n)
    want_fn, want_cyc = ref.closure_levels_lazy(edges, mask, n, (inv, comp),
                                                densify, force_device=True)
    got_fn, got_cyc = port.closure_levels_lazy(edges, mask, n, (inv, comp),
                                               densify, force_device=True,
                                               device="cpu")
    assert np.array_equal(got_cyc, want_cyc)
    assert np.array_equal(got_fn(), want_fn())


def test_reach_is_copied_only_when_asked(monkeypatch):
    """on_cycle comes back at once; reach_fn() copies the stack once."""
    a = random_stack(3, 3, 50)
    calls = []
    lazy = port._lazy

    def spy(reach, on_cycle, n):
        fn, cyc = lazy(reach, on_cycle, n)

        def counted():
            calls.append(1)
            return fn()
        return counted, cyc
    monkeypatch.setattr(port, "_lazy", spy)
    reach_fn, cyc = port.closure_batch_lazy(a, force_device=True,
                                            device="cpu")
    assert not calls and cyc.shape == (3, 50)
    assert reach_fn() is reach_fn()


def test_edge_accumulator_equals_reference():
    rng = np.random.default_rng(7)
    acc_ref, acc = ref.EdgeAccumulator(3), port.EdgeAccumulator(3)
    n_edges = ref.EdgeAccumulator.CHUNK + 900
    assert port.EdgeAccumulator.CHUNK == ref.EdgeAccumulator.CHUNK
    for t, i, j in rng.integers(0, 300, size=(n_edges, 3)):
        acc_ref.add(int(t) % 3, int(i), int(j))
        acc.add(int(t) % 3, int(i), int(j))
    assert len(acc) == len(acc_ref)
    for got, want in zip(acc.finalize(), acc_ref.finalize()):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    # resumed after a finalize, past the next chunk boundary
    for t, i, j in rng.integers(0, 500, size=(2 * port.EdgeAccumulator.CHUNK,
                                              3)):
        acc_ref.add(int(t) % 2, int(i), int(j))
        acc.add(int(t) % 2, int(i), int(j))
    assert len(acc) == len(acc_ref)
    for got, want in zip(acc.finalize(), acc_ref.finalize()):
        assert np.array_equal(got, want)
    empty = port.EdgeAccumulator(2).finalize()
    assert [e.shape for e in empty] == [(0, 2), (0, 2)]


def test_routing_constants_equal_reference():
    assert port.CPU_CUTOFF == ref.CPU_CUTOFF
    assert port.SHARD_CUTOFF == ref.SHARD_CUTOFF


#: the blocks the port's telemetry.py adds to the reference's: the
#: registry entries of the spans inside the port's ladder, split, DFS
#: and Elle checker, and of the service's wave-kernel launch counter, the rung
#: kernel's and the batched pack's columnar extraction's, which only
#: the port records
PORT_REGISTRY = ("""        "wgl.tables",         # ops/wgl.py: a ladder's tables padded and
                              # copied to the card (a key, a lane)
        "wgl.frames",         # ... a key's frame tables built: on the
                              # host (ensure_frames, on="host") or on
                              # the card (card_tables, on="card")
        "wgl.graph-capture",  # ... a rung run's warm-up wave and its
                              # CUDA-graph capture
        "wgl.graph-replay",   # ... the run's graph replays and syncs
        "wgl.eager",          # ... its host-launched waves (the rest)
        "wgl.rung-kernel",    # ... or the run in one launch of
                              # csrc/wgl_rung.cu (tables, launch, sync)
        "independent.split",  # checkers/independent.py: the per-key
                              # split
        "oracle.dfs",         # checkers/linearizable.py check_history:
                              # the native DFS or its Python twin
        "elle.collect",       # checkers/elle/append.py: txns
                              # collected, reads checked, version
                              # orders, the non-cycle anomalies
        "elle.graph",         # ... the committed set, the DepGraph's
                              # edges and realtime vectors
        "elle.certificates",  # checkers/elle/graph.py find_cycles
                              # after the closure: reach copied back,
                              # the anchored certificate searches
""", """        "service.wgl_wave_launches",  # wave-kernel launches a tick's
                                  # jobs made, each counted on its own
                                  # thread
        "wgl.rung-kernel",        # rung runs csrc/wgl_rung.cu took
        "wgl.frames-card",        # lone ladders whose rung-kernel tables
                                  # csrc/wgl_frames.cu built
        "wgl.pack-columnar",      # keys the batched pack paired, classed
                                  # and decoded from their columns with
                                  # numpy (ops/wgl.py _columnar_extract)
""")


def test_telemetry_is_the_reference_module():
    with open(ref_tel.__file__) as a, open(port_tel.__file__) as b:
        ref_text, port_text = a.read(), b.read()
    for block in PORT_REGISTRY:
        assert port_text.count(block) == 1
        port_text = port_text.replace(block, "")
    assert port_text == ref_text


def spans(tel_mod, tmp_path, name, fn) -> list:
    path = str(tmp_path / f"{name}.jsonl")
    tel = tel_mod.Telemetry(path)
    tel_mod.set_thread_current(tel)
    try:
        fn()
    finally:
        tel_mod.set_thread_current(None)
        tel.close()
    return [(r["name"], r["attrs"]) for r in tel_mod.load_jsonl(path)[0]
            if r.get("kind") == "span"]


@pytest.mark.parametrize("force", [True, False])
def test_spans_equal_reference(tmp_path, force):
    """A telemetry reader sees the same closure.device / closure.host
    spans from either package, on both entry points."""
    n = 40
    edges = typed_edges(1, n)
    rt_vecs = rt_vectors(1, n)
    mask = levels_mask(True)
    densify = densify_of(edges, rt_vecs, mask, n)
    a = densify()

    def run(mod, **kw):
        def go():
            mod.closure_levels_lazy(edges, mask, n, rt_vecs, densify,
                                    force_device=force, **kw)
            mod.closure_batch(a, force_device=force, **kw)
        return go
    want = spans(ref_tel, tmp_path, "ref", run(ref))
    got = spans(port_tel, tmp_path, "port", run(port, device="cpu"))
    assert got == want
    assert [s[0] for s in got] == (["closure.device"] * 2 if force
                                   else ["closure.host"] * 2)
