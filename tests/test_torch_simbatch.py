"""The port's batched simulator (``jepsen_etcd_tpu_torch/simbatch``)
against the reference's on the same inputs: ``BatchHeap`` drains,
epoch-v2 histories sha for sha (and its committed 16-seed pin), the
epoch-v3 generator on the CPU (its committed pin, and the live
reference run under ``jax.threefry_partitionable(False)``, the layout
the pin was made with), and the register drain's plain version against
the reference's ``lax.scan``. Tolerance 0 everywhere: every value
compared is an integer, a float32 bit pattern or a sha.

The reference is imported inside the ``ref`` fixture, so the ``cuda``
test at the end (the drain kernel against its plain version) runs on
a machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_simbatch.py``.
"""

import hashlib
import types

import numpy as np
import pytest
import torch

from jepsen_etcd_tpu_torch.simbatch import (GEN_EPOCH_V2, GEN_EPOCH_V3,
                                            BatchConfig, BatchHeap,
                                            default_schedule,
                                            default_schedule_jax, generate,
                                            generate_for_opts, generate_jax,
                                            history_sha)
from jepsen_etcd_tpu_torch.simbatch import engine_v3

from test_torch_fixtures import one_torch_thread  # noqa: F401

#: tests/test_simbatch.py's epoch-v2 pin, copied
GOLDEN_OPTS = {"workload": "register", "nodes": ["n1", "n2", "n3"],
               "concurrency": 8, "rate": 200.0, "time_limit": 2.0}
GOLDEN_SEED0 = \
    "f994af9bf3d2cb2728c4993bd44a13db92cbc70bc8f42f46bb33291d5e88da69"
GOLDEN_JOINED = \
    "89d9966eabeb0b1fa01943ac93921db260b503c3ec48e56ec830891674f21d69"
#: tests/test_simbatch_jax.py's epoch-v3 pin, copied (made with the
#: original threefry layout)
GOLDEN_SEED0_V3 = \
    "c82fabd17a19636bd2aa710d219ff7da169d8919b4528566d55fd41e63853fb8"
GOLDEN_JOINED_V3 = \
    "d93dbf74fe3c0a4180282278c2c223293b7779e33edbdd4bb5a2798c43f9693c"

CPU = "cpu"


@pytest.fixture(scope="module")
def ref():
    """The reference's simbatch package and its v3 engine (imports JAX)."""
    import jax

    import jepsen_etcd_tpu.simbatch as simbatch
    from jepsen_etcd_tpu.simbatch import engine_jax
    return types.SimpleNamespace(sb=simbatch, ej=engine_jax, jax=jax)


def _shas(out) -> list:
    return [history_sha(h) for h in out["histories"]]


def _joined(shas) -> str:
    return hashlib.sha256("".join(shas).encode()).hexdigest()


# ---- BatchHeap --------------------------------------------------------------


def _heap_trace(mod, epoch, seed, unique_times=False):
    """A random push/cancel/pop/compact sequence on ``mod.BatchHeap``;
    every drain's columns and the heap's sizes, in order."""
    S = 3
    h = mod.BatchHeap(S, capacity=2, epoch=epoch, auto_compact=3,
                      unique_times=unique_times)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(80):
        op = rng.integers(0, 6)
        if op <= 2:
            t = rng.integers(1, 400, S)
            if unique_times:
                t = np.array([int(x) * 64 + i for x in t])
            h.push(t, int(rng.integers(0, 8)), int(rng.integers(0, 3)),
                   mask=rng.random(S) < 0.8)
        elif op == 3:
            h.cancel(int(rng.integers(0, 8)), mask=rng.random(S) < 0.6,
                     kind=None if rng.random() < 0.5
                     else int(rng.integers(0, 3)))
        elif op == 4:
            out.append(tuple(np.asarray(x).tolist() for x in h.pop_min()))
        else:
            out.append(tuple(np.asarray(x).tolist()
                             for x in h.pop_same_instant()))
        if i % 17 == 16:
            h.compact()
        out.append((h.size().tolist(), h.peek_time().tolist()))
    while True:
        got = h.pop_min()
        out.append(tuple(np.asarray(x).tolist() for x in got))
        if not got[3].any():
            break
    return out, h.compactions, h.capacity


@pytest.mark.parametrize("epoch", ["epoch-v1", "epoch-v2", "epoch-v3"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_heap_matches_reference(ref, epoch, seed):
    import jepsen_etcd_tpu_torch.simbatch.heap as port_heap
    for unique in (False, True):
        assert _heap_trace(port_heap, epoch, seed, unique) == \
            _heap_trace(ref.sb.heap, epoch, seed, unique)


def test_batch_heap_rejects_unknown_epoch():
    with pytest.raises(ValueError, match="unknown generator epoch"):
        BatchHeap(1, epoch="epoch-v9")


# ---- epoch-v2 ---------------------------------------------------------------


def test_golden_hash_16_seed_pin():
    g = generate_for_opts(dict(GOLDEN_OPTS), range(16))
    assert g["epoch"] == GEN_EPOCH_V2
    shas = _shas(g)
    assert shas[0] == GOLDEN_SEED0
    assert _joined(shas) == GOLDEN_JOINED
    assert len(set(shas)) == 16


V2_CELLS = [("register", []), ("register", ["kill"]),
            ("register", ["partition"]), ("set", []), ("set", ["kill"]),
            ("set", ["partition"]), ("ranges", []),
            ("register", ["kill", "partition"])]


@pytest.mark.parametrize("workload,nemesis", V2_CELLS,
                         ids=[f"{w}-{'+'.join(n) or 'none'}"
                              for w, n in V2_CELLS])
def test_epoch_v2_equals_reference(ref, workload, nemesis):
    """Histories, jsonl bytes and the run's counts equal the
    reference's, seed for seed."""
    opts = {"workload": workload, "nemesis": list(nemesis),
            "nodes": ["n1", "n2", "n3"], "concurrency": 6,
            "rate": 200.0, "time_limit": 1.0,
            "inject_stale_reads": workload == "register"}
    seeds = [3, 11, 2 ** 32 - 1]
    got = generate_for_opts(dict(opts), seeds)
    want = ref.sb.generate_for_opts(dict(opts), seeds)
    for k in ("epoch", "seeds", "events", "steps", "compactions"):
        assert got[k] == want[k], k
    for h, r in zip(got["histories"], want["histories"]):
        # born columnar: asserted before to_jsonl builds the dicts
        assert h._ops is None and len(h.columns) == len(h) > 0
        assert h.to_jsonl() == r.to_jsonl()


@pytest.mark.parametrize("nemesis", [["kill"], ["partition"],
                                     ["kill", "partition"]],
                         ids=lambda n: "+".join(n))
def test_default_schedule_replays_drawn_plan(ref, nemesis):
    opts = {"workload": "register", "nodes": ["n1", "n2", "n3"],
            "concurrency": 6, "rate": 100.0, "time_limit": 1.0,
            "nemesis": nemesis}
    cfg = BatchConfig.from_opts(opts)
    for seed in (7, 12):
        sched = default_schedule(cfg, seed)
        assert sched == ref.sb.default_schedule(
            ref.sb.BatchConfig.from_opts(opts), seed)
        drawn = history_sha(generate(cfg, [seed])["histories"][0])
        explicit = generate(cfg, [seed], nem_schedules=[sched])
        pop = generate(cfg, [seed] * 3, nem_schedules=[sched] * 3)
        assert history_sha(explicit["histories"][0]) == drawn
        assert all(s == drawn for s in _shas(pop))


def test_generate_deterministic_and_composition_independent():
    cfg = BatchConfig(workload="register", lanes=4, ops_per_lane=30,
                      rate=500.0)
    g1 = _shas(generate(cfg, [3, 5, 7]))
    assert g1 == _shas(generate(cfg, [3, 5, 7]))
    assert _shas(generate(cfg, [5]))[0] == g1[1]


def test_config_mapping_equals_reference(ref):
    for opts in (GOLDEN_OPTS, {"concurrency": 40, "rate": 10,
                               "time_limit": 0.1, "nemesis": ["kill"],
                               "nem_drop_prob": 0.3}):
        assert BatchConfig.from_opts(opts).to_dict() == \
            ref.sb.BatchConfig.from_opts(opts).to_dict()
    with pytest.raises(ValueError, match="does not support"):
        BatchConfig(workload="watch")


# ---- epoch-v3 on the CPU -------------------------------------------------------


def test_golden_hash_16_seed_pin_v3():
    g = generate_for_opts(dict(GOLDEN_OPTS, gen_epoch="epoch-v3"),
                          range(16), device=CPU)
    assert g["epoch"] == GEN_EPOCH_V3
    shas = _shas(g)
    assert shas[0] == GOLDEN_SEED0_V3
    assert _joined(shas) == GOLDEN_JOINED_V3
    assert len(set(shas)) == 16


def test_epoch_v3_on_cpu_launches_nothing():
    before = engine_v3.LAUNCHES
    generate_jax(BatchConfig(lanes=4, ops_per_lane=10), [1], device=CPU)
    assert engine_v3.LAUNCHES == before


def _ref_v3(ref, cfg_kwargs, seeds, **kw):
    with ref.jax.threefry_partitionable(False):
        return ref.sb.generate_jax(ref.sb.BatchConfig(**cfg_kwargs),
                                   seeds, **kw)


def test_v3_deterministic_and_composition_independent(ref):
    mk = dict(workload="register", lanes=4, ops_per_lane=30, rate=500.0)
    cfg = BatchConfig(**mk)
    g1 = generate_jax(cfg, [3, 5, 7], device=CPU)
    for h in g1["histories"]:
        assert h._ops is None and len(h.columns) == len(h) > 0
    s1 = _shas(g1)
    assert s1 == _shas(generate_jax(cfg, [3, 5, 7], device=CPU))
    assert _shas(generate_jax(cfg, [5], device=CPU))[0] == s1[1]
    want = _ref_v3(ref, mk, [3, 5, 7])
    assert s1 == _shas(want)
    for k in ("epoch", "seeds", "events", "steps", "compactions"):
        assert g1[k] == want[k], k


V3_CELLS = [("register", [], False), ("register", ["kill"], False),
            ("register", ["partition"], True), ("set", ["partition"], False),
            ("set", [], False), ("register", ["kill", "partition"], True)]


@pytest.mark.parametrize("workload,nemesis,stale", V3_CELLS,
                         ids=[f"{w}-{'+'.join(n) or 'none'}"
                              f"{'-stale' if s else ''}"
                              for w, n, s in V3_CELLS])
def test_v3_equals_live_reference(ref, workload, nemesis, stale):
    opts = {"workload": workload, "nemesis": list(nemesis),
            "nodes": ["n1", "n2", "n3"], "concurrency": 8,
            "rate": 200.0, "time_limit": 1.5, "inject_stale_reads": stale}
    seeds = [11, 0, 2 ** 32 + 5]
    got = generate_for_opts(dict(opts, gen_epoch="epoch-v3"), seeds,
                            device=CPU)
    with ref.jax.threefry_partitionable(False):
        want = ref.sb.generate_for_opts(dict(opts, gen_epoch="epoch-v3"),
                                        seeds)
    assert _shas(got) == _shas(want)
    assert got["events"] == want["events"] and \
        got["steps"] == want["steps"]


@pytest.mark.parametrize("nemesis", [["kill"], ["partition"],
                                     ["kill", "partition"]],
                         ids=lambda n: "+".join(n))
def test_v3_explicit_schedule_replays_drawn_plan(ref, nemesis):
    opts = {"workload": "register", "nodes": ["n1", "n2", "n3"],
            "concurrency": 6, "rate": 100.0, "time_limit": 1.0,
            "nemesis": nemesis}
    cfg = BatchConfig.from_opts(opts)
    rcfg = ref.sb.BatchConfig.from_opts(opts)
    for seed in (7, 12):
        sched = default_schedule_jax(cfg, seed, device=CPU)
        with ref.jax.threefry_partitionable(False):
            assert sched == ref.sb.default_schedule_jax(rcfg, seed)
            want = history_sha(ref.sb.generate_jax(
                rcfg, [seed], nem_schedules=[sched])["histories"][0])
        drawn = history_sha(generate_jax(cfg, [seed],
                                         device=CPU)["histories"][0])
        explicit = generate_jax(cfg, [seed], nem_schedules=[sched],
                                device=CPU)
        pop = generate_jax(cfg, [seed] * 3, nem_schedules=[sched] * 3,
                           device=CPU)
        assert history_sha(explicit["histories"][0]) == drawn == want
        assert all(s == drawn for s in _shas(pop))
    with pytest.raises(ValueError, match="must align"):
        generate_jax(cfg, [1, 2], nem_schedules=[[]], device=CPU)


def test_v3_mvcc_delegates_to_v2():
    opts = {"workload": "ranges", "nodes": ["n1", "n2", "n3"],
            "concurrency": 6, "rate": 100.0, "time_limit": 1.0}
    cfg = BatchConfig.from_opts(opts)
    v2 = generate(cfg, [4, 9])
    v3 = generate_jax(cfg, [4, 9], device=CPU)
    assert (v2["epoch"], v3["epoch"]) == (GEN_EPOCH_V2, GEN_EPOCH_V3)
    assert _shas(v2) == _shas(v3)


def test_v3_stale_injection_caught_by_session_checker():
    """The port's register checker (``Independent(Compose({linear,
    session}))``) passes clean v3 histories and flags the injected stale
    reads as monotone-reads violations."""
    from jepsen_etcd_tpu_torch.checkers import (SessionGuarantees,
                                                TPULinearizableChecker,
                                                compose,
                                                independent_checker)
    chk = independent_checker(compose({
        "linear": TPULinearizableChecker(device=CPU),
        "session": SessionGuarantees()}))
    mk = dict(workload="register", lanes=6, ops_per_lane=60, rate=500.0)
    clean = generate_jax(BatchConfig(**mk), range(3), device=CPU)
    stale = generate_jax(BatchConfig(inject_stale_reads=True, **mk),
                         range(3), device=CPU)
    for h in clean["histories"]:
        assert chk.check({}, h)["valid?"] is True
    for h in stale["histories"]:
        res = chk.check({}, h)
        assert res["valid?"] is False
        sess = [v.get("session") for v in res["results"].values()
                if v.get("session")]
        bad = [s for s in sess if s["valid?"] is False]
        assert any(vi["guarantee"] == "monotone-reads"
                   for s in bad for vi in s.get("violations", []))


# ---- the register drain -----------------------------------------------------


def _drain_inputs(seed, N, S, K, p_to=0.3, p_sg=0.5):
    """Random drain planes: keys in [0, K), f in {read, write, cas},
    values in [0, 5) (the state starts at -1, so early CAS fail), a
    share of timeouts and of stale gates; numpy, (N, S)."""
    rng = np.random.default_rng(seed)
    planes = [rng.integers(0, K, (N, S)), rng.integers(0, 3, (N, S)),
              rng.integers(0, 5, (N, S)), rng.integers(-1, 5, (N, S)),
              rng.integers(0, 5, (N, S))]
    flags = [rng.random((N, S)) < p_to, rng.random((N, S)) < p_sg]
    state = [np.zeros((S, K)), np.full((S, K), -1),
             rng.integers(0, 3, (S, K)), rng.integers(-1, 5, (S, K))]
    return ([a.astype(np.int32) for a in state],
            [a.astype(np.int32) for a in planes], flags)


def _torch_inputs(state, planes, flags, dev="cpu"):
    return ([torch.from_numpy(a).to(dev) for a in state]
            + [torch.from_numpy(a).to(dev) for a in planes]
            + [torch.from_numpy(a).to(dev) for a in flags])


@pytest.mark.parametrize("seed,N,S,K,p_to", [
    (0, 60, 5, 3, 0.3), (1, 200, 7, 1, 0.0), (2, 150, 4, 6, 0.6),
    (3, 1, 1, 2, 1.0), (4, 90, 33, 4, 0.2)])
def test_drain_reference_equals_reference_scan(ref, seed, N, S, K, p_to):
    import jax.numpy as jnp
    state, planes, flags = _drain_inputs(seed, N, S, K, p_to)
    want = ref.ej._drain_register(*[jnp.asarray(a) for a in state],
                                  *[jnp.asarray(a) for a in planes],
                                  *[jnp.asarray(a) for a in flags])
    want = np.stack([np.asarray(y) for y in want])
    args = _torch_inputs(state, planes, flags)
    got = engine_v3.drain_register_reference(*args)
    assert got.dtype == torch.int32 and tuple(got.shape) == (5, N, S)
    assert np.array_equal(got.numpy(), want)
    before = engine_v3.LAUNCHES
    assert torch.equal(engine_v3._drain_register(*args), got)
    assert engine_v3.LAUNCHES == before
    # timed-out rows: the machine untouched, the scan's own row
    to = flags[0]
    if to.any():
        g = got.numpy()
        assert (g[0][to] == 1).all() and (g[1][to] == 7).all()
        assert np.array_equal(g[2][to], planes[3][to])
        assert np.array_equal(g[3][to], planes[4][to])
        assert (g[4][to] == -1).all()


def test_drain_rejects_bad_inputs():
    state, planes, flags = _drain_inputs(0, 4, 3, 2)
    args = _torch_inputs(state, planes, flags)
    with pytest.raises(TypeError):
        engine_v3._drain_register(*args[:4], args[4].long(), *args[5:])
    with pytest.raises(TypeError):
        engine_v3._drain_register(*args[:9], args[9].to(torch.uint8),
                                  args[10])
    with pytest.raises(TypeError):
        engine_v3._drain_register(*args[:5], args[5][:2], *args[6:])
    with pytest.raises(ValueError):
        engine_v3._drain_register(*args[:4], args[4].t(), *args[5:])
    with pytest.raises(ValueError, match="outside"):
        engine_v3._drain_register(*args[:4], args[4] + 2, *args[5:])
    with pytest.raises(ValueError, match="outside"):
        engine_v3.drain_register_reference(*args[:4], args[4] - 1,
                                           *args[5:])


@pytest.mark.cuda
def test_cuda_drain_equals_plain_version():
    """csrc/drain_register.cu against drain_register_reference on the
    card, the machine in shared memory and in the global scratch, with
    one launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from jepsen_etcd_tpu_torch.ops import _cuda
    for seed, N, S, K, p_to in [(0, 300, 16, 4, 0.2), (1, 64, 300, 1, 0.0),
                                (2, 100, 37, 40, 0.5), (3, 5, 1, 2, 1.0)]:
        args = _torch_inputs(*_drain_inputs(seed, N, S, K, p_to), "cuda")
        want = engine_v3.drain_register_reference(*args)
        smem = _cuda.drain_smem_max
        for force_scratch in (False, True):
            if force_scratch:
                _cuda.drain_smem_max = lambda: 0
            try:
                before = engine_v3.LAUNCHES
                got = engine_v3._drain_register(*args)
                torch.cuda.synchronize()
            finally:
                _cuda.drain_smem_max = smem
            assert engine_v3.LAUNCHES == before + 1
            assert torch.equal(got, want), (seed, force_scratch)
    # a machine past the shared memory limit is refused, not cut
    args = _torch_inputs(*_drain_inputs(4, 4, 32, 400), "cuda")
    out = torch.empty((5, 4, 32), dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="drain_register launch failed"):
        _cuda.drain_register(tuple(args[:4]), tuple(args[4:9]),
                             tuple(args[9:]), out, None, 128)
