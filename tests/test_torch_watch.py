"""The port's watch path against the JAX package's: the edit-distance
wavefront (the reference's Pallas kernel in interpret mode, its XLA
wavefront and its Python DP), the helpers it routes through, and the
watch checker's verdict dicts on the shapes of ``tests/test_watch.py``,
on synthesized watch histories and on a history from the reference's
own simulator. On the CPU the port's wavefront is its plain PyTorch
version; the CUDA kernel is held against it on the card (marked
``cuda``). All values are integers: tolerance 0."""

import random

import numpy as np
import pytest
import torch

from jepsen_etcd_tpu.checkers import watch as ref_watch
from jepsen_etcd_tpu.core.history import History as RefHistory
from jepsen_etcd_tpu.core.op import Op as RefOp
from jepsen_etcd_tpu.ops import common as ref_common
from jepsen_etcd_tpu.ops import edit_distance as ref_ed
from jepsen_etcd_tpu_torch.checkers import watch
from jepsen_etcd_tpu_torch.core.history import History
from jepsen_etcd_tpu_torch.core.op import Op
from jepsen_etcd_tpu_torch.ops import common
from jepsen_etcd_tpu_torch.ops import edit_distance as ed
from jepsen_etcd_tpu_torch.testing import gen_watch_history
from test_torch_fixtures import one_torch_thread  # noqa: F401


CPU = torch.device("cpu")


def to_ref(h: History) -> RefHistory:
    return RefHistory.from_jsonl(h.to_jsonl())


def to_port(h: RefHistory) -> History:
    return History.from_jsonl(h.to_jsonl())


# -- routing helpers ----------------------------------------------------

def test_bucket_matches_reference():
    for n in [0, 1, 2, 100, 127, 128, 129, 255, 256, 257, 600, 12_000]:
        assert common.bucket(n) == ref_common.bucket(n)
        assert common.bucket(n, minimum=16) == \
            ref_common.bucket(n, minimum=16)


@pytest.mark.parametrize("force,n,want", [(True, 1, "cpu"),
                                          (False, 10_000, None),
                                          (None, 127, None),
                                          (None, 128, "cpu")])
def test_use_device_tri_state(force, n, want):
    got = common.use_device(force, n, 128, device="cpu")
    assert got == (None if want is None else torch.device(want))


def test_history_filters_match_reference():
    rh = to_ref(gen_watch_history(random.Random(3), n_writes=40,
                                  per_watch=7, info_rate=0.3))
    rh = RefHistory(list(rh) + [RefOp(type="info", process="nemesis",
                                      f="kill", value=None)])
    h = to_port(rh)
    assert h.client_ops().to_jsonl() == rh.client_ops().to_jsonl()
    assert h.oks().to_jsonl() == rh.oks().to_jsonl()
    pred = lambda o: o.get("f") == "write"  # noqa: E731
    assert h.filter(pred).to_jsonl() == rh.filter(pred).to_jsonl()


def test_encode_matches_reference():
    seqs = [["a", 1, "b"], [1, 1, "c"], [], [None, "a"]]
    for got, ref in zip(ed._encode(seqs), ref_ed._encode(seqs)):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


# -- the wavefront ------------------------------------------------------

def _case(seed: int, K: int, n: int):
    """A canonical log of n values and K logs around it: random edits,
    an empty log, the reversal and an unrelated log (heavy divergence)."""
    rng = np.random.default_rng(seed)
    canon = [int(x) for x in rng.integers(0, 6, n)]
    logs = []
    for k in range(K):
        kind = k % 4
        if kind == 0:
            log = list(canon)
            for _ in range(int(rng.integers(0, 15))):
                if log and rng.random() < 0.5:
                    log.pop(int(rng.integers(len(log))))
                else:
                    log.insert(int(rng.integers(len(log) + 1)),
                               int(rng.integers(6)))
        elif kind == 1:
            log = []
        elif kind == 2:
            log = canon[::-1]
        else:
            log = [int(x) for x in rng.integers(0, 9,
                                                int(rng.integers(0, 600)))]
        logs.append(log)
    return canon, logs


def _tensors(canon, logs):
    enc = ed._encode([canon] + logs)
    lb = max([len(e) for e in enc[1:]] + [1])
    b = np.full((len(logs), lb), -2, np.int32)
    for k, e in enumerate(enc[1:]):
        b[k, :len(e)] = e
    return (torch.from_numpy(enc[0]), torch.from_numpy(b),
            torch.tensor([len(e) for e in enc[1:]], dtype=torch.int32))


@pytest.mark.parametrize("seed,K,n", [(1, 1, 130), (2, 3, 200),
                                      (3, 5, 260), (4, 7, 400),
                                      (5, 9, 600), (6, 2, 0),
                                      (7, 4, 90)])
def test_wavefront_matches_pallas_xla_and_python(seed, K, n):
    """Lengths 0..600 across the 128/256/512/1024 buckets."""
    canon, logs = _case(seed, K, n)
    want = [ref_ed._indel_python(canon, l) for l in logs]
    assert ref_ed.edit_distance_batch(canon, logs, force_device=True,
                                      force_pallas=True) == want
    assert ref_ed.edit_distance_batch(canon, logs, force_device=True,
                                      force_pallas=False) == want
    assert ed.wavefront_reference(*_tensors(canon, logs)).tolist() == want
    assert ed.edit_distance_batch(canon, logs, force_device=True,
                                  device="cpu") == want
    assert [ed._indel_python(canon, l) for l in logs] == want


@pytest.mark.parametrize("a,b", [([], []), ([], [4]), ([4], []),
                                 ([4], [4]), ([4], [5]),
                                 ([1, 2], [2, 1]), ([], [1, 2, 3]),
                                 ([1, 2, 3], [])])
def test_wavefront_edges(a, b):
    """n + m in {0, 1} and empty logs: the sweep's first diagonals."""
    want = ref_ed._indel_python(a, b)
    assert ed.wavefront_reference(*_tensors(a, [b])).tolist() == [want]
    assert ed.edit_distance(a, b, force_device=True, device="cpu") == want
    assert ref_ed.edit_distance_batch(a, [b], force_device=True,
                                      force_pallas=True) == [want]


def test_edit_distance_routes_short_logs_to_python(monkeypatch):
    """Under CPU_CUTOFF the Python DP answers, as in the reference."""
    def boom(*args, **kwargs):
        raise AssertionError("wavefront called under the cutoff")
    monkeypatch.setattr(ed, "wavefront", boom)
    assert ed.edit_distance_batch(list("kitten"), [list("sitting")],
                                  device="cpu") == [5]
    assert ed.edit_distance_batch([1], [], device="cpu") == []


def test_wavefront_on_cpu_tensors_is_the_plain_version():
    canon, logs = _case(9, 3, 150)
    before = ed.LAUNCHES
    t = _tensors(canon, logs)
    assert torch.equal(ed.wavefront(*t), ed.wavefront_reference(*t))
    assert ed.LAUNCHES == before


def test_wavefront_rejects_bad_inputs():
    a, b, m = _tensors([1, 2], [[1], [2, 2]])
    with pytest.raises(TypeError):
        ed.wavefront(a.long(), b, m)
    with pytest.raises(ValueError):
        ed.wavefront(a, b[0], m)
    with pytest.raises(ValueError):
        ed.wavefront(a, b, m[:1])
    with pytest.raises(ValueError):
        ed.wavefront(a, b.t(), m)


@pytest.mark.parametrize("lens", [[-1, 2], [1, 3], [0, 9]])
def test_wavefront_rejects_lengths_outside_the_rows(lens):
    """The kernel reads b[k, m_k - 1]: an m_k past the row is refused
    before any launch."""
    a, b, _ = _tensors([1, 2], [[1], [2, 2]])
    with pytest.raises(ValueError, match="lengths"):
        ed.wavefront(a, b, torch.tensor(lens, dtype=torch.int32))


def test_device_inputs_pad_and_encode_as_the_reference():
    """The checker's device inputs: first-seen codes, -2 padding to a
    bucket of at least 128, the logs' lengths."""
    canon, logs = _case(8, 3, 150)
    a, b, m = ed.device_inputs(canon, logs, CPU)
    enc = ref_ed._encode([canon] + logs)
    assert a.tolist() == enc[0].tolist()
    assert b.shape == (3, ref_common.bucket(max(len(l) for l in logs)))
    assert m.tolist() == [len(l) for l in logs]
    for k, e in enumerate(enc[1:]):
        assert b[k, :len(e)].tolist() == e.tolist()
        assert (b[k, len(e):] == -2).all()
    assert ed.wavefront_reference(a, b, m).tolist() == \
        [ref_ed._indel_python(canon, l) for l in logs]


def test_diff_report_matches_reference():
    canon, logs = _case(12, 4, 140)
    for log in logs:
        assert ed.diff_report(canon, log) == ref_ed.diff_report(canon, log)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["shared", "global"])
def test_cuda_kernel_equals_plain_version(cuda_device, regime, monkeypatch):
    """Shared-memory diagonals, and (no shared memory to opt in to) the
    global scratch."""
    if regime == "global":
        from jepsen_etcd_tpu_torch.ops import _cuda
        monkeypatch.setattr(_cuda, "indel_smem_optin", lambda dev: 0)
    before = ed.LAUNCHES
    for seed, K, n in [(1, 1, 130), (5, 9, 600), (6, 2, 0)]:
        t = [x.to(cuda_device) for x in _tensors(*_case(seed, K, n))]
        got = ed.wavefront(*t)
        torch.cuda.synchronize()
        assert torch.equal(got, ed.wavefront_reference(*t))
    assert ed.LAUNCHES == before + 3


# -- the checker --------------------------------------------------------

def watch_inv(p):
    return {"type": "invoke", "process": p, "f": "watch", "value": None}


def watch_ok(p, log, rev):
    return {"type": "ok", "process": p, "f": "watch",
            "value": {"revision": rev, "log": log}}


def gapped_ok(p, log, revs, rev, gaps):
    return {"type": "ok", "process": p, "f": "final-watch",
            "value": {"revision": rev, "log": log, "revs": revs,
                      "gaps": gaps}}


def full_ok(p, log, revs, rev):
    return {"type": "ok", "process": p, "f": "final-watch",
            "value": {"revision": rev, "log": log, "revs": revs}}


LONG = list(range(300))

#: the checker shapes of tests/test_watch.py, plus long-log twins that
#: take the wavefront instead of the Python DP
SHAPES = {
    "identical": [watch_inv(0), watch_ok(0, [1, 2, 3], 5),
                  watch_inv(1), watch_ok(1, [1, 2, 3], 5)],
    "divergent": [watch_inv(0), watch_ok(0, [1, 2, 3], 5),
                  watch_inv(1), watch_ok(1, [1, 3, 2], 5),
                  watch_inv(2), watch_ok(2, [1, 2, 3], 5)],
    "unequal-revisions": [watch_inv(0), watch_ok(0, [1, 2], 4),
                          watch_inv(1), watch_ok(1, [1, 2, 3], 5)],
    "nonmonotonic": [watch_inv(0), watch_ok(0, [1], 5), watch_inv(1),
                     {"type": "fail", "process": 1, "f": "watch",
                      "error": ["nonmonotonic-watch", "went backwards"]}],
    "threads-fold-processes": [watch_inv(1), watch_ok(1, [1, 2], 3),
                               watch_inv(9), watch_ok(9, [3, 4], 9),
                               watch_inv(2), watch_ok(2, [1, 2, 3, 4], 9)],
    "gap-attributed": [
        watch_inv(0), full_ok(0, [10, 11, 12, 13], [2, 3, 4, 5], 5),
        watch_inv(1), full_ok(1, [10, 11, 12, 13], [2, 3, 4, 5], 5),
        watch_inv(2), gapped_ok(2, [10, 13], [2, 5], 5, [[2, 4]])],
    "gap-unattributed": [
        watch_inv(0), full_ok(0, [10, 11, 12, 13], [2, 3, 4, 5], 5),
        watch_inv(1), full_ok(1, [10, 11, 12, 13], [2, 3, 4, 5], 5),
        watch_inv(2), gapped_ok(2, [10, 13], [2, 5], 5, [[2, 3]])],
    "gap-out-of-order": [
        watch_inv(0), full_ok(0, [10, 11, 12, 13], [2, 3, 4, 5], 5),
        watch_inv(1), full_ok(1, [10, 11, 12, 13], [2, 3, 4, 5], 5),
        watch_inv(2), gapped_ok(2, [13, 10], [5, 2], 5, [[2, 4]])],
    "gapped-never-canonical": [
        watch_inv(2), gapped_ok(2, [10, 13], [2, 5], 5, [[2, 4]]),
        watch_inv(0), full_ok(0, [10, 11, 12, 13], [2, 3, 4, 5], 5)],
    "dup-value-end-anchored": [
        watch_inv(0), full_ok(0, [10, 11, 10, 13], [2, 3, 4, 5], 5),
        watch_inv(1), full_ok(1, [10, 11, 10, 13], [2, 3, 4, 5], 5),
        watch_inv(2), gapped_ok(2, [10, 13], [], 5, [[1, 3]])],
    "dup-value-ambiguous": [
        watch_inv(0), full_ok(0, [10, 11, 10], [2, 3, 4], 4),
        watch_inv(1), full_ok(1, [10, 11, 10], [2, 3, 4], 4),
        watch_inv(2), gapped_ok(2, [10], [], 4, [[2, 3]])],
    "all-gapped-merged": [
        watch_inv(0), gapped_ok(0, [10, 13, 14], [2, 5, 6], 6, [[2, 4]]),
        watch_inv(1), gapped_ok(1, [10, 11, 12, 14], [2, 3, 4, 6], 6,
                                [[4, 5]])],
    "all-gapped-real-loss": [
        watch_inv(0), gapped_ok(0, [10, 11, 12, 13], [2, 3, 4, 5], 6,
                                [[5, 6]]),
        watch_inv(1), gapped_ok(1, [10, 11, 13], [2, 3, 5], 6, [[5, 6]])],
    "dup-value-unique-miss": [
        watch_inv(0), full_ok(0, [10, 11, 10, 20], [2, 3, 4, 5], 5),
        watch_inv(1), full_ok(1, [10, 11, 10, 20], [2, 3, 4, 5], 5),
        watch_inv(2), gapped_ok(2, [10, 11, 10], [], 5, [[0, 1]])],
    "dup-value-no-sighting": [
        watch_inv(0), full_ok(0, [10, 11, 10], [2, 3, 4], 4),
        watch_inv(1), full_ok(1, [10, 11, 10], [2, 3, 4], 4),
        watch_inv(2), gapped_ok(2, [11], [], 4, [[1, 2]])],
    "long-identical": [watch_inv(0), watch_ok(0, LONG, 301),
                       watch_inv(1), watch_ok(1, LONG, 301),
                       watch_inv(2), watch_ok(2, LONG, 301)],
    "long-divergent": [watch_inv(0), watch_ok(0, LONG, 301),
                       watch_inv(1), watch_ok(1, LONG[:150] + LONG[151:],
                                              301),
                       watch_inv(2), watch_ok(2, LONG[::-1], 301),
                       watch_inv(3), watch_ok(3, LONG, 301)],
}

VERDICTS = {"identical": True, "divergent": False,
            "unequal-revisions": "unknown", "nonmonotonic": False,
            "threads-fold-processes": True, "gap-attributed": True,
            "gap-unattributed": False, "gap-out-of-order": False,
            "gapped-never-canonical": True, "dup-value-end-anchored": True,
            "dup-value-ambiguous": "unknown", "all-gapped-merged": True,
            "all-gapped-real-loss": False, "dup-value-unique-miss": False,
            "dup-value-no-sighting": False, "long-identical": True,
            "long-divergent": False}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_watch_checker_matches_reference_on_test_shapes(shape):
    ops = SHAPES[shape]
    test = {"concurrency": 4}
    ref = ref_watch.WatchChecker().check(
        test, RefHistory([RefOp(o) for o in ops]))
    got = watch.WatchChecker(device="cpu").check(
        test, History([Op(o) for o in ops]))
    assert got == ref
    assert got["valid?"] == VERDICTS[shape]


@pytest.mark.parametrize("use_tpu", [True, False, None])
def test_watch_checker_use_tpu_tri_state(use_tpu, monkeypatch):
    """use_tpu is the reference's force_device: True takes the wavefront
    even for short logs, False never does."""
    calls = []
    real = ed.wavefront

    def spy(*args, **kwargs):
        calls.append(args[1].shape)
        return real(*args, **kwargs)
    monkeypatch.setattr(ed, "wavefront", spy)
    ops = SHAPES["divergent"]
    got = watch.WatchChecker(use_tpu=use_tpu, device="cpu").check(
        {"concurrency": 4}, History([Op(o) for o in ops]))
    ref = ref_watch.WatchChecker(use_tpu=use_tpu).check(
        {"concurrency": 4}, RefHistory([RefOp(o) for o in ops]))
    assert got == ref
    assert bool(calls) is (use_tpu is True)


GEN_CASES = {
    "clean": dict(),
    "clean-infos": dict(info_rate=0.2),
    "clean-recycled": dict(recycle_watchers=True, info_rate=0.1),
    "drop": dict(corrupt="drop"),
    "reorder": dict(corrupt="reorder"),
    "duplicate": dict(corrupt="duplicate"),
    "gap": dict(gap=True),
    "gap-and-drop": dict(gap=True, corrupt="drop"),
    "unequal": dict(unequal=True),
    "nonmonotonic": dict(nonmonotonic=True),
    "converge-timeout": dict(converge_timeout=True),
}
GEN_VERDICTS = {"clean": True, "clean-infos": True, "clean-recycled": True,
                "drop": False, "reorder": False, "duplicate": False,
                "gap": True, "gap-and-drop": False, "unequal": "unknown",
                "nonmonotonic": False, "converge-timeout": True}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_watch_checker_matches_reference_on_generated_histories(case):
    h = gen_watch_history(random.Random(len(case)), n_writers=3,
                          n_watchers=3, n_writes=300, per_watch=40,
                          corrupt_thread=1, **GEN_CASES[case])
    test = {"concurrency": 6}
    ref = ref_watch.WatchChecker().check(test, to_ref(h))
    got = watch.WatchChecker(device="cpu").check(test, h)
    assert got == ref
    assert got["valid?"] == GEN_VERDICTS[case]


def test_gen_watch_history_has_the_workload_shape():
    h = gen_watch_history(random.Random(1), n_writers=5, n_watchers=5,
                          n_writes=500, per_watch=60, info_rate=0.1,
                          nonmonotonic=True)
    writes = [o for o in h if o["f"] == "write" and o["type"] == "invoke"]
    assert [o["value"] for o in writes] == list(range(500))
    finals = [o for o in h if o["f"] == "final-watch" and o["type"] == "ok"]
    assert len(finals) == 5
    assert {o["process"] % 10 for o in finals} == set(range(5, 10))
    assert all(set(o["value"]) == {"revision", "log", "revs", "gaps"}
               for o in finals)
    assert finals[0]["error"][0] == "nonmonotonic-watch"
    watches = [o for o in h if o["f"] == "watch" and o["type"] == "ok"]
    assert watches and all(set(o["value"]) == {"revision", "log", "revs"}
                           for o in watches)
    assert any(o["type"] == "info" for o in h)
    times = [o["time"] for o in h]
    assert times == sorted(times)


def test_watch_checker_matches_reference_on_a_simulated_run(tmp_path):
    """A history from the reference's own simulator (the watch workload
    as bench.py's dry watch cell runs it), carried over by JSONL."""
    from jepsen_etcd_tpu.compose import etcd_test
    from jepsen_etcd_tpu.runner.test_runner import run_test
    test = etcd_test({"workload": "watch", "time_limit": 3, "rate": 100,
                      "seed": 7, "store_base": str(tmp_path)})
    out = run_test(test)
    rh = out["history"]
    conc = {"concurrency": test["concurrency"]}
    ref = ref_watch.WatchChecker().check(conc, rh)
    got = watch.WatchChecker(device="cpu").check(conc, to_port(rh))
    assert got == ref == out["results"]["workload"]
    assert got["valid?"] is True
    assert min(len(l) for l in
               watch.per_thread_logs(conc, to_port(rh)).values()) >= \
        ed.CPU_CUTOFF
