"""The port's closure with its rows split over lanes (the reference's
row-sharded closure), on the port alone (no JAX here, so the ``cuda``
tests also run on a machine with a card and no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_closure_lanes.py``).

Over 1, 2, 3 and 8 lanes the closure must equal one lane, with m
rounded up to a multiple of the lane count as the reference rounds it;
on the card it must equal the CPU path (bf16 against float32
squarings), on one lane and on two lanes of the card."""

import math

import numpy as np
import pytest
import torch

from jepsen_etcd_tpu_torch.ops import closure, wgl_mxu

from test_torch_fixtures import one_torch_thread  # noqa: F401

LANE_COUNTS = [1, 2, 3, 8]


def random_stack(seed: int, b: int, n: int, ring: int = 0) -> np.ndarray:
    """A sparse random digraph stack; plane 1 (when b > 1) gets a ring
    through its first ``ring`` nodes, a long cycle."""
    rng = np.random.default_rng(seed)
    a = rng.random((b, n, n)) < (2.0 / n)
    if ring and b > 1:
        idx = np.arange(ring)
        a[1, idx, (idx + 1) % ring] = True
    return a


def use_lanes(monkeypatch, lanes: list) -> None:
    monkeypatch.setattr(wgl_mxu, "batch_lanes", lambda device=None: lanes)


@pytest.mark.parametrize("n_lanes", LANE_COUNTS)
def test_row_split_equals_one_lane(n_lanes):
    m = 48   # a multiple of every lane count
    a = torch.from_numpy(random_stack(5, 3, m, ring=m))
    iters = math.ceil(math.log2(m))
    want = closure._closure_device(a, iters)
    got = closure._closure_device(a, iters, [torch.device("cpu")] * n_lanes)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2] == want[2]
    assert bool(want[1][1].all())   # the ring puts every node on a cycle


def test_row_split_rejects_uneven_rows():
    a = torch.zeros((1, 10, 10), dtype=torch.bool)
    with pytest.raises(ValueError, match="does not split"):
        closure._closure_device(a, 4, [torch.device("cpu")] * 3)


@pytest.mark.parametrize("n,n_lanes,m", [(1024, 1, 1024), (1024, 2, 1024),
                                         (1024, 3, 1026), (1024, 8, 1024),
                                         (200, 3, 258), (1, 3, 129),
                                         (5000, 3, 8193)])
def test_geometry_rounds_m_as_the_reference(monkeypatch, n, n_lanes, m):
    use_lanes(monkeypatch, [torch.device("cpu")] * n_lanes)
    lanes, got = closure._geometry(n, "cpu")
    assert got == m and len(lanes) == n_lanes


def closure_calls(monkeypatch) -> list:
    """Record (stack shape, lanes used) of every _closure_device call."""
    calls = []
    inner = closure._closure_device

    def spy(a, iters, lanes=None):
        calls.append((tuple(a.shape), len(lanes or [a.device])))
        return inner(a, iters, lanes)
    monkeypatch.setattr(closure, "_closure_device", spy)
    return calls


@pytest.mark.parametrize("n_lanes", [1, 3])
def test_sharded_route_at_the_cutoff(monkeypatch, n_lanes):
    """At n = SHARD_CUTOFF with several lanes, closure_batch splits the
    rows (m rounded to 1026 over three lanes); the result is the one
    lane's, and below the cutoff one lane runs."""
    n = closure.SHARD_CUTOFF
    a = random_stack(17, 2, n, ring=64)
    calls = closure_calls(monkeypatch)
    use_lanes(monkeypatch, [torch.device("cpu")])
    want = closure.closure_batch(a, force_device=True, device="cpu")
    use_lanes(monkeypatch, [torch.device("cpu")] * n_lanes)
    got = closure.closure_batch(a, force_device=True, device="cpu")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[1][1, :64].all()
    m = 1026 if n_lanes == 3 else 1024
    assert calls == [((2, 1024, 1024), 1), ((2, m, m), n_lanes)]
    calls.clear()
    closure.closure_batch(a[:, :100, :100], force_device=True, device="cpu")
    small = 129 if n_lanes == 3 else 128
    assert calls == [((2, small, small), 1)]


def test_levels_lazy_densifies_when_sharded(monkeypatch):
    """closure_levels_lazy hands a row-split closure to the dense
    pipeline (densify), like the reference; one lane builds the stack
    from the edge lists on the device."""
    n = closure.SHARD_CUTOFF
    rng = np.random.default_rng(3)
    edges = [np.unique(rng.integers(0, n, (2 * n, 2)).astype(np.int32),
                       axis=0) for _ in range(3)]
    edges = [e[e[:, 0] != e[:, 1]] for e in edges]
    mask = np.array([[True, False, False, False], [True, True, False, False]])
    densified = []

    def densify():
        densified.append(1)
        out = np.zeros((2, n, n), bool)
        for b, row in enumerate(mask):
            for t in range(3):
                if row[t]:
                    out[b, edges[t][:, 0], edges[t][:, 1]] = True
        return out
    calls = closure_calls(monkeypatch)
    use_lanes(monkeypatch, [torch.device("cpu")])
    fn1, cyc1 = closure.closure_levels_lazy(edges, mask, n, None, densify,
                                            force_device=True, device="cpu")
    assert not densified
    use_lanes(monkeypatch, [torch.device("cpu")] * 2)
    fn2, cyc2 = closure.closure_levels_lazy(edges, mask, n, None, densify,
                                            force_device=True, device="cpu")
    assert densified == [1]
    assert calls == [((2, n, n), 1), ((2, n, n), 2)]
    assert np.array_equal(cyc1, cyc2) and np.array_equal(fn1(), fn2())


def test_device_route_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = random_stack(1, 1, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        closure.closure_batch(a, force_device=True)
    # below the cutoff the reference's routing picks the host path
    closure.closure_batch(a)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the bf16 squaring runs on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 300, 1000])
def test_card_equals_cpu(cuda_device, n):
    a = random_stack(n, 6, n, ring=n // 2)
    want = closure.closure_batch(a, force_device=True, device="cpu")
    before = closure.LAUNCHES
    got = closure.closure_batch(a, force_device=True, device=cuda_device)
    assert closure.LAUNCHES > before
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.cuda
def test_two_lanes_of_the_card_equal_one(monkeypatch, cuda_device):
    a = random_stack(9, 6, closure.SHARD_CUTOFF + 3, ring=500)
    use_lanes(monkeypatch, [cuda_device])
    want = closure.closure_batch(a, force_device=True, device=cuda_device)
    use_lanes(monkeypatch, [cuda_device] * 2)
    got = closure.closure_batch(a, force_device=True, device=cuda_device)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
