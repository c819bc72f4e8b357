"""The batched wave-kernel launch over lanes, on the port alone (no JAX
here, so the ``cuda`` test also runs on a machine with a card and no
JAX: ``python -m pytest --noconftest -m cuda tests/test_torch_lanes.py``).

Keys split key-major over the lanes of ``wgl_mxu.batch_lanes``; the
per-key ``[accepted, overflowed, peak, waves]`` rows must not depend on
the lane count (so neither on k_pad nor on the padding keys), and on the
card two lanes (two streams of one card) must equal one launch and the
plain version exactly."""

import random

import pytest
import torch

from jepsen_etcd_tpu_torch.ops import wgl, wgl_mxu
from jepsen_etcd_tpu_torch.testing import gen_history

from test_torch_fixtures import one_torch_thread  # noqa: F401

LANE_COUNTS = [1, 2, 3, 8]


def supported_packs(seed: int, n: int) -> list:
    rng = random.Random(seed)
    out = []
    while len(out) < n:
        p = wgl.pack_register_history(gen_history(
            rng, n_procs=3, n_ops=rng.choice([12, 30]),
            corrupt=len(out) % 4 == 1))
        if wgl_mxu.supported(p):
            out.append(p)
    return out


def rows(monkeypatch, packs: list, lanes: list) -> dict:
    """{pack index: result row} of one batched launch over ``lanes``."""
    monkeypatch.setattr(wgl_mxu, "batch_lanes", lambda device=None: lanes)
    out = {}
    for chunk, arr, _ in wgl_mxu.readback(
            wgl_mxu.launch_packed_batch_mxu(packs)):
        assert arr.shape[0] == wgl_mxu._batch_geometry(len(chunk),
                                                       len(lanes))[0]
        out.update({i: arr[j].tolist() for j, i in enumerate(chunk)})
    return out


def test_rows_do_not_depend_on_the_lane_count(monkeypatch):
    packs = supported_packs(11, 13)
    got = {n: rows(monkeypatch, packs, [torch.device("cpu")] * n)
           for n in LANE_COUNTS}
    assert all(got[n] == got[1] for n in LANE_COUNTS)
    assert sorted(got[1]) == list(range(len(packs)))


@pytest.mark.parametrize("K,n,want", [(1, 8, (1, 1)), (3, 1, (4, 1)),
                                      (5, 2, (8, 2)), (7, 3, (12, 3)),
                                      (17, 8, (32, 8)), (2, 3, (2, 2))])
def test_batch_geometry(K, n, want):
    k_pad, n_dev = wgl_mxu._batch_geometry(K, n)
    assert (k_pad, n_dev) == want and k_pad % n_dev == 0 and k_pad >= K


def test_batch_lanes_name_one_device_or_every_card(monkeypatch):
    assert wgl_mxu.batch_lanes("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wgl_mxu.batch_lanes()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_two_lanes_on_one_card_equal_one_launch(monkeypatch, cuda_device):
    packs = supported_packs(17, 21)
    before = wgl_mxu.LAUNCHES
    one = rows(monkeypatch, packs, [cuda_device])
    assert rows(monkeypatch, packs, [cuda_device, cuda_device]) == one
    groups: dict = {}
    for p in packs:
        key = (max(wgl.bucket(p.R), wgl_mxu.TSUB), p.w)
        groups[key] = groups.get(key, 0) + 1
    # one launch per group on one lane, one per lane used on two
    assert wgl_mxu.LAUNCHES - before == sum(1 + min(2, k)
                                            for k in groups.values())
    assert rows(monkeypatch, packs, [torch.device("cpu")]) == one
