"""The port's wave search against the JAX reference kernel: the plain
PyTorch version ``wave_search_reference`` equals the Pallas kernel run
in interpret mode (``_call_single(..., interpret=True)``, which folds
through ``_summarize``) on the same per-op arrays, at every window
width, corrupt and clean; batched calls equal singles; and the decoded
verdict dicts, ``waves`` and ``peak-frontier`` included, are equal.
Exact equality (tolerance 0). The CUDA kernel itself is held against
the plain version on the card (marked ``cuda``)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_etcd_tpu.ops import wgl as ref_wgl
from jepsen_etcd_tpu.ops import wgl_mxu as ref_mxu
from jepsen_etcd_tpu_torch.core.history import History
from jepsen_etcd_tpu_torch.ops import wgl, wgl_mxu
from jepsen_etcd_tpu_torch.testing import (concurrent_writes_history,
                                           unversioned_rounds_history)

from test_torch_pack import fuzz
from test_torch_fixtures import one_torch_thread  # noqa: F401


def _tables(packs, r_pad, wk, device="cpu"):
    per = [wgl_mxu.pack_perop(p, r_pad) for p in packs]
    i32 = torch.from_numpy(np.stack([a for a, _ in per])).to(device)
    u16 = torch.from_numpy(np.stack([b for _, b in per])
                           .astype(np.int32)).to(device)
    return wgl_mxu.build_tables(i32, u16, r_pad, wk)


def _ref_out(p, r_pad):
    i32, u16 = ref_mxu.pack_perop(p, r_pad)
    return np.asarray(ref_mxu._call_single(r_pad, p.w, True)(
        jnp.asarray(i32), jnp.asarray(u16)))


def _port_pack(h):
    return wgl.pack_register_history(History.from_jsonl(h.to_jsonl()))


@pytest.mark.parametrize("w", [32, 64, 128])
@pytest.mark.parametrize("corrupt", [False, True])
def test_wave_search_reference_equals_pallas_interpret(w, corrupt):
    for h, rp in fuzz(w, corrupt, 0.0, seed=500 + w + corrupt, n=4,
                      need_supported=True):
        pp = _port_pack(h)
        r_pad = max(ref_wgl.bucket(rp.R), ref_mxu.TSUB)
        ref = _ref_out(rp, r_pad)
        tab, scal = _tables([pp], r_pad, w)
        got = wgl_mxu.wave_search(tab, scal, w)
        assert got.dtype == torch.int32
        assert np.array_equal(got[0].numpy(), ref), (got, ref)
        # the decoded verdicts agree field for field
        assert wgl_mxu.check_packed_mxu(pp, device="cpu") == \
            ref_mxu._decode(ref, rp)


def test_overflowing_searches_match():
    """Wide fuzz that overflows the F=32 frontier: which candidates
    survive truncation follows the plane rank order, so accepted /
    overflowed / peak / waves must still agree exactly."""
    rng = random.Random(77)
    seen_ovf = 0
    from test_wgl import gen_history
    for trial in range(40):
        h = gen_history(rng, n_procs=14, n_ops=rng.randint(50, 80),
                        dur_scale=20.0, corrupt=trial % 3 == 0)
        rp = ref_wgl.pack_register_history(h)
        if not ref_mxu.supported(rp):
            continue
        r_pad = max(ref_wgl.bucket(rp.R), ref_mxu.TSUB)
        ref = _ref_out(rp, r_pad)
        got = wgl_mxu.wave_search(*_tables([_port_pack(h)], r_pad, rp.w),
                                  rp.w)
        assert np.array_equal(got[0].numpy(), ref)
        seen_ovf += int(ref[1])
        if seen_ovf >= 3:
            break
    assert seen_ovf >= 3, "fuzz produced too few overflowing searches"


@pytest.mark.parametrize("done_every", [1, 8, 1 << 20])
def test_frontier_death_check_interval_is_unobservable(monkeypatch,
                                                       done_every):
    """The CUDA kernel stops at the first dead wave, the reference
    checks every DONE_EVERY=8 waves, and never stopping is a third
    option: all three give the same vector, because a dead frontier
    stays dead and counts nothing."""
    monkeypatch.setattr(wgl_mxu, "DONE_EVERY", done_every)
    for h, rp in fuzz(32, True, 0.0, seed=42, n=4, need_supported=True):
        r_pad = max(ref_wgl.bucket(rp.R), ref_mxu.TSUB)
        got = wgl_mxu.wave_search(*_tables([_port_pack(h)], r_pad, 32), 32)
        assert np.array_equal(got[0].numpy(), _ref_out(rp, r_pad))


def test_batched_search_equals_singles():
    packs = [p for _, p in fuzz(32, False, 0.0, seed=8, n=3,
                                need_supported=True)]
    packs += [p for _, p in fuzz(32, True, 0.0, seed=9, n=3,
                                 need_supported=True)]
    r_pad = max(max(wgl.bucket(p.R), wgl_mxu.TSUB) for p in packs)
    batched = wgl_mxu.wave_search(*_tables(packs, r_pad, 32), 32)
    for k, p in enumerate(packs):
        single = wgl_mxu.wave_search(*_tables([p], r_pad, 32), 32)
        assert np.array_equal(batched[k].numpy(), single[0].numpy())
    # the checker-facing batch entry groups by (r_pad, wk) and decodes
    outs = wgl_mxu.check_packed_batch_mxu(packs + [wgl.Packed(ok=False)],
                                          device="cpu")
    assert outs[-1] is None
    for p, out in zip(packs, outs):
        assert out == wgl_mxu.check_packed_mxu(p, device="cpu")


def test_unsupported_shapes_return_none():
    p = wgl.Packed(ok=False, reason="nope")
    assert wgl_mxu.check_packed_mxu(p, device="cpu") is None
    assert wgl_mxu.check_packed_batch_mxu([p], device="cpu") is None
    assert wgl.check_packed(p, device="cpu")["valid?"] == "unknown"


def _unversioned_packs(w):
    """Twelve histories of small rounds of unversioned concurrent ops
    that pack at width w (a wide round of 40 or 90 widens the window)."""
    rng = random.Random(11)
    wide = {32: 0, 64: 40, 128: 90}[w]
    packs = []
    for _ in range(12):
        sizes = [rng.randint(1, 4) for _ in range(rng.randint(4, 8))]
        if wide:
            sizes.insert(len(sizes) // 2, wide)
        packs.append(wgl.pack_register_history(
            unversioned_rounds_history(rng, sizes)))
    assert all(wgl_mxu.supported(p) and p.w == w for p in packs)
    return packs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("w", [32, 64, 128])
def test_cuda_kernel_equals_plain_version(cuda_device, w):
    before = wgl_mxu.LAUNCHES
    for corrupt in (False, True):
        for _, p in fuzz(w, corrupt, 0.0, seed=900 + w + corrupt, n=3,
                         need_supported=True):
            r_pad = max(wgl.bucket(p.R), wgl_mxu.TSUB)
            tab, scal = _tables([p], r_pad, w, device=cuda_device)
            got = wgl_mxu.wave_search(tab, scal, w)
            torch.cuda.synchronize()
            ref = wgl_mxu.wave_search_reference(tab, scal, w)
            assert torch.equal(got, ref)
    # one search that overflows F, alone, and one batched launch of twelve
    # keys of unversioned concurrent writes (the partial dedupe fires)
    batch = _unversioned_packs(w)
    r_pad = max(max(wgl.bucket(p.R), wgl_mxu.TSUB) for p in batch)
    over = [concurrent_writes_history(12, read_val=9)] if w == 32 else []
    over = [wgl.pack_register_history(h) for h in over] + [
        p for p in batch if wgl_mxu.wave_search(
            *_tables([p], r_pad, w), w)[0, 1]]
    for packs in (over[:1], batch):
        tab, scal = _tables(packs, r_pad, w, device=cuda_device)
        got = wgl_mxu.wave_search(tab, scal, w)
        torch.cuda.synchronize()
        ref = wgl_mxu.wave_search_reference(tab, scal, w)
        assert torch.equal(got, ref)
        assert ref[:, 1].any() or len(packs) > 1
    assert wgl_mxu.LAUNCHES == before + 8
