"""The port's host packing and device frame builder are bit-identical to
the JAX reference: ``Packed`` fields, ``pack_perop`` arrays, and the
``[r_pad, TLANES]`` / ``[r_pad, 8]`` tables of ``build_tables`` against
both the reference's jitted ``_build_tables_one`` and its host packer
``pack_tables``. Exact equality (tolerance 0)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from jepsen_etcd_tpu.core.history import History as RefHistory
from jepsen_etcd_tpu.ops import wgl as ref_wgl
from jepsen_etcd_tpu.ops import wgl_mxu as ref_mxu
from jepsen_etcd_tpu_torch.core.history import History
from jepsen_etcd_tpu_torch.ops import wgl, wgl_mxu

from test_wgl import gen_history
from test_torch_fixtures import one_torch_thread  # noqa: F401


#: fuzz shapes per target window width: (n_procs, n_ops, dur_scale)
SHAPES = {32: ((2, 6), (8, 48), 1.0),
          64: ((12, 20), (60, 120), 20.0),
          128: ((30, 38), (110, 150), 30.0)}


def fuzz(w, corrupt, info_rate, seed, n, need_supported=False):
    """Up to n reference histories that pack at window width w."""
    rng = random.Random(seed)
    (p_lo, p_hi), (o_lo, o_hi), dur = SHAPES[w]
    out = []
    for _ in range(60 * n):
        h = gen_history(rng, n_procs=rng.randint(p_lo, p_hi),
                        n_ops=rng.randint(o_lo, o_hi), corrupt=corrupt,
                        info_rate=info_rate, dur_scale=dur)
        p = ref_wgl.pack_register_history(h)
        if p.ok and p.w == w and (ref_mxu.supported(p)
                                  or not need_supported):
            out.append((h, p))
        if len(out) == n:
            break
    assert len(out) == n, f"fuzz found {len(out)}/{n} w={w} histories"
    return out


def port_history(h) -> History:
    return History.from_jsonl(h.to_jsonl())


def assert_packed_equal(ref, got):
    for name, rv in vars(ref).items():
        gv = getattr(got, name)
        if isinstance(rv, np.ndarray):
            assert isinstance(gv, np.ndarray), name
            assert rv.dtype == gv.dtype and rv.shape == gv.shape, name
            assert np.array_equal(rv, gv), name
        else:
            assert rv == gv, (name, rv, gv)


@pytest.mark.parametrize("w", [32, 64, 128])
@pytest.mark.parametrize("corrupt,info_rate",
                         [(False, 0.0), (True, 0.0), (False, 0.25)])
def test_packed_and_perop_bit_identical(w, corrupt, info_rate):
    for h, ref in fuzz(w, corrupt, info_rate, seed=w * 7 + corrupt,
                       n=4):
        got = wgl.pack_register_history(port_history(h))
        assert_packed_equal(ref, got)
        # frames: the host reference packer's ingredients
        ref_wgl.ensure_frames(ref)
        wgl.ensure_frames(got)
        assert_packed_equal(ref, got)
        r_pad = max(ref_wgl.bucket(ref.R), ref_mxu.TSUB)
        for a, b in zip(ref_mxu.pack_perop(ref, r_pad),
                        wgl_mxu.pack_perop(got, r_pad)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_mutex_and_unsupported_packs_match():
    """Adapter packing (mutex) and the refusal reasons match too."""
    from test_wgl import gen_mutex_history
    rng = random.Random(5)
    for trial in range(8):
        h = gen_mutex_history(rng, n_procs=3, n_ops=18,
                              corrupt=trial % 2 == 1)
        assert_packed_equal(ref_wgl.pack_mutex_history(h),
                            wgl.pack_mutex_history(port_history(h)))
    bad = RefHistory([
        {"type": "invoke", "process": 0, "f": "write", "value": [None, 1]},
        {"type": "ok", "process": 0, "f": "write", "value": ["x", 1]}])
    ref = ref_wgl.pack_register_history(bad)
    got = wgl.pack_register_history(port_history(bad))
    assert not got.ok and got.reason == ref.reason


def test_packed_from_numpy_round_trips_reference_fields():
    (h, ref), = fuzz(32, False, 0.0, seed=3, n=1)
    got = wgl.Packed.from_numpy(vars(ref))
    assert_packed_equal(ref, got)


def _ref_build(i32, u16, r_pad, wk):
    build = jax.jit(lambda a, b: ref_mxu._build_tables_one(
        jnp, lax, a, b, r_pad, wk))
    return [np.asarray(x) for x in build(jnp.asarray(i32),
                                         jnp.asarray(u16))]


def _port_build(perops, r_pad, wk):
    i32 = torch.from_numpy(np.stack([a for a, _ in perops]))
    u16 = torch.from_numpy(np.stack([b for _, b in perops])
                           .astype(np.int32))
    tab, scal = wgl_mxu.build_tables(i32, u16, r_pad, wk)
    return tab.numpy(), scal.numpy()


@pytest.mark.parametrize("w", [32, 64, 128])
@pytest.mark.parametrize("corrupt", [False, True])
def test_build_tables_matches_reference_builders(w, corrupt):
    for h, p in fuzz(w, corrupt, 0.0, seed=100 + w + corrupt, n=3,
                     need_supported=True):
        r_pad = max(ref_wgl.bucket(p.R), ref_mxu.TSUB)
        i32, u16 = ref_mxu.pack_perop(p, r_pad)
        t_host, s_host = ref_mxu.pack_tables(p, r_pad)
        t_ref, s_ref = _ref_build(i32, u16, r_pad, w)
        t_got, s_got = _port_build([(i32, u16)], r_pad, w)
        assert t_got.dtype == np.int32 and s_got.dtype == np.int32
        assert np.array_equal(t_got[0], t_ref)
        assert np.array_equal(s_got[0], s_ref)
        assert np.array_equal(t_got[0], t_host)
        assert np.array_equal(s_got[0], s_host)


def test_build_tables_batched_equals_per_key():
    """One [K, ...] build over keys of different R (and an all-zero
    padding key) equals the per-key reference tables."""
    packs = [p for _, p in fuzz(32, False, 0.0, seed=9, n=4,
                                need_supported=True)]
    r_pad = max(max(ref_wgl.bucket(p.R), ref_mxu.TSUB) for p in packs)
    perops = [ref_mxu.pack_perop(p, r_pad) for p in packs]
    perops.append((np.zeros_like(perops[0][0]),
                   np.zeros_like(perops[0][1])))
    t_got, s_got = _port_build(perops, r_pad, 32)
    for k, p in enumerate(packs):
        t_host, s_host = ref_mxu.pack_tables(p, r_pad)
        assert np.array_equal(t_got[k], t_host)
        assert np.array_equal(s_got[k], s_host)
    assert not t_got[-1].any() and not s_got[-1].any()


def test_build_tables_past_the_reference_one_hot_limit():
    """Past OH_MAX_RPAD the reference builder takes its banded scan
    branch; the port's single gather must match it there too."""
    (h, p), = fuzz(32, True, 0.0, seed=21, n=1, need_supported=True)
    r_pad = 2 * ref_mxu.OH_MAX_RPAD[32]
    i32, u16 = ref_mxu.pack_perop(p, r_pad)
    t_ref, s_ref = _ref_build(i32, u16, r_pad, 32)
    t_got, s_got = _port_build([(i32, u16)], r_pad, 32)
    assert np.array_equal(t_got[0], t_ref)
    assert np.array_equal(s_got[0], s_ref)
