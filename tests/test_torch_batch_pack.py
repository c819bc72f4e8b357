"""The port's batched columnar packer against the JAX reference:
``pack_register_histories_batched`` and ``_pack_reference`` give
``Packed`` bit-identical to the reference's on every field, frames
included, on the shapes of ``tests/test_wgl_batch_pack.py`` (info rates
0, 0.05 and 0.25; empty, invoke-only and one-read keys; corrupted keys;
keys the fast path delegates), and ``pack_register_history`` routes
through the batched packer as the reference's does. ``OpColumns``
(``columns_of``, ``split_by_key``) equals the reference's column for
column, and ``pack_perop_batch`` with padding keys equals the
reference's. Exact equality (tolerance 0)."""

import random

import numpy as np
import pytest

from jepsen_etcd_tpu.core.history import History as RefHistory
from jepsen_etcd_tpu.core.history import columns_of as ref_columns_of
from jepsen_etcd_tpu.ops import wgl as ref_wgl
from jepsen_etcd_tpu.ops import wgl_mxu as ref_mxu
from jepsen_etcd_tpu_torch.core.history import History, columns_of
from jepsen_etcd_tpu_torch.generators import independent
from jepsen_etcd_tpu_torch.ops import wgl, wgl_mxu

from test_batch import keyed
from test_torch_fixtures import one_torch_thread  # noqa: F401
from test_torch_pack import assert_packed_equal
from test_wgl import gen_history


def port_history(h) -> History:
    return History.from_jsonl(h.to_jsonl())


def gen_multi_key(rng, n_keys, info_rate=0.0, corrupt=False):
    """The reference test's key mix: {k: History} of small keys."""
    return {k: RefHistory(gen_history(
        rng, n_procs=rng.randint(2, 5), n_ops=rng.randint(6, 40),
        info_rate=info_rate, corrupt=corrupt)) for k in range(n_keys)}


def assert_packs_match(ref: dict, got: dict):
    """Every key's Packed equal, then equal again with frames built
    (which it builds on both sides)."""
    assert set(ref) == set(got)
    for k in ref:
        assert_packed_equal(ref[k], got[k])
        if ref[k].ok and got[k].ok:
            ref_wgl.ensure_frames(ref[k])
            wgl.ensure_frames(got[k])
            assert_packed_equal(ref[k], got[k])


def check_batched(subs: dict):
    """The port's batched packer and its per-key reference packer, on
    the port's copies of ``subs``, against the reference's batched
    packer and ``_pack_reference``."""
    port_subs = {k: port_history(h) for k, h in subs.items()}

    def per_key(pack, hs):
        return {k: pack(h) for k, h in hs.items()}

    ref_batched = ref_wgl.pack_register_histories_batched(subs)
    got_batched = wgl.pack_register_histories_batched(port_subs)
    assert list(ref_batched) == list(got_batched)
    assert_packs_match(ref_batched, got_batched)
    assert_packs_match(per_key(ref_wgl._pack_reference, subs),
                       wgl.pack_register_histories_batched(port_subs))
    assert_packs_match(per_key(ref_wgl._pack_reference, subs),
                       per_key(wgl._pack_reference, port_subs))
    return wgl.pack_register_histories_batched(port_subs)


@pytest.mark.parametrize("info_rate", [0.0, 0.05, 0.25])
def test_batched_packer_bit_identical(info_rate):
    rng = random.Random(int(info_rate * 100) + 5)
    got = check_batched(gen_multi_key(rng, 24, info_rate=info_rate))
    if info_rate:
        assert any(p.I for p in got.values())


def test_batched_packer_edge_keys():
    rng = random.Random(31)
    subs = gen_multi_key(rng, 6, info_rate=0.1)
    subs["empty"] = RefHistory([])
    subs["invoke-only"] = RefHistory([{"type": "invoke", "process": 0,
                                       "f": "write", "value": [None, 1]}])
    subs["one-read"] = RefHistory([
        {"type": "invoke", "process": 0, "f": "read",
         "value": [None, None]},
        {"type": "ok", "process": 0, "f": "read", "value": [None, None]},
    ])
    got = check_batched(subs)
    assert got["empty"].R == 0 and got["invoke-only"].R == 0


def test_batched_packer_corrupt_histories():
    check_batched(gen_multi_key(random.Random(77), 16, corrupt=True))


def _ops(*rows):
    out = []
    for t, p, f, v in rows:
        out.append({"type": t, "process": p, "f": f, "value": v})
    return RefHistory(out)


def test_batched_packer_delegated_keys():
    """Keys the columnar path cannot express (non-int values, a
    version-asserting info op, a malformed read value) delegate to the
    per-key packer and come out exactly as the reference's, beside keys
    the fast path takes."""
    rng = random.Random(9)
    subs = gen_multi_key(rng, 4, info_rate=0.1)
    subs["strings"] = _ops(("invoke", 0, "write", [None, "a"]),
                           ("ok", 0, "write", [1, "a"]),
                           ("invoke", 1, "read", [None, None]),
                           ("ok", 1, "read", [1, "a"]))
    subs["info-version"] = _ops(("invoke", 0, "write", [None, 1]),
                                ("ok", 0, "write", [1, 1]),
                                ("invoke", 1, "write", [3, 2]),
                                ("invoke", 2, "read", [None, None]),
                                ("ok", 2, "read", [1, 1]))
    subs["bad-version"] = _ops(("invoke", 0, "write", [None, 1]),
                               ("ok", 0, "write", ["x", 1]))
    subs["unsupported-f"] = _ops(("invoke", 0, "txn", [None, 1]),
                                 ("ok", 0, "txn", [1, 1]))
    got = check_batched(subs)
    assert got["strings"].ok and not got["bad-version"].ok
    assert not got["info-version"].ok and not got["unsupported-f"].ok


def test_pack_register_history_routes_through_the_batched_packer(
        monkeypatch):
    rng = random.Random(12)
    for k, h in gen_multi_key(rng, 6, info_rate=0.1).items():
        assert_packs_match({k: ref_wgl.pack_register_history(h)},
                           {k: wgl.pack_register_history(port_history(h))})
    calls = []
    real = wgl.pack_register_histories_batched
    monkeypatch.setattr(wgl, "pack_register_histories_batched",
                        lambda subs, **kw: calls.append(1) or real(subs))
    wgl.pack_register_history(port_history(h))
    assert calls == [1]


def timed_keyed(n_keys, seed, info_rate=0.0, corrupt_keys=()):
    """A keyed reference history whose ops carry ``time`` (so it has
    columns) and the port's copy of it, both column-backed."""
    rng = random.Random(seed)
    ops = []
    for k in range(n_keys):
        ops += keyed(gen_history(rng, n_procs=rng.randint(2, 4),
                                 n_ops=rng.randint(6, 30),
                                 info_rate=info_rate,
                                 corrupt=k in corrupt_keys),
                     f"k{k}" if k % 2 else k, 10 * k)
    ops = [op.evolve(time=1000 * t) for t, op in enumerate(ops)]
    ref = RefHistory(ops)
    ref = RefHistory(ref.ops, columns=ref_columns_of(ref.ops))
    port = port_history(ref)
    port = History(port.ops, columns=columns_of(port.ops))
    return ref, port


def assert_columns_equal(ref, got):
    for name in ("type_code", "f_code", "proc", "key_id", "time", "index"):
        a, b = getattr(ref, name), getattr(got, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("values", "extras", "missing", "f_table", "key_table",
                 "proc_table"):
        assert getattr(ref, name) == getattr(got, name), name


def test_columns_and_split_by_key_equal_the_reference():
    ref, port = timed_keyed(7, seed=4, info_rate=0.2, corrupt_keys=(2,))
    assert port.columns is not None
    assert_columns_equal(ref.columns, port.columns)
    assert port.columns.client_pairs() == ref.columns.client_pairs()
    ref_split = ref.columns.split_by_key()
    got_split = port.columns.split_by_key()
    assert list(ref_split) == list(got_split)
    for k in ref_split:
        assert_columns_equal(ref_split[k], got_split[k])
    # History.split_by_key: columnar when columns exist, the dict split
    # otherwise, both equal to the reference's per-key ops
    before = History.dict_materializations
    col_subs = port.split_by_key()
    assert History.dict_materializations == before
    dict_subs = History(port.ops).split_by_key()
    assert list(col_subs) == list(dict_subs) == \
        independent.history_keys(port)
    for k, sub in ref.split_by_key().items():
        assert col_subs[k].ops == dict_subs[k].ops == sub.ops
        assert dict_subs[k].ops == independent.subhistory(port, k)
        assert col_subs[k].pairs == sub.pairs


def test_column_backed_keys_pack_like_the_reference():
    """The batched packer's columnar front end (``_rows_from_columns``)
    packs split columns exactly as the reference does, and as the dict
    front end does."""
    ref, port = timed_keyed(9, seed=6, info_rate=0.15, corrupt_keys=(4,))
    before = History.dict_materializations
    got = wgl.pack_register_histories_batched(port.split_by_key())
    assert History.dict_materializations == before
    assert_packs_match(
        ref_wgl.pack_register_histories_batched(ref.split_by_key()), got)
    assert_packs_match(
        wgl.pack_register_histories_batched(port.split_by_key()),
        wgl.pack_register_histories_batched(
            History(port.ops).split_by_key()))


def test_pack_perop_batch_with_padding_keys():
    rng = random.Random(13)
    packs = []
    for _ in range(40):
        p = ref_wgl.pack_register_history(RefHistory(gen_history(
            rng, n_procs=rng.randint(2, 4), n_ops=rng.randint(6, 40))))
        if p.ok and ref_mxu.supported(p):
            packs.append(p)
    assert len(packs) >= 20
    groups = {}
    for p in packs:
        groups.setdefault((max(ref_wgl.bucket(p.R), ref_mxu.TSUB), p.w),
                          []).append(p)
    for (r_pad, _), chunk in groups.items():
        k_pad = len(chunk) + 3
        ports = [wgl.Packed.from_numpy(vars(p)) for p in chunk]
        for a, b in zip(ref_mxu.pack_perop_batch(chunk, r_pad, k_pad),
                        wgl_mxu.pack_perop_batch(ports, r_pad, k_pad)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)
            assert not b[len(chunk):].any()
        for j, p in enumerate(ports):
            single = wgl_mxu.pack_perop(p, r_pad)
            got = wgl_mxu.pack_perop_batch(ports, r_pad, k_pad)
            assert np.array_equal(got[0][j], single[0])
            assert np.array_equal(got[1][j], single[1])


def test_pack_perop_batch_empty():
    bi, bu = wgl_mxu.pack_perop_batch([], 128, 4)
    assert bi.shape == (4, 128, 4) and not bi.any() and not bu.any()
