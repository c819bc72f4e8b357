"""The port's ``SessionGuarantees`` (monotone reads, writes-follow-reads)
against the JAX reference's, dict for dict: on column-backed keyed
histories (whole and split per key through ``Independent``), on
corrupted ones where it finds violations, on dict-only histories (it
builds their columns) and on histories without columns at all."""

import random

import pytest

from jepsen_etcd_tpu.checkers.independent import Independent as RefIndependent
from jepsen_etcd_tpu.checkers.session import \
    SessionGuarantees as RefSessionGuarantees
from jepsen_etcd_tpu.core.history import History as RefHistory
from jepsen_etcd_tpu.core.history import columns_of as ref_columns_of
from jepsen_etcd_tpu_torch.checkers import Independent, SessionGuarantees
from jepsen_etcd_tpu_torch.core.history import History, columns_of

from test_batch import keyed
from test_torch_fixtures import one_torch_thread  # noqa: F401
from test_wgl import gen_history


def keyed_ops(seed, n_keys=6, corrupt_keys=(), info_rate=0.0):
    rng = random.Random(seed)
    ops = []
    for k in range(n_keys):
        ops += keyed(gen_history(rng, n_procs=3, n_ops=30,
                                 corrupt=k in corrupt_keys,
                                 info_rate=info_rate), k, 10 * k)
    return [op.evolve(time=t) for t, op in enumerate(ops)]


def both(ops, with_columns=True):
    """The reference's History of ``ops`` and the port's copy, both
    column-backed unless ``with_columns`` is False."""
    ref = RefHistory(ops)
    port = History.from_jsonl(ref.to_jsonl())
    if with_columns:
        ref = RefHistory(ref.ops, columns=ref_columns_of(ref.ops))
        port = History(port.ops, columns=columns_of(port.ops))
    return ref, port


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("corrupt", [False, True])
def test_keyed_histories_dict_for_dict(seed, corrupt):
    ref, port = both(keyed_ops(seed, corrupt_keys=(1, 3, 4) if corrupt
                               else (), info_rate=0.1))
    assert port.columns is not None
    got = SessionGuarantees().check({}, port)
    assert got == RefSessionGuarantees().check({}, ref)
    per_key = Independent(SessionGuarantees()).check({}, port)
    assert per_key == RefIndependent(RefSessionGuarantees()).check({}, ref)
    if not corrupt:
        assert got["valid?"] is True and per_key["valid?"] is True


def test_corrupted_histories_show_violations():
    found = 0
    for seed in range(4, 12):
        ref, port = both(keyed_ops(seed, corrupt_keys=range(6)))
        got = SessionGuarantees().check({}, port)
        assert got == RefSessionGuarantees().check({}, ref)
        found += got.get("violation-count", 0)
    assert found > 0


def test_dict_only_histories_get_columns():
    ops = keyed_ops(5, corrupt_keys=(0, 2))
    ref, port = both(ops, with_columns=False)
    assert port.columns is None
    assert SessionGuarantees().check({}, port) == \
        RefSessionGuarantees().check({}, ref)
    assert SessionGuarantees().check({}, list(port)) == \
        RefSessionGuarantees().check({}, list(ref))


def test_histories_without_a_columnar_view_are_unknown():
    """Ops without ``time`` do not fit the column schema: both checkers
    answer unknown, and agree on the empty history."""
    rng = random.Random(8)
    ops = keyed(gen_history(rng, n_procs=3, n_ops=20), 0, 0)
    ref, port = both(ops, with_columns=False)
    got = SessionGuarantees().check({}, port)
    assert got == RefSessionGuarantees().check({}, ref)
    assert got["valid?"] == "unknown"
    assert SessionGuarantees().check({}, History([])) == \
        RefSessionGuarantees().check({}, RefHistory([]))
