"""Twin of the reference's ``tests/test_perf.py`` on the port's
``checkers/perf.py`` (a byte-identical copy): quantiles, latency points
and nemesis bands, each result equal to the reference's on the same
input."""

import pytest

from jepsen_etcd_tpu.checkers import perf as ref_perf
from jepsen_etcd_tpu.core.history import History as RefHistory
from jepsen_etcd_tpu_torch.checkers.perf import (latency_points,
                                                 nemesis_bands, quantiles)
from jepsen_etcd_tpu_torch.core.history import History
from jepsen_etcd_tpu_torch.core.op import Op
from test_torch_fixtures import one_torch_thread  # noqa: F401

SECOND = 1_000_000_000


def H(*ops):
    return History([Op(o) for o in ops])


def ev(typ, p, f, v, t_s):
    return {"type": typ, "process": p, "f": f, "value": v,
            "time": int(t_s * SECOND)}


def ref_of(h) -> RefHistory:
    return RefHistory.from_jsonl(h.to_jsonl())


def points(h):
    got = latency_points(h)
    assert got == ref_perf.latency_points(ref_of(h))
    return got


def bands(h):
    got = nemesis_bands(h)
    assert got == ref_perf.nemesis_bands(ref_of(h))
    return got


# ---- quantiles --------------------------------------------------------------

def test_quantiles_empty():
    assert quantiles([]) == {} == ref_perf.quantiles([])


def test_quantiles_single_sample():
    q = quantiles([7.0])
    assert q == {0.5: 7.0, 0.95: 7.0, 0.99: 7.0, 1.0: 7.0}
    assert q == ref_perf.quantiles([7.0])


def test_quantiles_orders_input():
    q = quantiles([30.0, 10.0, 20.0, 40.0], qs=(0.5, 1.0))
    assert q[0.5] == 30.0
    assert q[1.0] == 40.0
    assert q == ref_perf.quantiles([30.0, 10.0, 20.0, 40.0], qs=(0.5, 1.0))


# ---- latency_points ---------------------------------------------------------

def test_latency_points_pairs_completions():
    h = H(ev("invoke", 0, "read", None, 1.0),
          ev("ok", 0, "read", 3, 1.5),
          ev("invoke", 1, "write", 9, 2.0),
          ev("fail", 1, "write", 9, 2.25))
    pts = points(h)
    assert set(pts) == {"read", "write"}
    (t, lat, typ), = pts["read"]
    assert t == pytest.approx(1.0)
    assert lat == pytest.approx(500.0)
    assert typ == "ok"
    (t, lat, typ), = pts["write"]
    assert lat == pytest.approx(250.0)
    assert typ == "fail"


def test_latency_points_skips_unpaired_and_nemesis():
    h = H(ev("invoke", 0, "read", None, 1.0),
          ev("invoke", "nemesis", "kill", None, 1.5),
          ev("info", "nemesis", "kill", None, 2.0),
          ev("invoke", 1, "write", 4, 3.0),
          ev("ok", 1, "write", 4, 3.5))
    pts = points(h)
    assert set(pts) == {"write"}
    assert len(pts["write"]) == 1


# ---- nemesis_bands ----------------------------------------------------------

def test_nemesis_bands_extraction():
    h = H(ev("invoke", 0, "read", None, 0.0),
          ev("invoke", "nemesis", "kill", None, 1.0),
          ev("info", "nemesis", "kill", None, 3.0),
          ev("invoke", "nemesis", "partition", None, 3.5),
          ev("info", "nemesis", "partition", None, 5.0),
          ev("ok", 0, "read", 1, 6.0))
    assert bands(h) == [
        {"f": "kill", "start": pytest.approx(1.0),
         "end": pytest.approx(3.0)},
        {"f": "partition", "start": pytest.approx(3.5),
         "end": pytest.approx(5.0)},
    ]


def test_nemesis_bands_unclosed_window_is_dropped():
    h = H(ev("invoke", "nemesis", "kill", None, 1.0))
    assert bands(h) == []
