"""The spans inside the ladder's graphed rung, on the card: a rung run
that the rung kernel does not take and long enough for a CUDA graph
records its capture, its replays and its eager tail, in that order
inside ``wgl.check_packed``, and recording them changes no verdict.
The CPU's side (no graphs there) is in ``tests/test_torch_telemetry.py``.
Runs on a card without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_ladder_spans.py``.
"""

import random

import pytest
import torch

from jepsen_etcd_tpu_torch.ops import wgl
from jepsen_etcd_tpu_torch.runner import telemetry
from jepsen_etcd_tpu_torch.testing import gen_history, impossible_read_at

#: the spans of one rung run, in the order it opens them
RUNG = ("wgl.graph-capture", "wgl.graph-replay", "wgl.eager")


@pytest.mark.cuda
def test_a_graphed_rung_records_capture_replay_then_eager(tmp_path,
                                                        monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    # the rung kernel's route off: rungs 32 and 128 take the graphs
    monkeypatch.setattr(wgl, "RUNG_KERNEL_F_MAX", 0)
    h = impossible_read_at(gen_history(random.Random(2026), n_procs=8,
                                       n_ops=1500), 0.9)
    p = wgl.pack_register_history(h)
    quiet = wgl.check_packed(p, f_max=32)
    path = str(tmp_path / "spans.jsonl")
    tel = telemetry.Telemetry(path)
    telemetry.set_current(tel)
    try:
        traced = wgl.check_packed(p, f_max=32)
    finally:
        telemetry.set_current(None)
        tel.close()
    assert traced == quiet
    assert traced["waves"] > wgl.GRAPH_MIN_WAVES
    spans = sorted((r for r in telemetry.load_jsonl(path)[0]
                    if r["kind"] == "span"), key=lambda r: r["t0"])
    [outer] = [r for r in spans if r["name"] == "wgl.check_packed"]
    inner = [r for r in spans if r["name"] in RUNG]
    assert all(outer["t0"] <= r["t0"] <= r["t1"] <= outer["t1"]
               for r in inner)
    names = [r["name"] for r in inner]
    # the first rung run graphs its waves; a graph's capture is followed
    # by its replays, then by the run's eager tail
    assert tuple(names[:3]) == RUNG
    for i, name in enumerate(names):
        if name == RUNG[0]:
            assert tuple(names[i:i + 3]) == RUNG
    assert all(a["t1"] <= b["t0"] for a, b in zip(inner, inner[1:]))
    # one eager span a rung run
    assert names.count("wgl.eager") == traced["rungs"]
