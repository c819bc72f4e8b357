"""The readers of the spans inside the ladder, the split and the DFS,
on hand-built spans and a hand-built device trace; and on the card, the
shared clock under the ladder's graph replays."""

from __future__ import annotations

import bisect

import pytest

from benchmark.lib.context import Checked, Context
from benchmark.lib.trace import DeviceTrace
from benchmark.metrics import (dfs_ms, rung_capture_ms, rung_eager_ms,
                               rung_replay_idle_share, split_ms)
from benchmark.run import ROOT

#: each span reader with the span it reads
SPAN_READERS = [(rung_capture_ms, "wgl.graph-capture"),
                (rung_eager_ms, "wgl.eager"),
                (split_ms, "independent.split"),
                (dfs_ms, "oracle.dfs")]


def checked(t0, t1):
    return Checked([], t0, t0, t1, {}, None)


def test_a_span_reader_averages_over_every_history():
    """Two histories, the span in the first alone (4 ms and 2 ms): 3 ms
    a history, the one without counting 0."""
    hs = [checked(0.0, 1.0), checked(1.0, 2.0)]
    for reader, name in SPAN_READERS:
        spans = [("bench:check", 0.0, 1.0), (name, 0.1, 0.104),
                 (name, 0.5, 0.502), ("bench:check", 1.0, 2.0),
                 ("wgl.check_packed", 1.1, 1.5)]
        assert reader.read(Context(1.0, 2.0, hs, spans=spans)) == \
            pytest.approx(3.0), name


def test_a_history_with_no_dfs_counts_0():
    hs = [checked(0.0, 1.0), checked(1.0, 2.0), checked(2.0, 3.0),
          checked(3.0, 4.0)]
    spans = [("oracle.dfs", 2.5, 2.508)]
    assert dfs_ms.read(Context(1.0, 4.0, hs, spans=spans)) == \
        pytest.approx(2.0)


@pytest.mark.parametrize("reader", [r for r, _ in SPAN_READERS])
def test_a_span_reader_reads_nothing_without_its_span(reader):
    """A program without the span (the one before it came) gives None,
    as does a run that was not traced."""
    hs = [checked(0.0, 1.0)]
    assert reader.read(Context(1.0, 1.0, hs, spans=[
        ("bench:check", 0.0, 1.0), ("wgl.check_packed", 0.1, 0.9)])) \
        is None
    assert reader.read(Context(1.0, 1.0, hs)) is None


def test_only_histories_before_the_profiler_are_read():
    hs = [checked(0.0, 1.0), checked(1.0, 2.0), checked(2.0, 3.0)]
    spans = [("wgl.eager", 0.1, 0.11), ("wgl.eager", 2.1, 2.9)]
    d = DeviceTrace([("k", 2.0, 2.5)], 2.0, 3.0)
    assert rung_eager_ms.read(Context(1.0, 3.0, hs, spans=spans,
                                      device=d)) == pytest.approx(5.0)


def test_a_replay_half_covered_by_device_operations_reads_50():
    spans = [("wgl.check_packed", 0.0, 10.0), ("wgl.graph-capture", 1.0, 2.0),
             ("wgl.graph-replay", 2.0, 6.0), ("wgl.eager", 6.0, 7.0)]
    # busy 2-3 and 4-5 under the replay: 2 of its 4 s idle
    d = DeviceTrace([("a", 2.0, 3.0), ("b", 4.0, 5.0), ("c", 6.0, 6.5),
                     ("d", 8.0, 9.0)], 0.0, 10.0)
    ctx = Context(1.0, 10.0, [checked(0.0, 10.0)], spans=spans, device=d)
    assert rung_replay_idle_share.read(ctx) == pytest.approx(50.0)


def test_replays_are_clipped_to_the_traced_window():
    # the window opens at 4 inside the first replay (2-6) and closes at
    # 9 inside the second (8-12): 2 + 1 s of replay traced, 1 + 0.5 idle
    spans = [("wgl.graph-replay", 2.0, 6.0), ("wgl.eager", 6.0, 8.0),
             ("wgl.graph-replay", 8.0, 12.0)]
    d = DeviceTrace([("a", 5.0, 6.0), ("b", 6.5, 7.0), ("c", 8.5, 9.0)],
                    4.0, 9.0)
    ctx = Context(1.0, 10.0, [checked(0.0, 12.0)], spans=spans, device=d)
    assert rung_replay_idle_share.read(ctx) == pytest.approx(50.0)


def test_a_window_with_no_replay_gives_none():
    spans = [("wgl.check_packed", 0.0, 10.0), ("wgl.eager", 1.0, 9.0),
             ("wgl.graph-replay", 11.0, 12.0)]
    d = DeviceTrace([("a", 2.0, 3.0)], 0.0, 10.0)
    ctx = Context(1.0, 10.0, [checked(0.0, 12.0)], spans=spans, device=d)
    assert rung_replay_idle_share.read(ctx) is None
    assert rung_replay_idle_share.read(Context(
        1.0, 10.0, [checked(0.0, 12.0)], spans=spans)) is None


def _inside_s(a: float, b: float, starts: list, spans: list) -> float:
    """Seconds of ``[a, b]`` inside the disjoint, sorted ``spans``."""
    i = max(0, bisect.bisect_right(starts, a) - 1)
    s = 0.0
    while i < len(spans) and spans[i][0] < b:
        s += max(0.0, min(b, spans[i][1]) - max(a, spans[i][0]))
        i += 1
    return s


@pytest.mark.cuda
def test_device_time_between_replays_falls_inside_them(tmp_path):
    """The shared clock, on the card: in a short traced run of the cell,
    at least 95 % of the device time between the first and the last
    ``wgl.graph-replay`` span falls inside those spans (the graphed
    waves are most of the ladder's device work, the eager tails and B1
    the rest): a clock mapped wrong would put it outside."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from jepsen_etcd_tpu_torch.runner import telemetry
    from benchmark.lib import spec
    from benchmark.lib.trace import Profiler
    cell = spec.load(ROOT, "register_4n_2000.faulted")
    traffic = cell.traffic(2 ** 35 + 7)
    entry = cell.module("entries").Entry(cell.config)
    for j, keys in enumerate(traffic.warmup()):
        entry.check(entry.history(keys, -(j + 1)))
    prof = Profiler(torch.device("cuda", 0))
    prof.warm()
    path = str(tmp_path / "spans.jsonl")
    tel = telemetry.Telemetry(path, max_records=10 ** 8)
    telemetry.set_current(tel)
    try:
        with prof:
            for i in range(4):
                entry.check(entry.history(traffic.history(i), i))
    finally:
        telemetry.set_current(None)
        tel.close()
    replays = sorted((r["t0"], r["t1"])
                     for r in telemetry.load_jsonl(path)[0]
                     if r.get("kind") == "span"
                     and r["name"] == "wgl.graph-replay")
    assert replays
    lo, hi = replays[0][0], replays[-1][1]
    starts = [a for a, _ in replays]
    total = inside = 0.0
    for _, a, b in prof.trace.ops:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            total += b - a
            inside += _inside_s(a, b, starts, replays)
    print(f"device time between replays {total:.4f} s, "
          f"inside them {inside:.4f} s")
    assert total > 0
    assert inside >= 0.95 * total
