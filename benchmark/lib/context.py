"""What a metric's reader reads: one run's record.

A reader ``read(ctx)`` returns a number, or None where it finds
nothing to read; the run leaves a None out of its line.
"""

from __future__ import annotations

import bisect

from .peaks import H100_SXM


class Checked:
    """One history of the window: ``keys`` (the pool's keys, slot by
    slot), ``entries`` (its ops), ``ta``/``t0``/``t1`` (assembly
    started, hand-off, verdict back; monotonic seconds), ``got`` (the
    entry's summary of the verdict, None where the check raised),
    ``error`` and ``exp`` (the reference's verdict a slot)."""

    __slots__ = ("keys", "entries", "ta", "t0", "t1", "got", "error", "exp")

    def __init__(self, keys, ta, t0, t1, got, error):
        self.keys = keys
        self.entries = sum(len(k) for k in keys)
        self.ta = ta
        self.t0 = t0
        self.t1 = t1
        self.got = got
        self.error = error
        self.exp = None

    @property
    def latency_s(self) -> float:
        return self.t1 - self.t0


class Context:
    """``setup_s``, ``window_s`` and ``histories`` in every run;
    ``spans`` (the program's telemetry spans and the harness's own,
    ``(name, t0, t1)``) and ``device`` (a ``DeviceTrace``, None off the
    card) in a traced run, else None; ``peaks`` the card's published
    peaks."""

    def __init__(self, setup_s: float, window_s: float, histories: list,
                 spans=None, device=None):
        self.setup_s = setup_s
        self.window_s = window_s
        self.histories = histories
        self.device = device
        self.peaks = H100_SXM
        self.spans = None
        if spans is not None:
            self.spans = sorted(spans, key=lambda s: s[1])
            self._starts = [s[1] for s in self.spans]

    def spans_in(self, h: Checked, name: str) -> list:
        """``(t0, t1)`` of the spans named ``name`` inside history
        ``h``'s check."""
        lo = bisect.bisect_left(self._starts, h.t0)
        hi = bisect.bisect_right(self._starts, h.t1)
        return [(a, b) for n, a, b in self.spans[lo:hi]
                if n == name and b <= h.t1]

    def span_s(self, h: Checked, name: str) -> float:
        return sum(b - a for a, b in self.spans_in(h, name))

    def traced(self) -> list:
        """The histories checked wholly inside the device trace."""
        if self.device is None:
            return []
        return [h for h in self.histories
                if h.t0 >= self.device.t0 and h.t1 <= self.device.t1]

    def untraced(self) -> list:
        """The histories checked before the profiler started, which the
        host's spans read without its cost; all where it traced the
        whole window."""
        if self.device is None:
            return self.histories
        rest = [h for h in self.histories if h.t1 <= self.device.t0]
        return rest or self.histories


def union_s(intervals: list) -> float:
    """Seconds covered by the union of ``(t0, t1)`` intervals."""
    total = 0.0
    end = float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total
