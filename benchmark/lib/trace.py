"""The device's side of a traced run: ``torch.profiler`` over the
window, its device operations mapped onto the host's monotonic clock,
and the reductions the per-layer readers and the ``breakdown`` use.

Only device activity is traced (kernels, copies, sets); the host side
comes from the program's telemetry spans. Two marker launches, each
after a synchronize, tie the profiler's clock to ``time.monotonic``:
the first device operation of the trace is the start marker, the last
the end marker.
"""

from __future__ import annotations

import time


class DeviceTrace:
    """``ops``: ``(name, t0, t1)`` of every device operation between the
    markers, in monotonic seconds; ``t0``/``t1``: the traced window."""

    def __init__(self, ops: list, t0: float, t1: float):
        self.ops = ops
        self.t0 = t0
        self.t1 = t1

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> list:
        """The union of the operations' intervals, merged, in order."""
        out: list = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                if b > out[-1][1]:
                    out[-1][1] = b
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def gaps(self) -> list:
        """The idle intervals of the traced window, in order."""
        out = []
        at = self.t0
        for a, b in self.busy():
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            out.append((at, self.t1))
        return out

    def seconds_by_name(self) -> dict:
        out: dict = {}
        for name, a, b in self.ops:
            out[name] = out.get(name, 0.0) + (b - a)
        return out


class Profiler:
    """``with Profiler(device) as p: ...`` traces the block's device
    work; ``p.trace`` is then a ``DeviceTrace``."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.device = device
        self.trace = None
        self.on = False

    def warm(self) -> None:
        """Trace one marker and drop it: the process's first trace
        starts the profiler's own machinery, seconds of set-up that
        would otherwise land in the window."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            self._marker()

    def _marker(self) -> float:
        torch = self.torch
        torch.cuda.synchronize(self.device)
        t = time.monotonic()
        torch.ones(1, device=self.device).add_(1)
        torch.cuda.synchronize(self.device)
        return t

    def __enter__(self) -> "Profiler":
        from torch.profiler import ProfilerActivity, profile
        self.torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.on = True
        self.h0 = self._marker()
        return self

    def __exit__(self, *exc) -> None:
        self.h1 = self._marker()
        self.prof.__exit__(*exc)
        self.on = False
        if exc[0] is None:
            self.trace = self._read()

    def _read(self) -> DeviceTrace:
        """Device operations from the profiler's raw events (no event
        tree: a ladder's window holds millions), mapped so the markers
        land on their host times."""
        from torch.autograd import DeviceType
        raw = [(e.name(), e.start_ns() / 1e3,
                (e.start_ns() + e.duration_ns()) / 1e3)
               for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        raw.sort(key=lambda r: r[1])
        if len(raw) < 2:
            raise RuntimeError("the profiler traced no device operation: "
                               "the markers are missing")
        d0, d1 = raw[0][1], raw[-1][1]
        scale = (self.h1 - self.h0) / (d1 - d0) if d1 > d0 else 1e-6

        def host(us):
            return self.h0 + (us - d0) * scale

        ops = [(name, host(a), host(b)) for name, a, b in raw[1:-1]]
        return DeviceTrace(ops, self.h0, self.h1)


def innermost(spans: list, gaps: list) -> dict:
    """Seconds of ``gaps`` by the innermost span open over them
    (``spans``: ``(name, t0, t1)``, nested as a thread's calls nest;
    ``"outside any span"`` where none is open)."""
    edges = []
    for k, (name, a, b) in enumerate(spans):
        edges.append((a, 1, -b, k))
        edges.append((b, 0, 0, k))
    edges.sort()
    out: dict = {}
    stack: list = []
    gi = 0
    prev = float("-inf")
    for t, opening, _, k in edges + [(float("inf"), 0, 0, -1)]:
        if t > prev:
            name = spans[stack[-1]][0] if stack else "outside any span"
            while gi < len(gaps) and gaps[gi][1] <= prev:
                gi += 1
            j = gi
            while j < len(gaps) and gaps[j][0] < t:
                a = max(gaps[j][0], prev)
                b = min(gaps[j][1], t)
                if b > a:
                    out[name] = out.get(name, 0.0) + (b - a)
                j += 1
        prev = t
        if k < 0:
            break
        if opening:
            stack.append(k)
        elif k in stack:
            stack.remove(k)
    return out


def top(d: dict, n: int = 10, width: int = 160) -> list:
    """The ``n`` largest entries of ``d`` as ``[name, seconds]``, names
    cut to ``width`` characters (a templated kernel's runs to
    thousands)."""
    return [[k[:width], v]
            for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
