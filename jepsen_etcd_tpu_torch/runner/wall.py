"""A wall-clock loop with the SimLoop API: the bridge to real SUTs.

The simulated stack runs on virtual time (runner/sim.py). Driving a
*real* etcd (client/etcd_http.py) needs real time and real I/O, but the
interpreter, generators, and clients only speak the narrow SimLoop
surface (``now``/``spawn``/``call_later``/``sleep``/``rng``) — so a
wall-clock implementation of that same surface lets the whole harness
run unchanged against a live cluster, the way the reference harness
drives its cluster over wall-clock JVM threads (README:3-4).

Blocking I/O (HTTP requests to etcd's gRPC gateway) runs on a thread
pool via ``run_in_thread``; completions re-enter the loop through
``call_soon_threadsafe``. Timers fire when the monotonic clock passes
them. Determinism is intentionally NOT promised here — that is the sim
loop's job; this loop exists so the same tests can also run against
reality.
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional

from .sim import Future, SimLoop


class WallLoop(SimLoop):
    def __init__(self, seed: int = 0, pool_size: int = 32):
        super().__init__(seed=seed)
        self._cond = threading.Condition()
        self._external: deque = deque()
        self._t0 = time.monotonic_ns()
        self._pool = ThreadPoolExecutor(max_workers=pool_size)
        self._in_flight = 0  # pool submissions whose callback hasn't run

    def _wall(self) -> int:
        return time.monotonic_ns() - self._t0

    # -- cross-thread entry points ------------------------------------------

    def call_soon_threadsafe(self, cb: Callable, *args: Any) -> None:
        with self._cond:
            self._external.append((cb, args))
            self._cond.notify()

    def run_in_thread(self, fn: Callable, *args: Any,
                      **kwargs: Any) -> Future:
        """Run blocking fn on the pool; resolve a loop Future with its
        result (exceptions propagate)."""
        fut = self.future()
        with self._cond:
            self._in_flight += 1

        def _finish(resolve, value):
            with self._cond:
                self._in_flight -= 1
            resolve(value)

        def work():
            try:
                r = fn(*args, **kwargs)
            except BaseException as e:
                self.call_soon_threadsafe(_finish, fut.set_exception, e)
            else:
                self.call_soon_threadsafe(_finish, fut.set_result, r)

        self._pool.submit(work)
        return fut

    # -- the loop ------------------------------------------------------------

    def run(self, until: Optional[Future] = None,
            max_time: Optional[int] = None) -> Any:
        while True:
            # externals first (I/O completions)
            while True:
                with self._cond:
                    if not self._external:
                        break
                    cb, args = self._external.popleft()
                self.now = self._wall()
                cb(*args)
            # due timers
            while self._heap and self._heap[0][0] <= self._wall():
                entry = heapq.heappop(self._heap)
                t, _, cb, args = entry
                if cb is None:
                    self._dead -= 1
                    continue  # cancelled
                self.now = max(self._wall(), t)
                cb(*args)
            if until is not None and until.done:
                return until.result()
            if max_time is not None and self._wall() >= max_time:
                self.now = self._wall()
                return None
            with self._cond:
                if self._external:
                    continue
                while self._heap and self._heap[0][2] is None:
                    heapq.heappop(self._heap)  # drop cancelled heads
                    self._dead -= 1
                # idle only when no timers AND no pool work in flight:
                # a pending run_in_thread completion arrives via
                # call_soon_threadsafe and must not be dropped by an
                # early exit
                if not self._heap and self._in_flight == 0 \
                        and until is None:
                    return None
                timeout = 0.1  # bounded: external work may arrive anytime
                if self._heap:
                    timeout = min(
                        timeout,
                        max(0.0, (self._heap[0][0] - self._wall()) / 1e9))
                self._cond.wait(timeout=timeout)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
