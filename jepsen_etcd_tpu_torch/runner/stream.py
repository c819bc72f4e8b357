"""Streaming online checking (the port of the reference's
``runner/stream.py``): feed recorded op columns to checker front-ends
while generation is still running, and the fused gen->check pipeline.

``StreamFeed`` attaches to the interpreter's ``ColumnsBuilder`` and,
every ``chunk_ops`` recorded events, drains a columnar chunk
(``take_chunk``) onto a worker thread that advances per-workload
incremental consumers — the resumable register pack extractor
(``ops.wgl.PackStream``) and the set scan (``checkers.set_full.
ColumnScan``). When the run ends, ``finish()`` finalizes the consumers
and installs their artifacts as reuse hints on ``test["_stream"]``.

Bit-identity contract: streaming consumers only ever produce REUSE
HINTS — precomputed artifacts the post-hoc checkers validate (row
count against the final history, key coverage) and then consume in
place of their own scan/pack pass. Every decision phase runs the exact
post-hoc code, so verdicts are bit-identical with hints present,
absent, or half-fed; a consumer that trips on a malformed stream
simply withdraws its hint and the checker recomputes from scratch.
The consumers are host code; the register packs they hand over go to
the wave kernel on the checker's device as post-hoc packs would.

Overlap: the simulator's generator loop is CPU-bound Python, so under
the GIL a streamed consumer mostly interleaves with generation instead
of running beside it. What streaming buys is ``phase:check`` without
its scan/pack pass: the artifacts are ready the moment generation ends.

``FusedPipeline`` is the device-resident leg: the epoch-v3 generator
(simbatch/engine_v3.py) produces seed sub-batches while a consumer
thread packs each finished history (``PackStream`` fed columnar row
slices) and advances ``check_prefix`` frontiers. Both legs spend their
hot loops on the device, where the GIL is released, so one cell's wall
approaches max(gen, check) instead of gen + check. The packs and the
chunked ladder are bit-identical to their one-shot forms, so the
pipeline changes WHEN checking happens, never what it concludes.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Optional

from . import telemetry

logger = logging.getLogger("jepsen_etcd_tpu_torch.run")

DEFAULT_CHUNK_OPS = 1024

#: join bound for the worker at finish; a wedged consumer must not
#: hang the run — the feed just withdraws its hints past this
JOIN_TIMEOUT_S = 300.0


class StreamFeed:
    """One run's streaming pipeline: chunk pump + consumer worker."""

    def __init__(self, test: dict, chunk_ops: int = DEFAULT_CHUNK_OPS):
        self.test = test
        self.chunk_ops = max(1, int(chunk_ops or DEFAULT_CHUNK_OPS))
        self.columns = None           # the interpreter's ColumnsBuilder
        self._since = 0               # ops recorded since last flush
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self.chunks = 0
        self.rows = 0                 # rows consumed by the worker
        self.backlog_peak = 0
        self.error: Optional[BaseException] = None
        # set under _cv when finish() gives up on a wedged worker; the
        # worker must not install finalize results past this point
        self._abandoned = False
        # per-workload consumers, created lazily on the worker thread
        wl = test.get("workload") if isinstance(test, dict) else None
        self._want_pack = wl == "register"
        self._want_scan = wl == "set"
        self._pack = None             # ops.wgl.PackStream
        self._scan = None             # checkers.set_full.ColumnScan
        self._pack_result = None
        self._scan_result = None

    # -- producer side (interpreter loop) ------------------------------------

    def attach(self, columns: Any) -> None:
        """Bind the interpreter's ColumnsBuilder and start the worker."""
        self.columns = columns
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._worker, name="stream-checker", daemon=True)
            self._thread.start()

    def on_record(self) -> None:
        """Per-op tick from the interpreter's record(); flushes a chunk
        every ``chunk_ops`` events. O(1) between flushes."""
        self._since += 1
        if self._since >= self.chunk_ops:
            self._since = 0
            self._flush()

    def _flush(self) -> None:
        if self.columns is None:
            return
        cols = self.columns.take_chunk()
        if cols is None or len(cols) == 0:
            return
        with self._cv:
            # enqueue stamp feeds the stream.chunk_lag_s histogram
            # (host wall time only — never reaches history/verdict)
            self._q.append((cols, time.monotonic()))
            if len(self._q) > self.backlog_peak:
                self.backlog_peak = len(self._q)
            self._cv.notify()

    # -- consumer side (worker thread) ---------------------------------------

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait()
                if not self._q and self._closed:
                    break
                cols, t_enq = self._q.popleft()
            lag = time.monotonic() - t_enq
            telemetry.current().hist("stream.chunk_lag_s", lag)
            try:
                self._consume(cols)
            except BaseException as e:  # withdraw hints, never crash a run
                logger.warning("stream consumer failed; hints withdrawn",
                               exc_info=True)
                with self._cv:
                    self.error = e
                    self._pack = self._scan = None
                    self._want_pack = self._want_scan = False
        try:
            self._finalize_consumers()
        except BaseException as e:
            logger.warning("stream finalize failed; hints withdrawn",
                           exc_info=True)
            with self._cv:
                self.error = e
                self._pack_result = self._scan_result = None

    def _consume(self, cols: Any) -> None:
        tel = telemetry.current()
        with tel.span("stream.chunk", rows=len(cols)):
            if self._want_pack:
                if self._pack is None:
                    from ..ops.wgl import PackStream
                    with self._cv:
                        self._pack = PackStream()
                self._pack.feed(cols)
            if self._want_scan:
                if self._scan is None:
                    from ..checkers.set_full import ColumnScan
                    with self._cv:
                        self._scan = ColumnScan()
                try:
                    self._scan.feed(cols)
                except Exception:  # _NonColumnar rows: scan withdrawn
                    with self._cv:
                        self._scan = None
                        self._want_scan = False
        with self._cv:
            self.chunks += 1
            self.rows += len(cols)
        tel.counter("stream.chunks")
        tel.counter("stream.flushed_events", len(cols))

    def _finalize_consumers(self) -> None:
        tel = telemetry.current()
        pack_result = scan_result = None
        if self._pack is not None:
            with tel.span("stream.finalize", kind="register-pack"):
                pack_result = self._pack.finish()  # None if bad
        if self._scan is not None:
            with tel.span("stream.finalize", kind="set-scan"):
                scan_result = self._scan.finish()
        # a worker that wedged past finish()'s join bound must not
        # install results the run already declared withdrawn
        with self._cv:
            if not self._abandoned:
                self._pack_result = pack_result
                self._scan_result = scan_result

    # -- epilogue (runner, after generation) ---------------------------------

    def finish(self, history: Any) -> dict:
        """Drain the tail, join the worker, validate, and install the
        hint map as ``test["_stream"]``. Returns the hint map."""
        self._flush()
        with self._cv:
            self._closed = True
            self._cv.notify()
        if self._thread is not None:
            self._thread.join(timeout=JOIN_TIMEOUT_S)
            if self._thread.is_alive():
                logger.warning("stream worker did not drain in %.0fs; "
                               "hints withdrawn", JOIN_TIMEOUT_S)
                with self._cv:
                    self._abandoned = True
                    self._pack_result = self._scan_result = None
        tel = telemetry.current()
        # snapshot under the lock: a worker alive past the join bound
        # must not mutate what this epilogue publishes
        with self._cv:
            error = self.error
            chunks, rows = self.chunks, self.rows
            pack_result = self._pack_result
            scan_result = self._scan_result
        tel.counter("stream.backlog_peak", self.backlog_peak, mode="max")
        hints: dict = {"stats": {"chunks": chunks,
                                 "rows": rows,
                                 "backlog_peak": self.backlog_peak,
                                 "chunk_ops": self.chunk_ops}}
        # hints are only safe when the worker consumed the WHOLE
        # recorded stream — a partial feed (error, wedged worker) must
        # not masquerade as the full history's artifacts
        if error is None and rows == len(history):
            if pack_result is not None:
                hints["register_packs"] = (pack_result, rows)
            if scan_result is not None:
                hints["set_scan"] = (scan_result, rows)
        self.test["_stream"] = hints
        return hints


# ---------------------------------------------------------------------------
# fused gen->check pipeline (device-resident leg)


def _slice_columns(cols: Any, lo: int, hi: int) -> Any:
    """Row slice ``[lo, hi)`` of an OpColumns as a standalone
    OpColumns: typed arrays slice as views, the values list copies its
    window, and the sparse extras/missing dicts re-key to the slice's
    local row numbers. Tables are shared by reference — a slice is a
    chunk of the SAME stream, exactly what ``ColumnsBuilder.
    take_chunk`` hands a streaming consumer."""
    from ..core.history import OpColumns

    lo = max(0, int(lo))
    hi = min(len(cols), int(hi))
    return OpColumns(
        cols.type_code[lo:hi], cols.f_code[lo:hi], cols.proc[lo:hi],
        cols.key_id[lo:hi], cols.time[lo:hi], cols.index[lo:hi],
        cols.values[lo:hi],
        {r - lo: v for r, v in cols.extras.items() if lo <= r < hi},
        {r - lo: v for r, v in cols.missing.items() if lo <= r < hi},
        cols.f_table, cols.key_table, cols.proc_table)


class FusedPipeline:
    """One campaign cell's gen->check overlap: the epoch-v3 generator
    produces seed sub-batches while a consumer thread packs each
    finished history and advances ``check_prefix`` frontiers, both on
    ``device`` (``cuda`` unless named).

    The producer (caller thread) runs ``generate_jax`` per sub-batch
    and enqueues finished histories; the consumer drains them — each
    history chunk-feeds a fresh ``PackStream`` (columnar row slices),
    ``finish()`` yields the per-key packs, and every pack's frontier
    advances through the chunked ladder until done.

    Verdict soundness is inherited, not re-argued: packs and the
    chunked ladder are bit-identical to their one-shot forms, so a
    fused cell's verdicts match the sequential cell's exactly."""

    def __init__(self, opts: dict, sub_batch: int = 4,
                 chunk_rows: int = DEFAULT_CHUNK_OPS,
                 max_waves: int = 256, device=None):
        from ..device import resolve_device
        from ..simbatch import BatchConfig

        if opts.get("workload", "register") != "register":
            raise ValueError("FusedPipeline checks register packs; "
                             f"workload {opts.get('workload')!r} has no "
                             "packable per-key decomposition")
        self.device = resolve_device(device)
        self.opts = dict(opts, gen_epoch="epoch-v3")
        self.config = BatchConfig.from_opts(self.opts)
        self.sub_batch = max(1, int(sub_batch))
        self.chunk_rows = max(1, int(chunk_rows))
        self.max_waves = max(1, int(max_waves))
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._done_producing = False
        self.gen_s = 0.0              # producer busy wall
        self.check_s = 0.0            # consumer busy wall
        self.e2e_s = 0.0
        self.verdicts: list = []      # (seed, bool) in completion order
        self.packs = 0
        self.waves = 0
        self.error: Optional[BaseException] = None

    # -- consumer leg ---------------------------------------------------------

    def _check_history(self, seed: int, history: Any) -> tuple:
        """One history's pack + frontier walk: ``(verdict, packs,
        waves)``. Pure accounting return — shared state stays with the
        caller, so the consumer thread can batch its publication."""
        from ..ops.wgl import PackStream, check_prefix

        cols = history.columns
        ps = PackStream()
        for lo in range(0, len(cols), self.chunk_rows):
            ps.feed(_slice_columns(cols, lo, lo + self.chunk_rows))
        packs = ps.finish()
        if packs is None:
            return "unknown", 0, 0
        vs = []
        waves = 0
        for p in packs.values():
            state = check_prefix(p, None, max_waves=self.max_waves,
                                 device=self.device)
            while not state.done:
                state = check_prefix(p, state,
                                     max_waves=self.max_waves)
            waves += state.waves_run
            vs.append(state.result.get("valid?"))
        # False dominates (a real violation), then unknown, then True
        verdict = (False if any(v is False for v in vs)
                   else "unknown" if any(v is not True for v in vs)
                   else True)
        return verdict, len(packs), waves

    def _consumer(self) -> None:
        tel = telemetry.current()
        verdicts: list = []
        packs = waves = 0
        busy = 0.0
        try:
            while True:
                with self._cv:
                    while not self._q and not self._done_producing:
                        self._cv.wait()
                    if not self._q and self._done_producing:
                        return
                    seed, history = self._q.popleft()
                t0 = time.monotonic()
                try:
                    with tel.span("fused.check", seed=seed):
                        v, n_packs, n_waves = self._check_history(
                            seed, history)
                    verdicts.append((seed, v))
                    packs += n_packs
                    waves += n_waves
                except BaseException as e:
                    with self._cv:
                        self.error = e
                    logger.warning("fused consumer failed",
                                   exc_info=True)
                    return
                finally:
                    busy += time.monotonic() - t0
        finally:
            # publish the thread-local accounting once, under the lock
            # (run() only reads after join, but the lock keeps the
            # cross-thread hand-off explicit)
            with self._cv:
                self.verdicts.extend(verdicts)
                self.packs += packs
                self.waves += waves
                self.check_s += busy

    # -- producer leg (caller thread) -----------------------------------------

    def run(self, seeds) -> dict:
        """Generate + check every seed, overlapped; returns the timing
        summary (``ratio`` is e2e over the busier leg)."""
        from ..simbatch.engine_v3 import generate_jax

        seeds = [int(s) for s in seeds]
        tel = telemetry.current()
        worker = threading.Thread(target=self._consumer,
                                  name="fused-checker", daemon=True)
        t_start = time.monotonic()
        worker.start()
        try:
            for i in range(0, len(seeds), self.sub_batch):
                sub = seeds[i:i + self.sub_batch]
                t0 = time.monotonic()
                with tel.span("fused.gen", seeds=len(sub)):
                    out = generate_jax(self.config, sub,
                                       device=self.device)
                self.gen_s += time.monotonic() - t0
                with self._cv:
                    for sd, h in zip(sub, out["histories"]):
                        self._q.append((sd, h))
                    self._cv.notify()
        finally:
            with self._cv:
                self._done_producing = True
                self._cv.notify()
            worker.join()
        self.e2e_s = time.monotonic() - t_start
        if self.error is not None:
            raise self.error
        tel.counter("fused.seeds", len(seeds))
        tel.counter("fused.packs", self.packs)
        tel.counter("fused.waves", self.waves)
        floor = max(self.gen_s, self.check_s) or 1e-9
        return {"seeds": len(seeds), "gen_s": self.gen_s,
                "check_s": self.check_s, "e2e_s": self.e2e_s,
                "ratio": self.e2e_s / floor,
                "packs": self.packs, "waves": self.waves,
                "verdicts": dict(self.verdicts)}
