"""The fused gen->check pipeline (the port of the reference's
``runner/stream.py``: ``_slice_columns``, ``DEFAULT_CHUNK_OPS`` and
``FusedPipeline``; ``StreamFeed`` is not ported yet).

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
