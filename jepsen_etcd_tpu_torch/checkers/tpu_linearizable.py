"""checker/tpu-linearizable on the port: the device wave search with a
sound CPU fallback (the counterpart of the reference's
``checkers/tpu_linearizable.py``, same module and class name, same
routing constants and verdict labels).

Binding analog of ``checker/linearizable`` (register.clj:110-112) with
the search on the card: the wave kernel (ops/wgl_mxu.py), then the
capacity ladder and the spill BFS (ops/wgl.py). Soundness contract: an
engine answers definitively only when its preconditions hold; anything
else falls back to the CPU oracle — the device path can be fast, it
must never be wrong.

With a checker service configured (``test["checker_service"]`` or
``JEPSEN_ETCD_TPU_CHECKER_SERVICE``; ``runner/checker_service.py``) the
device-bound packs ship to it and its verdicts come back to the same
``_finalize``; a dead service means the same packs are checked here.
"""

from __future__ import annotations

import functools
import logging
from typing import Optional

from ..device import resolve_device
from ..models import Mutex, VersionedRegister
from ..ops import wgl
from ..runner import telemetry
from .core import Checker
from .linearizable import check_history, history_entries

logger = logging.getLogger("jepsen_etcd_tpu_torch.checkers")


def _tally_engine(out: dict) -> dict:
    """Count which engine produced this verdict (``engine.mxu-wave``,
    ``engine.jnp-ladder``, ``engine.cpu-oracle``) into the run's
    telemetry."""
    telemetry.current().counter(
        "engine." + str(out.get("engine") or out.get("checker")
                        or "unknown"))
    return out

#: histories at or below this many entries (invoke + completion) route
#: to the native DFS before any device packing. Copied from the
#: reference so routing and verdict labels match; re-derived only from
#: measurements on the card.
CPU_CUTOFF = 512

#: mid-size band: up to here the DFS still gets first shot, with a
#: budget scaled to history size (copied from the reference)
DFS_FIRST_MAX = 13_000


class TPULinearizableChecker(Checker):
    """``device`` is where the search runs: ``cuda`` unless the caller
    passes another (``"cpu"`` runs the wave kernel's plain version and
    the ladder on the CPU). With no device named, ``check_batch``
    spreads its wave-kernel launches over every visible card, and a
    service-down fallback places its ladder groups as the service would
    (``checker_service.fallback_device_for``). ``f_max`` set skips the
    wave kernel and the service, and starts the ladder at that rung."""

    def __init__(self, model_fn=None, fallback: bool = True,
                 f_max: Optional[int] = None,
                 cpu_cutoff: Optional[int] = CPU_CUTOFF,
                 dfs_first_max: Optional[int] = DFS_FIRST_MAX,
                 device=None):
        self.model_fn = model_fn or (lambda: VersionedRegister(0, None))
        self.fallback = fallback
        self.f_max = f_max
        self.device = resolve_device(device)
        # the batched launch's lanes: the named device, or every card
        self.lanes_device = device
        # fallback=False means "I want the kernel's answer", so the
        # size cutoff only applies when CPU routing is allowed at all
        self.cpu_cutoff = cpu_cutoff if fallback else None
        # the mid band rides on the cutoff
        self.dfs_first_max = dfs_first_max if self.cpu_cutoff else None

    #: cutoff-DFS budget: the "cheap shot" size (same cap _fallback uses
    #: for blowup histories)
    CUTOFF_MAX_CONFIGS = 1_000_000
    #: check_history's default budget: what _fallback spends when the
    #: kernel can't take a history at all
    FALLBACK_MAX_CONFIGS = 5_000_000

    def _small_history_check(
            self, history, band: Optional[int] = None
    ) -> tuple[Optional[dict], Optional[dict], int]:
        """Size-cutoff routing: below CPU_CUTOFF the native DFS goes
        first; up to the mid-size band (``band``, by default the larger
        of the cutoff and DFS_FIRST_MAX) it still goes first with a
        size-scaled budget. Returns (result, unknown, budget): result is
        the definitive answer or None; unknown carries a
        budget-exhausted verdict with the budget it spent."""
        n = len(history)
        if band is None:
            band = max(self.cpu_cutoff or 0, self.dfs_first_max or 0)
        if not self.cpu_cutoff or n > band:
            return None, None, 0
        if n <= self.cpu_cutoff:
            budget = self.CUTOFF_MAX_CONFIGS
        else:
            # a valid history's witness costs ~R = n/2 configs, so
            # 4n + 10k is ~8x that with floor headroom
            budget = 4 * n + 10_000
        out = check_history(self.model_fn(), history, max_configs=budget)
        out["checker"] = "cpu-oracle"
        out["engine-route"] = "size-cutoff"
        if out["valid?"] == "unknown":
            return None, out, budget
        # report the indefinite-entry count like the kernel result does
        entries = history_entries(history) or []
        out.setdefault("info-ops",
                       sum(1 for e in entries if not e.required))
        return out, None, budget

    def _pack_fn(self):
        """The kernel packing for this model, or None for CPU-only
        models (a mutex IS a two-value CAS register)."""
        m = self.model_fn()
        if m == VersionedRegister(0, None):
            return wgl.pack_register_history
        if m == Mutex(False):
            return wgl.pack_mutex_history
        return None

    def _pack_batch_fn(self):
        """Batched form of _pack_fn: one columnar packing pass over a
        keyed dict of subhistories. None for CPU-only models."""
        m = self.model_fn()
        if m == VersionedRegister(0, None):
            return wgl.pack_register_histories_batched
        if m == Mutex(False):
            return functools.partial(wgl.pack_register_histories_batched,
                                     adapter=wgl.mutex_adapter)
        return None

    def _service_check(self, test, packs: list) -> Optional[list]:
        """Ship device-bound packs to the checker service when one is
        configured, returning verdicts aligned with packs — or None,
        meaning "check in-process" (counted as ``service.fallback``).
        Only device-bound work ships: the size-cutoff routing ran before
        packing, and the diagnostics, overflow DFS and fallback ladder
        all run here on what comes back (``_finalize``)."""
        from ..runner import checker_service as svc
        if svc.endpoint_for(test) is None:
            return None
        client = svc.client_for(test)
        tel = telemetry.current()
        # the run's trace id rides with the packs: the service stamps it
        # on the tick span, so the shipped == submitted ledger joins
        # per run
        outs = client.check(packs, trace=tel.trace) \
            if client is not None else None
        if outs is None:
            tel.counter("service.fallback")
        else:
            # producer-side ledger: summed over a campaign's runs,
            # service.shipped equals the service's service.submitted
            tel.counter("service.checks")
            tel.counter("service.shipped", len(packs))
            wait = getattr(client, "last_queue_wait_s", None)
            if wait is not None:
                tel.counter("service.queue_wait_s", wait)
                tel.hist("service.queue_wait_s", wait)
        return outs

    def _fallback_placement(self, test):
        """The ``group_key -> device`` callback of a service-down
        fallback (the service's sticky placement over every lane), or
        None: no service configured, a device named by the caller, or
        fewer than two lanes."""
        from ..runner import checker_service as svc
        if self.lanes_device is not None or svc.endpoint_for(test) is None:
            return None
        return svc.fallback_device_for(telemetry.current())

    def _finalize(self, history, out: dict, pack, band) -> dict:
        """Post-process one kernel verdict into a checker result,
        attaching CPU counterexample diagnostics / fallback as needed."""
        if out["valid?"] is True:
            out["checker"] = "tpu-wgl"
            return out
        if out["valid?"] is False:
            # attach the counterexample diagnostics (offending op,
            # model error) the CPU oracle produces
            out["checker"] = "tpu-wgl"
            cpu = check_history(self.model_fn(), history)
            for k in ("op", "error", "max-linearized"):
                if k in cpu:
                    out[k] = cpu[k]
            return out
        if out.get("overflow"):
            return self._overflow(history, pack, out)
        return self._fallback_after_band(
            history, out.get("reason", "unknown"),
            bool(out.get("blowup")), band[1], band[2])

    def _overflow(self, history, pack, out: dict) -> dict:
        """Top-rung frontier overflow: a DFS needs only one witness
        path where the BFS carries the whole frontier, so the CPU oracle
        goes first; the budgeted spill BFS, resumed from the frozen
        frontier, is the complete last resort."""
        resume = out.pop("_resume", None)
        cpu = self._fallback(history, out.get("reason", "overflow"))
        if cpu["valid?"] != "unknown":
            return cpu
        if resume is not None:
            out2 = wgl.spill_packed(pack, *resume)
        else:
            # a service verdict: its frozen frontier stayed there, so
            # the search runs again here, spill included
            out2 = wgl.check_packed(pack, f_max=self.f_max, spill=True,
                                    device=self.device)
        # no diagnostics DFS here: the DFS just exhausted its budget
        out2["checker"] = "tpu-wgl"
        if out2["valid?"] == "unknown":
            out2["dfs-also-unknown"] = True
        return out2

    def _fallback_budget(self, blowup: bool) -> int:
        """The ONE definition of what _fallback spends: blowup gets the
        cheap shot, else the full budget."""
        return self.CUTOFF_MAX_CONFIGS if blowup \
            else self.FALLBACK_MAX_CONFIGS

    def _fallback(self, history, reason: str,
                  blowup: bool = False) -> dict:
        if not self.fallback:
            return {"valid?": "unknown", "reason": reason,
                    "checker": "tpu-wgl"}
        logger.debug("device path unavailable (%s); CPU oracle", reason)
        out = check_history(self.model_fn(), history,
                            max_configs=self._fallback_budget(blowup))
        out["checker"] = "cpu-oracle"
        out["tpu-fallback-reason"] = reason
        return out

    def _fallback_after_band(self, history, reason: str, blowup: bool,
                             small_unknown: Optional[dict],
                             band_budget: int) -> dict:
        """The kernel can't take this history; fall back to the CPU —
        but skip the fallback DFS when the band search already spent at
        least what _fallback would."""
        if small_unknown is not None and \
                band_budget >= self._fallback_budget(blowup):
            small_unknown["tpu-fallback-reason"] = reason
            return small_unknown
        return self._fallback(history, reason, blowup=blowup)

    def check(self, test, history, opts=None, _band=None) -> dict:
        return _tally_engine(self._check(test, history, opts, _band))

    def _check(self, test, history, opts=None, _band=None) -> dict:
        small, small_unknown, band_budget = \
            self._small_history_check(history) if _band is None else _band
        if small is not None:
            return small
        pack = self._pack_fn()
        if pack is None:
            return self._fallback_after_band(
                history, "model has no kernel packing", False,
                small_unknown, band_budget)
        with telemetry.current().span("wgl.pack", ops=len(history)):
            p = pack(history)
        if not p.ok:
            return self._fallback_after_band(
                history, p.reason, bool(p.blowup),
                small_unknown, band_budget)
        if p.I > 0 and self.cpu_cutoff and small_unknown is None \
                and len(history) > (self.dfs_first_max or 0):
            # info-op histories can't run on the wave kernel and the
            # ladder is slower than the DFS on them, so the DFS-first
            # band extends to ANY size when infos are present
            cpu = check_history(self.model_fn(), history,
                                max_configs=self.FALLBACK_MAX_CONFIGS)
            if cpu["valid?"] != "unknown":
                cpu["checker"] = "cpu-oracle"
                cpu["engine-route"] = "info-dfs-first"
                return cpu
            small_unknown, band_budget = cpu, self.FALLBACK_MAX_CONFIGS
        # with a fallback available, the spill BFS waits until the DFS
        # has had its (cheaper) shot — see _overflow. The service rides
        # the same deferral (its batch runs spill=False), so it is only
        # tried when a fallback exists
        out = None
        svc_tried = self.f_max is None and self.fallback
        if svc_tried:
            svc_outs = self._service_check(test, [p])
            if svc_outs is not None:
                out = svc_outs[0]
        if out is None:
            device = self.device
            dev_for = self._fallback_placement(test) if svc_tried else None
            if dev_for is not None:
                device = dev_for(wgl.group_key(p))
            out = wgl.check_packed(p, f_max=self.f_max,
                                   spill=not self.fallback, device=device)
        return self._finalize(history, out, pack=p,
                              band=(None, small_unknown, band_budget))

    def check_batch(self, test, subhistories: dict, opts=None) -> dict:
        """Check many per-key histories (called by checkers.Independent):
        the keys the native DFS answers in milliseconds stay on the CPU;
        the rest pack in one columnar pass, go to the wave kernel in one
        launch per lane per (R-bucket, width) group, all launched before
        one readback, and the keys it cannot take or that overflow ride
        the batched ladder. Each verdict is finalized per key."""
        results: dict = {}
        big_keys = []
        bands: dict = {}
        # the mid-size band pays in a batch only when few keys would
        # reach the launch: with more than 8 keys past the cutoff the
        # band collapses to CPU_CUTOFF (the reference's rule)
        mid_count = sum(1 for h in subhistories.values()
                        if len(h) > (self.cpu_cutoff or 0))
        batch_band = None if mid_count <= 8 else (self.cpu_cutoff or 0)
        for k in subhistories:
            band = self._small_history_check(subhistories[k],
                                             band=batch_band)
            if band[0] is not None:
                results[k] = _tally_engine(band[0])
            else:
                big_keys.append(k)
                bands[k] = band
        if not big_keys:
            return results
        pack_batch = self._pack_batch_fn()
        if pack_batch is None:
            results.update({k: self.check(test, subhistories[k], opts,
                                          _band=bands[k])
                            for k in big_keys})
            return results
        packs_hint = (opts or {}).get("_stream_packs")
        if packs_hint is not None and \
                all(k in packs_hint for k in big_keys):
            # streaming reuse: the feed already packed every key from
            # the same op stream (per-key packs are independent of the
            # batch they were packed in, so this subset is exactly what
            # pack_batch would have produced)
            telemetry.current().counter("stream.pack_reuse",
                                        len(big_keys))
            packed = {k: packs_hint[k] for k in big_keys}
        else:
            with telemetry.current().span("wgl.pack-batch",
                                          keys=len(big_keys)):
                packed = pack_batch({k: subhistories[k]
                                     for k in big_keys})
        packs = [packed[k] for k in big_keys]
        # campaign mode: the checker service coalesces these packs with
        # every other run's into one dispatch per group per tick
        svc_outs = self._service_check(test, packs) \
            if self.f_max is None else None
        if svc_outs is not None:
            outs = svc_outs
        else:
            outs = self._check_packs_here(test, packs)
        # unpackable keys come back "unknown" with the pack reason;
        # _finalize routes those through the CPU fallback and top-rung
        # overflows through the DFS-then-spill ordering
        results.update({k: _tally_engine(
                            self._finalize(subhistories[k], out, pack=p,
                                           band=bands[k]))
                        for (k, out, p) in zip(big_keys, outs, packs)})
        return results

    def _check_packs_here(self, test, packs: list) -> list:
        """The in-process device path of ``check_batch``: the wave
        kernel over every pack (one launch per lane per group, all
        launched before one readback), then the batched ladder for the
        keys it could not take (info ops, wide ids) or whose frontier
        overflowed."""
        outs: list = [None] * len(packs)
        device_for = None
        if self.f_max is None:
            from ..ops import wgl_mxu
            device_for = self._fallback_placement(test)
            wgl_mxu.collect_packed_batch_mxu(
                wgl_mxu.launch_packed_batch_mxu(
                    packs, device=self.lanes_device), outs)
        rest = [i for i, out in enumerate(outs)
                if out is None or out.get("overflow")]
        if rest:
            rest_outs = wgl.check_packed_batch(
                [packs[i] for i in rest], f_max=self.f_max,
                try_fused=False,
                device=None if device_for is not None else self.device,
                device_for=device_for)
            for i, out in zip(rest, rest_outs):
                outs[i] = out
        return outs


def tpu_linearizable(model_fn=None, device=None) -> TPULinearizableChecker:
    return TPULinearizableChecker(model_fn, device=device)
