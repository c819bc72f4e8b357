"""Per-key checker decomposition (jepsen.independent/checker,
register.clj:108-113), the port of the reference's
``checkers/independent.py``.

Splits a (key, value)-tuple history into per-key sub-histories and runs
the wrapped checker on them. Sub-histories preserve op indices, so
reports point back into the full history. A batch-aware inner checker
(``TPULinearizableChecker``, or a ``Compose`` holding one) gets every
key in one ``check_batch`` call: one packing pass and one kernel launch
per key group, spread over the visible cards.
"""

from __future__ import annotations

from ..core.history import History
from ..runner import telemetry
from .core import Checker, _merge_valid, stream_hint


class Independent(Checker):
    def __init__(self, inner: Checker):
        self.inner = inner

    def check(self, test, history, opts=None) -> dict:
        h = history if isinstance(history, History) else History(history)
        # streaming reuse: the feed's per-key register packs were
        # extracted from this exact op stream (row-count + columns
        # guard in stream_hint). Validated HERE — the only place the
        # parent history is visible — and handed down via opts so the
        # batch checker can skip its own pack pass key-for-key.
        packs = stream_hint(test, h, "register_packs")
        if packs is not None:
            opts = dict(opts or {})
            opts["_stream_packs"] = packs
        # one pass over the parent history builds every per-key
        # subhistory; column-backed histories split as array slices and
        # stay column-backed into the batched packer
        tel = telemetry.current()
        with tel.span("independent.split"):
            subs = h.split_by_key()
        # the run's key fanout: how many per-key checks this split
        # produced
        tel.counter("independent.keys", len(subs))
        if hasattr(self.inner, "check_batch"):
            results = self.inner.check_batch(test, subs, opts)
        else:
            results = {k: self.inner.check(test, sub, opts)
                       for k, sub in subs.items()}
        return {
            "valid?": _merge_valid([r.get("valid?")
                                    for r in results.values()]),
            "key-count": len(results),
            "results": results,
        }


def independent_checker(inner: Checker) -> Independent:
    return Independent(inner)
