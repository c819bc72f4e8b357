"""``elle_collect_ms``: milliseconds of ``elle.collect`` spans a history
(``checkers/elle/append.py``: the txns collected from the history, the
reads' internal checks and external prefixes, each key's version order
and the non-cycle anomalies), over the histories checked before the
profiler started."""


def read(ctx):
    hs = ctx.untraced()
    if ctx.spans is None or not hs:
        return None
    s = sum(ctx.span_s(h, "elle.collect") for h in hs)
    return 1e3 * s / len(hs) if s else None
