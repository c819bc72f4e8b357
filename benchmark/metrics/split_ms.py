"""``split_ms``: milliseconds of ``independent.split`` spans a history
(``checkers/independent.py``: ``History.split_by_key``, the per-key
split), over the histories checked before the profiler started."""


def read(ctx):
    hs = ctx.untraced()
    if ctx.spans is None or not hs:
        return None
    s = sum(ctx.span_s(h, "independent.split") for h in hs)
    return 1e3 * s / len(hs) if s else None
