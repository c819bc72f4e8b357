"""``closure_ms``: milliseconds of ``closure.device`` spans a history
(``ops/closure.py`` ``closure_levels_lazy``: the six Adya planes built
on the card from the edge lists and the realtime vectors, squared to
their fixpoint, ``on_cycle`` copied back), over the histories checked
before the profiler started."""


def read(ctx):
    hs = ctx.untraced()
    if ctx.spans is None or not hs:
        return None
    s = sum(ctx.span_s(h, "closure.device") for h in hs)
    return 1e3 * s / len(hs) if s else None
