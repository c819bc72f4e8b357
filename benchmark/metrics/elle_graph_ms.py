"""``elle_graph_ms``: milliseconds of ``elle.graph`` spans a history
(``checkers/elle/append.py``: the committed set, the ``DepGraph``'s ww,
wr and rw edges, and its realtime vectors), over the histories checked
before the profiler started."""


def read(ctx):
    hs = ctx.untraced()
    if ctx.spans is None or not hs:
        return None
    s = sum(ctx.span_s(h, "elle.graph") for h in hs)
    return 1e3 * s / len(hs) if s else None
