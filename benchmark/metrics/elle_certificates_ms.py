"""``elle_certificates_ms``: milliseconds of ``elle.certificates``
spans a history (``checkers/elle/graph.py`` ``find_cycles`` after the
closure: the reach matrix copied back and the anchored searches where
a level has a cycle, little else on a valid history), over the
histories checked before the profiler started, a history with none
counting 0."""


def read(ctx):
    hs = ctx.untraced()
    if ctx.spans is None or not hs:
        return None
    spans = [ctx.spans_in(h, "elle.certificates") for h in hs]
    if not any(spans):
        return None
    return 1e3 * sum(b - a for s in spans for a, b in s) / len(hs)
