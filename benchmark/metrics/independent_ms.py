"""``independent_ms``: milliseconds a history spends outside the two
checkers, in ``checkers/independent.py`` and ``History.split_by_key``
(the split and the merge): each check's wall less its
``checker:linear`` and ``checker:session`` spans, averaged over the
histories checked before the profiler started (``ctx.untraced``), as
every span reader here is."""


def read(ctx):
    hs = ctx.untraced()
    if ctx.spans is None or not hs:
        return None
    rest = [h.latency_s - ctx.span_s(h, "checker:linear")
            - ctx.span_s(h, "checker:session") for h in hs]
    return 1e3 * sum(rest) / len(rest)
