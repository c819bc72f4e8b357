"""``rung_eager_ms``: milliseconds of ``wgl.eager`` spans a history
(``ops/wgl.py`` ``_wgl_loop``: the waves the host launches op by op,
syncing every ``SYNC_EVERY``; rung runs too short for a graph, and the
tail after a run's last graphed batch), over the histories checked
before the profiler started."""


def read(ctx):
    hs = ctx.untraced()
    if ctx.spans is None or not hs:
        return None
    s = sum(ctx.span_s(h, "wgl.eager") for h in hs)
    return 1e3 * s / len(hs) if s else None
