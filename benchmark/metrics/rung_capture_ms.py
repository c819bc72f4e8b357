"""``rung_capture_ms``: milliseconds of ``wgl.graph-capture`` spans a
history (``ops/wgl.py`` ``_graph_waves``: a rung run's warm-up wave and
its CUDA-graph capture, one for every rung run of ``GRAPH_MIN_WAVES``
waves or more), over the histories checked before the profiler
started."""


def read(ctx):
    hs = ctx.untraced()
    if ctx.spans is None or not hs:
        return None
    s = sum(ctx.span_s(h, "wgl.graph-capture") for h in hs)
    return 1e3 * s / len(hs) if s else None
