"""``frames_ms``: milliseconds of ``wgl.frames`` spans a history
(``ops/wgl.py`` ``ensure_frames``: a key's [R, W], [R, W, W] and
[R, I] frame tables built in numpy on the host, inside the ladder's
``wgl.tables``), over the histories checked before the profiler
started."""


def read(ctx):
    hs = ctx.untraced()
    if ctx.spans is None or not hs:
        return None
    s = sum(ctx.span_s(h, "wgl.frames") for h in hs)
    return 1e3 * s / len(hs) if s else None
