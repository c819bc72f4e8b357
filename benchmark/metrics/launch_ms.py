"""``launch_ms``: milliseconds of ``mxu.launch`` spans a history
(``ops/wgl_mxu.py`` ``launch_packed_batch_mxu``: ``pack_perop_batch``,
the copies to the card, ``build_tables``, the enqueue; not the
kernel's time on the card)."""


def read(ctx):
    hs = ctx.untraced()
    if ctx.spans is None or not hs:
        return None
    s = sum(ctx.span_s(h, "mxu.launch") for h in hs)
    return 1e3 * s / len(hs) if s else None
