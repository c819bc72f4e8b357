"""``session_ms``: milliseconds of ``checker:session`` spans
(``checkers/session.py``) a history."""


def read(ctx):
    hs = ctx.untraced()
    if ctx.spans is None or not hs:
        return None
    s = sum(ctx.span_s(h, "checker:session") for h in hs)
    return 1e3 * s / len(hs) if s else None
