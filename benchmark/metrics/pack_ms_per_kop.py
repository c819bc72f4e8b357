"""``pack_ms_per_kop``: milliseconds of ``wgl.pack-batch`` spans (the
batched pack, ``ops/wgl.py`` ``pack_register_histories_batched``) per
thousand entries of the keys it packed: every key not answered by the
native DFS's size cut-off."""


def read(ctx):
    hs = ctx.untraced()
    if ctx.spans is None:
        return None
    pack_s = sum(ctx.span_s(h, "wgl.pack-batch") for h in hs)
    entries = sum(len(k) for h in hs if h.got is not None
                  for k, g in zip(h.keys, h.got["keys"])
                  if g is not None and g["route"] != "size-cutoff")
    if not pack_s or not entries:
        return None
    return 1e3 * pack_s / (entries / 1e3)
