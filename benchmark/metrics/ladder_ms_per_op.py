"""``ladder_ms_per_op``: milliseconds on the ladder (``ops/wgl.py``
``check_packed_batch``: the batched rung, ``wgl.batch-dispatch``, and
the lone ladders, ``wgl.check_packed``; the union of their spans, which
nest where a key overflows the batched rung) per op that the keys
holding an :info op must linearize, counted from their histories
(``lib/work.py``): B1 cannot take such a key, and in a history of more
than eight keys the checker sends it to the ladder."""

from benchmark.lib.context import union_s
from benchmark.lib.work import steps


def read(ctx):
    hs = ctx.untraced()
    if ctx.spans is None:
        return None
    spans = [iv for h in hs
             for name in ("wgl.batch-dispatch", "wgl.check_packed")
             for iv in ctx.spans_in(h, name)]
    memo = {}
    ops = 0
    for h in hs:
        for k, e in zip(h.keys, h.exp):
            if k.name not in memo:
                memo[k.name] = steps(k.ops, None if e["linear"]
                                     else e["depth"]) \
                    if any(o["type"] == "info" for o in k.ops) else 0
            ops += memo[k.name]
    if not spans or not ops:
        return None
    return 1e3 * union_s(spans) / ops
