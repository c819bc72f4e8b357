"""``dfs_ms``: milliseconds of ``oracle.dfs`` spans a history
(``checkers/linearizable.py`` ``check_history``: the native DFS, or its
Python twin, wherever the checker routes a key to it: the size cut-off,
the DFS-first band, a fallback, an overflow past the top rung,
``_finalize``'s diagnostics on a refuted key), over the histories
checked before the profiler started, a history with no DFS counting
0."""


def read(ctx):
    hs = ctx.untraced()
    if ctx.spans is None or not hs:
        return None
    s = sum(ctx.span_s(h, "oracle.dfs") for h in hs)
    return 1e3 * s / len(hs) if s else None
