"""``rung_replay_idle_share``: the share of the time under
``wgl.graph-replay`` spans (``ops/wgl.py`` ``_graph_waves``: a rung
run's CUDA-graph replays and their syncs) in which no operation ran on
the card: the idle seconds whose innermost open span is
``wgl.graph-replay`` (``lib/trace.innermost`` over the traced window's
gaps) over the union of those spans clipped to the traced window. Idle
time there lies between a graph's kernels, or in the host's sync after
a replay; None where no replay falls in the window."""

from benchmark.lib.context import union_s
from benchmark.lib.trace import innermost

SPAN = "wgl.graph-replay"


def read(ctx):
    d = ctx.device
    if d is None or ctx.spans is None:
        return None
    under = union_s([(max(a, d.t0), min(b, d.t1))
                     for name, a, b in ctx.spans
                     if name == SPAN and min(b, d.t1) > max(a, d.t0)])
    if not under:
        return None
    idle = innermost(ctx.spans, d.gaps()).get(SPAN, 0.0)
    return 100.0 * idle / under
