"""``verdict_p50_s``: the median seconds from a history's hand-off to
its verdict, over every history of the window: what one Jepsen user
waits after a run."""

import statistics


def read(ctx):
    lat = [h.latency_s for h in ctx.histories]
    return statistics.median(lat) if lat else None
