"""``ops_per_s``: history entries (invocations and completions)
brought to a verdict, over all the window's time: the checking
throughput of a campaign or a CI fleet."""


def read(ctx):
    done = sum(h.entries for h in ctx.histories if h.got is not None)
    return done / ctx.window_s if done else None
