"""``device_idle_share``: the share of the traced window in which no
operation (kernel, copy or set) ran on the card, from
``torch.profiler``'s device trace."""


def read(ctx):
    d = ctx.device
    if d is None or d.window_s <= 0:
        return None
    return 100.0 * (1.0 - d.busy_s() / d.window_s)
