"""``rung_kernel_roofline``: the share of the least time the ladder's
search needs that the rung kernel (``csrc/wgl_rung.cu``) took, over the
keys the ladder decided (``engine`` ``jnp-ladder``) in the traced
window.

The work is ``wgl_wave_roofline``'s count of B1's (its ``work``, from
``lib/work.py``), so it is the same whatever implements the rung: as
many waves as ops must linearize, each trying every op of the window.
The least time is the larger of the operations over the card's 32-bit
peak and the bytes over its memory bandwidth (``lib/peaks.py``). The
kernel's time is the profiler's, summed over its launches inside those
keys' histories. Where a ``wgl.graph-replay`` or ``wgl.eager`` span
lies in one of those histories, some rung run left the kernel, and the
share reads None.
"""

from benchmark.metrics.wgl_wave_roofline import work

KERNEL = "wgl_rung_kernel"
#: spans of a rung run that the kernel did not take
OFF_KERNEL = ("wgl.graph-replay", "wgl.eager")


def read(ctx):
    hs = ctx.traced()
    if not hs:
        return None
    memo = {}
    least_s = 0.0
    laddered = []
    for h in hs:
        if h.got is None:
            continue
        on_ladder = False
        for k, g, e in zip(h.keys, h.got["keys"], h.exp):
            if g is None or g["engine"] != "jnp-ladder":
                continue
            on_ladder = True
            if k.name not in memo:
                ops, nbytes = work(k.ops, None if e["linear"]
                                   else e["depth"])
                memo[k.name] = max(
                    ops / ctx.peaks["alu32_ops_per_s"],
                    nbytes / ctx.peaks["hbm_bytes_per_s"])
            least_s += memo[k.name]
        if on_ladder:
            if ctx.spans is not None and any(
                    ctx.spans_in(h, name) for name in OFF_KERNEL):
                return None
            laddered.append(h)
    kernel_s = sum(b - a for name, a, b in ctx.device.ops
                   if KERNEL in name
                   and any(h.t0 <= a and b <= h.t1 for h in laddered))
    if not kernel_s or not least_s:
        return None
    return 100.0 * least_s / kernel_s
