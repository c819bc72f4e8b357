"""``closure_roofline``: the share of the least time Elle's closure
needs that the card took, over the histories checked wholly inside the
device trace.

The least time of a history is one boolean product of the six Adya
planes at n, the reference's count of committed txns: 2 * 6 * n^3
operations (``least_ops``) at the card's fastest exact dense matrix
rate. That rate is the int8 tensor cores', 1,979e12 dense operations a
second (NVIDIA's H100 SXM data sheet): a product of 0/1 matrices
counted in int32 is exact there, so no squaring closure computes the
same answer faster. Counted at the unpadded n and at int8, no closure
can read above 100 %: the padding to a power of two, the number of
squarings to the fixpoint and bf16's half rate are what the share
exposes. The card's time is the profiler's, summed over the device
operations inside those histories' ``closure.device`` spans (the
planes' build, the squarings, the fixpoint counts, ``on_cycle``; the
span ends after ``on_cycle``'s copy, so the closure's work lies within
it).
"""

#: int8 dense tensor-core operations a second, H100 SXM (data sheet)
INT8_OPS_PER_S = 1979e12
#: the planes of the closure: ww, ww|wr, ww|wr|rw and each with realtime
PLANES = 6


def least_ops(n: int) -> float:
    """One boolean product of the six n x n planes."""
    return 2.0 * PLANES * float(n) ** 3


def read(ctx):
    hs = ctx.traced()
    if not hs or ctx.spans is None:
        return None
    least_s = 0.0
    windows = []
    for h in hs:
        spans = ctx.spans_in(h, "closure.device")
        if not spans or h.exp is None:
            continue
        least_s += least_ops(h.exp["committed-count"]) / INT8_OPS_PER_S
        windows.extend(spans)
    card_s = sum(b - a for _, a, b in ctx.device.ops
                 if any(s <= a and b <= e for s, e in windows))
    if not card_s or not least_s:
        return None
    return 100.0 * least_s / card_s
