"""``wgl_wave_roofline``: the share of the least time the wave search
needs that kernel B1 (``csrc/wgl_wave.cu``) took, over the keys it
decided in the traced window.

The work is counted from the histories (``lib/work.py``), the same
whatever implements the search. A key's search linearizes one op a
wave: as many waves as ops must linearize, and each wave tries every
op of the window, ``OPS_PER_CANDIDATE`` 32-bit operations a candidate. Each op's input
(``BYTES_PER_OP``: its f, version, two values and its invoke and return
positions, 32 bits each) is read once. The least time is the larger of
the operations over the card's 32-bit peak and the bytes over its
memory bandwidth (``lib/peaks.py``). The kernel's time is the
profiler's, summed over its launches.
"""

from benchmark.lib.work import spans, steps, window

OPS_PER_CANDIDATE = 64
BYTES_PER_OP = 24
KERNEL = "wgl_wave"


def work(ops: list, depth=None) -> tuple:
    """``(operations, bytes)`` to search one key's history ``ops``
    (op dicts in history order); ``depth`` is the most ops the
    reference linearized where it refutes the key, else None."""
    return (steps(ops, depth) * window(ops) * OPS_PER_CANDIDATE,
            len(spans(ops)) * BYTES_PER_OP)


def read(ctx):
    hs = ctx.traced()
    if not hs:
        return None
    kernel_s = sum(b - a for name, a, b in ctx.device.ops
                   if KERNEL in name)
    memo = {}
    least_s = 0.0
    for h in hs:
        if h.got is None:
            continue
        for k, g, e in zip(h.keys, h.got["keys"], h.exp):
            if g is None or g["engine"] != "mxu-wave":
                continue
            if k.name not in memo:
                ops, nbytes = work(k.ops, None if e["linear"]
                                   else e["depth"])
                memo[k.name] = max(
                    ops / ctx.peaks["alu32_ops_per_s"],
                    nbytes / ctx.peaks["hbm_bytes_per_s"])
            least_s += memo[k.name]
    if not kernel_s or not least_s:
        return None
    return 100.0 * least_s / kernel_s
