"""The readers of the single-key cell's per-layer metrics on hand-built
spans and a hand-built device trace: ``frames_ms`` (the ``wgl.frames``
spans a history) and ``rung_kernel_roofline`` (the ladder-decided keys'
least time over the rung kernel's)."""

from __future__ import annotations

import pytest

from benchmark.lib.context import Checked, Context
from benchmark.lib.peaks import H100_SXM
from benchmark.lib.trace import DeviceTrace
from benchmark.metrics import frames_ms, rung_kernel_roofline as roof
from benchmark.reference import register as ref
from benchmark.traffic.register_pool import PoolKey, _rng
from benchmark.traffic.synth import gen_register_history

KERNEL_OP = "void wgl_rung_kernel<2>(int const*, int const*, int)"


def checked(t0, t1, keys=(), engines=()):
    got = {"valid?": True, "keys": [{"engine": e} for e in engines]}
    return Checked(list(keys), t0, t0, t1, got, None)


def test_frames_ms_sums_the_frames_spans_a_history():
    """Two histories, 30 + 10 ms of ``wgl.frames`` in the first, none in
    the second: 20 ms a history."""
    hs = [checked(0.0, 1.0), checked(1.0, 2.0)]
    spans = [("bench:check", 0.0, 1.0), ("wgl.tables", 0.1, 0.2),
             ("wgl.frames", 0.1, 0.13), ("wgl.frames", 0.5, 0.51),
             ("bench:check", 1.0, 2.0), ("wgl.tables", 1.1, 1.2)]
    assert frames_ms.read(Context(1.0, 2.0, hs, spans=spans)) == \
        pytest.approx(20.0)


def test_frames_ms_reads_nothing_without_its_span():
    hs = [checked(0.0, 1.0)]
    assert frames_ms.read(Context(1.0, 1.0, hs, spans=[
        ("bench:check", 0.0, 1.0), ("wgl.tables", 0.1, 0.9)])) is None
    assert frames_ms.read(Context(1.0, 1.0, hs)) is None


def _key(role, j, n_ops=300, info_rate=0.02, corrupt=False):
    return PoolKey(role, j, gen_register_history(
        _rng("fixed", role, j), n_ops=n_ops, info_rate=info_rate,
        corrupt=corrupt, concurrency=10))


def _ctx(hs, device_ops, spans=()):
    for h in hs:
        h.exp = [ref.key_verdict(k.ops) for k in h.keys]
    return Context(1.0, 10.0, hs, spans=list(spans),
                   device=DeviceTrace(list(device_ops), 0.0, 10.0))


def _least_s(k, e) -> float:
    ops, nbytes = roof.work(k.ops, None if e["linear"] else e["depth"])
    return max(ops / H100_SXM["alu32_ops_per_s"],
               nbytes / H100_SXM["hbm_bytes_per_s"])


def test_the_roofline_is_least_over_kernel_time():
    """Two ladder keys, one of them twice, and a B1 key: the least time
    of the three ladder checks over the kernel's time inside them; a
    kernel launch outside those histories and other device operations
    do not count."""
    a, b, c = _key("faulted", 0), _key("faulted", 1), \
        _key("corrupt", 0, info_rate=0.0, corrupt=True)
    hs = [checked(1.0, 2.0, [a], ["jnp-ladder"]),
          checked(2.0, 3.0, [b], ["jnp-ladder"]),
          checked(3.0, 4.0, [c], ["mxu-wave"]),
          checked(4.0, 5.0, [a], ["jnp-ladder"])]
    ops = [(KERNEL_OP, 1.1, 1.104), (KERNEL_OP, 2.5, 2.503),
           ("void wgl_wave_kernel(...)", 3.1, 3.2), (KERNEL_OP, 4.2, 4.201),
           ("Memcpy HtoD", 4.3, 4.4), (KERNEL_OP, 3.5, 3.6),
           (KERNEL_OP, 7.0, 8.0)]
    ctx = _ctx(hs, ops, [("wgl.rung-kernel", 1.1, 1.2)])
    ea, eb = hs[0].exp[0], hs[1].exp[0]
    least = 2 * _least_s(a, ea) + _least_s(b, eb)
    got = roof.read(ctx)
    assert got == pytest.approx(100.0 * least / 0.008)
    assert 0 < got < 100


@pytest.mark.parametrize("off", ["wgl.graph-replay", "wgl.eager"])
def test_a_rung_run_off_the_kernel_reads_none(off):
    """A graphed or eager rung run inside a ladder key's history means
    the kernel did not take every rung run: no share."""
    a = _key("faulted", 0)
    hs = [checked(1.0, 2.0, [a], ["jnp-ladder"]),
          checked(2.0, 3.0, [a], ["jnp-ladder"])]
    ops = [(KERNEL_OP, 1.1, 1.104), (KERNEL_OP, 2.1, 2.104)]
    assert roof.read(_ctx(hs, ops)) is not None
    assert roof.read(_ctx(hs, ops, [(off, 2.2, 2.3)])) is None
    # outside the ladder keys' histories it changes nothing
    c = _key("corrupt", 0, info_rate=0.0, corrupt=True)
    hs.append(checked(3.0, 4.0, [c], ["mxu-wave"]))
    assert roof.read(_ctx(hs, ops, [(off, 3.2, 3.3)])) is not None


def test_no_ladder_key_reads_none():
    c = _key("corrupt", 0, info_rate=0.0, corrupt=True)
    hs = [checked(1.0, 2.0, [c], ["mxu-wave"])]
    assert roof.read(_ctx(hs, [(KERNEL_OP, 1.1, 1.2)])) is None
    # nor without a device trace, or without the kernel in it
    a = _key("faulted", 0)
    hs = [checked(1.0, 2.0, [a], ["jnp-ladder"])]
    assert roof.read(_ctx(hs, [("void other(...)", 1.1, 1.2)])) is None
    hs[0].exp = [ref.key_verdict(a.ops)]
    assert roof.read(Context(1.0, 10.0, hs, spans=[])) is None
