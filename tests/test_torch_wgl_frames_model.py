"""A numpy model of ``csrc/wgl_frames.cu``, the rung kernel's tables
built on the card, held bit for bit against their plain version, the
host's frames narrowed: ``_rung_kernel_tables(device_tables(p, "cpu"),
ni)``.

The kernel has no CPU mode, so its design is checked here. The model
reads what the program hands the launch (``wgl._frame_inputs``: the
per-op vectors, ``last`` and the class table in one int32 array) and
writes what the kernel writes, all warps at once, a lane axis of 32:

- a warp per depth row d, lane c gathering rank lo[d] + c clamped to
  R - 1; fsk, a1, a2, ver and the ceiling from that gather;
- slot c's pred word, the ballot over lanes b of (b in range and ret_b
  below inv_c), inv_c shuffled from lane c; the update word one more
  ballot;
- member j's pred word, the ballot of ret_b < i_inv[j], and its static
  bit, last[j] < min(lo[d] + 32, R);
- rows R to r_pad zero but their ceilings, 2**30.

Inputs: R below 32 and not a multiple of 32, I = 0, info classes padded
to 8, 16 and 32 with one and two count words (and 32 with four, past
the rung kernel's two), a 3,000-op key at 5 %
:info, and the ``register_1key_10k.faulted`` cell's fixed faulted key 0
(13,500 ops) as it is and with an impossible read. The last tests put
the model in the launch's place behind the real routes (a lone ladder,
a batched group, ``check_prefix``), the rung kernel's model beside it:
the same dicts as the host build, a key's tables built on the card
once where the rung kernel takes its rung runs, and the host's int64
tables added where the ladder leaves the kernel.
"""

import random

import numpy as np
import pytest
import torch

from benchmark.traffic.register_pool import _rng
from benchmark.traffic.synth import gen_register_history
from jepsen_etcd_tpu_torch.core.history import History
from jepsen_etcd_tpu_torch.ops import _cuda, wgl
from jepsen_etcd_tpu_torch.runner import telemetry
from jepsen_etcd_tpu_torch.testing import concurrent_writes_history, \
    gen_history, impossible_read_at

from test_torch_fixtures import one_torch_thread  # noqa: F401
from test_torch_wgl_ladder import BUDGETS
from test_torch_wgl_rung_model import kernel_limits, rung_model

W = 32
LANE = np.arange(W, dtype=np.int64)
T_FSK, T_A1, T_A2, T_VER, T_PRED, T_CEIL = 0, W, 2 * W, 3 * W, 4 * W, 5 * W
T_SHIFT, T_UF, T_CEILB, T_UPD = 6 * W, 6 * W + 1, 6 * W + 2, 6 * W + 3
CEIL_INF = 2 ** 30
WRITE, CAS = 1, 2
CPU = torch.device("cpu")

#: gen_register_history draws (values, n_ops, info_rate, seed) and the
#: (c_pad, ni) their packs take, all at w = 32
SHAPES = {
    "R below 32": (5, 40, 0.2, 0),
    "I = 0": (5, 300, 0.0, 3),
    "c_pad 8, ni 1": (2, 300, 0.05, 0),
    "c_pad 8, ni 2": (2, 1600, 0.4, 0),
    "c_pad 16, ni 1": (3, 300, 0.15, 0),
    "c_pad 16, ni 2": (3, 600, 0.3, 1),
    "c_pad 32, ni 1": (5, 300, 0.3, 0),
    "c_pad 32, ni 2": (5, 600, 0.3, 0),
    "c_pad 32, ni 4": (5, 1200, 0.3, 0),
    "3,000 ops at 5 % :info": (5, 3000, 0.05, 0),
}
DIMS = {"I = 0": (0, 0), "c_pad 8, ni 1": (8, 1), "c_pad 8, ni 2": (8, 2),
        "c_pad 16, ni 1": (16, 1), "c_pad 16, ni 2": (16, 2),
        "c_pad 32, ni 1": (32, 1), "c_pad 32, ni 2": (32, 2),
        "c_pad 32, ni 4": (32, 4)}


def ballot(bits: np.ndarray) -> np.ndarray:
    """A warp's ballot over a trailing lane axis: bit b is lane b's."""
    return (bits.astype(np.int64) << LANE).sum(-1)


def frames_model(inputs: np.ndarray, R: int, I: int, i_tab: int,
                 r_pad: int) -> tuple:
    """What csrc/wgl_frames.cu writes into rows [r_pad, 196] and info
    [r_pad, 2 * i_tab] from ``inputs``, as int32."""
    vec = inputs[:12 * R].astype(np.int64).reshape(12, R)
    pred, inv, ret, f, a1, a2, ver, ceil, lo, shift, uf, ceilb = vec
    i_inv = inputs[12 * R:12 * R + I].astype(np.int64)
    last = inputs[12 * R + I:12 * R + 2 * I].astype(np.int64)
    rows = np.zeros((r_pad, T_UPD + 1), np.int64)
    info = np.zeros((r_pad, 2 * i_tab), np.int64)
    # rows R to r_pad: zero, their ceilings 2**30
    rows[R:, T_CEIL:T_CEIL + W] = CEIL_INF
    rows[R:, T_CEILB] = CEIL_INF
    # a warp a row d, lane c at rank lo[d] + c, gathered clamped
    d = np.arange(R)[:, None]
    rank = lo[:, None] + LANE                             # [R, lane]
    in_range = rank < R
    x = np.minimum(rank, R - 1)
    g_ret, g_inv, g_f = ret[x], inv[x], f[x]
    row = rows[:R]
    row[:, T_FSK:T_FSK + W] = np.where(in_range & (pred[x] <= d),
                                       g_f + 1, 0)
    row[:, T_A1:T_A1 + W] = a1[x]
    row[:, T_A2:T_A2 + W] = a2[x]
    row[:, T_VER:T_VER + W] = ver[x]
    row[:, T_CEIL:T_CEIL + W] = np.where(in_range, ceil[x], CEIL_INF)
    # lane c keeps the ballot taken with inv_c shuffled from lane c
    row[:, T_PRED:T_PRED + W] = ballot(
        in_range[:, None, :] & (g_ret[:, None, :] < g_inv[:, :, None]))
    row[:, T_SHIFT] = shift
    row[:, T_UF] = uf
    row[:, T_CEILB] = ceilb
    row[:, T_UPD] = ballot(in_range & ((g_f == WRITE) | (g_f == CAS)))
    if i_tab:
        # member j: one ballot, kept by lane j % 32; its static bit
        words = ballot(in_range[:, None, :]
                       & (g_ret[:, None, :] < i_inv[None, :, None]))
        hi = np.minimum(lo + W, R)
        info[:R, :I] = words
        info[:R, i_tab:i_tab + I] = last[None, :] < hi[:, None]
    return rows.astype(np.int32), info.astype(np.int32)


def plain(p) -> tuple:
    """The host's frames, padded, widened, and narrowed for the rung
    kernel."""
    ni = wgl.info_dims(p)[1]
    return tuple(t.numpy() for t in wgl._rung_kernel_tables(
        wgl.device_tables(p, CPU), ni))


def modelled(p) -> tuple:
    """The model's three tables, from the program's own inputs and
    class table (``_frame_inputs``)."""
    c_pad, ni, i_tab = wgl.info_dims(p)
    inputs = wgl._frame_inputs(p, c_pad, ni)
    n_cls = c_pad * (8 + ni) if ni else 0
    rows, info = frames_model(inputs, p.R, p.I, i_tab if ni else 0,
                              wgl.bucket(p.R))
    cls = inputs[inputs.shape[0] - n_cls:].reshape(
        (c_pad, 8 + ni) if ni else (0, 0))
    return rows, info if ni else np.zeros((0, 0), np.int32), cls


def drawn(name: str):
    values, n_ops, rate, seed = SHAPES[name]
    return wgl.pack_register_history(History(gen_register_history(
        random.Random(seed), n_ops=n_ops, info_rate=rate, values=values,
        concurrency=10)))


def cell_key(impossible: bool):
    """The 1-key cell's fixed faulted key 0, packed; with ``impossible``
    its first versioned read past 0.9 of its entries reads a version no
    write makes."""
    h = History(gen_register_history(_rng("fixed", "faulted", 0),
                                     n_ops=13_500, info_rate=0.01,
                                     concurrency=10))
    return wgl.pack_register_history(impossible_read_at(h, 0.9)
                                     if impossible else h)


CASES = sorted(SHAPES) + ["cell key 0", "cell key 0, impossible read"]


@pytest.mark.parametrize("case", CASES)
def test_model_equals_the_host_tables(case):
    p = cell_key("impossible" in case) if case.startswith("cell") \
        else drawn(case)
    assert p.ok and p.w == W
    if case == "R below 32":
        assert p.R < 32 and p.I
    elif case in DIMS:
        assert wgl.info_dims(p)[:2] == DIMS[case]
    elif case.startswith("cell"):
        assert wgl.info_dims(p)[:2] == (32, 2) and p.R > 10_000
    assert p.R % 32 or case.startswith("cell")
    for got, want in zip(modelled(p), plain(p)):
        assert got.dtype == want.dtype == np.int32
        assert got.shape == want.shape
        assert np.array_equal(got, want)


def test_last_is_the_cumulative_sums_static_bit():
    """``last`` (the highest rank r with ret[r] below a member's invoke)
    against the rank-by-rank count it stands for."""
    p = drawn("c_pad 8, ni 2")
    inputs = wgl._frame_inputs(p, *wgl.info_dims(p)[:2])
    last = inputs[12 * p.R + p.I:12 * p.R + 2 * p.I]
    for j, x in enumerate(p._i_inv_rank):
        below = np.flatnonzero(p.ret_rank < x)
        assert last[j] == (below[-1] if below.size else -1)


def test_the_launch_refuses_tensors_off_the_card():
    """``_cuda.wgl_frames`` checks device, type, layout and shape before
    it builds or launches anything."""
    p = drawn("c_pad 8, ni 1")
    c_pad, ni, i_tab = wgl.info_dims(p)
    inputs = torch.from_numpy(wgl._frame_inputs(p, c_pad, ni))
    r_pad = wgl.bucket(p.R)
    rows = torch.empty((r_pad, 196), dtype=torch.int32)
    info = torch.empty((r_pad, 2 * i_tab), dtype=torch.int32)
    with pytest.raises(ValueError, match="wrong device"):
        _cuda.wgl_frames(inputs, p.R, p.I, rows, info)
    with pytest.raises(ValueError):
        _cuda.wgl_frames(inputs.to(torch.int64), p.R, p.I, rows, info)


def frames_launch(inputs, R, I, rows, info) -> None:
    """``frames_model`` in ``_cuda.wgl_frames``' place."""
    got = frames_model(inputs.numpy(), R, I, info.shape[1] // 2,
                       rows.shape[0])
    rows.copy_(torch.from_numpy(got[0]))
    if info.numel():
        info.copy_(torch.from_numpy(got[1]))


@pytest.fixture
def card_model(monkeypatch):
    """The card's routes taken on the CPU: the frame builder's model and
    the rung kernel's model in their launches' places."""
    fits = wgl._rung_kernel_fits

    def rung(rows, info, cls, fr, n_alive, out, res, R, k0, lim):
        got, r, _ = rung_model(rows.numpy(), info.numpy(), cls.numpy(),
                               fr.numpy(), int(n_alive[0]), R, k0, lim)
        out.copy_(torch.from_numpy(got))
        res.copy_(torch.from_numpy(r))

    monkeypatch.setattr(wgl, "_rung_kernel_fits",
                        lambda dev, *a: fits(torch.device("cuda"), *a))
    monkeypatch.setattr(_cuda, "wgl_rung_limits", kernel_limits)
    monkeypatch.setattr(_cuda, "wgl_frames", frames_launch)
    monkeypatch.setattr(_cuda, "wgl_rung", rung)


def plain_route(fn):
    """fn() with the rung kernel's route off: the host build."""
    keep = wgl.RUNG_KERNEL_F_MAX
    wgl.RUNG_KERNEL_F_MAX = 0
    try:
        return fn()
    finally:
        wgl.RUNG_KERNEL_F_MAX = keep


def recorded(fn, tmp_path):
    """(fn(), its wgl.frames spans' ``on``, its wgl.frames-card count)."""
    path = str(tmp_path / f"tel{len(list(tmp_path.iterdir()))}.jsonl")
    tel = telemetry.Telemetry(path=path)
    telemetry.set_current(tel)
    try:
        out = fn()
    finally:
        telemetry.set_current(None)
        tel.close()
    recs = telemetry.load_jsonl(path)[0]
    on = [r["attrs"]["on"] for r in recs
          if r.get("kind") == "span" and r["name"] == "wgl.frames"]
    cards = sum(r.get("value", 1) for r in recs
                if r.get("kind") == "counter"
                and r["name"] == "wgl.frames-card")
    return out, on, cards


def strip(out: dict) -> dict:
    return {k: v for k, v in out.items() if k != "_resume"}


def frontier_bytes(fr) -> tuple:
    d, w, i, v, n = fr
    return torch.cat([d[:, None], w, i, v[:, None]], 1).numpy().tobytes(), \
        int(n)


@pytest.mark.parametrize("case", ["c_pad 16, ni 2", "c_pad 32, ni 1",
                                  "I = 0"])
def test_a_ladder_the_kernel_begins_builds_its_tables_on_the_card(
        card_model, case, tmp_path):
    p = drawn(case)
    got, on, cards = recorded(
        lambda: wgl.check_packed(p, f_max=32, device="cpu"), tmp_path)
    want, want_on, _ = recorded(
        lambda: plain_route(lambda: wgl.check_packed(p, f_max=32,
                                                     device="cpu")),
        tmp_path)
    assert got == want and got["valid?"] is True
    assert (on, cards) == (["card"], 1)
    assert want_on == ["host"]


def test_a_ladder_that_leaves_the_kernel_adds_the_host_tables(
        card_model, tmp_path):
    """32 -> 128 in the kernel, then the plain rungs from 256 read the
    host's tables; past the top rung the deferred spill hands back the
    key's tables with the frozen frontier, both views built, the card's
    bit for bit its plain version."""
    rng = random.Random(31)
    packs = [wgl.pack_register_history(gen_history(
        rng, n_procs=10, n_ops=60, values=4, info_rate=0.25,
        dur_scale=6.0)) for _ in range(21)]
    p = packs[20]
    got, on, cards = recorded(
        lambda: wgl.check_packed(p, f_max=32, device="cpu"), tmp_path)
    want = plain_route(lambda: wgl.check_packed(p, f_max=32, device="cpu"))
    assert got == want and got["rungs"] >= 3
    assert (on, cards) == (["card", "host"], 1)
    q = wgl.pack_register_history(concurrent_writes_history(16,
                                                            read_val=1))
    got, on, cards = recorded(
        lambda: wgl.check_packed(q, f_max=32, spill=False, device="cpu"),
        tmp_path)
    want = plain_route(lambda: wgl.check_packed(q, f_max=32, spill=False,
                                                device="cpu"))
    assert strip(got) == strip(want) and got["overflow"]
    assert (on, cards) == (["card", "host"], 1)
    tables, frontier, k = got["_resume"]
    assert k == want["_resume"][2]
    assert frontier_bytes(frontier) == frontier_bytes(want["_resume"][1])
    # both views are there: reading them builds nothing more
    (rung, plain), on, cards = recorded(
        lambda: (tables.rung, dict(tables)), tmp_path)
    assert (on, cards) == ([], 0)
    for got_t, want_t in zip(rung, wgl._rung_kernel_tables(plain, 0)):
        assert torch.equal(got_t, want_t)
    assert wgl.spill_packed(q, *got["_resume"]) == \
        wgl.spill_packed(q, *want["_resume"])


def test_routes_outside_the_kernel_build_on_the_host(card_model, tmp_path):
    """Four count words (past NI_CAP) and a two-word window take the
    host's frames, as does every route with the kernel's route off."""
    wide = wgl.pack_register_history(gen_history(
        random.Random(1), n_procs=16, n_ops=80, dur_scale=20.0,
        info_rate=0.2))
    assert (wide.w, wgl.info_dims(wide)[:2]) == (64, (8, 1))
    for p in (drawn("c_pad 32, ni 4"), wide):
        got, on, cards = recorded(
            lambda: wgl.check_packed(p, f_max=32, device="cpu"), tmp_path)
        assert got == plain_route(lambda: wgl.check_packed(p, f_max=32,
                                                           device="cpu"))
        assert (on, cards) == (["host"], 0)


def test_check_prefix_and_a_batched_group_build_on_the_card(card_model,
                                                            tmp_path):
    """``check_prefix`` paused at every budget of ``BUDGETS`` and a
    batched group of two keys: one card build a key the kernel takes,
    none with the kernel's route off; the same dicts and frozen
    frontiers as the plain route."""
    def paused(q, budget):
        states, state = [], None
        while state is None or not state.done:
            state = wgl.check_prefix(q, state, max_waves=budget,
                                     device="cpu")
            states.append((state.done, state.k, state.rungs, state.peak,
                           None if state.done
                           else frontier_bytes(state.frontier)))
        return states, strip(state.result)

    for budget in BUDGETS:
        # packed anew: the host's frames, once built, stay on a pack
        q = drawn("c_pad 8, ni 1")
        got, on, cards = recorded(lambda: paused(q, budget), tmp_path)
        want, want_on, want_cards = recorded(
            lambda: plain_route(lambda: paused(q, budget)), tmp_path)
        assert got == want and got[1]["valid?"] is True
        assert (on, cards, want_on, want_cards) == \
            (["card"], 1, ["host"], 0)
    out, on, cards = recorded(
        lambda: wgl.check_packed_batch([q, q], f_max=32, device="cpu"),
        tmp_path)
    want, _, want_cards = recorded(lambda: plain_route(
        lambda: wgl.check_packed_batch([q, q], f_max=32, device="cpu")),
        tmp_path)
    assert [strip(o) for o in out] == [strip(o) for o in want]
    assert all(o["batched"] for o in out)
    assert (cards, want_cards) == (2, 0)


def test_a_group_the_kernel_takes_gets_no_host_tables(card_model,
                                                      monkeypatch,
                                                      tmp_path):
    """The checker service pads a group's host tables ahead only where
    the rung kernel does not take its rung (``_ladder_tables``); the
    sharded rung over two lanes builds each key's on the card and pads
    nothing on the host: the plain route's dicts."""
    from jepsen_etcd_tpu_torch.ops import wgl_mxu
    from jepsen_etcd_tpu_torch.runner import checker_service
    q = drawn("c_pad 8, ni 1")
    key = wgl.group_key(q)
    monkeypatch.setattr(wgl_mxu, "batch_lanes",
                        lambda device=None: [CPU] * 2)
    assert checker_service._ladder_tables([q, q], key, None, 2) is None
    assert checker_service._ladder_tables([q, q], key, "cpu", 1) is None
    prep = plain_route(lambda: checker_service._ladder_tables(
        [q, q], key, "cpu", 1))
    assert (prep.n, prep.key) == (2, key)
    want = plain_route(lambda: wgl.check_packed_batch([q, q], shard=True))
    padded = []
    monkeypatch.setattr(wgl, "prepare_bucket_group",
                        lambda *a, **kw: padded.append(a))
    out, on, cards = recorded(
        lambda: wgl.check_packed_batch([q, q], shard=True), tmp_path)
    assert [strip(o) for o in out] == [strip(o) for o in want]
    assert all(o["batched"] for o in out)
    assert (padded, on, cards) == ([], ["card", "card"], 2)
