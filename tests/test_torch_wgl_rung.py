"""The rung kernel (``csrc/wgl_rung.cu``) on the card, held against the
plain path, the same rung runs as PyTorch ops on the same tables (the
kernel's route off: ``RUNG_KERNEL_F_MAX`` 0).

Equal, exactly: the dicts (``waves``, ``peak-frontier``, ``rungs``, the
verdict), and the frozen frontier's bytes at every ``check_prefix``
pause and in a ``spill=False`` hand-off. Inputs: the ladder tests' fuzz
at w = 32, with and without info ops and corruption; the benchmark's
faulted key shape (``gen_register_history`` at ``info_rate`` 0.01),
alone and as a batched group at F = 128; a search that climbs 32 ->
128 -> 256 and up; a batched rung whose key climbs from 512; and
``check_prefix`` at every budget. The kernel has no CPU mode (its numpy
model is ``tests/test_torch_wgl_rung_model.py``).

The rung kernel's tables built on the card (``wgl.card_tables``,
csrc/wgl_frames.cu; its numpy model is
``tests/test_torch_wgl_frames_model.py``) equal the host's frames
narrowed bit for bit, on the fuzz, the benchmark cells' faulted keys
and the 1-key cell's key 0 accepted and refuted; the kernel on them
gives the host build's dicts and frozen frontiers, one card build a
key on a lone ladder, a batched group and ``check_prefix``, and a key
that leaves the kernel (past rung 128, or at four count words) the
same dict as before. Runs on a card without
JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_wgl_rung.py``.
"""

import random

import pytest
import torch

from benchmark.traffic.register_pool import _rng
from benchmark.traffic.synth import gen_register_history
from jepsen_etcd_tpu_torch.core.history import History
from jepsen_etcd_tpu_torch.ops import wgl
from jepsen_etcd_tpu_torch.runner import telemetry
from jepsen_etcd_tpu_torch.testing import concurrent_writes_history, \
    gen_history, impossible_read_at

BUDGETS = (1, 7, 64, 10 ** 6)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the rung kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def plain(monkeypatch):
    """``plain(fn)``: fn() with the kernel's route off."""
    def run(fn):
        with monkeypatch.context() as m:
            m.setattr(wgl, "RUNG_KERNEL_F_MAX", 0)
            return fn()
    return run


def frontier_bytes(fr) -> tuple:
    d, w, i, v, n = fr
    rows = torch.cat([d[:, None], w, i, v[:, None]], 1)
    return rows.cpu().numpy().tobytes(), int(n)


def strip(out: dict) -> dict:
    return {k: v for k, v in out.items() if k != "_resume"}


def fuzz(info: bool, corrupt: bool, seed: int, n: int = 3) -> list:
    """n w = 32 packs of the ladder tests' fuzz shape."""
    rng = random.Random(seed)
    got = []
    while len(got) < n:
        p = wgl.pack_register_history(gen_history(
            rng, n_procs=4, n_ops=30, corrupt=corrupt,
            info_rate=0.2 if info else 0.0))
        if p.ok and p.w == 32 and (p.I > 0) == info:
            got.append(p)
    return got


def faulted_key(j: int):
    """Fixed faulted key j of the benchmark's cell, packed."""
    ops = gen_register_history(_rng("fixed", "faulted", j), n_ops=2000,
                               info_rate=0.01)
    return wgl.pack_register_history(History(ops))


def cell_key(info_rate: float = 0.01, impossible: bool = False):
    """The 1-key cell's fixed faulted key 0 (13,500 ops), packed; with
    ``impossible`` its first versioned read past 0.9 of its entries reads
    a version no write makes."""
    h = History(gen_register_history(_rng("fixed", "faulted", 0),
                                     n_ops=13_500, info_rate=info_rate,
                                     concurrency=10))
    return wgl.pack_register_history(impossible_read_at(h, 0.9)
                                     if impossible else h)


def drawn(values: int, n_ops: int, info_rate: float, seed: int):
    """A 10-thread register key of the benchmark's generator, packed."""
    return wgl.pack_register_history(History(gen_register_history(
        random.Random(seed), n_ops=n_ops, info_rate=info_rate,
        values=values, concurrency=10)))


def ladder_packs() -> list:
    """The first 28 packs of the ladder tests' rung-climbing generator."""
    rng = random.Random(31)
    return [wgl.pack_register_history(gen_history(
        rng, n_procs=10, n_ops=60, values=4, info_rate=0.25, dur_scale=6.0))
        for _ in range(28)]


@pytest.mark.cuda
@pytest.mark.parametrize("info,corrupt", [(False, False), (False, True),
                                          (True, False), (True, True)])
def test_kernel_equals_plain_on_fuzz(card, plain, monkeypatch, info,
                                     corrupt):
    monkeypatch.setattr(wgl, "RUNG_KERNEL_LAUNCHES", 0)
    for p in fuzz(info, corrupt, seed=3200 + 10 * info + corrupt):
        got = wgl.check_packed(p, f_max=32, device=card)
        assert got == plain(lambda: wgl.check_packed(p, f_max=32,
                                                     device=card))
        # one rung run, paused at each k_stop: the frozen frontier
        tables = wgl.LadderTables(p, card)
        ni = wgl.info_dims(p)[1]
        for f, k_stop in [(32, None), (128, None), (32, 5), (128, 1)]:
            init = (0, *wgl._initial_frontier(f, 1, ni, card))
            run = wgl._wgl_loop(tables, p.R, p.I, f, 32, init, k_stop)
            want = plain(lambda: wgl._wgl_loop(tables, p.R, p.I, f, 32,
                                               init, k_stop))
            assert run[:4] == want[:4]
            assert frontier_bytes(run[4]) == frontier_bytes(want[4])
    assert wgl.RUNG_KERNEL_LAUNCHES > 0


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_benchmarks_faulted_keys(card, plain,
                                                            monkeypatch,
                                                            tmp_path):
    """Two of the faulted cell's fixed keys (1,582 and 1,588 ops, 12 or
    13 info ops): each alone on the ladder from rung 32, and the two as
    one batched group at F = 128, every rung run in the kernel on
    tables built on the card, one build a key."""
    packs = [faulted_key(0), faulted_key(1)]
    assert wgl.group_key(packs[0]) == wgl.group_key(packs[1])
    monkeypatch.setattr(wgl, "RUNG_LAUNCHES", 0)
    monkeypatch.setattr(wgl, "RUNG_KERNEL_LAUNCHES", 0)
    for p in packs:
        got = wgl.check_packed(p, f_max=32, device=card)
        assert got == plain(lambda: wgl.check_packed(p, f_max=32,
                                                     device=card))
        assert got["valid?"] is True and got["waves"] > 1500
    got, on, cards = card_built(lambda: wgl.check_packed_batch(
        packs, try_fused=False, device=card), tmp_path)
    want = plain(lambda: wgl.check_packed_batch(packs, try_fused=False,
                                                device=card))
    assert got == want and all(g["batched"] for g in got)
    assert (on, cards) == (["card", "card"], 2)
    # the plain runs counted rung runs too; the kernel's were its own
    assert wgl.RUNG_KERNEL_LAUNCHES == 4
    assert wgl.RUNG_LAUNCHES == 8


@pytest.mark.cuda
def test_kernel_equals_plain_on_a_search_that_climbs(card, plain):
    """Rungs 32 and 128 overflow in the kernel and the plain rungs of
    256 and up resume their frozen frontiers; past the top rung the
    spill=False hand-off carries the same frontier bytes."""
    p = ladder_packs()[20]
    got = wgl.check_packed(p, f_max=32, device=card)
    assert got == plain(lambda: wgl.check_packed(p, f_max=32, device=card))
    assert got["rungs"] >= 3
    q = wgl.pack_register_history(concurrent_writes_history(16,
                                                            read_val=1))
    got = wgl.check_packed(q, f_max=32, spill=False, device=card)
    want = plain(lambda: wgl.check_packed(q, f_max=32, spill=False,
                                          device=card))
    assert strip(got) == strip(want) and got["overflow"]
    assert got["_resume"][2] == want["_resume"][2]
    assert frontier_bytes(got["_resume"][1]) == \
        frontier_bytes(want["_resume"][1])


@pytest.mark.cuda
def test_kernel_equals_plain_on_a_batched_rung_that_overflows(card, plain):
    """One key of a batched group settles at 128, the other overflows it
    and climbs from F_MAX = 512."""
    packs = ladder_packs()
    group = [packs[27], packs[7]]
    got = wgl.check_packed_batch(group, try_fused=False, device=card)
    want = plain(lambda: wgl.check_packed_batch(group, try_fused=False,
                                                device=card))
    assert [strip(g) for g in got] == [strip(x) for x in want]
    assert "batched" not in got[0] and got[1]["batched"]


@pytest.mark.cuda
@pytest.mark.parametrize("budget", BUDGETS)
def test_check_prefix_equals_plain_at_every_pause(card, plain, budget,
                                                  tmp_path):
    hists = [gen_history(random.Random(s), n_procs=5, n_ops=40,
                         info_rate=0.1 if s % 2 else 0.0) for s in (7, 21)]
    hists.append(gen_history(random.Random(31), n_procs=10, n_ops=60,
                             values=4, info_rate=0.25, dur_scale=6.0))
    for h in hists:
        p = wgl.pack_register_history(h)
        got = want = None
        builds = 0
        while True:
            got, _, cards = card_built(lambda: wgl.check_prefix(
                p, got, max_waves=budget, device=card), tmp_path)
            builds += cards
            want = plain(lambda: wgl.check_prefix(
                p, want, max_waves=budget, device=card))
            assert (got.done, got.k, got.rungs, got.rung_i, got.peak,
                    got.waves_run) == (want.done, want.k, want.rungs,
                                       want.rung_i, want.peak,
                                       want.waves_run)
            if got.done:
                break
            assert frontier_bytes(got.frontier) == \
                frontier_bytes(want.frontier)
        assert strip(got.result) == strip(want.result)
        assert builds == 1


@pytest.mark.cuda
def test_the_kernel_states_its_limits_and_refuses_beyond_them(card):
    """The route reads the kernel's own limits (capacity 128, 32 info
    classes, 2 count words); a launch past them raises."""
    from jepsen_etcd_tpu_torch.ops import _cuda
    assert _cuda.wgl_rung_limits() == (128, 32, 2)
    p = fuzz(True, False, seed=3210, n=1)[0]
    tables = wgl.device_tables(p, card)
    ni = wgl.info_dims(p)[1]
    rows, info, cls = wgl._rung_kernel_tables(tables, ni)
    d, w, i, v, n = wgl._initial_frontier(256, 1, ni, card)
    fr = torch.cat([d[:, None], w, i, v[:, None]], 1)
    with pytest.raises(RuntimeError, match="wgl_rung launch failed"):
        _cuda.wgl_rung(rows, info, cls, fr, n.reshape(1),
                       torch.empty_like(fr),
                       torch.empty(5, dtype=torch.int64, device=card),
                       p.R, 0, p.R + p.I + 1)


#: packs whose rung-kernel tables the card builds, by what they hold:
#: R below 32, info classes padded to 8, 16 and 32 with one and two
#: count words, none, and the cells' keys
CARD_PACKS = {
    "fuzz": lambda: fuzz(True, False, seed=3210) + fuzz(False, True,
                                                        seed=3201),
    "drawn": lambda: [drawn(*a) for a in ((5, 40, 0.2, 0), (2, 1600, 0.4, 0),
                                          (3, 600, 0.3, 1), (5, 300, 0.3, 0),
                                          (5, 300, 0.0, 3))],
    "4n cell": lambda: [faulted_key(0), faulted_key(1)],
    "1-key cell": lambda: [cell_key(), cell_key(impossible=True)],
}


def card_built(fn, tmp_path) -> tuple:
    """(fn(), the ``on`` of its wgl.frames spans, its wgl.frames-card
    count)."""
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
    cards = sum(r["value"] for r in recs if r.get("kind") == "counter"
                and r["name"] == "wgl.frames-card")
    return out, on, cards


@pytest.mark.cuda
@pytest.mark.parametrize("which", sorted(CARD_PACKS))
def test_card_tables_equal_the_host_paths(card, which):
    for p in CARD_PACKS[which]():
        c_pad, ni, _ = wgl.info_dims(p)
        assert p.ok and p.w == 32 and ni <= 2
        got = wgl.card_tables(p, card)
        want = wgl._rung_kernel_tables(wgl.device_tables(p, card), ni)
        assert len(got) == len(want) == 3
        for name, g, w in zip(("rows", "info", "cls"), got, want):
            assert g.dtype == w.dtype == torch.int32, name
            assert g.shape == w.shape and g.is_contiguous(), name
            assert torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("which", sorted(CARD_PACKS))
def test_a_ladder_on_card_built_tables_equals_the_host_builds(card, plain,
                                                              monkeypatch,
                                                              which,
                                                              tmp_path):
    """The rung kernel on the card's tables and on the host's (its
    plain version in ``card_tables``' place), paused halfway and run to
    the end: the same frozen frontier bytes, one card build a run on
    the card's; and ``check_packed`` the same dict as the host build
    (the kernel's route off), one card build a key."""
    def host_built(p, dev):
        return wgl._rung_kernel_tables(wgl.device_tables(p, dev),
                                       wgl.info_dims(p)[1])

    packs = CARD_PACKS[which]()
    for p in packs:
        ni = wgl.info_dims(p)[1]
        for k_stop in (p.R // 2, None):
            runs = []
            for build in (wgl.card_tables, host_built):
                init = (0, *wgl._initial_frontier(32, 1, ni, card))
                with monkeypatch.context() as m:
                    m.setattr(wgl, "card_tables", build)
                    (*head, fr), _, cards = card_built(
                        lambda: wgl._wgl_loop(wgl.LadderTables(p, card),
                                              p.R, p.I, 32, 32, init,
                                              k_stop), tmp_path)
                runs.append((head, frontier_bytes(fr), cards))
            assert runs[0][:2] == runs[1][:2]
            assert (runs[0][2], runs[1][2]) == (1, 0)
        if which == "1-key cell":
            continue          # ~10,700 plain waves a key: chip_smoke.py
        got, on, cards = card_built(
            lambda: wgl.check_packed(p, f_max=32, spill=False, device=card),
            tmp_path)
        want, _, want_cards = card_built(lambda: plain(
            lambda: wgl.check_packed(p, f_max=32, spill=False,
                                     device=card)), tmp_path)
        assert strip(got) == strip(want)
        assert (on, cards, want_cards) == (["card"], 1, 0)


@pytest.mark.cuda
def test_a_key_that_leaves_the_kernel_gives_the_hosts_dict(card, plain,
                                                           tmp_path):
    """Past rung 128 the plain rungs read the host's tables, built then;
    past the top rung the deferred spill hands them back with the same
    frozen frontier; a 3 % :info key packs to four count words, past the
    kernel, and builds on the host from the start."""
    p = ladder_packs()[20]
    got, on, cards = card_built(
        lambda: wgl.check_packed(p, f_max=32, device=card), tmp_path)
    assert got == plain(lambda: wgl.check_packed(p, f_max=32, device=card))
    assert got["rungs"] >= 3 and (on, cards) == (["card", "host"], 1)
    q = wgl.pack_register_history(concurrent_writes_history(16,
                                                            read_val=1))
    got, on, cards = card_built(
        lambda: wgl.check_packed(q, f_max=32, spill=False, device=card),
        tmp_path)
    want = plain(lambda: wgl.check_packed(q, f_max=32, spill=False,
                                          device=card))
    assert strip(got) == strip(want) and got["overflow"] and cards == 1
    assert got["_resume"][2] == want["_resume"][2]
    assert frontier_bytes(got["_resume"][1]) == \
        frontier_bytes(want["_resume"][1])
    assert wgl.spill_packed(q, *got["_resume"]) == \
        wgl.spill_packed(q, *want["_resume"])
    r = cell_key(info_rate=0.03)
    assert wgl.info_dims(r)[1] == 4
    got, on, cards = card_built(
        lambda: wgl.check_packed(r, f_max=32, spill=False, device=card),
        tmp_path)
    assert (on, cards) == (["host"], 0)
    want = plain(lambda: wgl.check_packed(r, f_max=32, spill=False,
                                          device=card))
    assert strip(got) == strip(want)
