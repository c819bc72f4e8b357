"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout
(one nvcc per source, in parallel), holds each against its plain
PyTorch version on the card, drives the port's paths and shows that
each launched its kernel: single-key linearizability checking of a
27,000-entry register history through ``TPULinearizableChecker`` (kernel
wgl_wave), the watch checker on five watchers' logs of 12,000 values
each (kernel indel_bits), the capacity ladder (PyTorch ops on the
card, at real size on a 26,992-entry history whose wave-kernel search
overflows, its waves replayed from CUDA graphs and held against the
eager loop), the spill BFS and ``check_prefix``, and the keyed register
check: the register workload's checker, ``Independent(Compose({linear,
session}))``, on 32 keys x 2,000 ops (wgl_wave's batched launch, once on
the card's one lane and once split over two lanes of it, and the
batched ladder for the faulted keys). wgl_wave is held on fuzz at
every window width, unversioned concurrent writes, a 64-key batch, the
register and ladder-at-real-size histories and the keyed launch, and
its profiling instantiation prints the SM cycles a wave spends in each
phase. Prints the card's name and power limit, a ``{"kernels": [...]}``
line, and last ``{"ok": true, "device": ...}``.
Exits non-zero, with no result line, when CUDA is unavailable or any
phase fails. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import random
import statistics
import subprocess
import sys
import time

#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
#: the 32-bit rate outside the tensor cores, used for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
ALU32_OPS_PER_S = 67e12
#: 32-bit integer operations per candidate per wave in wgl_wave.cu's
#: candidate body (loads, compares, shifts, selects), counted at wk=32
WGL_OPS_PER_CANDIDATE = 64
#: what indel_bits.cu does a step, counted from its code: four shuffles
#: take the step's (lo, hi, first, last) from their lane; a step with a
#: match position adds two ballots (each a warp instruction: 32 lane
#: operations) and updates its matched words and the one word a carry
#: stops at, each with V & M, the add of V & M and the carry-in, the
#: carry-out compare, V & ~M and the or (two 32-bit operations each)
INDEL_BITS_SHUFFLES_PER_STEP = 4
INDEL_BITS_BALLOTS_PER_MATCHED_STEP = 2
INDEL_BITS_OPS_PER_WORD = 10
#: the operations per DP cell of the anti-diagonal kernel indel_bits
#: replaced (its lane body: j = kd - i, the i == 0 / j == 0 tests, two
#: index computations, the a and b loads and their compare, two diagonal
#: loads, min, +1, select, the store, the lane loop's increment and
#: test): the old algorithm's work, printed beside the new bound
DP_OPS_PER_CELL = 16

MAIN_SEED, MAIN_PROCS, MAIN_OPS = 2026, 6, 13_500
#: the watch cell: 5 writers and 5 watchers (the reference workload's
#: threads on 5 nodes), 12,000 writes, so each watcher's log holds about
#: 12,000 values (a 60 s run at 200 writes/s); the long logs are a 300 s
#: run at the same rate
WATCH_SEED, WATCH_WRITERS, WATCH_WATCHERS = 2026, 5, 5
WATCH_WRITES, WATCH_LONG_WRITES = 12_000, 60_000
#: the ladder at real size: the register cell's seed and length over 8
#: processes (26,992 entries, R=10,473). Valid, the wave kernel accepts
#: it although its 32 slots overflow on the way; with one impossible
#: read at 90 % of the history it overflows and dies, so the checker
#: climbs the ladder from rung 32 for about 9,400 waves
LADDER_BIG_PROCS, LADDER_BIG_AT = 8, 0.9
#: gen_history seed (n_procs=10, n_ops=60, values=4, info_rate=0.25,
#: dur_scale=6.0) of a valid info-op history whose frontier peaks at 270:
#: the ladder climbs 32 -> 128 -> 256 -> 512
LADDER_SEED = 40
#: the keyed register cell (testing.keyed_register_history): 32 keys of
#: 2,000 ops, 10 processes a key (the reference's register test with
#: --ops-per-key 2000, 2n threads a key on 5 nodes). Keys 3, 11, 19 and
#: 27 complete 1 % of their ops :info (the wave kernel cannot take them;
#: 3 and 11 share a batched ladder group, 19 and 27 climb alone), key 7
#: misreports some observations
KEYED_KEYS, KEYED_OPS, KEYED_PROCS, KEYED_SEED = 32, 2_000, 10, 2026
KEYED_FAULTED, KEYED_INFO_RATE, KEYED_CORRUPTED = (3, 11, 19, 27), 0.01, (7,)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median device time of one call (CUDA events), after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def tables_for(packs, dev, k_pad=None):
    """(tab, scal, wk) for packs sharing one (r_pad, wk) group, padded
    to ``k_pad`` keys (all-zero padding keys) when given."""
    import numpy as np
    import torch
    from jepsen_etcd_tpu_torch.ops import wgl, wgl_mxu
    wk = packs[0].w
    r_pad = max(max(wgl.bucket(p.R), wgl_mxu.TSUB) for p in packs)
    i32, u16 = wgl_mxu.pack_perop_batch(packs, r_pad, k_pad)
    tab, scal = wgl_mxu.build_tables(
        torch.from_numpy(i32).to(dev),
        torch.from_numpy(u16.astype(np.int32)).to(dev), r_pad, wk)
    return tab, scal, wk


def hold(tab, scal, wk, what: str) -> int:
    """Kernel vs plain version on the same CUDA tensors: exact."""
    import torch
    from jepsen_etcd_tpu_torch.ops import wgl_mxu
    got = wgl_mxu.wave_search(tab, scal, wk)
    torch.cuda.synchronize()
    ref = wgl_mxu.wave_search_reference(tab, scal, wk)
    err = int((got.long() - ref.long()).abs().max())
    print(f"  {what}: K={tab.shape[0]} r_pad={tab.shape[1]} wk={wk} "
          f"max_abs_err={err}", flush=True)
    if err != 0:
        fail(f"wgl_wave disagrees with its plain version on {what}")
    return err


def wgl_bound(waves: int, row_bytes: int, keys: int, wk: int):
    """(bound, bytes_ms, ops_ms) of wave searches that run ``waves``
    waves in all over ``keys`` keys: one table row and one scal row read
    per wave run and 16 B written per key; 64 operations per candidate
    per wave."""
    from jepsen_etcd_tpu_torch.ops import wgl_mxu
    bytes_ms = (waves * row_bytes + 16 * keys) / HBM_BYTES_PER_S * 1e3
    ops_ms = (waves * wgl_mxu.F * wk * WGL_OPS_PER_CANDIDATE
              / ALU32_OPS_PER_S * 1e3)
    return max(bytes_ms, ops_ms), bytes_ms, ops_ms


def wgl_phases(tab, scal, wk: int, card: str, kern_ms: float) -> None:
    """The phase split of one wave search (one key): the profiling
    instantiation of wgl_wave.cu sums, in thread 0 of the block, the SM
    cycles (clock64) each phase of a wave takes, and counts the
    frontier's filled states and the kept candidates. Prints them a
    wave, the kernel's time a wave from ``kern_ms`` (CUDA events, the
    plain instantiation) and the profiling instantiation's, and the SM
    clock its cycles and time imply. Fails when the profiling
    instantiation's result differs from the kernel's."""
    import torch
    from jepsen_etcd_tpu_torch.ops import _cuda, wgl_mxu
    names = _cuda.wgl_wave_phase_names()
    out = torch.empty((tab.shape[0], 4), dtype=torch.int32, device=tab.device)
    prof = torch.zeros((tab.shape[0], len(names) + 2), dtype=torch.int64,
                       device=tab.device)
    prof_ms = cuda_ms(lambda: _cuda.wgl_wave_profile(tab, scal, out, prof,
                                                     wk), 5)
    if not torch.equal(out, wgl_mxu.wave_search(tab, scal, wk)):
        fail("wgl_wave's profiling instantiation disagrees with the kernel")
    waves = int(out[0, 3])
    *cyc, filled, kept = [c / waves for c in prof[0].tolist()]
    us = kern_ms * 1e3 / waves
    split = dict(zip(names, cyc))
    prof_us = prof_ms * 1e3 / waves
    print(f"wgl_wave phases on {card}: R={int(scal[0, 0, wgl_mxu.S_R])} "
          f"wk={wk} "
          f"{waves} waves; SM cycles a wave: " + ", ".join(
              f"{n} {c:.1f} ({c / sum(cyc):.1%})" for n, c in split.items())
          + f"; total {sum(cyc):.1f} cycles a wave; kernel {kern_ms:.3f} ms, "
          f"{us:.4f} us a wave; profiling instantiation {prof_ms:.3f} ms, "
          f"{prof_us:.4f} us a wave, so an SM clock of "
          f"{sum(cyc) / prof_us / 1e3:.3f} GHz (the kernel takes "
          f"{us / prof_us:.3f} of its time); a wave leaves {filled:.3f} filled states "
          f"and keeps {kept:.3f} candidates on average", flush=True)


def lanes_ms(tab, scal, wk: int, n_lanes: int, reps: int) -> float:
    """Median device time of one wave search whose keys split evenly
    over ``n_lanes`` streams of the card: CUDA events from a common
    start to the last lane's end, after a warm-up."""
    import torch
    from jepsen_etcd_tpu_torch.ops import wgl_mxu
    per = tab.shape[0] // n_lanes
    streams = [torch.cuda.Stream() for _ in range(n_lanes)]

    def once() -> float:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        ends = []
        for lane, stream in enumerate(streams):
            stream.wait_event(start)
            with torch.cuda.stream(stream):
                wgl_mxu.wave_search(tab[lane * per:(lane + 1) * per],
                                    scal[lane * per:(lane + 1) * per], wk)
                end = torch.cuda.Event(enable_timing=True)
                end.record(stream)
                ends.append(end)
        torch.cuda.synchronize()
        return max(start.elapsed_time(e) for e in ends)

    once()
    return statistics.median(once() for _ in range(reps))


class GpuBusy:
    """The card's utilization (nvidia-smi ``utilization.gpu``: the share
    of each sample period in which a kernel ran) sampled every 100 ms
    while the block runs; ``share`` is their mean, None when nvidia-smi
    gave no samples."""

    def __enter__(self):
        self.share = None
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        samples = [int(x) for x in out.split() if x.isdigit()]
        if samples:
            self.share = sum(samples) / len(samples) / 100
        return False


def watch_inputs(history, concurrency: int, dev, stages=None):
    """The watch checker's edit-distance inputs for a history: its
    complete logs' threads, the wavefront's (a, b, m) on dev as the
    checker builds them (``edit_distance.device_inputs``), and the
    canonical log. ``stages`` (a dict) gets the host-clock seconds of
    grouping and of encoding, padding and the host-to-device copy."""
    import torch
    from jepsen_etcd_tpu_torch.checkers import watch
    from jepsen_etcd_tpu_torch.ops import edit_distance as ed
    stages = {} if stages is None else stages
    t0 = time.perf_counter()
    test = {"concurrency": concurrency}
    logs = watch.per_thread_logs(test, history)
    gaps = watch.per_thread_gaps(test, history)
    full = sorted(t for t in logs if not gaps.get(t))
    canonical = watch.canonical_log([logs[t] for t in full])
    stages["group"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = ed.device_inputs(canonical, [logs[t] for t in full], dev)
    torch.cuda.synchronize()
    stages["inputs"] = time.perf_counter() - t0
    return full, out, canonical


def fuzz_indel(seed: int, K: int, n: int, dev):
    """K logs around a random canonical log of n codes: copies, random
    logs up to n + 50 long, and (for K > 1) an empty one."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 6, n).astype(np.int32)
    logs = [a.copy() if k % 3 == 0 else
            rng.integers(0, 6, int(rng.integers(0, n + 50))).astype(np.int32)
            for k in range(K)]
    if K > 1:
        logs[-1] = logs[-1][:0]
    b = np.full((K, max([len(x) for x in logs] + [1])), -2, np.int32)
    for k, x in enumerate(logs):
        b[k, :len(x)] = x
    m = np.array([len(x) for x in logs], np.int32)
    return [torch.from_numpy(x).to(dev) for x in (a, b, m)]


def wide_indel(seed: int, n: int, dev):
    """A canonical log of n distinct codes and five short logs against
    it (m <= 3,000): an edited prefix, a reversed middle run, a sorted
    sample, a log of codes it lacks, an empty one. At n = 140,000 a lane
    owns 69 words, so its all-ones bitmap takes two words."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    a = rng.permutation(n).astype(np.int32)
    prefix = np.delete(a[:3000], rng.choice(3000, 40, replace=False))
    logs = [prefix, a[n // 2:n // 2 + 2000][::-1],
            np.sort(rng.choice(n, 2500, replace=False)).astype(np.int32),
            np.arange(n, n + 700, dtype=np.int32), prefix[:0]]
    b = np.full((len(logs), 3000), -2, np.int32)
    for k, x in enumerate(logs):
        b[k, :len(x)] = x
    m = np.array([len(x) for x in logs], np.int32)
    return [torch.from_numpy(x).to(dev) for x in (a, b, m)]


def hold_indel(a, b, m, what: str, dp: bool = True) -> int:
    """indel_bits vs its plain versions on the same CUDA tensors, exact:
    lcs_bits_reference (the same algorithm) and, with ``dp``,
    wavefront_reference (the anti-diagonal DP), each computed once, then
    the kernel with its state in shared memory and, reporting no shared
    memory to opt in to, in the global scratch. Prints each launch's
    device time (CUDA events, one cold launch) and the plain versions'
    host-clock times."""
    import torch
    from jepsen_etcd_tpu_torch.ops import _cuda
    from jepsen_etcd_tpu_torch.ops import edit_distance as ed
    refs, plain = [], []
    for fn in (ed.lcs_bits_reference, ed.wavefront_reference)[:1 + dp]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refs.append(fn(a, b, m).long())
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t0) * 1e3)
    if not torch.equal(refs[0], refs[-1]):
        fail(f"the plain versions disagree on {what}")
    optin = _cuda.indel_smem_optin
    words = _cuda.indel_state_words(a.shape[0])
    err = 0
    for forced in (False, True):
        limit = 0 if forced else optin(a.device)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        if forced:
            _cuda.indel_smem_optin = lambda dev: 0
        try:
            t0.record()
            got = ed.wavefront(a, b, m)
            t1.record()
        finally:
            _cuda.indel_smem_optin = optin
        torch.cuda.synchronize()
        e = max(int((got.long() - r).abs().max()) for r in refs) \
            if len(got) else 0
        regime = "shared" if words * 8 <= limit else "global"
        print(f"  {what}: K={b.shape[0]} n={a.shape[0]} max m="
              f"{int(m.max()) if len(m) else 0} V in {regime} memory "
              f"max_abs_err={e} ({t0.elapsed_time(t1):.3f} ms; plain "
              f"lcs_bits {plain[0]:.1f} ms"
              + (f", wavefront {plain[1]:.1f} ms)" if dp else ")"),
              flush=True)
        if e != 0:
            fail(f"indel_bits disagrees with its plain versions on {what} "
                 f"({regime} memory)")
        err = max(err, e)
    return err


def indel_kernel_ms(a, b, m, reps: int, regime: str = "shared") -> float:
    """Median device time of indel_bits' launch alone, its state in
    shared memory or (``regime="global"``) in a global scratch buffer,
    the match index built once outside the timed calls and the binding
    called directly (no count)."""
    import torch
    from jepsen_etcd_tpu_torch.ops import _cuda
    from jepsen_etcd_tpu_torch.ops import edit_distance as ed
    order, lo, hi = ed.match_index(a, b)
    out = torch.empty(b.shape[0], dtype=torch.int32, device=a.device)
    scratch = None if regime == "shared" else torch.empty(
        (b.shape[0], _cuda.indel_state_words(a.shape[0])),
        dtype=torch.int64, device=a.device)
    return cuda_ms(lambda: _cuda.indel_bits(order, lo, hi, m, out, scratch),
                   reps)


def indel_regimes(a, b, m, what: str, card: str) -> dict:
    """indel_bits' launch alone with its state in shared and in global
    memory: two medians of 11 for each, the regimes alternating, and the
    median of the two."""
    times = {"shared": [], "global": []}
    for i in range(2):
        for regime in sorted(times, reverse=i == 1):
            times[regime].append(indel_kernel_ms(a, b, m, 11, regime))
    ms = {r: statistics.median(t) for r, t in times.items()}
    print(f"  {what} on {card}: indel_bits alone, state in shared memory "
          f"{ms['shared']:.3f} ms {times['shared']}, in global memory "
          f"{ms['global']:.3f} ms {times['global']} (global / shared "
          f"{ms['global'] / ms['shared']:.3f})", flush=True)
    return ms


def indel_work(a, b, m) -> dict:
    """What indel_bits does on these inputs, counted from the match
    index: steps (the sum of m_k), matched steps (those with a match
    position), the words those change (the distinct words of their
    positions), the operations (INDEL_BITS_* above) and, to compare, the
    word-steps of the dense bit-parallel pass (sum of m_k * ceil(n /
    64))."""
    import torch
    from jepsen_etcd_tpu_torch.ops import edit_distance as ed
    dev = a.device
    order, lo, hi = ed.match_index(a, b)
    live = torch.arange(b.shape[1], device=dev)[None, :] < m[:, None]
    cnt = torch.where(live, hi - lo, 0).reshape(-1).long()
    total = int(cnt.sum())
    step = torch.repeat_interleave(torch.arange(cnt.numel(), device=dev),
                                   cnt, output_size=total)
    first = torch.cumsum(cnt, 0) - cnt
    word = order.long()[lo.reshape(-1).long()[step]
                        + torch.arange(total, device=dev) - first[step]] >> 6
    new = torch.ones(total, dtype=torch.bool, device=dev)
    new[1:] = (step[1:] != step[:-1]) | (word[1:] != word[:-1])
    steps, matched, words = int(m.sum()), int((cnt > 0).sum()), int(new.sum())
    ops = (steps * INDEL_BITS_SHUFFLES_PER_STEP * 32
           + matched * (INDEL_BITS_BALLOTS_PER_MATCHED_STEP * 32
                        + INDEL_BITS_OPS_PER_WORD)
           + words * INDEL_BITS_OPS_PER_WORD)
    dense = steps * -(-a.shape[0] // 64)
    # the function's bytes: a, the logs' live codes and m read, out written
    bytes_ms = 4 * (a.shape[0] + steps + 2 * m.shape[0]) \
        / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ALU32_OPS_PER_S * 1e3
    return {"steps": steps, "matched": matched, "words": words, "ops": ops,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms), "dense_word_steps": dense,
            "dense_ms": dense * INDEL_BITS_OPS_PER_WORD
            / ALU32_OPS_PER_S * 1e3}


def work_text(w: dict) -> str:
    return (f"bound {w['bound_ms']:.6f} ms (operations {w['ops_ms']:.6f} ms:"
            f" {w['steps']} steps, {w['matched']} with a match, "
            f"{w['words']} words changed, {w['ops']} operations; bytes "
            f"{w['bytes_ms']:.6f} ms); the kernel is limited by its chain "
            f"of dependent steps, not by either; the dense bit-parallel "
            f"pass would do {w['dense_word_steps']} word-steps, "
            f"{w['dense_ms']:.6f} ms at {INDEL_BITS_OPS_PER_WORD} a "
            f"word-step")


def keyed_register_check(card: str) -> list:
    """The keyed register cell through the register workload's checker,
    ``Independent(Compose({linear, session}))``: every key's verdict
    against the native DFS, the routes the keys take, the wave kernel's
    launches (one per (r_pad, wk) group on the card's one lane, two when
    the batch is split over two lanes of it: same result), the check's
    stages and walls, and wgl_wave's batched launch held exactly against
    two lanes and its plain version. Returns the kernels line's entries
    for the batched and the sharded launch."""
    import numpy as np
    import torch
    from jepsen_etcd_tpu_torch.checkers import (
        SessionGuarantees, TPULinearizableChecker, compose,
        independent_checker)
    from jepsen_etcd_tpu_torch.checkers.linearizable import check_history
    from jepsen_etcd_tpu_torch.models import VersionedRegister
    from jepsen_etcd_tpu_torch.ops import wgl, wgl_mxu
    from jepsen_etcd_tpu_torch.testing import keyed_register_history

    dev0 = torch.device("cuda", 0)
    t0 = time.perf_counter()
    h = keyed_register_history(KEYED_KEYS, KEYED_OPS, KEYED_PROCS,
                               KEYED_SEED, KEYED_FAULTED, KEYED_INFO_RATE,
                               KEYED_CORRUPTED)
    print(f"keyed register cell: {KEYED_KEYS} keys x {KEYED_OPS} ops, "
          f"{len(h)} entries, made in {time.perf_counter() - t0:.2f} s",
          flush=True)
    linear = TPULinearizableChecker()
    checker = independent_checker(compose({
        "linear": linear, "session": SessionGuarantees()}))
    one_lane = wgl_mxu.batch_lanes

    def drive(lanes):
        """One keyed check with the launch lanes substituted; the
        kernel's launch count is read around it."""
        wgl_mxu.batch_lanes = lanes
        try:
            torch.cuda.synchronize()
            wgl_mxu.LAUNCHES = 0
            t0 = time.perf_counter()
            out = checker.check({}, h)
            torch.cuda.synchronize()
            return out, wgl_mxu.LAUNCHES, time.perf_counter() - t0
        finally:
            wgl_mxu.batch_lanes = one_lane

    res, launches, wall = drive(one_lane)
    res2, launches2, wall2 = drive(lambda device=None: [dev0, dev0])

    # the routes the keys must take, from their packs
    subs = h.split_by_key()
    packs = wgl.pack_register_histories_batched(subs)
    b1_keys = [k for k in subs if wgl_mxu.supported(packs[k])]
    groups = {(max(wgl.bucket(packs[k].R), wgl_mxu.TSUB), packs[k].w)
              for k in b1_keys}
    # the other keys ride the ladder: a key alone in its group_key climbs
    # it from rung 32; a group of several runs the batched rung at 128,
    # where a key that overflows climbs on alone from F_MAX
    rest = [k for k in subs if k not in b1_keys]
    shared = [wgl.group_key(packs[k]) for k in rest]
    grouped = [k for k, g in zip(rest, shared) if shared.count(g) > 1]
    lone = [k for k, g in zip(rest, shared) if shared.count(g) == 1]
    lin = {k: r["linear"] for k, r in res["results"].items()}
    ses = {k: r["session"] for k, r in res["results"].items()}
    engines = {}
    for k in subs:
        engines.setdefault(str(lin[k].get("engine")), []).append(k)
        dfs = check_history(VersionedRegister(), subs[k])
        if lin[k]["valid?"] is not dfs["valid?"]:
            fail(f"keyed cell, key {k}: {lin[k]} but native DFS {dfs}")
    batched = [k for k in subs if lin[k].get("batched")]
    climbed = [k for k in grouped if k not in batched]
    print(f"keyed check: valid?={res['valid?']} wall {wall:.3f} s, "
          f"wgl_wave launches {launches} for {len(groups)} (r_pad, wk) "
          f"group(s) of {len(b1_keys)} keys; engines {engines}; ladder "
          f"groups of several keys {grouped}: batched {batched}, "
          f"overflowed the batched rung {climbed}; alone on the ladder "
          f"{lone}; every key's verdict = native DFS", flush=True)
    shown = ("valid?", "engine", "batched", "rungs", "waves",
             "peak-frontier", "checker")
    for k in list(KEYED_FAULTED) + list(KEYED_CORRUPTED):
        fields = {f: lin[k].get(f) for f in shown}
        print(f"  key {k}: {len(subs[k])} entries R={packs[k].R} "
              f"I={packs[k].I} info_dims={wgl.info_dims(packs[k])} "
              f"linear={fields} diagnostics="
              f"{'op' in lin[k] or 'error' in lin[k]} "
              f"session={ses[k]['valid?']}", flush=True)
    print(f"keyed check over two lanes of the card: wall {wall2:.3f} s, "
          f"wgl_wave launches {launches2}, same result: {res2 == res}",
          flush=True)
    if res["valid?"] is not False:
        fail(f"keyed check merged verdict {res['valid?']}")
    for k in KEYED_CORRUPTED:
        if lin[k]["valid?"] is not False or not (
                "op" in lin[k] or "error" in lin[k]):
            fail(f"corrupted key {k}: {lin[k]}")
    if sorted(engines.get("mxu-wave", [])) != sorted(b1_keys):
        fail(f"wave-kernel keys {b1_keys}, engines {engines}")
    if not batched or not set(batched) <= set(grouped) or not lone or \
            any(lin[k].get("engine") != "jnp-ladder" for k in lone + climbed):
        fail(f"ladder keys: grouped {grouped}, batched {batched}, lone "
             f"{lone}: { {k: lin[k] for k in rest} }")
    if any(ses[k]["valid?"] is not True for k in subs
           if k not in KEYED_CORRUPTED):
        fail(f"session verdicts {ses}")
    if launches != len(groups) or launches2 != 2 * len(groups):
        fail(f"wgl_wave launches {launches} / {launches2} for "
             f"{len(groups)} group(s)")
    if res2 != res:
        fail("the keyed check over two lanes differs from one lane")

    # the check's stages, one by one on the host clock, each ending in
    # a synchronization
    stages = {}
    t0 = time.perf_counter()
    subs = h.split_by_key()
    stages["split"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    packs = wgl.pack_register_histories_batched(subs)
    stages["pack"] = time.perf_counter() - t0
    if len(groups) != 1:
        fail(f"the keyed cell's wave-kernel keys form {groups}")
    (r_pad, wk), = groups
    b1 = [packs[k] for k in b1_keys]
    # the wave kernel's stage as check_batch pays it, median of 11 calls
    # each, on the card's one lane and split over two lanes of it:
    # "launch" is launch_packed_batch_mxu (pack_perop_batch, the copies
    # to the card, build_tables and the launches, on the lanes' streams,
    # not waited for), "readback" the wait and the copy back
    rows = {}
    for name, lanes in (("one lane", one_lane),
                        ("two lanes", lambda device=None: [dev0, dev0])):
        wgl_mxu.batch_lanes = lanes
        launch_s, read_s = [], []
        try:
            for _ in range(11):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                launched = wgl_mxu.launch_packed_batch_mxu(b1)
                t1 = time.perf_counter()
                rows[name] = wgl_mxu.readback(launched)[0][1]
                launch_s.append(t1 - t0)
                read_s.append(time.perf_counter() - t1)
        finally:
            wgl_mxu.batch_lanes = one_lane
        stages[f"launch, {name}"] = statistics.median(launch_s)
        stages[f"readback, {name}"] = statistics.median(read_s)
    outs = {k: wgl_mxu._decode(rows["one lane"][j], packs[k])
            for j, k in enumerate(b1_keys)}
    # the ladder, one group_key group at a time (as check_packed_batch
    # runs them)
    ladder_groups: dict = {}
    for k in rest:
        ladder_groups.setdefault(wgl.group_key(packs[k]), []).append(k)
    for keys in ladder_groups.values():
        t0 = time.perf_counter()
        outs.update(zip(keys, wgl.check_packed_batch(
            [packs[k] for k in keys])))
        torch.cuda.synchronize()
        stages[f"ladder {keys}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k in subs:
        linear._finalize(subs[k], outs[k], pack=packs[k],
                         band=(None, None, 0))
    stages["finalize"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k in subs:
        SessionGuarantees().check({}, subs[k])
    stages["session"] = time.perf_counter() - t0
    print("keyed check stages (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()), flush=True)

    # the whole check, repeated, with the card's utilization sampled
    walls = []
    with GpuBusy() as busy:
        for _ in range(11):
            t0 = time.perf_counter()
            checker.check({}, h)
            walls.append(time.perf_counter() - t0)
    walls.sort()
    wmed, wp90 = walls[5], walls[9]

    # wgl_wave's batched launch at the cell's shape: device time alone,
    # and held against two lanes of the card and the plain version
    k_pad = wgl_mxu._batch_geometry(len(b1), 1)[0]
    tab, scal, _ = tables_for(b1, dev0, k_pad)
    got = wgl_mxu.wave_search(tab, scal, wk).cpu()
    b1_ms = cuda_ms(lambda: wgl_mxu.wave_search(tab, scal, wk), 11)
    two_ms = lanes_ms(tab, scal, wk, 2, 11)
    one, two = rows["one lane"], rows["two lanes"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = wgl_mxu.wave_search_reference(tab, scal, wk)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ref = ref.cpu().numpy()
    err = int(np.abs(got.numpy().astype(np.int64) - ref).max())
    err_one = int(np.abs(one.astype(np.int64) - ref).max())
    err_two = int(np.abs(two.astype(np.int64) - one).max())
    waves = int(ref[:len(b1), 3].sum())
    bound, bytes_ms, ops_ms = wgl_bound(
        waves, (tab.shape[2] + scal.shape[2]) * 4, len(b1), wk)
    idle = "not measured" if busy.share is None else f"{1 - busy.share:.3f}"
    print(f"keyed check timing on {card}: wall over {len(walls)} runs "
          f"median {wmed:.4f} s, p90 {wp90:.4f} s; device idle share "
          f"{idle} (1 - mean nvidia-smi utilization over the runs; "
          f"1 - B1 / median check = {1 - b1_ms / 1e3 / wmed:.3f}); "
          f"wgl_wave batched {len(b1)} keys (k_pad {tab.shape[0]}, r_pad "
          f"{r_pad}) {b1_ms:.3f} ms, over two lanes of the card "
          f"{two_ms:.3f} ms, plain {plain_ms:.1f} ms, {waves} waves in "
          f"all, bound {bound:.4f} ms (bytes {bytes_ms:.4f} ms, "
          f"operations {ops_ms:.4f} ms); max_abs_err launch/plain {err}, "
          f"one lane/plain {err_one}, two lanes/one lane {err_two}",
          flush=True)
    if err or err_one or err_two:
        fail("wgl_wave's batched launch disagrees across lanes or with "
             "its plain version")
    entry = {"route": "cuda",
             "source": "jepsen_etcd_tpu_torch/csrc/wgl_wave.cu",
             "plain_ms": plain_ms, "bound_ms": bound,
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
             "library_ms": None}
    return [{"name": "wgl_wave_batch",
             "replaces": "jepsen_etcd_tpu/ops/wgl_mxu.py:862",
             "launches": launches, "max_abs_err": max(err, err_one),
             "ms": b1_ms, **entry},
            {"name": "wgl_wave_sharded",
             "replaces": "jepsen_etcd_tpu/ops/wgl_mxu.py:902",
             "launches": launches2, "max_abs_err": err_two,
             "ms": two_ms, **entry}]


def hold_history(hist, what: str, dev) -> int:
    """wgl_wave against its plain version on one history's tables."""
    from jepsen_etcd_tpu_torch.ops import wgl
    return hold(*tables_for([wgl.pack_register_history(hist)], dev), what)


def hold_wgl_fuzz(dev):
    """wgl_wave held against its plain version on the fuzz: four
    histories each at wk = 32, 64 and 128, clean and corrupted; twelve
    histories of unversioned concurrent writes at each width in one
    launch (one mask, several values: the partial dedupe kills
    candidates); a batch of 64 keys x 200 ops in one launch and one
    2k-op key. Returns the largest error (0) and the batch's packs."""
    from jepsen_etcd_tpu_torch.ops import wgl, wgl_mxu
    from jepsen_etcd_tpu_torch.testing import (gen_history,
                                               unversioned_rounds_history)
    max_err = 0
    rng = random.Random(7)
    shapes = {32: dict(n_procs=4, n_ops=40),
              64: dict(n_procs=16, n_ops=100, dur_scale=20.0),
              128: dict(n_procs=34, n_ops=130, dur_scale=30.0)}
    for wk, kw in shapes.items():
        for corrupt in (False, True):
            packs = []
            for _ in range(400):
                p = wgl.pack_register_history(
                    gen_history(rng, corrupt=corrupt, **kw))
                if wgl_mxu.supported(p) and p.w == wk:
                    packs.append(p)
                if len(packs) == 4:
                    break
            if len(packs) < 4:
                fail(f"fuzz found too few w={wk} histories")
            for i, p in enumerate(packs):
                max_err = max(max_err, hold(
                    *tables_for([p], dev),
                    f"fuzz w={wk} corrupt={corrupt} #{i}"))
    for wk, wide in ((32, 0), (64, 40), (128, 90)):
        urng = random.Random(11)
        packs = []
        for _ in range(12):
            sizes = [urng.randint(1, 4) for _ in range(urng.randint(4, 8))]
            if wide:
                sizes.insert(len(sizes) // 2, wide)
            packs.append(wgl.pack_register_history(
                unversioned_rounds_history(urng, sizes)))
        if any(not wgl_mxu.supported(p) or p.w != wk for p in packs):
            fail(f"unversioned writes did not pack at w={wk}")
        max_err = max(max_err, hold(*tables_for(packs, dev),
                                    f"12 unversioned-write histories w={wk}"))
    batch = []
    while len(batch) < 64:
        p = wgl.pack_register_history(gen_history(
            rng, n_procs=4, n_ops=200, corrupt=len(batch) % 3 == 0))
        if wgl_mxu.supported(p) and p.w == 32:
            batch.append(p)
    max_err = max(max_err, hold(*tables_for(batch, dev),
                                "batch of 64 keys x 200 ops"))
    p2k = wgl.pack_register_history(
        gen_history(random.Random(11), n_procs=6, n_ops=2_000))
    max_err = max(max_err, hold(*tables_for([p2k], dev), "one 2k-op key"))
    return max_err, batch


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    from jepsen_etcd_tpu_torch.checkers.linearizable import check_history
    from jepsen_etcd_tpu_torch.checkers.tpu_linearizable import \
        TPULinearizableChecker
    from jepsen_etcd_tpu_torch.models import VersionedRegister
    from jepsen_etcd_tpu_torch.checkers.watch import WatchChecker
    from jepsen_etcd_tpu_torch.ops import _cuda, wgl, wgl_mxu
    from jepsen_etcd_tpu_torch.ops import edit_distance as ed
    from jepsen_etcd_tpu_torch.testing import concurrent_writes_history, \
        gen_history, gen_watch_history, impossible_read_at

    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)

    # -- 1. build -----------------------------------------------------
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    sources = ["wgl_wave", "indel_bits"]
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_cuda.build, sources))
    print(f"build: {', '.join(s + '.cu' for s in sources)} (in parallel) "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)

    # -- 2. kernel vs plain on the card -------------------------------
    print("kernel vs plain (exact, tolerance 0):", flush=True)
    max_err, batch = hold_wgl_fuzz(dev)
    print("indel_bits vs plain (exact, tolerance 0):", flush=True)
    ed_err = 0
    for seed, K, n in [(1, 1, 0), (2, 3, 1), (3, 5, 130), (4, 9, 600),
                       (5, 4, 2000), (7, 3, 12_000)]:
        ed_err = max(ed_err, hold_indel(*fuzz_indel(seed, K, n, dev),
                                        f"fuzz seed {seed}"))
    ed_err = max(ed_err, hold_indel(*wide_indel(6, 140_000, dev),
                                    "140,000 distinct values, short logs",
                                    dp=False))
    wbad = gen_watch_history(random.Random(WATCH_SEED),
                             n_writers=WATCH_WRITERS,
                             n_watchers=WATCH_WATCHERS,
                             n_writes=WATCH_WRITES, corrupt="drop",
                             corrupt_thread=2)
    wconc = WATCH_WRITERS + WATCH_WATCHERS
    ed_err = max(ed_err, hold_indel(*watch_inputs(wbad, wconc, dev)[1],
                                    "watch logs, one corrupted"))
    wlong = gen_watch_history(random.Random(WATCH_SEED + 1),
                              n_writers=WATCH_WRITERS,
                              n_watchers=WATCH_WATCHERS,
                              n_writes=WATCH_LONG_WRITES,
                              corrupt="reorder")
    long_in = watch_inputs(wlong, wconc, dev)[1]
    ed_err = max(ed_err, hold_indel(*long_in,
                                    "long watch logs, one corrupted"))
    long_ms = cuda_ms(lambda: ed.wavefront(*long_in), 11)
    long_kernel_ms = indel_regimes(*long_in, "long watch logs",
                                   card)["shared"]
    long_steps = int(long_in[2].max())
    print(f"  long watch logs on {card}: indel_bits {long_ms:.3f} ms "
          f"through wavefront (median of 11), {long_steps} steps, "
          f"{long_kernel_ms * 1e3 / long_steps:.4f} us a step alone; "
          f"{work_text(indel_work(*long_in))}", flush=True)
    del wlong, long_in

    # -- 3. the main path at full size --------------------------------
    h = gen_history(random.Random(MAIN_SEED), n_procs=MAIN_PROCS,
                    n_ops=MAIN_OPS)
    bad = gen_history(random.Random(MAIN_SEED), n_procs=MAIN_PROCS,
                      n_ops=MAIN_OPS, corrupt=True)
    checker = TPULinearizableChecker()
    torch.cuda.synchronize()
    wgl_mxu.LAUNCHES = ed.LAUNCHES = 0
    t0 = time.perf_counter()
    res = checker.check({}, h)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = wgl_mxu.LAUNCHES
    t0 = time.perf_counter()
    res_bad = checker.check({}, bad)
    wall_bad_s = time.perf_counter() - t0
    launches_bad = wgl_mxu.LAUNCHES - launches
    print(f"main path: {len(h)} entries -> {json.dumps(res)}", flush=True)
    print(f"main path (corrupted copy): {len(bad)} entries -> valid?="
          f"{res_bad['valid?']} engine={res_bad.get('engine')} "
          f"launches={launches_bad}", flush=True)
    if res.get("valid?") is not True or res.get("engine") != "mxu-wave":
        fail(f"main path verdict {res}")
    if launches < 1 or launches_bad < 1:
        fail("the main path did not launch wgl_wave")
    if res_bad.get("valid?") is not False:
        fail(f"corrupted history not refuted: {res_bad}")
    dfs = check_history(VersionedRegister(), h)
    if dfs["valid?"] is not res["valid?"]:
        fail(f"native DFS disagrees: {dfs}")
    max_err = max(max_err, hold_history(bad, "register 10k cell, corrupted",
                                        dev))

    # -- 4. timing at the main path's shapes --------------------------
    # one check's stages on the host clock, each ending in a sync
    stages = {}
    t0 = time.perf_counter()
    p = wgl.pack_register_history(h)
    stages["pack"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tab, scal, wk = tables_for([p], dev)
    torch.cuda.synchronize()
    stages["tables"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = wgl_mxu.wave_search(tab, scal, wk).cpu().numpy()[0]
    stages["kernel"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wgl_mxu._decode(out, p)
    stages["decode"] = time.perf_counter() - t0
    print("main path stages (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()), flush=True)
    t_pack = stages["pack"]
    btab, bscal, bwk = tables_for(batch, dev)
    batch_ms = cuda_ms(lambda: wgl_mxu.wave_search(btab, bscal, bwk), 21)
    bwaves = int(wgl_mxu.wave_search(btab, bscal, bwk)[:, 3].sum())
    bbound, bbytes_ms, bops_ms = wgl_bound(
        bwaves, (btab.shape[2] + bscal.shape[2]) * 4, len(batch), bwk)
    print(f"batch of {len(batch)} keys (r_pad {btab.shape[1]}): one "
          f"launch {batch_ms:.3f} ms, {bwaves} waves in all, bound "
          f"{bbound:.4f} ms (bytes {bbytes_ms:.4f} ms, operations "
          f"{bops_ms:.4f} ms)", flush=True)
    kern_ms = cuda_ms(lambda: wgl_mxu.wave_search(tab, scal, wk), 21)
    wgl_phases(tab, scal, wk, card, kern_ms)
    # end-to-end: the whole check, repeated (median and p90 of 110)
    walls = []
    for _ in range(110):
        t0 = time.perf_counter()
        checker.check({}, h)
        walls.append(time.perf_counter() - t0)
    walls.sort()
    wall_med, wall_p90 = walls[55], walls[98]
    print(f"main path check wall over {len(walls)} runs: median "
          f"{wall_med:.4f} s, p90 {wall_p90:.4f} s; device idle share "
          f"{1 - kern_ms / 1e3 / wall_med:.3f} (1 - kernel / median "
          f"check)", flush=True)
    # pack_register_history (the batched packer) against the per-key
    # packer it took over from: each alone (11 calls) and the whole
    # check with each (21 runs), interleaved, alternating which goes
    # first
    packers = {"batched": wgl.pack_register_history,
               "per-key": wgl._pack_reference}
    pack_s = {name: [] for name in packers}
    check_s = {name: [] for name in packers}
    for i in range(21):
        for name in sorted(packers, reverse=i % 2 == 1):
            if i < 11:
                t0 = time.perf_counter()
                packers[name](h)
                pack_s[name].append(time.perf_counter() - t0)
            wgl.pack_register_history = packers[name]
            try:
                t0 = time.perf_counter()
                checker.check({}, h)
                check_s[name].append(time.perf_counter() - t0)
            finally:
                wgl.pack_register_history = packers["batched"]
    print(f"register packers on {card}: " + "; ".join(
        f"{name}: pack median {statistics.median(pack_s[name]):.4f} s "
        f"[{min(pack_s[name]):.4f}-{max(pack_s[name]):.4f}], check median "
        f"{statistics.median(check_s[name]):.4f} s "
        f"[{min(check_s[name]):.4f}-{max(check_s[name]):.4f}]"
        for name in packers), flush=True)
    t0 = time.perf_counter()
    ref = wgl_mxu.wave_search_reference(tab, scal, wk)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = wgl_mxu.wave_search(tab, scal, wk)
    err = int((got.long() - ref.long()).abs().max())
    max_err = max(max_err, err)
    if err != 0:
        fail("wgl_wave disagrees with its plain version at full size")
    waves = int(got[0, 3])
    bound_ms, bytes_ms, ops_ms = wgl_bound(
        waves, (tab.shape[2] + scal.shape[2]) * 4, 1, wk)
    print(f"main path timing on {card}: check wall {wall_s:.3f} s "
          f"(pack {t_pack:.3f} s), kernel {kern_ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms, waves {waves} "
          f"({kern_ms * 1e3 / waves:.2f} us/wave), peak-frontier "
          f"{int(got[0, 2])}, bound {bound_ms:.4f} ms (bytes "
          f"{bytes_ms:.4f} ms, operations {ops_ms:.4f} ms); corrupted "
          f"check wall {wall_bad_s:.3f} s", flush=True)

    # -- 5. the watch path at full size --------------------------------
    wh = gen_watch_history(random.Random(WATCH_SEED),
                           n_writers=WATCH_WRITERS,
                           n_watchers=WATCH_WATCHERS, n_writes=WATCH_WRITES)
    wtest = {"concurrency": wconc}
    wchecker = WatchChecker()
    torch.cuda.synchronize()
    wgl_mxu.LAUNCHES = ed.LAUNCHES = 0
    t0 = time.perf_counter()
    wres = wchecker.check(wtest, wh)
    wall_w = time.perf_counter() - t0
    watch_launches = ed.LAUNCHES
    t0 = time.perf_counter()
    wres_bad = wchecker.check(wtest, wbad)
    wall_w_bad = time.perf_counter() - t0
    watch_launches_bad = ed.LAUNCHES - watch_launches
    print(f"watch path: {len(wh)} entries, {WATCH_WATCHERS} logs -> "
          f"valid?={wres['valid?']} revisions={wres['revisions']} "
          f"launches={watch_launches} wall {wall_w:.3f} s", flush=True)
    if wres.get("valid?") is not True:
        fail(f"watch path verdict {wres}")
    if watch_launches < 1 or watch_launches_bad < 1:
        fail("the watch path did not launch indel_bits")
    full, (wa, wb, wm), canonical = watch_inputs(wbad, wconc, dev)
    plain_d = dict(zip(full, ed.wavefront_reference(wa, wb, wm).tolist()))
    deltas = {d["thread"]: d["edit-distance"]
              for d in wres_bad.get("deltas", [])}
    print(f"watch path (corrupted copy): valid?={wres_bad['valid?']} "
          f"edit-distance by thread {deltas}, plain version "
          f"{plain_d} launches={watch_launches_bad} wall "
          f"{wall_w_bad:.3f} s", flush=True)
    if wres_bad.get("valid?") is not False or not deltas:
        fail(f"corrupted watch history not refuted: {wres_bad}")
    if any(plain_d[t] != d for t, d in deltas.items()) or \
            {t for t, d in plain_d.items() if d} != set(deltas):
        fail("watch edit distances differ from the plain version")
    small = gen_watch_history(random.Random(5), n_writes=600,
                              per_watch=50, corrupt="duplicate")
    on_card = WatchChecker(use_tpu=True).check(wtest, small)
    on_host = WatchChecker(use_tpu=False).check(wtest, small)
    if on_card != on_host or on_card["valid?"] is not False:
        fail("watch checker on the card disagrees with the Python DP")
    # one check's stages on the host clock (diff_report: the corrupted
    # copy's deltas, the only logs it runs on)
    from jepsen_etcd_tpu_torch.checkers import watch
    bad_logs = watch.per_thread_logs(wtest, wbad)
    t0 = time.perf_counter()
    for t in deltas:
        ed.diff_report(canonical, bad_logs[t])
    t_diff = time.perf_counter() - t0
    wstages = {}
    wa, wb, wm = watch_inputs(wh, wconc, dev, wstages)[1]
    t0 = time.perf_counter()
    ed.wavefront(wa, wb, wm).cpu()
    wstages["kernel"] = time.perf_counter() - t0
    wstages["diff_report"] = t_diff
    print("watch path stages (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in wstages.items()), flush=True)
    b2_ms = cuda_ms(lambda: ed.wavefront(wa, wb, wm), 11)
    b2_kernel_ms = indel_regimes(wa, wb, wm, "watch logs", card)["shared"]
    wwalls = []
    for _ in range(21):
        t0 = time.perf_counter()
        wchecker.check(wtest, wh)
        wwalls.append(time.perf_counter() - t0)
    wwalls.sort()
    wmed, wp90 = wwalls[10], wwalls[18]
    b2_plain = {}
    for name, fn in (("lcs_bits", ed.lcs_bits_reference),
                     ("wavefront", ed.wavefront_reference)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b2_ref = fn(wa, wb, wm)
        torch.cuda.synchronize()
        b2_plain[name] = (time.perf_counter() - t0) * 1e3
        got = ed.wavefront(wa, wb, wm)
        b2_err = int((got.long() - b2_ref.long()).abs().max())
        ed_err = max(ed_err, b2_err)
        if b2_err != 0:
            fail(f"indel_bits disagrees with {name} on the watch path")
    b2_plain_ms = b2_plain["lcs_bits"]
    n_can = wa.shape[0]
    steps = int(wm.max())
    b2_work = indel_work(wa, wb, wm)
    cells = sum((n_can + 1) * (int(x) + 1) for x in wm.tolist())
    dp_bound_ms = cells * DP_OPS_PER_CELL / ALU32_OPS_PER_S * 1e3
    print(f"watch path timing on {card}: check wall over {len(wwalls)} "
          f"runs median {wmed:.4f} s, p90 {wp90:.4f} s; indel_bits "
          f"{b2_ms:.3f} ms through wavefront (index and launch), kernel "
          f"alone {b2_kernel_ms:.3f} ms (medians of 11), "
          f"{b2_kernel_ms * 1e3 / steps:.4f} us a step, {steps} steps; "
          f"plain lcs_bits {b2_plain['lcs_bits']:.1f} ms, plain wavefront "
          f"{b2_plain['wavefront']:.1f} ms; {work_text(b2_work)}; the old "
          f"algorithm's work, {cells} DP cells at {DP_OPS_PER_CELL} "
          f"operations: {dp_bound_ms:.4f} ms; device idle share "
          f"{1 - b2_ms / 1e3 / wmed:.3f} (1 - indel_bits / median check)",
          flush=True)

    # -- 6. the capacity ladder, the spill BFS and check_prefix ----------
    big = gen_history(random.Random(MAIN_SEED), n_procs=LADDER_BIG_PROCS,
                      n_ops=MAIN_OPS)
    big_bad = impossible_read_at(big, LADDER_BIG_AT)
    for what, hist, engine in [("valid", big, "mxu-wave"),
                               ("impossible read", big_bad, "jnp-ladder")]:
        max_err = max(max_err, hold_history(
            hist, f"ladder at real size, {what}", dev))
        t0 = time.perf_counter()
        out = checker.check({}, hist)
        wall_l = time.perf_counter() - t0
        dfs = check_history(VersionedRegister(), hist)
        print(f"ladder at real size, {LADDER_BIG_PROCS} processes, "
              f"{len(hist)} entries, {what}: valid?={out['valid?']} "
              f"engine={out.get('engine')} rungs={out.get('rungs')} "
              f"peak-frontier={out.get('peak-frontier')} waves="
              f"{out.get('waves')} overflowed-en-route="
              f"{out.get('overflowed-en-route', False)} check wall "
              f"{wall_l:.3f} s; native DFS valid?={dfs['valid?']}",
              flush=True)
        if out.get("engine") != engine or out["valid?"] is not dfs["valid?"]:
            fail(f"ladder at real size, {what}: {out}")
    # the ladder alone (wave kernel, then rungs 32 and 128), its waves
    # replayed from CUDA graphs and issued one by one: same dict
    p = wgl.pack_register_history(big_bad)
    t0 = time.perf_counter()
    graphed = wgl.check_packed(p)
    torch.cuda.synchronize()
    wall_graph = time.perf_counter() - t0
    graph_min = wgl.GRAPH_MIN_WAVES
    wgl.GRAPH_MIN_WAVES = 1 << 62
    try:
        t0 = time.perf_counter()
        eager = wgl.check_packed(p)
        torch.cuda.synchronize()
        wall_eager = time.perf_counter() - t0
    finally:
        wgl.GRAPH_MIN_WAVES = graph_min
    lwaves = graphed.get("waves", 0)
    print(f"ladder at real size, check_packed: {lwaves} waves, rungs "
          f"{graphed.get('rungs')}; CUDA graphs {wall_graph:.3f} s "
          f"({wall_graph / lwaves * 1e3:.3f} ms a wave), eager "
          f"{wall_eager:.3f} s ({wall_eager / lwaves * 1e3:.3f} ms a "
          f"wave); same dict: {graphed == eager}", flush=True)
    if graphed != eager or graphed.get("engine") != "jnp-ladder":
        fail(f"ladder with CUDA graphs {graphed} != eager {eager}")
    lchecker = TPULinearizableChecker(cpu_cutoff=None)
    ladder_cases = [
        ("info-op history", gen_history(
            random.Random(LADDER_SEED), n_procs=10, n_ops=60, values=4,
            info_rate=0.25, dur_scale=6.0)),
        ("12 concurrent writes, read 9", concurrent_writes_history(
            12, read_val=9))]
    for what, hist in ladder_cases:
        t0 = time.perf_counter()
        out = lchecker.check({}, hist)
        wall_l = time.perf_counter() - t0
        dfs = check_history(VersionedRegister(), hist)
        print(f"ladder: {what}: valid?={out['valid?']} engine="
              f"{out.get('engine')} rungs={out.get('rungs')} "
              f"peak-frontier={out.get('peak-frontier')} waves="
              f"{out.get('waves')} wall {wall_l:.3f} s; native DFS "
              f"valid?={dfs['valid?']}", flush=True)
        if out.get("engine") != "jnp-ladder" or out.get("rungs", 0) < 3 \
                or out["valid?"] is not dfs["valid?"]:
            fail(f"ladder on {what}: {out}")
        p = wgl.pack_register_history(hist)
        one_shot = wgl.check_packed(p)
        state = None
        while state is None or not state.done:
            state = wgl.check_prefix(p, state, max_waves=64)
        print(f"  check_prefix (64 waves a call) ends on the one-shot "
              f"dict: {state.result == one_shot}", flush=True)
        if state.result != one_shot:
            fail(f"check_prefix on {what}: {state.result} != {one_shot}")
    for read_val, f_max in [(1, 32), (9, 32), (9, None)]:
        hist = concurrent_writes_history(16, read_val=read_val)
        t0 = time.perf_counter()
        out = TPULinearizableChecker(fallback=False, f_max=f_max).check(
            {}, hist)
        wall_s16 = time.perf_counter() - t0
        print(f"spill: 16 concurrent writes, read {read_val}, f_max "
              f"{f_max}: valid?={out['valid?']} spilled="
              f"{out.get('spilled')} rungs={out.get('rungs')} "
              f"peak-frontier={out.get('peak-frontier')} states="
              f"{out.get('states')} wall {wall_s16:.3f} s", flush=True)
        if out.get("spilled") is not True or \
                out["valid?"] is not (read_val == 1):
            fail(f"spill verdict {out}")

    # -- 7. the keyed register check ----------------------------------
    batch_entries = keyed_register_check(card)

    print(json.dumps({"kernels": [{
        "name": "wgl_wave", "route": "cuda",
        "source": "jepsen_etcd_tpu_torch/csrc/wgl_wave.cu",
        "replaces": "jepsen_etcd_tpu/ops/wgl_mxu.py:724",
        "launches": launches, "max_abs_err": max_err,
        "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None}, {
        "name": "indel_bits", "route": "cuda",
        "source": "jepsen_etcd_tpu_torch/csrc/indel_bits.cu",
        "replaces": "jepsen_etcd_tpu/ops/edit_distance.py:90",
        "launches": watch_launches, "max_abs_err": ed_err,
        "ms": b2_ms, "plain_ms": b2_plain_ms,
        "bound_ms": b2_work["bound_ms"],
        "bound_by": "bytes" if b2_work["bytes_ms"] >= b2_work["ops_ms"]
        else "operations",
        "library_ms": None}] + batch_entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
