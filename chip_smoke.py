"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout,
holds each against its plain PyTorch version on the card, drives the
port's main path (single-key linearizability checking of a 27,000-entry
register history through ``TPULinearizableChecker``) and shows that the
path launched the kernels. Prints the card's name and power limit, a
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
Exits non-zero, with no result line, when CUDA is unavailable or any
phase fails. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import random
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

MAIN_SEED, MAIN_PROCS, MAIN_OPS = 2026, 6, 13_500


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
    import statistics
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


def tables_for(packs, dev):
    """(tab, scal, wk) for packs sharing one (r_pad, wk) group."""
    import numpy as np
    import torch
    from jepsen_etcd_tpu_torch.ops import wgl, wgl_mxu
    wk = packs[0].w
    r_pad = max(max(wgl.bucket(p.R), wgl_mxu.TSUB) for p in packs)
    per = [wgl_mxu.pack_perop(p, r_pad) for p in packs]
    i32 = torch.from_numpy(np.stack([a for a, _ in per])).to(dev)
    u16 = torch.from_numpy(
        np.stack([b for _, b in per]).astype(np.int32)).to(dev)
    tab, scal = wgl_mxu.build_tables(i32, u16, r_pad, wk)
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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    from jepsen_etcd_tpu_torch.checkers.linearizable import check_history
    from jepsen_etcd_tpu_torch.checkers.tpu_linearizable import \
        TPULinearizableChecker
    from jepsen_etcd_tpu_torch.models import VersionedRegister
    from jepsen_etcd_tpu_torch.ops import _cuda, wgl, wgl_mxu
    from jepsen_etcd_tpu_torch.testing import gen_history

    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)

    # -- 1. build -----------------------------------------------------
    t0 = time.perf_counter()
    _cuda.build("wgl_wave")
    print(f"build: wgl_wave.cu in {time.perf_counter() - t0:.2f} s",
          flush=True)

    # -- 2. kernel vs plain on the card -------------------------------
    print("kernel vs plain (exact, tolerance 0):", flush=True)
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

    # -- 3. the main path at full size --------------------------------
    h = gen_history(random.Random(MAIN_SEED), n_procs=MAIN_PROCS,
                    n_ops=MAIN_OPS)
    bad = gen_history(random.Random(MAIN_SEED), n_procs=MAIN_PROCS,
                      n_ops=MAIN_OPS, corrupt=True)
    checker = TPULinearizableChecker()
    torch.cuda.synchronize()
    wgl_mxu.LAUNCHES = 0
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
    print(f"batch of {len(batch)} keys (r_pad {btab.shape[1]}): one "
          f"launch {batch_ms:.3f} ms", flush=True)
    kern_ms = cuda_ms(lambda: wgl_mxu.wave_search(tab, scal, wk), 21)
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
    row_bytes = (tab.shape[2] + scal.shape[2]) * 4
    bytes_ms = (waves * row_bytes + 16) / HBM_BYTES_PER_S * 1e3
    ops_ms = (waves * wgl_mxu.F * wk * WGL_OPS_PER_CANDIDATE
              / ALU32_OPS_PER_S * 1e3)
    bound_ms = max(bytes_ms, ops_ms)
    print(f"main path timing on {card}: check wall {wall_s:.3f} s "
          f"(pack {t_pack:.3f} s), kernel {kern_ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms, waves {waves} "
          f"({kern_ms * 1e3 / waves:.2f} us/wave), peak-frontier "
          f"{int(got[0, 2])}, bound {bound_ms:.4f} ms (bytes "
          f"{bytes_ms:.4f} ms, operations {ops_ms:.4f} ms); corrupted "
          f"check wall {wall_bad_s:.3f} s", flush=True)

    print(json.dumps({"kernels": [{
        "name": "wgl_wave", "route": "cuda",
        "source": "jepsen_etcd_tpu_torch/csrc/wgl_wave.cu",
        "replaces": "jepsen_etcd_tpu/ops/wgl_mxu.py:724",
        "launches": launches, "max_abs_err": max_err,
        "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
