"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Set-up builds the cell's traffic from the
seed, the system under test and its kernels, and checks the cell's
warm-up histories; the window then hands the system one history after
another for ``--seconds`` (a closed loop, one client) and times each
from the hand-off to its verdict. Once the window has closed the plain
reference judges every verdict. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones, read from the program's telemetry spans and from
``torch.profiler`` over the window's last ``profile_seconds``, all of
it where the cell file names none), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number compared beside its
limit, which also close standard error.

Without a CUDA card, or with fewer than the cell asks for, it exits 2;
if JAX or the JAX package was loaded, 3; either way with no result.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import spec  # noqa: E402
from benchmark.lib.context import Checked, Context  # noqa: E402

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "jepsen_etcd_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden, compared
    whole (``jepsen_etcd_tpu_torch`` is not ``jepsen_etcd_tpu``)."""
    return sorted({name.partition(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def _power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device=None, t_start: float = T_START) -> dict:
    """One run of ``cell``: set-up, the window, the reference's
    judgement and the metrics. ``device`` None runs on the card; the
    tests name ``"cpu"``."""
    import torch
    from jepsen_etcd_tpu_torch.runner import telemetry
    from benchmark.lib.trace import Profiler, innermost, top

    traffic = cell.traffic(seed)
    reference = cell.module("reference")
    entry = cell.module("entries").Entry(cell.config, device=device)
    on_card = device is None
    dev = torch.device("cuda", 0) if on_card else torch.device(device)

    span_file = None
    if trace:
        import tempfile
        fd, span_file = tempfile.mkstemp(prefix="bench-spans-",
                                         suffix=".jsonl")
        os.close(fd)
    tel = telemetry.Telemetry(path=span_file, max_records=10 ** 8)
    telemetry.set_current(tel)
    # the profiler covers the window's last ``profile_seconds`` (all of
    # it where the cell names none): a ladder's millions of kernels a
    # minute would cost more to trace and read than a run may take. It
    # stops once the window has closed, so reading its events costs the
    # window nothing.
    prof = Profiler(dev) if trace and on_card else None
    profile_from = seconds - cell.spec.get("profile_seconds", seconds)
    try:
        for j, keys in enumerate(traffic.warmup()):
            entry.check(entry.history(keys, -(j + 1)))
        if prof is not None:
            prof.warm()
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        gc.collect()
        gc.freeze()
        setup_s = time.monotonic() - t_start

        histories = []
        try:
            w0 = time.monotonic()
            i = 0
            while True:
                ta = time.monotonic()
                if prof is not None and not prof.on and \
                        ta - w0 >= profile_from:
                    prof.__enter__()
                    ta = time.monotonic()
                keys = traffic.history(i)
                h = entry.history(keys, i)
                t0 = time.monotonic()
                try:
                    out, error = entry.check(h), None
                except Exception as e:  # a failed operation, counted
                    out, error = None, f"{type(e).__name__}: {e}"
                t1 = time.monotonic()
                got = None if out is None else entry.summarize(out, keys, i)
                histories.append(Checked(keys, ta, t0, t1, got, error))
                i += 1
                if t1 - w0 >= seconds:
                    break
            window_s = t1 - w0
        finally:
            if prof is not None and prof.on:
                prof.__exit__(*sys.exc_info())
        memory_peak = torch.cuda.max_memory_allocated(dev) if on_card \
            else 0
    finally:
        telemetry.set_current(None)
        tel.close()
        gc.unfreeze()

    # the reference, once the window has closed
    t_closed = time.monotonic()
    wrong, failed = reference.judge(histories)

    t_judged = time.monotonic()
    spans = None
    if span_file is not None:
        spans = [(r["name"], r["t0"], r["t1"])
                 for r in telemetry.load_jsonl(span_file)[0]
                 if r.get("kind") == "span"]
        os.unlink(span_file)
        for h in histories:
            spans.append(("bench:assemble", h.ta, h.t0))
            spans.append(("bench:check", h.t0, h.t1))
    ctx = Context(setup_s, window_s, histories, spans=spans,
                  device=prof.trace if prof is not None else None)
    metrics = {}
    for m, reader in (cell.per_layer if trace else cell.end_to_end):
        value = reader.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    result = {
        "correct": all(wrong[n] <= lim
                       for n, lim in reference.LIMITS.items()),
        "attempted": len(histories),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else dev.type,
            "kind": torch.cuda.get_device_name(dev) if on_card
            else dev.type,
            "count": cell.chips if on_card else 1,
            "memory_peak_bytes": memory_peak,
        },
    }
    if on_card:
        result["device"]["power_limit_w"] = _power_limit_w()
    if ctx.device is not None:
        result["device"]["busy_s"] = ctx.device.busy_s()
        result["device"]["window_s"] = ctx.device.window_s
        result["breakdown"] = {
            "device_ops": top(ctx.device.seconds_by_name()),
            "idle_gaps": top(innermost(spans, ctx.device.gaps())),
        }
    result["compared"] = {n: {"value": wrong[n], "limit": lim}
                          for n, lim in reference.LIMITS.items()}
    errors = [h.error for h in histories if h.error is not None]
    if errors:
        print(f"{len(errors)} checks raised; the first: {errors[0]}",
              file=sys.stderr)
    print(f"after the window: reference {t_judged - t_closed:.1f} s, "
          f"metrics {time.monotonic() - t_judged:.1f} s" + (f" over {len(ctx.device.ops)} device operations"
                   if ctx.device is not None else ""), file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    leaked = forbidden_modules()
    if leaked:
        print(f"loaded in the run: {', '.join(leaked)}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
