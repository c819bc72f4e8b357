"""Delta-debugging shrinker for failing batched-sim runs.

When a guided (or matrix) run fails, the interesting part is rarely
the whole four-cycle fault schedule — it is usually one window that
opens at the wrong moment. This module minimizes a failing run to the
smallest explicit nemesis schedule (and the shortest op stream) that
still reproduces the SAME verdict signature, and persists the result
as a ``shrink.json`` store artifact next to ``results.json``.

Mechanics:

- Schedules are delta-debugged with classic ddmin over window lists.
  Every candidate re-executes under same-seed sim determinism, and a
  whole ddmin round's candidate population runs through ONE
  ``simbatch.generate`` call: the failing seed repeats across lanes
  with a different per-seed ``nem_schedules`` entry each (the engine's
  nemesis arrays are per-seed already, so this is free batching).
- Acceptance is by verdict signature equality only — the workload
  checker re-runs over each candidate history and the candidate is
  kept iff ``_failure_signature`` matches the original failure. Op
  counts, timings and exact violation sites may differ; the *bug
  class* may not.
- The op stream shrinks after the schedule: halving ``ops_per_lane``
  redraws every client plane (draw shapes are part of the epoch), so
  those candidates cannot share a generate() call and run singly.

The artifact embeds the minimized :class:`BatchConfig` verbatim
(``config`` key) plus a ``repro`` command line, so
``python -m jepsen_etcd_tpu_torch replay <dir>/shrink.json``
re-executes and re-checks it without depending on the opts→config
mapping.

The port checks on the device its caller names (``device``: the card
unless ``"cpu"``). The device is an argument of :func:`shrink_run` and
:func:`replay_artifact`, never part of ``checker_opts``, so
``shrink.json`` holds the reference's bytes. Candidates generate on
the host (epoch-v2, ``simbatch.generate``), as the reference's do.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from ..simbatch import BatchConfig, default_schedule, generate
from . import telemetry

#: nemesis ops emitted per schedule window (start/stop invoke + :info)
OPS_PER_WINDOW = 4

#: give up on a shrink after this many candidate executions
MAX_EXECUTIONS = 256


def _checker_for(config: BatchConfig, checker_opts: dict, device=None):
    from ..workloads import workloads
    return workloads()[config.workload](
        dict(checker_opts, device=device))["checker"]


def _signature(results: dict) -> str:
    from .store import failure_signature
    return failure_signature(results)


def checker_opts_from(opts: dict) -> dict:
    """The slice of run opts the workload checker factory needs."""
    nodes = opts.get("nodes") or ["n1", "n2", "n3"]
    out = {"nodes": list(nodes),
           "concurrency": int(opts.get("concurrency") or 2 * len(nodes))}
    # MVCC surface thresholds (checkers/mvcc.py reads them from the
    # test map at check time): shrink/replay verdicts must honor the
    # same bounds the original run was judged under
    for k in ("staleness_bound_s", "lease_ttl_ms", "compact_keep"):
        if opts.get(k) is not None:
            out[k] = opts[k]
    return out


def _eval_population(config, seed, scheds, checker, checker_opts):
    """Verdict signatures for a candidate-schedule population, one
    batched generate() call (same seed on every lane)."""
    tel = telemetry.current()
    g = generate(config, [seed] * len(scheds), nem_schedules=scheds)
    sigs = []
    for h in g["histories"]:
        res = checker.check(dict(checker_opts), h)
        sigs.append(_signature({"workload": res}))
    tel.counter("shrink.candidates", len(scheds))
    return sigs


def _ddmin_windows(config, seed, sched, sig0, checker, checker_opts,
                   budget):
    """Classic ddmin over the window list; each round's candidates are
    evaluated as one batched population. Returns (min_sched, rounds,
    executions)."""
    cur = list(sched)
    rounds = execs = 0
    n = 2
    while len(cur) >= 2 and execs < budget:
        rounds += 1
        size = len(cur) // n
        chunks = [cur[i:i + size] for i in range(0, len(cur), size)]
        # subsets first, then complements (ddmin order)
        cands = [c for c in chunks if 0 < len(c) < len(cur)]
        cands += [cur[:i * size] + cur[(i + 1) * size:]
                  for i in range(len(chunks))
                  if 0 < len(cur) - len(chunks[i]) < len(cur)]
        if not cands:
            break
        sigs = _eval_population(config, seed, cands, checker,
                                checker_opts)
        execs += len(cands)
        hit = next((i for i, sg in enumerate(sigs) if sg == sig0), None)
        if hit is not None:
            cur = list(cands[hit])
            n = 2
        elif n < len(cur):
            n = min(len(cur), 2 * n)
        else:
            break
    return cur, rounds, execs


def _shrink_ops(config, seed, sched, sig0, checker, checker_opts,
                budget):
    """Halve ops_per_lane while the signature survives; each candidate
    redraws the client planes so these run one-by-one."""
    tel = telemetry.current()
    cfg, execs = config, 0
    while cfg.ops_per_lane > 2 and execs < budget:
        cand = dict(cfg.to_dict(), ops_per_lane=cfg.ops_per_lane // 2,
                    nem_schedule=[list(w) for w in sched])
        c2 = BatchConfig(**cand)
        sg = _eval_population(c2, seed, [sched], checker,
                              checker_opts)[0]
        execs += 1
        if sg != sig0:
            break
        cfg = c2
    return cfg, execs


def shrink_run(opts: dict, seed: int, *, store_dir: Optional[str] = None,
               max_executions: int = MAX_EXECUTIONS,
               device=None) -> Optional[dict]:
    """Minimize a failing batched run; return the artifact dict (and
    write ``<store_dir>/shrink.json`` when a store dir is given). The
    candidates' checks run on ``device`` (the card unless named).

    Returns None when there is nothing to shrink (no faults configured)
    or the failure does not reproduce as a workload-checker signature
    under re-execution (e.g. an infrastructure error)."""
    tel = telemetry.current()
    config = BatchConfig.from_opts(opts)
    seed = int(seed)
    if not config.nemeses:
        return None
    sched = [tuple(w) for w in (config.nem_schedule
                                or default_schedule(config, seed))]
    checker_opts = checker_opts_from(opts)
    checker = _checker_for(config, checker_opts, device)
    tel.counter("shrink.runs")
    sig0 = _eval_population(config, seed, [sched], checker,
                            checker_opts)[0]
    if not sig0:
        tel.counter("shrink.irreproducible")
        return None
    min_sched, rounds, execs = _ddmin_windows(
        config, seed, sched, sig0, checker, checker_opts,
        max_executions)
    tel.counter("shrink.rounds", rounds)
    min_cfg = BatchConfig(**dict(
        config.to_dict(), nem_schedule=[list(w) for w in min_sched]))
    min_cfg, oexecs = _shrink_ops(min_cfg, seed, min_sched, sig0,
                                  checker, checker_opts,
                                  max(0, max_executions - execs - 1))
    if len(min_sched) < len(sched):
        tel.counter("shrink.accepted")
    art = {
        "schema": 1,
        "workload": config.workload,
        "seed": seed,
        "signature": sig0,
        "checker_opts": checker_opts,
        "config": min_cfg.to_dict(),
        "original_windows": len(sched),
        "windows": len(min_sched),
        "nemesis_ops": OPS_PER_WINDOW * len(min_sched),
        "ops_per_lane": {"original": config.ops_per_lane,
                         "min": min_cfg.ops_per_lane},
        "rounds": rounds,
        "executions": 1 + execs + oexecs,
    }
    if store_dir:
        path = os.path.join(store_dir, "shrink.json")
        art["repro"] = f"python -m jepsen_etcd_tpu_torch replay {path}"
        with open(path, "w") as f:
            json.dump(art, f, indent=1, sort_keys=True)
        tel.counter("shrink.artifacts")
        try:  # surface the artifact on the dashboard immediately
            from .store_index import record_shrink
            record_shrink(store_dir)
        except Exception:
            pass
    else:
        art["repro"] = ("python -m jepsen_etcd_tpu_torch replay "
                        "<shrink.json>")
    return art


def replay_artifact(path: str, device=None) -> dict:
    """Re-execute a ``shrink.json`` artifact and re-check it on
    ``device`` (the card unless named); returns ``{"signature",
    "match", "valid?", "windows", "nemesis_ops"}``. ``match`` is True
    iff the minimized schedule still reproduces the recorded verdict
    signature."""
    with open(path) as f:
        art = json.load(f)
    config = BatchConfig(**art["config"])
    checker = _checker_for(config, art["checker_opts"], device)
    g = generate(config, [int(art["seed"])])
    res = checker.check(dict(art["checker_opts"]), g["histories"][0])
    sig = _signature({"workload": res})
    return {
        "signature": sig,
        "expected": art["signature"],
        "match": sig == art["signature"],
        "valid?": bool(res.get("valid?")),
        "windows": art.get("windows"),
        "nemesis_ops": art.get("nemesis_ops"),
        "seed": art.get("seed"),
        "workload": art.get("workload"),
    }
