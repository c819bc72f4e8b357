"""Coverage-guided fault campaigns: an evolutionary scheduler over the
test-all matrix.

The uniform campaign samples workload × nemesis × seed cells blindly;
this module spends the same run budget adaptively. Generation 0
stratifies one run per matrix cell (``campaign_specs`` with
``runs_per_cell=1`` — every cell is novel by definition), then each
later generation mutates/crosses over a corpus of *interesting*
ancestors:

- **Scoring** reuses ``tel_cli.coverage``'s per-run feature vector
  verbatim (verdict signature + peak frontier width, rung escalations,
  host spills). A run earns corpus membership by showing a NEW verdict
  signature, pushing a feature dimension outside the seen envelope, or
  visiting an unseen cell. Infrastructure errors (no checker verdict)
  score zero — guided search never chases harness noise.
- **Mutations** act on the explicit nemesis schedule (materialized via
  ``simbatch.default_schedule`` when a run carried only drawn cycles):
  add/remove/retime windows, swap the partition shape, perturb the
  drop-probability/latency knobs, reseed, or cross over two ancestors
  (workload+seed from one, fault plan from the other). All draws come
  from ONE campaign-seeded ``np.random.default_rng`` so a master seed
  fully determines the search.
- **Execution** is the existing fleet, unchanged: each generation is
  one ``run_campaign`` wave (pool / host agents / checker service all
  apply), nested under the guided store dir as ``gen0, gen1, ...``.

Every failing run whose signature is newly seen is handed to
``runner/shrink.py``; the minimized schedule lands as ``shrink.json``
in that run's store dir. The search's own summary — corpus, novel
signatures, per-run ledger, minimized repros — is ``guided.json``,
surfaced by ``/aggregate`` and ``tel --corpus``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np

from ..simbatch import BatchConfig, default_schedule, schedule_span
from .campaign import _batchable, campaign_specs, run_campaign
from .shrink import shrink_run
from .store import _scrub, link_latest, make_store_dir
from .telemetry import Telemetry

#: partition start values guided can swap in (nemesis/faults.py shapes)
PARTITION_SHAPES = ("majority", "primaries", "majorities-ring",
                    "bridge", "one-way")
#: drop-probability / latency-delta pools for knob perturbation
DROP_PROBS = (0.01, 0.05, 0.1)
LATENCIES_MS = (8.0, 16.0, 32.0, 64.0, 128.0)

#: corpus size cap: lowest-scoring ancestors fall off first
CORPUS_CAP = 32

#: imported-ancestor aging: ``--corpus-in`` ancestors enter with
#: ``run: 0`` so cap eviction prefers dropping them on ties, but a
#: high-scoring ancestor could otherwise dominate mutation draws
#: forever. Their EFFECTIVE score halves every this-many generations
#: survived (native corpus entries never decay — they earned their
#: score in this search), and ancestors decayed below 1 leave the
#: mutation draw pool entirely.
IMPORT_HALF_LIFE_GENS = 4

#: feature-vector dimensions folded into the novelty envelope (the
#: tel_cli.coverage vector keys, reused verbatim). "waves" is BFS
#: wave depth (wgl.waves, mode=max): histories that force deeper
#: ladders are novel even at the same frontier width
ENVELOPE_DIMS = ("frontier", "waves", "rungs", "spills")

#: workload-parameter pools the "param" mutation hops along — each hop
#: moves one step within a pool, so mutants explore key churn
#: (ops_per_key rotates keys in), request rate, and client concurrency
#: without teleporting across the space
PARAM_POOLS = {
    "ops_per_key": (64, 128, 200, 400),
    "rate": (50.0, 100.0, 200.0, 400.0, 800.0),
    "concurrency": (4, 8, 10, 16, 32),
}


def _copy_opts(opts: dict) -> dict:
    return json.loads(json.dumps(_scrub(opts)))


class GuidedScheduler:
    """Deterministic candidate source: stratified seeding, then
    corpus-driven mutation/crossover. Pure bookkeeping — it never runs
    anything, so unit tests can pin its output spec-for-spec."""

    def __init__(self, base_opts: dict, workloads: list, nemeses: list,
                 *, seed0: int = 0, master_seed: Optional[int] = None,
                 corpus_cap: int = CORPUS_CAP):
        self.base = _copy_opts(base_opts)
        self.workloads = list(workloads)
        self.nemeses = [list(n) for n in nemeses]
        self.master_seed = int(seed0 if master_seed is None
                               else master_seed)
        self.rng = np.random.default_rng(self.master_seed)
        self._pending = [s["opts"] for s in campaign_specs(
            self.base, self.workloads, self.nemeses, 1, seed0)]
        self.next_seed = seed0 + len(self._pending)
        self.corpus: list[dict] = []
        self.corpus_cap = corpus_cap
        self.seen_signatures: dict[str, int] = {}
        self.seen_cells: set = set()
        self.envelope = {dim: 0 for dim in ENVELOPE_DIMS}
        #: wgl.rung_waves histogram buckets already observed — each
        #: newly-occupied bucket is a fresh search-depth shape (+1)
        self.seen_wave_buckets: set = set()
        #: generation counter: stamps corpus entries (``born``) so
        #: imported-ancestor decay ages in generations survived
        self.wave = 0
        self.runs_observed = 0
        self.mutations = 0
        self.crossovers = 0
        #: imported ancestors evicted after a full generation below
        #: effective score 1
        self.corpus_retired = 0

    # -- candidate generation ----------------------------------------

    def next_generation(self, size: int) -> list:
        """Up to ``size`` opts dicts: pending stratified cells first,
        then mutants/crossovers of corpus ancestors."""
        self.wave += 1
        self._retire_stale()
        out = []
        while self._pending and len(out) < size:
            out.append(self._pending.pop(0))
        while len(out) < size:
            out.append(self._mutate())
        return out

    def _mint_seed(self) -> int:
        s = self.next_seed
        self.next_seed += 1
        return s

    def _random_cell(self) -> dict:
        rng = self.rng
        wl = self.workloads[int(rng.integers(len(self.workloads)))]
        nem = self.nemeses[int(rng.integers(len(self.nemeses)))]
        opts = dict(self.base)
        opts.update({"workload": wl, "nemesis": list(nem),
                     "seed": self._mint_seed()})
        return opts

    def _eff_score(self, c: dict) -> float:
        """Eviction/draw weight: native entries keep their earned
        score; imported ancestors decay by half every
        ``IMPORT_HALF_LIFE_GENS`` generations survived since import."""
        score = float(c.get("score") or 0)
        if not c.get("imported"):
            return score
        age = max(0, self.wave - int(c.get("born") or 0))
        return score * 0.5 ** (age // IMPORT_HALF_LIFE_GENS)

    def _evict(self) -> None:
        if len(self.corpus) > self.corpus_cap:
            self.corpus.sort(
                key=lambda c: (-self._eff_score(c), c["run"]))
            del self.corpus[self.corpus_cap:]

    def _retire_stale(self) -> None:
        """Retire imported ancestors whose effective score has sat
        below 1 for a FULL generation. ``_pick`` already excludes them
        from mutation draws, but under the cap they lingered in the
        corpus (and its artifact) forever; one grace generation lets
        an entry whose decay step lands mid-generation still be drawn
        before it goes."""
        kept = []
        for c in self.corpus:
            if not c.get("imported") or self._eff_score(c) >= 1.0:
                c.pop("stale_since", None)
                kept.append(c)
                continue
            since = c.get("stale_since")
            if since is None:
                c["stale_since"] = self.wave
                kept.append(c)
            elif self.wave - int(since) < 1:
                kept.append(c)
            else:
                self.corpus_retired += 1
        self.corpus[:] = kept

    def _pick(self) -> dict:
        # stale imported ancestors (effective score decayed below 1)
        # never retire natives from the cap, but they DO stop feeding
        # mutation draws; an all-stale corpus still draws uniformly
        pool = [c for c in self.corpus
                if not c.get("imported") or self._eff_score(c) >= 1.0]
        pool = pool or self.corpus
        return pool[int(self.rng.integers(len(pool)))]

    def _mutate(self) -> dict:
        rng = self.rng
        self.mutations += 1
        if not self.corpus:
            return self._random_cell()
        if len(self.corpus) >= 2 and rng.random() < 0.25:
            return self._crossover()
        anc = self._pick()
        opts = _copy_opts(anc["opts"])
        nem = list(opts.get("nemesis") or ())
        ops = ["reseed", "cell", "param"]
        if nem and _batchable(opts):
            ops += ["window"] * 3
            if "partition" in nem:
                ops.append("shape")
            ops.append("knob")
        op = ops[int(rng.integers(len(ops)))]
        if op == "reseed":
            opts["seed"] = self._mint_seed()
        elif op == "cell":
            nem2 = self.nemeses[int(rng.integers(len(self.nemeses)))]
            opts["nemesis"] = list(nem2)
            opts.pop("nem_schedule", None)  # kinds may no longer match
            opts["seed"] = self._mint_seed()
        elif op == "window":
            self._mutate_schedule(opts)
        elif op == "shape":
            opts["nem_partition_shape"] = str(
                PARTITION_SHAPES[int(rng.integers(
                    len(PARTITION_SHAPES)))])
        elif op == "knob":
            if rng.random() < 0.5:
                opts["nem_drop_prob"] = float(
                    DROP_PROBS[int(rng.integers(len(DROP_PROBS)))])
            else:
                opts["nem_latency_ms"] = float(
                    LATENCIES_MS[int(rng.integers(len(LATENCIES_MS)))])
        elif op == "param":
            self._hop_param(opts)
        return opts

    def _hop_param(self, opts: dict) -> None:
        """One step along a workload-parameter pool (PARAM_POOLS):
        snap the current value to its nearest pool entry, then hop one
        slot up or down. Drawn schedules key off (config, seed), so a
        rate/concurrency hop also reshapes the fault plan timing —
        that interplay is exactly what the dimension is for."""
        rng = self.rng
        names = sorted(PARAM_POOLS)
        name = names[int(rng.integers(len(names)))]
        pool = PARAM_POOLS[name]
        cur = opts.get(name)
        if cur is None:
            cur = self.base.get(name)
        try:
            i = min(range(len(pool)),
                    key=lambda j: abs(float(pool[j]) - float(cur)))
        except (TypeError, ValueError):
            i = int(rng.integers(len(pool)))
        step = 1 if rng.random() < 0.5 else -1
        i = min(len(pool) - 1, max(0, i + step))
        opts[name] = pool[i]

    def _materialize(self, opts: dict) -> list:
        """The explicit window list a mutant starts from: the opts' own
        schedule, else the drawn cycles of (config, seed)."""
        sched = opts.get("nem_schedule")
        if sched is None:
            cfg = BatchConfig.from_opts(opts)
            sched = default_schedule(cfg, int(opts.get("seed", 0)))
        return [list(w) for w in sched]

    def _mutate_schedule(self, opts: dict) -> None:
        rng = self.rng
        sched = self._materialize(opts)
        span = schedule_span(BatchConfig.from_opts(opts))
        kinds = list(opts.get("nemesis") or ())
        which = rng.random()
        if which < 0.4 or not sched:  # add a window
            start = int(rng.integers(1, max(2, span)))
            hold = int(rng.integers(max(1, span // 12),
                                    max(2, span // 4)))
            kind = kinds[int(rng.integers(len(kinds)))]
            sched.append([start, kind, hold])
        elif which < 0.7:  # drop a window
            sched.pop(int(rng.integers(len(sched))))
        else:  # retime a window
            w = sched[int(rng.integers(len(sched)))]
            if rng.random() < 0.5:
                w[0] = max(1, int(w[0] * rng.uniform(0.5, 1.5)))
            else:
                w[2] = max(1, int(w[2] * rng.uniform(0.5, 1.5)))
        sched.sort(key=lambda w: (w[0], w[2]))
        opts["nem_schedule"] = sched

    def _crossover(self) -> dict:
        """Workload+seed from one ancestor, fault plan (nemesis list,
        schedule, knobs) from another."""
        self.crossovers += 1
        a, b = self._pick(), self._pick()
        opts = _copy_opts(a["opts"])
        donor = _copy_opts(b["opts"])
        opts["nemesis"] = list(donor.get("nemesis") or ())
        for k in ("nem_schedule", "nem_partition_shape",
                  "nem_latency_ms", "nem_drop_prob"):
            if donor.get(k) is not None:
                opts[k] = donor[k]
            else:
                opts.pop(k, None)
        return opts

    # -- corpus transfer ----------------------------------------------

    def export_corpus(self) -> dict:
        """JSON-able snapshot of the search state worth carrying into
        the NEXT campaign: the ancestor corpus, the novelty envelope,
        and the seen signature/cell ledgers (so a warmed-up search
        only scores genuinely new behavior), plus the seed cursor (so
        freshly minted seeds never collide with imported ancestors)."""
        return {
            "schema": 1, "kind": "guided-corpus",
            "master_seed": self.master_seed,
            "next_seed": self.next_seed,
            "envelope": dict(self.envelope),
            "signatures": dict(self.seen_signatures),
            "cells": sorted([w, list(n)] for w, n in self.seen_cells),
            "wave_buckets": sorted(self.seen_wave_buckets),
            "corpus": [dict(c) for c in self.corpus],
        }

    def import_corpus(self, data: dict) -> int:
        """Merge an :meth:`export_corpus` payload: ancestors join the
        pool (the cap still applies), the envelope widens to the
        imported peaks, and imported signatures/cells stop scoring as
        novel. Returns the number of ancestors added. Unknown envelope
        dims in the payload are dropped; missing ones default to 0, so
        corpora survive dimension growth across versions."""
        if not isinstance(data, dict) \
                or data.get("kind") != "guided-corpus":
            raise ValueError(
                "not a guided-corpus export (produce one with "
                "campaign --guided --corpus-out PATH)")
        self.next_seed = max(self.next_seed,
                             int(data.get("next_seed") or 0))
        env = data.get("envelope") or {}
        for dim in ENVELOPE_DIMS:
            v = int(env.get(dim) or 0)
            if v > self.envelope[dim]:
                self.envelope[dim] = v
        for sig, run in (data.get("signatures") or {}).items():
            self.seen_signatures.setdefault(str(sig), int(run))
        for cell in data.get("cells") or ():
            if isinstance(cell, (list, tuple)) and len(cell) == 2:
                self.seen_cells.add((cell[0], tuple(cell[1] or ())))
        for b in data.get("wave_buckets") or ():
            self.seen_wave_buckets.add(int(b))
        added = 0
        for c in data.get("corpus") or ():
            if not (isinstance(c, dict) and isinstance(c.get("opts"),
                                                       dict)):
                continue
            self.corpus.append({
                "opts": _copy_opts(c["opts"]),
                "seed": c.get("seed"),
                "run": 0,               # pre-history: ties sort first
                "score": int(c.get("score") or 1),
                "signature": c.get("signature") or "",
                "vector": {dim: int((c.get("vector") or {})
                                    .get(dim) or 0)
                           for dim in ENVELOPE_DIMS},
                "imported": True,
                # decay clock starts at the CURRENT wave: an ancestor
                # ages by generations survived here, not by how old
                # the exporting campaign was
                "born": self.wave,
            })
            added += 1
        self._evict()
        return added

    # -- scoring ------------------------------------------------------

    def observe(self, opts: dict, row: dict,
                vector: Optional[dict]) -> int:
        """Score one finished run by coverage novelty; admit scoring
        runs to the corpus. Returns the score (0 = not interesting).

        Rows without a real checker verdict (agent errors, requeues,
        crashed epilogues) always score 0: harness noise must not
        steer the search."""
        self.runs_observed += 1
        cell = (row.get("workload"), tuple(row.get("nemesis") or ()))
        if row.get("status") != "done" or not vector:
            return 0
        score = 0
        sig = vector.get("signature") or ""
        if sig and sig not in self.seen_signatures:
            self.seen_signatures[sig] = self.runs_observed
            score += 4
        for dim in ENVELOPE_DIMS:
            v = int(vector.get(dim) or 0)
            if v > self.envelope[dim]:
                self.envelope[dim] = v
                score += 1
        # search-depth SHAPE, not just envelope peaks: each
        # wgl.rung_waves histogram bucket (one per ladder rung) first
        # occupied by this run is novel — a history that makes many
        # dispatches settle at a new rung scores even when the deepest
        # rung (the "rungs" envelope dim) has been seen before
        for b in vector.get("wave_hist") or {}:
            if int(b) not in self.seen_wave_buckets:
                self.seen_wave_buckets.add(int(b))
                score += 1
        if cell not in self.seen_cells:
            self.seen_cells.add(cell)
            score += 1
        if score:
            self.corpus.append({
                "opts": _copy_opts(opts), "seed": row.get("seed"),
                "run": self.runs_observed, "score": score,
                "signature": sig,
                "vector": {dim: int(vector.get(dim) or 0)
                           for dim in ENVELOPE_DIMS},
                "born": self.wave,
            })
            self._evict()
        return score


def run_guided(base_opts: dict, workloads: list, nemeses: list, *,
               budget: int, seed0: int = 0,
               master_seed: Optional[int] = None,
               pool: int = 0, service: bool = False,
               service_tick_s: float = 0.05,
               store_base: str = "store", name: str = "guided",
               start_method: str = "spawn", live: bool = False,
               hosts=None, shrink: bool = True, max_shrinks: int = 4,
               gen_size: Optional[int] = None, on_row=None,
               corpus_in: Optional[str] = None,
               corpus_out: Optional[str] = None) -> dict:
    """Drive a guided campaign of ``budget`` runs; returns (and writes
    as ``<guided dir>/guided.json``) the search summary.

    Each generation executes as one :func:`run_campaign` wave nested
    under the guided store dir, so the pool / checker-service /
    host-agent fleet applies unchanged. Batched re-execution wants the
    lockstep generator, so ``gen_epoch`` defaults to epoch-v2 here.
    Runs and shrinks check on ``base_opts["device"]`` (the card unless
    ``"cpu"`` is named)."""
    from ..device import resolve_device
    from ..tel_cli import coverage

    # the card unless the opts name another device: raises before the
    # search's store dir or any run exists
    resolve_device(base_opts.get("device"))
    t0 = time.monotonic()
    base = _copy_opts(base_opts)
    base.setdefault("gen_epoch", "epoch-v2")
    gdir = make_store_dir(store_base, name)
    trace = f"{name}-{os.path.basename(gdir)}"
    tel = Telemetry(os.path.join(gdir, "telemetry.jsonl"), trace=trace)
    sched = GuidedScheduler(base, workloads, nemeses, seed0=seed0,
                            master_seed=master_seed)
    imported = 0
    if corpus_in:
        with open(corpus_in) as f:
            imported = sched.import_corpus(json.load(f))
        tel.counter("guided.corpus-imported", imported)
    ledger: list[dict] = []
    minimized: list[dict] = []
    first_failure: Optional[int] = None
    gen = 0
    runs_left = int(budget)
    try:
        while runs_left > 0:
            want = min(runs_left,
                       len(sched._pending) or gen_size
                       or max(2, len(sched._pending) or 4))
            specs = [{"index": i, "opts": o} for i, o in
                     enumerate(sched.next_generation(want))]
            if not specs:
                break
            tel.counter("guided.generations")
            tel.event("guided.generation", gen=gen, size=len(specs))
            summary = run_campaign(
                specs, pool=pool, service=service,
                service_tick_s=service_tick_s, store_base=gdir,
                name=f"gen{gen}", start_method=start_method,
                live=live, hosts=hosts, on_row=on_row)
            for row in sorted((r for r in summary["runs"] if r),
                              key=lambda r: r["index"]):
                opts = specs[row["index"]]["opts"]
                rdir = row.get("dir")
                vector = None
                if rdir:
                    try:
                        cov = coverage(rdir)
                        vector = (cov["runs"] or [None])[0]
                    except Exception:
                        vector = None
                score = sched.observe(opts, row, vector)
                tel.counter("guided.runs")
                if row.get("status") != "done":
                    tel.counter("guided.errors")
                if score:
                    tel.counter("guided.novelty", score)
                sig = (vector or {}).get("signature") or ""
                failing = (row.get("status") == "done"
                           and row.get("valid") is False)
                if failing:
                    tel.counter("guided.failures")
                    if first_failure is None:
                        first_failure = sched.runs_observed
                ledger.append({
                    "run": sched.runs_observed, "gen": gen,
                    "index": row["index"],
                    "workload": row.get("workload"),
                    "nemesis": row.get("nemesis"),
                    "seed": row.get("seed"),
                    "status": row.get("status"),
                    "valid": row.get("valid"),
                    "signature": sig, "score": score,
                    "dir": rdir,
                })
                # shrink the first run of each novel failure signature
                if (shrink and failing and sig and rdir
                        and len(minimized) < max_shrinks
                        and sched.seen_signatures.get(sig)
                        == sched.runs_observed
                        and _batchable(opts)):
                    try:
                        art = shrink_run(opts, int(row.get("seed") or 0),
                                         store_dir=rdir,
                                         device=opts.get("device"))
                    except Exception:
                        art = None
                    if art:
                        minimized.append({
                            "dir": rdir, "run": sched.runs_observed,
                            "signature": art["signature"],
                            "original_windows": art["original_windows"],
                            "windows": art["windows"],
                            "nemesis_ops": art["nemesis_ops"],
                            "executions": art["executions"],
                            "repro": art["repro"],
                        })
            runs_left -= len(specs)
            gen += 1
        tel.counter("guided.corpus", len(sched.corpus), mode="max")
        tel.counter("guided.mutations", sched.mutations)
        tel.counter("guided.crossovers", sched.crossovers)
        tel.counter("guided.signatures", len(sched.seen_signatures))
        tel.counter("guided.corpus_retired", sched.corpus_retired)
    finally:
        out = {
            "schema": 1, "kind": "guided", "name": name, "dir": gdir,
            "budget": int(budget), "runs": sched.runs_observed,
            "generations": gen, "seed0": seed0,
            "master_seed": sched.master_seed,
            "workloads": list(workloads),
            "nemeses": [list(n) for n in nemeses],
            "signatures": dict(sched.seen_signatures),
            "envelope": dict(sched.envelope),
            "first_failure_run": first_failure,
            "corpus": sched.corpus,
            "corpus_imported": imported,
            "corpus_retired": sched.corpus_retired,
            "corpus_in": corpus_in, "corpus_out": corpus_out,
            "minimized": minimized,
            "ledger": ledger,
            "wall_s": round(time.monotonic() - t0, 3),
            "telemetry": tel.summary(),
        }
        with open(os.path.join(gdir, "guided.json"), "w") as f:
            json.dump(_scrub(out), f, indent=2, default=repr)
        try:
            # fold the finished search into its parent store's index
            from .store_index import record_guided
            record_guided(gdir)
        except Exception:
            pass
        if corpus_out:
            with open(corpus_out, "w") as f:
                json.dump(_scrub(sched.export_corpus()), f, indent=2,
                          default=repr)
        tel.close()
        link_latest(gdir)
    return out
