"""Path-scoped lint policy: which invariant applies where.

The rules are generic AST analyses; this module pins them to THIS
repo's architecture — which modules are declared columnar (the static
twin of the ``History.dict_materializations == 0`` runtime guard),
which modules legitimately read the wall clock (the WallLoop/telemetry
allowlist), where the reachability roots of the deterministic core
are, which functions are the kernels' plain versions (exempt from the
TORCH loop rules), and which files are out of scope entirely
(generated protobufs, the linter itself).

Tests construct a permissive ``Policy(all_in_scope=True)`` so fixture
snippets exercise every rule without path gymnastics.
"""

from __future__ import annotations

import fnmatch
from typing import Iterable, Optional

#: files never scanned: generated code and the linter's own tree
EXCLUDE = (
    "client/proto/*",
    "lint/*",
)

#: modules declared columnar: dict-op APIs (History.ops, to_ops, op_at,
#: the filter/pairing helpers) are violations here, not style — these
#: are exactly the paths the dict_materializations==0 tier-1 guard
#: protects dynamically (ROADMAP direction 1)
COLUMNAR = (
    "ops/*",
    "checkers/set_full.py",
    "checkers/perf.py",
    "checkers/timeline.py",
    "checkers/tpu_linearizable.py",
    "checkers/session.py",
    "checkers/mvcc.py",
    "core/mvcc.py",     # the MVCC model builds from OpColumns in one
                        # pass; its dict-stream fallback is the single
                        # declared ignore in history_columns
    "simbatch/*",       # the batched generator BIRTHS histories as
                        # columns; materializing dicts inside it would
                        # defeat the subsystem (history_sha's to_jsonl
                        # is the declared test/bench-only exception)
)

#: modules allowed to read the wall clock: the wall-time bridge itself,
#: host-cost telemetry (spans measure host seconds by design), the
#: run-phase timers feeding those counters, real-process management
#: (readiness backoff against live etcd), and operator tooling that
#: never touches a verdict
DET_WALLCLOCK_ALLOW = (
    "runner/wall.py",
    "runner/telemetry.py",
    "runner/trace.py",
    "runner/test_runner.py",
    "runner/store.py",
    "runner/store_index.py",     # index rows carry artifact mtimes
                                 # (stat-based, never time.time) for
                                 # dashboard ordering only — verdicts
                                 # never read the index
    "runner/campaign.py",        # pool orchestration: wall-clock is
                                 # sweep accounting, never verdict
                                 # input (verdicts come from workers'
                                 # run_test)
    "runner/checker_service.py",  # socket I/O + coalescing-tick
                                  # timing; the device verdicts it
                                  # returns are pure functions of the
                                  # shipped packs (THR still applies
                                  # to its reader/dispatcher threads)
    "runner/transport.py",        # framed-socket plumbing (connect
                                  # timeouts, preambles): pure
                                  # transport, never verdict input
    "runner/host_agent.py",       # worker-agent supervision: spawn/
                                  # heartbeat/requeue timing (THR
                                  # still applies to its drive and
                                  # beat threads)
    "runner/guided.py",          # campaign-wave orchestration: wall
                                 # time is summary accounting only
                                 # (scores come from coverage vectors,
                                 # never the clock)
    "runner/shrink.py",          # artifact mtimes/summary wall only;
                                 # acceptance is signature equality on
                                 # replayed deterministic histories
    "runner/stream.py",          # streaming/fused-pipeline telemetry:
                                 # chunk-lag stamps and gen/check busy
                                 # walls are host accounting only —
                                 # verdicts come from the bit-identical
                                 # pack + ladder reuse paths, never the
                                 # clock
    "db/local.py",
    "db/fake_etcd.py",
    "net/*",            # userspace proxy plane: socket splice loops
                        # sleep real seconds to inject latency and
                        # bandwidth caps — transport I/O by design,
                        # never verdict input (the checker only ever
                        # sees the resulting history timestamps from
                        # WallLoop)
    "sut/*",            # gateway bridges: readiness deadlines against
                        # live sockets/processes, never verdict input
    "client/etcdctl.py",
    "serve.py",
    "cli.py",
    "forensics.py",
)

#: reachability roots for DET scoping: the deterministic kernel's run
#: loop, the generator interpreter, and every checker verdict entry.
#: Matched against callgraph qualnames (module:Class.func) by suffix.
ENTRY_SUFFIXES = (
    "SimLoop.run",
    ":interpret",
    ".check",
    ".check_batch",
)

#: the kernels' plain PyTorch versions beyond the ``*_reference`` naming
#: convention, as ``relpath:function`` patterns: the per-row and per-wave
#: loops a kernel replaces on the card. They run where a caller passes a
#: CPU tensor (the tests, ``--device cpu``) or names them to compare a
#: kernel against, never on the main path when a card is present, so
#: TORCH001/TORCH002 (a launch or a sync per iteration) do not apply.
PLAIN_VERSIONS = (
)

#: relpath of the module whose REGISTRY assignment is the canonical
#: telemetry name source (TEL002 reads it via ast.literal_eval — the
#: linter never imports the package)
TEL_REGISTRY_MODULE = "runner/telemetry.py"


def _match(rel: str, patterns: Iterable[str]) -> bool:
    return any(fnmatch.fnmatch(rel, p) for p in patterns)


class Policy:
    """Scope decisions for one lint run.

    ``all_in_scope=True`` (fixture tests) makes every file columnar,
    THR-scoped, and entry-reachable, with an empty wall-clock
    allowlist — every rule can fire on a bare snippet.
    """

    def __init__(self, all_in_scope: bool = False,
                 tel_registry: Optional[dict] = None):
        self.all_in_scope = all_in_scope
        #: {"span": [...], "counter": [...], "event": [...]} with
        #: ``*`` wildcards; None means "not loaded" (TEL002 skipped)
        self.tel_registry = tel_registry

    def excluded(self, rel: str) -> bool:
        if self.all_in_scope:
            return False
        return _match(rel, EXCLUDE)

    def columnar(self, rel: str) -> bool:
        return self.all_in_scope or _match(rel, COLUMNAR)

    def wallclock_allowed(self, rel: str) -> bool:
        if self.all_in_scope:
            return False
        return _match(rel, DET_WALLCLOCK_ALLOW)

    def entry_point(self, qualname: str) -> bool:
        """Is this def a reachability root? qualname: module:Class.func."""
        if self.all_in_scope:
            return True
        return any(qualname.endswith(s) for s in ENTRY_SUFFIXES)

    def plain_version(self, rel: str, func: str) -> bool:
        """Is ``func`` (a def name) in ``rel`` a kernel's plain version:
        named ``*_reference``, or listed in PLAIN_VERSIONS?"""
        return func.endswith("_reference") or \
            _match(f"{rel}:{func}", PLAIN_VERSIONS)

    def registry_module(self, rel: str) -> bool:
        return (not self.all_in_scope) and rel == TEL_REGISTRY_MODULE
