"""Structured run telemetry: spans, counters, and events.

Every phase of a run — setup, generation, history packing, each
checker, each device dispatch — emits into the process-current
``Telemetry`` recorder, which streams one JSON record per line to
``store/<run>/telemetry.jsonl`` and aggregates in memory so the run's
``results.json`` can carry a summary (phase totals, per-checker span
totals, TPU-path counters). The reference treats run artifacts as
first-class evidence (timeline/html at register.clj:112, perf plots,
per-node pcaps); telemetry is the same idea applied to the checker
economics this port exists to measure: a single run's artifacts explain
its own checker cost the way PERF.md's bench cells do.

Record schema (one JSON object per line; ``SPAN_FIELDS`` /
``COUNTER_FIELDS`` / ``EVENT_FIELDS`` pin the field sets — bench.py
emits the same schema per cell so BENCH rounds and live runs are
comparable with one reader):

    {"kind": "span",    "name": ..., "t0": ..., "t1": ...,
     "dur_s": ..., "attrs": {...}}
    {"kind": "counter", "name": ..., "value": ...}
    {"kind": "event",   "name": ..., "t": ..., "attrs": {...}}

Span-name conventions: ``phase:<name>`` for run phases (setup,
generate, stream-finalize, teardown, check, save), ``checker:<name>``
for one composed checker's pass, everything else dotted by subsystem
(``wgl.check_packed``, ``mxu.launch``, ``closure.device``; streamed
runs add per-chunk ``stream.chunk`` dispatch spans, ``stream.finalize``
consumer spans, and the ``stream.{chunks,flushed_events,resume_rungs,
backlog_peak,pack_reuse,*_reuse}`` counters from runner/stream.py).
Times are ``time.monotonic()`` wall seconds — telemetry measures
host/device cost, not virtual time.

Deep code (ops/, checkers/) reaches the recorder through ``current()``,
which returns a no-op ``NullTelemetry`` outside a run, so kernels and
packers are instrumentable without threading a handle through every
call — and pay only an attribute lookup when telemetry is off.
"""

from __future__ import annotations

import json
import math
import socket
import threading
import time
from typing import Any, Iterable, Optional

SCHEMA_VERSION = 1

#: the pinned field sets — a record of each kind carries exactly these
#: (traced recorders append ``trace`` and, when set, ``parent`` AFTER
#: the pinned fields; traceless records carry exactly the tuple)
SPAN_FIELDS = ("kind", "name", "t0", "t1", "dur_s", "attrs")
COUNTER_FIELDS = ("kind", "name", "value")
EVENT_FIELDS = ("kind", "name", "t", "attrs")
HIST_FIELDS = ("kind", "name", "count", "sum", "min", "max", "buckets")

#: total record cap per run: past it records are counted as dropped,
#: never buffered (a pathological dispatch loop must not eat the disk)
MAX_RECORDS = 200_000

#: the canonical name inventory. The cross-run dashboard
#: (forensics/telemetry readers) joins series by name, so a typo'd
#: name silently starts a fresh series; graftlint TEL002 checks every
#: ``span``/``counter``/``event`` call site against this literal (read
#: via ast.literal_eval — never imported). ``*`` matches a
#: parameterized segment (``phase:<name>``, ``stream.<field>_reuse``).
#: Adding an emit site means adding its name here, in the same commit.
REGISTRY = {
    "spans": (
        "phase:*",            # setup/generate/teardown/check/save/...
        "checker:*",          # one composed checker's pass
        "cell:*",             # bench.py per-cell spans
        "wgl.spill",
        "wgl.batch-dispatch",
        "wgl.check_packed",
        "wgl.pack",
        "wgl.pack-batch",
        "mxu.dispatch",
        "mxu.launch",
        "mxu.collect",
        "closure.device",
        "closure.host",
        "stream.chunk",
        "stream.finalize",
        "campaign.sweep",     # runner/campaign.py: the whole pool pass
        "service.tick",       # runner/checker_service.py: one coalesced
                              # device dispatch window
        "fused.gen",          # runner/stream.py FusedPipeline: the
                              # producer's generation leg
        "fused.check",        # ... and the consumer's check leg
        "wgl.tables",         # ops/wgl.py: a ladder's tables padded and
                              # copied to the card (a key, a lane)
        "wgl.frames",         # ... a key's frame tables built: on the
                              # host (ensure_frames, on="host") or on
                              # the card (card_tables, on="card")
        "wgl.graph-capture",  # ... a rung run's warm-up wave and its
                              # CUDA-graph capture
        "wgl.graph-replay",   # ... the run's graph replays and syncs
        "wgl.eager",          # ... its host-launched waves (the rest)
        "wgl.rung-kernel",    # ... or the run in one launch of
                              # csrc/wgl_rung.cu (tables, launch, sync)
        "independent.split",  # checkers/independent.py: the per-key
                              # split
        "oracle.dfs",         # checkers/linearizable.py check_history:
                              # the native DFS or its Python twin
        "elle.collect",       # checkers/elle/append.py: txns
                              # collected, reads checked, version
                              # orders, the non-cycle anomalies
        "elle.graph",         # ... the committed set, the DepGraph's
                              # edges and realtime vectors
        "elle.certificates",  # checkers/elle/graph.py find_cycles
                              # after the closure: reach copied back,
                              # the anchored certificate searches
    ),
    "hists": (
        "op.latency.*",       # per-op-class completion latency, seconds
                              # (checkers/perf.py; virtual time in sim)
        "wgl.check_packed",   # auto-hist of the span walls
        "stream.chunk",       # auto-hist of chunk dispatch walls
        "service.tick",       # auto-hist of service dispatch windows
        "service.queue_wait_s",   # producer-side: this run's packs'
                                  # submit->dispatch waits as reported
                                  # in the service reply
        "stream.chunk_lag_s",  # enqueue->consume delay per chunk,
                               # runner/stream.py
        "wgl.rung_waves",      # one sample per ladder-rung attempt,
                               # value = rung frontier budget — log2
                               # buckets put each rung in its own
                               # bucket, so counts read as search-depth
                               # shape (ops/wgl.py; the guided coverage
                               # vector's wave-histogram feature)
    ),
    "counters": (
        "generate.ops_per_s",
        "columns.events",
        "columns.keyed",
        "columns.extras",
        "columns.disabled",
        "stream.chunks",
        "stream.flushed_events",
        "stream.backlog_peak",
        "stream.resume_rungs",
        "stream.pack_reuse",
        "stream.*_reuse",     # per-consumer reuse, runner/stream.py
        "engine.*",           # verdict-engine routing tally,
                              # checkers/tpu_linearizable.py
        "wgl.dispatches",
        "wgl.rungs",
        "wgl.max-frontier",
        "wgl.host-spill",
        "wgl.waves",              # deepest wave loop of any dispatch
                                  # (mode=max) — the coverage envelope's
                                  # wave-depth dimension
        "mxu.dispatches",
        "campaign.runs",          # runner/campaign.py sweep accounting
        "campaign.completed",
        "campaign.failed",
        "campaign.skipped",
        "campaign.errors",
        "campaign.hosts",         # runner/host_agent.py fan-out:
                                  # worker agents registered at sweep
                                  # start
        "campaign.agent_requeues",  # specs re-queued after an agent
                                  # died mid-run (requeue-capped; past
                                  # the cap the driver runs inline)
        "service.requests",       # runner/checker_service.py batching:
        "service.submitted",      # packs received across all runners
        "service.coalesced",      # packs beyond the first per group
        "service.ticks",          # dispatch windows run
        "service.group_ticks",    # sum of (bucket, width) groups/tick
                                  # == the dispatch budget the coalescer
                                  # is held to (~1 dispatch per group)
        "service.batch_occupancy",  # max packs in one tick (mode=max)
        "service.queue_wait_s",   # total submit->dispatch wait
        "service.device_busy_s.*",  # per-device busy wall attributed
                                  # by dispatch (dev = platform+id; one
                                  # series per chip — fan-counted for a
                                  # sharded tick, every lane chip burns
                                  # the job's wall)
        "service.device_dispatches.*",  # group dispatches per chip
                                  # (fan-counted); ledger identity:
                                  # Σ over chips == service.group_ticks
                                  # + service.shard_fanout
        "service.device_occupancy",  # max distinct chips busy in one
                                  # tick (mode=max)
        "service.sharded_ticks",  # ticks whose single group spread its
                                  # batch axis over the whole mesh
                                  # (shard_map when oversized, GSPMD
                                  # scatter otherwise)
        "service.shard_fanout",   # extra lane-dispatches sharded ticks
                                  # added beyond one-per-group (Σ of
                                  # lanes-1), balancing the per-device
                                  # dispatch ledger
        "service.wgl_wave_launches",  # wave-kernel launches a tick's
                                  # jobs made, each counted on its own
                                  # thread
        "wgl.rung-kernel",        # rung runs csrc/wgl_rung.cu took
        "wgl.frames-card",        # lone ladders whose rung-kernel tables
                                  # csrc/wgl_frames.cu built
        "wgl.pack-columnar",      # keys the batched pack paired, classed
                                  # and decoded from their columns with
                                  # numpy (ops/wgl.py _columnar_extract)
        "service.pack_s",         # host packing wall per tick (the
                                  # half double-buffering overlaps with
                                  # the previous tick's device wall)
        "service.fallback",       # runner-side degradations to
                                  # in-process checking
        "service.fallback.*",     # fallback groups placed per chip by
                                  # fallback_device_for (the service's
                                  # sticky map honored in-process)
        "service.checks",         # runner-side: service round-trips
                                  # that returned verdicts
        "service.shipped",        # runner-side packs shipped; summed
                                  # over a campaign's runs this equals
                                  # the service's service.submitted
        "service.host_submitted.*",  # packs received per generator
                                  # host (JET-HOST preamble); ledger:
                                  # Σ over hosts' rows'
                                  # service_shipped == this series —
                                  # the cross-host shipped==submitted
                                  # join
        "service.admission_rejects",  # check requests bounced BUSY at
                                  # the door (queue/in-flight caps) —
                                  # counted BEFORE deserialization
        "service.busy_retries",   # client-side: BUSY replies absorbed
                                  # by backoff-and-retry
        "service.auth_rejects",   # hello frames with a wrong/missing
                                  # shared-secret token
        "service.reconnects",     # client-side: successful reconnects
                                  # after >=1 failure (the broken
                                  # latch healing)
        "service.heartbeats_sent",  # service-side liveness frames to
                                  # connections with in-flight work
        "service.heartbeats_seen",  # client-side heartbeats consumed
                                  # while waiting (distinguishes slow
                                  # from dead)
        "service.bad_requests",   # undeserializable/oversized check
                                  # bodies answered with a structured
                                  # error (connection survives)
        "service.shutdown_leaked_threads",  # threads still alive
                                  # after close() joins timed out
        "independent.keys",       # per-key fanout of the independent
                                  # split (the producer side of the
                                  # batching axis)
        "net.links",              # net/plane.py proxy fleet: proxies
                                  # raised in front of node ports
        "net.dropped_conns",      # connections blackholed by a drop
                                  # rule or refused (node down)
        "net.dropped_chunks",     # chunks discarded by a lossy-link
                                  # drop_prob rule (netem-loss analog)
        "net.delayed_bytes",      # bytes that paid injected latency
        "net.active_rules",       # peak concurrent fault rules
                                  # (mode=max)
        "net.accept_errors",      # transient accept() failures the
                                  # proxy survived (EMFILE, ...)
        "genbatch.cells",         # simbatch batched generation (campaign
                                  # epoch-v2 routing + bench batched
                                  # leg): (workload, nemesis) cells run
        "genbatch.seeds",         # seeds generated across all cells
        "genbatch.steps",         # lockstep columnar steps executed
        "genbatch.events",        # history rows born as columns
        "genbatch.ops_per_s",     # aggregate events per generation wall
                                  # second across the batch (mode=max)
        "genbatch.compactions",   # BatchHeap tombstone compactions
        "fused.seeds",            # runner/stream.py FusedPipeline:
                                  # seeds generated+checked through the
                                  # overlapped gen->check pipeline
        "fused.packs",            # per-key packs checked by the
                                  # pipeline's consumer leg
        "fused.waves",            # total check_prefix waves the
                                  # consumer advanced while the
                                  # producer was still generating
        "live.records",           # campaign LiveCollector: records
                                  # received over the live socket
        "live.dropped",           # records shed by the bounded queue
                                  # (backpressure, never blocking)
        "guided.generations",     # runner/guided.py search accounting:
                                  # run_campaign waves driven
        "guided.runs",            # runs scored by the scheduler
        "guided.errors",          # rows without a checker verdict
                                  # (never scored — harness noise)
        "guided.failures",        # rows with a real failing verdict
        "guided.novelty",         # summed novelty score admitted to
                                  # the corpus
        "guided.signatures",      # distinct verdict signatures seen
        "guided.corpus",          # peak corpus size (mode=max)
        "guided.mutations",       # mutants generated
        "guided.crossovers",      # crossover children generated
        "guided.corpus-imported",  # ancestors merged from --corpus-in
        "guided.corpus_retired",  # imported ancestors evicted after a
                                  # full generation below score 1
        "store.index_rows",       # runner/store_index.py: rows written
                                  # by a full `store index --rebuild`
        "store.index_writes",     # incremental index rows written at
                                  # save_run / campaign-fold time
        "store.compacted",        # passing runs demoted to index rows
                                  # + summaries by `store compact`
        "store.compact_skipped_failures",  # compaction candidates left
                                  # untouched because they failed
        "shrink.runs",            # runner/shrink.py: shrinks attempted
        "shrink.candidates",      # candidate schedules re-executed
        "shrink.rounds",          # ddmin rounds run
        "shrink.accepted",        # shrinks that reduced the schedule
        "shrink.irreproducible",  # failures that did not reproduce
                                  # under re-execution (left unshrunk)
        "shrink.artifacts",       # shrink.json artifacts written
        "mvcc.reads",             # checkers/mvcc.py consistency
        "mvcc.keys",              # surfaces: observations consumed per
        "mvcc.writes",            # check over the core/mvcc.py model
        "mvcc.ranges",
        "mvcc.grants",
        "mvcc.watches",
        "mvcc.watch-events",
        "mvcc.compactions",
        "mvcc.violations",        # violations across all four surface
                                  # checkers (0 on a clean run)
    ),
    "events": (
        "telemetry.dropped",
        "campaign.run",           # one completed campaign run (attrs:
                                  # workload, nemesis, seed, valid)
        "guided.generation",      # one guided generation dispatched
                                  # (attrs: gen, size)
    ),
}


#: histogram geometry: 64 log2 buckets starting at 1 microsecond.
#: Bucket 0 is [0, HIST_MIN] (plus any negative clock skew); bucket i
#: covers (HIST_MIN * 2**(i-1), HIST_MIN * 2**i]. 64 doublings from
#: 1 us tops out near 9e12 s — every latency this harness can see fits.
HIST_MIN = 1e-6
HIST_BUCKETS = 64

#: spans whose wall durations are ALSO folded into a same-named
#: histogram on close of each span (the hot paths ISSUE 14 names)
HIST_SPAN_NAMES = frozenset(
    {"wgl.check_packed", "stream.chunk", "service.tick"})


class Hist:
    """Fixed-geometry log2 histogram: bounded memory (64 ints), exact
    count/sum/min/max, mergeable across runs by bucket-wise addition —
    the HDR-histogram idea reduced to the precision dashboards need.
    """

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self) -> None:
        self.counts = [0] * HIST_BUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    @staticmethod
    def bucket_of(value: float) -> int:
        if not value > HIST_MIN:
            return 0
        # bucket i covers (MIN*2**(i-1), MIN*2**i]: upper edge inclusive
        return max(1, min(HIST_BUCKETS - 1,
                          int(math.ceil(math.log2(value / HIST_MIN)))))

    @staticmethod
    def bucket_edges(i: int) -> tuple:
        """(lo, hi) of bucket i; bucket 0 starts at 0."""
        if i <= 0:
            return (0.0, HIST_MIN)
        return (HIST_MIN * 2.0 ** (i - 1), HIST_MIN * 2.0 ** i)

    def record(self, value: float) -> None:
        self.counts[self.bucket_of(value)] += 1
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    def record_many(self, values: Iterable[float]) -> None:
        """Vectorized bulk insert (used for per-class op latencies,
        tens of thousands of points per run)."""
        import numpy as np
        a = np.asarray(values if hasattr(values, "__len__")
                       else list(values), dtype=np.float64).ravel()
        a = a[np.isfinite(a)]
        if a.size == 0:
            return
        idx = np.zeros(a.shape, dtype=np.int64)
        big = a > HIST_MIN
        if big.any():
            idx[big] = np.clip(
                np.ceil(np.log2(a[big] / HIST_MIN)).astype(np.int64),
                1, HIST_BUCKETS - 1)
        for i, c in zip(*np.unique(idx, return_counts=True)):
            self.counts[int(i)] += int(c)
        self.count += int(a.size)
        self.sum += float(a.sum())
        self.min = min(self.min, float(a.min()))
        self.max = max(self.max, float(a.max()))

    def merge(self, other: "Hist") -> "Hist":
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 100]; linear interpolation inside the landing
        bucket, clamped to the exact observed [min, max]."""
        if not self.count:
            return None
        target = (q / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if cum + c >= target:
                lo, hi = self.bucket_edges(i)
                v = lo + ((target - cum) / c) * (hi - lo)
                return min(max(v, self.min), self.max)
            cum += c
        return self.max

    # -- serialization --------------------------------------------------------
    def to_dict(self) -> dict:
        """Sparse, mergeable, JSON-stable form used in summaries,
        campaign rows, and ``"hist"`` records."""
        if not self.count:
            return {"count": 0, "sum": 0.0, "min": None, "max": None,
                    "p50": None, "p95": None, "p99": None,
                    "buckets": {}}
        return {"count": self.count, "sum": round(self.sum, 9),
                "min": round(self.min, 9), "max": round(self.max, 9),
                "p50": round(self.percentile(50), 9),
                "p95": round(self.percentile(95), 9),
                "p99": round(self.percentile(99), 9),
                "buckets": {str(i): c for i, c in enumerate(self.counts)
                            if c}}

    @classmethod
    def from_dict(cls, d: dict) -> "Hist":
        h = cls()
        for k, c in (d.get("buckets") or {}).items():
            h.counts[int(k)] += int(c)
        h.count = int(d.get("count") or 0)
        h.sum = float(d.get("sum") or 0.0)
        if d.get("min") is not None:
            h.min = float(d["min"])
        if d.get("max") is not None:
            h.max = float(d["max"])
        return h


class _Span:
    """Context manager for one span; ``set(**attrs)`` attaches result
    attributes (engine, rung count, ...) before the span closes."""

    __slots__ = ("_tel", "name", "attrs", "t0")

    def __init__(self, tel: "Telemetry", name: str, attrs: dict):
        self._tel = tel
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        self.t0 = self._tel._clock()
        return self

    def __exit__(self, *exc) -> None:
        self._tel._end_span(self)


class _NullSpan:
    """No-op span: zero work outside a run."""

    __slots__ = ()

    def set(self, **attrs: Any) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class NullTelemetry:
    """The recorder used outside a run: every call is a no-op."""

    enabled = False
    trace = None

    def span(self, name: str, **attrs: Any) -> _NullSpan:
        return _NULL_SPAN

    def counter(self, name: str, value: float = 1,
                mode: str = "sum") -> None:
        pass

    def event(self, name: str, **attrs: Any) -> None:
        pass

    def hist(self, name: str, value: float) -> None:
        pass

    def hist_many(self, name: str, values: Iterable[float]) -> None:
        pass

    def summary(self) -> dict:
        return {}

    def close(self) -> None:
        pass


NULL = NullTelemetry()


class Telemetry:
    """Span/counter recorder streaming to a .jsonl file.

    Thread-safe: live runs complete ops from socket threads, and a
    counter bump must never corrupt the stream. The file opens lazily
    on the first record and every record is written (buffered by the
    underlying file object) as it happens — a crashed run keeps the
    spans it completed.
    """

    enabled = True

    def __init__(self, path: Optional[str] = None,
                 clock=time.monotonic,
                 max_records: int = MAX_RECORDS,
                 trace: Optional[str] = None,
                 parent: Optional[str] = None,
                 sink: Optional[str] = None):
        self.path = path
        self._clock = clock
        self._fh = None
        self._lock = threading.Lock()
        self._max_records = max_records
        self.records = 0
        self.dropped = 0
        #: trace identity stamped on every record (``trace``/``parent``
        #: fields AFTER the pinned tuple; absent when trace is None)
        self.trace = trace
        self.parent = parent
        # name -> [count, total_s]; insertion-ordered like the file
        self._span_agg: dict[str, list] = {}
        # name -> value; mode "max" counters keep the running max
        self._counters: dict[str, float] = {}
        # name -> Hist; flushed as "hist" records at close
        self._hists: dict[str, Hist] = {}
        self._closed = False
        # optional live sink: an AF_UNIX datagram socket path the
        # campaign collector listens on; strictly best-effort — a full
        # or missing socket drops the datagram, never blocks the run
        self._sink_path = sink
        self._sink_sock = None
        self._sink_errors = 0
        self.sink_dropped = 0

    # -- recording -----------------------------------------------------------
    def span(self, name: str, **attrs: Any) -> _Span:
        return _Span(self, name, attrs)

    def _end_span(self, sp: _Span) -> None:
        t1 = self._clock()
        dur = t1 - sp.t0
        with self._lock:
            agg = self._span_agg.setdefault(sp.name, [0, 0.0])
            agg[0] += 1
            agg[1] += dur
            if sp.name in HIST_SPAN_NAMES:
                self._hists.setdefault(sp.name, Hist()).record(dur)
            self._write({"kind": "span", "name": sp.name,
                         "t0": sp.t0, "t1": t1, "dur_s": dur,
                         "attrs": sp.attrs})

    def counter(self, name: str, value: float = 1,
                mode: str = "sum") -> None:
        """Accumulate a named counter; ``mode="max"`` keeps the running
        maximum (e.g. peak frontier width) instead of the sum. Counters
        are flushed as records at close, not per bump."""
        with self._lock:
            if mode == "max":
                self._counters[name] = max(
                    self._counters.get(name, value), value)
            else:
                self._counters[name] = self._counters.get(name, 0) + value

    def event(self, name: str, **attrs: Any) -> None:
        with self._lock:
            self._write({"kind": "event", "name": name,
                         "t": self._clock(), "attrs": attrs})

    def hist(self, name: str, value: float) -> None:
        """Fold one observation into the named histogram. Histograms
        live in memory (64 ints each) and flush as one ``"hist"``
        record at close."""
        with self._lock:
            self._hists.setdefault(name, Hist()).record(value)

    def hist_many(self, name: str, values: Iterable[float]) -> None:
        """Vectorized :meth:`hist` for bulk observations."""
        with self._lock:
            self._hists.setdefault(name, Hist()).record_many(values)

    def _write(self, rec: dict) -> None:
        # caller holds the lock
        if self._closed:
            return
        if self.records >= self._max_records:
            self.dropped += 1
            return
        self.records += 1
        self._emit(rec)

    def _emit(self, rec: dict) -> None:
        """Serialize once, append to the file and forward to the live
        sink (both best-effort independent). Caller holds the lock and
        has already done cap accounting."""
        if self.path is None and self._sink_path is None:
            return
        if self.trace is not None:
            rec["trace"] = self.trace
            if self.parent is not None:
                rec["parent"] = self.parent
        line = json.dumps(rec, default=repr)
        if self.path is not None:
            if self._fh is None:
                self._fh = open(self.path, "w")
            self._fh.write(line + "\n")
        if self._sink_path is not None:
            self._sink_send(line.encode("utf-8", "replace"))

    def _sink_send(self, data: bytes) -> None:
        # caller holds the lock; drop-and-count, never block or raise
        if self._sink_sock is None:
            try:
                self._sink_sock = socket.socket(
                    socket.AF_UNIX, socket.SOCK_DGRAM)
                self._sink_sock.setblocking(False)
            except OSError:
                self._sink_path = None
                return
        try:
            self._sink_sock.sendto(data, self._sink_path)
            self._sink_errors = 0
        except (BlockingIOError, InterruptedError):
            self.sink_dropped += 1     # receiver backlogged: shed
        except OSError:
            self.sink_dropped += 1
            self._sink_errors += 1
            if self._sink_errors >= 8:  # collector gone: stop trying
                self._sink_path = None

    # -- reading -------------------------------------------------------------
    def summary(self) -> dict:
        """Aggregate view for results.json: per-span-name totals (the
        file's span records sum to exactly these — same floats, same
        order), counters, and the phase / per-checker convenience maps
        derived from the span-name conventions."""
        with self._lock:
            spans = {name: {"count": c, "total_s": t}
                     for name, (c, t) in self._span_agg.items()}
            counters = dict(self._counters)
            hists = {name: h.to_dict()
                     for name, h in self._hists.items()}
            dropped = self.dropped
        out = {
            "schema": SCHEMA_VERSION,
            "spans": spans,
            "counters": counters,
            "phases": {n[len("phase:"):]: v["total_s"]
                       for n, v in spans.items()
                       if n.startswith("phase:")},
            "checkers": {n[len("checker:"):]: v["total_s"]
                         for n, v in spans.items()
                         if n.startswith("checker:")},
        }
        if hists:
            out["hists"] = hists
        if self.trace is not None:
            out["trace"] = self.trace
        if dropped:
            out["dropped"] = dropped
        if self.path is not None:
            import os
            out["file"] = os.path.basename(self.path)
        return out

    def close(self) -> None:
        """Flush counters and histograms as records and close the
        stream. Idempotent."""
        with self._lock:
            if self._closed:
                return
            for name, value in self._counters.items():
                if self.records < self._max_records:
                    self.records += 1
                    self._emit({"kind": "counter", "name": name,
                                "value": value})
                else:
                    self.dropped += 1
            for name, h in self._hists.items():
                if self.records < self._max_records:
                    self.records += 1
                    d = h.to_dict()
                    self._emit({"kind": "hist", "name": name,
                                "count": d["count"], "sum": d["sum"],
                                "min": d["min"], "max": d["max"],
                                "buckets": d["buckets"]})
                else:
                    self.dropped += 1
            if self.dropped:
                self._emit({"kind": "event",
                            "name": "telemetry.dropped",
                            "t": self._clock(),
                            "attrs": {"dropped": self.dropped}})
            self._closed = True
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            if self._sink_sock is not None:
                try:
                    self._sink_sock.close()
                except OSError:
                    pass
                self._sink_sock = None


def load_jsonl(path: str) -> tuple:
    """Read a ``*.jsonl`` artifact tolerantly: ``(records, skipped)``.

    A killed run (or a reader racing the writer) leaves a truncated
    trailing line; readers must skip-and-count, never crash. Non-dict
    rows and undecodable bytes count as skipped too."""
    records: list = []
    skipped = 0
    try:
        fh = open(path, "rb")
    except OSError:
        return records, skipped
    with fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line.decode("utf-8", "replace"))
            except ValueError:
                skipped += 1
                continue
            if not isinstance(rec, dict):
                skipped += 1
                continue
            records.append(rec)
    return records, skipped


#: the process-current recorder; NULL outside a run
_current: Any = NULL

#: per-thread override: a service dispatcher (or any worker thread
#: that must record into its own stream) pins its recorder here
#: WITHOUT touching the process-global — concurrent threads keep
#: recording into theirs, closing the swap race checker_service.py
#: used to have
_tls = threading.local()


def current() -> Any:
    """The calling thread's pinned Telemetry if one is set (see
    :func:`set_thread_current`), else the process-current recorder,
    else the no-op NULL outside a run."""
    tel = getattr(_tls, "tel", None)
    return tel if tel is not None else _current


def set_current(tel: Optional[Telemetry]) -> None:
    """Install (or with None, clear) the process-current recorder."""
    global _current
    _current = tel if tel is not None else NULL


def set_thread_current(tel: Optional[Telemetry]) -> None:
    """Pin (or with None, unpin) a recorder for THIS thread only.
    ``current()`` prefers the thread pin over the process-global, so a
    long-lived worker thread can record into its own stream while
    other threads' runs stay untouched."""
    _tls.tel = tel
