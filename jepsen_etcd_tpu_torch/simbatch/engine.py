"""Lockstep batched generator: S seeds' client/nemesis simulations as
columnar numpy steps, histories born as OpColumns (the port of the
reference's ``simbatch/engine.py``, copied: numpy on the host).

Where ``runner/sim.py`` interprets ONE seed's discrete-event simulation
on the CPython event loop (epoch-v1), this engine advances S seeds at
once: every step pops one due event per live seed from a
:class:`~..simbatch.heap.BatchHeap`, applies the register/set client
state machines as ``(S,)``-wide masked array ops, and appends one
``(S,)`` column per history field. At the end, each seed's rows gather
straight into a ``core/history.py`` OpColumns — no per-op dicts are
ever built, so histories enter the dict-free checker pipeline with
zero conversion.

Determinism contract (generator epoch-v2; see the epoch ledger in
runner/sim.py):

- Per-seed histories are a pure function of ``(seed, BatchConfig)`` —
  every random draw comes from that seed's own
  ``np.random.default_rng(seed)`` block, pre-drawn before the loop, and
  heap sequence numbers advance per seed. Batch composition (which
  other seeds ride along, and how many) cannot perturb a history; the
  16-seed golden-hash pin in tests/test_simbatch.py holds seed-by-seed.
- Event times carry a lane residue (``time = t_ns * STRIDE + lane``)
  so no two lanes of one seed ever share an instant; the epoch-v2
  same-instant rule (ascending lane, then push seq) therefore never
  has to arbitrate inside generated histories — it is pinned at the
  heap level by unit tests instead.
- The linearization point of every client op is its completion
  instant, and completions are totally ordered per seed, so every
  generated history is linearizable by construction. That is what
  makes the epoch-v2 vs epoch-v1 fuzz a *verdict*-equality check:
  histories differ op-by-op across epochs (the point of declaring an
  epoch), but any state-machine bug here flips a checker verdict.

Timeouts model indeterminacy: while a nemesis window is open, each
completion may instead resolve as an ``info`` op (the invoke's payload,
``{"error": "timeout"}``), the register/set state is NOT advanced, and
the process retires exactly like epoch-v1's client error path
(``proc += lanes``).

Performance shape: per-op draw planes (f, write/cas values, latency,
gap, timeout, payload-kind) are pre-folded into ONE ``(R, S, L, O)``
stack so each step gathers single ``(R, S)`` slabs instead of ~10
separate advanced-index reads. And because invoke rows carry no
machine state — every field is a pure draw — the heap only schedules
COMPLETION and nemesis events: each completion step emits the
completion row *and* the next op's invoke row with its proper (later)
timestamp, and the finish phase restores each seed's global row order
with one argsort over the (unique) times. Step count is therefore one
per completion, not one per history row.
"""

from __future__ import annotations

from bisect import insort

import numpy as np

from ..core.history import History, OpColumns
from .heap import EPOCH_V1, EPOCH_V2, BatchHeap

GEN_EPOCH_V1 = EPOCH_V1
GEN_EPOCH_V2 = EPOCH_V2

#: MVCC consistency-surface workloads (workloads/mvcc.py, lock.py):
#: generated by the per-seed sweep in ``_generate_mvcc`` — same draw
#: blocks and nemesis window arithmetic as the lockstep path, but the
#: per-op state machines are richer (version chains, lease table,
#: revision counter + compaction watermark), so they run seed-by-seed.
MVCC_WORKLOADS = ("register-stale", "ranges", "lock-lease",
                  "compact-watch")

SUPPORTED_WORKLOADS = ("register", "set") + MVCC_WORKLOADS

#: lane-residue stride: event times are ``t_ns * STRIDE + lane``, so
#: lane count (clients + 1 nemesis lane) must stay below it
STRIDE = 64

KIND_INVOKE = 0
KIND_COMPLETE = 1
KIND_NEM = 2

# history type codes (core/history.py _TYPE_CODES order)
TC_INVOKE, TC_OK, TC_FAIL, TC_INFO = 0, 1, 2, 3

# payload kinds: how a row's (va, vb, vc) int slots decode to a value
PK_REG_RD_INV = 1
PK_REG_RD_OK = 2
PK_REG_WR_INV = 3
PK_REG_WR_OK = 4
PK_REG_CAS_INV = 5
PK_REG_CAS_OK = 6
PK_REG_CAS_FAIL = 7
PK_SET_ADD = 8
PK_SET_RD_INV = 9
PK_SET_RD_OK = 10
PK_NEM = 11

# register f codes (f_table prefix) / set f codes
FC_READ, FC_WRITE, FC_CAS = 0, 1, 2
FC_ADD, FC_SRD = 0, 1

#: per-fault probability that a completion inside an open nemesis
#: window resolves as a timeout info instead
P_TIMEOUT = {"partition": 0.25, "latency": 0.06, "kill": 0.18}
P_TIMEOUT_DEFAULT = 0.12

#: stale-read injection rate (inject_stale_reads knob; the draw is
#: always made so the knob cannot shift any other draw). With a fault
#: schedule present the injection models a stale read served by a
#: partitioned replica: it fires only while a partition window is OPEN
#: (guided campaigns steer toward exactly those cells). With no faults
#: at all it stays unconditional (the session-checker regression case).
STALE_P = 0.25

#: ns between a nemesis invoke and its :info (fault apply latency)
NEM_APPLY_NS = 2_000_000
#: fault/heal cycles per nemesis per run
NEM_CYCLES = 4

#: nemesis start-op values by fault kind (stop value is always None),
#: mirroring nemesis/faults.py specs
NEM_START_VALUE = {
    "partition": "majority",
    "latency": {"delta-ms": 40.0, "jitter-ms": 8.0},
}


#: per-workload client f tables (nemesis start/stop pairs append after)
_F_TABLES = {
    "register": ["read", "write", "cas"],
    "set": ["add", "read"],
    "register-stale": ["read", "write"],
    "ranges": ["range", "write"],
    "lock-lease": ["acquire", "release"],
    "compact-watch": ["write", "watch", "compact"],
}


def supports(workload: str) -> bool:
    return workload in SUPPORTED_WORKLOADS


def _norm_schedule(schedule, nemeses):
    """Normalize an explicit nemesis schedule to a sorted tuple of
    ``(start_ns, kind, hold_ns)`` windows. ``kind`` must name a fault
    in ``nemeses`` (the window replays that fault's start/stop pair)."""
    if schedule is None:
        return None
    out = []
    for w in schedule:
        start, kind, hold = w
        if kind not in nemeses:
            raise ValueError(f"schedule window kind {kind!r} not in "
                             f"nemeses {tuple(nemeses)!r}")
        out.append((int(start), str(kind), int(hold)))
    out.sort(key=lambda w: (w[0], w[2], w[1]))
    return tuple(out)


class BatchConfig:
    """Sizing + workload knobs; with a seed, fully determines one
    history. ``from_opts`` is the stable opts→config mapping the
    campaign router and bench use (changing it would re-key every
    pinned golden hash — bump the epoch instead).

    ``nem_schedule`` replays an explicit window list instead of the
    drawn nemesis cycles; draws are still made in full, so a config
    with no schedule is bit-identical to the pre-schedule epoch.
    ``partition_shape``/``latency_ms``/``drop_prob`` are the guided
    mutation knobs: shape swaps the partition start value, latency
    scales the latency-window timeout rate, drop_prob adds a flat
    timeout rate inside every open window."""

    __slots__ = ("workload", "nemeses", "lanes", "readers", "keys",
                 "ops_per_lane", "rate", "key_offset",
                 "inject_stale_reads", "nem_schedule",
                 "partition_shape", "latency_ms", "drop_prob",
                 "lease_ttl_ms", "compact_keep",
                 "inject_stale_snapshot", "inject_torn_range",
                 "inject_double_grant", "inject_compaction_swallow")

    def __init__(self, workload="register", nemeses=(), lanes=8,
                 ops_per_lane=64, rate=200.0, keys=None, readers=None,
                 key_offset=0, inject_stale_reads=False,
                 nem_schedule=None, partition_shape=None,
                 latency_ms=None, drop_prob=0.0, lease_ttl_ms=1500.0,
                 compact_keep=8, inject_stale_snapshot=False,
                 inject_torn_range=False, inject_double_grant=False,
                 inject_compaction_swallow=False):
        if workload not in SUPPORTED_WORKLOADS:
            raise ValueError(f"simbatch does not support workload "
                             f"{workload!r} (supported: "
                             f"{SUPPORTED_WORKLOADS})")
        self.workload = workload
        self.nemeses = tuple(nemeses or ())
        self.lanes = max(2, min(int(lanes), STRIDE - 2))
        r = int(readers) if readers is not None else self.lanes // 2
        self.readers = max(1, min(self.lanes - 1, r))
        k = int(keys) if keys is not None else max(1, self.lanes // 4)
        self.keys = max(1, k)
        self.ops_per_lane = max(2, int(ops_per_lane))
        self.rate = float(rate) if rate else 200.0
        self.key_offset = int(key_offset)
        self.inject_stale_reads = bool(inject_stale_reads)
        self.nem_schedule = _norm_schedule(nem_schedule, self.nemeses)
        self.partition_shape = (str(partition_shape)
                                if partition_shape else None)
        self.latency_ms = (float(latency_ms)
                           if latency_ms is not None else None)
        self.drop_prob = min(1.0, max(0.0, float(drop_prob or 0.0)))
        self.lease_ttl_ms = float(lease_ttl_ms or 1500.0)
        self.compact_keep = max(1, int(compact_keep or 8))
        self.inject_stale_snapshot = bool(inject_stale_snapshot)
        self.inject_torn_range = bool(inject_torn_range)
        self.inject_double_grant = bool(inject_double_grant)
        self.inject_compaction_swallow = bool(inject_compaction_swallow)

    @classmethod
    def from_opts(cls, opts: dict) -> "BatchConfig":
        nodes = opts.get("nodes") or ["n1", "n2", "n3"]
        conc = int(opts.get("concurrency") or 2 * len(nodes))
        lanes = max(2, min(conc, 16))
        rate = float(opts.get("rate") or 200.0)
        tl = float(opts.get("time_limit") or 30.0)
        total = max(2 * lanes, int(tl * rate))
        return cls(
            workload=opts.get("workload", "register"),
            nemeses=tuple(opts.get("nemesis") or ()),
            lanes=lanes,
            ops_per_lane=max(2, total // lanes),
            rate=rate,
            key_offset=int(opts.get("key_offset") or 0),
            inject_stale_reads=bool(opts.get("inject_stale_reads")),
            nem_schedule=opts.get("nem_schedule"),
            partition_shape=opts.get("nem_partition_shape"),
            latency_ms=opts.get("nem_latency_ms"),
            drop_prob=opts.get("nem_drop_prob") or 0.0,
            lease_ttl_ms=opts.get("lease_ttl_ms") or 1500.0,
            compact_keep=opts.get("compact_keep") or 8,
            inject_stale_snapshot=bool(opts.get("inject_stale_snapshot")),
            inject_torn_range=bool(opts.get("inject_torn_range")),
            inject_double_grant=bool(opts.get("inject_double_grant")),
            inject_compaction_swallow=bool(
                opts.get("inject_compaction_swallow")),
        )

    def to_dict(self) -> dict:
        """JSON-safe round-trip: ``BatchConfig(**cfg.to_dict())`` —
        shrink artifacts persist this so replay does not depend on the
        opts→config mapping staying stable."""
        return {
            "workload": self.workload, "nemeses": list(self.nemeses),
            "lanes": self.lanes, "readers": self.readers,
            "keys": self.keys, "ops_per_lane": self.ops_per_lane,
            "rate": self.rate, "key_offset": self.key_offset,
            "inject_stale_reads": self.inject_stale_reads,
            "nem_schedule": ([list(w) for w in self.nem_schedule]
                             if self.nem_schedule is not None else None),
            "partition_shape": self.partition_shape,
            "latency_ms": self.latency_ms, "drop_prob": self.drop_prob,
            "lease_ttl_ms": self.lease_ttl_ms,
            "compact_keep": self.compact_keep,
            "inject_stale_snapshot": self.inject_stale_snapshot,
            "inject_torn_range": self.inject_torn_range,
            "inject_double_grant": self.inject_double_grant,
            "inject_compaction_swallow": self.inject_compaction_swallow,
        }

    def cache_key(self) -> tuple:
        """Hashable identity of everything that shapes a generated
        history (besides the seed) — the campaign router coalesces a
        cell only when this whole tuple matches, so guided mutants with
        distinct schedules/knobs never share a generate() call."""
        return (self.workload, self.nemeses, self.lanes, self.readers,
                self.keys, self.ops_per_lane, self.rate,
                self.key_offset, self.inject_stale_reads,
                self.nem_schedule, self.partition_shape,
                self.latency_ms, self.drop_prob, self.lease_ttl_ms,
                self.compact_keep, self.inject_stale_snapshot,
                self.inject_torn_range, self.inject_double_grant,
                self.inject_compaction_swallow)

    def f_table(self) -> list:
        base = list(_F_TABLES[self.workload])
        for kind in self.nemeses:
            base.append(f"start-{kind}")
            base.append(f"stop-{kind}")
        return base

    def nem_f_base(self) -> int:
        return len(_F_TABLES[self.workload])


def schedule_span(config: BatchConfig) -> int:
    """Rough per-lane wall span of a run in ns — the same arithmetic
    ``_draws`` uses to space nemesis cycles. Guided mutations draw new
    window start/hold times inside this span."""
    gap_ns = max(1_000_000, int(config.lanes * 1e9 / config.rate))
    return config.ops_per_lane * (gap_ns + 3_000_000)


def default_schedule(config: BatchConfig, seed: int) -> list:
    """Materialize the DRAWN nemesis schedule of ``(config, seed)`` as
    an explicit ``[(start_ns, kind, hold_ns), ...]`` window list.

    Replaying it through ``nem_schedule`` reproduces the drawn run
    bit-for-bit (pinned by tests): the phase machine's absolute event
    times are start = prev stop-ok + wait, stop-ok = start +
    2*NEM_APPLY_NS + hold, so the wait/hold draws convert to absolute
    windows and back exactly. This is the shrinker's starting corpus
    for runs that never carried an explicit schedule."""
    if not config.nemeses:
        return []
    d = _draws(config, [int(seed)])
    out, tcur = [], 0
    for c in range(NEM_CYCLES):
        start = tcur + int(d["nwait"][0, c])
        hold = int(d["nhold"][0, c])
        out.append((start, config.nemeses[int(d["nkind"][0, c])], hold))
        tcur = start + 2 * NEM_APPLY_NS + hold
    return out


def _schedule_arrays(schedules, nemeses):
    """Convert per-seed explicit window lists into the phase machine's
    ``(nwait, nhold, nkind, n_cycles)`` arrays (ns, pre-STRIDE).

    Inverse of :func:`default_schedule`'s absolute-time conversion;
    short schedules are padded (padding is never reached because the
    machine stops pushing at each seed's own cycle count)."""
    S = len(schedules)
    C = max([len(sc) for sc in schedules] + [1])
    nwait = np.ones((S, C), np.int64)
    nhold = np.ones((S, C), np.int64)
    nkind = np.zeros((S, C), np.int64)
    ncyc = np.array([len(sc) for sc in schedules], np.int64)
    kidx = {kd: i for i, kd in enumerate(nemeses)}
    for s, sc in enumerate(schedules):
        prev_end = 0
        for c, (start, kd, hold) in enumerate(sc):
            nwait[s, c] = max(1, int(start) - prev_end)
            nhold[s, c] = max(1, int(hold))
            nkind[s, c] = kidx[kd]
            prev_end = prev_end + nwait[s, c] + 2 * NEM_APPLY_NS \
                + nhold[s, c]
    return nwait, nhold, nkind, ncyc


def _p_timeout(config: BatchConfig, kind: str) -> float:
    """Per-kind in-window timeout probability with the guided knobs
    folded in (defaults leave the pre-knob values bit-identical)."""
    p = P_TIMEOUT.get(kind, P_TIMEOUT_DEFAULT)
    if kind == "latency" and config.latency_ms is not None:
        p = min(0.9, p * config.latency_ms / 40.0)
    return min(1.0, p + config.drop_prob)


def _draws_shape_params(config: BatchConfig) -> tuple:
    """The draw-block geometry both epochs share: ``(L, O, ncy, nnem,
    gap_ns, w_lo, w_hi)``. Part of each epoch's contract — it depends
    only on the config, never on simulation outcomes."""
    L, O = config.lanes, config.ops_per_lane
    ncy = NEM_CYCLES
    gap_ns = max(1_000_000, int(config.lanes * 1e9 / config.rate))
    # rough per-lane span drives nemesis cycle spacing
    span = schedule_span(config)
    w_lo, w_hi = max(1, span // (3 * ncy)), max(2, span // (2 * ncy))
    nnem = max(1, len(config.nemeses))
    return L, O, ncy, nnem, gap_ns, w_lo, w_hi


def _draws(config: BatchConfig, seeds) -> dict:
    """Pre-draw every random block, one independent generator per seed.

    Draw ORDER and SHAPES are part of the epoch: they depend only on
    the config, never on simulation outcomes, so per-seed streams stay
    aligned and histories stay pure functions of (seed, config). The
    stale-read block is always drawn (even when injection is off) so
    the knob cannot shift any other draw; likewise the nemesis blocks
    are drawn even when an explicit ``nem_schedule`` replaces them.
    """
    L, O, ncy, nnem, gap_ns, w_lo, w_hi = _draws_shape_params(config)
    cols = {k: [] for k in ("start", "fsel", "wval", "cold", "cnew",
                            "lat", "gap", "tmo", "stale",
                            "nwait", "nhold", "nkind")}
    for sd in seeds:
        rng = np.random.default_rng(int(sd))
        cols["start"].append(rng.integers(0, gap_ns, L))
        cols["fsel"].append(rng.integers(0, 2, (L, O)))
        cols["wval"].append(rng.integers(0, 5, (L, O)))
        cols["cold"].append(rng.integers(0, 5, (L, O)))
        cols["cnew"].append(rng.integers(0, 5, (L, O)))
        cols["lat"].append(rng.integers(1_000_000, 5_000_000, (L, O)))
        cols["gap"].append(rng.integers(gap_ns // 2,
                                        gap_ns + gap_ns // 2, (L, O)))
        cols["tmo"].append(rng.random((L, O)))
        cols["stale"].append(rng.random((L, O)))
        cols["nwait"].append(rng.integers(w_lo, w_hi, ncy))
        cols["nhold"].append(rng.integers(w_lo, w_hi, ncy))
        cols["nkind"].append(rng.integers(0, nnem, ncy))
    return {k: np.stack(v) for k, v in cols.items()}


# draw-plane rows of the folded (R, S, L, O) per-op stack
_CF, _CWV, _CCO, _CCN, _CLAT, _CGAP, _CPKI, _CVAI, _CVBI, _CTMO, \
    _CSTALE = range(11)

# the invoke-row slice gathered per step for the NEXT op
_INV_PLANES = np.array([_CF, _CPKI, _CVAI, _CVBI, _CLAT])[:, None]
_IF, _IPKI, _IVAI, _IVBI, _ILAT = range(5)


def generate(config: BatchConfig, seeds, nem_schedules=None) -> dict:
    """Run S seeds' simulations in lockstep; return their histories
    born columnar.

    ``nem_schedules`` (optional, one explicit window list per seed)
    overrides the drawn nemesis cycles per lane — the shrinker re-runs
    a whole candidate population in ONE call by repeating the failing
    seed across lanes with a different candidate schedule each.

    Returns ``{"histories": [History per seed], "epoch": "epoch-v2",
    "seeds": [...], "events": int, "steps": int, "compactions": int}``.
    """
    seeds = [int(s) for s in seeds]
    S = len(seeds)
    if S == 0:
        return {"histories": [], "epoch": GEN_EPOCH_V2, "seeds": [],
                "events": 0, "steps": 0, "compactions": 0}
    if config.workload in MVCC_WORKLOADS:
        return _generate_mvcc(config, seeds, nem_schedules)
    L, O, K = config.lanes, config.ops_per_lane, config.keys
    NL = L  # nemesis lane id (time residue); L <= STRIDE - 2
    is_register = config.workload == "register"
    has_nem = bool(config.nemeses)
    inject_stale = config.inject_stale_reads
    # stale reads are replica-staleness: with faults configured they
    # fire only inside an open partition window (see STALE_P)
    part_idx = (config.nemeses.index("partition")
                if "partition" in config.nemeses else -2)
    d = _draws(config, seeds)
    AR = np.arange(S)

    # lane roles: first `readers` lanes read-only, the rest write
    readers = config.readers
    key_of_lane = (np.arange(L, dtype=np.int64) % K if is_register
                   else np.full(L, -1, np.int64))
    if is_register:
        # readers: f=read; writers alternate write/cas by fsel
        fop = np.where(np.arange(L)[None, :, None] < readers,
                       FC_READ, FC_WRITE + d["fsel"])
        pki = np.where(fop == FC_READ, PK_REG_RD_INV,
                       np.where(fop == FC_WRITE, PK_REG_WR_INV,
                                PK_REG_CAS_INV))
        vai = np.where(fop == FC_WRITE, d["wval"],
                       np.where(fop == FC_CAS, d["cold"], -1))
        vbi = np.where(fop == FC_CAS, d["cnew"], -1)
    else:
        fop = np.where(np.arange(L)[None, :, None] < readers,
                       FC_SRD, FC_ADD)
        # per-seed-unique add values: op_index * writers + writer_rank
        wrank = np.arange(L, dtype=np.int64) - readers  # <0 for readers
        nwriters = L - readers
        addval = (np.arange(O, dtype=np.int64)[None, None, :] * nwriters
                  + np.where(wrank < 0, 0, wrank)[None, :, None])
        pki = np.where(fop == FC_ADD, PK_SET_ADD, PK_SET_RD_INV)
        vai = np.where(fop == FC_ADD, addval, -1)
        vbi = np.full_like(vai, -1)
    planes = [fop, d["wval"], d["cold"], d["cnew"],
              d["lat"] * STRIDE, d["gap"] * STRIDE, pki, vai, vbi,
              (d["tmo"] * 1e9).astype(np.int64),
              (d["stale"] < STALE_P).astype(np.int64)]
    CL = np.stack([np.broadcast_to(p, (S, L, O)) for p in planes])
    p_by_kind = (np.array(
        [_p_timeout(config, kd) for kd in config.nemeses]
        or [0.0]) * 1e9).astype(np.int64)
    if nem_schedules is not None:
        if len(nem_schedules) != S:
            raise ValueError("nem_schedules must align with seeds "
                             f"({len(nem_schedules)} != {S})")
        scheds = [_norm_schedule(sc, config.nemeses) or ()
                  for sc in nem_schedules]
    elif config.nem_schedule is not None:
        scheds = [config.nem_schedule] * S
    else:
        scheds = None
    if has_nem and scheds is not None:
        nw, nh, nkind, n_cycles = _schedule_arrays(scheds,
                                                   config.nemeses)
        nwaitE = nw * STRIDE
        nholdE = nh * STRIDE
        ncyc_cap = nkind.shape[1]
    else:
        nwaitE = d["nwait"] * STRIDE
        nholdE = d["nhold"] * STRIDE
        nkind = d["nkind"]
        n_cycles = np.full(S, NEM_CYCLES, np.int64)
        ncyc_cap = NEM_CYCLES
    nem_apply = NEM_APPLY_NS * STRIDE
    nfb = config.nem_f_base()

    # lane residues make per-seed event times unique, so the heap can
    # skip epoch-ordinal bookkeeping (identical results, cheaper steps)
    heap = BatchHeap(S, capacity=NL + 1, epoch=GEN_EPOCH_V2,
                     unique_times=True)

    # per-seed machine state
    opi = np.zeros((S, L), np.int64)       # op index in flight per lane
    retire = np.zeros((S, L), np.int64)    # info-retirement count
    done_lanes = np.zeros(S, np.int64)
    ver = np.zeros((S, K), np.int64)
    val = np.full((S, K), -1, np.int64)    # -1 encodes "never written"
    pver = np.zeros((S, K), np.int64)      # pre-last-write snapshot
    pval = np.full((S, K), -1, np.int64)   # (stale-read injection)
    nphase = np.zeros(S, np.int64)         # 0..3 nemesis phase
    ncyci = np.zeros(S, np.int64)          # completed fault cycles
    win_active = np.zeros(S, bool)
    win_p = np.zeros(S, np.int64)
    win_kind = np.full(S, -1, np.int64)    # open window's fault index
    applied = [[] for _ in range(S)]       # set workload: sorted adds
    snaps = [[] for _ in range(S)]         # set workload: read snaps

    e_time, e_tc, e_fc, e_proc, e_key = [], [], [], [], []
    e_pk, e_va, e_vb, e_vc, e_act = [], [], [], [], []
    steps = 0

    # shared constant rows (append-only; never written after creation)
    ALL = np.ones(S, bool)
    ZERO = np.zeros(S, np.int64)
    NEG1 = np.full(S, -1, np.int64)
    K_CMP = np.full(S, KIND_COMPLETE, np.int64)

    # op 0 invoke rows are emitted upfront (pure draws); the heap is
    # seeded with each lane's FIRST completion
    startE = d["start"] * STRIDE + np.arange(L)
    latE = CL[_CLAT]
    for j0 in range(L):
        e_time.append(startE[:, j0])
        e_tc.append(ZERO)
        e_fc.append(CL[_CF][:, j0, 0])
        e_proc.append(np.full(S, j0, np.int64))
        e_key.append(np.full(S, key_of_lane[j0], np.int64))
        e_pk.append(CL[_CPKI][:, j0, 0])
        e_va.append(CL[_CVAI][:, j0, 0])
        e_vb.append(CL[_CVBI][:, j0, 0])
        e_vc.append(NEG1)
        e_act.append(ALL)
        heap.push(startE[:, j0] + latE[:, j0, 0], j0, KIND_COMPLETE)
    if has_nem:
        # explicit empty schedules leave those seeds fault-free
        heap.push(nwaitE[:, 0] + NL, NL, KIND_NEM, n_cycles > 0)

    while True:
        t, kind, lane, act = heap.pop_min()
        if not act.any():
            break
        steps += 1
        if has_nem:
            m_cmp = act & (kind == KIND_COMPLETE)
            m_nem = act & ~m_cmp
            # client-lane index for gathers; nemesis/inactive rows
            # alias lane 0 and are masked out or overwritten below
            j = np.where(m_cmp, lane, 0)
        else:
            m_cmp = act
            j = np.where(act, lane, 0)
        oi = opi[AR, j]
        g = CL[:, AR, j, oi]            # ONE slab: all per-op draws
        f = g[_CF]
        ret = retire[AR, j]
        row_tc = np.zeros(S, np.int64)
        row_fc = f
        row_proc = j + ret * L
        row_key = key_of_lane[j]
        row_pk = np.zeros(S, np.int64)
        row_va = np.full(S, -1, np.int64)
        row_vb = np.full(S, -1, np.int64)
        row_vc = NEG1
        row_act = act

        # -- completions: timeout infos vs real outcomes --------------
        if has_nem:
            m_to = m_cmp & win_active & (g[_CTMO] < win_p)
            m_ok = m_cmp & ~m_to
            if m_to.any():
                row_tc[m_to] = TC_INFO
                row_pk[m_to] = g[_CPKI][m_to]
                row_va[m_to] = g[_CVAI][m_to]
                row_vb[m_to] = g[_CVBI][m_to]
                retire[AR[m_to], j[m_to]] += 1
                ret = ret + m_to  # later ops (incl. this step's
                # eagerly-emitted next invoke) use the retired proc
        else:
            m_ok = m_cmp

        if is_register:
            m_r = m_ok & (f == FC_READ)
            m_w = m_ok & (f == FC_WRITE)
            m_c = m_ok & (f == FC_CAS)
            if m_r.any():
                sr, kr = AR[m_r], row_key[m_r]
                rv, rl = ver[sr, kr], val[sr, kr]
                if inject_stale:
                    stale_m = g[_CSTALE][m_r] == 1
                    if has_nem:
                        stale_m &= (win_active[m_r]
                                    & (win_kind[m_r] == part_idx))
                    rv = np.where(stale_m, pver[sr, kr], rv)
                    rl = np.where(stale_m, pval[sr, kr], rl)
                row_tc[m_r] = TC_OK
                row_pk[m_r] = PK_REG_RD_OK
                row_va[m_r] = rv
                row_vb[m_r] = rl
            if m_w.any():
                sw, kw = AR[m_w], row_key[m_w]
                wv = g[_CWV][m_w]
                pver[sw, kw] = ver[sw, kw]
                pval[sw, kw] = val[sw, kw]
                nv = ver[sw, kw] + 1
                ver[sw, kw] = nv
                val[sw, kw] = wv
                row_tc[m_w] = TC_OK
                row_pk[m_w] = PK_REG_WR_OK
                row_va[m_w] = nv
                row_vb[m_w] = wv
            if m_c.any():
                sc, kc = AR[m_c], row_key[m_c]
                co, cn = g[_CCO][m_c], g[_CCN][m_c]
                okc = val[sc, kc] == co
                scw, kcw = sc[okc], kc[okc]
                pver[scw, kcw] = ver[scw, kcw]
                pval[scw, kcw] = val[scw, kcw]
                nv2 = ver[scw, kcw] + 1
                ver[scw, kcw] = nv2
                val[scw, kcw] = cn[okc]
                row_tc[m_c] = np.where(okc, TC_OK, TC_FAIL)
                row_pk[m_c] = np.where(okc, PK_REG_CAS_OK,
                                       PK_REG_CAS_FAIL)
                va_c = co.copy()
                va_c[okc] = nv2
                row_va[m_c] = va_c
                row_vb[m_c] = np.where(okc, co, cn)
                row_vc = row_vc.copy()
                row_vc[m_c] = np.where(okc, cn, -1)
        else:
            m_a = m_ok & (f == FC_ADD)
            m_s = m_ok & (f == FC_SRD)
            if m_a.any():
                av = g[_CVAI]
                row_tc[m_a] = TC_OK
                row_pk[m_a] = PK_SET_ADD
                row_va[m_a] = av[m_a]
                for s in np.flatnonzero(m_a).tolist():
                    insort(applied[s], int(av[s]))
            if m_s.any():
                row_tc[m_s] = TC_OK
                row_pk[m_s] = PK_SET_RD_OK
                for s in np.flatnonzero(m_s).tolist():
                    snaps[s].append(list(applied[s]))
                    row_va[s] = len(snaps[s]) - 1

        # -- advance lanes; eagerly emit the NEXT op's invoke row -----
        ncur = oi + 1
        m_adv = m_cmp & (ncur < O)
        opi[AR[m_adv], j[m_adv]] = ncur[m_adv]
        oi2 = oi + m_adv                 # clamped: non-adv rows inert
        g2 = CL[_INV_PLANES, AR, j, oi2]
        inv_t = t + g[_CGAP]
        inv_proc = j + ret * L
        nxt_push = m_adv
        nxt_t = inv_t + g2[_ILAT]
        nxt_kind = K_CMP
        push_lane = j

        # -- nemesis lane: 4-phase fault/heal windows -----------------
        if has_nem:
            done_lanes += m_cmp & (ncur >= O)
        if has_nem and m_nem.any():
            ph = nphase
            ci = np.minimum(ncyci, ncyc_cap - 1)
            nk = nkind[AR, ci]
            m_n0 = m_nem & (ph == 0)
            m_die = m_n0 & (done_lanes >= L)  # clients done: no window
            m_emit = m_nem & ~m_die
            row_act = act.copy()
            row_act[m_die] = False
            m_sinv = m_n0 & ~m_die
            m_sok = m_nem & (ph == 1)
            m_einv = m_nem & (ph == 2)
            m_eok = m_nem & (ph == 3)
            is_stop = (m_einv | m_eok).astype(np.int64)
            nf = nfb + 2 * nk + is_stop
            row_fc = np.where(m_emit, nf, row_fc)
            row_tc[m_sok | m_eok] = TC_INFO  # invokes keep default 0
            row_proc[m_emit] = -1
            row_key[m_emit] = -1
            row_pk[m_emit] = PK_NEM
            row_va[m_emit] = nk[m_emit]
            row_vb[m_emit] = is_stop[m_emit]
            win_active = (win_active | m_sok) & ~m_eok
            win_p[m_sok] = p_by_kind[nk[m_sok]]
            win_kind[m_sok] = nk[m_sok]
            win_kind[m_eok] = -1
            ncyci = ncyci + m_eok
            nphase = np.where(m_emit, (ph + 1) % 4, nphase)
            n_push = m_emit & ~(m_eok & (ncyci >= n_cycles))
            ci2 = np.minimum(ncyci, ncyc_cap - 1)
            ntm = np.where(m_sinv | m_einv, t + nem_apply,
                           np.where(m_sok, t + nholdE[AR, ci],
                                    t + nwaitE[AR, ci2]))
            nxt_push = nxt_push | n_push
            nxt_t = np.where(n_push, ntm, nxt_t)
            nxt_kind = np.where(n_push, KIND_NEM, nxt_kind)
            push_lane = np.where(m_nem, NL, push_lane)

        heap.push_slots(nxt_t, push_lane, nxt_kind, nxt_push)

        # completion (or nemesis) row at t ...
        e_time.append(t)
        e_tc.append(row_tc)
        e_fc.append(row_fc)
        e_proc.append(row_proc)
        e_key.append(row_key)
        e_pk.append(row_pk)
        e_va.append(row_va)
        e_vb.append(row_vb)
        e_vc.append(row_vc)
        e_act.append(row_act)
        # ... and the next op's invoke row at its later timestamp (the
        # finish-phase per-seed argsort restores global time order)
        e_time.append(inv_t)
        e_tc.append(ZERO)
        e_fc.append(g2[_IF])
        e_proc.append(inv_proc)
        e_key.append(row_key)
        e_pk.append(g2[_IPKI])
        e_va.append(g2[_IVAI])
        e_vb.append(g2[_IVBI])
        e_vc.append(NEG1)
        e_act.append(m_adv)

    histories, events = _finish(config, seeds, e_time, e_tc, e_fc,
                                e_proc, e_key, e_pk, e_va, e_vb, e_vc,
                                e_act, snaps)
    return {"histories": histories, "epoch": GEN_EPOCH_V2,
            "seeds": seeds, "events": events, "steps": steps,
            "compactions": heap.compactions}


def _nem_start_value(config, kind):
    """Start-op :info value for a fault kind, with the guided mutation
    knobs (partition shape, latency delta) folded in."""
    if kind == "partition" and config.partition_shape:
        return config.partition_shape
    if kind == "latency" and config.latency_ms is not None:
        return {"delta-ms": config.latency_ms,
                "jitter-ms": round(config.latency_ms / 5.0, 3)}
    return NEM_START_VALUE.get(kind, "all")


def _finish(config, seeds, e_time, e_tc, e_fc, e_proc, e_key, e_pk,
            e_va, e_vb, e_vc, e_act, snaps):
    """Gather each seed's rows (sorted by its unique event times) into
    an OpColumns-backed History."""
    S = len(seeds)
    f_table = config.f_table()
    key_table = ([config.key_offset + i for i in range(config.keys)]
                 if config.workload == "register" else [])
    proc_table = ["nemesis"]
    nem_start = [_nem_start_value(config, kd)
                 for kd in config.nemeses] or [None]
    if not e_tc:
        empty = np.zeros(0, np.int64)
        return [History.from_columns(OpColumns(
            empty.astype(np.int8), empty.astype(np.int32), empty,
            empty, empty, empty, [], {}, {}, f_table, key_table,
            proc_table)) for _ in range(S)], 0
    TM, TC = np.stack(e_time), np.stack(e_tc)
    FC, PR, KID = np.stack(e_fc), np.stack(e_proc), np.stack(e_key)
    PK, VA, VB = np.stack(e_pk), np.stack(e_va), np.stack(e_vb)
    VC, ACT = np.stack(e_vc), np.stack(e_act)
    events = int(ACT.sum())
    out = []
    for s in range(S):
        rows = np.flatnonzero(ACT[:, s])
        tm = TM[rows, s]
        rows = rows[np.argsort(tm)]  # unique times: total order
        n = rows.size
        tc = TC[rows, s]
        pk_l = PK[rows, s].tolist()
        va_l = VA[rows, s].tolist()
        vb_l = VB[rows, s].tolist()
        vc_l = VC[rows, s].tolist()
        tc_l = tc.tolist()
        snap = snaps[s]
        values = [None] * n
        extras: dict = {}
        for i in range(n):
            p = pk_l[i]
            if p == PK_REG_RD_INV:
                values[i] = [None, None]
            elif p == PK_REG_RD_OK:
                v = vb_l[i]
                values[i] = [va_l[i], None if v < 0 else v]
            elif p == PK_REG_WR_INV:
                values[i] = [None, va_l[i]]
            elif p == PK_REG_WR_OK:
                values[i] = [va_l[i], vb_l[i]]
            elif p == PK_REG_CAS_INV:
                values[i] = [None, [va_l[i], vb_l[i]]]
            elif p == PK_REG_CAS_OK:
                values[i] = [va_l[i], [vb_l[i], vc_l[i]]]
            elif p == PK_REG_CAS_FAIL:
                values[i] = [None, [va_l[i], vb_l[i]]]
                extras[i] = {"error": "did-not-succeed"}
            elif p == PK_SET_ADD:
                values[i] = va_l[i]
            elif p == PK_SET_RD_OK:
                values[i] = snap[va_l[i]]
            elif p == PK_NEM:
                values[i] = None if vb_l[i] else nem_start[va_l[i]]
            # PK_SET_RD_INV: value stays None
            if tc_l[i] == TC_INFO and p != PK_NEM:
                extras[i] = {"error": "timeout"}
        cols = OpColumns(
            tc.astype(np.int8), FC[rows, s].astype(np.int32),
            PR[rows, s], KID[rows, s], TM[rows, s] // STRIDE,
            np.arange(n, dtype=np.int64), values, extras, {},
            f_table, key_table, proc_table)
        out.append(History.from_columns(cols))
    return out, events


# -- MVCC consistency-surface generation (per-seed sweep) --------------------
#
# The four MVCC workloads share the lockstep path's determinism
# contract — same ``_draws`` blocks, same lane-timeline arithmetic
# (inv[i+1] = cmp[i] + gap, cmp[i] = inv[i] + lat, times carry the lane
# residue), same nemesis phase machine (including the death check when
# every client lane finished) and in-window timeout rule — but their
# per-op state machines carry real MVCC state (version chains, a lease
# table, the revision counter + compaction watermark), so they advance
# one seed at a time in completion-time order instead of S-wide.
#
# Injection hooks follow the ``inject_stale_reads`` template: the
# injected anomaly fires only when it is DEFINITE for the matching
# checker (checkers/mvcc.py) — gated to open partition windows when a
# fault schedule exists, unconditional otherwise — and every knob
# leaves the non-injected history untouched.


class _MvccMachine:
    """Per-seed workload state machine: ``invoke`` returns the pure
    draw-determined invoke row, ``complete`` applies the op, ``post``
    may rewrite rows once the final state (e.g. the last compaction
    watermark) is known."""

    def __init__(self, config: BatchConfig, inv_i, cmp_i):
        self.config = config
        self.inv_i = inv_i
        self.cmp_i = cmp_i
        self.has_nem = bool(config.nemeses)

    def _gate(self, part_win) -> bool:
        """Injections model partitioned-replica bugs: inside an open
        partition window when faults exist, unconditional otherwise."""
        return part_win is not None if self.has_nem else True

    def invoke(self, j, i, key_d, wv):
        raise NotImplementedError

    def timeout(self, j, i):
        pass

    def complete(self, j, i, ti, key_d, wv, part_win):
        raise NotImplementedError

    def post(self, rows, windows, part_idx):
        pass


class _StaleRegMachine(_MvccMachine):
    """register-stale: reader lanes serve the current (or injected
    frozen-snapshot) chain state, writer lanes bump per-key versions.
    Payloads are ``[key, version, value]``."""

    def __init__(self, config, inv_i, cmp_i):
        super().__init__(config, inv_i, cmp_i)
        self.readers = config.readers
        K = config.keys
        self.ver = [0] * K
        self.val = [None] * K
        self.frozen = None
        self.fwin = None
        self.inject = config.inject_stale_snapshot

    def invoke(self, j, i, key_d, wv):
        if j < self.readers:
            return 0, key_d, [key_d, None, None]
        return 1, key_d, [key_d, None, int(wv)]

    def complete(self, j, i, ti, key_d, wv, part_win):
        if j < self.readers:
            v, x = self.ver[key_d], self.val[key_d]
            # lane 0 is the stale replica: it pins a whole snapshot
            # (per freeze point), so its reads stay session-monotone
            # and never read the future — only ever *stale*
            if self.inject and j == 0:
                if not self.has_nem:
                    if self.frozen is None and i >= 2:
                        self.frozen = (list(self.ver), list(self.val))
                    if self.frozen is not None:
                        v = self.frozen[0][key_d]
                        x = self.frozen[1][key_d]
                elif part_win is not None:
                    if self.fwin is not part_win:
                        self.fwin = part_win
                        self.frozen = (list(self.ver), list(self.val))
                    v = self.frozen[0][key_d]
                    x = self.frozen[1][key_d]
            return TC_OK, 0, key_d, [key_d, v, x], None
        self.ver[key_d] += 1
        self.val[key_d] = wv
        return TC_OK, 1, key_d, [key_d, self.ver[key_d], wv], None


class _RangesMachine(_MvccMachine):
    """ranges: reader lanes snapshot the whole version vector
    atomically; writers bump per-key versions. The torn-range
    injection serves key 0 at version 1 only when another key's
    current chain head was invoked strictly after key 0's version-2
    ack — exactly the checker's definite-torn condition."""

    def __init__(self, config, inv_i, cmp_i):
        super().__init__(config, inv_i, cmp_i)
        self.readers = config.readers
        K = config.keys
        self.ver = [0] * K
        self.val = [None] * K
        self.head_inv = [None] * K      # emitted-ns invoke of chain head
        self.u2 = None                  # emitted-ns ok of key0 version 2
        self.inject = config.inject_torn_range

    def invoke(self, j, i, key_d, wv):
        if j < self.readers:
            return 0, -1, None
        return 1, key_d, [key_d, None, int(wv)]

    def complete(self, j, i, ti, key_d, wv, part_win):
        if j < self.readers:
            vec = [[k, self.ver[k]] for k in range(len(self.ver))]
            if (self.inject and self._gate(part_win)
                    and self.u2 is not None):
                m = max((x for k, x in enumerate(self.head_inv)
                         if k and x is not None), default=None)
                if m is not None and m > self.u2:
                    vec[0] = [0, 1]
            return TC_OK, 0, -1, vec, None
        self.ver[key_d] += 1
        self.val[key_d] = wv
        self.head_inv[key_d] = int(self.inv_i[j, i]) // STRIDE
        if key_d == 0 and self.ver[0] == 2:
            self.u2 = ti // STRIDE
        return TC_OK, 1, key_d, [key_d, self.ver[key_d], wv], None


class _LeaseMachine(_MvccMachine):
    """lock-lease: every lane alternates acquire/release under a
    never-renewed lease. The server grants only when no unexpired,
    unreleased holder remains (lease countdown from the grant, lock
    freed at release *completion*), which keeps certain-hold windows
    disjoint by construction; the double-grant injection grants while
    the holder's certain hold (release invoke / TTL clip, both known
    from the fixed lane timelines) is still open."""

    def __init__(self, config, inv_i, cmp_i):
        super().__init__(config, inv_i, cmp_i)
        ttl_ns = int(config.lease_ttl_ms * 1e6)
        self.ttl_i = ttl_ns * STRIDE
        self.ttl_e = ttl_ns
        self.holders: list = []
        self.held = [False] * config.lanes
        self.inject = config.inject_double_grant

    def invoke(self, j, i, key_d, wv):
        return (0 if i % 2 == 0 else 1), -1, None

    def timeout(self, j, i):
        if i % 2 == 1:
            # a timed-out release: the client stops claiming the lock
            # but the server-side holder persists until lease expiry
            self.held[j] = False

    def complete(self, j, i, ti, key_d, wv, part_win):
        if i % 2 == 0:                                # acquire
            self.holders = [h for h in self.holders
                            if ti < h["expiry"]]
            grant = not self.holders
            if not grant and self.inject and self._gate(part_win):
                h = self.holders[0]
                end_e = h["acq_inv_e"] + self.ttl_e
                if h["rel_inv_e"] is not None:
                    end_e = min(end_e, h["rel_inv_e"])
                grant = ti // STRIDE < end_e          # definite overlap
            if grant:
                O = self.inv_i.shape[1]
                self.holders.append({
                    "lane": j, "expiry": ti + self.ttl_i,
                    "acq_inv_e": int(self.inv_i[j, i]) // STRIDE,
                    "rel_inv_e": (int(self.inv_i[j, i + 1]) // STRIDE
                                  if i + 1 < O else None)})
                self.held[j] = True
                return TC_OK, 0, -1, None, None
            return TC_FAIL, 0, -1, None, "held"
        if self.held[j]:                              # release
            self.held[j] = False
            self.holders = [h for h in self.holders if h["lane"] != j]
            return TC_OK, 1, -1, None, None
        return TC_FAIL, 1, -1, None, "not-held"


class _CompactWatchMachine(_MvccMachine):
    """compact-watch: lane 0 compacts ``compact_keep`` behind the
    head, the next lanes write (acking ``[revision, value]``), the
    rest watch — recording an explicit gap whenever their cursor fell
    under the watermark. The swallow injection is a post-pass: once
    the FINAL watermark is known, it drops delivered revisions above
    it (keeping each watch's max as the span anchor), which the
    checker can never attribute."""

    def __init__(self, config, inv_i, cmp_i):
        super().__init__(config, inv_i, cmp_i)
        L = config.lanes
        self.W = max(1, (L - 1) // 2)
        self.keep = config.compact_keep
        self.rev = 0
        self.wm = 0
        self.wlog: list = []            # wlog[r-1] = value of rev r
        self.cursor = [0] * L
        self.inject = config.inject_compaction_swallow

    def role(self, j):
        if j == 0:
            return "compact"
        return "write" if j <= self.W else "watch"

    def invoke(self, j, i, key_d, wv):
        r = self.role(j)
        if r == "write":
            return 0, -1, int(wv)
        return (1, -1, None) if r == "watch" else (2, -1, None)

    def complete(self, j, i, ti, key_d, wv, part_win):
        r = self.role(j)
        if r == "write":
            self.rev += 1
            self.wlog.append(wv)
            return TC_OK, 0, -1, [self.rev, wv], None
        if r == "compact":
            target = self.rev - self.keep
            if target < 1:
                return TC_OK, 2, -1, 0, None
            if target <= self.wm:
                return TC_FAIL, 2, -1, None, "compacted"
            self.wm = target
            return TC_OK, 2, -1, target, None
        frm = self.cursor[j]                          # watch
        gaps, lo = [], frm
        if frm < self.wm:
            gaps, lo = [[frm, self.wm]], self.wm
        res = {"from": frm,
               "revs": list(range(lo + 1, self.rev + 1)),
               "gaps": gaps, "log": self.wlog[lo:self.rev]}
        self.cursor[j] = self.rev
        return TC_OK, 1, -1, res, None

    def post(self, rows, windows, part_idx):
        if not self.inject:
            return
        final_wm = self.wm
        for n, (ti, tc, fc, proc, key, val, extra) in enumerate(rows):
            if tc != TC_OK or fc != 1 or not isinstance(val, dict):
                continue
            if self.has_nem and not any(
                    w_lo < ti < w_hi and ki == part_idx
                    for w_lo, w_hi, ki in windows):
                continue
            revs = val["revs"]
            if not revs:
                continue
            mx = revs[-1]
            kept = [(r, v) for r, v in zip(revs, val["log"])
                    if not (final_wm < r < mx)]
            if len(kept) == len(revs):
                continue
            rows[n] = (ti, tc, fc, proc, key,
                       {"from": val["from"],
                        "revs": [r for r, _ in kept],
                        "gaps": val["gaps"],
                        "log": [v for _, v in kept]}, extra)


_MVCC_MACHINES = {
    "register-stale": _StaleRegMachine,
    "ranges": _RangesMachine,
    "lock-lease": _LeaseMachine,
    "compact-watch": _CompactWatchMachine,
}


def _mvcc_schedule(config, d, si, scheds, max_fin):
    """One seed's nemesis cycles as absolute internal times: emitted
    rows plus open fault windows, replicating the lockstep phase
    machine exactly — including the schedule-replay clamp arithmetic
    of ``_schedule_arrays`` and the death check (a cycle whose start
    falls after every client lane finished never fires)."""
    NL = config.lanes
    apply_i = NEM_APPLY_NS * STRIDE
    if scheds is not None:
        seq, prev_end = [], 0
        for s_, kd, h in scheds[si]:
            w = max(1, int(s_) - prev_end)
            hh = max(1, int(h))
            st = prev_end + w
            seq.append((st, config.nemeses.index(kd), hh))
            prev_end = st + 2 * NEM_APPLY_NS + hh
    else:
        seq, tcur = [], 0
        for c in range(NEM_CYCLES):
            st = tcur + int(d["nwait"][si, c])
            h = int(d["nhold"][si, c])
            seq.append((st, int(d["nkind"][si, c]), h))
            tcur = st + 2 * NEM_APPLY_NS + h
    windows, rows = [], []
    nfb = config.nem_f_base()
    for st, ki, h in seq:
        t0 = st * STRIDE + NL
        if t0 > max_fin:
            break
        t1 = t0 + apply_i
        t2 = t1 + h * STRIDE
        t3 = t2 + apply_i
        windows.append((t1, t3, ki))
        sv = _nem_start_value(config, config.nemeses[ki])
        rows.append((t0, TC_INVOKE, nfb + 2 * ki, sv))
        rows.append((t1, TC_INFO, nfb + 2 * ki, sv))
        rows.append((t2, TC_INVOKE, nfb + 2 * ki + 1, None))
        rows.append((t3, TC_INFO, nfb + 2 * ki + 1, None))
    return windows, rows


def _mvcc_seed(config, d, si, scheds):
    """One seed's full history as sorted row tuples
    ``(t_internal, tc, fc, proc, key, value, extra)``."""
    L, O, K = config.lanes, config.ops_per_lane, config.keys
    part_idx = (config.nemeses.index("partition")
                if "partition" in config.nemeses else -2)
    lat = d["lat"][si].astype(np.int64)
    gap = d["gap"][si].astype(np.int64)
    inv = np.empty((L, O), np.int64)
    cmp_ = np.empty((L, O), np.int64)
    t = d["start"][si].astype(np.int64)
    for i in range(O):
        inv[:, i] = t
        cmp_[:, i] = t + lat[:, i]
        t = cmp_[:, i] + gap[:, i]
    res = np.arange(L, dtype=np.int64)[:, None]
    inv_i = inv * STRIDE + res
    cmp_i = cmp_ * STRIDE + res
    windows, nrows = [], []
    if config.nemeses:
        windows, nrows = _mvcc_schedule(config, d, si, scheds,
                                        int(cmp_i[:, -1].max()))
    p9 = {ki: int(_p_timeout(config, kd) * 1e9)
          for ki, kd in enumerate(config.nemeses)}
    tmo9 = (d["tmo"][si] * 1e9).astype(np.int64)
    kdrw = d["cnew"][si] % K        # per-op key draw
    wval = d["wval"][si]

    def win_at(ti):
        for w in windows:
            if w[0] < ti < w[1]:
                return w
        return None

    machine = _MVCC_MACHINES[config.workload](config, inv_i, cmp_i)
    retire = [0] * L
    rows = []
    for j in range(L):
        fc, key, val = machine.invoke(j, 0, int(kdrw[j, 0]),
                                      wval[j, 0])
        rows.append((int(inv_i[j, 0]), TC_INVOKE, fc, j, key, val,
                     None))
    steps = 0
    for flat in np.argsort(cmp_i, axis=None).tolist():
        j, i = flat // O, flat % O
        ti = int(cmp_i[j, i])
        steps += 1
        key_d = int(kdrw[j, i])
        proc = j + retire[j] * L
        w = win_at(ti)
        if w is not None and int(tmo9[j, i]) < p9[w[2]]:
            fc, key, val = machine.invoke(j, i, key_d, wval[j, i])
            rows.append((ti, TC_INFO, fc, proc, key, val,
                         {"error": "timeout"}))
            retire[j] += 1
            machine.timeout(j, i)
        else:
            part_win = w if (w is not None and w[2] == part_idx) \
                else None
            tc, fc, key, val, err = machine.complete(
                j, i, ti, key_d, int(wval[j, i]), part_win)
            rows.append((ti, tc, fc, proc, key, val,
                         {"error": err} if err else None))
        if i + 1 < O:
            fc, key, val = machine.invoke(j, i + 1,
                                          int(kdrw[j, i + 1]),
                                          wval[j, i + 1])
            rows.append((int(inv_i[j, i + 1]), TC_INVOKE, fc,
                         j + retire[j] * L, key, val, None))
    machine.post(rows, windows, part_idx)
    rows.extend((tn, tc, fc, -1, -1, val, None)
                for tn, tc, fc, val in nrows)
    rows.sort(key=lambda r: r[0])
    return rows, steps


def _mvcc_finish(config, rows) -> History:
    n = len(rows)
    key_table = (list(range(config.keys))
                 if config.workload in ("register-stale", "ranges")
                 else [])
    cols = OpColumns(
        np.array([r[1] for r in rows], np.int8),
        np.array([r[2] for r in rows], np.int32),
        np.array([r[3] for r in rows], np.int64),
        np.array([r[4] for r in rows], np.int64),
        np.array([r[0] // STRIDE for r in rows], np.int64),
        np.arange(n, dtype=np.int64),
        [r[5] for r in rows],
        {i: r[6] for i, r in enumerate(rows) if r[6]},
        {}, config.f_table(), key_table, ["nemesis"])
    return History.from_columns(cols)


def _generate_mvcc(config: BatchConfig, seeds, nem_schedules=None) \
        -> dict:
    """The MVCC workloads' generate(): per-seed sweeps over the shared
    draw blocks (see the section comment above)."""
    S = len(seeds)
    if nem_schedules is not None:
        if len(nem_schedules) != S:
            raise ValueError("nem_schedules must align with seeds "
                             f"({len(nem_schedules)} != {S})")
        scheds = [_norm_schedule(sc, config.nemeses) or ()
                  for sc in nem_schedules]
    elif config.nem_schedule is not None:
        scheds = [config.nem_schedule] * S
    else:
        scheds = None
    d = _draws(config, seeds)
    histories, steps, events = [], 0, 0
    for si in range(S):
        rows, n = _mvcc_seed(config, d, si, scheds)
        steps += n
        events += len(rows)
        histories.append(_mvcc_finish(config, rows))
    return {"histories": histories, "epoch": GEN_EPOCH_V2,
            "seeds": seeds, "events": events, "steps": steps,
            "compactions": 0}


def generate_for_opts(opts: dict, seeds, device=None) -> dict:
    """Campaign/bench entry: opts→config mapping plus generate,
    routed by the declared generator epoch (``gen_epoch`` opt:
    epoch-v3 runs the device engine on ``device``, ``cuda`` unless
    named; anything else the lockstep numpy engine on the host)."""
    config = BatchConfig.from_opts(opts)
    if opts.get("gen_epoch") == "epoch-v3":
        from .engine_v3 import generate_jax
        return generate_jax(config, seeds, device=device)
    return generate(config, seeds)
