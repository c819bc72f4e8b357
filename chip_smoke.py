"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout
(one nvcc per source, in parallel), holds each against its plain
PyTorch version on the card, drives the port's paths and shows that
each launched its kernel: single-key linearizability checking of a
27,000-entry register history through ``TPULinearizableChecker`` (kernel
wgl_wave), the watch checker on five watchers' logs of 12,000 values
each (kernel indel_bits), the capacity ladder (kernel wgl_rung for
rungs of one-word windows up to 128, PyTorch ops on the card above,
at real size on a 26,992-entry history whose wave-kernel search
overflows, held against the same rungs as PyTorch ops replayed from
CUDA graphs and issued one by one, on two info-op keys the size of
the benchmark's 4n cell's faulted keys and on three keys of its 1-key
cell at the kernel's limits of info classes and count words, one
accepted and two refuted, dict and frozen frontier bytes, the rung
kernel's tables built on the card by kernel wgl_frames identical to
the host's), the spill BFS and
``check_prefix``, and the keyed register check: the register
workload's checker, ``Independent(Compose({linear, session}))``, on
32 keys x 2,000 ops (wgl_wave's batched launch, once on
the card's one lane and once split over two lanes of it, and the
batched ladder for the faulted keys). wgl_wave is held on fuzz at
every window width, unversioned concurrent writes, a 64-key batch, the
register and ladder-at-real-size histories and the keyed launch, and
its profiling instantiation prints the SM cycles a wave spends in each
phase. Last comes Elle: the boolean-closure engine (``ops/closure.py``,
bf16 ``torch.bmm`` squarings) at six 2,048-node planes, held against
strongly connected components and BFS rows and split over two lanes of
the card, then ``ListAppendChecker`` and ``RWRegisterChecker`` on 3,731
committed txns (clean and with an anomaly planted), the card against
the host, and the closure's crossover. Last the simulator
(``simbatch/``): the register drain kernel drain_register held against
its plain version at the reference bench's generation shape (16 seeds x
7,520 completions), at 256 seeds, on a fuzz, on 64 random keys and on
edge inputs, in two blockings, both plane layouts and on unaligned
planes; a link of its chain measured on one chain; timed through its
wrapper and alone at the first two, and with every row timed out; the
epoch-v2 and epoch-v3 golden pins reproduced with generation on the
card; epoch-v3 timed with its stages; the threefry draws held against
the CPU's; simulated histories checked (a single key through
wgl_wave, four keys through its batched launch, stale reads caught);
and the fused gen->check pipeline against its sequential twin. Last
the checker service (``runner/checker_service.py``): a campaign of 20
simulated register runs, each checked by the register workload's checker
on a thread of its own through one service on a unix socket, held
against the same runs checked in-process; the same packs over two lanes
of the card, placed and sharded; wgl_wave at a tick's shape and the
sharded batched rung, timed. Last the ``test`` command on the
simulated cluster (``runner_phase``): the BASELINE register
configuration through ``cli.main`` (every key through wgl_wave's
batched launch, each verdict equal to the native DFS), stale reads
caught on the native DFS's keys, the watch workload through
indel_bits (its dict equal to the plain versions' on the CPU) and
list-append through the closure on the card (held against scipy's
strongly connected components). Then streaming and the set, lock and
MVCC workloads (``stream_phase``): the BASELINE command with
``--stream``, held against the runner phase's post-hoc run (history
bytes, the workload's dict) with every key wgl_wave took checked from a
streamed pack; the reference's set cell with ``--stream`` and epoch-v3
set histories generated on the card; lock decided by wgl_wave through
the Mutex adapter; the MVCC workloads clean and each with its injected
bug caught. Last the campaign runner
(``campaign_phase``): the reference's campaign-amortization cell serial,
over a pool of spawned workers and over the pool with one checker
service on the card (verdicts held against in-process re-checks, the
service's ledger balanced, the CUDA contexts each arm opens sampled
from nvidia-smi), the same runs over two worker-agent processes on
loopback TCP (the cross-host ledger), an epoch-v3 campaign generated on
the card (histories held against ``generate_for_opts``), and guided
search, shrink and ``replay`` on the card (held against the same search
on the CPU). Last the live side (``live_phase``): the register workload
at BASELINE's widths over the etcd v3 JSON wire against the port's
gateway, then over native gRPC, then on the local control plane's
fake-etcd node under a kill nemesis and in three soak windows, every
key through wgl_wave's batched launch and held against the native DFS,
each run's dict against its stored history checked with the plain
versions on the CPU, a corrupted read refuted. Last the store's readers
(``readers_phase``) over the runner and campaign phases' stores:
``store index --rebuild`` and verify (the index's runs =
``forensics.all_runs``, the walk's rows = the index's), ``store compact
--dry-run``, ``serve`` on port 0 in a process of its own with every
page read over HTTP (each run page's verdicts and engines held against
its results.json), and the linter over the port's tree. Last the
reference's fault packages (``faults_phase``, tests/test_nemesis.py's
runs at its opts): register under kill, partition, latency, pause with
clock and member, set under admin compaction, append under kill with
bitflips, watch under kill and lock-set under clock faults, each through
``run_test`` with force_kernel on the card and again on the CPU (plain
versions): equal history bytes and dicts, every register key equal to
the native DFS, lock-set losing adds. The frame
tables (``build_tables``, held against the host packer) and the
unsharded ladder rung (the rung kernel, csrc/wgl_rung.cu, held against
its plain version, the same rungs as PyTorch ops replayed from CUDA
graphs and issued one by one) are timed at the register and
ladder-at-real-size cells.
Holds that need no card run in worker processes while the card's
sections go on: the ladder-at-real-size histories' wgl_wave plain
versions on host copies of their tables, Elle's host legs (the 500-txn
checks and the closure up to CPU_CUTOFF), and the reference sweep over
the epoch-v3 set seeds. Prints the card's name and power limit, a
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
Exits non-zero, with no result line, when CUDA is unavailable or any
phase fails. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import atexit
import contextlib
import io
import concurrent.futures
import itertools
import json
import multiprocessing
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
#: info-op keys the size of a faulted key of the benchmark's cell:
#: gen_history seeds (n_procs=10, info_rate=0.01) of 1,600 entries, R
#: 1,248 and 1,246 with 7 and 13 :info ops, info classes padded to 8 and
#: 16 (one count word). The first climbs 32 -> 128, the second 32 ->
#: 128 -> 256 -> 512, so the rung kernel runs its class candidates on
#: both and hands the second's frozen frontier to the PyTorch rungs
INFO_KEY_SEEDS, INFO_KEY_OPS = (20, 21), 1_600
#: the register_1key_10k.faulted cell's fixed faulted key 0 (13,500 ops,
#: R 10,759, I 44, info classes padded to 32 in two count words: the
#: rung kernel's C_CAP and NI_CAP), and where its impossible read goes
CELL_KEY, CELL_KEY_OPS, CELL_KEY_AT = 0, 13_500, 0.9
#: the keyed register cell (testing.keyed_register_history): 32 keys of
#: 2,000 ops, 10 processes a key (the reference's register test with
#: --ops-per-key 2000, 2n threads a key on 5 nodes). Keys 3, 11, 19 and
#: 27 complete 1 % of their ops :info (the wave kernel cannot take them;
#: 3 and 11 share a batched ladder group, 19 and 27 climb alone), key 7
#: misreports some observations
KEYED_KEYS, KEYED_OPS, KEYED_PROCS, KEYED_SEED = 32, 2_000, 10, 2026
KEYED_FAULTED, KEYED_INFO_RATE, KEYED_CORRUPTED = (3, 11, 19, 27), 0.01, (7,)
#: repetitions of the whole keyed check for its median (5 since the
#: service phase joined the script, 3 since the campaign phase did:
#: each takes ~6 s)
KEYED_RUNS = 3
#: the Elle cells. The closure at the reference bench's shape: six
#: 2,048-node planes drawn with RandomState(0) at density 2/N
#: (bench.py:619-623, "the append checker's shape at ~30 min of
#: workload"), 64 of its reach rows held against a BFS. The list-append
#: and rw-register checks at the reference's append bench size, 3,731
#: committed txns (BENCH_r02.json elle_append_device), 10 processes,
#: each with one planted anomaly in a corrupted copy; the card against
#: the host at 500 txns (the host's numpy closure of a 1,000-txn append
#: history takes over a minute on the H100's host); the closure's
#: crossover swept over N, the host leg where it serves (N <= CPU_CUTOFF)
ELLE_B, ELLE_N, ELLE_ROWS = 6, 2_048, 64
ELLE_TXNS, ELLE_PAIR_TXNS, ELLE_PROCS, ELLE_SEED = 3_731, 500, 10, 2026
ELLE_PLANTED = {"list-append": "G-single-realtime", "rw-register": "G1c"}
ELLE_SWEEP = (256, 512, 768, 1024, 2048)
#: dense bf16 tensor-core peak of the H100 SXM (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12
#: the simulator cells. The reference bench's generation shape
#: (bench.py:763-787): 16 lanes x 470 ops, N = 7,520 completions over 4
#: keys, 16 seeds; its seed-axis scaling at time_limit 1.0 (16 seeds
#: against 256, bench.py:789-802); the single-key check on a simulated
#: history of the register cell's size, 13,500 ops (6 lanes -> 1 key);
#: the fused pipeline at the generation shape over 4 seeds in
#: sub-batches of 2 (bench.py:885-930 runs 16: its check is ~30,000
#: ladder waves at 4 seeds). The drain's fuzz: 24 lanes over 12 keys,
#: partition and kill with a flat 0.3 timeout rate in open windows and
#: stale reads injected, and random planes over 64 keys (a block's keys
#: over more than one warp of lanes)
GEN_OPTS = {"workload": "register", "nodes": ["n1", "n2", "n3"],
            "concurrency": 16, "rate": 1000.0, "time_limit": 7.52}
GEN_SEEDS, GEN_SCALE_SEEDS, GEN_SCALE_LIMIT, GEN_REPS = 16, 256, 1.0, 5
SIM_SINGLE_OPTS = dict(GEN_OPTS, concurrency=6, time_limit=13.5)
FUSED_SEEDS, FUSED_SUB_BATCH = 4, 2
DRAIN_FUZZ = {"workload": "register", "lanes": 24, "keys": 12,
              "ops_per_lane": 150, "rate": 1000.0,
              "nemeses": ("partition", "kill"), "drop_prob": 0.3,
              "inject_stale_reads": True}
DRAIN_FUZZ_SEEDS, DRAIN_WIDE_KEYS = 64, 64
#: the drain's edge inputs (random planes): (label, seed, (N, S, K),
#: random_drain_inputs' options). One chain a seed, more keys than a
#: block has lanes, 90 % of the rows on one key, fewer rows than a tile,
#: an odd seed count (rows that start mid-word in the flags' planes)
DRAIN_EDGES = (("K = 1", 2, (2_000, 16, 1), {}),
               ("K = 400", 3, (3_000, 32, 400), {}),
               ("90 % of the rows on key 0", 4, (3_000, 16, 4),
                {"skew": 0.9}),
               ("N = 100 < T", 5, (100, 16, 4), {}),
               ("S = 33", 6, (1_000, 33, 4), {}))
#: the drain's variants timed at the two generation shapes: (most lanes
#: a block (None: the default), the planes in the other layout)
DRAIN_TIMED = ((None, False), (None, True), (4, False), (32, False))
#: launches in a row a drain timing takes (``back_to_back_ms``), each on
#: the next of DRAIN_COPIES copies of its inputs and outputs: 16 copies
#: of the generation shape's ~5 MB are more than the card's 50 MB of L2,
#: so a launch reads its planes from HBM, as the bound counts them
DRAIN_B2B, DRAIN_COPIES = 48, 16
#: the committed pins (tests/test_simbatch.py:177-198 and
#: tests/test_simbatch_jax.py:30-37): seed 0's sha and the sha of the 16
#: seeds' shas joined, at the bench's dry shape
PIN_OPTS = {"workload": "register", "nodes": ["n1", "n2", "n3"],
            "concurrency": 8, "rate": 200.0, "time_limit": 2.0}
PINS = {"epoch-v2": (
    "f994af9bf3d2cb2728c4993bd44a13db92cbc70bc8f42f46bb33291d5e88da69",
    "89d9966eabeb0b1fa01943ac93921db260b503c3ec48e56ec830891674f21d69"),
    "epoch-v3": (
    "c82fabd17a19636bd2aa710d219ff7da169d8919b4528566d55fd41e63853fb8",
    "d93dbf74fe3c0a4180282278c2c223293b7779e33edbdd4bb5a2798c43f9693c")}
#: drain_register.cu's body a (step, seed), counted from its code: seven
#: plane loads, two state loads, the compares and selects of the five
#: outputs, four state stores when it writes, five output stores
DRAIN_OPS_PER_STEP = 30
#: the yardstick of a machine kept in shared memory, printed beside the
#: recount: N steps, each adding a shared-memory store and load of the
#: machine (~30 SM cycles)
DRAIN_CHAIN_CYCLES = 30
#: a link of the recounted chain (a write or CAS that is not timed out,
#: of one (seed, key)): in drain_register.cu's step the next val waits on
#: DRAIN_LINK_OPS dependent operations, the compare of val with the CAS's
#: old value, its and with the CAS bit, the or with the write bit and the
#: select of the new value. A link's time on the card is measured in
#: each run (``drain_link``): one seed, one key, DRAIN_LINK_ROWS rows,
#: each a write or a CAS and none timed out, so that every row is a link
#: of the one chain, the kernel's time over its links
DRAIN_LINK_OPS, DRAIN_LINK_ROWS = 4, 65_536
#: the checker service's campaign, after the reference's campaign cell
#: (bench.py:937-1010: many runs' packs shipped to one service) and its
#: service-scaling cell (bench.py:1013-1106: the same packs over one and
#: several devices): epoch-v3 register runs at the generation cell's
#: concurrency and rate, 4 keys a run, for T = 27 s, so that every key
#: (13,496 entries) passes DFS_FIRST_MAX = 13,000 and the checker's
#: default route ships it; SVC_STALE_SEEDS more seeds with stale reads
#: injected; the simulated single-key cell's seeds give a second group
#: shape; the sharded rung runs on SVC_RUNG_KEYS of the campaign's keys
SVC_TIME_LIMIT, SVC_SEEDS, SVC_STALE_SEEDS = 27.0, 16, 4
SVC_LONG_SEEDS, SVC_RUNG_KEYS, SVC_TICK_S = 4, 4, 0.05
#: threefry-2x32 a pair of words, counted from threefry.py's _hash: 20
#: rounds of an add and its mask, a rotate (two shifts, a mask, an or)
#: and a xor; 5 key injections of three adds and two masks; the initial
#: two adds and masks; the counter's split and concatenation
THREEFRY_OPS_PER_PAIR = 20 * 7 + 5 * 5 + 4 + 4
#: the runner phase: the ``test`` entry point on the simulated cluster.
#: (a) the BASELINE deep configuration, "register --concurrency 4n
#: --ops-per-key 2000" (BASELINE.md), run for 110 virtual seconds so
#: that 12 keys of ~3,700 entries pass CPU_CUTOFF and ride the wave
#: kernel's batched launch; (b) the e2e suite's stale-read test
#: (tests/test_e2e.py:10-28: serializable reads, rate 100, 8 s) with
#: force_kernel; (c) the reference's watch cell (bench.py:674-689: 60 s
#: at 200 writes/s, ~11,800 values a watcher's log); (d) list-append
#: for 10 s at 200 txns/s, ~1,500 committed txns, past the closure's
#: CPU_CUTOFF of 768
RUNNER_ARGV = ["test", "-w", "register", "-c", "4n", "--ops-per-key",
               "2000", "--time-limit", "110", "--seed", "0"]
RUNNER_MIN_KEYS = 9
RUNNER_STALE = {"workload": "register", "serializable": True, "rate": 100,
                "time_limit": 8, "ops_per_key": 30, "seed": 7,
                "force_kernel": True}
RUNNER_WATCH = {"workload": "watch", "time_limit": 60, "rate": 200,
                "seed": 0}
RUNNER_APPEND = {"workload": "append", "time_limit": 10, "rate": 200,
                 "seed": 0}
#: the stream phase. (a) the runner phase's BASELINE command with
#: --stream; (b) the reference's set cell (bench.py:554-567: 60 s at 200
#: ops/s, ~24,000 ops and ~15 M observed values) with --stream, then the
#: set workload at the generation cell's opts through epoch-v3; (c) lock
#: with force_kernel (the Mutex adapter to wgl_wave), lock-set and
#: lock-etcd-set at their defaults; (d) the four MVCC workloads clean
#: at their defaults, then each with its injection hook through an
#: epoch-v3 campaign cell at tests/test_mvcc.py:39-46's opts
STREAM_ARGV = RUNNER_ARGV + ["--stream"]
SET_ARGV = ["test", "-w", "set", "--time-limit", "60", "--rate", "200",
            "--seed", "0", "--stream"]
SET_V3_OPTS = dict(GEN_OPTS, workload="set", gen_epoch="epoch-v3")
#: processes that run the reference sweep over the epoch-v3 set seeds
#: (host Python, ~1.7 s a seed) beside the card's checks, forked so that
#: they read the histories without a copy
SET_REF_WORKERS = 8
LOCK_RUNS = (("lock", {"force_kernel": True}), ("lock-set", {}),
             ("lock-etcd-set", {}))
MVCC_INJECT = {
    "register-stale": ("staleness", "inject_stale_snapshot",
                       "stale-beyond-bound"),
    "ranges": ("ranges", "inject_torn_range", "torn-range"),
    "lock-lease": ("lease", "inject_double_grant", "double-grant"),
    "compact-watch": ("watch-mvcc", "inject_compaction_swallow",
                      "lost-event"),
}
MVCC_INJECT_BASE = {"nodes": ["n1", "n2", "n3"], "concurrency": 8,
                    "rate": 200.0, "time_limit": 2.0,
                    "gen_epoch": "epoch-v3"}
#: result keys that read a host clock, dropped before dicts are compared
WALL_KEYS = ("telemetry", "wall", "seconds")
#: the campaign phase. (a) the reference's campaign-amortization cell
#: (bench.py:937-1010): 12 forced-kernel register runs at epoch-v1,
#: serial, over a pool of 4 spawned workers, and over the pool with one
#: checker service on the card; (b) the same specs over two worker-agent
#: processes on loopback TCP; (c) an epoch-v3 campaign at the service
#: cell's generation opts (16 seeds, 4 keys of 13,496 entries a run);
#: (d) the reference's guided search against the seeded stale-read bug
#: (tests/test_guided.py:321-366), its shrink and replay
CAMPAIGN_BASE = {"time_limit": 3, "rate": 100.0, "force_kernel": True,
                 "nodes": ["n1", "n2", "n3"], "snapshot_count": 100_000}
CAMPAIGN_POOL, CAMPAIGN_HOSTS = 4, 2
GUIDED_BASE = {"workload": "register", "nodes": ["n1", "n2", "n3"],
               "concurrency": 6, "rate": 100.0, "time_limit": 1.0,
               "inject_stale_reads": True, "gen_epoch": "epoch-v2"}
GUIDED_CELLS = [["kill"], ["pause"], ["latency"], ["member"],
                ["partition"]]
#: the verdict fields a service-checked run and an in-process re-check
#: share (tests/test_campaign.py:252-261)
PROJECTION = ("valid?", "waves", "peak-frontier", "ops", "info-ops",
              "op", "error", "stuck-at-depth")
#: the frame tables' work a (key, row, window slot), counted from
#: build_tables: nine column gathers with their range tests and
#: encodings (~3 operations each) and, against each of the wk window
#: ops, the predecessor bit (a compare, an and, a shift, an or)
FRAME_OPS_PER_SLOT = 27
FRAME_OPS_PER_PAIR = 4
#: the live phase: (a) the register workload over the etcd v3 JSON wire
#: at BASELINE's widths, against five in-process gateway endpoints over
#: one shared MVCC store (BASELINE's five nodes): 20 threads (its -c 4n),
#: so 10 threads a key, 2,000 ops a key and the reference's default 200
#: ops/s for 30 s; (b) the same over native gRPC for 10 s; (c) the local
#: control plane on one fake-etcd node with a kill nemesis every 2 s,
#: 10 s at 50 ops/s on 4 threads (tests/test_local_db.py:316-366); (d)
#: three 2 s soak windows on one such node (tests/test_stream.py:327-
#: 360). Every key goes to wgl_wave's batched launch (force_kernel: a
#: key's ~4,000 entries are below DFS_FIRST_MAX)
LIVE_OPTS = {"workload": "register", "concurrency": 20,
             "ops_per_key": 2000, "rate": 200.0, "time_limit": 30,
             "force_kernel": True}
LIVE_GRPC_TIME_LIMIT = 10
#: the readers phase: the runner and campaign phases' stores, indexed,
#: checked and served; one small run with a network trace joins the
#: runner's store (no earlier run records one) so the trace viewer has
#: events to show; /aggregate pages of READERS_PER rows
READERS_TRACE_OPTS = {"workload": "register", "time_limit": 3,
                      "rate": 100, "nemesis": ["partition"],
                      "nemesis_interval": 1, "tcpdump": True, "seed": 3}
READERS_PER = 20
LIVE_ENDPOINTS = 5
LOCAL_OPTS = {"workload": "register", "client_type": "http",
              "db_mode": "local", "etcd_binary": "fake", "nodes": ["n1"],
              "nemesis": ["kill"], "nemesis_interval": 2, "time_limit": 10,
              "rate": 50.0, "concurrency": 4, "force_kernel": True}
SOAK_OPTS = {"workload": "register", "client_type": "http",
             "db_mode": "local", "etcd_binary": "fake", "nodes": ["n1"],
             "rate": 150.0, "ops_per_key": 20, "seed": 3,
             "soak_windows": 3, "soak_window_s": 2, "force_kernel": True}
#: fake-etcd nodes spawned cold (and each restarted once) to time a spawn
LIVE_SPAWNS = 3
#: the value a corrupted read claims: the register workload writes 0-4
NEVER_WRITTEN = 424_242
#: hold workers: the two ladder-at-size plain versions, the closure's
#: three host legs and the four Elle host checks at 500 txns
HOLD_WORKERS = 3
#: section 16: the reference's fault packages (tests/test_nemesis.py)
#: through etcd_test -> run_test at that file's opts (:13-18), each run
#: with the card as the device and force_kernel, and once more with the
#: plain versions on the CPU: (label, opts over FAULTS_BASE). Lock-set
#: runs the file's two seeds, one of which must lose adds
FAULTS_BASE = {"time_limit": 20, "rate": 25, "ops_per_key": 50,
               "seed": 3, "nemesis_interval": 3, "force_kernel": True}
FAULT_RUNS = (
    ("register, kill", {"workload": "register", "nemesis": ["kill"]}),
    ("register, partition", {"workload": "register",
                             "nemesis": ["partition"]}),
    ("register, latency", {"workload": "register", "nemesis": ["latency"]}),
    ("register, pause + clock", {"workload": "register",
                                 "nemesis": ["pause", "clock"],
                                 "time_limit": 40}),
    ("register, member", {"workload": "register", "nemesis": ["member"],
                          "time_limit": 25}),
    ("set, admin", {"workload": "set", "nemesis": ["admin"]}),
    ("append, kill + bitflip", {"workload": "append",
                                "nemesis": ["kill", "bitflip-wal",
                                            "bitflip-snap"],
                                "time_limit": 25}),
    ("watch, kill", {"workload": "watch", "nemesis": ["kill"]}),
    ("lock-set, clock, seed 0", {"workload": "lock-set",
                                 "nemesis": ["clock"], "time_limit": 60,
                                 "rate": 10, "seed": 0,
                                 "nemesis_interval": 2}),
    ("lock-set, clock, seed 1", {"workload": "lock-set",
                                 "nemesis": ["clock"], "time_limit": 60,
                                 "rate": 10, "seed": 1,
                                 "nemesis_interval": 2}),
)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


#: the hold workers: spawned processes that run holds needing no card
#: (plain versions on the host's CPU, the host legs of the card-against-
#: host comparisons) while the card's sections go on; made on first use
_HOLDS = None


def hold_worker_init() -> None:
    import torch
    torch.set_num_threads(1)


def hold_workers():
    """The hold workers' pool, made on first use."""
    global _HOLDS
    if _HOLDS is None:
        _HOLDS = concurrent.futures.ProcessPoolExecutor(
            HOLD_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=hold_worker_init)
    return _HOLDS


def stop_hold_workers() -> None:
    """Ends the hold workers (jobs not started are dropped)."""
    global _HOLDS
    if _HOLDS is not None:
        _HOLDS.shutdown(wait=True, cancel_futures=True)
        _HOLDS = None


def host_wave(tab, scal, wk: int) -> tuple:
    """A hold worker's job: ``wave_search_reference`` on host copies
    (numpy) of a group's tables, and its seconds."""
    import torch
    from jepsen_etcd_tpu_torch.ops import wgl_mxu
    t0 = time.perf_counter()
    out = wgl_mxu.wave_search_reference(torch.from_numpy(tab),
                                        torch.from_numpy(scal), wk)
    return out.numpy(), time.perf_counter() - t0


def host_closure(a) -> tuple:
    """A hold worker's job: the closure's host leg, ``closure_batch``
    with ``force_device=False``: ((reach, on_cycle), seconds)."""
    from jepsen_etcd_tpu_torch.ops import closure
    t0 = time.perf_counter()
    got = closure.closure_batch(a, force_device=False)
    return got, time.perf_counter() - t0


def host_elle(kind: str, history) -> tuple:
    """A hold worker's job: the Elle check of ``kind`` on the host
    (``use_tpu=False``), elle_check's (dict, stages)."""
    from jepsen_etcd_tpu_torch.checkers.elle import (ListAppendChecker,
                                                     RWRegisterChecker)
    cls = {"list-append": ListAppendChecker,
           "rw-register": RWRegisterChecker}[kind]
    return elle_check(cls(use_tpu=False), history, sync=False)[:2]


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
        for _ in range(KEYED_RUNS):
            t0 = time.perf_counter()
            checker.check({}, h)
            walls.append(time.perf_counter() - t0)
    walls.sort()
    wmed, wmax = walls[len(walls) // 2], walls[-1]

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
          f"median {wmed:.4f} s, max {wmax:.4f} s; device idle share "
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


class SpanLog:
    """A telemetry recorder that keeps (name, attrs) of every span, to
    show which route a check's closure took."""

    def __init__(self):
        self.spans = []

    @contextlib.contextmanager
    def span(self, name, **attrs):
        self.spans.append((name, attrs))
        yield


def elle_check(checker, history, sync: bool = True) -> tuple:
    """One Elle check with its stages on the host clock: (result,
    stages, spans). "closure" is closure_levels_lazy (the level stack
    built and squared on the card, on_cycle copied back), "certificates"
    the rest of find_cycles (anchored BFS over the edges, reach copied
    back on an invalid history), "collect and graph" the rest of the
    check. ``sync`` False: no card is touched (a host check in a hold
    worker)."""
    import torch
    from jepsen_etcd_tpu_torch.checkers.elle import graph
    from jepsen_etcd_tpu_torch.runner import telemetry
    find_cycles, levels = graph.DepGraph.find_cycles, \
        graph.closure_levels_lazy
    t = {}

    def timed(name, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                t[name] = time.perf_counter() - t0
        return run
    log = SpanLog()
    graph.DepGraph.find_cycles = timed("find_cycles", find_cycles)
    graph.closure_levels_lazy = timed("closure", levels)
    telemetry.set_thread_current(log)
    try:
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = checker.check({}, history)
        wall = time.perf_counter() - t0
    finally:
        telemetry.set_thread_current(None)
        graph.DepGraph.find_cycles, graph.closure_levels_lazy = \
            find_cycles, levels
    stages = {"collect and graph": wall - t["find_cycles"],
              "closure": t["closure"],
              "certificates": t["find_cycles"] - t["closure"],
              "wall": wall}
    return res, stages, log.spans


def stage_text(stages: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in stages.items())


def elle_closure_at_scale(card: str, dev) -> dict:
    """The closure at 6 x 2,048 on the card: on_cycle held against the
    strongly connected components (scipy) of every plane, 64 sampled
    reach rows against a BFS, the squaring step against its plain
    float32 version, the card's time for one squaring and for the whole
    closure, and the same stack split over two lanes of the card.
    Returns the kernels line's numbers for the squaring."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from scipy.sparse.csgraph import breadth_first_order, \
        connected_components
    from jepsen_etcd_tpu_torch.ops import closure, wgl_mxu
    B, N = ELLE_B, ELLE_N
    a = np.random.RandomState(0).rand(B, N, N) < (2.0 / N)
    iters = int(np.ceil(np.log2(N)))
    a_dev = torch.from_numpy(a).to(dev)
    closure._closure_device(a_dev, iters)   # warm-up
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    reach, on_cycle, sq = closure._closure_device(a_dev, iters)
    e1.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    closure_ms = e0.elapsed_time(e1)
    reach_h, cyc_h = reach.cpu().numpy(), on_cycle.cpu().numpy()
    # the host check: a node is on a cycle iff its strongly connected
    # component has two or more nodes, or it has a self-loop
    scc_bad = 0
    for b in range(B):
        g = sp.csr_matrix(a[b])
        _, labels = connected_components(g, directed=True,
                                         connection="strong")
        want = (np.bincount(labels)[labels] >= 2) | a[b].diagonal()
        scc_bad += int((want != cyc_h[b]).sum())
    pick = np.random.RandomState(1)
    bfs_bad = 0
    for _ in range(ELLE_ROWS):
        b, i = int(pick.randint(B)), int(pick.randint(N))
        want = np.zeros(N, bool)
        want[breadth_first_order(sp.csr_matrix(a[b]), i, directed=True,
                                 return_predecessors=False)] = True
        bfs_bad += int((want != reach_h[b, i]).sum())
    # one squaring: the step (_square), torch.bmm alone, the plain
    # float32 step, on the same R
    r = (a_dev | torch.eye(N, dtype=torch.bool, device=dev)).to(
        torch.bfloat16)
    r32 = r.float()
    step = closure._square(r, r)
    plain = (torch.bmm(r32, r32) > 0).float()
    step_err = int((step.float() - plain).abs().max())
    sq_ms = cuda_ms(lambda: closure._square(r, r), 11)
    bmm_ms = cuda_ms(lambda: torch.bmm(r, r), 11)
    plain_ms = cuda_ms(lambda: (torch.bmm(r32, r32) > 0).float(), 11)
    flops = 2 * B * N ** 3
    sq_ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    sq_bytes_ms = 2 * B * N * N * 2 / HBM_BYTES_PER_S * 1e3
    run_ops_ms = sq * sq_ops_ms
    run_bytes_ms = (2 * B * N * N + B * N) / HBM_BYTES_PER_S * 1e3
    print(f"closure at {B} x {N} on {card}: {sq} squarings run of "
          f"{iters} bound; whole closure {closure_ms:.3f} ms on the card "
          f"(CUDA events; host clock {wall_ms:.3f} ms), "
          f"{flops * sq / closure_ms / 1e9:.1f} TFLOP/s over the "
          f"squarings run; bound {max(run_ops_ms, run_bytes_ms):.4f} ms "
          f"(operations {run_ops_ms:.4f} ms at {B} x {sq} x 2 x {N}^3 bf16, "
          f"bytes {run_bytes_ms:.4f} ms); one squaring {sq_ms:.3f} ms "
          f"({flops / sq_ms / 1e9:.1f} TFLOP/s), torch.bmm alone "
          f"{bmm_ms:.3f} ms, plain float32 squaring {plain_ms:.3f} ms, "
          f"bound {max(sq_ops_ms, sq_bytes_ms):.4f} ms (operations "
          f"{sq_ops_ms:.4f}, bytes {sq_bytes_ms:.4f}); on_cycle against "
          f"the SCCs: {scc_bad} nodes differ; {ELLE_ROWS} reach rows "
          f"against BFS: {bfs_bad} entries differ; squaring against its "
          f"plain version max_abs_err {step_err}; "
          f"{int(cyc_h.sum())} of {B * N} nodes on a cycle", flush=True)
    if scc_bad or bfs_bad or step_err:
        fail("the closure disagrees with the host check or its plain "
             "version")
    # the rows split over two lanes of the card, through closure_batch
    one_lane = wgl_mxu.batch_lanes
    got = {}
    for name, lanes in (("one lane", one_lane),
                        ("two lanes", lambda device=None: [dev, dev])):
        wgl_mxu.batch_lanes = lanes
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got[name] = closure.closure_batch(a, force_device=True)
            got[name + " s"] = time.perf_counter() - t0
        finally:
            wgl_mxu.batch_lanes = one_lane
    same = all(np.array_equal(x, y) for x, y in
               zip(got["one lane"], got["two lanes"]))
    print(f"closure at {B} x {N} over two lanes of the card (rows split, "
          f"blocks gathered each squaring): {got['two lanes s']:.3f} s "
          f"through closure_batch, one lane {got['one lane s']:.3f} s; "
          f"same reach and on_cycle: {same}", flush=True)
    if not same or not np.array_equal(got["one lane"][0], reach_h):
        fail("the closure over two lanes differs from one lane")
    return {"ms": sq_ms, "library_ms": bmm_ms, "plain_ms": plain_ms,
            "bound_ms": max(sq_ops_ms, sq_bytes_ms),
            "bound_by": "operations" if sq_ops_ms >= sq_bytes_ms
            else "bytes", "max_abs_err": max(step_err, scc_bad, bfs_bad)}


def elle_phase(card: str, dev) -> list:
    """The port's Elle path on the card: the closure at scale, the
    list-append and rw-register checks at 3,731 committed txns, clean
    and with an anomaly planted (the main path of this phase: the
    closure's launches are counted around the clean list-append check),
    the card against the host at 500 txns, and the closure's crossover.
    The host legs (the 500-txn checks with ``use_tpu=False``, the
    crossover's ``_closure_numpy`` up to CPU_CUTOFF) run in the hold
    workers while the card's checks go on; their seconds are the
    workers'. Returns the kernels line's entry."""
    import numpy as np
    import torch
    from jepsen_etcd_tpu_torch.checkers.elle import (ListAppendChecker,
                                                     RWRegisterChecker)
    from jepsen_etcd_tpu_torch.ops import closure
    from jepsen_etcd_tpu_torch.testing import gen_append_history, \
        gen_wr_history
    host_legs = {}
    for kind, gen in (("list-append", gen_append_history),
                      ("rw-register", gen_wr_history)):
        for corrupt in (None, ELLE_PLANTED[kind]):
            small = gen(random.Random(ELLE_SEED), ELLE_PROCS,
                        ELLE_PAIR_TXNS, corrupt=corrupt)
            host_legs[kind, corrupt] = (small, hold_workers().submit(
                host_elle, kind, small))
    planes = {n: np.random.RandomState(0).rand(ELLE_B, n, n) < (2.0 / n)
              for n in ELLE_SWEEP}
    host_closures = {n: hold_workers().submit(host_closure, planes[n])
                     for n in ELLE_SWEEP if n <= closure.CPU_CUTOFF}
    sq = elle_closure_at_scale(card, dev)
    launches = None
    for kind, gen, cls in (("list-append", gen_append_history,
                            ListAppendChecker),
                           ("rw-register", gen_wr_history,
                            RWRegisterChecker)):
        t0 = time.perf_counter()
        planted = ELLE_PLANTED[kind]
        h = gen(random.Random(ELLE_SEED), ELLE_PROCS, ELLE_TXNS)
        bad = gen(random.Random(ELLE_SEED), ELLE_PROCS, ELLE_TXNS,
                  corrupt=planted)
        made = time.perf_counter() - t0
        checker = cls()
        closure.LAUNCHES = 0
        res, stages, spans = elle_check(checker, h)
        if launches is None:
            launches = closure.LAUNCHES
        print(f"elle {kind}: {ELLE_TXNS} txns, {len(h)} entries (made in "
              f"{made:.2f} s) -> valid?={res['valid?']} committed="
              f"{res['committed-count']} closure squarings launched "
              f"{closure.LAUNCHES}; spans {spans}; stages (s): "
              f"{stage_text(stages)}", flush=True)
        if res["valid?"] is not True or res["committed-count"] != ELLE_TXNS:
            fail(f"elle {kind}: {res['anomaly-types']}")
        if [n for n, _ in spans if n.startswith("closure.")] != \
                ["closure.device"] or closure.LAUNCHES < 1:
            fail(f"elle {kind} did not close on the card: {spans}")
        res_bad, stages_bad, _ = elle_check(checker, bad)
        counts = {k: len(v) for k, v in res_bad["anomalies"].items()}
        # the planted stale read's certificates come from the realtime
        # vectors (graph._RealtimeSuccessors), never the n^2 pairs
        print(f"elle {kind} ({planted} planted): valid?="
              f"{res_bad['valid?']} anomalies {counts}; verdict and "
              f"certificates in {stages_bad['wall']:.3f} s, of which "
              f"certificates {stages_bad['certificates']:.3f} s; stages "
              f"(s): {stage_text(stages_bad)}", flush=True)
        if res_bad["valid?"] is not False or \
                planted not in res_bad["anomaly-types"]:
            fail(f"elle {kind}, {planted}: {res_bad['anomaly-types']}")
        walls = []
        with GpuBusy() as busy:
            for _ in range(11):
                walls.append(elle_check(checker, h)[1])
        walls.sort(key=lambda st: st["wall"])
        med = {k: statistics.median(st[k] for st in walls)
               for k in walls[0]}
        idle = "not measured" if busy.share is None else \
            f"{1 - busy.share:.3f}"
        print(f"elle {kind} timing on {card}: check wall over "
              f"{len(walls)} runs median {walls[5]['wall']:.4f} s, p90 "
              f"{walls[9]['wall']:.4f} s; median stages (s): "
              f"{stage_text(med)}; device idle share {idle} (1 - mean "
              f"nvidia-smi utilization over the runs)", flush=True)
        # the card against the host at 500 txns, clean and corrupted
        for corrupt in (None, planted):
            small, leg = host_legs[kind, corrupt]
            on_card, st_card, _ = elle_check(cls(use_tpu=True), small)
            on_host, st_host = leg.result()
            print(f"elle {kind} at {ELLE_PAIR_TXNS} txns, corrupt="
                  f"{corrupt}: valid?={on_card['valid?']} "
                  f"{on_card['anomaly-types']}; card and host dicts equal: "
                  f"{on_card == on_host}; closure on the card "
                  f"{st_card['closure']:.4f} s, on the host "
                  f"{st_host['closure']:.4f} s (a hold worker); check "
                  f"{st_card['wall']:.4f} / {st_host['wall']:.4f} s",
                  flush=True)
            if on_card != on_host or on_card["valid?"] is not (
                    corrupt is None):
                fail(f"elle {kind} at {ELLE_PAIR_TXNS} txns: the card and "
                     f"the host disagree")
    # the crossover: closure_batch on the card and, where the host
    # serves (N <= CPU_CUTOFF), on the host; six planes at density 2/N
    for n in ELLE_SWEEP:
        a = planes[n]
        card_s = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = closure.closure_batch(a, force_device=True)
            card_s.append(time.perf_counter() - t0)
        host = "not measured (N > CPU_CUTOFF)"
        if n in host_closures:
            want, secs = host_closures[n].result()
            host = f"{secs:.4f} s (a hold worker)"
            if not all(np.array_equal(x, y) for x, y in zip(got, want)):
                fail(f"closure at N={n}: card and host differ")
        print(f"closure crossover on {card}: N={n}, {ELLE_B} planes: card "
              f"{statistics.median(card_s):.4f} s (closure_batch, median of "
              f"3, copies included), host {host}", flush=True)
    return [{"name": "closure_squaring", "route": "torch.bmm",
             "source": "jepsen_etcd_tpu_torch/ops/closure.py",
             "replaces": "jepsen_etcd_tpu/ops/closure.py:51",
             "launches": launches, **sq}]


def sm_clock_mhz() -> float:
    """The card's top SM clock (nvidia-smi ``clocks.max.sm``, MHz)."""
    return float(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])


@contextlib.contextmanager
def captured_drains():
    """Record the arguments of every ``_drain_register`` call that
    ``generate_jax`` makes inside the block (the drain's inputs exactly
    as the main path builds them)."""
    from jepsen_etcd_tpu_torch.simbatch import engine_v3
    calls = []
    real = engine_v3._drain_register

    def capture(*args):
        calls.append(args)
        return real(*args)
    engine_v3._drain_register = capture
    try:
        yield calls
    finally:
        engine_v3._drain_register = real


@contextlib.contextmanager
def gen_stage_timers(stages: dict):
    """Add, into ``stages``, the host-clock seconds (each ending in a
    device sync) that ``generate_jax`` spends in its draws (threefry on
    the card and the one copy back), its drain (the kernel) and
    ``_finish`` (the per-seed OpColumns)."""
    import torch
    from jepsen_etcd_tpu_torch.simbatch import engine_v3
    names = {"draw": "_draws_jax", "drain": "_drain_register",
             "finish": "_finish"}
    real = {k: getattr(engine_v3, v) for k, v in names.items()}

    def timed(key, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stages[key] = stages.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run
    for k, v in names.items():
        setattr(engine_v3, v, timed(k, real[k]))
    try:
        yield stages
    finally:
        for k, v in names.items():
            setattr(engine_v3, v, real[k])


def drain_chain_links(args) -> int:
    """The longest chain of the drain's inputs: the most steps, over
    (seed, key), that are not timed out and write or CAS."""
    import torch
    from jepsen_etcd_tpu_torch.simbatch.engine import FC_CAS, FC_WRITE
    k, f, to = args[4], args[5], args[9]
    S, K = args[0].shape
    carry = ~to & ((f == FC_WRITE) | (f == FC_CAS))
    pair = k.long() + torch.arange(S, device=k.device) * K
    counts = torch.bincount(pair[carry], minlength=S * K)
    return int(counts.max()) if counts.numel() else 0


def drain_bound(args, mhz: float, link_ns: float) -> dict:
    """The drain's least time on the card, counted from its inputs: the
    bytes of the planes read once (five int32 and two bool a step and
    seed) and the outputs written once (five int32), the state read
    once, against HBM; the body's operations against the 32-bit rate;
    and, beside them, the recounted chain (``drain_chain_links`` links
    at ``link_ns`` each, as ``drain_link`` measures it) and that of a
    machine in shared memory (N steps at DRAIN_CHAIN_CYCLES)."""
    N, S = args[4].shape
    K = args[0].shape[1]
    nbytes = N * S * (5 * 4 + 2) + N * S * 5 * 4 + 4 * S * K * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = N * S * DRAIN_OPS_PER_STEP / ALU32_OPS_PER_S * 1e3
    links = drain_chain_links(args)
    return {"bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms), "links": links,
            "chain_ms": links * link_ns * 1e-6,
            "chain_old_ms": N * DRAIN_CHAIN_CYCLES / (mhz * 1e6) * 1e3}


def misaligned(args):
    """The drain's inputs copied into tensors that start one element
    past an allocation's start (4 bytes for the int32 planes, 1 for the
    flags), in the same layout: views the kernel's 4-byte copies meet
    unaligned."""
    import torch

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        if t.is_contiguous():
            view = buf[1:].view(t.shape)
        else:
            view = buf[1:].view(t.shape[1], t.shape[0]).t()
        view.copy_(t)
        return view
    return tuple(shifted(t) for t in args)


def flipped(args):
    """The drain's inputs with the planes in the other layout: (N, S)
    contiguous where they were seed-major, seed-major where they were
    (N, S)."""
    def flip(t):
        return t.contiguous() if not t.is_contiguous() \
            else t.t().contiguous().t()
    return tuple(args[:4]) + tuple(flip(t) for t in args[4:])


def timed_out(args):
    """The drain's inputs with every row timed out: no lane has a row to
    walk, and the workers' passes are the whole kernel."""
    import torch
    return tuple(args[:9]) + (torch.ones_like(args[9]), args[10])


#: the drain kernel's regimes: (label, lanes a block (None: the
#: default, through ``drain_register_cuda``), a change of the inputs'
#: layout or alignment)
DRAIN_REGIMES = (("default blocking", None, None),
                 ("32 lanes a block", 32, None),
                 ("misaligned planes", None, misaligned),
                 ("the other layout", None, flipped))


def drain_default_lanes(S: int, K: int) -> int:
    """The lanes a drain block takes by default on card 0."""
    import torch
    from jepsen_etcd_tpu_torch.simbatch import engine_v3
    return engine_v3.drain_lanes(
        S, K, torch.cuda.get_device_properties(0).multi_processor_count)


def drain_launcher(args, lanes=None, copies: int = 1):
    """Bare launches of drain_register.cu at ``lanes`` a block (None:
    the default), the wrapper's checks and allocation done once,
    outside; not counted in ``engine_v3.LAUNCHES``. Each call launches
    on the next of ``copies`` copies of the inputs and outputs. Returns
    the launch and the first copy's outputs ([5, N, S], seed-major when
    the planes are)."""
    import torch
    from jepsen_etcd_tpu_torch.ops import _cuda
    from jepsen_etcd_tpu_torch.simbatch import engine_v3
    N, S = args[4].shape
    K = args[0].shape[1]
    seed_major = not args[4].is_contiguous()
    blocking = engine_v3.drain_blocking(
        S, K, lanes or drain_default_lanes(S, K))
    runs = []
    for c in range(copies):
        ins = args if c == 0 else tuple(t.clone() for t in args)
        out = torch.empty((5, S, N) if seed_major else (5, N, S),
                          dtype=torch.int32, device=args[0].device)
        runs.append((ins, out))
    turn = itertools.cycle(runs)

    def launch():
        ins, out = next(turn)
        _cuda.drain_register(tuple(ins[:4]), tuple(ins[4:9]),
                             tuple(ins[9:]), out, blocking, seed_major)
    out = runs[0][1]
    return launch, out.transpose(1, 2) if seed_major else out


def back_to_back_ms(fn, reps: int, runs: int = 5) -> float:
    """Median over ``runs`` of the device time of ``reps`` launches in a
    row over ``reps`` (CUDA events): a kernel's own time, the host's
    work between launches hidden behind the queue."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / reps)
    return statistics.median(times)


def hold_drain(args, what: str) -> int:
    """drain_register.cu against drain_register_reference on the same
    planes, all five outputs, in each of DRAIN_REGIMES: the default
    blocking (``drain_lanes``) and blocks of 32 lanes, planes at one
    element past an aligned start and in the other layout (the
    generator's are seed-major, random planes (N, S)); returns the
    largest difference."""
    import torch
    from jepsen_etcd_tpu_torch.ops import _cuda
    from jepsen_etcd_tpu_torch.simbatch import engine_v3
    want = engine_v3.drain_register_reference(*args)
    N, S = args[4].shape
    K = args[0].shape[1]
    errs, shapes = {}, {}
    for label, lanes, change in DRAIN_REGIMES:
        SB, KB, T = engine_v3.drain_blocking(
            S, K, lanes or drain_default_lanes(S, K))
        shapes[label] = (f"SB {SB} KB {KB} T {T}, "
                         f"{_cuda.drain_smem(SB, KB, T)} B")
        inputs = change(args) if change else args
        if lanes is None:
            got = engine_v3.drain_register_cuda(*inputs)
        else:
            run, got = drain_launcher(inputs, lanes)
            run()
        torch.cuda.synchronize()
        errs[label] = int((got.long() - want.long()).abs().max()) \
            if got.numel() else 0
    to = args[9]
    layout = "(N, S)" if args[4].is_contiguous() else "seed-major"
    print(f"  drain_register {what}: N {N}, S {S}, K {K}, {layout} planes, "
          f"{int(to.sum())} timed-out rows, {int(args[10].sum())} stale "
          f"gates, {drain_chain_links(args)} links in the longest chain; "
          f"blocks {shapes}; max_abs_err against the plain version on "
          f"all five planes: {errs}", flush=True)
    if any(errs.values()):
        fail(f"drain_register disagrees with its plain version ({what})")
    return max(errs.values())


def drain_link(dev, mhz: float) -> dict:
    """A link of the drain's chain, measured on the card: the kernel
    alone on one seed, one key and DRAIN_LINK_ROWS rows, each a write or
    a CAS and none timed out (every row a link of the one chain), over
    its links; beside it the same rows all timed out (no link: the
    workers' passes alone), which must take less for the reading to be
    the chain's."""
    from jepsen_etcd_tpu_torch.simbatch.engine import FC_READ, FC_WRITE
    args = list(random_drain_inputs(7, DRAIN_LINK_ROWS, 1, 1, dev,
                                    p_to=0.0))
    args[5] = args[5].masked_fill(args[5] == FC_READ, FC_WRITE)
    links = drain_chain_links(args)
    ms = back_to_back_ms(drain_launcher(args)[0], 5)
    idle_ms = back_to_back_ms(drain_launcher(timed_out(args))[0], 5)
    ns = ms * 1e6 / links
    return {"links": links, "ms": ms, "idle_ms": idle_ms, "ns": ns,
            "cycles": ns * mhz / 1e3}


def random_drain_inputs(seed: int, N: int, S: int, K: int, dev,
                        skew: float = 0.0, p_to: float = 0.3):
    """Random drain planes (keys in [0, K), a share ``skew`` of the rows
    sent to key 0; f in {read, write, cas}, values in [0, 5), a share
    ``p_to`` of the rows timed out, half stale-gated)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, K, (N, S))
    keys = np.where(rng.random((N, S)) < skew, 0, keys)
    state = [np.zeros((S, K)), np.full((S, K), -1), np.zeros((S, K)),
             np.full((S, K), -1)]
    planes = [keys, rng.integers(0, 3, (N, S)),
              rng.integers(0, 5, (N, S)), rng.integers(-1, 5, (N, S)),
              rng.integers(0, 5, (N, S))]
    flags = [rng.random((N, S)) < p_to, rng.random((N, S)) < 0.5]
    return tuple([torch.from_numpy(a.astype(np.int32)).to(dev)
                  for a in state + planes]
                 + [torch.from_numpy(a).to(dev) for a in flags])


def threefry_work(config, S: int) -> dict:
    """What ``_draw_device`` computes for S seeds: words hashed (each
    uniform block its size, each randint block a split of 4 words and
    twice its size, the 12-way split 24 words) and bytes written (the
    blocks, 4 bytes a value; the input is S seeds); its bound."""
    from jepsen_etcd_tpu_torch.simbatch import engine_v3
    L, O, ncy, _ = engine_v3._draws_shape_params(config)[:4]
    uniform = L + 3 * L * O + 2 * ncy
    randint = 5 * L * O + ncy
    words = S * (24 + uniform + randint * 2 + 6 * 4)
    nbytes = S * 4 * (uniform + randint) + S * 8
    ops_ms = words / 2 * THREEFRY_OPS_PER_PAIR / ALU32_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"words": words, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms)}


def pin_shas(out) -> tuple:
    import hashlib
    from jepsen_etcd_tpu_torch.simbatch import history_sha
    shas = [history_sha(h) for h in out["histories"]]
    return shas[0], hashlib.sha256("".join(shas).encode()).hexdigest()


def simulator_phase(card: str, dev) -> list:
    """The port's simulator on the card: (a) drain_register.cu held
    exactly against its plain version at the generation shape, at 256
    seeds and on the fuzz, both timed; (b) both committed pins, the
    generator timed at the generation shape (stages, events/s, the
    device's busy share) and per seed at 16 and 256 seeds, the threefry
    draws held against the CPU's and timed; (c) simulated histories
    checked: a single key through B1, the generation shape's 4 keys
    through ``Independent(Compose({linear, session}))``, every verdict
    against the native DFS, and an injected stale read caught; (d) the
    fused gen->check pipeline against its sequential twin. Returns the
    kernels line's entries for the drain and the draws."""
    import numpy as np
    import torch
    from jepsen_etcd_tpu_torch.checkers import (
        SessionGuarantees, TPULinearizableChecker, compose,
        independent_checker)
    from jepsen_etcd_tpu_torch.checkers.linearizable import check_history
    from jepsen_etcd_tpu_torch.models import VersionedRegister
    from jepsen_etcd_tpu_torch.ops import wgl_mxu
    from jepsen_etcd_tpu_torch.runner.stream import FusedPipeline
    from jepsen_etcd_tpu_torch.simbatch import (BatchConfig, engine_v3,
                                                generate, generate_for_opts,
                                                generate_jax)
    mhz = sm_clock_mhz()
    v3 = dict(GEN_OPTS, gen_epoch="epoch-v3")
    cfg = BatchConfig.from_opts(v3)
    seeds = list(range(GEN_SEEDS))

    # -- (a) the drain against its plain version ----------------------
    print("drain_register vs plain (exact, tolerance 0):", flush=True)
    with captured_drains() as calls:
        generate_jax(cfg, seeds, device=dev)
        generate_jax(BatchConfig.from_opts(
            dict(v3, time_limit=GEN_SCALE_LIMIT)),
            list(range(GEN_SCALE_SEEDS)), device=dev)
        generate_jax(BatchConfig(**DRAIN_FUZZ),
                     list(range(DRAIN_FUZZ_SEEDS)), device=dev)
    gen_args, scale_args, fuzz_args = calls
    wide_args = random_drain_inputs(1, 500, 100, DRAIN_WIDE_KEYS, dev)
    drain_err = 0
    for what, args in (("generation shape", gen_args),
                       (f"{GEN_SCALE_SEEDS} seeds", scale_args),
                       ("fuzz: 12 keys, partition and kill", fuzz_args),
                       (f"random planes, {DRAIN_WIDE_KEYS} keys",
                        wide_args),
                       *[(f"edge: {label}",
                          random_drain_inputs(seed, *shape, dev, **kw))
                         for label, seed, shape, kw in DRAIN_EDGES]):
        drain_err = max(drain_err, hold_drain(args, what))
    link = drain_link(dev, mhz)
    print(f"drain_register link on {card}: one chain of {link['links']} "
          f"writes and CASes (one seed, one key) {link['ms']:.4f} ms alone "
          f"(the same rows all timed out: {link['idle_ms']:.4f} ms, the "
          f"workers alone), {link['ns']:.3f} ns a link = "
          f"{link['cycles']:.1f} cycles at the top SM clock {mhz:.0f} MHz "
          f"over {DRAIN_LINK_OPS} dependent operations", flush=True)
    if link["idle_ms"] >= link["ms"]:
        fail("the drain's one-chain input did not take longer than its "
             "workers alone: the link reading is not the chain's")
    drain_t = {}
    for what, args in (("generation shape", gen_args),
                       (f"{GEN_SCALE_SEEDS} seeds", scale_args)):
        N, S = args[4].shape
        K = args[0].shape[1]
        b = drain_bound(args, mhz, link["ns"])
        w_ms = cuda_ms(lambda: engine_v3._drain_register(*args), 11)
        k_ms = back_to_back_ms(drain_launcher(args, None, DRAIN_COPIES)[0],
                               DRAIN_B2B)
        idle_ms = back_to_back_ms(
            drain_launcher(timed_out(args), None, DRAIN_COPIES)[0],
            DRAIN_B2B)
        p_ms = cuda_ms(lambda: engine_v3.drain_register_reference(*args),
                       1)
        drain_t[what] = (w_ms, k_ms, p_ms, b)
        regimes = {}
        for lanes, flip in DRAIN_TIMED:
            lanes = lanes or drain_default_lanes(S, K)
            blocking = engine_v3.drain_blocking(S, K, lanes)
            run = flipped(args) if flip else args
            layout = "(N, S)" if run[4].is_contiguous() else "seed-major"
            regimes[f"{lanes} lanes (SB, KB, T = {blocking}), "
                    f"{layout}"] = back_to_back_ms(
                        drain_launcher(run, lanes, DRAIN_COPIES)[0],
                        DRAIN_B2B)
        print(f"drain_register at the {what} on {card}: through "
              f"_drain_register {w_ms:.4f} ms (median of 11, CUDA "
              f"events: the key check's transfer, the allocation and the "
              f"launch), kernel alone {k_ms:.4f} ms ({DRAIN_B2B} launches "
              f"in a row over {DRAIN_COPIES} copies of the inputs, median "
              f"of 5), every row timed out {idle_ms:.4f} ms (the workers "
              f"alone); plain torch loop {p_ms:.1f} ms (one run); N {N} "
              f"steps x S {S} seeds x K {K} keys, {w_ms * 1e6 / N:.1f} ns "
              f"a step ({k_ms * 1e6 / N:.1f} alone); bound "
              f"{b['bound_ms']:.5f} ms (bytes {b['bytes_ms']:.5f} ms, "
              f"operations {b['ops_ms']:.5f} ms); the recounted chain of "
              f"{b['links']} links at the measured {link['ns']:.3f} ns: "
              f"{b['chain_ms']:.5f} ms (a machine in shared memory: {N} "
              f"steps at {DRAIN_CHAIN_CYCLES} cycles and {mhz:.0f} MHz, "
              f"{b['chain_old_ms']:.4f} ms); variants (kernel ms): "
              + ", ".join(f"{k} {v:.4f}" for k, v in regimes.items()),
              flush=True)

    # -- (b) generation on the card ------------------------------------
    got = {"epoch-v2": pin_shas(generate_for_opts(dict(PIN_OPTS),
                                                  seeds)),
           "epoch-v3": pin_shas(generate_for_opts(
               dict(PIN_OPTS, gen_epoch="epoch-v3"), seeds, device=dev))}
    print(f"pins (16 seeds, seed 0's sha and the joined sha): {got}; "
          f"committed: {got == PINS}", flush=True)
    if got != PINS:
        fail(f"a generator pin differs: {got} != {PINS}")
    # the main path of this phase: epoch-v3 at the generation shape
    # (warmed at that shape by the capture above), counted
    torch.cuda.synchronize()
    engine_v3.LAUNCHES = engine_v3.DRAW_LAUNCHES = 0
    t0 = time.perf_counter()
    out = generate_jax(cfg, seeds, device=dev)
    torch.cuda.synchronize()
    drive_s = time.perf_counter() - t0
    drain_launches = engine_v3.LAUNCHES
    draw_launches = engine_v3.DRAW_LAUNCHES
    if drain_launches < 1 or draw_launches < 1:
        fail("the generator did not launch drain_register or draw")
    walls, stage_runs = [], []
    with GpuBusy() as busy:
        for _ in range(GEN_REPS):
            stages = {}
            with gen_stage_timers(stages):
                t0 = time.perf_counter()
                generate_jax(cfg, seeds, device=dev)
                walls.append(time.perf_counter() - t0)
            stages["host timeline"] = walls[-1] - sum(stages.values())
            stage_runs.append(stages)
    wall = statistics.median(walls)
    split = {k: statistics.median(r[k] for r in stage_runs)
             for k in stage_runs[0]}
    t0 = time.perf_counter()
    v2 = generate(cfg, seeds)
    v2_s = time.perf_counter() - t0
    print(f"generation at the bench shape on {card}: {out['events']} "
          f"events over {GEN_SEEDS} seeds ({cfg.lanes} lanes x "
          f"{cfg.ops_per_lane} ops, {cfg.keys} keys); epoch-v3 median of "
          f"{GEN_REPS} {wall:.4f} s [{min(walls):.4f}-{max(walls):.4f}], "
          f"{out['events'] / wall:,.0f} aggregate events/s (first run "
          f"{drive_s:.4f} s); stages (s, medians): " + ", ".join(
              f"{k} {v:.4f}" for k, v in split.items())
          + f"; card busy share {busy.share} (nvidia-smi); epoch-v2 on "
          f"the host {v2_s:.4f} s ({v2['events'] / v2_s:,.0f} events/s); "
          f"drain launches {drain_launches}, draws {draw_launches}",
          flush=True)
    scaling = {}
    for n in (GEN_SEEDS, GEN_SCALE_SEEDS):
        scfg = BatchConfig.from_opts(dict(v3, time_limit=GEN_SCALE_LIMIT))
        ss = list(range(n))
        generate_jax(scfg, ss, device=dev)
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            sgen = generate_jax(scfg, ss, device=dev)
            runs.append(time.perf_counter() - t0)
        scaling[n] = (statistics.median(runs), sgen["events"])
    print(f"generation per seed at time_limit {GEN_SCALE_LIMIT} on {card} "
          f"(medians of 3): " + "; ".join(
              f"S={n}: {s:.4f} s, {s / n * 1e3:.3f} ms a seed, {e} events"
              for n, (s, e) in scaling.items()), flush=True)
    # the draws: the card's blocks against the CPU's, bit for bit
    L, O, ncy, nnem = engine_v3._draws_shape_params(cfg)[:4]
    sd = torch.tensor(seeds, device=dev)
    on_card = engine_v3._draw_device(sd, L, O, ncy, nnem)
    on_cpu = engine_v3._draw_device(sd.cpu(), L, O, ncy, nnem)
    draw_err = max(int((a.cpu().view(torch.int32).long()
                        - b.view(torch.int32).long()).abs().max())
                   for a, b in zip(on_card, on_cpu))
    draw_ms = cuda_ms(lambda: engine_v3._draw_device(sd, L, O, ncy, nnem),
                      11)
    cpu_runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine_v3._draw_device(sd.cpu(), L, O, ncy, nnem)
        cpu_runs.append((time.perf_counter() - t0) * 1e3)
    draw_cpu_ms = statistics.median(cpu_runs)
    tw = threefry_work(cfg, GEN_SEEDS)
    print(f"threefry draws at the bench shape on {card}: "
          f"{draw_ms:.4f} ms (median of 11, CUDA events), the same torch "
          f"ops on the host's CPU {draw_cpu_ms:.1f} ms (median of 3); "
          f"{tw['words']} words hashed; bound {tw['bound_ms']:.5f} ms "
          f"(operations {tw['ops_ms']:.5f} ms, bytes {tw['bytes_ms']:.5f} "
          f"ms); card against CPU max_abs_err {draw_err}", flush=True)
    if draw_err:
        fail("the card's threefry draws differ from the CPU's")

    # -- (c) checks on simulated histories -----------------------------
    single = generate_for_opts(dict(SIM_SINGLE_OPTS, gen_epoch="epoch-v3"),
                               [0], device=dev)["histories"][0]
    (key, sub), = single.split_by_key().items()
    torch.cuda.synchronize()
    wgl_mxu.LAUNCHES = 0
    t0 = time.perf_counter()
    res = TPULinearizableChecker().check({}, sub)
    single_s = time.perf_counter() - t0
    single_launches = wgl_mxu.LAUNCHES
    dfs = check_history(VersionedRegister(0, None), sub)
    print(f"simulated single-key history: {len(single)} entries, key "
          f"{key}: valid?={res['valid?']} engine={res.get('engine')} "
          f"waves={res.get('waves')} wgl_wave launches {single_launches} "
          f"check wall {single_s:.3f} s; native DFS valid?="
          f"{dfs['valid?']}", flush=True)
    if res.get("engine") != "mxu-wave" or single_launches < 1 or \
            res["valid?"] is not dfs["valid?"] or res["valid?"] is not True:
        fail(f"simulated single-key check {res}, DFS {dfs}")
    # the register workload's checker with --force-kernel (cpu_cutoff
    # None): 4 keys of 3,760 entries each sit inside the native DFS's
    # first-shot band, and this cell is B1's batched launch
    checker = independent_checker(compose({
        "linear": TPULinearizableChecker(cpu_cutoff=None),
        "session": SessionGuarantees()}))
    for stale in (False, True):
        h = generate_for_opts(dict(v3, inject_stale_reads=stale), [0],
                              device=dev)["histories"][0]
        subs = h.split_by_key()
        torch.cuda.synchronize()
        wgl_mxu.LAUNCHES = 0
        t0 = time.perf_counter()
        res = checker.check({}, h)
        keyed_s = time.perf_counter() - t0
        launches = wgl_mxu.LAUNCHES
        lin = {k: r["linear"] for k, r in res["results"].items()}
        ses = {k: r["session"]["valid?"] for k, r in res["results"].items()}
        for k, s in subs.items():
            dfs = check_history(VersionedRegister(0, None), s)
            if lin[k]["valid?"] is not dfs["valid?"]:
                fail(f"simulated keyed history, key {k}: {lin[k]} but "
                     f"native DFS {dfs}")
        print(f"simulated keyed history{' (stale reads injected)' if stale else ''}: "
              f"{len(h)} entries, {len(subs)} keys x "
              f"{[len(s) for s in subs.values()]} entries: valid?="
              f"{res['valid?']}, linear {[lin[k]['valid?'] for k in subs]} "
              f"engines {[lin[k].get('engine') for k in subs]} (= native "
              f"DFS), session {[ses[k] for k in subs]}; wgl_wave launches "
              f"{launches}; check wall {keyed_s:.3f} s", flush=True)
        if stale:
            if res["valid?"] is not False or all(ses.values()):
                fail("the injected stale reads were not caught")
        elif res["valid?"] is not True or launches < 1:
            fail(f"simulated keyed history: {res['valid?']}, launches "
                 f"{launches}")

    # -- (d) the fused pipeline against its sequential twin ------------
    fseeds = list(range(FUSED_SEEDS))
    fused = FusedPipeline(GEN_OPTS, sub_batch=FUSED_SUB_BATCH,
                          device=dev).run(fseeds)
    t0 = time.perf_counter()
    gen = generate_for_opts(v3, fseeds, device=dev)
    seq_gen_s = time.perf_counter() - t0
    twin = FusedPipeline(GEN_OPTS, device=dev)
    t0 = time.perf_counter()
    seq = {s: twin._check_history(s, h)[0]
           for s, h in zip(fseeds, gen["histories"])}
    seq_check_s = time.perf_counter() - t0
    print(f"fused pipeline on {card}: {FUSED_SEEDS} seeds in sub-batches "
          f"of {FUSED_SUB_BATCH}: gen_s {fused['gen_s']:.3f}, check_s "
          f"{fused['check_s']:.3f}, e2e_s {fused['e2e_s']:.3f}, ratio "
          f"{fused['ratio']:.3f} (e2e / max leg), packs {fused['packs']}, "
          f"waves {fused['waves']}; sequential twin: gen "
          f"{seq_gen_s:.3f} s + check {seq_check_s:.3f} s = "
          f"{seq_gen_s + seq_check_s:.3f} s; verdicts {fused['verdicts']}, "
          f"equal: {seq == fused['verdicts']}", flush=True)
    if seq != fused["verdicts"]:
        fail(f"fused verdicts {fused['verdicts']} != sequential {seq}")
    # where the check leg's time goes: seed 0's packs through check_prefix
    # (paused every max_waves) against the one-shot ladder from the same
    # rung (f_max: no wave kernel); same dicts
    from jepsen_etcd_tpu_torch.ops import wgl
    ps = wgl.PackStream()
    ps.feed(gen["histories"][0].columns)
    walls = {"check_prefix": 0.0, "one-shot ladder": 0.0}
    lwaves = 0
    packs = ps.finish()
    for p in packs.values():
        t0 = time.perf_counter()
        state = None
        while state is None or not state.done:
            state = wgl.check_prefix(p, state, max_waves=twin.max_waves,
                                     device=dev)
        walls["check_prefix"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        one = wgl.check_packed(p, f_max=wgl.LADDER[0], device=dev)
        walls["one-shot ladder"] += time.perf_counter() - t0
        lwaves += state.waves_run
        if one != state.result:
            fail(f"check_prefix {state.result} != one-shot ladder {one}")
    print(f"fused check leg, seed 0's {len(packs)} packs, {lwaves} "
          f"waves: " + ", ".join(f"{k} {v:.3f} s ({v / lwaves * 1e3:.3f} "
                                 f"ms a wave)" for k, v in walls.items())
          + "; same dicts", flush=True)

    w_ms, k_ms, p_ms, b = drain_t["generation shape"]
    return [{"name": "drain_register", "route": "cuda",
             "source": "jepsen_etcd_tpu_torch/csrc/drain_register.cu",
             "replaces": "jepsen_etcd_tpu/simbatch/engine_jax.py:159",
             "launches": drain_launches, "max_abs_err": drain_err,
             "ms": w_ms, "kernel_ms": k_ms, "plain_ms": p_ms,
             "bound_ms": b["bound_ms"],
             "bound_by": "bytes" if b["bytes_ms"] >= b["ops_ms"]
             else "operations", "library_ms": None,
             "chain_ms": b["chain_ms"]},
            {"name": "threefry_draws", "route": "torch",
             "source": "jepsen_etcd_tpu_torch/simbatch/threefry.py",
             "replaces": "jepsen_etcd_tpu/simbatch/engine_jax.py:81",
             "launches": draw_launches, "max_abs_err": draw_err,
             "ms": draw_ms, "plain_ms": draw_cpu_ms,
             "bound_ms": tw["bound_ms"],
             "bound_by": "bytes" if tw["bytes_ms"] >= tw["ops_ms"]
             else "operations", "library_ms": None}]


def service_campaign(card: str, dev) -> dict:
    """The checker service (``runner/checker_service.py``) driven by a
    campaign: SVC_SEEDS epoch-v3 register runs and SVC_STALE_SEEDS more
    with stale reads injected, each checked by the register workload's
    checker, ``Independent(Compose({linear, session}))``, on a client
    thread of its own against one service on a unix socket (every key
    ships by the checker's default route), then the same runs checked
    in-process one after another on the same card. Then the runs' packs
    again through services over one lane and over two lanes of the
    card: groups placed sticky (with the simulated single-key cell's
    packs as a second group shape), then the campaign's one group split
    over both lanes in one tick. Every dict is held against the one-lane
    run's; fails on any fallback, error reply or broken ledger. Returns
    what the kernels line needs."""
    import shutil
    import tempfile
    import threading
    import torch
    from jepsen_etcd_tpu_torch.checkers import (
        SessionGuarantees, TPULinearizableChecker, compose,
        independent_checker)
    from jepsen_etcd_tpu_torch.checkers.tpu_linearizable import \
        DFS_FIRST_MAX
    from jepsen_etcd_tpu_torch.ops import wgl, wgl_mxu
    from jepsen_etcd_tpu_torch.runner import checker_service as svc_mod
    from jepsen_etcd_tpu_torch.runner import telemetry
    from jepsen_etcd_tpu_torch.runner.telemetry import Hist, Telemetry
    from jepsen_etcd_tpu_torch.simbatch import generate_for_opts

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    opts = dict(GEN_OPTS, gen_epoch="epoch-v3", time_limit=SVC_TIME_LIMIT)
    t0 = time.perf_counter()
    runs = generate_for_opts(opts, list(range(SVC_SEEDS)),
                             device=dev)["histories"]
    stale = list(range(SVC_SEEDS, SVC_SEEDS + SVC_STALE_SEEDS))
    runs += generate_for_opts(dict(opts, inject_stale_reads=True), stale,
                              device=dev)["histories"]
    gen_s = time.perf_counter() - t0
    subs = [h.split_by_key() for h in runs]
    n_keys = sum(len(s) for s in subs)
    smallest = min(len(k) for s in subs for k in s.values())
    print(f"service campaign: {len(runs)} epoch-v3 register runs "
          f"({SVC_SEEDS} clean, {SVC_STALE_SEEDS} with stale reads) at "
          f"concurrency {opts['concurrency']}, rate {opts['rate']:.0f}, "
          f"time_limit T = {SVC_TIME_LIMIT} s: {n_keys} keys, the "
          f"smallest {smallest} entries (DFS_FIRST_MAX {DFS_FIRST_MAX}); "
          f"generated on the card in {gen_s:.2f} s", flush=True)

    def checker():
        return independent_checker(compose({
            "linear": TPULinearizableChecker(),
            "session": SessionGuarantees()}))

    # -- in-process, one run after another ------------------------------
    local, local_tels = [], []
    sync()
    wgl_mxu.LAUNCHES = 0
    t0 = time.perf_counter()
    for h in runs:
        tel = Telemetry()
        telemetry.set_thread_current(tel)
        try:
            local.append(checker().check({}, h))
        finally:
            telemetry.set_thread_current(None)
        local_tels.append(tel.summary())
    sync()
    seq_s = time.perf_counter() - t0
    local_launches = wgl_mxu.LAUNCHES

    # -- the campaign through one service (the main path) ---------------
    sock_dir = tempfile.mkdtemp(prefix="jet-")
    path = os.path.join(sock_dir, "checker.sock")
    test = {"checker_service": path}
    tels = [Telemetry(trace=f"run-{i}") for i in range(len(runs))]
    got: list = [None] * len(runs)
    errors: list = []

    def run(i: int) -> None:
        telemetry.set_thread_current(tels[i])
        try:
            got[i] = checker().check(test, runs[i])
        except Exception as e:  # reported below, fails the phase
            errors.append(f"run {i}: {e!r}")

    svc = svc_mod.CheckerService(path=path, tick_s=SVC_TICK_S).start()
    try:
        threads = [threading.Thread(target=run, args=(i,),
                                    name=f"campaign-run{i}")
                   for i in range(len(runs))]
        sync()
        wgl_mxu.LAUNCHES = 0
        with GpuBusy() as busy:
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            svc_s = time.perf_counter() - t0
        main_launches = wgl_mxu.LAUNCHES
        alive = [t.name for t in threads if t.is_alive()]
        st = svc.stats()
    finally:
        svc.close()
        svc_mod.reset_clients()
        shutil.rmtree(sock_dir, ignore_errors=True)
    if errors or alive:
        fail(f"service campaign: {errors or alive}")
    ctr = st["counters"]
    run_ctr = [t.summary()["counters"] for t in tels]
    fallbacks = sum(c.get("service.fallback", 0) for c in run_ctr)
    shipped = sum(c.get("service.shipped", 0) for c in run_ctr)
    disp = {k[len("service.device_dispatches."):]: v
            for k, v in ctr.items()
            if k.startswith("service.device_dispatches.")}
    qwait = Hist.from_dict(st["hists"]["service.queue_wait_s"])
    lane_busy = {k[len("service.device_busy_s."):]: v
                 for k, v in ctr.items()
                 if k.startswith("service.device_busy_s.")}
    run_pack = [t.summary()["spans"].get("wgl.pack-batch", {})
                .get("total_s", 0.0) for t in tels]
    idle = "not measured" if busy.share is None \
        else f"{1 - busy.share:.3f}"
    svc_launches = ctr.get("service.wgl_wave_launches", 0)
    same, relabelled = same_campaign(got, local)
    print(f"service campaign on {card}: {len(runs)} runs on "
          f"{len(runs)} client threads through one service over "
          f"{len(st['devices'])} lane(s) {st['devices']}: wall "
          f"{svc_s:.3f} s; the same runs checked in-process one after "
          f"another on the card: {seq_s:.3f} s; every run's dict = its "
          f"in-process dict: {same} ({relabelled} ladder keys compared "
          f"on verdict and depth); valid? {[r['valid?'] for r in got]}; "
          f"service.fallback {fallbacks}, shutdown leaked threads "
          f"{svc.shutdown_leaked_threads}", flush=True)
    print(f"service ticks on {card}: ticks {ctr['service.ticks']}, "
          f"group_ticks {ctr['service.group_ticks']}, coalesced "
          f"{ctr['service.coalesced']}, batch occupancy "
          f"{ctr['service.batch_occupancy']} packs at most, median queue "
          f"wait {qwait.percentile(50):.4f} s (p95 "
          f"{qwait.percentile(95):.4f}); shipped by the runs {shipped} = "
          f"submitted {ctr['service.submitted']}; per-lane dispatches "
          f"{disp} = group_ticks + shard_fanout "
          f"{ctr['service.group_ticks']} + "
          f"{ctr.get('service.shard_fanout', 0)}; where the wall went: "
          f"the runs' packing {sum(run_pack):.3f} s in all (client "
          f"threads), the dispatcher's table padding "
          f"{ctr['service.pack_s']:.3f} s, the lanes' dispatches "
          f"{lane_busy} s; device idle share {idle} (1 - mean "
          f"nvidia-smi utilization over the service's wall)", flush=True)
    if not same:
        fail("a run's dict through the service differs from in-process")
    if any(r["valid?"] is not (i < SVC_SEEDS) for i, r in enumerate(got)):
        fail(f"campaign verdicts {[r['valid?'] for r in got]}: clean runs "
             f"must be valid, stale-read runs not")
    if fallbacks or ctr.get("service.bad_requests"):
        fail(f"service fallbacks {fallbacks}, bad requests "
             f"{ctr.get('service.bad_requests')}")
    if shipped != ctr["service.submitted"] or shipped != n_keys:
        fail(f"shipped {shipped}, submitted {ctr['service.submitted']}, "
             f"keys {n_keys}")
    if sum(disp.values()) != ctr["service.group_ticks"] + \
            ctr.get("service.shard_fanout", 0):
        fail(f"per-lane ledger {disp} against {ctr}")
    if svc.shutdown_leaked_threads:
        fail("the service leaked threads at shutdown")

    # -- the packs again, over one and two lanes of the card ------------
    t0 = time.perf_counter()
    run_packs = []
    for s in subs:
        packed = wgl.pack_register_histories_batched(s)
        run_packs.append([packed[k] for k in s])
    pack_s = (time.perf_counter() - t0) / len(runs)
    ser, wire = [], []
    for packs in run_packs:
        t0 = time.perf_counter()
        wire.append(sum(len(wgl.serialize_packed(p)) for p in packs))
        ser.append(time.perf_counter() - t0)
    print(f"service device use on {card}: wgl_wave launches by the "
          f"service {svc_launches} (its ledger; the process counted "
          f"{main_launches}) against {local_launches} in-process (one "
          f"per run per group); pack {pack_s:.4f} s a run (batched "
          f"packer, 4 keys), serialize {statistics.median(ser):.4f} s a "
          f"run (median), {statistics.median(wire):.0f} bytes a run",
          flush=True)
    if svc_launches != main_launches or not 1 <= svc_launches <= \
            local_launches:
        fail(f"wgl_wave launches: service {svc_launches}, process "
             f"{main_launches}, in-process {local_launches}")
    camp = [p for packs in run_packs for p in packs]
    long_h = generate_for_opts(dict(SIM_SINGLE_OPTS, gen_epoch="epoch-v3"),
                               list(range(SVC_LONG_SEEDS)),
                               device=dev)["histories"]
    longs = [p for h in long_h for p in
             wgl.pack_register_histories_batched(h.split_by_key()).values()]
    groups = {wgl.group_key(p) for p in camp + longs}
    one_lane = wgl_mxu.batch_lanes

    def through(n: int, requests: list) -> tuple:
        """Each request through one service over n lanes of the card
        (one after another); returns (dicts per request, stats)."""
        wgl_mxu.batch_lanes = (
            lambda device=None: [torch.device(device)]
            if device is not None else [dev] * n)
        d = tempfile.mkdtemp(prefix="jet-")
        s = svc_mod.CheckerService(path=os.path.join(d, "s.sock"),
                                   tick_s=SVC_TICK_S).start()
        try:
            client = svc_mod.CheckerClient(s.path)
            outs = [client.check(r) for r in requests]
            client.close()
            return outs, s.stats()
        finally:
            s.close()
            shutil.rmtree(d, ignore_errors=True)
            wgl_mxu.batch_lanes = one_lane

    t0 = time.perf_counter()
    (one, one_camp), st1 = through(1, [camp + longs, camp])
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (two, two_camp), st2 = through(2, [camp + longs, camp])
    two_s = time.perf_counter() - t0
    c2 = st2["counters"]
    disp2 = {k[len("service.device_dispatches."):]: v
             for k, v in c2.items()
             if k.startswith("service.device_dispatches.")}
    print(f"service over two lanes of the card ({card}): {len(camp)} "
          f"campaign packs in one group and {len(longs)} packs of the "
          f"simulated single-key cell, {len(groups)} groups: placed "
          f"{st2['placement']}, sticky; then the campaign's group alone, "
          f"split over both lanes ({c2.get('service.sharded_ticks', 0)} "
          f"sharded tick, fan-out {c2.get('service.shard_fanout', 0)}); "
          f"per-lane dispatches {disp2}; wgl_wave launches "
          f"{c2.get('service.wgl_wave_launches')} (one lane: "
          f"{st1['counters'].get('service.wgl_wave_launches')}); walls "
          f"{two_s:.3f} s against {one_s:.3f} s on one lane; dicts = one "
          f"lane's: {two == one and two_camp == one_camp == one[:len(camp)]}",
          flush=True)
    if None in (one, two, one_camp, two_camp) or two != one or \
            two_camp != one_camp or one_camp != one[:len(camp)]:
        fail("the service's dicts over two lanes differ from one lane's")
    if len(groups) != 2 or len(set(st2["placement"].values())) != 2 or \
            c2.get("service.sharded_ticks") != 1 or \
            sum(disp2.values()) != c2["service.group_ticks"] + \
            c2["service.shard_fanout"]:
        fail(f"placement over two lanes: {st2['placement']}, {c2}")
    return {"camp": camp, "occupancy": ctr["service.batch_occupancy"],
            "launches": svc_launches}


def same_campaign(got: list, want: list) -> tuple:
    """(equal, relabelled): whether each run's dict through the service
    equals its in-process dict. A key the ladder answered may have
    ridden another group in the service's tick than in its own run (the
    batched rung, not a lone climb), so for those keys the rung labels
    and the peak frontier are set aside and the verdict and the depth
    compared; ``relabelled`` counts them."""
    drop = ("rungs", "engine", "batched", "peak-frontier")

    def norm(res: dict) -> tuple:
        res = json.loads(json.dumps(res, default=repr))
        n = 0
        for key_res in res.get("results", {}).values():
            lin = key_res.get("linear", {})
            if lin.get("engine") == "jnp-ladder" or lin.get("batched"):
                n += 1
                for k in drop:
                    lin.pop(k, None)
        return res, n

    pairs = [(norm(a), norm(b)) for a, b in zip(got, want)]
    return (all(a[0] == b[0] for a, b in pairs),
            sum(a[1] for a, _ in pairs))


def service_phase(card: str, dev) -> list:
    """The service campaign (``service_campaign``), then the kernels as
    it runs them: wgl_wave at a tick's shape (the largest tick's count
    of the campaign's keys in one launch) held exactly against its plain
    version and timed, and the sharded batched rung (B3's sharded form,
    PyTorch ops: each lane's keys on a thread and a stream of its own)
    over two lanes of the card, held against the unsharded rung and
    timed, with each key's waves. Returns the kernels line's entries."""
    import numpy as np
    import torch
    from jepsen_etcd_tpu_torch.ops import wgl, wgl_mxu

    res = service_campaign(card, dev)
    camp = res["camp"]
    # wgl_wave at a tick's shape
    k = max(1, min(int(res["occupancy"]), len(camp)))
    tick = camp[:k]
    k_pad = wgl_mxu._batch_geometry(k, 1)[0]
    tab, scal, wk = tables_for(tick, dev, k_pad)
    b1_ms = cuda_ms(lambda: wgl_mxu.wave_search(tab, scal, wk), 11)
    got = wgl_mxu.wave_search(tab, scal, wk).cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = wgl_mxu.wave_search_reference(tab, scal, wk)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ref = ref.cpu().numpy()
    b1_err = int(np.abs(got.astype(np.int64) - ref).max())
    waves = int(ref[:k, 3].sum())
    bound, bytes_ms, ops_ms = wgl_bound(
        waves, (tab.shape[2] + scal.shape[2]) * 4, k, wk)
    print(f"wgl_wave at the service's tick shape on {card}: {k} keys "
          f"(k_pad {k_pad}, r_pad {tab.shape[1]}, wk {wk}) in one launch "
          f"{b1_ms:.3f} ms (median of 11, CUDA events), plain "
          f"{plain_ms:.1f} ms, {waves} waves in all, bound {bound:.4f} ms "
          f"(bytes {bytes_ms:.4f} ms, operations {ops_ms:.4f} ms); "
          f"max_abs_err {b1_err}", flush=True)
    if b1_err:
        fail("wgl_wave disagrees with its plain version at the tick shape")
    del tab, scal

    # the sharded rung over two lanes of the card, against its plain
    # version (the unsharded rung as PyTorch ops: the rung kernel's route
    # off) and against the unsharded rung in the kernel
    rung = camp[:SVC_RUNG_KEYS]
    one_lane = wgl_mxu.batch_lanes
    kernel_max = wgl.RUNG_KERNEL_F_MAX
    walls = {}
    try:
        for route, f_max in (("plain", 0), ("one lane", kernel_max)):
            wgl.RUNG_KERNEL_F_MAX = f_max
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = wgl.check_packed_batch(rung, try_fused=False, device=dev)
            torch.cuda.synchronize()
            walls[route] = time.perf_counter() - t0
            outs = [{k: v for k, v in o.items() if k != "_resume"}
                    for o in outs]
            if route == "plain":
                want = outs
            elif outs != want:
                fail(f"the unsharded rung in the kernel {outs} != as "
                     f"PyTorch ops {want}")
    finally:
        wgl.RUNG_KERNEL_F_MAX = kernel_max
    plain_s = walls["plain"]
    wgl_mxu.batch_lanes = lambda device=None: (
        [torch.device(device)] if device is not None else [dev, dev])
    try:
        wgl.SHARDED_LAUNCHES = wgl.RUNG_KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        sharded = wgl.check_packed_batch(rung, try_fused=False,
                                         shard=True)
        torch.cuda.synchronize()
        rung_s = time.perf_counter() - t0
        rung_launches = wgl.SHARDED_LAUNCHES
        in_kernel = wgl.RUNG_KERNEL_LAUNCHES
    finally:
        wgl_mxu.batch_lanes = one_lane
    strip = [{k: v for k, v in o.items() if k != "_resume"}
             for o in want]
    sharded = [{k: v for k, v in o.items() if k != "_resume"}
               for o in sharded]
    rung_err = max(abs(a.get(f, 0) - b.get(f, 0))
                   for a, b in zip(sharded, strip)
                   for f in ("waves", "peak-frontier"))
    rung_waves = [o.get("waves") for o in sharded]
    key = wgl.group_key(rung[0])
    tables = wgl.prepare_bucket_group(rung, list(range(len(rung))),
                                      key[0], key[1])
    rung_bytes = sum(a[:len(rung)].nbytes for a in tables.stacked.values())
    rbytes_ms = rung_bytes / HBM_BYTES_PER_S * 1e3
    rops_ms = (sum(rung_waves) * 128 * key[2] * WGL_OPS_PER_CANDIDATE
               / ALU32_OPS_PER_S * 1e3)
    print(f"sharded batched rung on {card}: {len(rung)} campaign keys at "
          f"rung 128 (kernel not run: try_fused=False) split over two "
          f"lanes of the card, {rung_launches} lane launches, "
          f"{in_kernel} rung runs in the rung kernel: "
          f"{rung_s:.3f} s; the unsharded rung on one lane in the kernel "
          f"{walls['one lane']:.3f} s, as PyTorch ops (its plain version) "
          f"{plain_s:.3f} s; waves a key {rung_waves} "
          f"({rung_s / max(1, max(rung_waves)) * 1e3:.3f} ms a wave of "
          f"the longest lane); bound {max(rbytes_ms, rops_ms):.4f} ms "
          f"(operations: {sum(rung_waves)} waves x 128 states x "
          f"{key[2]} ops x {WGL_OPS_PER_CANDIDATE}: {rops_ms:.4f} ms; "
          f"bytes: {rung_bytes} of tables {rbytes_ms:.4f} ms); dicts = "
          f"unsharded: {sharded == strip}", flush=True)
    if sharded != strip or rung_launches != 2 or \
            not all(o.get("batched") for o in sharded):
        fail(f"sharded rung {sharded} != unsharded {strip}")
    return [{"name": "wgl_wave_service", "route": "cuda",
             "source": "jepsen_etcd_tpu_torch/csrc/wgl_wave.cu",
             "replaces": "jepsen_etcd_tpu/ops/wgl_mxu.py:902",
             "launches": res["launches"], "max_abs_err": b1_err,
             "ms": b1_ms, "plain_ms": plain_ms, "bound_ms": bound,
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
             "library_ms": None},
            {"name": "wgl_rung_sharded",
             "route": "cuda" if in_kernel else "torch",
             "source": "jepsen_etcd_tpu_torch/csrc/wgl_rung.cu" if in_kernel
             else "jepsen_etcd_tpu_torch/ops/wgl.py",
             "replaces": "jepsen_etcd_tpu/ops/wgl.py:1966",
             "launches": rung_launches, "max_abs_err": rung_err,
             "ms": rung_s * 1e3, "plain_ms": plain_s * 1e3,
             "bound_ms": max(rbytes_ms, rops_ms),
             "bound_by": "bytes" if rbytes_ms >= rops_ms
             else "operations", "library_ms": None}]


def runner_phase(card: str, dev) -> dict:
    """The ``test`` entry point on the card: (a) the BASELINE register
    configuration through ``cli.main`` (the kernel's launches counted,
    every key's verdict held against the native DFS, wgl_wave at the
    run's batch held against its plain version and timed), (b) stale
    reads through ``run_test(etcd_test(...))`` with force_kernel, (c)
    the watch workload (indel_bits launched, the dict equal to the plain
    versions' on the CPU) and (d) list-append (a ``closure.device``
    span, on_cycle held against scipy's strongly connected components).
    Returns the wave kernel's launches and error for the kernels line."""
    import shutil
    import tempfile
    import numpy as np
    import scipy.sparse as sp
    import torch
    from scipy.sparse.csgraph import connected_components
    from jepsen_etcd_tpu_torch import cli
    from jepsen_etcd_tpu_torch.checkers import watch
    from jepsen_etcd_tpu_torch.checkers.elle import graph
    from jepsen_etcd_tpu_torch.checkers.linearizable import check_history
    from jepsen_etcd_tpu_torch.checkers.tpu_linearizable import CPU_CUTOFF
    from jepsen_etcd_tpu_torch.compose import etcd_test
    from jepsen_etcd_tpu_torch.models import VersionedRegister
    from jepsen_etcd_tpu_torch.ops import edit_distance as ed
    from jepsen_etcd_tpu_torch.ops import wgl, wgl_mxu
    from jepsen_etcd_tpu_torch.runner.test_runner import run_test

    store = tempfile.mkdtemp(prefix="chip-smoke-runner-")
    # the readers phase serves this store and removes it
    atexit.register(shutil.rmtree, store, True)
    try:
        # -- (a) the BASELINE configuration through the CLI --------------
        runs = []
        run_test_cli = cli.run_test

        def keep(test):
            out = run_test_cli(test)
            runs.append((test, out))
            return out
        cli.run_test = keep
        try:
            torch.cuda.synchronize()
            wgl_mxu.LAUNCHES = 0
            t0 = time.perf_counter()
            rc = cli.main(RUNNER_ARGV + ["--store", store])
            wall = time.perf_counter() - t0
            launches = wgl_mxu.LAUNCHES
        finally:
            cli.run_test = run_test_cli
        test, out = runs[0]
        res = out["results"]
        lin = {k: r["linear"] for k, r in res["workload"]["results"].items()}
        subs = out["history"].split_by_key()
        big = sorted(k for k in subs if len(subs[k]) > CPU_CUTOFF)
        bad_keys = [k for k in subs
                    if check_history(VersionedRegister(), subs[k])["valid?"]
                    is not lin[k]["valid?"]]
        engines = {}
        for k in subs:
            engines.setdefault(str(lin[k].get("engine")), []).append(k)
        phases = res["telemetry"]["phases"]
        for f in ("history.jsonl", "results.json", "test.json",
                  "timeline.html", "n1/etcd.log"):
            if not os.path.exists(os.path.join(out["dir"], f)):
                fail(f"the test command wrote no {f}")
        # wgl_wave at the run's batch: held against its plain version
        # and timed, one launch per (r_pad, wk) group of the keys it took
        groups = b1_groups(wgl.pack_register_histories_batched(
            {k: subs[k] for k in big}))
        b1_ms, plain_ms, err, waves, bound = 0.0, 0.0, 0, 0, 0.0
        for gp in groups.values():
            tab, scal, wk = tables_for(gp, dev,
                                       wgl_mxu._batch_geometry(len(gp), 1)[0])
            b1_ms += cuda_ms(lambda: wgl_mxu.wave_search(tab, scal, wk), 11)
            got = wgl_mxu.wave_search(tab, scal, wk).cpu().numpy()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = wgl_mxu.wave_search_reference(tab, scal, wk).cpu().numpy()
            plain_ms += (time.perf_counter() - t0) * 1e3
            err = max(err, int(np.abs(got.astype(np.int64) - ref).max()))
            gw = int(ref[:len(gp), 3].sum())
            waves += gw
            bound += wgl_bound(gw, (tab.shape[2] + scal.shape[2]) * 4,
                               len(gp), wk)[0]
        print(f"runner (a) on {card}: python -m jepsen_etcd_tpu_torch "
              f"{' '.join(RUNNER_ARGV)}: exit {rc}, valid?={out['valid?']}, "
              f"{len(out['history'])} ops, {len(subs)} keys ({len(big)} past "
              f"CPU_CUTOFF = {CPU_CUTOFF}), {out['sim-seconds']:.1f} sim-s, "
              f"wall {wall:.3f} s (generate {phases['generate']:.3f} s, "
              f"check {phases['check']:.3f} s); wgl_wave launches "
              f"{launches}, engines {engines}; every key's verdict = "
              f"native DFS: {not bad_keys}; wgl_wave at the run's batch "
              f"({len(groups)} group(s), {waves} waves) {b1_ms:.3f} ms "
              f"(CUDA events, median of 11), plain {plain_ms:.1f} ms, "
              f"bound {bound:.4f} ms, max_abs_err {err}; device idle share "
              f"of the check {1 - b1_ms / 1e3 / phases['check']:.4f} and "
              f"of the run {1 - b1_ms / 1e3 / wall:.4f} (1 - wgl_wave / "
              f"wall); the checkers' seconds " + ", ".join(
                  f"{k} {v:.4f}" for k, v in
                  res["telemetry"]["checkers"].items())
              + "; perf plots: " + ("plot-error" if "plot-error" in
                                    res["perf"] else
                                    str(res["perf"].get("plots"))),
              flush=True)
        if rc != 0 or out["valid?"] is not True:
            fail(f"runner (a): exit {rc}, valid? {out['valid?']}")
        if len(big) < RUNNER_MIN_KEYS or launches < 1 or \
                sorted(engines.get("mxu-wave", [])) != big:
            fail(f"runner (a): keys past the cutoff {big}, wgl_wave "
                 f"launches {launches}, engines {engines}")
        if bad_keys or err:
            fail(f"runner (a): keys {bad_keys} differ from the native "
                 f"DFS, max_abs_err {err}")
        # the post-hoc twin of the stream phase's streamed run
        with open(os.path.join(out["dir"], "history.jsonl"), "rb") as f:
            baseline = {"history": f.read(), "workload": res["workload"],
                        "b1_ms": b1_ms, "groups": len(groups),
                        "phases": phases}

        # -- (b) stale reads, every key device-bound -----------------------
        torch.cuda.synchronize()
        wgl_mxu.LAUNCHES = 0
        t0 = time.perf_counter()
        sout = run_test(etcd_test(dict(RUNNER_STALE, store_base=store)))
        swall = time.perf_counter() - t0
        stale_launches = wgl_mxu.LAUNCHES
        slin = {k: r["linear"]
                for k, r in sout["results"]["workload"]["results"].items()}
        ssubs = sout["history"].split_by_key()
        dfs_false = sorted(
            k for k in ssubs
            if check_history(VersionedRegister(), ssubs[k])["valid?"]
            is False)
        got_false = sorted(k for k in ssubs
                           if slin[k]["valid?"] is False)
        print(f"runner (b) on {card}: stale reads, {len(sout['history'])} "
              f"ops, {len(ssubs)} keys: valid?={sout['valid?']}, failing "
              f"keys {got_false}, native DFS {dfs_false}; wgl_wave "
              f"launches {stale_launches}; wall {swall:.3f} s", flush=True)
        if sout["valid?"] is not False or got_false != dfs_false or \
                stale_launches < 1:
            fail("runner (b): stale reads not caught as the native DFS "
                 "catches them")

        # -- (c) watch -----------------------------------------------------
        torch.cuda.synchronize()
        ed.LAUNCHES = 0
        t0 = time.perf_counter()
        wtest = etcd_test(dict(RUNNER_WATCH, store_base=store))
        wout = run_test(wtest)
        wwall = time.perf_counter() - t0
        watch_launches = ed.LAUNCHES
        logs = watch.per_thread_logs(wtest, wout["history"])
        plain = watch.WatchChecker(device="cpu").check(wtest,
                                                       wout["history"])
        wres = wout["results"]["workload"]
        wph = wout["results"]["telemetry"]["phases"]
        print(f"runner (c) on {card}: watch, {len(wout['history'])} ops, "
              f"{wout['sim-seconds']:.1f} sim-s: valid?={wout['valid?']}, "
              f"{len(logs)} logs of {min(map(len, logs.values()))}-"
              f"{max(map(len, logs.values()))} values; indel_bits launches "
              f"{watch_launches}; dict = the plain versions' on the CPU: "
              f"{wres == plain}; wall {wwall:.3f} s (generate "
              f"{wph['generate']:.3f} s, check {wph['check']:.3f} s)",
              flush=True)
        if wout["valid?"] is not True or watch_launches < 1 or \
                wres != plain or \
                min(map(len, logs.values())) < ed.CPU_CUTOFF:
            fail(f"runner (c): watch {wres}, launches {watch_launches}")

        # -- (d) list-append -----------------------------------------------
        seen = []
        levels = graph.closure_levels_lazy

        def capture(et_edges, lvl_mask, n, rt_vecs, densify, **kw):
            reach_fn, on_cycle = levels(et_edges, lvl_mask, n, rt_vecs,
                                        densify, **kw)
            seen.append((densify, on_cycle))
            return reach_fn, on_cycle
        graph.closure_levels_lazy = capture
        try:
            t0 = time.perf_counter()
            aout = run_test(etcd_test(dict(RUNNER_APPEND,
                                           store_base=store)))
            awall = time.perf_counter() - t0
        finally:
            graph.closure_levels_lazy = levels
        ares = aout["results"]["workload"]
        spans = aout["results"]["telemetry"]["spans"]
        scc_bad = 0
        for densify, on_cycle in seen:
            adj = densify()
            for b in range(adj.shape[0]):
                _, labels = connected_components(
                    sp.csr_matrix(adj[b]), directed=True,
                    connection="strong")
                want = (np.bincount(labels)[labels] >= 2) | adj[b].diagonal()
                scc_bad += int((want != on_cycle[b]).sum())
        print(f"runner (d) on {card}: list-append, "
              f"{len(aout['history'])} ops, {ares.get('committed-count')} "
              f"committed txns: valid?={aout['valid?']}; closure.device "
              f"span: {'closure.device' in spans}; {len(seen)} closure(s) "
              f"held against scipy's SCCs: {scc_bad} nodes differ; wall "
              f"{awall:.3f} s", flush=True)
        if aout["valid?"] is not True or "closure.device" not in spans \
                or not seen or scc_bad:
            fail(f"runner (d): append {ares}")
    except BaseException:
        shutil.rmtree(store, ignore_errors=True)
        raise
    return {"launches": launches + stale_launches, "max_abs_err": err,
            "baseline": baseline, "store": store,
            "runs": [out["dir"], sout["dir"], wout["dir"], aout["dir"]]}


#: the epoch-v3 set histories of stream (b), read by its forked workers
_SET_HISTORIES = []


def set_reference(sd: int) -> tuple:
    """A forked worker's job in stream (b): ``_analyze_reference`` on
    seed ``sd``'s history (pure Python, no card) and its seconds."""
    from jepsen_etcd_tpu_torch.checkers.set_full import _analyze_reference
    from jepsen_etcd_tpu_torch.core.history import History
    t0 = time.perf_counter()
    want = _analyze_reference(History(_SET_HISTORIES[sd].ops))
    return want, time.perf_counter() - t0


def no_wall(x):
    """``x`` without the keys that read a host clock (WALL_KEYS)."""
    if isinstance(x, dict):
        return {k: no_wall(v) for k, v in x.items()
                if not any(w in str(k) for w in WALL_KEYS)}
    if isinstance(x, (list, tuple)):
        return [no_wall(v) for v in x]
    return x


def as_json(x):
    """``x`` without its wall-clock keys, through a JSON round trip."""
    return json.loads(json.dumps(no_wall(x), sort_keys=True, default=repr))


def differences(a, b, path=()) -> list:
    """(path, a's value, b's value) of every leaf where two JSON values
    differ, in key order."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = []
        for k in sorted(set(a) | set(b)):
            out += differences(a.get(k), b.get(k), path + (k,))
        return out
    return [] if a == b else [(path, a, b)]


def reread_differences(stored: dict, reread: dict, subs: dict) -> tuple:
    """Whether a register run's stored workload dict ``stored`` and its
    dict on history.jsonl re-read, ``reread``, differ only as C6 leaves
    them (ROADMAP.md): a key with no read, as a time limit can cut a
    run's last key to a lone write, counts its writes in session.writes
    on the run's column-backed history and 0 on the re-read one, in the
    reference as in the port. ``subs`` is the run's history by key.
    Returns (that, every difference)."""
    no_read = {str(k) for k, sub in subs.items()
               if not any(op.get("f") == "read" for op in sub.ops)}
    diffs = differences(as_json(stored), as_json(reread))
    return all(len(p) == 4 and p[0] == "results" and p[1] in no_read
               and p[2:] == ("session", "writes") and a >= 1 and b == 0
               for p, a, b in diffs), diffs


def same_json(a, b) -> bool:
    return json.dumps(no_wall(a), sort_keys=True, default=repr) == \
        json.dumps(no_wall(b), sort_keys=True, default=repr)


def b1_groups(packs: dict) -> dict:
    """The packs wgl_wave takes, by (r_pad, wk) group, as
    ``launch_packed_batch_mxu`` groups them: one launch each."""
    from jepsen_etcd_tpu_torch.ops import wgl, wgl_mxu
    groups = {}
    for p in packs.values():
        if wgl_mxu.supported(p):
            groups.setdefault((max(wgl.bucket(p.R), wgl_mxu.TSUB), p.w),
                              []).append(p)
    return groups


def b1_batch_ms(packs: dict, dev) -> tuple:
    """wgl_wave over the keys it takes, one launch per group: device ms
    (CUDA events, median of 11, summed over groups) and the group
    count."""
    from jepsen_etcd_tpu_torch.ops import wgl_mxu
    groups = b1_groups(packs)
    ms = 0.0
    for gp in groups.values():
        tab, scal, wk = tables_for(gp, dev,
                                   wgl_mxu._batch_geometry(len(gp), 1)[0])
        ms += cuda_ms(lambda: wgl_mxu.wave_search(tab, scal, wk), 11)
    return ms, len(groups)


def stream_phase(card: str, dev, baseline: dict) -> dict:
    """Streaming, the set workload, and the lock and MVCC workloads on
    the card: (a) the BASELINE command with ``--stream`` through
    ``cli.main``, held against the runner phase's post-hoc run of the
    same seed (history bytes, the workload's dict) with every key B1
    took checked from a streamed pack (``stream.pack_reuse``); (b) the
    reference's set cell with ``--stream`` (the ``set_scan`` hint
    installed and used, the dict equal to the same history checked
    post-hoc), then epoch-v3 set histories generated on the card, each
    ``SetFull`` verdict held against ``_analyze_reference`` (run in
    SET_REF_WORKERS processes while the card checks); (c) lock
    with force_kernel decided by wgl_wave through the Mutex adapter (its
    verdict = the Python DFS's), lock-set and lock-etcd-set; (d) the
    MVCC workloads clean, then each with its injection hook caught.
    Returns the launches of wgl_wave (single and batched) and of the
    draws, and wgl_wave's error on the lock's pack, for the kernels
    line."""
    import shutil
    import tempfile
    import torch
    from jepsen_etcd_tpu_torch import cli
    from jepsen_etcd_tpu_torch.checkers.linearizable import check_history
    from jepsen_etcd_tpu_torch.checkers.set_full import (
        SetFull, _analyze_reference, analyze)
    from jepsen_etcd_tpu_torch.compose import etcd_test
    from jepsen_etcd_tpu_torch.core.history import History
    from jepsen_etcd_tpu_torch.models import Mutex
    from jepsen_etcd_tpu_torch.ops import wgl, wgl_mxu
    from jepsen_etcd_tpu_torch.runner.campaign import (campaign_specs,
                                                       run_campaign)
    from jepsen_etcd_tpu_torch.runner.test_runner import run_test
    from jepsen_etcd_tpu_torch.simbatch import engine_v3, generate_for_opts

    store = tempfile.mkdtemp(prefix="chip-smoke-stream-")
    runs = []
    run_test_cli = cli.run_test

    def keep(test):
        out = run_test_cli(test)
        runs.append((test, out))
        return out
    cli.run_test = keep
    try:
        # -- (a) the BASELINE command, streamed ---------------------------
        torch.cuda.synchronize()
        wgl_mxu.LAUNCHES = 0
        t0 = time.perf_counter()
        rc = cli.main(STREAM_ARGV + ["--store", store])
        wall = time.perf_counter() - t0
        batch_launches = wgl_mxu.LAUNCHES
        test, out = runs[-1]
        hints = test.get("_stream") or {}
        tel = out["results"]["telemetry"]
        ctr, phases = tel["counters"], tel["phases"]
        with open(os.path.join(out["dir"], "history.jsonl"), "rb") as f:
            same_bytes = f.read() == baseline["history"]
        same_dict = same_json(out["results"]["workload"],
                              baseline["workload"])
        took = sorted(str(k) for k, r in
                      out["results"]["workload"]["results"].items()
                      if r["linear"].get("engine") == "mxu-wave")
        reuse = ctr.get("stream.pack_reuse", 0)
        packs = (hints.get("register_packs") or ({}, 0))[0]
        b1_ms, n_groups = b1_batch_ms(
            {k: packs[k] for k in packs if str(k) in took}, dev)
        print(f"stream (a) on {card}: python -m jepsen_etcd_tpu_torch "
              f"{' '.join(STREAM_ARGV)}: exit {rc}, valid?="
              f"{out['valid?']}, {len(out['history'])} ops; hints "
              f"{sorted(hints)}; stream.chunks {ctr.get('stream.chunks')}, "
              f"stream.pack_reuse {reuse} (keys wgl_wave took: "
              f"{len(took)}), stream.backlog_peak "
              f"{ctr.get('stream.backlog_peak')}; phases generate "
              f"{phases['generate']:.3f} s, stream-finalize "
              f"{phases.get('stream-finalize', 0.0):.4f} s, check "
              f"{phases['check']:.3f} s (post-hoc twin: generate "
              f"{baseline['phases']['generate']:.3f} s, check "
              f"{baseline['phases']['check']:.3f} s); wall {wall:.3f} s; "
              f"wgl_wave launches {batch_launches}, {b1_ms:.3f} ms on the "
              f"streamed packs ({n_groups} group(s), CUDA events, median "
              f"of 11; post-hoc {baseline['b1_ms']:.3f} ms); history "
              f"bytes = post-hoc: {same_bytes}; workload dict = post-hoc: "
              f"{same_dict}", flush=True)
        if rc != 0 or out["valid?"] is not True or not same_bytes or \
                not same_dict:
            fail(f"stream (a): exit {rc}, valid? {out['valid?']}, bytes "
                 f"equal {same_bytes}, dict equal {same_dict}")
        if "register_packs" not in hints or not took or \
                reuse != len(took):
            fail(f"stream (a): hints {sorted(hints)}, pack_reuse {reuse} "
                 f"for {len(took)} keys: the run repacked instead of "
                 f"reusing the streamed packs")
        if batch_launches < 1 or not n_groups:
            fail(f"stream (a): wgl_wave launches {batch_launches}, "
                 f"{n_groups} group(s)")

        # -- (b) the set cell, streamed; epoch-v3 set ---------------------
        t0 = time.perf_counter()
        rc = cli.main(SET_ARGV + ["--store", store])
        wall = time.perf_counter() - t0
        test, out = runs[-1]
        hints = test.pop("_stream", None) or {}
        tel = out["results"]["telemetry"]
        ctr, phases = tel["counters"], tel["phases"]
        streamed = out["results"]["workload"]
        t0 = time.perf_counter()
        post = test["checker"].checkers["workload"].check(
            test, out["history"], {})
        post_s = time.perf_counter() - t0
        values = sum(len(o.get("value") or ()) for o in out["history"].ops
                     if o.get("f") == "read" and o.get("type") == "ok")
        print(f"stream (b) on {card}: python -m jepsen_etcd_tpu_torch "
              f"{' '.join(SET_ARGV)}: exit {rc}, valid?={out['valid?']}, "
              f"{len(out['history'])} ops, {values} observed values; "
              f"hints {sorted(hints)}, stream.set_scan_reuse "
              f"{ctr.get('stream.set_scan_reuse')}, stream.chunks "
              f"{ctr.get('stream.chunks')}; set_full "
              f"{tel['checkers']['workload']:.4f} s streamed, "
              f"{post_s:.4f} s post-hoc on "
              f"the same history; dict = post-hoc: "
              f"{same_json(streamed, post)}; phases generate "
              f"{phases['generate']:.3f} s, check {phases['check']:.3f} s; "
              f"wall {wall:.3f} s", flush=True)
        if rc != 0 or streamed.get("valid?") is not True or \
                "set_scan" not in hints or \
                not ctr.get("stream.set_scan_reuse") or \
                not same_json(streamed, post):
            fail(f"stream (b): exit {rc}, hints {sorted(hints)}, dicts "
                 f"equal {same_json(streamed, post)}")
        del out, test, post, streamed
        runs.clear()
        torch.cuda.synchronize()
        engine_v3.DRAW_LAUNCHES = 0
        t0 = time.perf_counter()
        gen = generate_for_opts(dict(SET_V3_OPTS), range(GEN_SEEDS),
                                device=dev)
        gen_s = time.perf_counter() - t0
        draw_launches = engine_v3.DRAW_LAUNCHES
        check_s = ref_s = 0.0
        verdicts, bad = [], []
        t_ref = time.perf_counter()
        _SET_HISTORIES[:] = gen["histories"]
        with concurrent.futures.ProcessPoolExecutor(
                SET_REF_WORKERS,
                mp_context=multiprocessing.get_context("fork")) as pool:
            wants = [pool.submit(set_reference, sd)
                     for sd in range(len(_SET_HISTORIES))]
            for sd, h in enumerate(gen["histories"]):
                t0 = time.perf_counter()
                res = SetFull(linearizable=True).check({}, h)
                check_s += time.perf_counter() - t0
                verdicts.append(res["valid?"])
                want, secs = wants[sd].result()
                ref_s += secs
                if analyze(h) != want:
                    bad.append(sd)
        _SET_HISTORIES.clear()
        ref_wall = time.perf_counter() - t_ref
        print(f"stream (b) epoch-v3 set on {card}: {GEN_SEEDS} seeds at "
              f"{SET_V3_OPTS}: generated in {gen_s:.3f} s (draws launched "
              f"{draw_launches} time(s)), {sum(map(len, gen['histories']))} "
              f"ops; SetFull {check_s:.3f} s in all, _analyze_reference "
              f"{ref_s:.3f} s in all ({SET_REF_WORKERS} processes; the "
              f"holds' wall {ref_wall:.3f} s); verdicts "
              f"{sorted(set(map(str, verdicts)))}; "
              f"seeds whose analysis differs from the reference "
              f"sweep's: {bad}", flush=True)
        if gen["epoch"] != "epoch-v3" or draw_launches < 1 or bad or \
                any(v is not True for v in verdicts):
            fail(f"stream (b): epoch-v3 set, epoch {gen['epoch']}, draws "
                 f"{draw_launches}, differing seeds {bad}, verdicts "
                 f"{verdicts}")
        del gen

        # -- (c) lock, lock-set, lock-etcd-set ----------------------------
        single_launches = 0
        for wl, extra in LOCK_RUNS:
            torch.cuda.synchronize()
            wgl_mxu.LAUNCHES = 0
            t0 = time.perf_counter()
            out = run_test(etcd_test(dict(extra, workload=wl,
                                          store_base=store)))
            lwall = time.perf_counter() - t0
            n = wgl_mxu.LAUNCHES
            h = out["history"]
            res = out["results"]["workload"]
            if wl == "lock":
                single_launches += n
                lin = res["linear"]
                dfs = check_history(Mutex(False), h)["valid?"]
                # wgl_wave on the lock's Mutex pack: timed, held against
                # its plain version
                tab, scal, wk = tables_for([wgl.pack_mutex_history(h)], dev)
                lock_ms = cuda_ms(
                    lambda: wgl_mxu.wave_search(tab, scal, wk), 11)
                t0 = time.perf_counter()
                want = wgl_mxu.wave_search_reference(tab, scal, wk)
                torch.cuda.synchronize()
                lock_plain_ms = (time.perf_counter() - t0) * 1e3
                got = wgl_mxu.wave_search(tab, scal, wk)
                lock_err = int((got.long() - want.long()).abs().max())
                lock_bound = wgl_bound(
                    int(want[0, 3]), (tab.shape[2] + scal.shape[2]) * 4, 1,
                    wk)[0]
                print(f"stream (c) on {card}: lock, force_kernel, "
                      f"{len(h)} ops: valid?={out['valid?']} engine="
                      f"{lin.get('engine')} waves={lin.get('waves')} "
                      f"peak-frontier={lin.get('peak-frontier')}; "
                      f"wgl_wave launches {n}, {lock_ms:.3f} ms on the "
                      f"Mutex pack (CUDA events, median of 11; wk {wk}), "
                      f"plain {lock_plain_ms:.1f} ms, bound "
                      f"{lock_bound:.5f} ms, max_abs_err {lock_err}; "
                      f"Python DFS valid?={dfs}; wall {lwall:.3f} s",
                      flush=True)
                if lin.get("engine") != "mxu-wave" or n < 1 or \
                        lin["valid?"] is not dfs or lock_err:
                    fail(f"stream (c): lock {lin}, launches {n}, DFS {dfs}, "
                         f"max_abs_err {lock_err}")
            else:
                same = analyze(h) == _analyze_reference(History(h.ops))
                print(f"stream (c) on {card}: {wl}, {len(h)} ops: "
                      f"valid?={out['valid?']} (set {res['set']['valid?']}, "
                      f"lost {res['set']['lost-count']}); analysis = the "
                      f"reference sweep's: {same}; wall {lwall:.3f} s",
                      flush=True)
                if not same or res["set"]["valid?"] is not True:
                    fail(f"stream (c): {wl} {res['set']}")

        # -- (d) the MVCC workloads, clean and injected --------------------
        for wl, (key, flag, klass) in MVCC_INJECT.items():
            t0 = time.perf_counter()
            rc = cli.main(["test", "-w", wl, "--store", store])
            mwall = time.perf_counter() - t0
            test, out = runs[-1]
            sub = out["results"]["workload"][key]
            opts = dict(MVCC_INJECT_BASE, **{flag: True})
            if wl == "register-stale":
                opts["staleness_bound_s"] = 0.5
            t0 = time.perf_counter()
            camp = run_campaign(campaign_specs(opts, [wl], [[]],
                                               runs_per_cell=2, seed0=0),
                                pool=0, service=False, store_base=store,
                                name=f"inject-{wl}", live=False)
            cwall = time.perf_counter() - t0
            classes = set()
            for row in camp["runs"]:
                with open(os.path.join(row["dir"], "results.json")) as f:
                    got = json.load(f)["workload"][key]
                classes |= {v["class"] for v in got.get("violations", ())}
            print(f"stream (d) on {card}: {wl}: clean {len(out['history'])} "
                  f"ops, exit {rc}, valid?={out['valid?']} ({key} "
                  f"{sub['valid?']}), wall {mwall:.3f} s; {flag}: "
                  f"{len(camp['runs'])} runs of the epoch-v3 cell, "
                  f"valid?={camp['valid?']}, rows "
                  f"{[r.get('valid') for r in camp['runs']]}, classes "
                  f"{sorted(classes)}, wall {cwall:.3f} s", flush=True)
            if rc != 0 or out["valid?"] is not True or \
                    camp["valid?"] is not False or classes != {klass} or \
                    any(r.get("valid") is not False for r in camp["runs"]):
                fail(f"stream (d): {wl} clean {sub['valid?']}, injected "
                     f"{camp['valid?']} {sorted(classes)}")
            runs.clear()
    finally:
        cli.run_test = run_test_cli
        shutil.rmtree(store, ignore_errors=True)
    return {"batch": batch_launches, "single": single_launches,
            "draws": draw_launches, "max_abs_err": lock_err}


class ComputeApps:
    """Samples ``nvidia-smi --query-compute-apps`` on a thread: the CUDA
    contexts open on the card while a block runs, one row each (a
    container may show every process under one pid, so rows are counted,
    not pids). ``peak`` is the sample with the most rows, as MiB."""

    def __init__(self, every_s: float = 0.25):
        import threading
        self.every_s = every_s
        self.peak: list = []
        self.pids: set = set()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def sample(self) -> list:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout
        rows = []
        for line in out.splitlines():
            parts = [x.strip() for x in line.split(",")]
            if len(parts) == 2 and parts[0].isdigit():
                rows.append((int(parts[0]), parts[1]))
        return rows

    def _run(self) -> None:
        while not self._stop.is_set():
            rows = self.sample()
            self.pids |= {pid for pid, _ in rows}
            if len(rows) > len(self.peak):
                self.peak = rows
            self._stop.wait(self.every_s)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)

    def text(self) -> str:
        return (f"{len(self.peak)} context(s) at peak, MiB "
                f"{[mib for _, mib in self.peak]}, pids seen "
                f"{sorted(self.pids)} (this process {os.getpid()})")


def projected(results: dict) -> dict:
    return {str(k): {f: (v.get("linear") or {}).get(f) for f in PROJECTION}
            for k, v in results["workload"]["results"].items()}


def recheck(run_dir: str, history=None) -> dict:
    """The run's own register checker, in-process on the card, over its
    stored history (or ``history``, one whose bytes were held equal to
    the stored ones): the projection of every key's verdict."""
    from jepsen_etcd_tpu_torch.core.history import History
    from jepsen_etcd_tpu_torch.workloads.register import workload
    with open(os.path.join(run_dir, "test.json")) as f:
        test = json.load(f)
    test.pop("checker_service", None)
    if history is None:
        with open(os.path.join(run_dir, "history.jsonl")) as f:
            history = History.from_jsonl(f.read())
    return projected({"workload": workload(test)["checker"].check(
        test, history)})


def stored(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "results.json")) as f:
        return projected(json.load(f))


def guided_view(out: dict) -> dict:
    """A guided summary without its timing, paths and device."""
    def no_dev(x):
        if isinstance(x, dict):
            return {k: no_dev(v) for k, v in x.items() if k != "device"}
        if isinstance(x, list):
            return [no_dev(v) for v in x]
        return x
    view = {k: no_dev(v) for k, v in out.items()
            if k not in ("dir", "wall_s", "telemetry", "ledger",
                         "minimized", "name")}
    view["ledger"] = [{k: v for k, v in r.items() if k != "dir"}
                      for r in out["ledger"]]
    view["minimized"] = [{k: v for k, v in m.items()
                          if k not in ("dir", "repro")}
                         for m in out["minimized"]]
    return view


def campaign_phase(card: str, dev) -> dict:
    """The campaign runner on the card (``runner/campaign.py``, ``guided``,
    ``shrink``, ``host_agent``): (a) the reference's amortization cell in
    three arms, the service arm's verdicts held against in-process
    re-checks on the card and its ledger balanced, the CUDA contexts each
    arm opens sampled; (b) the same specs over two worker-agent
    processes, the cross-host ledger balanced; (c) an epoch-v3 campaign,
    its histories held against ``generate_for_opts`` on the card and its
    verdicts against in-process checks; (d) guided search, shrink and
    ``replay`` on the card, the summary held against the same search on
    the CPU. Returns the launches of wgl_wave, the drain and the draws
    made in-process for the kernels line."""
    import shutil
    import tempfile
    import torch
    import hashlib
    from jepsen_etcd_tpu_torch import cli
    from jepsen_etcd_tpu_torch.ops import wgl_mxu
    from jepsen_etcd_tpu_torch.runner.campaign import (campaign_specs,
                                                       run_campaign)
    from jepsen_etcd_tpu_torch.runner.guided import run_guided
    from jepsen_etcd_tpu_torch.simbatch import (engine_v3,
                                                generate_for_opts,
                                                history_sha)

    store = tempfile.mkdtemp(prefix="cs-")
    # the readers phase serves this store and removes it
    atexit.register(shutil.rmtree, store, True)
    launches = {"wgl_wave": 0, "drain": 0, "draws": 0, "store": store}
    try:
        # -- (a) serial, pooled, pooled with the service -----------------
        arms = {}
        for name, pool, service in (("serial", 0, False),
                                    ("pooled", CAMPAIGN_POOL, False),
                                    ("service", CAMPAIGN_POOL, True)):
            specs = campaign_specs(CAMPAIGN_BASE, ["register"],
                                   [[], ["kill"]], runs_per_cell=6,
                                   seed0=31)
            torch.cuda.synchronize()
            wgl_mxu.LAUNCHES = 0
            with ComputeApps() as apps:
                t0 = time.perf_counter()
                out = run_campaign(specs, pool=pool, service=service,
                                   store_base=store, name=name)
                wall = time.perf_counter() - t0
            arms[name] = (out, wall, wgl_mxu.LAUNCHES, apps)
            if not out["valid?"]:
                fail(f"campaign (a) {name}: {out['failures']}")
        serial, svc = arms["serial"][0], arms["service"][0]
        valids = {n: [r["valid"] for r in a[0]["runs"]]
                  for n, a in arms.items()}
        sctr = svc["service"]["counters"]
        svc_disp = int(sctr.get("wgl.dispatches", 0)
                       + sctr.get("mxu.dispatches", 0))
        local = {n: sum(r.get("dispatches", 0) for r in a[0]["runs"])
                 for n, a in arms.items()}
        shipped = sum(r["service_shipped"] for r in svc["runs"])
        bad = [r["index"] for r in svc["runs"]
               if stored(r["dir"]) != recheck(r["dir"])]
        svc_launches = int(sctr.get("service.wgl_wave_launches", 0))
        launches["wgl_wave"] += arms["serial"][2] + arms["service"][2]
        for n, (out, wall, n_launch, apps) in arms.items():
            print(f"campaign (a) {n} on {card}: {out['count']} runs, wall "
                  f"{wall:.3f} s (campaign.json {out['wall_s']} s), "
                  f"dispatches in the runs {local[n]}, wgl_wave launches "
                  f"in this process {n_launch}; CUDA contexts: "
                  f"{apps.text()}", flush=True)
        print(f"campaign (a) service ledger on {card}: submitted "
              f"{sctr.get('service.submitted')}, coalesced "
              f"{sctr.get('service.coalesced')}, ticks "
              f"{sctr.get('service.ticks')}, group_ticks "
              f"{sctr.get('service.group_ticks')}, batch_occupancy "
              f"{sctr.get('service.batch_occupancy')}, fallback "
              f"{sctr.get('service.fallback', 0)}; rows shipped {shipped}; "
              f"service dispatches {svc_disp} (+{local['service']} in the "
              f"runs), wgl_wave launches {svc_launches}; dispatch "
              f"amortization {local['serial'] / max(1, svc_disp + local['service']):.2f} "
              f"(serial dispatches / service's); verdicts = in-process "
              f"re-checks on the card: {not bad}; valid lists equal: "
              f"{valids['serial'] == valids['pooled'] == valids['service']}",
              flush=True)
        if not valids["serial"] == valids["pooled"] == valids["service"]:
            fail(f"campaign (a): valid lists differ {valids}")
        if bad or sctr.get("service.fallback") or \
                shipped != sctr.get("service.submitted") or \
                svc_disp > sctr.get("service.group_ticks", 0) or \
                svc_launches < 1:
            fail(f"campaign (a): runs {bad} differ from re-checks, or the "
                 f"ledger does not balance: {sctr}")

        # -- (b) two worker-agent processes over loopback TCP -----------
        specs = campaign_specs(CAMPAIGN_BASE, ["register"], [[], ["kill"]],
                               runs_per_cell=6, seed0=31)
        wgl_mxu.LAUNCHES = 0
        with ComputeApps() as apps:
            t0 = time.perf_counter()
            hout = run_campaign(specs, pool=0, service=True,
                                hosts=CAMPAIGN_HOSTS, store_base=store,
                                name="hosts")
            hwall = time.perf_counter() - t0
        launches["wgl_wave"] += wgl_mxu.LAUNCHES
        hctr = hout["service"]["counters"]
        hosts = hout["hosts"] or {}
        per_host = {h: (st["shipped"],
                        hctr.get("service.host_submitted." + h))
                    for h, st in hosts.items()}
        hvalid = [r["valid"] for r in hout["runs"]]
        hbad = [r["index"] for r in hout["runs"]
                if stored(r["dir"]) != stored(
                    svc["runs"][r["index"]]["dir"])]
        print(f"campaign (b) on {card}: {CAMPAIGN_HOSTS} worker agents, "
              f"{hout['count']} runs, wall {hwall:.3f} s; per host (rows "
              f"shipped, service.host_submitted) {per_host}; submitted "
              f"{hctr.get('service.submitted')}, group_ticks "
              f"{hctr.get('service.group_ticks')}, requeues "
              f"{hout['agent_requeues']}; verdicts = arm (a)'s: "
              f"{not hbad and hvalid == valids['service']}; CUDA "
              f"contexts: {apps.text()}", flush=True)
        if not hout["valid?"] or len(hosts) != CAMPAIGN_HOSTS or \
                any(a != b for a, b in per_host.values()) or hbad or \
                hvalid != valids["service"]:
            fail(f"campaign (b): ledger {per_host}, runs {hbad}")

        # -- (c) an epoch-v3 campaign through the service ----------------
        v3 = dict(GEN_OPTS, time_limit=SVC_TIME_LIMIT, gen_epoch="epoch-v3")
        specs = campaign_specs(v3, ["register"], [[]],
                               runs_per_cell=SVC_SEEDS, seed0=0)
        torch.cuda.synchronize()
        wgl_mxu.LAUNCHES = 0
        engine_v3.LAUNCHES = engine_v3.DRAW_LAUNCHES = 0
        t0 = time.perf_counter()
        vout = run_campaign(specs, pool=0, service=True, store_base=store,
                            name="v3")
        vwall = time.perf_counter() - t0
        v3_launches = (wgl_mxu.LAUNCHES, engine_v3.LAUNCHES,
                       engine_v3.DRAW_LAUNCHES)
        launches["wgl_wave"] += v3_launches[0]
        launches["drain"] += v3_launches[1]
        launches["draws"] += v3_launches[2]
        direct = generate_for_opts(
            dict(specs[0]["opts"]), list(range(SVC_SEEDS)),
            device=specs[0]["opts"].get("device"))["histories"]
        vbad = []
        for r, h in zip(vout["runs"], direct):
            # the stored bytes are the history's to_jsonl(), which
            # history_sha hashes
            with open(os.path.join(r["dir"], "history.jsonl"), "rb") as f:
                sha = hashlib.sha256(f.read()).hexdigest()
            if sha != history_sha(h) or r["gen-epoch"] != "epoch-v3" or \
                    stored(r["dir"]) != recheck(r["dir"], h):
                vbad.append(r["index"])
        vctr = vout["service"]["counters"]
        gb = vout["genbatch"]
        check_s = sum(r["check_s"] for r in vout["runs"])
        print(f"campaign (c) epoch-v3 on {card}: {vout['count']} runs of "
              f"{vout['runs'][0]['ops']} ops, one batched cell: genbatch "
              f"{gb['events']} events at {gb['ops_per_s']} events/s "
              f"(generation {gb['events'] / gb['ops_per_s']:.3f} s), the "
              f"runs' check {check_s:.3f} s, wall {vwall:.3f} s; service "
              f"ticks {vctr.get('service.ticks')} for {vout['count']} runs, "
              f"submitted {vctr.get('service.submitted')}, coalesced "
              f"{vctr.get('service.coalesced')} (a run's keys share its "
              f"tick: the cell checks one run at a time); drain launches "
              f"{v3_launches[1]}, draws {v3_launches[2]}, wgl_wave "
              f"{v3_launches[0]}; histories = generate_for_opts "
              f"on the card and verdicts = in-process checks: {not vbad}",
              flush=True)
        if not vout["valid?"] or vbad or gb["epoch"] != "epoch-v3" or \
                vctr.get("service.fallback"):
            fail(f"campaign (c): runs {vbad} differ")

        # -- (d) guided search, shrink and replay ------------------------
        t0 = time.perf_counter()
        gout = run_guided(dict(GUIDED_BASE), ["register"], GUIDED_CELLS,
                          budget=12, seed0=7, pool=0, service=False,
                          live=False, store_base=os.path.join(store, "g"),
                          name="hunt")
        gwall = time.perf_counter() - t0
        gcpu = run_guided(dict(GUIDED_BASE, device="cpu"), ["register"],
                          GUIDED_CELLS, budget=12, seed0=7, pool=0,
                          service=False, live=False,
                          store_base=os.path.join(store, "gc"),
                          name="hunt")
        mini = gout["minimized"]
        rc = None
        if mini:
            rc = cli.main(["replay", os.path.join(mini[0]["dir"],
                                                  "shrink.json"),
                           "--device", "cuda"])
        same = guided_view(gout) == guided_view(gcpu)
        print(f"campaign (d) guided on {card}: {gout['runs']} runs in "
              f"{gout['generations']} generations, wall {gwall:.3f} s; "
              f"first failure at run {gout['first_failure_run']}; "
              f"signatures {gout['signatures']}; minimized "
              f"{[(m['original_windows'], m['windows'], m['nemesis_ops']) for m in mini]} "
              f"(windows before, after, nemesis ops); replay --device cuda "
              f"exit {rc}; summary = the CPU's: {same}", flush=True)
        if not gout["first_failure_run"] or \
                gout["first_failure_run"] > 12 or not mini or \
                mini[0]["nemesis_ops"] >= 10 or rc != 0 or not same:
            fail("campaign (d): guided search, shrink or replay")
    except BaseException:
        shutil.rmtree(store, ignore_errors=True)
        raise
    return launches


def corrupt_read(text: str, keys) -> tuple:
    """``text`` (a history.jsonl) with its first ok read of a written
    value on one of ``keys`` changed to a value never written, and that
    read's key."""
    lines = text.splitlines()
    for i, line in enumerate(lines):
        op = json.loads(line)
        v = op.get("value")
        if op.get("f") == "read" and op.get("type") == "ok" and \
                isinstance(v, dict) and v["__tuple__"][0] in keys and \
                v["__tuple__"][1][1] is not None:
            v["__tuple__"][1][1] = NEVER_WRITTEN
            lines[i] = json.dumps(op)
            return "\n".join(lines) + "\n", v["__tuple__"][0]
    fail(f"no ok read of a written value on keys {sorted(keys)} to "
         f"corrupt")


def pids_with(token: str) -> list:
    """Live processes whose command line names ``token`` (a run's data
    dir), this one aside."""
    pids = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if token in f.read().decode("utf-8", "replace"):
                    pids.append(int(pid))
        except OSError:
            continue
    return pids


def fake_spawn_seconds(root: str, n: int) -> tuple:
    """Seconds from spawning a fake-etcd node to its first status with a
    leader: ``n`` cold starts and ``n`` restarts after a SIGKILL."""
    from jepsen_etcd_tpu_torch.db.local import LocalDb
    from jepsen_etcd_tpu_torch.runner.sim import set_current_loop
    from jepsen_etcd_tpu_torch.runner.wall import WallLoop
    cold, restart = [], []
    for i in range(n):
        db = LocalDb({"etcd_binary": "fake", "client_type": "http",
                      "etcd_data_dir": os.path.join(root, f"probe{i}"),
                      "nodes": ["n1"]})
        test = {"nodes": ["n1"], "client_type": "http",
                "db_mode": "local", "db": db}
        loop = WallLoop()
        set_current_loop(loop)
        try:
            t0 = time.perf_counter()
            loop.run_coro(db.setup(test))
            cold.append(time.perf_counter() - t0)
            db.kill(test, "n1")
            t0 = time.perf_counter()
            db.start(test, "n1")
            loop.run_coro(db._await_node_ready(test, "n1"))
            restart.append(time.perf_counter() - t0)
        finally:
            db.stop_all()
            set_current_loop(None)
            loop.shutdown()
    return cold, restart


def hold_live(label: str, out) -> dict:
    """The holds every live run keeps, on its result ``out``: each key's
    verdict equal to the native DFS's; the workload's dict equal to the
    stored history.jsonl checked again with the plain versions on the
    CPU; a copy of that history with one read of a key wgl_wave decided
    set to a value never written refuted through wgl_wave on the card.
    wgl_mxu's launch count is left as it was found, so the holds' own
    launches never count as the main path's. Fails on any miss; returns
    what the run's line prints."""
    from jepsen_etcd_tpu_torch.checkers.linearizable import check_history
    from jepsen_etcd_tpu_torch.core.history import History
    from jepsen_etcd_tpu_torch.models import VersionedRegister
    from jepsen_etcd_tpu_torch.ops import wgl_mxu
    from jepsen_etcd_tpu_torch.workloads.register import workload

    found = wgl_mxu.LAUNCHES
    subs = out["history"].split_by_key()
    lin = {k: r["linear"]
           for k, r in out["results"]["workload"]["results"].items()}
    # the deciding engine; a key with info ops leaves wgl_wave for the
    # ladder or the DFS as in the reference (``checker`` names which)
    engines = {}
    for k in subs:
        engines.setdefault(str(lin[k].get("engine")
                               or lin[k].get("checker")), []).append(k)
    dfs_bad = [k for k in subs
               if check_history(VersionedRegister(), subs[k])["valid?"]
               is not lin[k]["valid?"]]
    with open(os.path.join(out["dir"], "history.jsonl")) as f:
        text = f.read()
    with open(os.path.join(out["dir"], "test.json")) as f:
        stored_test = json.load(f)
    kept = out["results"]["workload"]
    plain = workload(dict(stored_test, device="cpu"))["checker"]
    # the plain versions on the history as the run checked it: the
    # stored dict, exactly
    same_cpu = same_json(kept, plain.check(stored_test, out["history"]))
    # and on history.jsonl re-read: the stored dict but for C6
    same_reread, c6 = reread_differences(
        kept, plain.check(stored_test, History.from_jsonl(text)), subs)
    bad_text, bad_key = corrupt_read(text, engines.get("mxu-wave", ()))
    wgl_mxu.LAUNCHES = 0
    bad = workload(stored_test)["checker"].check(
        stored_test, History.from_jsonl(bad_text))
    bad_launches = wgl_mxu.LAUNCHES
    wgl_mxu.LAUNCHES = found
    bad_lin = bad["results"][bad_key]["linear"]
    if dfs_bad or not same_cpu or not same_reread:
        fail(f"live {label}: keys {dfs_bad} differ from the native DFS, "
             f"or the dict differs from the plain versions' ({same_cpu}), "
             f"or from theirs on history.jsonl re-read by more than C6's "
             f"session.writes of a key with no read: {c6}")
    if bad["valid?"] is not False or bad_lin["valid?"] is not False or \
            bad_lin.get("engine") != "mxu-wave" or bad_launches < 1:
        fail(f"live {label}: the corrupted read was not refuted through "
             f"wgl_wave: {bad_lin}")
    return {"subs": subs, "engines": engines,
            "text": (f"every key's verdict = native DFS: {not dfs_bad}; "
                     f"dict = the stored history checked with the plain "
                     f"versions on the CPU: {same_cpu}, on history.jsonl "
                     f"re-read: {same_reread} (C6's session.writes of "
                     f"keys with no read: {c6}); key {bad_key} "
                     f"with a read of {NEVER_WRITTEN}: valid?="
                     f"{bad['valid?']} (engine {bad_lin.get('engine')}, "
                     f"wgl_wave launches {bad_launches})")}


def gateways(kind: str, n: int) -> tuple:
    """``n`` loopback gateways of ``kind`` (``http`` or ``grpc``) on
    ephemeral ports over one shared GatewayState, so that ``n``
    endpoints serve one linearizable MVCC store as a cluster's members
    do: their URLs, and a function that stops them all."""
    import threading
    from jepsen_etcd_tpu_torch.sut.grpc_gateway import serve_grpc
    from jepsen_etcd_tpu_torch.sut.http_gateway import GatewayState, serve
    state = GatewayState()
    urls, stops = [], []
    for _ in range(n):
        if kind == "grpc":
            gsrv, _, port = serve_grpc(0, state)
            stops.append(lambda g=gsrv: g.stop(0))
        else:
            srv, _ = serve(0, state)
            port = srv.server_address[1]
            thread = threading.Thread(target=srv.serve_forever,
                                      daemon=True)
            thread.start()

            def stop(srv=srv, thread=thread):
                srv.shutdown()
                srv.server_close()
                thread.join(timeout=10)
            stops.append(stop)
        urls.append(f"http://127.0.0.1:{port}")

    def stop_all():
        for stop in stops:
            stop()
    return urls, stop_all


def live_run(label: str, card: str, dev, opts: dict,
             full_key: bool = False) -> int:
    """One run against live endpoints through ``run_test``: wgl_wave's
    launches counted around it, every key through wgl_wave and held by
    ``hold_live``; the run's batch timed on the card. ``full_key`` holds
    that a key took all of its ``ops_per_key`` ops. Returns the run's
    wgl_wave launches."""
    import torch
    from jepsen_etcd_tpu_torch.compose import etcd_test
    from jepsen_etcd_tpu_torch.ops import wgl, wgl_mxu
    from jepsen_etcd_tpu_torch.runner.test_runner import run_test

    # register.workload's group: 2n threads a key, n of them readers
    threads = min(2 * len(opts["nodes"]), opts["concurrency"])
    torch.cuda.synchronize()
    wgl_mxu.LAUNCHES = 0
    t0 = time.perf_counter()
    out = run_test(etcd_test(opts))
    wall = time.perf_counter() - t0
    launches = wgl_mxu.LAUNCHES
    phases = out["results"]["telemetry"]["phases"]
    held = hold_live(label, out)
    subs = held["subs"]
    b1_ms, groups = b1_batch_ms(wgl.pack_register_histories_batched(subs),
                                dev)
    invokes = sum(1 for op in out["history"].ops
                  if op.get("type") == "invoke"
                  and op.get("process") != "nemesis")
    print(f"live {label} on {card}: {opts['client_type']} to "
          f"{len(opts['nodes'])} endpoints over one store, "
          f"{opts['concurrency']} threads ({threads} a key), "
          f"{opts['rate']} ops/s for {opts['time_limit']} s: "
          f"valid?={out['valid?']}, {invokes} client ops, achieved "
          f"{invokes / phases['generate']:.1f} ops/s, phase:generate "
          f"{phases['generate']:.3f} s, phase:check {phases['check']:.3f} "
          f"s, wall {wall:.3f} s; {len(subs)} keys of "
          f"{min(map(len, subs.values()))}-"
          f"{max(map(len, subs.values()))} entries; engines "
          f"{held['engines']}; wgl_wave launches {launches}, the run's "
          f"batch {b1_ms:.3f} ms on the card ({groups} group(s), CUDA "
          f"events, median of 11); {held['text']}", flush=True)
    if out["valid?"] is not True or launches < 1 or \
            set(held["engines"]) != {"mxu-wave"}:
        fail(f"live {label}: valid? {out['valid?']}, engines "
             f"{held['engines']}, launches {launches}")
    if full_key and max(map(len, subs.values())) != 2 * opts["ops_per_key"]:
        fail(f"live {label}: no key reached {opts['ops_per_key']} ops")
    return launches


def live_phase(card: str, dev) -> dict:
    """The live side on the card: (a) the register workload over the
    etcd v3 JSON wire against five of the port's gateways
    (``sut/http_gateway``) over one store at BASELINE's widths and (b)
    over native gRPC (``sut/grpc_gateway``), each through ``live_run``;
    (c) the local control plane on a fake-etcd node under a kill
    nemesis, the node's spawn timed and no process left behind; (d)
    three soak windows on one retained node. (c) and each window of (d)
    keep ``hold_live``'s holds. Returns the runs' wgl_wave launches for
    the kernels line."""
    import shutil
    import tempfile
    import torch
    from collections import Counter
    from jepsen_etcd_tpu_torch.compose import etcd_test
    from jepsen_etcd_tpu_torch.ops import wgl_mxu
    from jepsen_etcd_tpu_torch.runner.test_runner import (SOAK_KEY_STRIDE,
                                                          run_soak,
                                                          run_test)

    store = tempfile.mkdtemp(prefix="chip-smoke-live-")
    launches = 0
    try:
        # -- (a) the JSON wire at BASELINE's widths, (b) native gRPC --------
        for label, kind, limit in (("(a)", "http", LIVE_OPTS["time_limit"]),
                                   ("(b)", "grpc", LIVE_GRPC_TIME_LIMIT)):
            urls, stop_all = gateways(kind, LIVE_ENDPOINTS)
            try:
                launches += live_run(label, card, dev, dict(
                    LIVE_OPTS, client_type=kind, store_base=store,
                    time_limit=limit, nodes=urls), full_key=kind == "http")
            finally:
                stop_all()

        # -- (c) the local control plane under a kill nemesis --------------
        cold, restart = fake_spawn_seconds(os.path.join(store, "probe"),
                                           LIVE_SPAWNS)
        data = os.path.join(store, "cluster")
        torch.cuda.synchronize()
        wgl_mxu.LAUNCHES = 0
        t0 = time.perf_counter()
        test = etcd_test(dict(LOCAL_OPTS, etcd_data_dir=data,
                              store_base=store))
        out = run_test(test)
        wall = time.perf_counter() - t0
        local_launches = wgl_mxu.LAUNCHES
        launches += local_launches
        held = hold_live("(c)", out)
        nem = Counter(op["f"] for op in out["history"].ops
                      if op.get("process") == "nemesis"
                      and op.get("type") != "invoke")
        leaked = pids_with(os.path.abspath(data))
        phases = out["results"]["telemetry"]["phases"]
        print(f"live (c) on {card}: --db local --etcd-binary fake, node "
              f"n1, nemesis kill every {LOCAL_OPTS['nemesis_interval']} "
              f"s, {LOCAL_OPTS['time_limit']} s at {LOCAL_OPTS['rate']} "
              f"ops/s: valid?={out['valid?']}, {len(out['history'])} ops, "
              f"nemesis ops {dict(nem)}, node processes spawned "
              f"{len(test['db'].all_procs)}; phase:generate "
              f"{phases['generate']:.3f} s, phase:check "
              f"{phases['check']:.3f} s, wall {wall:.3f} s; engines "
              f"{held['engines']}; wgl_wave launches {local_launches}; "
              f"{held['text']}; processes left with the data dir: "
              f"{leaked}; a fake-etcd node's spawn to its first leader: "
              f"cold " + ", ".join(f"{s:.3f}" for s in cold) + " s, after "
              f"a kill " + ", ".join(f"{s:.3f}" for s in restart) + " s",
              flush=True)
        if out["valid?"] is not True or not (nem["kill"] or nem["start"]) \
                or local_launches < 1 or "mxu-wave" not in held["engines"] \
                or leaked:
            fail(f"live (c): valid? {out['valid?']}, nemesis {dict(nem)}, "
                 f"launches {local_launches}, engines {held['engines']}, "
                 f"leaked {leaked}")

        # -- (d) soak windows on one retained node -------------------------
        data = os.path.join(store, "soak")
        window_held = []

        def on_window(summary, wout):
            held = hold_live(f"(d) window {len(window_held)}", wout)
            window_held.append((held["engines"], held["text"]))

        torch.cuda.synchronize()
        wgl_mxu.LAUNCHES = 0
        t0 = time.perf_counter()
        sout = run_soak(dict(SOAK_OPTS, etcd_data_dir=data,
                             store_base=store), on_window=on_window)
        wall = time.perf_counter() - t0
        soak_launches = wgl_mxu.LAUNCHES
        launches += soak_launches
        wins = sout["windows"]
        offsets = [w["key_offset"] for w in wins]
        leaked = pids_with(os.path.abspath(data))
        print(f"live (d) on {card}: soak, {sout['count']} windows of "
              f"{SOAK_OPTS['soak_window_s']} s on one fake-etcd node: "
              f"valid? {[w['valid?'] for w in wins]}, ops "
              f"{[w['ops'] for w in wins]}, key_offset {offsets}, window "
              f"wall-seconds "
              f"{[round(w['wall-seconds'], 3) for w in wins]}, wall "
              f"{wall:.3f} s (the holds included); wgl_wave launches "
              f"{soak_launches}; processes left with the data dir: "
              f"{leaked}; by window: " + " | ".join(
                  f"engines {e}; {t}" for e, t in window_held), flush=True)
        if sout["valid?"] is not True or sout["count"] != 3 or \
                len(window_held) != 3 or \
                offsets != [0, SOAK_KEY_STRIDE, 2 * SOAK_KEY_STRIDE] or \
                any("mxu-wave" not in e for e, _ in window_held) or \
                soak_launches < 1 or leaked:
            fail(f"live (d): {wins}, engines "
                 f"{[e for e, _ in window_held]}, launches {soak_launches}")
    finally:
        shutil.rmtree(store, ignore_errors=True)
    return {"launches": launches}


def store_cmd(*argv) -> tuple:
    """``python -m jepsen_etcd_tpu_torch store ...`` through ``cli.main``:
    (exit code, the JSON it printed, seconds)."""
    from jepsen_etcd_tpu_torch import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["store", *argv])
    return rc, json.loads(buf.getvalue()), time.perf_counter() - t0


def copy_but_histories(src: str, dst: str) -> None:
    """``shutil.copy2``, except that a history.jsonl is copied empty."""
    import shutil
    if os.path.basename(src) == "history.jsonl":
        open(dst, "w").close()
    else:
        shutil.copy2(src, dst)


def page_checks(page: str, results: dict) -> tuple:
    """What a run page shows against the run's results.json: the
    header's verdict, each checker's verdict and detail (the page's
    first 2,000 characters of its JSON), and the engines that detail
    names, in order. Returns (the faults found, the engines shown)."""
    import html as html_mod
    import re
    faults = []
    cls = {True: "ok", False: "bad"}
    head = re.search(r"</a></p><h1>.*? <span class=\"(\w+)\">(.*?)</span>"
                     r"</h1>", page, re.S)
    want = results.get("valid?")
    if not head or head.group(2) != html_mod.escape(str(want)) or \
            head.group(1) != cls.get(want, "unk"):
        faults.append(f"header {head and head.groups()} != {want}")
    rows = re.findall(r"<tr><td>([^<]*)</td><td><span class=\"(\w+)\">"
                      r"([^<]*)</span></td><td><code>(.*?)</code></td></tr>",
                      page, re.S)
    checkers = [(k, v) for k, v in sorted(results.items())
                if isinstance(v, dict) and "valid?" in v]
    if [html_mod.unescape(r[0]) for r in rows] != [k for k, _ in checkers]:
        faults.append(f"checkers {[r[0] for r in rows]}")
        return faults, []
    engines = []
    for (name, c, val, blob), (_, v) in zip(rows, checkers):
        detail = json.dumps({dk: dv for dk, dv in v.items()
                             if dk != "valid?"}, default=repr)[:2000]
        if val != html_mod.escape(str(v["valid?"])) or \
                c != cls.get(v["valid?"], "unk") or \
                html_mod.unescape(blob) != detail:
            faults.append(f"checker {name}: {val} vs {v['valid?']}")
        shown = re.findall(r'"engine": "([^"]+)"', html_mod.unescape(blob))
        stored = re.findall(r'"engine": "([^"]+)"', json.dumps(
            {dk: dv for dk, dv in v.items() if dk != "valid?"},
            default=repr))
        if shown != stored[:len(shown)]:
            faults.append(f"checker {name}: engines {shown} vs {stored}")
        engines += shown
    return faults, engines


def readers_phase(card: str, runner: dict, camp: dict) -> None:
    """The store's readers on the stores the runner and campaign phases
    wrote on the card: ``store index --rebuild`` and ``store index``
    (the index's run rows = ``forensics.all_runs``), the walk path's rows
    = the index's, ``store compact --dry-run`` at the default --keep;
    then ``serve`` on port 0 in a process of its own, every page read
    over HTTP and each run page held against its results.json; then the
    linter over the port's tree. Removes both stores."""
    import shutil
    import signal
    import tempfile
    import urllib.request
    from jepsen_etcd_tpu_torch import forensics, serve
    from jepsen_etcd_tpu_torch.compose import etcd_test
    from jepsen_etcd_tpu_torch.runner import store_index
    from jepsen_etcd_tpu_torch.runner.test_runner import run_test

    root = os.path.dirname(os.path.abspath(__file__))
    rstore, cstore = runner["store"], camp["store"]
    secs = {}
    procs = []
    try:
        t0 = time.perf_counter()
        tout = run_test(etcd_test(dict(READERS_TRACE_OPTS,
                                       store_base=rstore)))
        secs["trace run"] = time.perf_counter() - t0
        if not os.path.exists(os.path.join(tout["dir"], "trace.jsonl")):
            fail("readers: the --tcpdump run wrote no trace.jsonl")
        run_dirs = list(runner["runs"]) + [tout["dir"]]

        # -- the store command: rebuild, verify, compact --dry-run -------
        counts = {}
        for label, base in (("runner", rstore), ("campaign", cstore)):
            rc, built, secs[f"{label} rebuild"] = store_cmd(
                "index", "--rebuild", "--store", base)
            rc2, ver, secs[f"{label} verify"] = store_cmd(
                "index", "--store", base)
            tree = sorted(os.path.relpath(r, base)
                          for r in forensics.all_runs(base))
            fold = store_index.fold(base)
            rows = sorted(store_index.kind_dirs(fold, "run"))
            if rc or rc2 or not built["ok"] or not ver["ok"] or \
                    rows != tree or ver["index_runs"] != len(tree):
                fail(f"readers: store index on the {label} store: exit "
                     f"{rc}/{rc2}, {built}, {ver}, index rows {len(rows)} "
                     f"vs all_runs {len(tree)}")
            rc3, dry, secs[f"{label} compact"] = store_cmd(
                "compact", "--dry-run", "--store", base)
            after = [os.path.relpath(r, base)
                     for r in forensics.all_runs(base)]
            if rc3 or not dry["ok"] or not dry["dry_run"] or \
                    sorted(after) != tree or \
                    dry["compacted"] + dry["skipped_failures"] != \
                    max(0, len(tree) - 32) or \
                    (len(tree) <= 32 and dry["compacted"]):
                fail(f"readers: store compact --dry-run on the {label} "
                     f"store: {dry}")
            # the walk path (no index) gives the index's rows: a copy
            # without the index (histories left empty: the walk reads
            # only that they exist; directory times are kept)
            t0 = time.perf_counter()
            walk = tempfile.mkdtemp(prefix="chip-smoke-walk-")
            try:
                shutil.copytree(base, os.path.join(walk, "s"),
                                symlinks=True,
                                ignore=shutil.ignore_patterns(
                                    store_index.INDEX_NAME + "*"),
                                copy_function=copy_but_histories)
                walk_rows = serve._run_rows(os.path.join(walk, "s"))
            finally:
                shutil.rmtree(walk, ignore_errors=True)
            secs[f"{label} walk"] = time.perf_counter() - t0
            if walk_rows != store_index.serve_run_rows(fold):
                fail(f"readers: the {label} store's walk rows differ "
                     "from the index's")
            counts[label] = (len(tree), dry["compacted"])

        # -- serve on port 0, each store in a process of its own ---------
        urls = {}
        t0 = time.perf_counter()
        for label, base in (("runner", rstore), ("campaign", cstore)):
            proc = subprocess.Popen(
                [sys.executable, "-u", "-m", "jepsen_etcd_tpu_torch",
                 "serve", "--store", base, "-p", "0"],
                cwd=root, stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True)
            procs.append(proc)
            urls[label] = proc
        for label, proc in list(urls.items()):
            line = proc.stdout.readline()
            if "http://" not in line:
                fail(f"readers: serve printed {line!r}")
            urls[label] = line.split("http://", 1)[1].split("/", 1)[0]
        secs["serve start"] = time.perf_counter() - t0

        def get(label: str, path: str, name: str) -> str:
            t0 = time.perf_counter()
            with urllib.request.urlopen(f"http://{urls[label]}{path}",
                                        timeout=60) as resp:
                body = resp.read().decode()
                if resp.status != 200:
                    fail(f"readers: GET {path}: {resp.status}")
            secs[name] = time.perf_counter() - t0
            return body

        index = get("runner", "/", "/")
        agg1 = get("campaign", f"/aggregate?page=1&per={READERS_PER}",
                   "/aggregate p1")
        agg2 = get("campaign", f"/aggregate?page=2&per={READERS_PER}",
                   "/aggregate p2")
        n_camp = counts["campaign"][0]
        if f"rows 1–{READERS_PER} of {n_camp}" not in agg1 or \
                f"rows {READERS_PER + 1}–" not in agg2 or \
                "Campaign perf trends" not in agg1 or \
                "ledger" not in agg1:
            fail(f"readers: /aggregate pages over {n_camp} runs")
        engines = {}
        for rdir in run_dirs:
            rel = os.path.relpath(rdir, rstore)
            if rel not in index:
                fail(f"readers: / lists no {rel}")
            page = get("runner", f"/{rel}/", f"run {len(engines) + 1}")
            with open(os.path.join(rdir, "results.json")) as f:
                faults, engines[rel] = page_checks(page, json.load(f))
            if faults:
                fail(f"readers: the run page of {rel}: {faults}")
        base_rel = os.path.relpath(runner["runs"][0], rstore)
        if "mxu-wave" not in engines[base_rel]:
            fail(f"readers: the BASELINE run's page shows engines "
                 f"{engines[base_rel]}")
        trace_rel = os.path.relpath(tout["dir"], rstore)
        trace = get("runner", f"/{trace_rel}/?trace", "trace")
        if "events shown" not in trace or "<td>" not in trace:
            fail("readers: the trace page shows no events")
        live = get("campaign", "/live", "/live")
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"http://{urls['campaign']}/live?sse=1",
                                    timeout=60) as resp:
            line = resp.readline()
            while line and not line.startswith(b"data: "):
                line = resp.readline()
        secs["sse tick"] = time.perf_counter() - t0
        tick = json.loads(line[len(b"data: "):].decode())
        if "EventSource" not in live or not tick.get("campaign") or \
                not os.path.isdir(os.path.join(cstore, tick.get("dir", ""))):
            fail(f"readers: /live or its SSE tick: {tick}")

        # -- the linter over the port's tree ----------------------------
        t0 = time.perf_counter()
        lint = subprocess.run(
            [sys.executable, "-m", "jepsen_etcd_tpu_torch.lint", "--json"],
            cwd=root, capture_output=True, text=True, timeout=300)
        secs["lint"] = time.perf_counter() - t0
        report = json.loads(lint.stdout or "{}")
        if lint.returncode != 0 or report.get("errors") != 0:
            fail(f"readers: the linter: exit {lint.returncode}, "
                 f"{report.get('errors')} error(s)\n{lint.stderr[-2000:]}")
        print(f"readers on {card}: runner store {counts['runner'][0]} runs, "
              f"campaign store {counts['campaign'][0]} runs (compact "
              f"--dry-run at --keep 32 would demote "
              f"{counts['campaign'][1]}, deletes nothing); engines on the "
              f"BASELINE run page {sorted(set(engines[base_rel]))}; SSE "
              f"tick active={tick.get('active')} done={tick.get('done')}; "
              f"lint {report['files']} files, {report['suppressed']} "
              f"suppressed, 0 errors; seconds " + ", ".join(
                  f"{k} {v:.3f}" for k, v in secs.items()), flush=True)
    finally:
        for proc in procs:
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        shutil.rmtree(rstore, ignore_errors=True)
        shutil.rmtree(cstore, ignore_errors=True)


def fault_route(lin: dict) -> str:
    """Which engine decided a register key of a forced-kernel run:
    wgl_wave's batched launch, the ladder's batched rung or a lone
    ladder (keys with info ops), the native DFS, or nothing to search
    (no op that took effect: waves 0)."""
    if lin.get("engine") == "mxu-wave":
        return "wgl_wave batched"
    if lin.get("batched"):
        return "ladder, batched rung"
    if lin.get("engine") == "jnp-ladder":
        return "ladder"
    if lin.get("checker") == "cpu-oracle":
        return "native DFS"
    if lin.get("waves") == 0 and "engine" not in lin:
        return "nothing to search"
    return str(lin.get("engine"))


def faults_phase(card: str, dev) -> dict:
    """Section 16: the reference's fault packages on the card. Each of
    FAULT_RUNS through ``run_test(etcd_test(...))`` with ``device`` the
    card and force_kernel, and again with ``device="cpu"`` (the plain
    versions): the history bytes and every checker's dict (wall-clock
    keys aside) equal, each register key's verdict equal to the native
    DFS's, every run valid (watch: valid or unknown) but lock-set, of
    whose two seeds one loses adds (``valid? False``). Prints each run's
    keys by engine and its wgl_wave launches; returns the launches for
    the kernels line."""
    import shutil
    import tempfile
    import torch
    from jepsen_etcd_tpu_torch.checkers.linearizable import check_history
    from jepsen_etcd_tpu_torch.compose import etcd_test
    from jepsen_etcd_tpu_torch.models import VersionedRegister
    from jepsen_etcd_tpu_torch.ops import edit_distance as ed
    from jepsen_etcd_tpu_torch.ops import wgl_mxu
    from jepsen_etcd_tpu_torch.runner.test_runner import run_test

    store = tempfile.mkdtemp(prefix="chip-smoke-faults-")
    launches, lock_losses = 0, 0
    try:
        for label, extra in FAULT_RUNS:
            opts = dict(FAULTS_BASE, **extra)
            torch.cuda.synchronize()
            wgl_mxu.LAUNCHES = ed.LAUNCHES = 0
            t0 = time.perf_counter()
            out = run_test(etcd_test(dict(opts, store_base=store)))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs, b2_runs = wgl_mxu.LAUNCHES, ed.LAUNCHES
            launches += runs
            cpu = run_test(etcd_test(dict(opts, store_base=store,
                                          device="cpu")))
            same_bytes = out["history"].to_jsonl() == \
                cpu["history"].to_jsonl()
            res = {k: v for k, v in out["results"].items()
                   if k != "timeline"}
            cres = {k: v for k, v in cpu["results"].items()
                    if k != "timeline"}
            same = same_json(res, cres)
            wl = out["results"]["workload"]
            engines, bad_keys = {}, []
            if extra["workload"] == "register":
                subs = out["history"].split_by_key()
                for k, r in wl["results"].items():
                    lin = r["linear"]
                    engines.setdefault(fault_route(lin), []).append(k)
                    dfs = check_history(VersionedRegister(), subs[k])
                    if dfs["valid?"] is not lin["valid?"]:
                        bad_keys.append(k)
            verdict = wl["set"]["valid?"] if "set" in wl else wl["valid?"]
            print(f"faults on {card}: {label}: valid?={out['valid?']} "
                  f"workload {verdict}, {len(out['history'])} ops, "
                  f"{out['sim-seconds']:.1f} sim-s, wall {wall:.3f} s; "
                  f"keys by engine "
                  f"{ {k: len(v) for k, v in engines.items()} }; "
                  f"wgl_wave launches {runs}, indel_bits {b2_runs}; "
                  f"history bytes = the CPU "
                  f"run's: {same_bytes}; dicts = the CPU run's: {same}; "
                  f"every key = native DFS: {not bad_keys}", flush=True)
            if not same_bytes or not same or bad_keys:
                fail(f"faults, {label}: bytes {same_bytes}, dicts {same}, "
                     f"keys unlike the native DFS {bad_keys}")
            if extra["workload"] == "lock-set":
                lock_losses += verdict is not True and \
                    bool(wl["set"].get("lost"))
            elif verdict is not True and not (
                    extra["workload"] == "watch" and verdict == "unknown"):
                fail(f"faults, {label}: workload verdict {verdict}")
            if extra["workload"] == "register" and (
                    "wgl_wave batched" not in engines or runs < 1):
                fail(f"faults, {label}: wgl_wave launched {runs} times, "
                     f"keys by engine {engines}")
        if not lock_losses:
            fail("faults: lock-set lost no adds under clock faults")
    finally:
        shutil.rmtree(store, ignore_errors=True)
    return {"launches": launches}


def frame_tables_entry(p, card: str, dev, launches: int) -> dict:
    """The frame tables (``wgl_mxu.build_tables``, the reference's
    ``_build_tables_one``) at the register cell: its tables held exactly
    against the host packer ``pack_tables`` (its plain version), timed
    beside it and beside its ``torch.gather``s alone (the library calls
    it issues; it has no matmul), with its bound counted from the data."""
    import numpy as np
    import torch
    from jepsen_etcd_tpu_torch.ops import wgl, wgl_mxu
    wk = p.w
    r_pad = max(wgl.bucket(p.R), wgl_mxu.TSUB)
    i32, u16 = wgl_mxu.pack_perop_batch([p], r_pad)
    ti = torch.from_numpy(i32).to(dev)
    tu = torch.from_numpy(u16.astype(np.int32)).to(dev)
    ms = cuda_ms(lambda: wgl_mxu.build_tables(ti, tu, r_pad, wk), 21)
    tab, scal = wgl_mxu.build_tables(ti, tu, r_pad, wk)
    t0 = time.perf_counter()
    ptab, pscal = wgl_mxu.pack_tables(p, r_pad)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(int(np.abs(tab[0].cpu().numpy().astype(np.int64)
                         - ptab.astype(np.int64)).max()),
              int(np.abs(scal[0].cpu().numpy().astype(np.int64)
                         - pscal.astype(np.int64)).max()))
    # the library calls alone: one gather of the nine window columns at
    # build_tables' index
    u = tu.to(torch.int64)
    pos = u[:, :, wgl_mxu.C_LO:wgl_mxu.C_LO + 1] + \
        torch.arange(wk, device=dev)[None, None, :]
    flat = pos.clamp(0, p.R - 1).reshape(1, r_pad * wk)
    cols = torch.cat([ti.to(torch.int64)[:, :, :2], u[:, :, :7]], dim=2)
    idx = flat[:, :, None].expand(1, r_pad * wk, cols.shape[2])
    lib_ms = cuda_ms(lambda: torch.gather(cols, 1, idx), 21)
    nbytes = (ti.numel() + tu.numel() + tab.numel() + scal.numel()) * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops = p.R * wk * (FRAME_OPS_PER_SLOT + wk * FRAME_OPS_PER_PAIR)
    ops_ms = ops / ALU32_OPS_PER_S * 1e3
    print(f"frame tables on {card}: build_tables at R={p.R} (r_pad "
          f"{r_pad}, wk {wk}) {ms:.3f} ms (CUDA events, median of 21), "
          f"{launches} build(s) on the main path; plain pack_tables on the "
          f"host {plain_ms:.1f} ms; its gathers alone {lib_ms:.3f} ms; "
          f"bound {max(bytes_ms, ops_ms):.4f} ms (bytes {nbytes}: "
          f"{bytes_ms:.4f} ms; operations {ops}: {ops_ms:.4f} ms); "
          f"max_abs_err {err}", flush=True)
    if err:
        fail("build_tables disagrees with pack_tables at the register cell")
    if launches < 1:
        fail("the main path did not build its tables on the card")
    return {"name": "frame_tables", "route": "torch",
            "source": "jepsen_etcd_tpu_torch/ops/wgl_mxu.py",
            "replaces": "jepsen_etcd_tpu/ops/wgl_mxu.py:306",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": lib_ms}


def ladder_rungs(p, dev) -> tuple:
    """The ladder alone on one pack, as ``check_packed(p, f_max=32)``
    climbs it (rung 32, then up), each rung run in the rung kernel where
    it takes it: (accepted, waves, peak, (capacity, waves, seconds) of
    each rung run, seconds in all, tables included)."""
    import torch
    from jepsen_etcd_tpu_torch.ops import wgl
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ladder = wgl._ladder(p, wgl.LADDER[0])
    ni = wgl.info_dims(p)[1]
    tables = wgl.LadderTables(p, dev)
    k, frontier = 0, wgl._initial_frontier(ladder[0], p.w // 32, ni, dev)
    per_rung = []
    peak_all = 1
    for f in ladder:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        k0 = k
        valid, overflow, k, peak, frontier = wgl._wgl_loop(
            tables, p.R, p.I, f, p.w, (k, *frontier))
        torch.cuda.synchronize()
        per_rung.append((f, k - k0, time.perf_counter() - t1))
        peak_all = max(peak_all, peak)
        if not overflow or len(per_rung) == len(ladder):
            break
        frontier = wgl._grow(frontier, ladder[len(per_rung)])
    torch.cuda.synchronize()
    return valid, k, peak_all, per_rung, time.perf_counter() - t0


def frontier_bytes(frontier) -> tuple:
    """A frozen frontier (d, mask words, count words, v, n_alive) as its
    rows' bytes on the host and its count."""
    import torch
    d, w, i, v, n = frontier
    rows = torch.cat([d[:, None], w, i, v[:, None]], 1)
    return rows.cpu().numpy().tobytes(), int(n)


def card_builds(fn) -> tuple:
    """(fn(), the ``wgl.frames-card`` builds it counted), this thread
    recording into a telemetry recorder of its own meanwhile."""
    from jepsen_etcd_tpu_torch.runner import telemetry
    tel = telemetry.Telemetry()
    telemetry.set_thread_current(tel)
    try:
        out = fn()
    finally:
        telemetry.set_thread_current(None)
    return out, tel.summary()["counters"].get("wgl.frames-card", 0)


def card_tables_hold(p, what: str, card: str, dev) -> None:
    """The rung kernel's tables built on the card (``wgl.card_tables``,
    csrc/wgl_frames.cu) against their plain version, the host's frames
    narrowed (``_rung_kernel_tables(device_tables(p))``): all three
    identical. Prints the card build's wall (inputs, copy, launch and
    sync; median of 21), its kernel alone (CUDA events) beside the time
    its writes take at the card's bandwidth, and the host build's wall
    (its frames built anew each time; median of 3)."""
    import torch
    from jepsen_etcd_tpu_torch.ops import _cuda, wgl
    c_pad, ni, i_tab = wgl.info_dims(p)

    def card_build():
        out = wgl.card_tables(p, dev)
        torch.cuda.synchronize()
        return out

    def host_build():
        for name in wgl.FRAME_FIELDS:
            setattr(p, name, None)
        out = wgl._rung_kernel_tables(wgl.device_tables(p, dev), ni)
        torch.cuda.synchronize()
        return out

    def wall_ms(fn, reps: int) -> float:
        fn()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls) * 1e3

    got, want = card_build(), host_build()
    same = all(g.dtype == w.dtype and g.shape == w.shape
               and bool(torch.equal(g, w)) for g, w in zip(got, want))
    card_ms, host_ms = wall_ms(card_build, 21), wall_ms(host_build, 3)
    inputs = torch.from_numpy(wgl._frame_inputs(p, c_pad, ni)).to(dev)
    rows = torch.empty_like(got[0])
    info = torch.empty_like(got[1])
    kern_ms = cuda_ms(lambda: _cuda.wgl_frames(inputs, p.R, p.I, rows,
                                               info), 21)
    nbytes = (rows.numel() + info.numel()) * 4
    print(f"{what} on {card}: the rung kernel's tables built on the card "
          f"(r_pad {rows.shape[0]}, i_tab {i_tab}): {card_ms * 1e3:.1f} us "
          f"a build (inputs, copy, launch, sync), the kernel alone "
          f"{kern_ms * 1e3:.1f} us ({nbytes} bytes written, "
          f"{nbytes / HBM_BYTES_PER_S * 1e6:.2f} us at the card's "
          f"bandwidth); the host build {host_ms:.1f} ms; identical: {same}",
          flush=True)
    if not same:
        fail(f"{what}: the card-built rung-kernel tables differ from the "
             f"host's")


def rung_route_holds(p, what: str, fs: tuple, card: str, dev) -> dict:
    """The rung kernel on one pack against its plain version, the same
    rungs as PyTorch ops (the kernel's route off, ``RUNG_KERNEL_F_MAX``
    0) on the same tables: ``check_packed`` from rung 32 with the spill
    deferred, the same dict and frozen frontier, its tables built on the
    card (csrc/wgl_frames.cu) on the kernel's route and on the host on
    the plain one; and each rung of ``fs`` from the empty frontier,
    paused at k = R/2 and run whole, the same (accepted, overflow, k,
    peak) and frozen frontier bytes. Prints the kernel's launches and a
    wave's time either way; returns the kernel's dict."""
    import torch
    from jepsen_etcd_tpu_torch.ops import wgl
    c_pad, ni, _ = wgl.info_dims(p)
    kernel_max = wgl.RUNG_KERNEL_F_MAX
    routes = (("kernel", kernel_max), ("plain", 0))
    try:
        outs, walls, launches, builds = {}, {}, {}, {}
        for route, f_max in routes:
            wgl.RUNG_KERNEL_F_MAX = f_max
            wgl.RUNG_KERNEL_LAUNCHES = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[route], builds[route] = card_builds(
                lambda: wgl.check_packed(p, f_max=32, spill=False,
                                         device=dev))
            torch.cuda.synchronize()
            walls[route] = time.perf_counter() - t0
            launches[route] = wgl.RUNG_KERNEL_LAUNCHES
        got, want = outs["kernel"], outs["plain"]
        same_dict = {k: v for k, v in got.items() if k != "_resume"} \
            == {k: v for k, v in want.items() if k != "_resume"}
        if "_resume" in got or "_resume" in want:
            same_dict = same_dict and "_resume" in got and \
                "_resume" in want and \
                got["_resume"][2] == want["_resume"][2] and \
                frontier_bytes(got["_resume"][1]) == \
                frontier_bytes(want["_resume"][1])
        tables = wgl.LadderTables(p, dev)
        # both views built before the timed runs
        _ = tables.rung, tables.plain
        lines, same_runs = [], True
        for f in fs:
            for k_stop in (p.R // 2, None):
                runs = {}
                for route, f_max in routes:
                    wgl.RUNG_KERNEL_F_MAX = f_max
                    init = (0, *wgl._initial_frontier(f, 1, ni, dev))
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    *head, fr = wgl._wgl_loop(tables, p.R, p.I, f, 32,
                                              init, k_stop)
                    torch.cuda.synchronize()
                    runs[route] = (tuple(head), frontier_bytes(fr),
                                   time.perf_counter() - t0)
                same = runs["kernel"][:2] == runs["plain"][:2]
                same_runs = same_runs and same
                acc, ovf, k, peak = runs["kernel"][0]
                waves = max(1, k + (1 if ovf else 0))
                lines.append(
                    f"F = {f} to {'the end' if k_stop is None else k_stop}"
                    f": k {k}, peak {peak}, accepted {acc}, overflow "
                    f"{ovf}, kernel {runs['kernel'][2] * 1e6 / waves:.2f}"
                    f" us a wave, plain "
                    f"{runs['plain'][2] * 1e6 / waves:.2f} us a wave, "
                    f"same: {same}")
    finally:
        wgl.RUNG_KERNEL_F_MAX = kernel_max
    waves = max(1, got.get("waves", 0))
    print(f"{what} on {card}: R {p.R}, I {p.I}, info dims {(c_pad, ni)}: "
          f"check_packed from rung 32 (spill deferred) valid? "
          f"{got.get('valid?')}, rungs {got.get('rungs')}, waves "
          f"{got.get('waves')}, peak {got.get('peak-frontier')}, "
          f"{launches['kernel']} rung run(s) in the kernel on "
          f"{builds['kernel']} card-built table set(s): "
          f"{walls['kernel'] * 1e3:.1f} ms ("
          f"{walls['kernel'] * 1e6 / waves:.2f} us a wave), plain "
          f"{walls['plain'] * 1e3:.1f} ms ({walls['plain'] * 1e6 / waves:.2f}"
          f" us a wave; {launches['plain']} in the kernel); same dict and "
          f"frozen frontier: {same_dict}; rung runs from the empty "
          f"frontier: " + "; ".join(lines), flush=True)
    if not same_dict or not same_runs or launches["plain"] or \
            launches["kernel"] < 1 or builds != {"kernel": 1, "plain": 0}:
        fail(f"{what}: the rung kernel disagrees with its plain version, "
             f"took no rung run or did not build its tables on the card: "
             f"{got} against {want}, card builds {builds}")
    return got


def info_key_holds(card: str, dev) -> None:
    """The rung kernel with its info classes (count words ni = 1) on
    info-op keys the size of a faulted key of the benchmark's 4n cell
    (``INFO_KEY_SEEDS``), against its plain version at rungs 32 and 128
    (``rung_route_holds``)."""
    from jepsen_etcd_tpu_torch.ops import wgl
    from jepsen_etcd_tpu_torch.testing import gen_history
    for seed in INFO_KEY_SEEDS:
        p = wgl.pack_register_history(gen_history(
            random.Random(seed), n_procs=10, n_ops=INFO_KEY_OPS,
            info_rate=0.01))
        c_pad, ni, _ = wgl.info_dims(p)
        if not (p.ok and p.w == 32 and ni == 1 and c_pad):
            fail(f"info-op key {seed}: not a one-word window with "
                 f"info classes: w {p.w}, info dims {(c_pad, ni)}")
        rung_route_holds(p, f"info-op key at the 4n cell's size, seed "
                         f"{seed}", (32, 128), card, dev)


def cell_key_holds(card: str, dev) -> None:
    """The rung kernel at its limits, on keys of the
    ``register_1key_10k.faulted`` cell: its fixed faulted key
    ``CELL_KEY`` (info classes padded to the kernel's ``C_CAP``, count
    words at its ``NI_CAP``), which it accepts, and the same key
    refuted twice, by an impossible read at ``CELL_KEY_AT`` of its
    entries and misreported as the cell corrupts its keys; each
    against its plain version at rung 32 (``rung_route_holds``), its
    tables built on the card against the host's (``card_tables_hold``);
    and two copies of the faulted key as a batched group
    (``batched_card_hold``)."""
    from benchmark.traffic.register_pool import _rng
    from benchmark.traffic.synth import gen_register_history
    from jepsen_etcd_tpu_torch.core.history import History
    from jepsen_etcd_tpu_torch.ops import _cuda, wgl
    from jepsen_etcd_tpu_torch.testing import impossible_read_at
    _, c_cap, ni_cap = _cuda.wgl_rung_limits()

    def key(corrupt: bool) -> History:
        return History(gen_register_history(
            _rng("fixed", "faulted", CELL_KEY), n_ops=CELL_KEY_OPS,
            info_rate=0.01, concurrency=10, corrupt=corrupt))

    faulted = key(False)
    for what, hist, valid in [
            ("faulted", faulted, True),
            ("impossible read", impossible_read_at(faulted, CELL_KEY_AT),
             False),
            ("corrupted", key(True), False)]:
        p = wgl.pack_register_history(hist)
        c_pad, ni, _ = wgl.info_dims(p)
        if not (p.ok and p.w == 32 and (c_pad, ni) == (c_cap, ni_cap)):
            fail(f"1-key cell's key, {what}: not at the rung kernel's "
                 f"limits: w {p.w}, info dims {(c_pad, ni)}")
        card_tables_hold(p, f"1-key cell's key {CELL_KEY}, {what}", card,
                         dev)
        got = rung_route_holds(p, f"1-key cell's key {CELL_KEY}, {what}",
                               (32,), card, dev)
        if got.get("valid?") is not valid:
            fail(f"1-key cell's key, {what}: valid? {got.get('valid?')}")
        if what == "faulted":
            batched_card_hold(p, f"1-key cell's key {CELL_KEY}", card, dev)


def batched_card_hold(p, what: str, card: str, dev) -> None:
    """Two copies of one key as a batched group (``check_packed_batch``,
    the rung at 128): on the card's route each key's tables are built
    there, two ``wgl.frames-card`` builds, and its rung run is the rung
    kernel's; the same dicts as the plain route (``RUNG_KERNEL_F_MAX``
    0: the group's stacked host tables, the rung as PyTorch ops).
    Prints both walls."""
    import torch
    from jepsen_etcd_tpu_torch.ops import wgl
    kernel_max = wgl.RUNG_KERNEL_F_MAX
    outs, builds, walls = {}, {}, {}
    try:
        for route, f_max in (("kernel", kernel_max), ("plain", 0)):
            wgl.RUNG_KERNEL_F_MAX = f_max
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, builds[route] = card_builds(lambda: wgl.check_packed_batch(
                [p, p], try_fused=False, device=dev))
            torch.cuda.synchronize()
            walls[route] = time.perf_counter() - t0
            outs[route] = [{k: v for k, v in o.items() if k != "_resume"}
                           for o in got]
    finally:
        wgl.RUNG_KERNEL_F_MAX = kernel_max
    same = outs["kernel"] == outs["plain"]
    print(f"{what} on {card}, two copies as a batched group: "
          f"{outs['kernel']}; card builds {builds}; kernel's route "
          f"{walls['kernel'] * 1e3:.1f} ms, plain "
          f"{walls['plain'] * 1e3:.1f} ms; same dicts: {same}", flush=True)
    if not same or builds != {"kernel": 2, "plain": 0} or \
            not all(o.get("batched") for o in outs["kernel"]):
        fail(f"{what}, batched: the card's route {outs['kernel']} "
             f"against the plain {outs['plain']}, card builds {builds}")


def rung_entry(p, card: str, dev, launches: int, kernel_launches: int,
               eager: dict, eager_s: float, graphs_s: float) -> dict:
    """The unsharded B3 rung at the ladder-at-real-size cell: the ladder
    alone, each rung run in the rung kernel (csrc/wgl_rung.cu), held
    against ``eager`` (the checker's ``check_packed`` with the rungs as
    PyTorch ops issued one by one, its plain version, which took
    ``eager_s``; ``graphs_s`` with their waves replayed from CUDA
    graphs); a wave's time at each rung's capacity; the bound counted
    from the waves each rung ran at its capacity, as the sharded rung's
    row."""
    from jepsen_etcd_tpu_torch.ops import wgl
    valid, waves, peak, per_rung, secs = ladder_rungs(p, dev)
    err = max(int(valid != eager["valid?"]),
              abs(waves - eager.get("waves", 0)),
              abs(peak - eager.get("peak-frontier", 0)),
              abs(len(per_rung) - eager.get("rungs", 0)))
    ops = sum(k * f * p.w * WGL_OPS_PER_CANDIDATE for f, k, _ in per_rung)
    ops_ms = ops / ALU32_OPS_PER_S * 1e3
    nbytes = sum(int(t.numel()) * t.element_size()
                 for t in wgl.device_tables(p, dev).values())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    per_wave = ", ".join(f"F = {f}: {k} waves, {s / max(1, k) * 1e6:.2f} "
                         f"us a wave" for f, k, s in per_rung)
    print(f"B3 rung on {card}: the ladder alone from rung 32 ({per_wave}), "
          f"accepted {valid}, peak {peak}: rung kernel {secs * 1e3:.1f} ms "
          f"with the tables; its plain version (PyTorch ops through "
          f"check_packed) eager {eager_s * 1e3:.1f} ms, CUDA graphs "
          f"{graphs_s * 1e3:.1f} ms; {launches} rung run(s) on the "
          f"checker's path, {kernel_launches} in the kernel; bound "
          f"{max(ops_ms, bytes_ms):.4f} ms (operations {ops}: "
          f"{ops_ms:.4f} ms; bytes {nbytes} of tables {bytes_ms:.4f} ms); "
          f"max_abs_err {err}", flush=True)
    if err:
        fail("the rung kernel disagrees with its plain version")
    if kernel_launches < 1 or kernel_launches != launches:
        fail("the checker's path ran a rung outside the rung kernel")
    return {"name": "wgl_rung", "route": "cuda",
            "source": "jepsen_etcd_tpu_torch/csrc/wgl_rung.cu",
            "replaces": "jepsen_etcd_tpu/ops/wgl.py:1669",
            "launches": kernel_launches, "max_abs_err": err,
            "ms": secs * 1e3, "plain_ms": eager_s * 1e3,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


def main() -> None:
    import numpy as np
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
    # (section, start) of each numbered section below, for its seconds
    marks = []

    # -- 1. build -----------------------------------------------------
    marks.append((1, time.perf_counter()))
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    sources = ["wgl_wave", "indel_bits", "drain_register", "wgl_rung",
               "wgl_frames"]
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_cuda.build, sources))
    print(f"build: {', '.join(s + '.cu' for s in sources)} (in parallel) "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)

    # -- 2. kernel vs plain on the card -------------------------------
    marks.append((2, time.perf_counter()))
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
    marks.append((3, time.perf_counter()))
    h = gen_history(random.Random(MAIN_SEED), n_procs=MAIN_PROCS,
                    n_ops=MAIN_OPS)
    bad = gen_history(random.Random(MAIN_SEED), n_procs=MAIN_PROCS,
                      n_ops=MAIN_OPS, corrupt=True)
    checker = TPULinearizableChecker()
    torch.cuda.synchronize()
    wgl_mxu.LAUNCHES = ed.LAUNCHES = wgl_mxu.BUILDS = 0
    t0 = time.perf_counter()
    res = checker.check({}, h)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = wgl_mxu.LAUNCHES
    builds = wgl_mxu.BUILDS
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
    marks.append((4, time.perf_counter()))
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
    frame_entry = frame_tables_entry(p, card, dev, builds)
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
    marks.append((5, time.perf_counter()))
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
    marks.append((6, time.perf_counter()))
    big = gen_history(random.Random(MAIN_SEED), n_procs=LADDER_BIG_PROCS,
                      n_ops=MAIN_OPS)
    big_bad = impossible_read_at(big, LADDER_BIG_AT)
    # wgl_wave on each history's tables now, its plain version on host
    # copies in a hold worker, compared after section 8
    ladder_holds = []
    for what, hist, engine in [("valid", big, "mxu-wave"),
                               ("impossible read", big_bad, "jnp-ladder")]:
        tab, scal, wk = tables_for([wgl.pack_register_history(hist)], dev)
        ladder_holds.append((
            f"ladder at real size, {what}", tab.shape, wk,
            wgl_mxu.wave_search(tab, scal, wk).cpu(),
            hold_workers().submit(host_wave, tab.cpu().numpy(),
                                  scal.cpu().numpy(), wk)))
        wgl.RUNG_LAUNCHES = wgl.RUNG_KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        out = checker.check({}, hist)
        wall_l = time.perf_counter() - t0
        rung_launches = wgl.RUNG_LAUNCHES
        kernel_launches = wgl.RUNG_KERNEL_LAUNCHES
        dfs = check_history(VersionedRegister(), hist)
        print(f"ladder at real size, {LADDER_BIG_PROCS} processes, "
              f"{len(hist)} entries, {what}: valid?={out['valid?']} "
              f"engine={out.get('engine')} rungs={out.get('rungs')} "
              f"peak-frontier={out.get('peak-frontier')} waves="
              f"{out.get('waves')} overflowed-en-route="
              f"{out.get('overflowed-en-route', False)} check wall "
              f"{wall_l:.3f} s, rung runs {rung_launches} ({kernel_launches} "
              f"in the rung kernel); native DFS valid?={dfs['valid?']}",
              flush=True)
        if out.get("engine") != engine or out["valid?"] is not dfs["valid?"]:
            fail(f"ladder at real size, {what}: {out}")
    # the ladder alone (wave kernel, then rungs 32 and 128): in the rung
    # kernel, and as its plain version, PyTorch ops replayed from CUDA
    # graphs and issued one by one: the same dict
    p = wgl.pack_register_history(big_bad)
    outs, walls = {}, {}
    graph_min, kernel_max = wgl.GRAPH_MIN_WAVES, wgl.RUNG_KERNEL_F_MAX
    try:
        for name, f_max, g_min in [("rung kernel", kernel_max, graph_min),
                                   ("CUDA graphs", 0, graph_min),
                                   ("eager", 0, 1 << 62)]:
            wgl.RUNG_KERNEL_F_MAX, wgl.GRAPH_MIN_WAVES = f_max, g_min
            wgl.RUNG_KERNEL_LAUNCHES = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[name] = wgl.check_packed(p)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            if name == "rung kernel":
                alone_launches = wgl.RUNG_KERNEL_LAUNCHES
    finally:
        wgl.GRAPH_MIN_WAVES, wgl.RUNG_KERNEL_F_MAX = graph_min, kernel_max
    lwaves = outs["rung kernel"].get("waves", 0)
    print(f"ladder at real size, check_packed: {lwaves} waves, rungs "
          f"{outs['rung kernel'].get('rungs')}; " + ", ".join(
              f"{name} {wall:.3f} s ({wall / lwaves * 1e3:.4f} ms a wave)"
              for name, wall in walls.items())
          + f"; rung kernel launches {alone_launches}; same dict: "
          f"{all(o == outs['eager'] for o in outs.values())}", flush=True)
    if any(o != outs["eager"] for o in outs.values()) or \
            outs["eager"].get("engine") != "jnp-ladder" or \
            alone_launches != outs["eager"].get("rungs"):
        fail(f"ladder in the rung kernel and as PyTorch ops: {outs}")
    rung = rung_entry(p, card, dev, rung_launches, kernel_launches,
                      outs["eager"], walls["eager"], walls["CUDA graphs"])
    info_key_holds(card, dev)
    cell_key_holds(card, dev)
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
    marks.append((7, time.perf_counter()))
    batch_entries = keyed_register_check(card)

    # -- 8. Elle: the closure, list-append and rw-register ------------
    marks.append((8, time.perf_counter()))
    elle_entries = elle_phase(card, torch.device("cuda", 0))
    print("kernel vs plain, the plain version on the host's CPU (a hold "
          "worker; exact, tolerance 0):", flush=True)
    for what, shape, wk, got, job in ladder_holds:
        want, secs = job.result()
        err = int(np.abs(got.numpy().astype(np.int64)
                         - want.astype(np.int64)).max())
        max_err = max(max_err, err)
        print(f"  {what}: K={shape[0]} r_pad={shape[1]} wk={wk} "
              f"max_abs_err={err} (plain version {secs:.1f} s)",
              flush=True)
        if err != 0:
            fail(f"wgl_wave disagrees with its plain version on {what}")
    stop_hold_workers()

    # -- 9. the simulator: drain, generation, checks, fused pipeline ---
    marks.append((9, time.perf_counter()))
    sim_entries = simulator_phase(card, torch.device("cuda", 0))

    # -- 10. the checker service: a campaign through one service --------
    marks.append((10, time.perf_counter()))
    svc_entries = service_phase(card, torch.device("cuda", 0))

    # -- 11. the test entry point on the simulated cluster --------------
    marks.append((11, time.perf_counter()))
    runner = runner_phase(card, torch.device("cuda", 0))
    batch_entries[0]["launches"] += runner["launches"]
    batch_entries[0]["max_abs_err"] = max(batch_entries[0]["max_abs_err"],
                                          runner["max_abs_err"])

    # -- 12. stream, set, lock and MVCC -----------------------------------
    marks.append((12, time.perf_counter()))
    streamed = stream_phase(card, torch.device("cuda", 0),
                            runner["baseline"])
    launches += streamed["single"]
    max_err = max(max_err, streamed["max_abs_err"])
    batch_entries[0]["launches"] += streamed["batch"]

    # -- 13. the campaign runner ----------------------------------------
    marks.append((13, time.perf_counter()))
    camp = campaign_phase(card, torch.device("cuda", 0))
    batch_entries[0]["launches"] += camp["wgl_wave"]
    for e in sim_entries:
        e["launches"] += {"drain_register": camp["drain"],
                          "threefry_draws": camp["draws"]
                          + streamed["draws"]}[e["name"]]

    # -- 14. the live side ----------------------------------------------
    marks.append((14, time.perf_counter()))
    live = live_phase(card, torch.device("cuda", 0))
    batch_entries[0]["launches"] += live["launches"]

    # -- 15. the readers: store index, serve, lint ------------------------
    marks.append((15, time.perf_counter()))
    readers_phase(card, runner, camp)

    # -- 16. the reference's fault packages -------------------------------
    marks.append((16, time.perf_counter()))
    faults = faults_phase(card, torch.device("cuda", 0))
    batch_entries[0]["launches"] += faults["launches"]

    marks.append((None, time.perf_counter()))
    print("section seconds on " + card + ": " + ", ".join(
        f"{n} {t1 - t0:.1f}" for (n, t0), (_, t1) in zip(marks, marks[1:]))
        + f"; all sections {marks[-1][1] - marks[0][1]:.1f} s (the "
        f"script's limit: 1200 s)",
        flush=True)
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
        "library_ms": None}, frame_entry, rung] + batch_entries
        + elle_entries + sim_entries + svc_entries}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        main()
    finally:
        stop_hold_workers()
