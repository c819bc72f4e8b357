"""Test composition: the etcd-test analog (etcd.clj:90-155).

Builds a full test map from CLI-style opts: workload + db + nemesis
package + the phased generator (main phase at :rate under the nemesis,
then heal, recover, final client generator) + the composed checker stack.

The database is the simulated cluster (``--db sim``, the default for
the direct and etcdctl clients), an external etcd cluster reached over
the live wire (``--db live``, the default for the http and grpc
clients), or etcd processes this machine spawns and faults (``--db
local``, db/local.py). ``opts["device"]`` names the device the checkers
run on: None (the default) is the card, and with no card composing the
test raises, before a gateway or process is started; ``"cpu"`` runs the
kernels' plain PyTorch versions.
"""

from __future__ import annotations

from .generators import (phases, stagger, time_limit, nemesis as gen_nemesis,
                         clients as gen_clients, log as gen_log, sleep_gen)
from .workloads import workloads
from .checkers import (compose as compose_checkers, Stats,
                       UnhandledExceptions, LogFilePattern, ClockPlot,
                       Perf, TimelineHtml)
from .db import db as make_db
from .nemesis import nemesis_package
from .runner.sim import SECOND
from .device import resolve_device

DEFAULT_NODES = ["n1", "n2", "n3", "n4", "n5"]


def default_opts() -> dict:
    """CLI defaults mirroring cli-opts (etcd.clj:157-209): every key and
    default of the reference's, plus the port's ``device``."""
    return {
        "nodes": list(DEFAULT_NODES),
        "workload": "register",
        "nemesis": [],                  # e.g. ["kill", "partition"]
        "nemesis_interval": 5,          # seconds (etcd.clj:177-180)
        "rate": 200.0,                  # hz (etcd.clj:190-193)
        "ops_per_key": 200,             # etcd.clj:182-185
        "time_limit": 30,               # seconds
        "concurrency": None,            # default 2n
        "serializable": False,
        "lazyfs": False,
        "client_type": "direct",        # or "etcdctl" (etcd.clj:161-164)
        "db_mode": None,                # sim | live | local (None: infer
                                        # from client_type)
        "etcd_binary": None,            # --db local: argv prefix; None =
                                        # etcd from PATH, else fake stub
        "etcd_data_dir": None,          # --db local: data/log root
        "etcd_env": None,               # --db local: extra child env
        "snapshot_count": 100,          # etcd.clj:197-200
        "unsafe_no_fsync": False,       # etcd.clj:204 (opt-in, like etcd)
        "corrupt_check": False,         # etcd.clj:164
        "seed": 0,
        "device": None,                 # the checkers' device: None =
                                        # the card (device.resolve_device
                                        # raises when there is none);
                                        # "cpu" runs the kernels' plain
                                        # PyTorch versions
        "debug": False,
        "no_telemetry": False,          # every run writes telemetry.jsonl
                                        # unless opted out (--no-telemetry)
        "stream": False,                # --stream: online chunked checking
                                        # overlapped with generation
                                        # (runner/stream.py)
        "stream_chunk_ops": 1024,       # ops per streamed chunk
        "key_offset": 0,                # first register key id (soak
                                        # windows rotate it so a retained
                                        # cluster never re-serves a
                                        # checked key)
        "soak": False,                  # --soak: sliding-window run
                                        # against one long-lived cluster
        "soak_windows": 0,              # 0 = run until interrupted
        "soak_window_s": None,          # per-window time limit (None:
                                        # --time-limit)
        "soak_net_faults": [],          # --soak-net-fault schedule:
                                        # windows cycle [healthy]+these,
                                        # each held for a whole window
                                        # on the proxy plane
        "version": "sim-3.5.6",         # etcd.clj:206-207 (pinned: the sim
                                        # has exactly one "binary")
        "checker_service": None,        # AF_UNIX socket path or
                                        # tcp://HOST:PORT endpoint of a
                                        # campaign checker service
                                        # (runner/checker_service.py);
                                        # None = check in-process. Env
                                        # JEPSEN_ETCD_TPU_CHECKER_SERVICE
                                        # is the fallback source.
        "checker_service_token": None,  # shared-secret auth token for
                                        # a TCP checker service (env
                                        # JEPSEN_ETCD_TPU_SERVICE_TOKEN
                                        # is the fallback source)
        "host_id": None,                # this run's generator-host
                                        # name: stamps the JET-HOST
                                        # preamble + the service's
                                        # service.host_submitted.*
                                        # ledger (campaign --hosts
                                        # sets it per agent; env
                                        # JEPSEN_ETCD_TPU_HOST is the
                                        # fallback source)
        "force_kernel": False,          # disable the native-DFS size
                                        # cutoff so every key is
                                        # device-bound (campaign
                                        # coalescing tests/bench on CPU;
                                        # production leaves the measured
                                        # routing alone)
        "net_proxy": False,             # --db local: front every peer/
                                        # client URL with the userspace
                                        # proxy plane (net/plane.py).
                                        # Auto-set when partition or
                                        # latency faults are requested.
        "gen_epoch": "epoch-v1",        # generator epoch (see the epoch
                                        # ledger in runner/sim.py):
                                        # epoch-v1 = SimLoop event loop;
                                        # epoch-v2 routes campaign sim
                                        # runs through the batched
                                        # lockstep generator on the host
                                        # (simbatch/), epoch-v3 through
                                        # its draws and drain on the card
        "inject_stale_reads": False,    # seed a stale-read serving bug
                                        # in the batched sim (guided-
                                        # campaign quarry; with nemeses
                                        # present it only fires inside
                                        # open partition windows)
        "nem_schedule": None,           # explicit nemesis schedule:
                                        # [[start_ns, kind, hold_ns],
                                        # ...] replayed verbatim instead
                                        # of the drawn fault plan
                                        # (shrink repros, guided window
                                        # mutations)
        "nem_partition_shape": None,    # partition grudge override
                                        # (majority | primaries | ...);
                                        # None keeps the drawn shape
        "nem_latency_ms": None,         # latency-fault delta override
                                        # in ms; scales the latency
                                        # window timeout probability
        "nem_drop_prob": 0.0,           # extra flat drop probability
                                        # added inside every open fault
                                        # window
        "staleness_bound_s": 8.0,       # register-stale: max excusable
                                        # read lag (virtual seconds)
                                        # without an open fault window
        "lease_ttl_ms": 1500,           # lock-lease: never-renewed
                                        # lease TTL (churn pressure)
        "compact_keep": 8,              # compact-watch: revisions kept
                                        # behind the head per compaction
        "inject_stale_snapshot": False,  # MVCC injection hooks
        "inject_torn_range": False,      # (simbatch/engine.py): each
        "inject_double_grant": False,    # seeds the one bug its
        "inject_compaction_swallow": False,  # checker class pins
    }


#: faults the local control plane (db/local.py) can inject with plain
#: process-level privileges; partition + latency ride the userspace
#: TCP proxy plane (net/plane.py), raised automatically when requested
LOCAL_FAULTS = {"kill", "pause", "member", "admin", "partition",
                "latency"}

#: fault -> why `--db local` refuses it (each REMAINING failure mode is
#: specific and documented, not a blanket live-mode error; see README
#: "Fault / privilege matrix". Partition/latency used to live here —
#: the net proxy plane closed that gap.)
LOCAL_FAULT_REFUSALS = {
    "clock": ("clock skew needs per-process time virtualization "
              "(CAP_SYS_TIME / libfaketime); the local control plane "
              "does not alter the host clock"),
    "bitflip-wal": ("on-disk corruption injection targets the "
                    "simulated WAL/snapshot files; a real etcd's data "
                    "dir has no byte-level corruption hook here"),
}
LOCAL_FAULT_REFUSALS["bitflip-snap"] = LOCAL_FAULT_REFUSALS["bitflip-wal"]
LOCAL_FAULT_REFUSALS["truncate-wal"] = LOCAL_FAULT_REFUSALS["bitflip-wal"]


def fault_matrix(db_mode: str = "local") -> dict:
    """fault -> {"supported": bool, "why": refusal-or-None} for the
    given db mode; the README table and test_config_plane assert these
    rows. Sim supports everything; live supports nothing (the cluster
    is external)."""
    from .nemesis.faults import KNOWN_FAULTS
    rows = {}
    for fault in sorted(KNOWN_FAULTS):
        if db_mode == "live":
            supported, why = False, "external cluster: no control plane"
        elif db_mode == "local":
            supported = fault in LOCAL_FAULTS
            why = None if supported else LOCAL_FAULT_REFUSALS.get(
                fault, "not implemented")
        else:
            supported, why = True, None
        rows[fault] = {"supported": supported, "why": why}
    return rows


def _check_fault_support(db_mode: str, o: dict) -> None:
    """Refuse unsupportable fault requests up front, specifically."""
    faults = list(o.get("nemesis") or [])
    if not faults:
        return
    if db_mode == "live":
        # the reference faults real nodes over SSH (db.clj); an
        # external cluster offers only the client wire
        raise ValueError(
            f"live mode (--client-type {o['client_type']}) has no "
            f"control plane for faults {faults}: the cluster is "
            "external. Use --db local to spawn and fault local etcd "
            "processes, or the simulated cluster")
    if db_mode == "local":
        refused = [f for f in faults if f not in LOCAL_FAULTS]
        if refused:
            reasons = "; ".join(
                f"{f}: {LOCAL_FAULT_REFUSALS.get(f, 'not implemented')}"
                for f in sorted(set(refused)))
            raise ValueError(
                f"--db local cannot inject {sorted(set(refused))} — "
                f"{reasons}. Supported local faults: "
                f"{sorted(LOCAL_FAULTS)}")


def etcd_test(opts: dict) -> dict:
    """Compose opts into a runnable test map (etcd-test, etcd.clj:90-155)."""
    o = default_opts()
    o.update(opts or {})
    n = len(o["nodes"])
    if not o.get("concurrency"):
        o["concurrency"] = 2 * n
    # the card unless the caller names another device; raises here,
    # before anything runs, when there is none
    resolve_device(o["device"])
    wl_fn = workloads()[o["workload"]]
    workload = wl_fn(o)
    live = o["client_type"] in ("http", "grpc")
    db_mode = o.get("db_mode") or ("live" if live else "sim")
    o["db_mode"] = db_mode
    if db_mode in ("live", "local") and not live:
        raise ValueError(
            f"--db {db_mode} drives real etcd over the live wire; use "
            "--client-type http or grpc (direct/etcdctl speak to the "
            "simulated cluster only)")
    if db_mode == "sim" and live:
        raise ValueError(
            f"--client-type {o['client_type']} speaks to real etcd; "
            "--db sim has no live endpoints. Use --db live (external "
            "cluster) or --db local (locally spawned processes)")
    _check_fault_support(db_mode, o)
    if db_mode == "local" and \
            {"partition", "latency"} & set(o.get("nemesis") or []):
        # network faults in local mode ride the userspace proxy plane
        o["net_proxy"] = True
    if db_mode == "local":
        from .db.local import local_db
        o["db"] = local_db(o)
    elif db_mode == "live":
        from .db.live import live_db
        o["db"] = live_db(o)
    else:
        o["db"] = make_db(o)
    nem = nemesis_package(o)

    rate_gap = int(SECOND / o["rate"]) if o["rate"] else 0
    main_gen = workload["generator"]
    if rate_gap:
        main_gen = stagger(rate_gap, main_gen)
    main_phase = time_limit(
        int(o["time_limit"] * SECOND),
        gen_nemesis(
            phases(sleep_gen(5 * SECOND), nem.get("generator")),
            main_gen))

    phase_list: list = [main_phase]
    if nem.get("generator") is not None or \
            nem.get("final_generator") is not None:
        # heal + 10 s recovery window only when faults actually ran:
        # free in virtual time, but a live run pays it in real seconds
        phase_list.append(gen_log("Healing cluster"))
        if nem.get("final_generator") is not None:
            phase_list.append(gen_nemesis(nem["final_generator"]))
        phase_list.append(gen_log("Waiting for recovery"))
        phase_list.append(sleep_gen(10 * SECOND))
    if workload.get("final_generator") is not None:
        phase_list.append(gen_clients(workload["final_generator"]))

    checker = compose_checkers({
        "perf": Perf(nemesis_perf=nem.get("perf", [])),
        # top level, not per workload: the full history (nemesis ops
        # included) renders the positioned timeline with fault bands;
        # a per-key subhistory would lose both
        "timeline": TimelineHtml(nemesis_perf=nem.get("perf", [])),
        "clock": ClockPlot(),
        "stats": Stats(),
        "exceptions": UnhandledExceptions(),
        "crash": LogFilePattern(),
        "workload": workload["checker"],
    })

    name = "etcd " + " ".join(
        [o["workload"]] +
        (["sz"] if o["serializable"] else []) +
        (sorted(o["nemesis"]) if o["nemesis"] else []))
    test = dict(o)
    test.update({
        "name": name.replace(" ", "-"),
        # the fault-name list survives here: test["nemesis"] below is
        # the live nemesis OBJECT, which save_run excludes from
        # test.json — the spec is what run reports need
        "nemesis_spec": list(o["nemesis"]),
        "client": workload["client"],
        "generator": phases(*[p for p in phase_list if p is not None]),
        "checker": checker,
        "nemesis": nem.get("nemesis"),
        "nemesis_package": nem,
    })
    return test
