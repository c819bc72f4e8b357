"""CLI: `python -m jepsen_etcd_tpu_torch test|test-all|campaign|...`.

Mirrors the reference's lein run commands and flags (etcd.clj:157-257):
test runs one composed test; test-all sweeps
nemeses x workloads; campaign fans the matrix over a pool of worker
processes (or ``--hosts`` worker agents) with one checker service, or
runs a coverage-guided search (``--guided``); checker-service runs the
batched checker service (``runner/checker_service.py``) until
interrupted; replay re-executes a minimized repro (``shrink.json``);
worker-agent is one campaign host agent; tel mines telemetry artifacts;
gateway serves an etcd v3 endpoint (JSON, or gRPC with ``--grpc``) over
the simulated MVCC store. The checkers run on ``--device`` (default
``cuda``); ``--device cpu`` runs the kernels' plain PyTorch versions.
``--stream`` checks online while the run generates (runner/stream.py).
``--client-type http|grpc`` drives real etcd: an external cluster at
``--endpoint`` (``--db live``) or processes this machine spawns and
faults (``--db local``); ``--soak`` checks one long-lived cluster window
by window; serve browses a store over local HTTP; store indexes and
compacts one.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from .compose import etcd_test
from .workloads import workloads, ALL_WORKLOADS, WORKLOADS_EXPECTED_TO_PASS
from .runner.test_runner import run_test

# nemesis combinations swept by test-all (etcd.clj:60-73)
ALL_NEMESES = [
    ["admin"],
    ["pause", "admin"],
    ["kill", "admin"],
    ["partition", "admin"],
    ["latency", "admin"],
    ["member", "admin"],
    ["bitflip-wal", "bitflip-snap", "admin"],
    ["bitflip-wal", "bitflip-snap", "kill"],
    ["admin", "bitflip-snap", "bitflip-wal", "pause", "kill", "partition",
     "latency", "clock", "member"],
]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="jepsen_etcd_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    subs = {}
    for cmd in ("test", "test-all", "campaign"):
        s = sub.add_parser(cmd)
        subs[cmd] = s
        # None means "register" for test, "all workloads" for test-all
        # (the reference's test-all honors -w as a narrowing filter,
        # etcd.clj:238-242)
        s.add_argument("-w", "--workload", default=None,
                       choices=sorted(workloads().keys()))
        s.add_argument("--nemesis", default="",
                       help="comma-separated faults: kill,pause,partition,"
                            "latency,clock,member,corrupt,admin,all,none")
        s.add_argument("--nemesis-interval", type=float, default=5.0)
        s.add_argument("-r", "--rate", type=float, default=200.0)
        s.add_argument("--ops-per-key", type=int, default=200)
        s.add_argument("--time-limit", type=float, default=30.0)
        s.add_argument("-c", "--concurrency", default=None,
                       help="worker count; suffix n multiplies node count "
                            "(e.g. 4n)")
        s.add_argument("--nodes", default="n1,n2,n3,n4,n5")
        s.add_argument("--serializable", action="store_true")
        s.add_argument("--lazyfs", action="store_true")
        s.add_argument("--client-type", default="direct",
                       choices=["direct", "etcdctl", "http", "grpc"],
                       help="direct/etcdctl drive the simulated cluster; "
                            "http drives a LIVE etcd over its v3 JSON "
                            "gateway, grpc over native gRPC — the "
                            "reference's wire protocol "
                            "(etcd.clj:246-257, client.clj:14-68)")
        s.add_argument("--endpoint", default="http://127.0.0.1:2379",
                       help="comma-separated live-etcd endpoint URLs "
                            "(only with --client-type http/grpc); each "
                            "endpoint is a node")
        s.add_argument("--db", default=None,
                       choices=["sim", "live", "local"],
                       help="cluster lifecycle: sim (default for "
                            "direct/etcdctl), live (external cluster at "
                            "--endpoint, no fault control plane), local "
                            "(spawn+supervise etcd processes on this "
                            "machine — kill/pause/member/admin faults "
                            "work; default for http/grpc is live)")
        s.add_argument("--etcd-binary", default=None,
                       help="--db local: etcd argv (shell-split). "
                            "Default: etcd from PATH if present, else "
                            "the bundled fake-etcd stub; 'fake' forces "
                            "the stub")
        s.add_argument("--etcd-data-dir", default=None,
                       help="--db local: root for per-node data dirs "
                            "and logs (default: a fresh temp dir)")
        s.add_argument("--net-proxy", action="store_true",
                       help="--db local: front every peer/client URL "
                            "with the userspace TCP proxy plane "
                            "(net/plane.py) even when no network fault "
                            "is requested; partition/latency faults "
                            "raise it automatically")
        s.add_argument("--snapshot-count", type=int, default=100)
        s.add_argument("--unsafe-no-fsync", action="store_true",
                       help="ask the SUT not to fsync WAL appends "
                            "(etcd.clj:204)")
        s.add_argument("--corrupt-check", action="store_true",
                       help="enable the runtime corruption monitor: "
                            "initial check at boot + a sweep every "
                            "virtual minute (etcd.clj:164, db.clj:97-99)")
        s.add_argument("-v", "--version", default="sim-3.5.6",
                       help="SUT version to run (etcd.clj:206-207; the "
                            "sim ships exactly one)")
        s.add_argument("--seed", type=int, default=0)
        s.add_argument("--debug", action="store_true")
        s.add_argument("--tcpdump", action="store_true",
                       help="record a message-level network trace to "
                            "store/<run>/trace.jsonl (db.clj:276-277)")
        s.add_argument("--no-telemetry", action="store_true",
                       help="skip writing store/<run>/telemetry.jsonl "
                            "(phase/checker spans and kernel counters "
                            "are on by default)")
        s.add_argument("--soak", action="store_true",
                       help="sliding-window soak against ONE long-lived "
                            "cluster (--client-type http/grpc): each "
                            "window is generated, streamed, checked and "
                            "released before the next, so memory stays "
                            "bounded indefinitely")
        s.add_argument("--soak-windows", type=int, default=0,
                       help="number of soak windows (0 = run until "
                            "interrupted)")
        s.add_argument("--soak-window-s", type=float, default=None,
                       help="per-window time limit in seconds "
                            "(default: --time-limit)")
        s.add_argument("--soak-net-fault", action="append", default=None,
                       metavar="KIND[:ARG]",
                       help="long-lived net-plane fault schedule "
                            "(--db local): windows cycle through "
                            "[healthy] + these faults, each applied to "
                            "the proxy plane for the WHOLE window and "
                            "healed after. Kinds: latency[:delta-ms], "
                            "drop[:probability], partition. Repeatable")
        s.add_argument("--test-count", type=int, default=1)
        s.add_argument("--inject-stale-reads", action="store_true",
                       help="seed the sim's stale-read bug class "
                            "(the batched generator, epoch-v2/v3): "
                            "reads may return the pre-last-write "
                            "snapshot — with faults configured, only "
                            "inside an open partition window (the "
                            "guided-campaign target); with none, "
                            "unconditionally")
        s.add_argument("--stream", action="store_true",
                       help="online chunked checking: feed recorded op "
                            "columns to checker front-ends while "
                            "generation runs; verdicts stay "
                            "bit-identical to post-hoc")
        s.add_argument("--stream-chunk-ops", type=int, default=1024,
                       help="recorded ops per streamed chunk "
                            "(default 1024)")
        s.add_argument("--staleness-bound-s", type=float, default=None,
                       help="register-stale: max excusable read lag in "
                            "virtual seconds (default 8.0)")
        s.add_argument("--lease-ttl-ms", type=float, default=None,
                       help="lock-lease: lease TTL clipping certain-"
                            "hold windows (default 1500)")
        s.add_argument("--compact-keep", type=int, default=None,
                       help="compact-watch: revisions kept behind the "
                            "compaction watermark (default 8)")
        s.add_argument("--only-workloads-expected-to-pass",
                       action="store_true")
        s.add_argument("--store", default="store")
        s.add_argument("--checker-service", default=None,
                       help="AF_UNIX socket of a running checker "
                            "service (see the checker-service "
                            "subcommand): device-bound checks are "
                            "shipped there and batched across every "
                            "submitting run; unset = check in-process "
                            "(campaign hosts its own unless "
                            "--no-service)")
        s.add_argument("--device", default="cuda",
                       help="device the checkers run on (default cuda: "
                            "the hand-written kernels; raises when no "
                            "card is present). cpu runs their plain "
                            "PyTorch versions")
    camp = subs["campaign"]
    camp.add_argument("--pool", type=int, default=4,
                      help="worker processes running tests concurrently "
                           "(0 = inline in this process)")
    camp.add_argument("--no-service", action="store_true",
                      help="skip the shared checker service: every "
                           "worker dispatches its own device checks "
                           "(pays the per-run dispatch floor)")
    camp.add_argument("--no-live", action="store_true",
                      help="skip the live telemetry collector (no "
                           "live.sock/live.json); runs record exactly "
                           "as before")
    camp.add_argument("--service-tick", type=float, default=0.05,
                      help="checker-service coalescing window in "
                           "seconds: pending packs from all runners "
                           "batch into one dispatch per (bucket, "
                           "width) per tick")
    camp.add_argument("--campaign-name", default="campaign",
                      help="store dir name for the campaign summary "
                           "(store/<name>/<id>/campaign.json)")
    camp.add_argument("--gen-epoch", default="epoch-v1",
                      choices=["epoch-v1", "epoch-v2", "epoch-v3"],
                      help="generator epoch (epoch ledger, runner/"
                           "sim.py): epoch-v2 routes every sim run "
                           "through the batched lockstep generator "
                           "(simbatch/) on the host — S seeds per "
                           "(workload, nemesis) cell generated in one "
                           "columnar pass, histories born as "
                           "OpColumns; epoch-v3 runs the same cells "
                           "with their draws and drain on --device "
                           "(MVCC workloads delegate to the epoch-v2 "
                           "sweep); runs the batched generator cannot "
                           "serve (live clusters, unsupported "
                           "workloads, --stream/--soak) fall back to "
                           "epoch-v1, and every campaign.json row "
                           "records the epoch that actually produced it")
    camp.add_argument("--hosts", type=int, default=0,
                      help="multi-host fan-out: spawn N worker-agent "
                           "processes (host1..hostN) that pull runs "
                           "over loopback TCP and ship device checks "
                           "to the campaign's TCP checker service "
                           "with a campaign-minted auth token; "
                           "replaces --pool for the non-batched "
                           "specs (0 = local process pool)")
    camp.add_argument("--force-kernel", action="store_true",
                      help="disable the native-DFS size cutoff so "
                           "every key is device-bound (coalescing "
                           "demos/tests; production keeps the "
                           "measured routing)")
    camp.add_argument("--guided", type=int, default=0, metavar="N",
                      help="coverage-guided mode: spend a budget of N "
                           "runs adaptively instead of sweeping the "
                           "matrix uniformly — generation 0 "
                           "stratifies one run per cell, later "
                           "generations mutate a corpus of "
                           "novelty-scored ancestors (runner/"
                           "guided.py); failing schedules are "
                           "delta-debugged to minimal repros "
                           "(shrink.json). Forces gen-epoch epoch-v2 "
                           "for sim specs")
    camp.add_argument("--master-seed", type=int, default=None,
                      help="--guided: the search RNG seed (mutation/"
                           "crossover draws; default: --seed) — one "
                           "master seed fully determines the search")
    camp.add_argument("--corpus-in", default=None, metavar="PATH",
                      help="--guided: warm-start from a corpus "
                           "exported by --corpus-out — ancestors "
                           "join the pool and already-seen "
                           "signatures/cells/envelope peaks stop "
                           "scoring as novel")
    camp.add_argument("--corpus-out", default=None, metavar="PATH",
                      help="--guided: export the final novelty-scored "
                           "corpus (ancestors, envelope, signature/"
                           "cell ledgers) as JSON for a later "
                           "--corpus-in")
    cs = sub.add_parser("checker-service",
                        help="run a standalone batched checker service: "
                             "one process owns the card; concurrent "
                             "test invocations point --checker-service "
                             "at its socket and their device checks "
                             "coalesce into one dispatch per (bucket, "
                             "width) per tick")
    cs.add_argument("--socket", default=None,
                    help="AF_UNIX socket path (default: a fresh temp "
                         "path, printed on stdout)")
    cs.add_argument("--tick", type=float, default=0.05,
                    help="coalescing window seconds")
    cs.add_argument("--tcp", nargs="?", const=True, default=None,
                    metavar="[HOST:]PORT",
                    help="also listen on TCP for multi-host clients "
                         "(bare --tcp: loopback ephemeral port, "
                         "printed on stdout); pair with --token or "
                         "JEPSEN_ETCD_TPU_SERVICE_TOKEN so only the "
                         "fleet can submit")
    cs.add_argument("--token", default=None,
                    help="shared-secret auth token TCP clients must "
                         "present (default: env "
                         "JEPSEN_ETCD_TPU_SERVICE_TOKEN; unset = "
                         "unauthenticated)")
    wa = sub.add_parser("worker-agent",
                        help="one generator-host agent: registers "
                             "with a campaign's HostAgentPool over "
                             "TCP, pulls run specs, ships device "
                             "checks to the fleet's checker service, "
                             "returns summary rows (spawned by "
                             "campaign --hosts; rarely run by hand)")
    wa.add_argument("--connect", required=True,
                    help="the pool endpoint (tcp://HOST:PORT)")
    wa.add_argument("--host", required=True,
                    help="this agent's host name (row + ledger "
                         "attribution)")
    wa.add_argument("--token", default=None,
                    help="pool auth token (default: env "
                         "JEPSEN_ETCD_TPU_SERVICE_TOKEN)")
    srv = sub.add_parser("serve", help="serve the store dir over HTTP "
                                       "(etcd.clj:250-252)")
    srv.add_argument("--store", default="store")
    srv.add_argument("-p", "--port", type=int, default=8080)
    srv.add_argument("-b", "--bind", default="127.0.0.1")
    gw = sub.add_parser("gateway",
                        help="serve an etcd v3 JSON-gateway endpoint "
                             "backed by the simulated MVCC store (the "
                             "real-etcd adapter's hermetic test double)")
    gw.add_argument("-p", "--port", type=int, default=2379)
    gw.add_argument("--grpc", action="store_true",
                    help="serve native gRPC (etcdserverpb) instead of "
                         "the JSON gateway")
    tl = sub.add_parser("tel",
                        help="mine telemetry artifacts offline: span "
                             "percentile tables (default), --diff "
                             "two runs, --ledger a campaign dir, or "
                             "--coverage feature vectors; does no "
                             "device work")
    tl.add_argument("paths", nargs="+",
                    help="telemetry.jsonl/service.jsonl files, run "
                         "dirs, campaign dirs, or a store base "
                         "(--coverage)")
    tl.add_argument("--diff", action="store_true",
                    help="compare spans across exactly two inputs")
    tl.add_argument("--ledger", action="store_true",
                    help="verify a campaign's shipped/queue-wait/"
                         "trace-join accounting (exit 1 on mismatch)")
    tl.add_argument("--coverage", action="store_true",
                    help="emit the per-run + aggregate coverage "
                         "vector (frontier, wave depth, rungs, "
                         "spills, verdict signatures)")
    tl.add_argument("--corpus", action="store_true",
                    help="inspect a guided campaign (guided.json): "
                         "corpus ancestors, novel signatures, "
                         "minimized repros")
    tl.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    tl.add_argument("--no-index", action="store_true", dest="no_index",
                    help="bypass the store index and walk the tree "
                         "(output is bit-identical either way)")
    so = sub.add_parser("store",
                        help="artifact-store maintenance: build/verify "
                             "the sqlite run index, or compact old "
                             "passing runs to summaries; does no "
                             "device work")
    so.add_argument("action", choices=("index", "compact"),
                    help="index: verify (default) or --rebuild the "
                         "run index; compact: demote old passing runs "
                         "to index rows + summary files")
    so.add_argument("--store", default="store",
                    help="store base directory (default: store)")
    so.add_argument("--rebuild", action="store_true",
                    help="with `index`: backfill the index from the "
                         "tree in one transaction (also recurses into "
                         "guided sub-stores)")
    so.add_argument("--keep", type=int, default=32,
                    help="with `compact`: newest N runs spared "
                         "regardless of verdict (default 32)")
    so.add_argument("--dry-run", action="store_true", dest="dry_run",
                    help="with `compact`: report what would be "
                         "demoted without deleting anything")
    rp = sub.add_parser("replay",
                        help="re-execute a minimized repro "
                             "(shrink.json): regenerate the history "
                             "from the stored config + seed via the "
                             "batched generator, re-check it, and "
                             "verify the verdict signature matches "
                             "(exit 1 when it does not)")
    rp.add_argument("artifact",
                    help="path to a shrink.json store artifact (or a "
                         "run dir containing one)")
    rp.add_argument("--device", default="cuda",
                    help="device the re-check runs on (default cuda; "
                         "raises when no card is present). cpu runs "
                         "the kernels' plain PyTorch versions")
    return p


SPECIAL_NEMESES = {  # etcd.clj:75-80
    "none": [],
    "corrupt": ["bitflip-wal", "bitflip-snap", "truncate-wal"],
    "all": ["admin", "pause", "kill", "bitflip-wal", "bitflip-snap",
            "truncate-wal", "partition", "latency", "clock", "member"],
}


def parse_nemesis_spec(spec: str) -> list[str]:
    out: list[str] = []
    for tok in filter(None, (t.strip() for t in spec.split(","))):
        out.extend(SPECIAL_NEMESES.get(tok, [tok]))
    return sorted(set(out))


def opts_from_args(args) -> dict:
    """The run opts of a parsed command line: the reference's keys,
    plus ``device``."""
    db_mode = getattr(args, "db", None)
    if args.client_type in ("http", "grpc") and db_mode != "local":
        # live mode: nodes ARE the endpoint URLs
        nodes = [e.strip() for e in args.endpoint.split(",") if e.strip()]
    else:
        # sim and local modes: nodes are NAMES (local maps name ->
        # client URL in db/local.py)
        nodes = [n.strip() for n in args.nodes.split(",") if n.strip()]
    conc = args.concurrency
    if isinstance(conc, str):
        if conc.endswith("n"):
            conc = int(conc[:-1] or 1) * len(nodes)
        else:
            conc = int(conc)
    return {
        "nodes": nodes,
        "workload": args.workload or "register",
        "nemesis": parse_nemesis_spec(args.nemesis),
        "nemesis_interval": args.nemesis_interval,
        "rate": args.rate,
        "ops_per_key": args.ops_per_key,
        "time_limit": args.time_limit,
        "concurrency": conc,
        "serializable": args.serializable,
        "lazyfs": args.lazyfs,
        "client_type": args.client_type,
        "db_mode": db_mode,
        "etcd_binary": getattr(args, "etcd_binary", None),
        "etcd_data_dir": getattr(args, "etcd_data_dir", None),
        "net_proxy": getattr(args, "net_proxy", False),
        "snapshot_count": args.snapshot_count,
        "unsafe_no_fsync": args.unsafe_no_fsync,
        "corrupt_check": args.corrupt_check,
        "version": args.version,
        "seed": args.seed,
        "debug": args.debug,
        "tcpdump": args.tcpdump,
        "no_telemetry": getattr(args, "no_telemetry", False),
        "inject_stale_reads": getattr(args, "inject_stale_reads",
                                      False),
        "checker_service": getattr(args, "checker_service", None),
        "stream": getattr(args, "stream", False),
        "stream_chunk_ops": getattr(args, "stream_chunk_ops", 1024),
        "soak": getattr(args, "soak", False),
        "soak_windows": getattr(args, "soak_windows", 0),
        "soak_window_s": getattr(args, "soak_window_s", None),
        "soak_net_faults": getattr(args, "soak_net_fault", None) or [],
        "store_base": args.store,
        # MVCC surface thresholds: only carried when given, so
        # compose.default_opts keeps supplying the reference values
        **{k: v for k, v in (
            ("staleness_bound_s", getattr(args, "staleness_bound_s",
                                          None)),
            ("lease_ttl_ms", getattr(args, "lease_ttl_ms", None)),
            ("compact_keep", getattr(args, "compact_keep", None)),
        ) if v is not None},
        "device": args.device,
    }


def test_all_matrix(args) -> tuple[list, list]:
    """The test-all sweep axes, narrowed by -w / --nemesis when given
    (all-tests, etcd.clj:236-242: a single workload or nemesis combo
    replaces the full axis)."""
    if args.workload:
        wls = [args.workload]
    elif args.only_workloads_expected_to_pass:
        wls = list(WORKLOADS_EXPECTED_TO_PASS)
    else:
        wls = list(ALL_WORKLOADS)
    nemeses = [parse_nemesis_spec(args.nemesis)] if args.nemesis \
        else ALL_NEMESES
    return wls, nemeses


def run_one(opts: dict) -> dict:
    test = etcd_test(opts)
    out = run_test(test)
    print(json.dumps({
        "test": test["name"],
        "valid?": out["valid?"],
        "ops": len(out["history"]),
        "sim-seconds": round(out["sim-seconds"], 1),
        "wall-seconds": round(out["wall-seconds"], 2),
        "dir": out["dir"],
    }))
    return out


def run_campaign_command(args) -> int:
    """The ``campaign`` command: a matrix sweep through
    ``run_campaign``, or with ``--guided N`` a coverage-guided search
    through ``run_guided``; both resolve ``--device`` before the pool,
    the agents or the service start."""
    from .runner.campaign import campaign_specs, run_campaign
    base = opts_from_args(args)
    if args.force_kernel:
        base["force_kernel"] = True
    base["gen_epoch"] = args.gen_epoch
    wls, nemeses = test_all_matrix(args)
    if args.guided:
        from .runner.guided import run_guided

        def _print_guided_row(row):
            print(json.dumps({k: row.get(k) for k in
                              ("index", "workload", "nemesis",
                               "seed", "status", "valid", "dir")}))

        out = run_guided(
            base, wls, nemeses, budget=args.guided,
            seed0=args.seed, master_seed=args.master_seed,
            pool=args.pool,
            service=not args.no_service and not base.get(
                "checker_service"),
            service_tick_s=args.service_tick,
            store_base=args.store,
            name=args.campaign_name
            if args.campaign_name != "campaign" else "guided",
            live=not args.no_live, hosts=args.hosts or None,
            on_row=_print_guided_row,
            corpus_in=args.corpus_in, corpus_out=args.corpus_out)
        print(json.dumps({
            "guided": out["name"], "dir": out["dir"],
            "budget": out["budget"], "runs": out["runs"],
            "generations": out["generations"],
            "signatures": out["signatures"],
            "first_failure_run": out["first_failure_run"],
            "corpus": len(out["corpus"]),
            "corpus_imported": out["corpus_imported"],
            "corpus_out": out["corpus_out"],
            "minimized": [{k: m.get(k) for k in
                           ("dir", "signature", "windows",
                            "nemesis_ops", "repro")}
                          for m in out["minimized"]],
            "wall_s": out["wall_s"],
        }))
        # a guided campaign EXISTS to find failures: exit 0 means the
        # search completed, not that every run passed
        return 0
    specs = campaign_specs(base, wls, nemeses,
                           runs_per_cell=args.test_count,
                           seed0=args.seed)

    def _print_row(row):
        print(json.dumps({k: row.get(k) for k in
                          ("index", "workload", "nemesis", "seed",
                           "status", "valid", "dir", "wall_s")}))

    out = run_campaign(
        specs, pool=args.pool,
        # an external service (--checker-service) rides in via the
        # per-spec opts; hosting one on top would shadow it
        service=not args.no_service and not base.get("checker_service"),
        service_tick_s=args.service_tick,
        store_base=args.store, name=args.campaign_name,
        live=not args.no_live,
        hosts=args.hosts or None,
        on_row=_print_row)
    svc_counters = ((out.get("service") or {}).get("counters") or {})
    print(json.dumps({
        "campaign": out["name"], "dir": out["dir"],
        "runs": out["count"], "valid?": out["valid?"],
        "failures": [repr(f) for f in out["failures"]],
        "wall_s": out["wall_s"],
        "service": {k: svc_counters[k] for k in sorted(svc_counters)
                    if k.startswith(("service.", "wgl.", "mxu."))}
        if svc_counters else None,
    }))
    return 0 if out["valid?"] else 1


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    if args.command == "serve":
        from .serve import serve_store
        return serve_store(args.store, args.port, args.bind)
    if args.command == "tel":
        from .tel_cli import run as tel_run
        return tel_run(args)
    if args.command == "store":
        from .runner.store_index import cli_store
        return cli_store(args)
    if args.command == "worker-agent":
        from .runner.host_agent import agent_main
        return agent_main(args.connect, args.host, token=args.token)
    if args.command == "gateway":
        log = logging.getLogger("jepsen_etcd_tpu_torch")
        if args.grpc:
            import time as _time
            from .sut.grpc_gateway import serve_grpc
            srv, _state, port = serve_grpc(args.port)
            log.info("etcd v3 gRPC gateway on 127.0.0.1:%d (sim store)",
                     port)
            try:
                while True:
                    _time.sleep(3600)
            except KeyboardInterrupt:
                srv.stop(0)
            return 0
        from .sut.http_gateway import serve as gw_serve
        srv, _state = gw_serve(args.port)
        log.info(
            "etcd v3 gateway on http://127.0.0.1:%d (sim store)",
            srv.server_address[1])
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        return 0
    if args.command == "checker-service":
        import time as _time
        from .runner.checker_service import CheckerService
        svc = CheckerService(path=args.socket, tick_s=args.tick,
                             tcp=args.tcp,
                             auth_token=args.token).start()
        print(json.dumps({"checker-service": svc.path,
                          "tcp": svc.tcp_endpoint}), flush=True)
        try:
            while True:
                _time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            svc.close()
        return 0
    if args.command == "replay":
        from .device import resolve_device
        from .runner.shrink import replay_artifact
        # the card unless --device names another: raises here, before
        # anything runs, when there is none
        resolve_device(args.device)
        path = args.artifact
        if os.path.isdir(path):
            path = os.path.join(path, "shrink.json")
        out = replay_artifact(path, device=args.device)
        print(json.dumps(out, indent=2, sort_keys=True))
        return 0 if out["match"] else 1
    if args.command == "campaign":
        return run_campaign_command(args)
    if args.command == "test":
        opts = opts_from_args(args)
        if opts.get("soak"):
            from .runner.test_runner import run_soak

            def _print_window(summary, _out):
                print(json.dumps(summary))
                return None

            try:
                out = run_soak(opts, on_window=_print_window)
            except KeyboardInterrupt:
                # interactive stop is the normal exit for
                # --soak-windows 0; the finally in run_soak already
                # tore the shared cluster down
                print(json.dumps({"soak": "interrupted"}))
                return 0
            print(json.dumps({"soak-windows": out["count"],
                              "valid?": out["valid?"]}))
            return 0 if out["valid?"] is True else 1
        ok = True
        for i in range(args.test_count):
            opts["seed"] = args.seed + i
            out = run_one(dict(opts))
            ok = ok and out["valid?"] is True
        return 0 if ok else 1
    # test-all: nemeses x workloads sweep (all-tests, etcd.clj:226-244)
    base = opts_from_args(args)
    wls, nemeses = test_all_matrix(args)
    failures = []
    for nem in nemeses:
        for wl in wls:
            for i in range(args.test_count):
                opts = dict(base)
                opts.update({"workload": wl, "nemesis": nem,
                             "seed": args.seed + i})
                try:
                    out = run_one(opts)
                    expected_pass = wl in WORKLOADS_EXPECTED_TO_PASS
                    if out["valid?"] is not True and expected_pass:
                        failures.append((wl, nem, out["valid?"]))
                except NotImplementedError as e:
                    print(f"SKIP {wl} {nem}: {e}")
    print(json.dumps({"failures": [repr(f) for f in failures]}))
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
