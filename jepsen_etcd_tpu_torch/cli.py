"""CLI: `python -m jepsen_etcd_tpu_torch test|test-all|checker-service`.

Mirrors the reference's lein run commands and flags (etcd.clj:157-257):
test runs one composed test on the simulated cluster; test-all sweeps
nemeses x workloads; checker-service runs the batched checker service
(``runner/checker_service.py``) until interrupted. The checkers run on
``--device`` (default ``cuda``); ``--device cpu`` runs the kernels'
plain PyTorch versions. The live side (``--client-type http|grpc``,
``--db local|live``, ``--soak``), ``--stream`` and the campaign,
serve, tel, store, gateway, replay and worker-agent commands are not
ported yet (ROADMAP A).
"""

from __future__ import annotations

import argparse
import json
import logging
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
    for cmd in ("test", "test-all"):
        s = sub.add_parser(cmd)
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
                       choices=["direct", "etcdctl"],
                       help="both drive the simulated cluster "
                            "(etcd.clj:161-164)")
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
        s.add_argument("--test-count", type=int, default=1)
        s.add_argument("--only-workloads-expected-to-pass",
                       action="store_true")
        s.add_argument("--store", default="store")
        s.add_argument("--checker-service", default=None,
                       help="AF_UNIX socket of a running checker "
                            "service (see the checker-service "
                            "subcommand): device-bound checks are "
                            "shipped there and batched across every "
                            "submitting run; unset = check in-process")
        s.add_argument("--device", default="cuda",
                       help="device the checkers run on (default cuda: "
                            "the hand-written kernels; raises when no "
                            "card is present). cpu runs their plain "
                            "PyTorch versions")
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
        "snapshot_count": args.snapshot_count,
        "unsafe_no_fsync": args.unsafe_no_fsync,
        "corrupt_check": args.corrupt_check,
        "version": args.version,
        "seed": args.seed,
        "debug": args.debug,
        "tcpdump": args.tcpdump,
        "no_telemetry": args.no_telemetry,
        "checker_service": args.checker_service,
        "store_base": args.store,
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


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
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
    if args.command == "test":
        opts = opts_from_args(args)
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
