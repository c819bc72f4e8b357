"""fake-etcd: a standalone stub binary speaking enough of etcd's
surface for process-level fault testing without a real etcd.

The local control plane (db/local.py) spawns, signals, wipes, and
supervises OS processes; what those processes *serve* is secondary —
what matters is that every process-management path (spawn, readiness
polling, SIGKILL/SIGSTOP/SIGCONT delivery, data-dir wipe,
restart-after-kill, log capture, crash-loop detection, teardown of
leaked children) can be exercised end-to-end in tier-1 tests. This stub
provides that: it parses etcd's real flag set (the subset db.clj:79-100
passes), serves the v3 JSON gateway (sut/http_gateway.py) on its client
URL, persists its MVCC store to the data dir so kill→restart keeps
data and wipe visibly loses it, reports a member/status surface derived
from --initial-cluster, and writes etcd-shaped log lines to stderr.

NOT a distributed store: each fake node owns an independent Store (no
raft, no replication), so a multi-node fake cluster is N disjoint KVs
behind one member list. Checker validity across faults is a real-binary
concern (tests/test_live_etcd.py, gated on `shutil.which("etcd")`);
process-control correctness is this stub's concern. Leadership is
deterministic: every node reports leader = lowest member id.

Quorum awareness (the one distributed behavior the stub does model, so
userspace-proxy partitions are observable): in a multi-node roster each
node listens on its peer port and runs a prober that round-trips a
``FAKE-ETCD-PEER <name>\\n`` preamble through every roster peer URL —
which, under ``--net-proxy``, routes through the target's ingress proxy
where drop rules apply. A node that can see fewer than a majority of
the roster reports leader=0 and refuses linearizable reads and writes
with ``etcdserver: no leader`` (grpc code 14, the same wire shape real
etcd emits), so a partitioned minority fails ops while the majority
progresses, and healing restores it. Probe reads use short timeouts:
a SIGSTOP'd node's kernel still completes TCP handshakes via the
accept backlog, so only the reply round-trip distinguishes alive.

Runs both ways:
    python -m jepsen_etcd_tpu_torch.db.fake_etcd --name n1 ...
    python /path/to/fake_etcd.py --name n1 ...   (db/local.py default)

Crash injection (for crash-loop tests): FAKE_ETCD_CRASH=1 in the
environment makes the process log a panic and exit 1 before serving.
"""

from __future__ import annotations

import argparse
import os
import pickle
import signal
import socket
import sys
import threading
import time

if __package__ in (None, ""):  # invoked as a file path, not a module
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))

from jepsen_etcd_tpu_torch.sut.http_gateway import (  # noqa: E402
    GatewayState, member_id_for_peer_urls, serve)
from jepsen_etcd_tpu_torch.sut.store import Store  # noqa: E402

STORE_FILE = "member/snap/store.pickle"  # under the data dir

#: peer-visibility probe cadence / per-peer reply deadline (short: a
#: SIGSTOP'd peer still accepts via the kernel backlog, only the reply
#: times out)
PROBE_INTERVAL_S = 0.25
PROBE_TIMEOUT_S = 1.0
PEER_PREAMBLE = b"FAKE-ETCD-PEER "
PEER_REPLY = b"FAKE-ETCD-OK "


def _log(msg: str, level: str = "info") -> None:
    # etcd's zap console format, near enough for eyeballing run logs
    ts = time.strftime("%Y-%m-%dT%H:%M:%S")
    sys.stderr.write(f'{{"level":"{level}","ts":"{ts}","msg":"{msg}"}}\n')
    sys.stderr.flush()


def parse_args(argv: list[str]) -> argparse.Namespace:
    """etcd's flag surface, the subset the reference passes
    (db.clj:79-100). parse_known_args: unknown real-etcd flags must not
    kill the stub — a real binary would accept them."""
    p = argparse.ArgumentParser(prog="fake-etcd", add_help=False)
    p.add_argument("--name", required=True)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--listen-client-urls", default="")
    p.add_argument("--advertise-client-urls", default="")
    p.add_argument("--listen-peer-urls", default="")
    p.add_argument("--initial-advertise-peer-urls", default="")
    p.add_argument("--initial-cluster", default="")
    p.add_argument("--initial-cluster-state", default="new",
                   choices=["new", "existing"])
    p.add_argument("--initial-cluster-token", default="etcd-cluster")
    p.add_argument("--snapshot-count", type=int, default=100000)
    p.add_argument("--unsafe-no-fsync", action="store_true")
    p.add_argument("--experimental-initial-corrupt-check",
                   default=None, nargs="?")
    p.add_argument("--experimental-corrupt-check-time", default=None)
    p.add_argument("--logger", default="zap")
    p.add_argument("--log-outputs", default="stderr")
    args, unknown = p.parse_known_args(argv)
    if unknown:
        _log(f"ignoring unrecognized flags: {unknown}", "warn")
    return args


def parse_initial_cluster(spec: str) -> dict[str, str]:
    """'n1=http://h:p1,n2=http://h:p2' -> {name: peer_url}."""
    out: dict[str, str] = {}
    for part in filter(None, (s.strip() for s in spec.split(","))):
        name, _, url = part.partition("=")
        out[name] = url
    return out


def _url_port(url: str) -> int:
    return int(url.rsplit(":", 1)[1].rstrip("/"))


def _url_host(url: str) -> str:
    hostport = url.split("//", 1)[-1]
    return hostport.rsplit(":", 1)[0] or "127.0.0.1"


class FakeEtcd:
    def __init__(self, args: argparse.Namespace):
        self.args = args
        self.data_dir = args.data_dir
        roster = parse_initial_cluster(args.initial_cluster)
        if args.name not in roster and args.initial_advertise_peer_urls:
            roster[args.name] = args.initial_advertise_peer_urls
        members = {
            member_id_for_peer_urls([url]): {
                "name": name, "peerURLs": [url],
                "clientURLs": ([args.advertise_client_urls]
                               if name == args.name else [])}
            for name, url in roster.items()}
        self.member_id = member_id_for_peer_urls(
            [roster.get(args.name, f"unix://{args.name}")])
        self.state = GatewayState(name=args.name,
                                  member_id=self.member_id,
                                  members=members)
        self._persist_lock = threading.Lock()
        self._stopping = threading.Event()
        self._srv = None
        # peer visibility: visible/total member counts published by the
        # prober (self included). The probe targets and majority size
        # come from the LIVE member list each round (_live_peers), not
        # this boot roster — roster only gates whether the peer plane
        # starts at all. Starts optimistic so a clean boot reports a
        # leader before the first probe round completes.
        self.roster = dict(roster)
        self._peer_lock = threading.Lock()
        self._visible_count = max(len(self.roster), 1)
        self._member_total = max(len(self.roster), 1)
        self._peer_srv: socket.socket = None
        if len(self.roster) > 1:
            self.state.quorum_check = self._has_quorum

    # ---- peer visibility / quorum ------------------------------------------

    def _has_quorum(self) -> bool:
        with self._peer_lock:
            return self._visible_count >= self._member_total // 2 + 1

    def _live_peers(self) -> tuple[list[str], int]:
        """Peer URLs of every *other* live member plus the live member
        count, from state.members — member add/remove faults move the
        real majority mid-run, so quorum must never judge against the
        boot-time --initial-cluster roster."""
        with self.state.lock:
            urls = [m["peerURLs"][0]
                    for mid, m in self.state.members.items()
                    if mid != self.member_id and m.get("peerURLs")]
            total = len(self.state.members)
        return urls, total

    def _peer_answer(self, conn: socket.socket) -> None:
        """Answer one probe: read the preamble, echo our name back.
        The round trip crosses both proxy legs, so a one-way drop in
        either direction degrades visibility correctly."""
        try:
            conn.settimeout(PROBE_TIMEOUT_S)
            buf = b""
            while b"\n" not in buf and len(buf) < 256:
                chunk = conn.recv(256)
                if not chunk:
                    break
                buf += chunk
            if buf.startswith(PEER_PREAMBLE):
                conn.sendall(PEER_REPLY
                             + self.args.name.encode("utf-8") + b"\n")
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _peer_listen_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _ = self._peer_srv.accept()
            except OSError:
                return  # listener closed on shutdown
            threading.Thread(target=self._peer_answer, args=(conn,),
                             daemon=True).start()

    def _probe_one(self, url: str) -> bool:
        try:
            with socket.create_connection(
                    (_url_host(url), _url_port(url)),
                    timeout=PROBE_TIMEOUT_S) as s:
                s.settimeout(PROBE_TIMEOUT_S)
                s.sendall(PEER_PREAMBLE
                          + self.args.name.encode("utf-8") + b"\n")
                buf = b""
                while b"\n" not in buf and len(buf) < 256:
                    chunk = s.recv(256)
                    if not chunk:
                        break
                    buf += chunk
                return buf.startswith(PEER_REPLY)
        except OSError:
            return False

    def _probe_loop(self) -> None:
        """Round-trip the preamble to every live member's peer URL
        (under --net-proxy these route through each target's ingress
        proxy, where drop rules apply) and publish visible/total
        counts. An added-but-unstarted member counts toward the
        majority size but never answers — the same fault-tolerance
        dent a real etcd takes from an unstarted learner."""
        while not self._stopping.wait(PROBE_INTERVAL_S):
            urls, total = self._live_peers()
            seen = 1  # self
            for url in sorted(urls):
                if self._probe_one(url):
                    seen += 1
            with self._peer_lock:
                self._visible_count = seen
                self._member_total = max(total, 1)

    def _start_peer_plane(self) -> None:
        port = _url_port(self.args.listen_peer_urls)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", port))
        srv.listen(64)
        self._peer_srv = srv
        threading.Thread(target=self._peer_listen_loop,
                         daemon=True).start()
        threading.Thread(target=self._probe_loop, daemon=True).start()
        _log(f"peer visibility prober up on :{port} "
             f"(roster {sorted(self.roster)})")

    # ---- persistence -------------------------------------------------------

    @property
    def _store_path(self) -> str:
        return os.path.join(self.data_dir, STORE_FILE)

    def load(self) -> None:
        os.makedirs(os.path.dirname(self._store_path), exist_ok=True)
        if os.path.exists(self._store_path):
            with open(self._store_path, "rb") as f:
                payload = pickle.load(f)
            store = Store.__new__(Store)
            store.__dict__.update(payload)
            self.state.store = store
            _log(f"restored store from {self._store_path} at revision "
                 f"{store.revision}")
        elif self.args.initial_cluster_state == "existing":
            # rejoining with an empty data dir is how a wiped node comes
            # back; real etcd would stream a snapshot from the leader —
            # the stub just starts empty
            _log("existing-state start with empty data dir "
                 "(post-wipe rejoin)", "warn")

    def persist(self) -> None:
        """Snapshot the store to the data dir (atomic rename). Called
        after every committed txn: like a per-commit fsync, so SIGKILL
        at any instant loses nothing already acknowledged."""
        with self._persist_lock:
            payload = dict(self.state.store.__dict__)
            payload.pop("apply_txn", None)  # never pickle a wrapper
            tmp = self._store_path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(payload, f)
                if not self.args.unsafe_no_fsync:
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, self._store_path)

    def _hook_persistence(self) -> None:
        store = self.state.store
        orig = store.apply_txn

        def persisting_apply(txn):
            result = orig(txn)
            self.persist()
            return result

        # instance attribute shadows the method; persist() strips it
        # before pickling
        store.apply_txn = persisting_apply

    # ---- lifecycle ---------------------------------------------------------

    def run(self) -> int:
        args = self.args
        _log(f"starting fake-etcd member {args.name} "
             f"(id {self.member_id:x}), data-dir {self.data_dir}, "
             f"snapshot-count {args.snapshot_count}, "
             f"unsafe-no-fsync {args.unsafe_no_fsync}")
        if os.environ.get("FAKE_ETCD_CRASH"):
            # injected startup failure for crash-loop detection tests
            _log("panic: injected crash (FAKE_ETCD_CRASH)", "panic")
            return 1
        self.load()
        self._hook_persistence()
        port = _url_port(args.listen_client_urls
                         or args.advertise_client_urls)
        self._srv, _ = serve(port=port, state=self.state)

        def on_term(signum, frame):
            _log(f"received signal {signum}; shutting down gracefully")
            self._stopping.set()

        signal.signal(signal.SIGTERM, on_term)
        signal.signal(signal.SIGINT, on_term)
        t = threading.Thread(target=self._srv.serve_forever,
                             daemon=True)
        t.start()
        if len(self.roster) > 1 and args.listen_peer_urls:
            self._start_peer_plane()
        _log(f"serving client requests on {args.listen_client_urls}")
        _log("ready to serve client requests")
        self._stopping.wait()
        if self._peer_srv is not None:
            try:
                self._peer_srv.close()
            except OSError:
                pass
        self._srv.shutdown()
        self._srv.server_close()
        self.persist()
        _log("closed fake-etcd; goodbye")
        return 0


def main(argv: list[str] = None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    return FakeEtcd(args).run()


if __name__ == "__main__":
    raise SystemExit(main())
