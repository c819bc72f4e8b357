"""NetPlane: the controller for the per-link proxy fleet.

One NetPlane per local cluster (db/local.py owns it when
``--net-proxy`` is active): ``front()`` raises a LinkProxy in front of
each node's real client and peer port, and the fault API below is what
the nemesis partition/latency packages drive in local mode — the same
vocabulary as the simulated ``Cluster`` (``partition`` /
``partition_pairs`` / ``heal_partition`` / ``set_latency`` /
``clear_latency``), so ``nemesis/faults.py`` dispatches to either
backend without caring which.

Blocked-pair encoding is shared with ``sut/cluster.py``: a
``frozenset((a, b))`` blocks both directions, an ordered tuple
``(src, dst)`` blocks only ``src -> dst`` (one-way / asymmetric
partitions). Only ``kind="peer"`` legs are ever dropped — partitions
sever inter-node traffic, clients always reach their own node — while
latency/bandwidth/slow-close apply to every leg (tc-on-the-interface
semantics).

Telemetry: ``net.links`` (proxies raised), ``net.dropped_conns``
(connections blackholed or refused), ``net.dropped_chunks`` (chunks
lost to probabilistic drop), ``net.delayed_bytes`` (bytes that paid
injected latency), ``net.active_rules`` (peak concurrent fault
rules), ``net.accept_errors`` (transient accept() failures survived)
— all in the runner/telemetry.py REGISTRY.

The jitter RNG is a plane-owned seeded ``random.Random`` (DET002:
no unseeded randomness, even off the verdict path).
"""

from __future__ import annotations

import random
import threading
from typing import Iterable, Optional

from ..runner import telemetry
from .proxy import LinkProxy, Rule, PASS


class NetPlane:
    """Fault controller over the local cluster's proxy fleet."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        #: (node, kind) -> LinkProxy
        self.proxies: dict[tuple[str, str], LinkProxy] = {}
        #: node names with at least one proxy raised
        self.nodes: set[str] = set()
        #: blocked pairs: frozensets (bidirectional) + tuples (one-way)
        self.blocked: set = set()
        #: (latency_s, jitter_s) when a latency fault is active
        self.latency: Optional[tuple[float, float]] = None
        self.bandwidth_bps: float = 0.0
        self.slow_close_s: float = 0.0
        #: per-chunk loss probability when a lossy-link fault is active
        self.drop_prob: float = 0.0
        #: real-etcd member-id (hex string) -> node name, registered by
        #: db/local.py once the cluster has formed and ids are known
        self.member_names: dict[str, str] = {}
        self._closed = False

    # ---- fleet -------------------------------------------------------------

    def front(self, node: str, kind: str, target_port: int,
              target_host: str = "127.0.0.1") -> int:
        """Raise a proxy in front of ``node``'s real ``kind`` port;
        returns the proxy's listen port (what gets advertised)."""
        proxy = LinkProxy(node, kind, target_port,
                          router=self.route, resolve=self.member_name,
                          jitter=self._jitter, on_event=self._note,
                          target_host=target_host)
        with self._lock:
            self.proxies[(node, kind)] = proxy
            self.nodes.add(node)
        telemetry.current().counter("net.links", 1)
        return proxy.port

    def front_service(self, target_port: int, node: str = "svc",
                      target_host: str = "127.0.0.1") -> str:
        """Raise a proxy in front of a checker-service TCP port and
        return the endpoint clients should dial (``tcp://...``).
        Service legs ride ``kind="peer"`` so partitions — e.g.
        ``partition_pairs({frozenset((host, node))})`` — sever the
        fleet's own control traffic with SUT semantics; attribution
        comes from the client's ``JET-HOST`` preamble."""
        port = self.front(node, "peer", target_port,
                          target_host=target_host)
        return f"tcp://127.0.0.1:{port}"

    def register_member_ids(self, mapping: dict[str, str]) -> None:
        """Install real-etcd member-id-hex -> node-name attribution
        (X-Server-From values are member ids, only known post-setup)."""
        with self._lock:
            for ident, name in sorted(mapping.items()):
                self.member_names[str(ident).lower()] = name

    def member_name(self, ident: str) -> Optional[str]:
        with self._lock:
            return self.member_names.get(str(ident).lower())

    def _jitter(self) -> float:
        with self._lock:
            return self._rng.random()

    # ---- routing (called from pump threads, per chunk) ---------------------

    def route(self, src: Optional[str], dst: str, kind: str) -> Rule:
        with self._lock:
            blocked = self.blocked
            drop = bool(blocked) and kind == "peer" and src is not None \
                and ((src, dst) in blocked
                     or frozenset((src, dst)) in blocked)
            lat = self.latency
            bw = self.bandwidth_bps
            sc = self.slow_close_s
            dp = self.drop_prob
        if not (drop or lat or bw or sc or dp):
            return PASS
        return Rule(drop=drop, drop_prob=dp,
                    latency_s=lat[0] if lat else 0.0,
                    jitter_s=lat[1] if lat else 0.0,
                    bandwidth_bps=bw, slow_close_s=sc)

    # ---- fault API (the nemesis backend surface) ---------------------------

    def partition(self, groups: list[list[str]]) -> None:
        """Partition nodes into isolated groups (bidirectional), same
        group semantics as sut/cluster.py: nodes in no group are cut
        off from every grouped node."""
        group_of = {}
        for gi, g in enumerate(groups):
            for name in g:
                group_of[name] = gi
        with self._lock:
            names = sorted(self.nodes | set(group_of))
        pairs = set()
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                if group_of.get(a) != group_of.get(b):
                    pairs.add(frozenset((a, b)))
        self.partition_pairs(pairs)

    def partition_pairs(self, pairs: Iterable) -> None:
        """Install an explicit blocked set: frozensets block both ways,
        ordered (src, dst) tuples block only src -> dst."""
        with self._lock:
            self.blocked = set(pairs)
        self._note_rules()

    def heal_partition(self) -> None:
        with self._lock:
            self.blocked = set()
        self._note_rules()

    def set_latency(self, delta_ms: float, jitter_ms: float = 0) -> None:
        with self._lock:
            self.latency = (delta_ms / 1000.0, jitter_ms / 1000.0)
        self._note_rules()

    def clear_latency(self) -> None:
        with self._lock:
            self.latency = None
        self._note_rules()

    def set_bandwidth(self, bps: float) -> None:
        with self._lock:
            self.bandwidth_bps = float(bps)
        self._note_rules()

    def set_slow_close(self, seconds: float) -> None:
        with self._lock:
            self.slow_close_s = float(seconds)
        self._note_rules()

    def set_drop_prob(self, p: float) -> None:
        """Lossy-link fault: every chunk on every leg is independently
        discarded with probability ``p`` (clamped to [0, 1]), drawn
        from the plane's seeded RNG."""
        with self._lock:
            self.drop_prob = min(1.0, max(0.0, float(p)))
        self._note_rules()

    def clear_drop_prob(self) -> None:
        with self._lock:
            self.drop_prob = 0.0
        self._note_rules()

    def heal(self) -> None:
        """Drop every active rule (partitions, latency, caps)."""
        with self._lock:
            self.blocked = set()
            self.latency = None
            self.bandwidth_bps = 0.0
            self.slow_close_s = 0.0
            self.drop_prob = 0.0
        self._note_rules()

    # ---- accounting --------------------------------------------------------

    def _active_rules(self) -> int:
        # caller holds no lock; snapshot under it
        with self._lock:
            return (len(self.blocked) + (1 if self.latency else 0)
                    + (1 if self.bandwidth_bps else 0)
                    + (1 if self.slow_close_s else 0)
                    + (1 if self.drop_prob else 0))

    def _note_rules(self) -> None:
        telemetry.current().counter("net.active_rules",
                                    self._active_rules(), mode="max")

    def _note(self, event: str, value: float) -> None:
        """Proxy-thread event sink -> REGISTRY counters (literal names:
        dashboards join by name, graftlint TEL002 checks them)."""
        if event == "dropped":
            telemetry.current().counter("net.dropped_conns", value)
        elif event == "chunk_dropped":
            telemetry.current().counter("net.dropped_chunks", value)
        elif event == "delayed":
            telemetry.current().counter("net.delayed_bytes", value)
        elif event == "accept_error":
            telemetry.current().counter("net.accept_errors", value)

    def stats(self) -> dict:
        with self._lock:
            return {
                "links": len(self.proxies),
                "nodes": sorted(self.nodes),
                "blocked": len(self.blocked),
                "latency": self.latency,
                "bandwidth_bps": self.bandwidth_bps,
                "slow_close_s": self.slow_close_s,
                "drop_prob": self.drop_prob,
            }

    # ---- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            proxies = [self.proxies[k] for k in sorted(self.proxies)]
        for p in proxies:
            p.close()
