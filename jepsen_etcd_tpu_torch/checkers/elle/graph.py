"""Shared dependency-graph cycle analysis for the Elle-analog checkers.

Both Elle checkers (list-append, rw-register) reduce to the same core:
given per-edge-type adjacency over committed transactions (ww, wr, rw,
plus realtime for strict-serializable), find cycles in the *nested*
subgraphs Adya's anomaly hierarchy distinguishes:

    G0          cycle in ww alone           (write cycle)
    G1c         cycle in ww|wr              (circular information flow)
    G-single    cycle with exactly one rw   (read skew / non-repeatable)
    G2-item     cycle with >=2 rw           (anti-dependency cycle)
    *-realtime  same, but needing realtime edges (strict-serializability
                violations that serializability alone permits)

All six subgraph closures compute in ONE batched closure on the card
(ops/closure.py, one ``torch.bmm`` a squaring); certificates (a
concrete cycle to show the user) are recovered host-side by BFS over
the sparse edges, restricted to the cycle-participating nodes the
closure identified.

G-single is separated from G2-item exactly: an rw edge (a, b) closes a
G-single cycle iff the *previous* level's closure already reaches b -> a
(one rw + a ww|wr path); otherwise the cycle needs a second rw.
"""

from __future__ import annotations

import logging
import math
from collections import defaultdict, deque
from typing import Any, Optional

import numpy as np

logger = logging.getLogger("jepsen_etcd_tpu_torch.checkers")

from ...core.history import History
from ...ops.closure import EdgeAccumulator, closure_levels_lazy

WW, WR, RW, RT = "ww", "wr", "rw", "realtime"
_ET_INDEX = {WW: 0, WR: 1, RW: 2}

#: certificate-enumeration bounds per anomaly class: enough to show every
#: independent cycle in practice without letting one big SCC turn the
#: checker into an O(E) BFS storm with a thousand-entry result map
MAX_CERTS_PER_CLASS = 32
MAX_ANCHOR_SCANS = 512

#: anomaly -> weakest consistency models it rules out (Elle's `not` field)
ANOMALY_NOT = {
    "G0": ["read-uncommitted"],
    "G1a": ["read-committed"],
    "G1b": ["read-committed"],
    "G1c": ["read-committed"],
    "internal": ["read-committed"],
    "G-single": ["consistent-view", "snapshot-isolation"],
    "G2-item": ["serializable"],
    "G0-realtime": ["strict-serializable"],
    "G1c-realtime": ["strict-serializable"],
    "G-single-realtime": ["strict-serializable"],
    "G2-item-realtime": ["strict-serializable"],
    "incompatible-order": ["read-committed"],
    "duplicate-elements": ["read-committed"],
    "cyclic-version-order": ["read-committed"],
}


class Txn:
    """One transaction as both checkers see it: the completion op, its
    invoke/complete history indices (complete = +inf for indeterminate
    ops, which never gain outgoing realtime edges), and the micro-ops
    (from the invocation for non-ok ops, whose completion value may be
    missing)."""

    __slots__ = ("op", "invoke_index", "complete_index", "mops", "status",
                 "appends", "writes", "ext_reads", "node")

    def __init__(self, op, invoke_index, complete_index, mops, status):
        self.op = op
        self.invoke_index = invoke_index
        self.complete_index = complete_index
        self.mops = mops
        self.status = status  # "ok" | "info" | "fail"
        self.appends: dict = defaultdict(list)  # list-append: k -> [v...]
        self.writes: dict = defaultdict(list)   # rw-register: k -> [v...]
        self.ext_reads: dict = {}               # rw-register: k -> v
        self.node: Optional[int] = None


def collect_txns(history) -> list[Txn]:
    h = history if isinstance(history, History) else History(history)
    txns = []
    for op in h.client_ops():
        if not (op.is_completion and op.get("f") == "txn"):
            continue
        inv = h.invocation(op)
        inv_index = inv["index"] if inv is not None else op["index"]
        status = op["type"]
        mops = op.value if (status == "ok" and op.value) else \
            (inv.value if inv is not None else op.value) or []
        complete = op["index"] if status == "ok" else math.inf
        txns.append(Txn(op, inv_index, complete, mops, status))
    return txns


def _bfs_path(adj: dict[int, list], src: int, dst: int) -> Optional[list]:
    """Shortest node path src..dst over adjacency lists (None if none)."""
    if src == dst:
        return [src]
    prev: dict[int, int] = {src: src}
    q = deque([src])
    while q:
        u = q.popleft()
        for v in adj.get(u, ()):
            if v in prev:
                continue
            prev[v] = u
            if v == dst:
                path = [v]
                while path[-1] != src:
                    path.append(prev[path[-1]])
                return path[::-1]
            q.append(v)
    return None


class DepGraph:
    """Sparse per-type edges over n transaction nodes.

    Edges are held in an :class:`~...ops.closure.EdgeAccumulator` —
    chunked int32 buffers instead of a set of tuples — so the streaming
    path can accumulate edges incrementally without a per-edge Python
    object footprint. ``finalize()`` yields the sorted-unique per-type
    ``[E, 2]`` arrays, which are both the kernel input and (row order ==
    ``sorted(set)``) what every host-side consumer below iterates."""

    def __init__(self, n: int):
        self.n = n
        self._acc = EdgeAccumulator(len(_ET_INDEX))
        self._sets: Optional[dict] = None  # lazy, certificates only
        self.rt: Optional[np.ndarray] = None  # dense [n, n] bool

    def add(self, etype: str, i: int, j: int) -> None:
        self._acc.add(_ET_INDEX[etype], i, j)
        self._sets = None

    def _arrays(self) -> list[np.ndarray]:
        return self._acc.finalize()

    @property
    def edges(self) -> dict[str, set]:
        """Per-type edge sets, materialized on demand (certificate
        recovery and membership tests only — the hot paths use the
        finalized arrays directly)."""
        if self._sets is None:
            arrs = self._arrays()
            self._sets = {et: set(map(tuple, arrs[ti].tolist()))
                          for et, ti in _ET_INDEX.items()}
        return self._sets

    def set_realtime(self, invoke_idx: np.ndarray,
                     complete_idx: np.ndarray) -> None:
        """T1 -> T2 iff T1 completed before T2 invoked (history indices;
        ops that never completed carry +inf and get no outgoing edges)."""
        self.rt = complete_idx[:, None] < invoke_idx[None, :]
        np.fill_diagonal(self.rt, False)
        # kept for the compact device path: the dense rt matrix is
        # derivable from these two N-vectors on device, so the closure
        # launch copies ~KBs instead of the O(B*N^2) bool stack (the
        # [6, 4096, 4096] stack of 3.7k txns is 100 MB)
        self._rt_vecs = (np.asarray(invoke_idx, dtype=np.float64),
                         np.asarray(complete_idx, dtype=np.float64))

    # -- analysis ------------------------------------------------------------

    def _dense(self, *etypes: str) -> np.ndarray:
        a = np.zeros((self.n, self.n), dtype=bool)
        arrs = self._arrays()
        for et in etypes:
            if et == RT:
                if self.rt is not None:
                    a |= self.rt
                continue
            idx = arrs[_ET_INDEX[et]]
            if len(idx):
                a[idx[:, 0], idx[:, 1]] = True
        return a

    def _adj_lists(self, *etypes: str) -> dict[int, list]:
        adj: dict[int, list] = {}
        seen = set()
        arrs = self._arrays()
        for et in etypes:
            if et == RT:
                if self.rt is not None:
                    for i, j in zip(*np.nonzero(self.rt)):
                        if (i, j) not in seen:
                            seen.add((i, j))
                            adj.setdefault(int(i), []).append(int(j))
                continue
            for i, j in arrs[_ET_INDEX[et]].tolist():
                if (i, j) not in seen:
                    seen.add((i, j))
                    adj.setdefault(i, []).append(j)
        return adj

    def edge_type(self, i: int, j: int) -> str:
        for et in (WW, WR, RW):
            if (i, j) in self.edges[et]:
                return et
        if self.rt is not None and self.rt[i, j]:
            return RT
        return "?"

    def find_cycles(self, realtime: bool = True,
                    force_device: Optional[bool] = None,
                    device=None) -> list[dict]:
        """Run the batched closure kernel over the nested subgraphs and
        return anomaly records [{type, cycle, steps}], strongest first.

        Each anomaly level recovers its certificate *anchored on the edge
        type that distinguishes it* — G1c on a wr edge whose target reaches
        back, G-single/G2-item on an rw edge, the realtime variants on an
        edge whose back-path exists only once rt edges are added — so a
        weaker level's cycle can never be re-found and mislabeled at a
        stronger level, and each reported type is genuinely present.
        """
        if self.n == 0:
            return []
        levels = [(WW,), (WW, WR), (WW, WR, RW)]
        use_rt = realtime and self.rt is not None
        if use_rt:
            levels += [(WW, RT), (WW, WR, RT), (WW, WR, RW, RT)]
        # compact inputs: per-type edge lists + the rt vectors; the
        # device path builds the level stack on the card, while the
        # host/row-split paths densify lazily. reach is
        # fetched lazily: only certificate recovery on invalid
        # histories touches it, so valid checks skip the O(B*N^2)
        # device->host transfer
        et_order = (WW, WR, RW)
        lvl_mask = np.array(
            [[et in ets for et in et_order] + [RT in ets]
             for ets in levels])
        et_edges = [self._arrays()[_ET_INDEX[et]] for et in et_order]
        rt_vecs = getattr(self, "_rt_vecs", None) if use_rt else None
        reach_fn, on_cycle = closure_levels_lazy(
            et_edges, lvl_mask, self.n, rt_vecs,
            densify=lambda: np.stack([self._dense(*ets)
                                      for ets in levels]),
            force_device=force_device, device=device)
        adjs: dict[int, dict] = {}

        def adj(li: int) -> dict:
            if li not in adjs:
                adjs[li] = self._adj_lists(*levels[li])
            return adjs[li]

        def anchored(name: str, anchor_edges, need: int,
                     forbid: tuple = ()) -> list[dict]:
            """ALL cycles of a class: one certificate per anchor edge
            (a, b) whose back-path b->a exists in level `need`; `forbid`
            lists weaker levels the back-path must NOT exist at (so the
            cycle genuinely needs the edges `need` adds, and a weaker
            anomaly is never re-labeled here). Distinct anchors that
            close over the same node cycle dedupe to one certificate —
            Elle likewise enumerates every cycle it finds, not just the
            first (elle's cycle search reports each anchored cycle)."""
            reach = reach_fn()
            found: list[dict] = []
            seen_cycles: set = set()
            scans = 0
            for (a, b) in sorted(anchor_edges):
                # bound the enumeration: a densely cyclic history can
                # have O(E) on-cycle anchors (one BFS each) — Elle
                # likewise bounds its cycle search rather than emit
                # thousands of certificates. Mark the truncation so a
                # dense history's report never reads as exhaustive
                # (the repo's no-silent-caps convention).
                if len(found) >= MAX_CERTS_PER_CLASS or \
                        scans >= MAX_ANCHOR_SCANS:
                    if found:
                        found[-1] = dict(found[-1],
                                         **{"certificates-truncated": True})
                    truncated_classes.append(name)
                    break
                if not reach[need][b, a]:
                    continue
                if any(reach[f][b, a] for f in forbid):
                    continue
                scans += 1
                back = _bfs_path(adj(need), b, a)
                if back is None:
                    continue
                cycle = [a] + back
                nodes = cycle[:-1]
                # canonical rotation: same cycle found from different
                # anchors collapses to one certificate
                pivot = nodes.index(min(nodes))
                key = tuple(nodes[pivot:] + nodes[:pivot])
                if key in seen_cycles:
                    continue
                seen_cycles.add(key)
                found.append(self._record(name, cycle))
            return found

        recs: list = []
        truncated_classes: list = []
        add = recs.extend

        # anchor lists come straight from the finalized arrays: already
        # lexicographically sorted, so anchored()'s sorted() is a no-op
        ww, wr, rw = (list(map(tuple, e.tolist())) for e in et_edges)
        if on_cycle[0].any():
            add(anchored("G0", ww, need=0))
        if on_cycle[1].any():
            add(anchored("G1c", wr, need=1))
        if on_cycle[2].any():
            # Scan both classes: a history can contain a G-single AND an
            # independent G2-item cycle. The forbid gate keeps G2-item
            # anchored only on rw edges whose back-path genuinely needs
            # a second rw, so one cycle is never labeled twice.
            add(anchored("G-single", rw, need=1))
            add(anchored("G2-item", rw, need=2, forbid=(1,)))
        if len(levels) > 3:
            if on_cycle[3].any():
                add(anchored("G0-realtime", ww, need=3, forbid=(0,)))
            if on_cycle[4].any():
                add(anchored("G1c-realtime", wr, need=4, forbid=(1,)))
            if on_cycle[5].any():
                add(anchored("G-single-realtime", rw, need=4, forbid=(1,)))
                add(anchored("G2-item-realtime", rw, need=5,
                             forbid=(2, 4)))
        if truncated_classes:
            logger.warning(
                "elle certificate enumeration truncated for %s "
                "(caps: %d certificates / %d anchor scans per class); "
                "the verdict is unaffected but the anomaly list is "
                "not exhaustive", truncated_classes,
                MAX_CERTS_PER_CLASS, MAX_ANCHOR_SCANS)
        return recs

    def _record(self, name: str, cycle: list) -> dict:
        """cycle is [n0, n1, ..., n0]; annotate each step's edge type."""
        steps = [{"from": cycle[i], "to": cycle[i + 1],
                  "type": self.edge_type(cycle[i], cycle[i + 1])}
                 for i in range(len(cycle) - 1)]
        return {"type": name, "cycle": cycle[:-1], "steps": steps}


def render_result(anomalies: dict[str, list],
                  consistency_models: list) -> dict:
    """Assemble the Elle-shaped result map: valid?, anomaly-types,
    anomalies, not (models ruled out)."""
    types = sorted(anomalies)
    not_models: list = []
    for t in types:
        for m in ANOMALY_NOT.get(t, []):
            if m not in not_models:
                not_models.append(m)
    valid = not types
    out = {"valid?": True if valid else False,
           "anomaly-types": types,
           "anomalies": anomalies,
           "not": not_models}
    return out
