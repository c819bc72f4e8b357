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

import itertools
import logging
import math
from collections import defaultdict, deque
from typing import Any, Optional

import numpy as np

logger = logging.getLogger("jepsen_etcd_tpu_torch.checkers")

from ...core.history import _CORE_KEYS, TYPE_NAMES, History
from ...ops.closure import EdgeAccumulator, closure_levels_lazy
from ...runner import telemetry

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

    __slots__ = ("_op", "_row", "invoke_index", "complete_index", "mops",
                 "status", "appends", "writes", "ext_reads", "node")

    def __init__(self, op, invoke_index, complete_index, mops, status,
                 row=None):
        self._op = op
        #: (OpColumns, row) of the completion where ``op`` is None
        self._row = row
        self.invoke_index = invoke_index
        self.complete_index = complete_index
        self.mops = mops
        self.status = status  # "ok" | "info" | "fail"
        self.appends: dict = defaultdict(list)  # list-append: k -> [v...]
        self.writes: dict = defaultdict(list)   # rw-register: k -> [v...]
        self.ext_reads: dict = {}               # rw-register: k -> v
        self.node: Optional[int] = None

    @property
    def op(self):
        """The completion op; a column-backed txn builds it on first
        read (only reports read it)."""
        if self._op is None:
            cols, i = self._row
            self._op = cols.op_at(i)
        return self._op


def collect_txns(history) -> list[Txn]:
    h = history if isinstance(history, History) else History(history)
    if h.columns is not None and _plain_columns(h.columns):
        return _collect_txns_columns(h.columns)
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


def _plain_columns(cols) -> bool:
    """Whether ``cols`` rows read as their ops do without building
    them: no core key missing or overridden by an extra, and each op's
    ``index`` unique (else the op path raises, as it should)."""
    if cols.missing or any(_CORE_KEYS.intersection(ex)
                           for ex in cols.extras.values()):
        return False
    return len(np.unique(cols.index)) == len(cols.index)


def _collect_txns_columns(cols) -> list[Txn]:
    """collect_txns over a column-backed history, read from the columns:
    the same txns in the same order, each completion op built only when
    a report reads it. Invokes pair with completions per process as
    ``pair_index`` pairs them; where it would raise, this raises too,
    and as the op path does, only once some txn has completed."""
    tc = cols.type_code.tolist()
    pr = cols.proc.tolist()
    idx = cols.index.tolist()
    pt = cols.proc_table
    is_txn = [f == "txn" for f in cols.f_table]
    fc = cols.f_code.tolist()
    value_at = cols.value_at
    inf = math.inf
    open_by: dict = {}
    txns = []
    error = None
    for i, t in enumerate(tc):
        p = pr[i]
        if p < 0:
            p = pt[-1 - p]
        if t == 0:
            if p in open_by and error is None:
                error = ValueError(
                    f"process {p!r} invoked op {idx[i]} while op "
                    f"{idx[open_by[p]]} is still open")
            open_by[p] = i
            continue
        j = open_by.pop(p, None)
        if not (is_txn[fc[i]] and isinstance(p, int)):
            continue
        status = TYPE_NAMES[t]
        v = value_at(i)
        mops = v if (t == 1 and v) else \
            (value_at(j) if j is not None else v) or []
        txns.append(Txn(None, idx[j] if j is not None else idx[i],
                        idx[i] if t == 1 else inf, mops, status,
                        row=(cols, i)))
    if error is not None and txns:
        raise error
    return txns


def _bfs_path(adj: dict[int, list], src: int, dst: int,
              rt: Optional["_RealtimeSuccessors"] = None) -> Optional[list]:
    """Shortest node path src..dst over adjacency lists (None if none).
    With ``rt``, each node's realtime successors follow its listed
    neighbours, by ascending node index: the order the dense realtime
    pairs of a level's adjacency lists gave, so the path is theirs."""
    if src == dst:
        return [src]
    prev: dict[int, int] = {src: src}
    q = deque([src])
    if rt is not None:
        rt.reset()
    while q:
        u = q.popleft()
        nbrs = adj.get(u, ())
        if rt is not None:
            nbrs = itertools.chain(nbrs, rt.successors(u, prev))
        for v in nbrs:
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


class _RealtimeSuccessors:
    """A node's realtime successors, ``comp[u] < inv[j]``, ``j != u``,
    from the two vectors: the nodes past a point of an index sorted by
    invoke, never the n^2 pairs. Within one search the nodes invoked
    after the least completion handed out so far (``floor``) have all
    been found, so a node hands out only the slice between its
    completion and that floor, and the search's work is O(n log n)."""

    def __init__(self, invoke: np.ndarray, complete: np.ndarray):
        self.complete = complete
        self.order = np.argsort(invoke, kind="stable")
        self.sorted_inv = invoke[self.order]
        self.floor = math.inf

    def reset(self) -> None:
        """A new search: nothing handed out yet."""
        self.floor = math.inf

    def successors(self, u: int, found: dict) -> list:
        """u's realtime successors not in ``found``, ascending. Every
        node invoked after ``floor`` is in ``found`` already, so only
        those invoked in (comp[u], floor] are looked at."""
        c = self.complete[u]
        if not c < self.floor:
            return []
        lo = np.searchsorted(self.sorted_inv, c, side="right")
        hi = np.searchsorted(self.sorted_inv, self.floor, side="right")
        self.floor = c
        cand = np.sort(self.order[lo:hi])
        return [j for j in cand.tolist() if j != u and j not in found]


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
        #: (invoke, complete) float64 [n] vectors, or None: the
        #: realtime relation, never held as a dense [n, n] matrix
        self._rt_vecs: Optional[tuple] = None

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
        ops that never completed carry +inf and get no outgoing edges).
        Only the two N-vectors are kept: the device builds the relation
        from them on the card (~KBs copied instead of the O(B*N^2) bool
        stack), the host's dense planes derive it on demand
        (``_realtime``), and certificate searches take a node's
        successors from them (``_RealtimeSuccessors``)."""
        self._rt_vecs = (np.asarray(invoke_idx, dtype=np.float64),
                         np.asarray(complete_idx, dtype=np.float64))

    def _realtime(self) -> np.ndarray:
        """The dense [n, n] realtime relation, for the host's planes."""
        inv, comp = self._rt_vecs
        rt = comp[:, None] < inv[None, :]
        np.fill_diagonal(rt, False)
        return rt

    # -- analysis ------------------------------------------------------------

    def _dense(self, *etypes: str) -> np.ndarray:
        a = np.zeros((self.n, self.n), dtype=bool)
        arrs = self._arrays()
        for et in etypes:
            if et == RT:
                if self._rt_vecs is not None:
                    a |= self._realtime()
                continue
            idx = arrs[_ET_INDEX[et]]
            if len(idx):
                a[idx[:, 0], idx[:, 1]] = True
        return a

    def _adj_lists(self, *etypes: str) -> dict[int, list]:
        """The typed edges of ``etypes`` as adjacency lists, type by
        type in their sorted order (realtime, which has no list, is
        ``_RealtimeSuccessors``')."""
        adj: dict[int, list] = {}
        seen = set()
        arrs = self._arrays()
        for et in etypes:
            if et == RT:
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
        if self._rt_vecs is not None and i != j and \
                self._rt_vecs[1][i] < self._rt_vecs[0][j]:
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
        use_rt = realtime and self._rt_vecs is not None
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
        rt_vecs = self._rt_vecs if use_rt else None
        reach_fn, on_cycle = closure_levels_lazy(
            et_edges, lvl_mask, self.n, rt_vecs,
            densify=lambda: np.stack([self._dense(*ets)
                                      for ets in levels]),
            force_device=force_device, device=device)
        with telemetry.current().span("elle.certificates", n=self.n):
            return self._certificates(levels, et_edges, reach_fn, on_cycle)

    def _certificates(self, levels: list, et_edges: list, reach_fn,
                      on_cycle: np.ndarray) -> list[dict]:
        """find_cycles' anomaly records from the closure's ``on_cycle``
        and ``reach``: each class's certificates, anchored."""
        adjs: dict[int, dict] = {}
        rt = _RealtimeSuccessors(*self._rt_vecs) if len(levels) > 3 \
            else None

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
                back = _bfs_path(adj(need), b, a,
                                 rt if RT in levels[need] else None)
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
