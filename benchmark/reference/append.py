"""The plain reference for the append workload's checker.

Elle's list-append semantics under strict serializability, written
again from their definitions in plain Python, importing nothing of the
program:

- A txn is a completion of ``f`` "txn" by an integer process, paired
  with that process's open invocation; its micro-ops are the
  completion's value where it is :ok, else the invocation's. Its invoke
  and completion are their positions in the history; a txn that did not
  complete :ok completes at infinity (it gains no realtime successor).
- Every append value is unique a key, so each :ok read of a key, a
  list, shows a prefix of the key's version order. A txn's own earlier
  appends of a key are the end of what it reads there (else
  ``internal``), and the rest is the read's external prefix, which may
  hold none of the txn's own appends (else ``internal``). A list that
  repeats an element is ``duplicate-elements``; two txns that append
  the same value, ``duplicate-appends``.
- A key's version order is its longest external prefix; a prefix that
  is not a prefix of it is ``incompatible-order``, and the key then has
  none. A read value no txn appended is ``lost-write``; one a :fail txn
  appended, ``G1a``; a prefix whose last value is not its writer's last
  append of the key, ``G1b``.
- Committed: :ok txns, and :info txns one of whose appends some read
  observed. Over them: ww from the writer of each version to the
  writer of the next; wr from the writer of a read's last value to the
  reader; rw from a reader to the writer of the version after its
  prefix; no edge from a txn to itself. Realtime: T1 -> T2 iff T1
  completed before T2 invoked, held as a chain of time points (T to the
  first invoke after its completion, each invoke to the next and to
  its txn), so O(n) edges and not n^2.
- The cycle classes, over Adya's levels ww, ww|wr, ww|wr|rw and each
  with realtime: an anchor edge (a, b) of a class's type is a cycle of
  the class where b reaches a in the class's level and not in its
  forbidden ones. G0: a ww anchor, back in ww. G1c: a wr anchor, back
  in ww|wr. G-single: an rw anchor, back in ww|wr. G2-item: an rw
  anchor, back in ww|wr|rw and not in ww|wr. G0-realtime: a ww anchor,
  back in ww|rt and not in ww. G1c-realtime: a wr anchor, back in
  ww|wr|rt and not in ww|wr. G-single-realtime: an rw anchor, back in
  ww|wr|rt and not in ww|wr. G2-item-realtime: an rw anchor, back in
  ww|wr|rw|rt and not in ww|wr|rw nor in ww|wr|rt. Strongly connected
  components (iterative Tarjan) of the whole graph bound every search:
  a back path and its anchor lie in one component, so only anchors
  inside one are looked at, and only within it.

``valid?`` holds iff no anomaly does. A certificate (a reported cycle)
is judged by the graph: each step an edge of its stated type, the
first step an anchor of its class's type, the rest a path in its
class's level, and no back path in a forbidden level.
"""

from __future__ import annotations

import bisect
from collections import deque

INF = float("inf")
WW, WR, RW, RT = "ww", "wr", "rw", "realtime"
#: the levels: Adya's three, then each with realtime
LEVELS = ((WW,), (WW, WR), (WW, WR, RW),
          (WW, RT), (WW, WR, RT), (WW, WR, RW, RT))
#: class -> (anchor type, level of the back path, forbidden levels)
CLASSES = {
    "G0": (WW, 0, ()),
    "G1c": (WR, 1, ()),
    "G-single": (RW, 1, ()),
    "G2-item": (RW, 2, (1,)),
    "G0-realtime": (WW, 3, (0,)),
    "G1c-realtime": (WR, 4, (1,)),
    "G-single-realtime": (RW, 4, (1,)),
    "G2-item-realtime": (RW, 5, (2, 4)),
}


class Txn:
    __slots__ = ("name", "status", "inv", "comp", "mops", "appends")

    def __init__(self, name, status, inv, comp, mops):
        self.name = name          # the completion's position
        self.status = status
        self.inv = inv
        self.comp = comp
        self.mops = mops
        self.appends: dict = {}
        for f, k, v in mops:
            if f == "append":
                self.appends.setdefault(k, []).append(v)


def txns_of(ops: list) -> list:
    """The history's txns in order of completion."""
    open_at: dict = {}
    out = []
    for pos, op in enumerate(ops):
        p = op.get("process")
        if not isinstance(p, int):
            continue
        if op["type"] == "invoke":
            open_at[p] = (pos, op)
            continue
        inv_pos, inv = open_at.pop(p, (pos, None))
        if op.get("f") != "txn":
            continue
        status = op["type"]
        value = op.get("value") if status == "ok" and op.get("value") \
            else (inv.get("value") if inv is not None else op.get("value"))
        out.append(Txn(pos, status, inv_pos,
                       pos if status == "ok" else INF, value or []))
    return out


class Graph:
    """One history's committed txns and their edges."""

    def __init__(self, ops: list, drop_wr: bool = False):
        self.txns = txns_of(ops)
        self.anomalies: set = set()
        writer: dict = {}
        for t in self.txns:
            for k, vs in t.appends.items():
                for v in vs:
                    if (k, v) in writer:
                        self.anomalies.add("duplicate-appends")
                    writer[(k, v)] = t
        reads = []      # (key, external prefix, reader)
        observed = set()
        for t in self.txns:
            if t.status != "ok":
                continue
            own: dict = {}
            for f, k, v in t.mops:
                if f == "append":
                    own.setdefault(k, []).append(v)
                    continue
                lst = list(v) if v is not None else []
                if len(set(lst)) != len(lst):
                    self.anomalies.add("duplicate-elements")
                    continue
                mine = own.get(k, [])
                if len(lst) < len(mine) or \
                        lst[len(lst) - len(mine):] != mine:
                    self.anomalies.add("internal")
                    continue
                ext = lst[:len(lst) - len(mine)]
                if set(ext) & set(t.appends.get(k, ())):
                    self.anomalies.add("internal")
                    continue
                observed.update((k, x) for x in ext)
                reads.append((k, tuple(ext), t))
        prefixes: dict = {}
        for k, ext, _ in reads:
            prefixes.setdefault(k, set()).add(ext)
        order = {}
        for k, ps in prefixes.items():
            longest = max(ps, key=len)
            if all(longest[:len(p)] == p for p in ps):
                order[k] = longest
            else:
                self.anomalies.add("incompatible-order")
        for k, v in observed:
            w = writer.get((k, v))
            if w is None:
                self.anomalies.add("lost-write")
            elif w.status == "fail":
                self.anomalies.add("G1a")
        for k, ext, t in reads:
            if ext:
                w = writer.get((k, ext[-1]))
                if w is not None and w.status != "fail" and \
                        w.appends[k][-1] != ext[-1]:
                    self.anomalies.add("G1b")
        self.committed = [
            t for t in self.txns if t.status == "ok" or (
                t.status == "info" and any(
                    (k, v) in observed
                    for k, vs in t.appends.items() for v in vs))]
        node = {id(t): i for i, t in enumerate(self.committed)}
        self.node_of_name = {t.name: i for i, t in
                             enumerate(self.committed)}
        self.n = n = len(self.committed)
        edges = {WW: set(), WR: set(), RW: set()}

        def add(et, a, b):
            i, j = node.get(id(a)), node.get(id(b))
            if i is not None and j is not None and i != j:
                edges[et].add((i, j))

        for k, vs in order.items():
            for x, y in zip(vs, vs[1:]):
                a, b = writer.get((k, x)), writer.get((k, y))
                if a is not None and b is not None:
                    add(WW, a, b)
        for k, ext, t in reads:
            if ext and not drop_wr:
                w = writer.get((k, ext[-1]))
                if w is not None:
                    add(WR, w, t)
            vs = order.get(k)
            if vs is not None and len(ext) < len(vs):
                w = writer.get((k, vs[len(ext)]))
                if w is not None:
                    add(RW, t, w)
        self.edges = edges
        self.inv = [t.inv for t in self.committed]
        self.comp = [t.comp for t in self.committed]
        # time points: point p (node n + p) is the p-th committed invoke
        self.by_inv = sorted(range(n), key=self.inv.__getitem__)
        self.succ = {}
        for et, es in edges.items():
            adj = [[] for _ in range(n)]
            for i, j in sorted(es):
                adj[i].append(j)
            self.succ[et] = adj
        inv_sorted = [self.inv[i] for i in self.by_inv]
        self.first_after = [bisect.bisect_right(inv_sorted, c)
                            for c in self.comp]
        self._top = None

    # -- the levels ----------------------------------------------------------
    def neighbours(self, level: int, u: int):
        """u's successors in ``level``, time points included."""
        ets = LEVELS[level]
        n = self.n
        if u < n:
            for et in ets:
                if et != RT:
                    yield from self.succ[et][u]
            if RT in ets and self.comp[u] != INF:
                p = self.first_after[u]
                if p < n:
                    yield n + p
        else:
            p = u - n
            if p + 1 < n:
                yield u + 1
            yield self.by_inv[p]

    def top(self) -> list:
        """Component ids of the whole graph (the last level), -1 for a
        node whose component is itself alone."""
        if self._top is None:
            self._top = _tarjan(2 * self.n, lambda u: self.neighbours(5, u),
                                range(2 * self.n))
        return self._top

    def back(self, level: int, a: int, b: int) -> bool:
        """Whether b reaches a in ``level``, for an anchor edge (a, b):
        a breadth-first search inside their component."""
        comp = self.top()
        if comp[a] < 0 or comp[a] != comp[b]:
            return False
        c = comp[a]
        seen = {b}
        q = deque([b])
        while q:
            u = q.popleft()
            for v in self.neighbours(level, u):
                if v == a:
                    return True
                if v not in seen and comp[v] == c:
                    seen.add(v)
                    q.append(v)
        return False

    def is_edge(self, et: str, i: int, j: int) -> bool:
        if et == RT:
            return i != j and self.comp[i] < self.inv[j]
        return et in self.edges and (i, j) in self.edges[et]

    def in_level(self, level: int, i: int, j: int) -> bool:
        return any(self.is_edge(et, i, j) for et in LEVELS[level])

    # -- the verdict ---------------------------------------------------------
    def cycle_types(self) -> set:
        out = set()
        comp = self.top()
        for name, (et, need, forbid) in CLASSES.items():
            for a, b in sorted(self.edges[et]):
                if comp[a] < 0 or comp[a] != comp[b]:
                    continue
                if self.back(need, a, b) and \
                        not any(self.back(f, a, b) for f in forbid):
                    out.add(name)
                    break
        return out

    def verdict(self) -> dict:
        types = sorted(self.anomalies | self.cycle_types())
        return {"valid?": not types, "anomaly-types": types,
                "txn-count": len(self.txns),
                "committed-count": self.n}

    def certificate_ok(self, cert: dict) -> bool:
        """Whether a reported cycle is one of its class in this graph."""
        cls = CLASSES.get(cert.get("type"))
        names = cert.get("cycle") or []
        steps = cert.get("steps") or []
        if cls is None or not names or len(steps) != len(names):
            return False
        nodes = [self.node_of_name.get(x) for x in names]
        if None in nodes:
            return False
        et, need, forbid = cls
        for s, (i, j) in enumerate(zip(nodes, nodes[1:] + nodes[:1])):
            st = steps[s]
            if self.node_of_name.get(st.get("from")) != i or \
                    self.node_of_name.get(st.get("to")) != j:
                return False
            if not self.is_edge(st.get("type"), i, j):
                return False
            if s > 0 and not self.in_level(need, i, j):
                return False
        a, b = nodes[0], nodes[1 % len(nodes)]
        return self.is_edge(et, a, b) and \
            not any(self.back(f, a, b) for f in forbid)


def _tarjan(size: int, succ, roots) -> list:
    """Strongly connected components, iteratively: a component id a
    node, -1 where the node's component is the node alone."""
    index = [-1] * size
    low = [0] * size
    on = [False] * size
    comp = [-1] * size
    stack: list = []
    counter = 0
    n_comp = 0
    for root in roots:
        if index[root] >= 0:
            continue
        work = [(root, iter(succ(root)))]
        index[root] = low[root] = counter
        counter += 1
        stack.append(root)
        on[root] = True
        while work:
            u, it = work[-1]
            pushed = False
            for v in it:
                if index[v] < 0:
                    index[v] = low[v] = counter
                    counter += 1
                    stack.append(v)
                    on[v] = True
                    work.append((v, iter(succ(v))))
                    pushed = True
                    break
                if on[v] and index[v] < low[u]:
                    low[u] = index[v]
            if pushed:
                continue
            work.pop()
            if work:
                p = work[-1][0]
                if low[u] < low[p]:
                    low[p] = low[u]
            if low[u] == index[u]:
                members = []
                while True:
                    v = stack.pop()
                    on[v] = False
                    members.append(v)
                    if v == u:
                        break
                if len(members) > 1:
                    for v in members:
                        comp[v] = n_comp
                    n_comp += 1
    return comp


#: each number compared, with its limit: every comparison is exact
LIMITS = {"valid": 0, "types": 0, "counts": 0, "certificates": 0}


def compare(got: dict, exp: dict, graph: Graph) -> tuple:
    """``(wrong, unknown)`` for one history: ``wrong`` counts, by the
    names of ``LIMITS``, a ``valid?`` that differs, anomaly types that
    differ, each of ``txn-count`` and ``committed-count`` that differs,
    and each certificate that is not a cycle of its class in the
    reference's graph; ``unknown`` is 1 where ``valid?`` is neither
    true nor false."""
    wrong = dict.fromkeys(LIMITS, 0)
    unknown = 0
    if not isinstance(got.get("valid?"), bool):
        unknown = 1
    elif got["valid?"] != exp["valid?"]:
        wrong["valid"] += 1
    if list(got.get("anomaly-types") or []) != exp["anomaly-types"]:
        wrong["types"] += 1
    for k in ("txn-count", "committed-count"):
        if got.get(k) != exp[k]:
            wrong["counts"] += 1
    for cert in got.get("certificates") or []:
        if not graph.certificate_ok(cert):
            wrong["certificates"] += 1
    return wrong, unknown


def judge(histories: list) -> tuple:
    """``(wrong, failed)`` over a run's ``histories`` (``Checked``s,
    ``keys`` one pool history): the reference's verdict of each pool
    history, once, set as ``h.exp``; ``wrong`` summed by the names of
    ``LIMITS`` over the histories that came back, and ``failed`` the
    histories whose check raised or left a verdict neither true nor
    false."""
    graphs: dict = {}
    verdicts: dict = {}
    wrong = dict.fromkeys(LIMITS, 0)
    failed = 0
    for h in histories:
        k, = h.keys
        if k.name not in graphs:
            graphs[k.name] = Graph(k.ops)
            verdicts[k.name] = graphs[k.name].verdict()
        h.exp = verdicts[k.name]
        if h.got is None:
            failed += 1
            continue
        w, unknown = compare(h.got, h.exp, graphs[k.name])
        for name, n in w.items():
            wrong[name] += n
        failed += unknown
    return wrong, failed


def control(keys: list, memo: dict) -> dict:
    """The control's answer for a history, in the form of the entry's
    summary: the reference with the wr relation dropped, memoized in
    ``memo`` by pool history."""
    k, = keys
    if k.name not in memo:
        memo[k.name] = dict(Graph(k.ops, drop_wr=True).verdict(),
                            certificates=[])
    return memo[k.name]
