"""Realtime certificates without the n^2 pairs (``checkers/elle/
graph.py``): a node's realtime successors come from the invoke and
complete vectors (``_RealtimeSuccessors``), and every breadth-first
search on a realtime level must give the path the dense pairs gave.

The dense adjacency is kept here as a plain version, as the port had it:
a level's typed edges type by type in their sorted order, then the
realtime pairs of ``np.nonzero`` of the dense [n, n] relation, each
pair once. The port's Elle dicts stay JSON-equal to the JAX package's
on stale reads planted at several distances, and a stale read at the
benchmark's size finds its back path in a second or two."""

import itertools
import json
import random
import time
from collections import deque

import numpy as np
import pytest

from jepsen_etcd_tpu.checkers.elle.append import \
    ListAppendChecker as RefAppend
from jepsen_etcd_tpu.checkers.elle.wr import RWRegisterChecker as RefWR
from jepsen_etcd_tpu.core.history import History as RefHistory
from jepsen_etcd_tpu.core.op import Op as RefOp
from jepsen_etcd_tpu_torch.checkers.elle import (ListAppendChecker,
                                                 RWRegisterChecker)
from jepsen_etcd_tpu_torch.checkers.elle import graph
from jepsen_etcd_tpu_torch.core.history import History
from jepsen_etcd_tpu_torch.core.op import Op
from jepsen_etcd_tpu_torch.testing import gen_append_history, gen_wr_history

from benchmark.traffic import append_pool

from test_torch_fixtures import one_torch_thread  # noqa: F401

REALTIME_LEVELS = [(graph.WW, graph.RT), (graph.WW, graph.WR, graph.RT),
                   (graph.WW, graph.WR, graph.RW, graph.RT)]


def dense_adj_lists(g: graph.DepGraph, etypes: tuple) -> dict:
    """The plain version: the level's adjacency lists with the realtime
    pairs of the dense relation, in ``np.nonzero``'s order."""
    inv, comp = g._rt_vecs
    rt = comp[:, None] < inv[None, :]
    np.fill_diagonal(rt, False)
    adj: dict = {}
    seen = set()
    arrs = g._arrays()
    for et in etypes:
        pairs = zip(*np.nonzero(rt)) if et == graph.RT else \
            map(tuple, arrs[graph._ET_INDEX[et]].tolist())
        for i, j in pairs:
            if (i, j) not in seen:
                seen.add((i, j))
                adj.setdefault(int(i), []).append(int(j))
    return adj


def bfs_plain(adj: dict, src: int, dst: int):
    """The search as the port ran it over full lists."""
    if src == dst:
        return [src]
    prev = {src: src}
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


def random_graph(rng: np.random.Generator, n: int) -> graph.DepGraph:
    """Typed edges, mostly forward in a hidden order with a few back
    edges, over invoke/complete vectors with spans of several widths,
    repeated values and some txns that never completed."""
    g = graph.DepGraph(n)
    for et, count in (("ww", n), ("wr", n), ("rw", n // 2)):
        for _ in range(count):
            i, j = (int(x) for x in rng.integers(0, n, 2))
            if rng.random() < 0.9 and i > j:
                i, j = j, i
            g.add(et, i, j)
    inv = np.round(np.sort(rng.random(n)) * n / 4)
    rng.shuffle(inv)
    comp = inv + rng.integers(1, max(2, n // 8), n)
    comp[rng.random(n) < 0.05] = np.inf
    g.set_realtime(inv.astype(float), comp.astype(float))
    return g


@pytest.mark.parametrize("n,seed", [(200, 0), (600, 1), (1500, 2)])
def test_realtime_paths_equal_the_dense_pairs(n, seed):
    rng = np.random.default_rng(seed)
    g = random_graph(rng, n)
    rt = graph._RealtimeSuccessors(*g._rt_vecs)
    queries = [tuple(int(x) for x in rng.integers(0, n, 2))
               for _ in range(40)]
    found = 0
    for etypes in REALTIME_LEVELS:
        plain = dense_adj_lists(g, etypes)
        typed = g._adj_lists(*etypes)
        for src, dst in queries:
            want = bfs_plain(plain, src, dst)
            got = graph._bfs_path(typed, src, dst, rt)
            assert got == want, (etypes, src, dst)
            found += want is not None
    assert found > 0


def test_edge_types_and_dense_planes_from_the_vectors():
    rng = np.random.default_rng(3)
    g = random_graph(rng, 120)
    inv, comp = g._rt_vecs
    rt = g._dense(graph.RT)
    assert rt.shape == (120, 120) and not rt.diagonal().any()
    assert np.array_equal(rt, (comp[:, None] < inv[None, :]) &
                          ~np.eye(120, dtype=bool))
    for i, j in itertools.product(range(0, 120, 7), range(0, 120, 5)):
        typed = [et for et in (graph.WW, graph.WR, graph.RW)
                 if (i, j) in g.edges[et]]
        want = typed[0] if typed else graph.RT if rt[i, j] else "?"
        assert g.edge_type(i, j) == want


def as_json(x) -> str:
    return json.dumps(x, sort_keys=True)


def both(kind: str, ops: list) -> tuple:
    ref_cls, port_cls = {"append": (RefAppend, ListAppendChecker),
                         "wr": (RefWR, RWRegisterChecker)}[kind]
    want = ref_cls().check({}, RefHistory([RefOp(dict(o)) for o in ops]))
    got = port_cls(device="cpu").check({}, History([Op(dict(o))
                                                    for o in ops]))
    return want, got


@pytest.mark.parametrize("staleness", [1, 5, 50])
def test_planted_stale_reads_give_the_reference_dicts(staleness):
    ops = append_pool.gen_append_history(
        random.Random(17 + staleness), txns=480, info_rate=0.03,
        plant="G-single-realtime", staleness=staleness,
        plant_rng=random.Random(staleness))
    want, got = both("append", ops)
    assert as_json(got) == as_json(want)
    assert got["valid?"] is False
    assert "G-single-realtime" in got["anomaly-types"]
    certs = got["anomalies"]["G-single-realtime"]
    assert certs and all(any(s["type"] == "realtime" for s in c["steps"])
                         for c in certs)


@pytest.mark.parametrize("seed", [3, 29])
@pytest.mark.parametrize("kind", ["append", "wr"])
def test_synthesized_stale_reads_give_the_reference_dicts(kind, seed):
    gen = {"append": gen_append_history, "wr": gen_wr_history}[kind]
    h = gen(random.Random(seed), 10, 300, corrupt="G-single-realtime")
    want, got = both(kind, [dict(o) for o in h])
    assert as_json(got) == as_json(want)
    assert "G-single-realtime" in got["anomaly-types"]


def test_stale_read_at_the_cells_size_finds_its_back_path():
    """~11,000 committed txns with one stale read: the back path of its
    anchor on the ww|wr|realtime level, from the edges and the vectors
    and no closure. The dense pairs took ~1.6 us each, ~95 s for the
    ~59 M pairs of this size; the search here takes well under a
    second, so 5 s leaves room for a slow host."""
    ops = append_pool.gen_append_history(
        random.Random(5), plant="G-single-realtime", staleness=1,
        plant_rng=random.Random(6))
    checker = ListAppendChecker(device="cpu")
    _, txns, writer, ext_reads, observed, order = checker._collect(
        History([Op(o) for o in ops]))
    committed, g = checker._graph(txns, writer, ext_reads, observed, order)
    assert g.n >= 10_000
    level = (graph.WW, graph.WR, graph.RT)
    t0 = time.perf_counter()
    typed = g._adj_lists(*level)
    rt = graph._RealtimeSuccessors(*g._rt_vecs)
    inv, comp = g._rt_vecs
    # the planted anchor: the rw edge (R, W) whose W completed before R
    # invoked
    anchors = [(a, b) for a, b in g._arrays()[graph._ET_INDEX["rw"]]
               .tolist() if comp[b] < inv[a]]
    assert len(anchors) == 1
    a, b = anchors[0]
    back = graph._bfs_path(typed, b, a, rt)
    took = time.perf_counter() - t0
    assert back is not None and back[0] == b and back[-1] == a
    assert g.edge_type(back[-2], a) == graph.RT
    assert took < 5.0, took
