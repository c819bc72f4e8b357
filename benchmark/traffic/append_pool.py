"""List-append histories at the shape of jepsen.etcd's append workload,
one whole run a history.

``append.clj:183-185`` runs Elle's list-append generator with
``{:key-count 3 :max-txn-length 4}`` (the port's
``generators/elle.py``): a pool of ``key_count`` live keys, each retired
after ``max_writes_per_key`` appends and replaced by a fresh key; a txn
of 1 to ``max_txn_length`` micro-ops, reads ``["r", k, nil]`` and
appends ``["append", k, v]`` one to one, values unique and increasing a
key. Each txn is an optimistic two-phase etcd txn (``append.clj:64-158``):
one that holds an append comes back ``:fail :didnt-succeed`` when its
guard loses a race, and one that times out comes back ``:info``, after
which its process goes on as process + ``concurrency``.

The timing model is ``synth.py``'s for the register: each process runs
its txns back to back, 0.1 to 1.1 time units each with gaps of up to
0.3, and a txn that takes effect applies atomically at a uniform
instant of its span, against one serial state in the order of those
instants. So a txn that completes before another invokes applies first,
and a clean history is strict-serializable by construction. A txn's
keys and values are drawn in invoke order, as a generator draws them;
an :info txn's appends take effect or not by a coin, and a read that
comes after one that did observes it.

``plant`` edits a clean history, the same ops, to carry one anomaly:

- ``"G1c"``: two :ok txns A and B, consecutive in the serial order and
  with overlapping spans, where B reads a key A appended and A reads a
  key B appends (and A does not): A's reads of that key are given what
  it held after B. Each reads the other's append, a ww|wr cycle whose
  strongly connected component is the pair alone at every level, the
  realtime ones included.
- ``"G-single-realtime"``: a stale read. A txn R that is one :ok read
  reads, of a key that W appended, what the key held before W's first
  append, where W is the :ok append txn that completed ``staleness``-th
  last before R invoked (1: the last). R -rw-> W, and W completed before
  R invoked: a cycle only realtime closes.
- ``"G1a"``: one :fail txn's appends take effect all the same, so later
  reads observe an aborted write.

Ops are plain dicts (``type``, ``process``, ``f`` "txn", ``value`` the
micro-ops, and ``error`` on :fail and :info completions); nothing of the
program is imported.

Parameters (the configuration's keys, then the cell's ``params`` over
them): ``txns``, ``concurrency``, ``key_count``, ``max_txn_length``,
``max_writes_per_key``, ``fail_rate``, ``info_rate`` (a history's
shape), ``keys_per_history`` ([1, 1]: a history is one run's),
``pool`` (how many ``clean`` and ``corrupt`` histories), ``plant`` (the
corrupted histories' anomaly) and ``staleness`` (a
``G-single-realtime`` plant's), ``corrupt_every`` (one history in each
block of that many is corrupted) and ``warmup`` (one dict a warm-up
history: ``keys`` 1, and 1 under its role). A corrupted history, the
cell's guard, is the clean history of its index with the plant.
"""

from __future__ import annotations

import random

import numpy as np

ROLES = ("clean", "corrupt")
#: ``f`` values in the order of the ``f_code`` column
F_TABLE = ("txn",)
TYPE_CODES = {"invoke": 0, "ok": 1, "fail": 2, "info": 3}
PLANTS = ("G1c", "G-single-realtime", "G1a")


def _rng(seed: int, *parts) -> random.Random:
    return random.Random("/".join(str(p) for p in (seed, *parts)))


class _Keys:
    """Elle's rotating pool of live keys, values counted a key."""

    def __init__(self, key_count: int, max_writes: int):
        self.max_writes = max_writes
        self.live = list(range(key_count))
        self.next_key = key_count
        self.written = dict.fromkeys(self.live, 0)

    def read_key(self, rng) -> int:
        return rng.choice(self.live)

    def append(self, rng) -> tuple:
        k = rng.choice(self.live)
        self.written[k] += 1
        v = self.written[k]
        if v >= self.max_writes:
            self.live[self.live.index(k)] = self.next_key
            self.written[self.next_key] = 0
            self.next_key += 1
        return k, v


def gen_append_history(rng: random.Random, txns: int = 12_000,
                       concurrency: int = 10, key_count: int = 3,
                       max_txn_length: int = 4,
                       max_writes_per_key: int = 32,
                       fail_rate: float = 0.10, info_rate: float = 0.01,
                       plant=None, staleness: int = 1,
                       plant_rng=None) -> list:
    """One history's ops in history order. ``plant`` (None or one of
    ``PLANTS``) draws its choices from ``plant_rng``, after every draw
    of the clean history, so the ops are the clean history's but for
    the plant."""
    if plant is not None and plant not in PLANTS:
        raise ValueError(f"unknown plant {plant!r}")
    spans = []  # (start, end, thread)
    for p in range(concurrency):
        at = rng.random()
        for _ in range(txns // concurrency + (p < txns % concurrency)):
            dur = 0.1 + rng.random()
            spans.append((at, at + dur, p))
            at += dur + rng.random() * 0.3
    spans.sort()
    keys = _Keys(key_count, max_writes_per_key)
    mops = []
    for _ in spans:
        txn = []
        for _ in range(rng.randint(1, max_txn_length)):
            if rng.random() < 0.5:
                txn.append(["r", keys.read_key(rng), None])
            else:
                k, v = keys.append(rng)
                txn.append(["append", k, v])
        mops.append(txn)
    n = len(spans)
    status = []
    for txn in mops:
        if rng.random() < info_rate:
            status.append("info")
        elif any(f == "append" for f, _, _ in txn) and \
                rng.random() < fail_rate:
            status.append("fail")
        else:
            status.append("ok")
    took_effect = [rng.random() < 0.5 for _ in spans]
    points = [rng.uniform(s, e) for s, e, _ in spans]
    order = sorted(range(n), key=points.__getitem__)
    prng = plant_rng if plant_rng is not None else rng
    applies = [st == "ok" or (st == "info" and took_effect[i])
               for i, st in enumerate(status)]
    if plant == "G1a":
        fails = [i for i in order[: n // 2] if status[i] == "fail"]
        if not fails:
            raise ValueError("no :fail txn to plant G1a on")
        applies[prng.choice(fails)] = True
    state: dict = {}
    outs = [None] * n
    before = [None] * n  # {key: list before the txn's first append}
    for i in order:
        if not applies[i]:
            continue
        out, pre = [], {}
        for f, k, v in mops[i]:
            if f == "append":
                if k not in pre:
                    pre[k] = list(state.get(k, ()))
                state.setdefault(k, []).append(v)
                out.append([f, k, v])
            else:
                out.append([f, k, list(state[k]) if k in state else None])
        outs[i], before[i] = out, pre
    if plant == "G1c":
        _plant_g1c(prng, spans, order, status, outs, before)
    elif plant == "G-single-realtime":
        _plant_stale(prng, spans, status, mops, outs, before, staleness)
    events = []
    for i, (s, e, t) in enumerate(spans):
        events.append((s, 0, i))
        events.append((e, 1, i))
    events.sort()
    process = list(range(concurrency))
    ops = []
    for _, kind, i in events:
        t = spans[i][2]
        p = process[t]
        if kind == 0:
            ops.append({"type": "invoke", "process": p, "f": "txn",
                        "value": [list(m) for m in mops[i]]})
            continue
        st = status[i]
        if st == "ok":
            ops.append({"type": "ok", "process": p, "f": "txn",
                        "value": outs[i]})
            continue
        ops.append({"type": st, "process": p, "f": "txn",
                    "value": [list(m) for m in mops[i]],
                    "error": "didnt-succeed" if st == "fail"
                    else "timeout"})
        if st == "info":
            process[t] = p + concurrency
    return ops


def _plant_g1c(rng, spans, order, status, outs, before) -> None:
    """A and B consecutive :ok txns of the serial order, spans
    overlapping, B reading a key A appended, A reading a key j that B
    appends and A does not: A's reads of j become what j held after
    B."""
    applied = [i for i in order if outs[i] is not None]
    cands = []
    for a, b in zip(applied, applied[1:]):
        if status[a] != "ok" or status[b] != "ok" or \
                spans[b][0] >= spans[a][1] or spans[a][0] >= spans[b][1]:
            continue
        a_app = {k for f, k, _ in outs[a] if f == "append"}
        b_app = {k for f, k, _ in outs[b] if f == "append"}
        if not any(f == "r" and k in a_app for f, k, _ in outs[b]):
            continue
        js = sorted({k for f, k, _ in outs[a] if f == "r"} & b_app - a_app)
        if js:
            cands.append((a, b, js[0]))
    if not cands:
        raise ValueError("no txn pair to plant G1c on")
    a, b, j = rng.choice(cands)
    after = before[b][j] + [v for f, k, v in outs[b]
                            if f == "append" and k == j]
    outs[a] = [[f, k, list(after)] if f == "r" and k == j else [f, k, v]
               for f, k, v in outs[a]]


def _plant_stale(rng, spans, status, mops, outs, before,
                 staleness) -> None:
    """R, one :ok read, reads a key k of W what k held before W's first
    append of it, W the :ok append txn that completed ``staleness``-th
    last before R invoked, and k a key of W whose append another txn's
    read observed (else no read shows R's stale)."""
    seen: dict = {}  # (k, value) -> up to two txns that read it
    for i, out in enumerate(outs):
        if status[i] != "ok":
            continue
        own = {(k, v) for f, k, v in out if f == "append"}
        for f, k, v in out:
            for x in (v or ()) if f == "r" else ():
                if (k, x) not in own and len(seen.setdefault((k, x),
                                                             [])) < 2:
                    seen[(k, x)].append(i)
    writers = sorted((spans[i][1], i) for i in range(len(spans))
                     if status[i] == "ok" and
                     any(f == "append" for f, _, _ in outs[i]))
    ends = np.array([e for e, _ in writers])
    done = np.searchsorted(ends, [s for s, _, _ in spans])

    def key_of(r):
        w = writers[int(done[r]) - staleness][1]
        return w, next((k for f, k, v in outs[w] if f == "append" and
                        set(seen.get((k, v), ())) - {r}), None)
    readers = [i for i in range(len(spans))
               if status[i] == "ok" and len(outs[i]) == 1 and
               outs[i][0][0] == "r" and done[i] >= staleness and
               key_of(i)[1] is not None]
    if not readers:
        raise ValueError("no read to make stale")
    r = rng.choice(readers)
    w, k = key_of(r)
    mops[r] = [["r", k, None]]
    outs[r] = [["r", k, list(before[w][k]) or None]]


class PoolHistory:
    """One synthesized history: its op dicts (what the reference reads)
    and the same ops as column arrays (what the entry's ``History`` is
    built from). ``len`` is its entries, invocations and
    completions."""

    __slots__ = ("role", "index", "ops", "type_code", "proc", "values",
                 "errors")

    def __init__(self, role: str, index: int, ops: list):
        self.role = role
        self.index = index
        self.ops = ops
        self.type_code = np.array([TYPE_CODES[o["type"]] for o in ops],
                                  dtype=np.int8)
        self.proc = np.array([o["process"] for o in ops], dtype=np.int64)
        self.values = [o["value"] for o in ops]
        self.errors = {r: o["error"] for r, o in enumerate(ops)
                       if "error" in o}

    @property
    def name(self) -> tuple:
        return self.role, self.index

    def __len__(self) -> int:
        return len(self.ops)


def history_of(params: dict, seed: int, role: str, j: int) -> PoolHistory:
    """Pool history ``j`` of ``role`` for ``seed``: the clean history
    of index j, with the plant where ``role`` is ``corrupt``."""
    shape = {k: params[k] for k in (
        "txns", "concurrency", "key_count", "max_txn_length",
        "max_writes_per_key", "fail_rate", "info_rate")}
    plant = params["plant"] if role == "corrupt" else None
    ops = gen_append_history(
        _rng(seed, "clean", j), plant=plant,
        staleness=params.get("staleness", 1),
        plant_rng=_rng(seed, "plant", j), **shape)
    return PoolHistory(role, j, ops)


class Traffic:
    """The pool of one run and the histories drawn from it: one history
    a check, in each block of ``corrupt_every`` one corrupted (at a
    slot drawn for the block), each role's histories in turn through a
    shuffled order."""

    def __init__(self, params: dict, seed: int):
        if list(params["keys_per_history"]) != [1, 1]:
            raise ValueError("append_pool puts one run in a history: "
                             "keys_per_history must be [1, 1]")
        self.params = params
        self.seed = seed
        self.pool = {role: [history_of(params, seed, role, j)
                            for j in range(params["pool"][role])]
                     for role in ROLES}
        self.corrupt_every = params["corrupt_every"]
        self._turns = {role: [] for role in ROLES}
        self._rngs = {role: _rng(seed, "turns", role) for role in ROLES}

    def role(self, i: int) -> str:
        """The role of history ``i``."""
        block, at = divmod(i, self.corrupt_every)
        slot = _rng(self.seed, "corrupt", block).randrange(
            self.corrupt_every)
        return "corrupt" if at == slot else "clean"

    def _take(self, role: str) -> PoolHistory:
        turns = self._turns[role]
        if not turns:
            order = list(range(len(self.pool[role])))
            self._rngs[role].shuffle(order)
            turns.extend(order)
        return self.pool[role][turns.pop(0)]

    def history(self, i: int) -> list:
        """History ``i`` as a list of one ``PoolHistory``. Draws advance
        the pool's turns, so call in order of ``i``."""
        return [self._take(self.role(i))]

    def warmup(self) -> list:
        """The warm-up histories, one of the role each entry of
        ``warmup`` names, drawn apart from the window's turns."""
        out = []
        for j, w in enumerate(self.params.get("warmup") or []):
            role, = (r for r in ROLES if w.get(r))
            hs = self.pool[role]
            out.append([hs[_rng(self.seed, "warmup", j)
                           .randrange(len(hs))]])
        return out


def make(params: dict, seed: int) -> Traffic:
    return Traffic(params, seed)
