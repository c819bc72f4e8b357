"""Keyed register histories assembled from a pool of synthesized keys.

Synthesizing a key costs tens of milliseconds of host Python (more on
a slow host), so a run synthesizes a small pool of distinct keys in its
set-up and hands the checker histories assembled from it: the keys of
history ``i`` relabelled and their processes offset by 100 a slot, as
``jepsen.independent`` keys them. Every seed gets the same sizes and
the same mix in another order: history ``i``'s key count cycles through
every size in ``keys_per_history`` once a cycle, one history in each
block of ``corrupt_every`` carries one corrupted key, faulted keys
alternate between the counts in ``faulted_per_history``, and each role
of the pool is used in turn through a shuffled order, so every key of
the pool is checked about as often as every other.

Parameters (the configuration's keys, then the cell's ``params`` over
them): ``readers``, ``writers``, ``values``, ``concurrency`` and
``ops_per_key`` (a key's shape, ``synth.gen_register_history``),
``keys_per_history`` ([least, most]),
``pool`` (how many ``clean``, ``corrupt`` and ``faulted`` keys),
``corrupt_every`` (0: none), ``faulted_per_history`` ([] or counts),
``info_rate`` (the faulted keys' :info share), ``fixed_roles`` (roles
whose keys are the same in every seed: where a role's keys differ in
cost, each seed then does the same work in another order) and
``warmup`` (one dict a warm-up history: ``keys``, ``corrupt``,
``faulted``).

A corrupted key is the clean key of the same index synthesized with
``corrupt=True``: the same ops, some observations misreported.
"""

from __future__ import annotations

import random

import numpy as np

from .synth import gen_register_history

#: ``f`` values in the order of the ``f_code`` column
F_TABLE = ("read", "write", "cas")
TYPE_CODES = {"invoke": 0, "ok": 1, "fail": 2, "info": 3}
#: a slot's processes are offset by this much: past any process a key
#: reaches (its threads, plus ``concurrency`` for each :info)
PROC_STRIDE = 1000


class PoolKey:
    """One synthesized key: its op dicts (what the reference reads) and
    the same ops as column arrays (what a history is assembled from)."""

    __slots__ = ("role", "index", "ops", "type_code", "f_code", "proc",
                 "values", "errors")

    def __init__(self, role: str, index: int, ops: list):
        self.role = role
        self.index = index
        self.ops = ops
        self.type_code = np.array([TYPE_CODES[o["type"]] for o in ops],
                                  dtype=np.int8)
        self.f_code = np.array([F_TABLE.index(o["f"]) for o in ops],
                               dtype=np.int32)
        self.proc = np.array([o["process"] for o in ops], dtype=np.int64)
        self.values = [o["value"] for o in ops]
        self.errors = {r: o["error"] for r, o in enumerate(ops)
                       if "error" in o}

    @property
    def name(self) -> tuple:
        return self.role, self.index

    def __len__(self) -> int:
        return len(self.ops)


def _rng(seed: int, *parts) -> random.Random:
    return random.Random("/".join(str(p) for p in (seed, *parts)))


class Traffic:
    """The pool of one run and the histories drawn from it."""

    def __init__(self, params: dict, seed: int):
        self.params = params
        self.seed = seed
        shape = {k: params[k] for k in ("readers", "writers", "values",
                                         "concurrency")}
        sizes = params["pool"]
        fixed = set(params.get("fixed_roles") or ())
        self.pool: dict = {}
        for role in ("clean", "corrupt", "faulted"):
            stream = "faulted" if role == "faulted" else "clean"
            self.pool[role] = [
                PoolKey(role, j, gen_register_history(
                    _rng("fixed" if role in fixed else seed, stream, j),
                    n_ops=params["ops_per_key"], corrupt=role == "corrupt",
                    info_rate=params["info_rate"] if role == "faulted"
                    else 0.0, **shape))
                for j in range(sizes.get(role, 0))]
        lo, hi = params["keys_per_history"]
        self.sizes = list(range(lo, hi + 1))
        self.faulted = list(params.get("faulted_per_history") or [0])
        self.corrupt_every = params.get("corrupt_every", 0)
        self._turns = {role: [] for role in self.pool}
        self._rngs = {role: _rng(seed, "turns", role) for role in self.pool}

    def keys(self):
        """Every key of the pool."""
        for role in ("clean", "corrupt", "faulted"):
            yield from self.pool[role]

    def _take(self, role: str, n: int) -> list:
        """The next ``n`` keys of ``role`` in its turn order (a fresh
        shuffle of the pool whenever one runs out), never one key twice
        in a history."""
        out = []
        turns = self._turns[role]
        while len(out) < n:
            if not turns:
                order = list(range(len(self.pool[role])))
                self._rngs[role].shuffle(order)
                turns.extend(order)
            j = turns.pop(0)
            if j in out:
                continue
            out.append(j)
        return [self.pool[role][j] for j in out]

    def _compose(self, rng: random.Random, n_keys: int, n_corrupt: int,
                 n_faulted: int) -> list:
        keys = (self._take("faulted", n_faulted)
                + self._take("corrupt", n_corrupt)
                + self._take("clean", n_keys - n_faulted - n_corrupt))
        rng.shuffle(keys)
        return keys

    def history(self, i: int) -> list:
        """History ``i``'s keys, slot by slot (``PoolKey`` objects).
        Draws advance the pool's turns, so call in order of ``i``."""
        cycle, at = divmod(i, len(self.sizes))
        order = list(self.sizes)
        _rng(self.seed, "sizes", cycle).shuffle(order)
        n_keys = order[at]
        n_corrupt = 0
        if self.corrupt_every:
            block, at = divmod(i, self.corrupt_every)
            n_corrupt = int(at == _rng(self.seed, "corrupt", block)
                            .randrange(self.corrupt_every))
        block, at = divmod(i, len(self.faulted))
        counts = list(self.faulted)
        _rng(self.seed, "faulted", block).shuffle(counts)
        return self._compose(_rng(self.seed, "slots", i), n_keys,
                             n_corrupt, counts[at])

    def warmup(self) -> list:
        """The warm-up histories: the cell's own shapes, drawn apart
        from the window's turns."""
        out = []
        for j, w in enumerate(self.params.get("warmup") or []):
            rng = _rng(self.seed, "warmup", j)
            pick = []
            for role, n in (("faulted", w.get("faulted", 0)),
                            ("corrupt", w.get("corrupt", 0)),
                            ("clean", w["keys"] - w.get("faulted", 0)
                             - w.get("corrupt", 0))):
                pick += [self.pool[role][k] for k in
                         rng.sample(range(len(self.pool[role])), n)]
            rng.shuffle(pick)
            out.append(pick)
        return out


def make(params: dict, seed: int) -> Traffic:
    return Traffic(params, seed)
