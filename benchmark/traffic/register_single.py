"""Single-key register histories: one key of one role a history.

A run of jepsen.etcd's register workload at ``--concurrency 2n`` has one
group of threads, so it works one key, and its history is that key's
(``register.clj:98-119``). A run synthesizes a small pool of such keys
in its set-up (``synth.gen_register_history``; a key of 13,500 ops takes
about a tenth of a second of host Python) and hands the checker one key
a history. In each block of ``corrupt_every`` histories one, at a slot
drawn from the seed for the block, holds a corrupted key and the others
a faulted one; each role's keys are used in turn through a shuffled
order, so every key of the pool is checked about as often as every
other.

Parameters (the configuration's keys, then the cell's ``params`` over
them): ``readers``, ``writers``, ``values``, ``concurrency`` and
``ops_per_key`` (a key's shape), ``keys_per_history`` ([1, 1], as
``register_pool`` reads it), ``pool`` (how many ``faulted`` and
``corrupt`` keys), ``corrupt_every`` (the block), ``info_rate`` (the
faulted keys' :info share) and ``warmup`` (one dict a warm-up history:
``keys`` 1, and 1 under the role of its key).

The faulted keys are the same in every seed (seeds' own keys read up
to 16 % apart); the corrupted keys are the seed's, each the clean key
of the same index synthesized with ``corrupt=True``: the same ops, some
observations misreported.
"""

from __future__ import annotations

from .register_pool import PoolKey, _rng
from .synth import gen_register_history

ROLES = ("faulted", "corrupt")


class Traffic:
    """The pool of one run and the histories drawn from it."""

    def __init__(self, params: dict, seed: int):
        if list(params["keys_per_history"]) != [1, 1]:
            raise ValueError("register_single puts one key in a history: "
                             "keys_per_history must be [1, 1]")
        self.params = params
        self.seed = seed
        shape = {k: params[k] for k in ("readers", "writers", "values",
                                         "concurrency")}
        self.pool = {
            role: [PoolKey(role, j, gen_register_history(
                _rng("fixed", "faulted", j) if role == "faulted"
                else _rng(seed, "clean", j),
                n_ops=params["ops_per_key"], corrupt=role == "corrupt",
                info_rate=params["info_rate"] if role == "faulted"
                else 0.0, **shape))
                   for j in range(params["pool"][role])]
            for role in ROLES}
        self.corrupt_every = params["corrupt_every"]
        self._turns = {role: [] for role in ROLES}
        self._rngs = {role: _rng(seed, "turns", role) for role in ROLES}

    def role(self, i: int) -> str:
        """The role of history ``i``'s key."""
        block, at = divmod(i, self.corrupt_every)
        slot = _rng(self.seed, "corrupt", block).randrange(
            self.corrupt_every)
        return "corrupt" if at == slot else "faulted"

    def _take(self, role: str) -> PoolKey:
        """The next key of ``role`` in its turn order (a fresh shuffle
        of the pool whenever one runs out)."""
        turns = self._turns[role]
        if not turns:
            order = list(range(len(self.pool[role])))
            self._rngs[role].shuffle(order)
            turns.extend(order)
        return self.pool[role][turns.pop(0)]

    def history(self, i: int) -> list:
        """History ``i``'s one key, as a list of one ``PoolKey``. Draws
        advance the pool's turns, so call in order of ``i``."""
        return [self._take(self.role(i))]

    def warmup(self) -> list:
        """The warm-up histories, one key of the role each entry of
        ``warmup`` names, drawn apart from the window's turns."""
        out = []
        for j, w in enumerate(self.params.get("warmup") or []):
            role, = (r for r in ROLES if w.get(r))
            keys = self.pool[role]
            out.append([keys[_rng(self.seed, "warmup", j)
                             .randrange(len(keys))]])
        return out


def make(params: dict, seed: int) -> Traffic:
    return Traffic(params, seed)
