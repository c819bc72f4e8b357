"""Elle-style transaction generators: list-append and rw-register.

The reference delegates txn generation to the Elle library
(``append.clj:183-185`` calls ``jepsen.tests.cycle.append/test`` with
``{:key-count 3 :max-txn-length 4}``; ``wr.clj:87-92`` the rw-register
variant with ``:wfr-keys true``). This module re-creates those generator
semantics:

- a rotating pool of ``key_count`` active keys; a key retires after
  ``max_writes_per_key`` writes and is replaced by a fresh key, so version
  orders stay short and the inference stays tractable;
- txns are 1..max_txn_length micro-ops ``[f, k, v]``:
  list-append: ``["r", k, None]`` / ``["append", k, v]`` with v unique and
  increasing per key; rw-register: ``["r", k, None]`` / ``["w", k, v]``;
- ``wfr_bias``: with rw-register, a write placed after a read in the same
  txn reuses the read's key with some probability, producing the
  writes-follow-reads patterns the checker's version-order inference
  (wfr-keys) feeds on.

Generators are pure functions of the shared mutable state captured in the
closure, driven through ``fn_gen`` on the deterministic loop's rng.
"""

from __future__ import annotations

from ..generators import fn_gen


class _KeyPool:
    """Rotating active-key pool with per-key unique value counters."""

    def __init__(self, key_count: int, max_writes_per_key: int):
        self.key_count = key_count
        self.max_writes = max_writes_per_key
        self.active = list(range(key_count))
        self.next_key = key_count
        self.written: dict[int, int] = {k: 0 for k in self.active}

    def read_key(self, rng) -> int:
        return rng.choice(self.active)

    def write_key(self, rng) -> tuple:
        """Pick a key and its next unique value; rotate exhausted keys."""
        k = rng.choice(self.active)
        self.written[k] += 1
        v = self.written[k]
        if self.written[k] >= self.max_writes:
            i = self.active.index(k)
            self.active[i] = self.next_key
            self.written[self.next_key] = 0
            self.next_key += 1
        return k, v

    def bump(self, k: int) -> int:
        """Next value for a specific key (wfr same-key writes)."""
        self.written[k] = self.written.get(k, 0) + 1
        return self.written[k]


def list_append_gen(key_count: int = 3, max_txn_length: int = 4,
                    max_writes_per_key: int = 32):
    """Txn generator for the list-append workload (append.clj:183-185)."""
    pool = _KeyPool(key_count, max_writes_per_key)

    def gen(test, ctx):
        rng = ctx.rng
        n = rng.randint(1, max_txn_length)
        txn = []
        for _ in range(n):
            if rng.random() < 0.5:
                txn.append(["r", pool.read_key(rng), None])
            else:
                k, v = pool.write_key(rng)
                txn.append(["append", k, v])
        return {"f": "txn", "value": txn}

    return fn_gen(gen)


def rw_register_gen(key_count: int = 3, max_txn_length: int = 4,
                    max_writes_per_key: int = 32, wfr_bias: float = 0.5):
    """Txn generator for the rw-register workload (wr.clj:87-92)."""
    pool = _KeyPool(key_count, max_writes_per_key)

    def gen(test, ctx):
        rng = ctx.rng
        n = rng.randint(1, max_txn_length)
        txn = []
        read_keys: list = []
        for _ in range(n):
            if rng.random() < 0.5:
                k = pool.read_key(rng)
                txn.append(["r", k, None])
                read_keys.append(k)
            elif read_keys and rng.random() < wfr_bias:
                # writes-follow-reads: overwrite a key this txn read
                k = rng.choice(read_keys)
                txn.append(["w", k, pool.bump(k)])
            else:
                k, v = pool.write_key(rng)
                txn.append(["w", k, v])
        return {"f": "txn", "value": txn}

    return fn_gen(gen)
