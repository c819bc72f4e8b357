"""Histories: ordered op sequences with invoke/completion pairing (the
port of the reference's ``core/history.py``).

Mirrors jepsen.history semantics: a history is a vector of ops ordered by
real (here: virtual) time; each client process is sequential, so an
``invoke`` by process p pairs with the next completion (``ok``/``fail``/
``info``) by p.  Crashed ops surface as ``info`` completions; processes are
then retired and replaced with ``process + concurrency`` by the interpreter
(thread recovery via ``(mod process concurrency)``, cf. reference
``watch.clj:281-282``).

A ``History`` is backed by a dict op list, by SoA columns
(``OpColumns``, ``from_columns``) or both; the keyed register check splits
column-backed histories per key without building dict ops
(``split_by_key``) and the batched packer reads the columns directly.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np

from .op import Op, INVOKE, COMPLETIONS


def pair_index(ops: list[Op]) -> dict[int, int | None]:
    """Map each op's ``index`` field -> its pair's ``index``.

    invoke -> completion index (or None if never completed);
    completion -> invoke index (or None for spontaneous completions, which
    should not occur in our histories).

    Keys are the ops' own ``index`` fields (not positions), so pairing
    survives filtering: a sub-history keeps the parent's indices.
    """
    out: dict[int, int | None] = {}
    open_by_process: dict[Any, int] = {}
    for op in ops:
        t = op.get("type")
        p = op.get("process")
        i = op["index"]
        if t == INVOKE:
            if p in open_by_process:
                raise ValueError(
                    f"process {p!r} invoked op {i} while op "
                    f"{open_by_process[p]} is still open"
                )
            open_by_process[p] = i
            out[i] = None
        elif t in COMPLETIONS:
            j = open_by_process.pop(p, None)
            out[i] = j
            if j is not None:
                out[j] = i
        else:
            raise ValueError(f"op {i} has unknown type {t!r}")
    return out


#: the op keys the typed columns carry; anything else rides in extras
_CORE_KEYS = frozenset(("type", "f", "value", "process", "time", "index"))
_CORE_ORDER = ("type", "f", "value", "process", "time", "index")
_TYPE_CODES = {"invoke": 0, "ok": 1, "fail": 2, "info": 3}
TYPE_NAMES = ("invoke", "ok", "fail", "info")


class OpColumns:
    """Typed structure-of-arrays view of an op stream (SoA columns).

    One row per history EVENT, in record order. The typed columns are
    numpy arrays; payloads stay as an aligned Python list (``values``),
    and rare non-core keys (error, debug, ...) ride in a sparse
    ``extras`` dict keyed by row. Checkers consume the arrays directly
    — ops/wgl.py's batched packer, checkers/session.py,
    checkers/perf.py, checkers/timeline.py — so the per-op dict
    round-trip disappears from those paths; dict materialization
    is lazy (``History.ops``) and counted
    (``History.dict_materializations``).

    Column schema (the reference's, unchanged):

    - ``type_code``  int8   0 invoke / 1 ok / 2 fail / 3 info
    - ``f_code``     int32  index into ``f_table`` (op ``f`` values)
    - ``proc``       int64  the process when a non-negative int;
                            non-int processes (e.g. "nemesis") intern
                            into ``proc_table`` as ``-(i + 1)``
    - ``key_id``     int64  index into ``key_table`` when the value is
                            a 2-tuple ``(key, v)`` (independent
                            workloads), else ``-1``
    - ``time``       int64  virtual nanoseconds
    - ``index``      int64  global history index
    - ``values``     list   the payload per row — the unwrapped inner
                            value for keyed rows, the raw value
                            otherwise (shared by reference, no copy)
    - ``extras``     dict   row -> {non-core keys}
    - ``missing``    dict   row -> core keys absent from the source op
    """

    __slots__ = ("type_code", "f_code", "proc", "key_id", "time", "index",
                 "values", "extras", "missing",
                 "f_table", "key_table", "proc_table")

    def __init__(self, type_code, f_code, proc, key_id, time, index,
                 values, extras, missing, f_table, key_table, proc_table):
        self.type_code = type_code
        self.f_code = f_code
        self.proc = proc
        self.key_id = key_id
        self.time = time
        self.index = index
        self.values = values
        self.extras = extras
        self.missing = missing
        self.f_table = f_table
        self.key_table = key_table
        self.proc_table = proc_table

    def __len__(self) -> int:
        return len(self.values)

    # -- row accessors -------------------------------------------------------
    def process_at(self, i: int) -> Any:
        p = int(self.proc[i])
        return p if p >= 0 else self.proc_table[-1 - p]

    def value_at(self, i: int) -> Any:
        k = int(self.key_id[i])
        v = self.values[i]
        return v if k < 0 else (self.key_table[k], v)

    def op_at(self, i: int) -> Op:
        d = Op()
        d["type"] = TYPE_NAMES[self.type_code[i]]
        d["f"] = self.f_table[self.f_code[i]]
        d["value"] = self.value_at(i)
        d["process"] = self.process_at(i)
        d["time"] = int(self.time[i])
        d["index"] = int(self.index[i])
        miss = self.missing.get(i)
        if miss:
            for k in miss:
                del d[k]
        ex = self.extras.get(i)
        if ex:
            d.update(ex)
        return d

    def to_ops(self) -> list[Op]:
        return [self.op_at(i) for i in range(len(self.values))]

    # -- pairing / splitting -------------------------------------------------
    def client_pairs(self) -> list[list[int]]:
        """``[[invoke_row, completion_row | -1], ...]`` for client ops
        (int process), in invoke order — the columnar analog of
        iterating invokes and asking ``History.completion``."""
        tc = self.type_code.tolist()
        pr = self.proc.tolist()
        pt = self.proc_table
        out: list[list[int]] = []
        open_by: dict = {}
        for i, t in enumerate(tc):
            p = pr[i]
            if p < 0 and not isinstance(pt[-1 - p], int):
                continue
            if t == 0:
                open_by[p] = len(out)
                out.append([i, -1])
            else:
                j = open_by.pop(p, None)
                if j is not None:
                    out[j][1] = i
        return out

    def split_by_key(self) -> dict:
        """Per-key sub-columns in key first-seen order: the columnar
        analog of ``generators.independent.subhistories`` (values
        unwrapped, indices preserved) with no dict materialization."""
        kid = self.key_id
        order = np.argsort(kid, kind="stable")
        skid = kid[order]
        n = len(skid)
        start = int(np.searchsorted(skid, 0, side="left"))
        groups: dict[int, np.ndarray] = {}
        i = start
        while i < n:
            k = int(skid[i])
            j = int(np.searchsorted(skid, k, side="right"))
            groups[k] = order[i:j]  # stable sort: already in row order
            i = j
        sub_extras: dict[int, dict] = {k: {} for k in groups}
        sub_missing: dict[int, dict] = {k: {} for k in groups}
        for src, dst in ((self.extras, sub_extras),
                         (self.missing, sub_missing)):
            for r, ex in src.items():
                k = int(kid[r])
                if k >= 0:
                    dst[k][int(np.searchsorted(groups[k], r))] = ex
        vals = self.values
        neg1 = None
        out: dict = {}
        for k, rows in groups.items():
            if neg1 is None or len(neg1) != len(rows):
                neg1 = np.full(len(rows), -1, dtype=np.int64)
            out[self.key_table[k]] = OpColumns(
                self.type_code[rows], self.f_code[rows], self.proc[rows],
                neg1, self.time[rows], self.index[rows],
                [vals[r] for r in rows.tolist()],
                sub_extras[k], sub_missing[k],
                self.f_table, [], self.proc_table)
        return out


class ColumnsBuilder:
    """Accumulates SoA columns as ops are recorded.

    ``append`` is on the record() hot path: plain list appends plus
    dict-interning, no numpy until ``finish()``. Anything the column
    schema can't express (unhashable f/key, unknown op type, non-int
    time) marks the builder dead and ``finish()`` returns None — the
    run keeps its dict history and checkers take the dict paths.
    """

    __slots__ = ("_tc", "_fc", "_pr", "_kid", "_tm", "_ix",
                 "values", "extras", "missing",
                 "f_index", "f_table", "key_index", "key_table",
                 "proc_index", "proc_table", "dead", "_cursor")

    def __init__(self):
        self._cursor = 0
        self._tc: list = []
        self._fc: list = []
        self._pr: list = []
        self._kid: list = []
        self._tm: list = []
        self._ix: list = []
        self.values: list = []
        self.extras: dict = {}
        self.missing: dict = {}
        self.f_index: dict = {}
        self.f_table: list = []
        self.key_index: dict = {}
        self.key_table: list = []
        self.proc_index: dict = {}
        self.proc_table: list = []
        self.dead = False

    def append(self, op: Op) -> None:
        if self.dead:
            return
        try:
            self._tc.append(_TYPE_CODES[op.get("type")])
            f = op.get("f")
            fc = self.f_index.get(f)
            if fc is None:
                fc = self.f_index[f] = len(self.f_table)
                self.f_table.append(f)
            self._fc.append(fc)
            p = op.get("process")
            if type(p) is int and p >= 0:
                self._pr.append(p)
            else:
                pc = self.proc_index.get(p)
                if pc is None:
                    pc = self.proc_index[p] = len(self.proc_table)
                    self.proc_table.append(p)
                self._pr.append(-(pc + 1))
            v = op.get("value")
            if isinstance(v, tuple) and len(v) == 2:
                k = v[0]
                kc = self.key_index.get(k)
                if kc is None:
                    kc = self.key_index[k] = len(self.key_table)
                    self.key_table.append(k)
                self._kid.append(kc)
                self.values.append(v[1])
            else:
                self._kid.append(-1)
                self.values.append(v)
            self._tm.append(op["time"])
            self._ix.append(op["index"])
            row = len(self._tc) - 1
            n_core = 0
            ex = None
            for key, val in op.items():
                if key in _CORE_KEYS:
                    n_core += 1
                else:
                    if ex is None:
                        ex = {}
                    ex[key] = val
            if ex is not None:
                self.extras[row] = ex
            if n_core != 6:
                self.missing[row] = tuple(
                    k for k in _CORE_ORDER if k not in op)
        except Exception:
            self.dead = True

    def take_chunk(self) -> Optional[OpColumns]:
        """Drain rows recorded since the previous ``take_chunk`` as an
        OpColumns slice (the streaming-checker feed). Non-destructive: a
        cursor advances but the builder keeps every row, so ``finish()``
        still returns the complete columns; intern tables are shared by
        reference (chunk codes stay valid as the tables grow — tables
        only ever append). Returns None when the builder is dead or no
        new rows arrived."""
        if self.dead:
            return None
        start, end = self._cursor, len(self._tc)
        if end <= start:
            return None
        self._cursor = end
        try:
            extras = {r - start: ex for r, ex in self.extras.items()
                      if start <= r < end}
            missing = {r - start: m for r, m in self.missing.items()
                       if start <= r < end}
            return OpColumns(
                np.asarray(self._tc[start:end], dtype=np.int8),
                np.asarray(self._fc[start:end], dtype=np.int32),
                np.asarray(self._pr[start:end], dtype=np.int64),
                np.asarray(self._kid[start:end], dtype=np.int64),
                np.asarray(self._tm[start:end], dtype=np.int64),
                np.asarray(self._ix[start:end], dtype=np.int64),
                self.values[start:end], extras, missing,
                self.f_table, self.key_table, self.proc_table)
        except Exception:
            self.dead = True
            return None

    def finish(self) -> Optional[OpColumns]:
        if self.dead:
            return None
        try:
            return OpColumns(
                np.asarray(self._tc, dtype=np.int8),
                np.asarray(self._fc, dtype=np.int32),
                np.asarray(self._pr, dtype=np.int64),
                np.asarray(self._kid, dtype=np.int64),
                np.asarray(self._tm, dtype=np.int64),
                np.asarray(self._ix, dtype=np.int64),
                self.values, self.extras, self.missing,
                self.f_table, self.key_table, self.proc_table)
        except Exception:
            return None


def columns_of(ops: Iterable[Op]) -> Optional[OpColumns]:
    """Build SoA columns from an existing op stream (tests, reloaded
    histories); None when the stream doesn't fit the schema."""
    b = ColumnsBuilder()
    for op in ops:
        b.append(op)
    return b.finish()


class History:
    """An immutable-by-convention sequence of ops with pairing helpers.

    Backed by a dict op list, SoA columns (``from_columns``), or both
    (recorded histories: the interpreter emits columns alongside the
    dict stream). Column-only histories materialize their dicts lazily
    on first ``.ops`` touch; ``History.dict_materializations`` counts
    those events so a test can assert a checker path stayed columnar."""

    #: process-wide count of lazy column->dict materializations
    dict_materializations = 0

    def __init__(self, ops: Iterable[Op],
                 columns: Optional[OpColumns] = None):
        self._ops: list[Op] = [o if isinstance(o, Op) else Op(o)
                               for o in ops]
        self.columns = columns
        # Assign indices to ops missing one, starting past any explicit
        # indices (so synthesized ops appended to a recorded history can't
        # collide); copy rather than mutate the caller's op.
        explicit = [o["index"] for o in self._ops
                    if o.get("index") is not None]
        if len(explicit) != len(set(explicit)):
            raise ValueError("duplicate op indices in history")
        nxt = max(explicit, default=-1) + 1
        for i, o in enumerate(self._ops):
            if o.get("index") is None:
                self._ops[i] = o.evolve(index=nxt)
                nxt += 1
        self._pairs: dict[int, int | None] | None = None
        self._by_index: dict[int, Op] | None = None

    @classmethod
    def from_columns(cls, columns: OpColumns) -> "History":
        """A column-only history: dict ops materialize lazily (and bump
        ``dict_materializations``) only if some consumer asks."""
        h = cls.__new__(cls)
        h._ops = None
        h.columns = columns
        h._pairs = None
        h._by_index = None
        return h

    @property
    def ops(self) -> list[Op]:
        if self._ops is None:
            History.dict_materializations += 1
            self._ops = self.columns.to_ops()
        return self._ops

    def split_by_key(self) -> dict:
        """``{key: History}`` per-key decomposition (2-tuple values),
        keys in first-seen order, values unwrapped, indices preserved —
        columnar when columns are present (no dict work), else the
        one-pass dict split."""
        if self.columns is not None:
            return {k: History.from_columns(c)
                    for k, c in self.columns.split_by_key().items()}
        from ..generators.independent import subhistories
        return {k: History(ops) for k, ops in subhistories(self).items()}

    # -- sequence protocol --------------------------------------------------
    def __len__(self) -> int:
        if self._ops is None:
            return len(self.columns)
        return len(self._ops)

    def __iter__(self) -> Iterator[Op]:
        return iter(self.ops)

    def __getitem__(self, i):
        return self.ops[i]

    # -- pairing ------------------------------------------------------------
    @property
    def pairs(self) -> dict[int, int | None]:
        if self._pairs is None:
            self._pairs = pair_index(self.ops)
        return self._pairs

    def by_index(self, i: int) -> Op:
        if self._by_index is None:
            self._by_index = {o["index"]: o for o in self.ops}
        return self._by_index[i]

    def completion(self, op: Op) -> Op | None:
        """The completion for an invoke op (or None if it never completed)."""
        j = self.pairs.get(op["index"])
        return None if j is None else self.by_index(j)

    def invocation(self, op: Op) -> Op | None:
        j = self.pairs.get(op["index"])
        return None if j is None else self.by_index(j)

    # -- filters (jepsen.history-style) -------------------------------------
    def filter(self, pred: Callable[[Op], bool]) -> "History":
        return History([o for o in self.ops if pred(o)])

    def nemesis_ops(self) -> "History":
        return self.filter(lambda o: not isinstance(o.get("process"), int))

    def client_ops(self) -> "History":
        return self.filter(lambda o: isinstance(o.get("process"), int))

    def oks(self) -> "History":
        return self.filter(lambda o: o.get("type") == "ok")

    def invokes(self) -> "History":
        return self.filter(lambda o: o.get("type") == "invoke")

    def remove_f(self, fs: set) -> "History":
        return self.filter(lambda o: o.get("f") not in fs)

    # -- (de)serialization ---------------------------------------------------
    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(_jsonable(o)) for o in self.ops)

    @classmethod
    def from_jsonl(cls, text: str) -> "History":
        ops = []
        for line in text.splitlines():
            line = line.strip()
            if line:
                ops.append(Op(_unjsonable(json.loads(line))))
        return cls(ops)

    def __repr__(self) -> str:
        return f"<History of {len(self)} ops>"


_SCALAR_TYPES = frozenset((str, int, float, bool, type(None)))


def _jsonable(x: Any) -> Any:
    """JSON encoding that round-trips tuples and sets (tagged).

    Op values use tuples structurally — e.g. the documented ``(key, value)``
    shape for independent workloads — so a plain list coercion would silently
    break tuple-equality in checkers over reloaded histories.
    """
    if isinstance(x, dict):
        if all(isinstance(k, str) for k in x) and not (
                set(x.keys()) & {"__tuple__", "__set__", "__dict__"}):
            return {k: _jsonable(v) for k, v in x.items()}
        # Non-string (or tag-colliding) keys: tagged pair-list encoding.
        return {"__dict__": [[_jsonable(k), _jsonable(v)]
                             for k, v in x.items()]}
    if isinstance(x, tuple):
        return {"__tuple__": [_jsonable(v) for v in x]}
    if isinstance(x, list):
        # fast path: a list of plain scalars is already JSON-clean and
        # json.dumps serializes it at C speed — recursing per element
        # made big read values (e.g. the set workload's full-set reads)
        # dominate history serialization. set(map(type, x)) runs the
        # whole scan in C
        if not set(map(type, x)) - _SCALAR_TYPES:
            return x
        return [_jsonable(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return {"__set__": sorted((_jsonable(v) for v in x), key=repr)}
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    return repr(x)  # lossy fallback for exotic values; documented


def _hashable(x: Any) -> Any:
    """Make a decoded key usable as a dict key (lists -> tuples)."""
    if isinstance(x, list):
        return tuple(_hashable(v) for v in x)
    if isinstance(x, set):
        return frozenset(x)
    return x


def _unjsonable(x: Any) -> Any:
    if isinstance(x, dict):
        if set(x.keys()) == {"__tuple__"}:
            return tuple(_unjsonable(v) for v in x["__tuple__"])
        if set(x.keys()) == {"__set__"}:
            return set(_unjsonable(v) for v in x["__set__"])
        if set(x.keys()) == {"__dict__"}:
            return {_hashable(_unjsonable(k)): _unjsonable(v)
                    for k, v in x["__dict__"]}
        return {k: _unjsonable(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_unjsonable(v) for v in x]
    return x
