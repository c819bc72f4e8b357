"""Test helpers shared by the port's tests and ``chip_smoke.py``: a
random register-history synthesizer (a copy of the reference's
``tests/test_wgl.py`` ``gen_history``), keyed (independent) register
histories built from it (the reference's ``tests/test_batch.py``
``keyed`` / ``multi_key_history``, and ``keyed_register_history``), the
reference's ``_concurrent_writes_history`` (a frontier of C(n, n/2)
states), rounds of unversioned concurrent ops (one window mask with
several values, ``unversioned_rounds_history``), a late impossible read that makes a long history invalid near
its end (``impossible_read_at``), and a watch-history synthesizer with
the op shape of the reference's ``workloads/watch.py``."""

from __future__ import annotations

import itertools
import random

from .core.history import History, columns_of
from .core.op import Op


def gen_history(rng: random.Random, n_procs=4, n_ops=20, values=3,
                corrupt=False, info_rate=0.0, dur_scale=1.0):
    """Random concurrent register history via linearization-point
    simulation: ops apply atomically at a random instant inside their
    [invoke, complete] span, so the generated history is linearizable by
    construction — unless `corrupt` flips some observations. With
    info_rate > 0, some ops complete :info (timeout/crash): the client
    doesn't learn the outcome — the op took effect with probability 1/2
    (at its linearization point) or not at all."""
    events = []  # (time, kind, proc, ...)
    t = 0.0
    state_v = 0   # version
    state_val = None
    # build per-process schedules: (start, end) spans
    spans = []
    for p in range(n_procs):
        at = rng.random()
        for _ in range(n_ops // n_procs):
            dur = (0.1 + rng.random()) * dur_scale
            spans.append((at, at + dur, p))
            at += dur + rng.random() * 0.3
    is_info = [rng.random() < info_rate for _ in spans]
    took_effect = [rng.random() < 0.5 for _ in spans]
    # linearization points decide outcomes
    pts = sorted((rng.uniform(s, e), i) for i, (s, e, p) in enumerate(spans))
    outcomes = {}
    for _, i in pts:
        s, e, p = spans[i]
        f = rng.choice(["read", "write", "cas"])
        if is_info[i] and not took_effect[i]:
            # crashed before reaching the server: no state change
            if f == "read":
                outcomes[i] = ("read", [None, None])
            elif f == "write":
                outcomes[i] = ("write", [None, rng.randrange(values)])
            else:
                outcomes[i] = ("cas", [None, [rng.randrange(values),
                                              rng.randrange(values)]])
            continue
        if f == "read":
            outcomes[i] = ("read", [state_v, state_val])
        elif f == "write":
            v = rng.randrange(values)
            state_v += 1
            state_val = v
            outcomes[i] = ("write", [state_v, v])
        else:
            old = rng.randrange(values)
            new = rng.randrange(values)
            if state_val == old:
                state_v += 1
                state_val = new
                outcomes[i] = ("cas", [state_v, [old, new]])
            elif is_info[i]:
                # would not have matched; still indefinite to the client
                outcomes[i] = ("cas", [None, [old, new]])
            else:
                outcomes[i] = ("cas-fail", [None, [old, new]])
    ops = []
    evs = []
    for i, (s, e, p) in enumerate(spans):
        evs.append((s, "inv", i, p))
        evs.append((e, "ret", i, p))
    evs.sort()
    for _, kind, i, p in evs:
        f, val = outcomes[i]
        if kind == "inv":
            fv = f if f != "cas-fail" else "cas"
            ops.append(Op(type="invoke", process=p, f=fv,
                          value=[None, val[1]] if fv != "read"
                          else [None, None]))
        else:
            if is_info[i]:
                ops.append(Op(type="info", process=p, f=f,
                              value=[None, val[1]] if f != "read"
                              else [None, None], error="timeout"))
            elif f == "cas-fail":
                ops.append(Op(type="fail", process=p, f="cas",
                              value=[None, val[1]], error="did-not-succeed"))
            else:
                v = list(val)
                if corrupt and rng.random() < 0.15:
                    if rng.random() < 0.5 and v[0] is not None:
                        v[0] = v[0] + rng.choice([-1, 1])
                    else:
                        v[1] = (v[1] + 1) % values if isinstance(v[1], int) \
                            else v[1]
                ops.append(Op(type="ok", process=p, f=f, value=v))
    return History(ops)


def keyed(history, key, p_base) -> list:
    """Wrap a per-key history into (key, v) tuple values with disjoint
    process ids, as jepsen.independent records them (indices cleared,
    so the keyed history numbers its ops afresh)."""
    return [op.evolve(value=(key, op.get("value")),
                      process=op.get("process") + p_base, index=None)
            for op in history]


def multi_key_history(n_keys, rng, corrupt_keys=(), info_rate=0.0):
    """n_keys small keys (3 processes, 18 ops each) in one history."""
    ops = []
    for k in range(n_keys):
        sub = gen_history(rng, n_procs=3, n_ops=18,
                          corrupt=(k in corrupt_keys), info_rate=info_rate)
        ops.extend(keyed(sub, k, 100 * k))
    return History(ops)


def keyed_register_history(n_keys=32, n_ops=2_000, n_procs=10, seed=2026,
                           faulted=(3, 11, 19, 27), info_rate=0.01,
                           corrupted=(7,)) -> History:
    """A register-workload history over ``n_keys`` keys, each worked by
    ``n_procs`` processes for ``n_ops`` ops (the reference's register
    test at ``--ops-per-key``; 2n = 10 threads a key on 5 nodes): key k
    is ``gen_history(random.Random(seed + k), n_procs, n_ops)`` with
    processes offset by 100 k; ``faulted`` keys complete some ops :info
    at ``info_rate``, ``corrupted`` keys misreport some observations.
    Each op carries its position as ``time`` and the history carries SoA
    columns, as a recorded run's does."""
    ops = []
    for k in range(n_keys):
        sub = gen_history(random.Random(seed + k), n_procs=n_procs,
                          n_ops=n_ops, corrupt=k in corrupted,
                          info_rate=info_rate if k in faulted else 0.0)
        ops.extend(keyed(sub, k, 100 * k))
    ops = [op.evolve(time=t) for t, op in enumerate(ops)]
    h = History(ops)
    return History(h.ops, columns=columns_of(h.ops))


def concurrent_writes_history(n=16, read_val=1, read_ver=None) -> History:
    """n mutually-concurrent unversioned writes of the same value, then a
    sequential read (the reference's ``tests/test_wgl.py``
    ``_concurrent_writes_history``). Peak frontier C(n, n/2): 12,870
    for n=16, past the ladder's top rung, so the spill BFS runs."""
    ops = []
    for p in range(n):
        ops.append(Op(type="invoke", process=p, f="write", value=[None, 1]))
    for p in range(n):
        ops.append(Op(type="ok", process=p, f="write", value=[None, 1]))
    ops.append(Op(type="invoke", process=n, f="read", value=[None, None]))
    ops.append(Op(type="ok", process=n, f="read",
                  value=[n if read_ver is None else read_ver, read_val]))
    return History(ops)


def unversioned_rounds_history(rng: random.Random, sizes,
                               values=4) -> History:
    """Rounds of mutually concurrent ops, one round after another, with
    ``sizes[i]`` ops in round i: 3/4 unversioned writes of a random value
    in 1..values, 1/4 unversioned reads of a random value. A versioned
    write fixes its place, so in a register history a set of linearized
    ops fixes the value; here several orders of one set leave different
    values, and the same write from each gives one successor (what the
    wave search's partial dedupe removes)."""
    ops = []
    proc = 0
    for k in sizes:
        batch = [(proc + i, "write" if rng.random() < 0.75 else "read",
                  rng.randint(1, values)) for i in range(k)]
        proc += k
        for p, f, v in batch:
            ops.append(Op(type="invoke", process=p, f=f,
                          value=[None, v if f == "write" else None]))
        for p, f, v in batch:
            ops.append(Op(type="ok", process=p, f=f, value=[None, v]))
    return History(ops)


def impossible_read_at(history, frac: float) -> History:
    """A copy of a register history whose first ok read with a version
    at or past ``frac`` of its entries reads a version 1000 past the one
    it saw, which no write makes: the search dies there, after it has
    carried its frontier through most of the history."""
    ops = [Op(o) for o in history]
    for i in range(int(frac * len(ops)), len(ops)):
        o = ops[i]
        if o.type == "ok" and o.f == "read" and o.value[0] is not None:
            ops[i] = Op({**o, "value": [o.value[0] + 1000, o.value[1]]})
            return History(ops)
    raise ValueError(f"no versioned ok read past {frac} of the history")


def gen_watch_history(rng: random.Random, n_writers=5, n_watchers=5,
                      n_writes=200, per_watch=500, info_rate=0.0,
                      corrupt=None, corrupt_thread=0, gap=False,
                      unequal=False, nonmonotonic=False,
                      converge_timeout=False,
                      recycle_watchers=False) -> History:
    """A watch-workload history (``workloads/watch.py``): threads 0 ..
    n_writers-1 write consecutive ints to one key, one revision per
    applied write (the first at revision 2); threads n_writers .. each
    watch the key with ``watch`` ops of about ``per_watch`` events
    (value ``{"revision", "log", "revs"}``), then one ``final-watch``
    that brings them to the last revision (value adds ``"gaps"``). A
    write completes :info with probability ``info_rate`` (applied or not,
    evens) and its thread's process becomes process + concurrency, as
    the interpreter recycles crashed processes.

    Knobs that break the history, on watcher ``corrupt_thread`` (an
    index among the watchers): ``corrupt`` in {"drop", "reorder",
    "duplicate"} edits its log at a random place; ``gap`` removes a run
    of its events and records that window as a compaction gap (still
    valid); ``unequal`` stops it one revision short (verdict unknown);
    ``nonmonotonic`` / ``converge_timeout`` put the workload's
    ``["nonmonotonic-watch", ...]`` / ``["converge-timeout"]`` error on
    its final-watch. ``recycle_watchers`` gives every watcher a new
    process after its first watch op, as a replaced client would."""
    conc = n_writers + n_watchers
    events = []                        # (time, seq, op)
    seq = itertools.count()

    def emit(t, **op):
        events.append((t, next(seq), Op(time=t, **op)))

    proc = list(range(conc))
    applied = []                       # (value, revision, time)
    rev = 1
    for v in range(n_writes):
        th = v % n_writers
        t = 10 * v
        emit(t, type="invoke", process=proc[th], f="write", value=v)
        if rng.random() < info_rate:
            emit(t + 5, type="info", process=proc[th], f="write", value=v,
                 error="timeout")
            proc[th] += conc
            if rng.random() < 0.5:
                rev += 1
                applied.append((v, rev, t))
        else:
            rev += 1
            applied.append((v, rev, t))
            emit(t + 5, type="ok", process=proc[th], f="write", value=v)
    t_end = 10 * n_writes
    for w in range(n_watchers):
        th = n_writers + w
        seen = list(applied)
        final_rev = rev
        gaps = []
        mine = w == corrupt_thread
        if mine and unequal and seen:
            final_rev = seen[-1][1] - 1
            seen = [e for e in seen if e[1] <= final_rev]
        if mine and gap and len(seen) > 4:
            i = rng.randrange(1, len(seen) - 2)
            j = rng.randrange(i + 1, len(seen) - 1)
            gaps.append([seen[i - 1][1], seen[j - 1][1]])
            seen = seen[:i] + seen[j:]
        if mine and corrupt and len(seen) > 2:
            i = rng.randrange(len(seen) - 1)
            if corrupt == "drop":
                del seen[i]
            elif corrupt == "reorder":
                seen[i], seen[i + 1] = seen[i + 1], seen[i]
            elif corrupt == "duplicate":
                seen.insert(i, seen[i])
            else:
                raise ValueError(f"unknown corruption {corrupt!r}")
        n_watch = len(seen) // per_watch if per_watch else 0
        cuts = sorted(rng.sample(range(1, len(seen)), n_watch)) \
            if len(seen) > n_watch else []
        start, last_rev, t = 0, 0, 0
        for c in cuts + [None]:
            part = seen[start:c]
            final = c is None
            f = "final-watch" if final else "watch"
            t0 = t_end + 1 + w if final else max(t, 1)
            t1 = t_end + 100 + w if final else part[-1][2] + 7
            if part:
                last_rev = part[-1][1]
            value = {"revision": final_rev if final else last_rev,
                     "log": [e[0] for e in part],
                     "revs": [e[1] for e in part]}
            extra = {}
            if final:
                value["gaps"] = gaps
                if mine and nonmonotonic:
                    extra["error"] = ["nonmonotonic-watch",
                                      f"got event with revision {last_rev}"
                                      f" but we last saw {last_rev + 1}"]
                elif mine and converge_timeout:
                    extra["error"] = ["converge-timeout"]
            emit(t0, type="invoke", process=proc[th], f=f, value=None)
            emit(t1, type="ok", process=proc[th], f=f, value=value, **extra)
            if recycle_watchers and not final and start == 0:
                proc[th] += conc
            start, t = c, t1 + 1
    events.sort(key=lambda e: (e[0], e[1]))
    return History([op for _, _, op in events])
