"""One key's register history at the shape of jepsen.etcd's register
workload.

``register.clj:98-119`` (the port's ``workloads/register.py``): a key
is worked by a group of ``2n`` threads, of which ``gen/reserve n r``
gives the first ``n`` reads only and the rest ``gen/mix [w cas]``,
writes and CASes one to one, with values ``rand-int 5``. A read that
times out completes ``:fail`` (reads are idempotent, ``with-errors``);
a write or CAS that times out completes ``:info``, and Jepsen retires
its process: the thread's next op runs as process ``p + concurrency``.

The timing model is the program's test synthesizer's (``testing.
gen_history``): each thread issues its ops back to back with random
durations and gaps, and an op applies atomically at a random instant
inside its [invoke, complete] span, so a history is linearizable by
construction unless ``corrupt`` misreports some observations. A timed
out write or CAS took effect, at that instant, with probability 1/2.

Ops are plain dicts (``type``, ``process``, ``f``, ``value``, and
``error`` on :info and :fail completions); nothing of the program is
imported.
"""

from __future__ import annotations

import random


def gen_register_history(rng: random.Random, readers=5, writers=5,
                         n_ops=2000, values=5, info_rate=0.0,
                         concurrency=20, corrupt=False) -> list:
    """One key's ops in history order: ``n_ops`` spread evenly over
    ``readers + writers`` threads. With ``corrupt`` the same ops come
    out with about 15 % of the :ok observations misreported (the draws
    for that follow every other draw)."""
    threads = readers + writers
    spans = []  # (start, end, thread, f, argument)
    for t in range(threads):
        at = rng.random()
        for _ in range(n_ops // threads):
            dur = 0.1 + rng.random()
            if t < readers:
                f, arg = "read", None
            elif rng.random() < 0.5:
                f, arg = "write", rng.randrange(values)
            else:
                f, arg = "cas", [rng.randrange(values),
                                 rng.randrange(values)]
            spans.append((at, at + dur, t, f, arg))
            at += dur + rng.random() * 0.3
    timed_out = [rng.random() < info_rate for _ in spans]
    took_effect = [rng.random() < 0.5 for _ in spans]
    pts = sorted((rng.uniform(s[0], s[1]), i) for i, s in enumerate(spans))
    version, value = 0, None
    outcomes = {}  # i -> (type, completion value)
    for _, i in pts:
        _, _, _, f, arg = spans[i]
        if timed_out[i] and (f == "read" or not took_effect[i]):
            outcomes[i] = ("fail" if f == "read" else "info", None)
        elif f == "read":
            outcomes[i] = ("ok", [version, value])
        elif f == "write":
            version, value = version + 1, arg
            outcomes[i] = ("ok", [version, arg])
        elif value == arg[0]:
            version, value = version + 1, arg[1]
            outcomes[i] = ("ok", [version, arg])
        else:
            outcomes[i] = ("info" if timed_out[i] else "fail", None)
    evs = sorted((s[0] if kind == 0 else s[1], kind, i)
                 for i, s in enumerate(spans) for kind in (0, 1))
    process = list(range(threads))
    ops = []
    for _, kind, i in evs:
        _, _, t, f, arg = spans[i]
        p = process[t]
        if kind == 0:
            ops.append({"type": "invoke", "process": p, "f": f,
                        "value": [None, arg]})
            continue
        typ, v = outcomes[i]
        if typ == "ok":
            if corrupt and rng.random() < 0.15:
                v = list(v)
                if rng.random() < 0.5:
                    v[0] += rng.choice([-1, 1])
                elif isinstance(v[1], int):
                    v[1] = (v[1] + 1) % values
            ops.append({"type": "ok", "process": p, "f": f, "value": v})
            continue
        error = "timeout" if timed_out[i] else "did-not-succeed"
        ops.append({"type": typ, "process": p, "f": f,
                    "value": [None, arg], "error": error})
        if typ == "info":
            process[t] = p + concurrency
    return ops
