"""Test helpers: a random register-history synthesizer (a copy of the
reference's ``tests/test_wgl.py`` ``gen_history``), shared by the port's
tests and ``chip_smoke.py``."""

from __future__ import annotations

import random

from .core.history import History
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
