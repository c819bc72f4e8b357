"""The plain reference for the register workload's checker.

Knossos's semantics for etcd's versioned register (``register.clj``:
the model at lines 55-96, the checker at 110-119), written again from
the definitions in plain Python with no search engine, kernel or
table of the program, and importing nothing of it:

- ``linearizable(ops)``: a Wing-Gong depth-first search with Lowe's
  memo of (linearized set, register state). An :ok op must linearize,
  with its completion's value; an :info op, or one still open at the
  end, may linearize at any point after its invoke, or never, with its
  invocation's value; a :fail op never happened. An op may linearize
  next only if it was invoked before the earliest return among the
  :ok ops not linearized yet.
- ``session(ops)``: monotone reads and writes-follow-reads over each
  process's :ok ops that carry an integer version: a read's version
  may not fall below the largest version the process read before it,
  and a write's (or cas's) resulting version must exceed it.

``ops`` is one key's history: op dicts with ``type``, ``process``,
``f`` and ``value`` (``[version, value]``, unwrapped from the key), in
history order.

Two reductions keep the search short, each sound by the model alone:
an :info read is left out (it changes no state wherever it is put);
:info updates with the same ``f`` and value are put in invoke order
(swapping two leaves a linearization valid); and a configuration whose
version is past the one some required op still needs is dropped
(versions only grow).
"""

from __future__ import annotations

INF = float("inf")


def _entries(ops: list) -> list:
    """(f, value, invoke position, return position, required) per
    operation that may have taken effect, in invoke order; positions
    count the client ops (integer processes) of the history. A read
    that never completed :ok is left out: it changes no state wherever
    it is put, and it need not be put anywhere."""
    out = []
    open_by = {}
    pos = 0
    for op in ops:
        proc = op.get("process")
        if not isinstance(proc, int):
            continue
        pos += 1
        t = op["type"]
        if t == "invoke":
            open_by[proc] = (pos, op)
            continue
        got = open_by.pop(proc, None)
        if got is None or t == "fail":
            continue
        inv_pos, inv = got
        if t == "ok":
            out.append((inv["f"], op.get("value"), inv_pos, pos, True))
        elif t == "info":
            if inv["f"] != "read":
                out.append((inv["f"], inv.get("value"), inv_pos, INF,
                            False))
        else:
            open_by[proc] = got
    for inv_pos, inv in open_by.values():
        if inv["f"] != "read":
            out.append((inv["f"], inv.get("value"), inv_pos, INF, False))
    out.sort(key=lambda e: e[2])
    return out


def _step(version, value, f, op_value):
    """The versioned register's transition (register.clj:55-96): the
    next (version, value), or None where the op cannot apply."""
    op_version, op_val = op_value if op_value is not None else (None, None)
    if f == "write":
        if op_version is not None and op_version != version + 1:
            return None
        return version + 1, op_val
    if f == "cas":
        old, new = op_val
        if op_version is not None and op_version != version + 1:
            return None
        if value != old:
            return None
        return version + 1, new
    if f == "read":
        if op_version is not None and op_version != version:
            return None
        if op_val is not None and op_val != value:
            return None
        return version, value
    return None


def linearizable(ops: list) -> dict:
    """``{"valid?": bool, "configs": n, "depth": d}``: the verdict, the
    configurations searched, and the most ops any path linearized."""
    es = _entries(ops)
    req_mask = 0
    infos = []
    for i, e in enumerate(es):
        if e[4]:
            req_mask |= 1 << i
        else:
            infos.append(i)
    # indefinite ops with the same f and value are interchangeable: a
    # linearization that puts a later-invoked one where an earlier one
    # stays out stays valid with the two swapped, so each such class is
    # put in invoke order
    first_of = {}
    before = {}
    for i in infos:
        cls = (es[i][0], repr(es[i][1]))
        if cls in first_of:
            before[i] = first_of[cls]
        first_of[cls] = i
    # every update raises the version by one, so a required op that
    # names a version needs the register at one version: an update's
    # named version less one, a read's named version. A configuration
    # past the least version some required op still needs cannot
    # finish.
    needs = []
    for i, e in enumerate(es):
        ver = e[1][0] if isinstance(e[1], (list, tuple)) and e[1] else None
        if e[4] and isinstance(ver, int):
            needs.append((ver if e[0] == "read" else ver - 1, i))
    needs.sort()
    visited = set()
    stack = [(0, 0, None, 0, 0)]
    configs = 0
    best = 0
    while stack:
        mask, version, value, depth, at = stack.pop()
        key = (mask, version, value)
        if key in visited:
            continue
        visited.add(key)
        configs += 1
        if depth > best:
            best = depth
        while at < len(needs) and (mask >> needs[at][1]) & 1:
            at += 1
        if at < len(needs) and version > needs[at][0]:
            continue
        free = req_mask & ~mask
        if not free:
            return {"valid?": True, "configs": configs, "depth": depth}
        # required candidates: walk the free required ops in invoke
        # order while they were invoked before the earliest return seen
        min_ret = INF
        cands = []
        x = free
        while x:
            low = x & -x
            i = low.bit_length() - 1
            e = es[i]
            if e[2] >= min_ret:
                break
            if e[3] < min_ret:
                min_ret = e[3]
            cands.append(i)
            x ^= low
        nxt = []
        for i in infos:
            e = es[i]
            if e[2] >= min_ret:
                break
            if not (mask >> i) & 1 and (
                    i not in before or (mask >> before[i]) & 1):
                nxt.append(i)
        # pushed last = tried first: required ops in invoke order
        for i in reversed([i for i in cands if es[i][2] < min_ret]):
            nxt.append(i)
        for i in nxt:
            e = es[i]
            s = _step(version, value, e[0], e[1])
            if s is not None:
                stack.append((mask | (1 << i), s[0], s[1], depth + 1, at))
    return {"valid?": False, "configs": configs, "depth": best}


def session(ops: list, monotone_reads: bool = True) -> dict:
    """``{"valid?": bool, "violations": n}``. ``monotone_reads=False``
    leaves that guarantee out: the benchmark's control."""
    read_max = {}
    reads = 0
    bad = 0
    for op in ops:
        if op["type"] != "ok" or op["f"] not in ("read", "write", "cas"):
            continue
        v = op.get("value")
        if not isinstance(v, (list, tuple)) or not v:
            continue
        ver = v[0]
        if not isinstance(ver, int):
            continue
        proc = op["process"]
        prior = read_max.get(proc, -1)
        if op["f"] == "read":
            reads += 1
            if monotone_reads and ver < prior:
                bad += 1
            if ver > prior:
                read_max[proc] = ver
        elif 0 <= ver <= prior:
            bad += 1
    if reads == 0:
        return {"valid?": True, "violations": 0}
    return {"valid?": bad == 0, "violations": bad}


def key_verdict(ops: list, control: bool = False) -> dict:
    """One key's verdicts as the register workload's checker gives
    them: ``linear`` and ``session`` (with ``violations`` counted), and
    ``depth``, the most ops the search linearized. ``control`` drops
    monotone reads from the session guarantees."""
    lin = linearizable(ops)
    ses = session(ops, monotone_reads=not control)
    return {"linear": lin["valid?"], "depth": lin["depth"],
            "session": ses["valid?"], "violations": ses["violations"]}


def merge(verdicts: list) -> bool:
    """A history's ``valid?``: every key linearizable and every
    session guarantee held."""
    return all(v["linear"] and v["session"] for v in verdicts)


#: each number compared, with its limit: every comparison is exact
LIMITS = {"linear": 0, "session": 0, "valid": 0}


def compare(got: dict, exp: list) -> tuple:
    """``(wrong, unknown)`` for one history: ``wrong`` counts, by the
    names of ``LIMITS``, the keys whose linear or session verdict
    differs from the reference's or never came (``got["keys"]`` holds
    None there) and the history's ``valid?`` where it differs or keys
    came that were never sent; ``unknown`` counts the verdicts that are
    neither true nor false where the reference decides. ``got`` is a
    summary of the system's verdict in the form of ``entries``'
    ``summarize``; ``exp`` holds ``key_verdict`` a slot."""
    wrong = dict.fromkeys(LIMITS, 0)
    unknown = 0
    for g, e in zip(got["keys"], exp):
        if g is None:
            wrong["linear"] += 1
            wrong["session"] += 1
            continue
        if not isinstance(g["linear"], bool):
            unknown += 1
        elif g["linear"] != e["linear"]:
            wrong["linear"] += 1
        if not isinstance(g["session"], bool):
            unknown += 1
        elif g["session"] != e["session"] or \
                g["violations"] != e["violations"]:
            wrong["session"] += 1
    if len(got["keys"]) != len(exp) or got.get("extra"):
        wrong["valid"] += 1
    if not isinstance(got["valid?"], bool):
        unknown += 1
    elif got["valid?"] != merge(exp):
        wrong["valid"] += 1
    return wrong, unknown


def judge(histories: list) -> tuple:
    """``(wrong, failed)`` over a run's ``histories`` (``Checked``s,
    ``keys`` the pool's keys slot by slot): the reference's verdict of
    each pool key, once, set a slot as ``h.exp``; ``wrong`` summed by
    the names of ``LIMITS`` over the histories that came back, and
    ``failed`` the histories whose check raised or left a verdict
    neither true nor false."""
    verdicts: dict = {}
    wrong = dict.fromkeys(LIMITS, 0)
    failed = 0
    for h in histories:
        h.exp = []
        for k in h.keys:
            if k.name not in verdicts:
                verdicts[k.name] = key_verdict(k.ops)
            h.exp.append(verdicts[k.name])
        if h.got is None:
            failed += 1
            continue
        w, unknown = compare(h.got, h.exp)
        for name, n in w.items():
            wrong[name] += n
        failed += unknown > 0
    return wrong, failed


def control(keys: list, memo: dict) -> dict:
    """The control's answer for a history of ``keys``, in the form of
    the entry's summary: ``key_verdict(control=True)`` a slot, memoized
    in ``memo`` by pool key."""
    got = []
    for k in keys:
        if k.name not in memo:
            memo[k.name] = key_verdict(k.ops, control=True)
        got.append(memo[k.name])
    return {"valid?": merge(got), "keys": got, "extra": 0}
