"""The full fault suite: kill, pause, partition, clock, member, corrupt,
admin — composed packages (the nemesis.clj + jepsen.nemesis.combined
analog).

Each package is {fs, nemesis, generator, final_generator, perf}; packages
compose by routing ops on ``f`` (nc/compose-packages). Target specs
mirror the reference's configuration (etcd.clj:105-112): kill/pause
target ``primaries``/``all``; partitions target ``primaries`` /
``majority`` / ``majorities-ring``. Corruption targets only the first
``majority(n) - 1`` nodes so a quorum stays intact (nemesis.clj:176);
bitflip probability ∈ {1e-3, 1e-4, 1e-5} and truncation drops ≤1024
bytes (nemesis.clj:182-183). Admin ops compact at a random client and
defrag random subsets (nemesis.clj:72-143). Every package heals in its
final generator: restart everything, resume, drop partitions, reset
clocks, grow the cluster back (capped at 60 s), compact+defrag.
"""

from __future__ import annotations

from typing import Any, Optional

from ..core.op import Op
from ..generators import (fn_gen, limit, mix, stagger, delay, time_limit,
                          phases, any_gen, seq)
from ..runner.sim import current_loop, sleep, SECOND
from ..sut.errors import SimError
from .packages import Nemesis

MS = 1_000_000


def _majority(n: int) -> int:
    return n // 2 + 1


async def _resolve_targets(test: dict, spec: str) -> list[str]:
    """Resolve a target spec to node names at invoke time."""
    db = test["db"]
    members = sorted(db.members or test["nodes"])
    if spec == "all":
        return members
    if spec == "one":
        return [current_loop().rng.choice(members)]
    if spec == "minority":
        rng = current_loop().rng
        picks = rng.sample(members, max(1, _majority(len(members)) - 1))
        return sorted(picks)
    if spec == "primaries":
        return await db.primaries(test)
    raise ValueError(f"unknown target spec {spec!r}")


class _FnNemesis(Nemesis):
    """Dispatch table f -> async handler(test, op)."""

    def __init__(self, handlers: dict):
        self.handlers = handlers

    @property
    def fs(self) -> set:
        return set(self.handlers)

    async def invoke(self, test: dict, op: Op) -> Op:
        return await self.handlers[op.f](test, op)


class ComposedNemesis(Nemesis):
    def __init__(self, parts: list[Nemesis]):
        self.parts = parts

    @property
    def fs(self) -> set:
        out: set = set()
        for p in self.parts:
            out |= p.fs
        return out

    async def setup(self, test: dict) -> None:
        for p in self.parts:
            await p.setup(test)

    async def invoke(self, test: dict, op: Op) -> Op:
        for p in self.parts:
            if op.f in p.fs:
                return await p.invoke(test, op)
        raise ValueError(f"no nemesis handles f={op.f!r}")

    async def teardown(self, test: dict) -> None:
        for p in self.parts:
            await p.teardown(test)


# ---- kill / pause ----------------------------------------------------------

def _process_package(kind: str, opts: dict, targets: list[str]) -> dict:
    """kill/start or pause/resume package (jepsen.nemesis.combined db/
    pause packages, wired at etcd.clj:105-112)."""
    interval = int(opts.get("nemesis_interval", 5) * SECOND)
    stop_f, start_f = (("kill", "start") if kind == "kill"
                       else ("pause", "resume"))

    async def do_stop(test, op):
        nodes = await _resolve_targets(test, op.value or "all")
        db = test["db"]
        out = {}
        for n in nodes:
            out[n] = (db.kill(test, n) if kind == "kill"
                      else db.pause(test, n))
        return op.evolve(type="info", value=out)

    async def do_start(test, op):
        db = test["db"]
        out = {}
        for n in sorted(db.members or test["nodes"]):
            out[n] = (db.start(test, n) if kind == "kill"
                      else db.resume(test, n))
        return op.evolve(type="info", value=out)

    def gen_stop(test, ctx):
        return {"f": stop_f, "value": ctx.rng.choice(targets)}

    def gen_start(test, ctx):
        return {"f": start_f, "value": "all"}

    return {
        "fs": {stop_f, start_f},
        "nemesis": _FnNemesis({stop_f: do_stop, start_f: do_start}),
        "generator": stagger(interval, mix([gen_stop, gen_start])),
        "final_generator": limit(1, fn_gen(gen_start)),
        "perf": [{"name": kind, "fs": [stop_f, start_f],
                  "start": [stop_f], "stop": [start_f],
                  "color": "#E9A4A0" if kind == "kill" else "#A0B2E9"}],
    }


# ---- partition / latency ---------------------------------------------------

def _partition_pool(test: dict) -> list[str]:
    """Nodes a network fault can target: alive sim nodes, or the local
    control plane's current membership."""
    cluster = test.get("cluster")
    if cluster is not None:
        nodes = sorted(cluster.nodes)
        alive = [n for n in nodes if cluster.nodes[n].alive]
        return alive or nodes
    db = test["db"]
    return sorted(db.members or test["nodes"])


def _net_backend(test: dict):
    """The network fault surface: the simulated Cluster, or the local
    control plane's userspace proxy fleet (net/plane.py). Both speak
    partition/partition_pairs/heal_partition/set_latency/clear_latency
    with the shared blocked-pair encoding."""
    cluster = test.get("cluster")
    if cluster is not None:
        return cluster
    plane = getattr(test.get("db"), "plane", None)
    if plane is None:
        raise SimError(
            "unsupported",
            "no network fault backend: need the sim cluster or "
            "--db local with the net proxy plane (--net-proxy)",
            definite=True)
    return plane


def _partition_groups(test: dict, spec: str, primaries: list) -> Any:
    """Compute a partition. Returns either a list of groups (disjoint
    isolation) or a set of blocked pairs — frozensets are
    bidirectional, ordered (src, dst) tuples are one-way."""
    rng = current_loop().rng
    pool = _partition_pool(test)
    if spec == "primaries" and primaries:
        p = rng.choice(sorted(primaries))
        return [[p], [n for n in pool if n != p]]
    if spec == "majority" or (spec == "primaries" and not primaries):
        sh = list(pool)
        rng.shuffle(sh)
        maj = _majority(len(sh))
        return [sh[:maj], sh[maj:]]
    if spec == "majorities-ring":
        # each node sees itself plus its ring neighbors — everyone has a
        # "majority" view but no two agree (the classic etcd killer)
        sh = list(pool)
        rng.shuffle(sh)
        n = len(sh)
        keep = max(1, (_majority(n) - 1) // 2)
        blocked = set()
        for i in range(n):
            for j in range(i + 1, n):
                dist = min((j - i) % n, (i - j) % n)
                if dist > keep:
                    blocked.add(frozenset((sh[i], sh[j])))
        return blocked
    if spec == "bridge":
        # two halves that only communicate through one bridge node
        # (jepsen.nemesis bridge): neither half has a majority alone,
        # the bridge sees everyone
        sh = list(pool)
        rng.shuffle(sh)
        bridge, rest = sh[0], sh[1:]
        half = len(rest) // 2
        g1, g2 = rest[:half], rest[half:]
        return {frozenset((a, b)) for a in g1 for b in g2}
    if spec == "one-way":
        # asymmetric: one node's OUTBOUND traffic is blackholed while
        # inbound still flows — the fault class a symmetric
        # groups-based partition cannot express
        x = rng.choice(list(pool))
        return {(x, o) for o in pool if o != x}
    raise ValueError(f"unknown partition spec {spec!r}")


def partition_package(opts: dict) -> dict:
    interval = int(opts.get("nemesis_interval", 5) * SECOND)
    targets = ["primaries", "majority", "majorities-ring", "bridge",
               "one-way"]

    async def start(test, op):
        primaries = await test["db"].primaries(test)
        g = _partition_groups(test, op.value, primaries)
        backend = _net_backend(test)
        if isinstance(g, set):
            backend.partition_pairs(g)
            desc = f"{op.value} ({len(g)} blocked links)"
        else:
            backend.partition(g)
            desc = [sorted(x) for x in g]
        return op.evolve(type="info", value=desc)

    async def stop(test, op):
        _net_backend(test).heal_partition()
        return op.evolve(type="info", value="fully-connected")

    def gen_start(test, ctx):
        return {"f": "start-partition", "value": ctx.rng.choice(targets)}

    def gen_stop(test, ctx):
        return {"f": "stop-partition", "value": None}

    return {
        "fs": {"start-partition", "stop-partition"},
        "nemesis": _FnNemesis({"start-partition": start,
                               "stop-partition": stop}),
        "generator": stagger(interval, mix([gen_start, gen_stop])),
        "final_generator": limit(1, fn_gen(gen_stop)),
        "perf": [{"name": "partition",
                  "fs": ["start-partition", "stop-partition"],
                  "start": ["start-partition"],
                  "stop": ["stop-partition"], "color": "#E9DCA0"}],
    }


def latency_package(opts: dict) -> dict:
    """Injected link latency + jitter: the sim adds a bounded extra
    delay to every message leg; local mode programs the proxy plane
    (net/plane.py), which sleeps real milliseconds per chunk."""
    interval = int(opts.get("nemesis_interval", 5) * SECOND)

    async def start(test, op):
        v = op.value or {}
        backend = _net_backend(test)
        backend.set_latency(float(v.get("delta-ms", 50)),
                            float(v.get("jitter-ms", 0)))
        # lossy-link rider: per-chunk drop probability, only the proxy
        # plane speaks it (the sim cluster models loss as timeouts) —
        # guard so the same spec works against either backend
        set_dp = getattr(backend, "set_drop_prob", None)
        if set_dp is not None and v.get("drop-prob"):
            set_dp(float(v["drop-prob"]))
        return op.evolve(type="info")

    async def stop(test, op):
        backend = _net_backend(test)
        backend.clear_latency()
        clear_dp = getattr(backend, "clear_drop_prob", None)
        if clear_dp is not None:
            clear_dp()
        return op.evolve(type="info", value="latency-cleared")

    def gen_start(test, ctx):
        return {"f": "start-latency",
                "value": {"delta-ms": 2 ** ctx.rng.randint(3, 7),
                          "jitter-ms": 2 ** ctx.rng.randint(0, 5),
                          "drop-prob": ctx.rng.choice(
                              [0.0, 0.0, 0.01, 0.05])}}

    def gen_stop(test, ctx):
        return {"f": "stop-latency", "value": None}

    return {
        "fs": {"start-latency", "stop-latency"},
        "nemesis": _FnNemesis({"start-latency": start,
                               "stop-latency": stop}),
        "generator": stagger(interval, mix([gen_start, gen_stop])),
        "final_generator": limit(1, fn_gen(gen_stop)),
        "perf": [{"name": "latency",
                  "fs": ["start-latency", "stop-latency"],
                  "start": ["start-latency"],
                  "stop": ["stop-latency"], "color": "#C9E9A0"}],
    }


# ---- clock -----------------------------------------------------------------

def clock_package(opts: dict) -> dict:
    interval = int(opts.get("nemesis_interval", 5) * SECOND)

    async def bump(test, op):
        cluster = test["cluster"]
        for node, delta in (op.value or {}).items():
            cluster.bump_clock(node, int(delta * MS))
        return op.evolve(type="info")

    async def strobe(test, op):
        # genuinely oscillate: flip each strobed node's clock between 0
        # and +delta every period-ms for duration-ms (the sim analog of
        # jepsen.nemesis.time strobe-time!), so lease-expiry races see a
        # moving clock, not just a one-shot skew
        cluster = test["cluster"]
        v = op.value or {}
        nodes = v.get("nodes", [])
        period = max(1, int(v.get("period-ms", 1))) * MS
        duration = int(v.get("duration-ms", 1000)) * MS
        delta = int(v.get("delta-ms", 200)) * MS
        loop = current_loop()
        end = loop.now + duration
        up = False
        while loop.now < end:
            for node in nodes:
                cluster.bump_clock(node, -delta if up else delta)
            up = not up
            await sleep(min(period, end - loop.now))
        if up:  # land back where we started, residual skew = 0
            for node in nodes:
                cluster.bump_clock(node, -delta)
        return op.evolve(type="info")

    async def reset(test, op):
        cluster = test["cluster"]
        for node in sorted(cluster.nodes):
            cluster.nodes[node].clock_offset = 0
        return op.evolve(type="info", value=sorted(cluster.nodes))

    def rand_subset(ctx, test):
        nodes = sorted(test["cluster"].nodes)
        k = ctx.rng.randint(1, len(nodes))
        return ctx.rng.sample(nodes, k)

    def gen_bump(test, ctx):
        delta = ctx.rng.choice([-1, 1]) * (2 ** ctx.rng.randint(4, 15))
        return {"f": "bump-clock",
                "value": {n: delta for n in rand_subset(ctx, test)}}

    def gen_strobe(test, ctx):
        return {"f": "strobe-clock",
                "value": {"nodes": rand_subset(ctx, test),
                          "period-ms": 2 ** ctx.rng.randint(0, 10),
                          "delta-ms": 2 ** ctx.rng.randint(4, 9),
                          "duration-ms": ctx.rng.randint(200, 2000)}}

    def gen_reset(test, ctx):
        return {"f": "reset-clock", "value": None}

    return {
        "fs": {"bump-clock", "strobe-clock", "reset-clock"},
        "nemesis": _FnNemesis({"bump-clock": bump, "strobe-clock": strobe,
                               "reset-clock": reset}),
        "generator": stagger(interval,
                             mix([gen_bump, gen_strobe, gen_reset])),
        "final_generator": limit(1, fn_gen(gen_reset)),
        "perf": [{"name": "clock",
                  "fs": ["bump-clock", "strobe-clock", "reset-clock"],
                  "color": "#A0E9DC"}],
    }


# ---- membership ------------------------------------------------------------

def member_package(opts: dict) -> dict:
    interval = int(opts.get("nemesis_interval", 5) * SECOND)
    full_count = len(opts["nodes"])

    async def grow(test, op):
        try:
            return op.evolve(type="info",
                             value=await test["db"].grow(test))
        except (SimError, TimeoutError) as e:
            return op.evolve(type="info", value=f"grow-failed: {e}")

    async def shrink(test, op):
        try:
            return op.evolve(type="info",
                             value=await test["db"].shrink(test))
        except (SimError, TimeoutError) as e:
            return op.evolve(type="info", value=f"shrink-failed: {e}")

    def gen(test, ctx):
        return {"f": ctx.rng.choice(["grow", "shrink"]), "value": None}

    def final(test, ctx):
        # until the cluster is back to full strength, emit grows
        # (nemesis.clj:47-64)
        if len(test["db"].members or ()) < full_count:
            return {"f": "grow", "value": None}
        return None

    return {
        "fs": {"grow", "shrink"},
        "nemesis": _FnNemesis({"grow": grow, "shrink": shrink}),
        "generator": stagger(interval, fn_gen(gen)),
        "final_generator": time_limit(60 * SECOND,
                                      delay(1 * SECOND, fn_gen(final))),
        "perf": [{"name": "grow", "fs": ["grow"], "color": "#E9A0E6"},
                 {"name": "shrink", "fs": ["shrink"], "color": "#ACA0E9"}],
    }


# ---- corruption ------------------------------------------------------------

def corrupt_package(opts: dict, faults: set) -> Optional[dict]:
    interval = int(opts.get("nemesis_interval", 5) * SECOND)
    fault_types = []
    if "bitflip-wal" in faults:
        fault_types.append(("bitflip", "wal"))
    if "bitflip-snap" in faults:
        fault_types.append(("bitflip", "snap"))
    if "truncate-wal" in faults:
        fault_types.append(("truncate", "wal"))
    if not fault_types:
        return None

    async def corrupt(test, op):
        (node, spec), = op.value.items()
        test["cluster"].corrupt_file(
            node, which=spec["file"],
            mode="bitflip" if "probability" in spec else "truncate",
            probability=spec.get("probability", 1e-4),
            truncate_bytes=spec.get("drop", 1024))
        return op.evolve(type="info")

    def gen(test, ctx):
        nodes = sorted(test["nodes"])
        targets = nodes[:max(1, _majority(len(nodes)) - 1)]
        node = ctx.rng.choice(targets)
        fault, ftype = ctx.rng.choice(fault_types)
        spec: dict = {"file": ftype}
        if fault == "truncate":
            spec["drop"] = ctx.rng.randint(0, 1024)
        else:
            spec["probability"] = ctx.rng.choice([1e-3, 1e-4, 1e-5])
        return {"f": f"{fault}-{ftype}", "value": {node: spec}}

    fs = {f"{f}-{t}" for f, t in fault_types}
    return {
        "fs": fs,
        "nemesis": _FnNemesis({f: corrupt for f in fs}),
        "generator": stagger(interval, fn_gen(gen)),
        "final_generator": None,
        "perf": [{"name": "corrupt", "fs": sorted(fs),
                  "color": "#99F2E2"}],
    }


# ---- admin (compact / defrag) ---------------------------------------------

def _admin_nodes(test: dict) -> list[str]:
    """Current cluster membership for admin targeting: the db's member
    set tracks grow/shrink; test['nodes'] is only the starting roster."""
    db = test.get("db")
    members = getattr(db, "members", None) if db is not None else None
    return sorted(members or test["nodes"])


def admin_package(opts: dict) -> dict:
    interval = int(opts.get("nemesis_interval", 5) * SECOND)
    # the client factory dispatches on client_type/db_mode, so admin
    # ops work identically against the simulated cluster and the local
    # control plane's real processes
    from ..client import client as make_client

    async def compact(test, op):
        rng = current_loop().rng
        node = rng.choice(_admin_nodes(test))
        c = make_client(test, node)
        try:
            rev = await c.revision()
            await c.compact(rev, physical=True)
            return op.evolve(type="info", value=f"compacted to {rev}")
        except (SimError, TimeoutError) as e:
            return op.evolve(type="info", value="compact-failed",
                             error=str(e))
        finally:
            c.close()

    async def defrag(test, op):
        out = {}
        for node in op.value or _admin_nodes(test):
            c = make_client(test, node)
            try:
                await c.defrag()
                out[node] = "defragged"
            except (SimError, TimeoutError) as e:
                out[node] = f"defrag-failed: {e}"
            finally:
                c.close()
        return op.evolve(type="info", value=out)

    def gen_compact(test, ctx):
        return {"f": "compact", "value": None}

    def gen_defrag(test, ctx):
        nodes = _admin_nodes(test)
        if ctx.rng.random() < 0.5:
            nodes = ctx.rng.sample(nodes, ctx.rng.randint(1, len(nodes)))
        return {"f": "defrag", "value": sorted(nodes)}

    return {
        "fs": {"compact", "defrag"},
        "nemesis": _FnNemesis({"compact": compact, "defrag": defrag}),
        "generator": stagger(interval, mix([gen_compact, gen_defrag])),
        "final_generator": seq(limit(1, fn_gen(gen_compact)),
                               limit(1, fn_gen(gen_defrag))),
        "perf": [{"name": "compact", "fs": ["compact"], "color": "#2021CC"},
                 {"name": "defrag", "fs": ["defrag"], "color": "#BE20CC"}],
    }


# ---- composition -----------------------------------------------------------

#: every fault name the nemesis layer knows (compose.py's fault matrix
#: and the CLI validate against this)
KNOWN_FAULTS = frozenset({
    "kill", "pause", "partition", "latency", "clock", "member", "admin",
    "bitflip-wal", "bitflip-snap", "truncate-wal"})


def build_packages(opts: dict, faults: set) -> dict:
    """Build and compose the packages for the requested fault set
    (nemesis-package, nemesis.clj:200-209)."""
    packages = []
    if "kill" in faults:
        packages.append(_process_package("kill", opts,
                                         ["primaries", "all"]))
    if "pause" in faults:
        packages.append(_process_package("pause", opts,
                                         ["primaries", "all"]))
    if "partition" in faults:
        packages.append(partition_package(opts))
    if "latency" in faults:
        packages.append(latency_package(opts))
    if "clock" in faults:
        packages.append(clock_package(opts))
    if "member" in faults:
        packages.append(member_package(opts))
    if "admin" in faults:
        packages.append(admin_package(opts))
    cp = corrupt_package(opts, faults)
    if cp is not None:
        packages.append(cp)
    unknown = faults - KNOWN_FAULTS
    if unknown:
        raise ValueError(f"unknown faults {sorted(unknown)}")
    if not packages:
        return {"nemesis": None, "generator": None,
                "final_generator": None, "perf": []}

    gens = [p["generator"] for p in packages if p["generator"] is not None]
    finals = [p["final_generator"] for p in packages
              if p["final_generator"] is not None]
    return {
        "nemesis": ComposedNemesis([p["nemesis"] for p in packages]),
        "generator": any_gen(*gens) if gens else None,
        "final_generator": phases(*finals) if finals else None,
        "perf": [spec for p in packages for spec in p["perf"]],
    }
