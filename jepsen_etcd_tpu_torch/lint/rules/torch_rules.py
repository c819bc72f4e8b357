"""TORCH: launch and sync hygiene for eager PyTorch on a CUDA card.

Eager PyTorch launches one kernel per tensor op, and each launch costs
the host a few microseconds of dispatch whatever the size of the
tensor; a device-to-host read waits for every kernel queued before it.
One stray op or read inside a Python loop turns a single-kernel checker
into a launch storm or a sync per iteration, and a compiled or loaded
callable built per call pays its build per call. These hazards surface
only in a timed run on the card; statically they are visible in the
AST. The family is the counterpart of the reference's JAX family, rule
for rule:

- TORCH001 — a ``torch.*`` op (tensor ops, ``torch.nn.functional``,
  ``torch.linalg``) inside a Python ``for``/``while`` body: a launch
  per iteration. Not inside a ``with torch.cuda.graph(...)`` capture
  (replayed as one graph), not in a function handed to
  ``torch.cuda.make_graphed_callables``, and not in a kernel's plain
  version (``*_reference``, ``policy.PLAIN_VERSIONS``), which never
  runs on the main path when a card is present.
- TORCH002 — a device-to-host sync the AST can see, inside a loop:
  ``.item()``, ``.cpu()``, ``.to("cpu")``, ``torch.cuda.synchronize()``,
  a stream's or event's ``.synchronize()`` / ``.elapsed_time()``,
  ``.numpy()`` / ``.tolist()`` of a torch call, ``numpy.asarray`` /
  ``numpy.array`` of a torch call or ``.cpu()``; and ``.to(<device>)``
  of a freshly made host tensor (a transfer per iteration). Plain
  versions are exempt, as for TORCH001.
- TORCH003 — ``torch.compile``, ``torch.jit.script`` / ``trace``,
  ``torch.utils.cpp_extension.load`` / ``load_inline``, ``ctypes.CDLL``
  or ``torch.cuda.CUDAGraph()`` built inside a loop or per call in a
  function without ``lru_cache`` / ``cache``: the build (or capture)
  is paid every time; it belongs at module level or behind a cache.
- TORCH004 — explicit float64 in a ``torch`` call (``dtype=``),
  ``.double()`` or ``.to(torch.float64)``: the kernels here are
  int32/uint32 by design, and the card's float64 rate is a fraction of
  its float32 rate. ``numpy.float64`` on host arrays is fine.
"""

from __future__ import annotations

import ast
from typing import Iterator

FAMILY = "TORCH"

RULES = {
    "TORCH001": "torch op launched per iteration of a Python loop",
    "TORCH002": "device-to-host sync or transfer inside a Python loop",
    "TORCH003": "compiled/loaded/captured callable built per call",
    "TORCH004": "explicit float64 in a torch call",
}

#: torch origins that launch nothing: device and runtime queries,
#: streams and events, grad-mode switches, and the builders TORCH003
#: owns
_NO_LAUNCH_PREFIXES = ("torch.cuda.", "torch.backends.", "torch.utils.",
                       "torch.jit.", "torch.profiler.", "torch.autograd.",
                       "torch.distributed.", "torch.multiprocessing.")
_NO_LAUNCH = {"torch.device", "torch.dtype", "torch.is_tensor",
              "torch.no_grad", "torch.inference_mode", "torch.compile",
              "torch.get_num_threads", "torch.set_num_threads",
              "torch.Generator", "torch.iinfo", "torch.finfo",
              "torch.Size", "torch.manual_seed",
              "torch.from_numpy"}    # a zero-copy view of host memory
#: device-to-host syncs that are method calls with no arguments
_SYNC_METHODS = {"item", "cpu", "synchronize"}
_TENSOR_READS = {"numpy", "tolist"}
_HOST_ARRAY = {"numpy.asarray", "numpy.array"}
_HOST_TENSOR = {"torch.from_numpy", "torch.as_tensor", "torch.tensor"}
_BUILDERS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
             "torch.utils.cpp_extension.load",
             "torch.utils.cpp_extension.load_inline", "ctypes.CDLL",
             "torch.cuda.CUDAGraph"}
_CACHE_DECOS = {"lru_cache", "cache"}
_F64_NAMES = {"float64", "double"}


def _leaf(node: ast.Call):
    f = node.func
    return f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else None)


def _cache_decorated(fn: ast.AST) -> bool:
    for deco in getattr(fn, "decorator_list", ()):
        for n in ast.walk(deco):
            if (isinstance(n, ast.Name) and n.id in _CACHE_DECOS) or \
                    (isinstance(n, ast.Attribute) and
                     n.attr in _CACHE_DECOS):
                return True
    return False


def _launches(origin) -> bool:
    return origin is not None and origin.startswith("torch.") and \
        origin not in _NO_LAUNCH and \
        not origin.startswith(_NO_LAUNCH_PREFIXES)


def _holds_torch_call(module, node: ast.AST, cpu: bool = False) -> bool:
    """Does the subtree call a torch op (or, with ``cpu``, ``.cpu()``)?"""
    for n in ast.walk(node):
        if not isinstance(n, ast.Call):
            continue
        if _launches(module.origin(n.func)):
            return True
        if cpu and _leaf(n) == "cpu" and not n.args:
            return True
    return False


def _graph_capture(module, node: ast.AST) -> bool:
    """Does the node sit in a ``with torch.cuda.graph(...)`` body?"""
    cur = module.parent(node)
    while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
        if isinstance(cur, (ast.With, ast.AsyncWith)):
            for item in cur.items:
                ce = item.context_expr
                if isinstance(ce, ast.Call) and \
                        module.origin(ce.func) == "torch.cuda.graph":
                    return True
        cur = module.parent(cur)
    return False


def _graphed_names(module) -> set:
    """Names of functions captured into a CUDA graph: handed to
    ``torch.cuda.make_graphed_callables`` or called from a
    ``torch.cuda.graph`` capture, and (transitively) the bare names
    those call."""
    out: set = set()
    by_name: dict = {}
    for node in ast.walk(module.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(node.name, []).append(node)
        if isinstance(node, ast.Call) and module.origin(node.func) == \
                "torch.cuda.make_graphed_callables":
            for arg in list(node.args) + [k.value for k in node.keywords]:
                for n in ast.walk(arg):
                    if isinstance(n, ast.Name):
                        out.add(n.id)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and _graph_capture(module, node):
            out.add(node.func.id)
    frontier = list(out)
    while frontier:
        for d in by_name.get(frontier.pop(), ()):
            for n in ast.walk(d):
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                        and n.func.id not in out:
                    out.add(n.func.id)
                    frontier.append(n.func.id)
    return out


def _is_cpu(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


def _mentions_f64(module, node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and n.value == "float64":
            return True
        if isinstance(n, ast.Attribute) and n.attr in _F64_NAMES:
            origin = module.origin(n)
            # numpy.float64 on a host array is fine; torch's (or an
            # unresolvable root) is the device hazard
            if origin is None or origin.startswith("torch."):
                return True
        if isinstance(n, ast.Name) and n.id == "float":
            return True    # torch maps dtype=float to float64
    return False


def _sync(module, node: ast.Call, origin, leaf) -> bool:
    if origin == "torch.cuda.synchronize":
        return True
    if not isinstance(node.func, ast.Attribute) or origin is not None:
        return False
    recv = node.func.value
    if leaf in _SYNC_METHODS and not node.args and not node.keywords:
        return True
    if leaf == "elapsed_time":
        return True
    if leaf in _TENSOR_READS and not node.args:
        return _holds_torch_call(module, recv)
    if leaf == "to":
        # the first positional argument, unless it is a dtype
        dev = [a for a in node.args[:1] if not (
            isinstance(a, ast.Attribute) and
            (module.origin(a) or "").startswith("torch."))] + \
            [k.value for k in node.keywords if k.arg == "device"]
        if any(_is_cpu(d) for d in dev):
            return True
        # a host tensor made here and moved: a transfer per iteration
        return bool(dev) and isinstance(recv, ast.Call) and \
            module.origin(recv.func) in _HOST_TENSOR and \
            not any(k.arg == "device" for k in recv.keywords)
    return False


def check(module, ctx) -> Iterator:
    policy = ctx.policy
    graphed = _graphed_names(module)
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        origin = module.origin(node.func)
        leaf = _leaf(node)
        encl = module.enclosing_functions(node)
        in_loop = bool(module.enclosing_loops(node))
        plain = any(policy.plain_version(module.relpath, f.name)
                    for f in encl)

        # TORCH001: a launch per loop iteration
        if in_loop and not plain and _launches(origin) and \
                not _graph_capture(module, node) and \
                not any(f.name in graphed for f in encl):
            yield module.finding(
                "TORCH001", node,
                f"{origin}() launches a kernel per loop iteration; "
                "batch the loop into one op, capture it in a CUDA "
                "graph, or write it as one kernel")

        # TORCH002: a device-to-host sync (or transfer) per iteration
        if in_loop and not plain and (
                _sync(module, node, origin, leaf) or (
                    origin in _HOST_ARRAY and any(
                        _holds_torch_call(module, a, cpu=True)
                        for a in node.args))):
            yield module.finding(
                "TORCH002", node,
                "device-to-host sync or host-to-device transfer inside "
                "a Python loop waits on the card every iteration; "
                "hoist it out of the loop or batch the loop")

        # TORCH003: built per call / per iteration
        if origin in _BUILDERS and (in_loop or (
                encl and not any(_cache_decorated(f) for f in encl))):
            yield module.finding(
                "TORCH003", node,
                f"{origin}() builds per call; build it at module level "
                "or behind functools.lru_cache")

        # TORCH004: explicit float64
        if origin is not None and origin.startswith("torch."):
            for kw in node.keywords:
                if kw.arg == "dtype" and _mentions_f64(module, kw.value):
                    yield module.finding(
                        "TORCH004", node,
                        "explicit float64 in a torch call; the kernels "
                        "are int32/uint32 by design and the card's "
                        "float64 rate is a fraction of its float32 rate")
        if origin is None and isinstance(node.func, ast.Attribute) and (
                (leaf == "double" and not node.args) or
                (leaf == "to" and any(
                    _mentions_f64(module, a) for a in list(node.args) +
                    [k.value for k in node.keywords
                     if k.arg == "dtype"]))):
            yield module.finding(
                "TORCH004", node,
                f".{leaf}() to float64 on a tensor; the kernels are "
                "int32/uint32 by design")
