"""ctypes driver for the native WGL oracle (wgl_oracle.cpp).

A copy of the reference's ``native/oracle.py`` over the port's own copy
of ``wgl_oracle.cpp``. The C++ core is the CPU engine for
linearizability checks — the role Knossos' JVM search plays in the
reference (register.clj:110-112, lock.clj:244). It speaks the same
register language as the device kernel (ops/wgl.py): models expressible
as (versioned) CAS registers — VersionedRegister natively, Mutex and
CASRegister through adapters — run native; anything else returns None
and the caller uses the Python DFS (checkers/linearizable.py), which
stays the semantic reference.

Build: compiled on demand with g++ into ``_build/`` keyed by source
hash; a failed build disables the native path for the process (the
Python oracle is always available). Set JEPSEN_ETCD_TPU_NO_NATIVE=1 to
disable explicitly.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Any, Optional

import numpy as np

from ..ops.common import UnsupportedValue, ValueIds, as_version
from ..ops.wgl import (CAS, NO_ASSERT, NONE_VAL, READ, WILDCARD,
                       WRITE)

logger = logging.getLogger("jepsen_etcd_tpu_torch.native")

INF = float("inf")

_lock = threading.Lock()
_lib: Any = None
_lib_tried = False


def _build_lib() -> Optional[ctypes.CDLL]:
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "wgl_oracle.cpp")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    build_dir = os.path.join(here, "_build")
    so = os.path.join(build_dir, f"wgl_oracle_{digest}.so")
    if not os.path.exists(so):
        os.makedirs(build_dir, exist_ok=True)
        tmp = so + f".tmp{os.getpid()}"
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", src,
               "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True,
                           timeout=120)
            os.replace(tmp, so)
        except Exception as e:
            logger.warning("native oracle build failed (%r); "
                           "using the Python oracle", e)
            return None
    # graftlint: ignore[TORCH003] built once per process: get_lib memoizes it under its lock
    lib = ctypes.CDLL(so)
    fn = lib.wgl_oracle_check
    fn.restype = ctypes.c_int32
    fn.argtypes = [
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if os.environ.get("JEPSEN_ETCD_TPU_NO_NATIVE"):
        return None
    with _lock:
        if not _lib_tried:
            _lib_tried = True
            _lib = _build_lib()
        return _lib


def _register_language(model) -> Optional[Any]:
    """An adapter mapping each entry's (f, value) into the register
    language ``(f, [version_assert, payload])``, or None when the model
    has no register expression (caller uses the Python DFS)."""
    from ..models import VersionedRegister, Mutex, CASRegister
    from ..ops.wgl import mutex_adapter

    if isinstance(model, VersionedRegister):
        if model.version != 0 or model.value is not None:
            return None
        return lambda f, v: (f, v) if f in ("read", "write", "cas") else None
    if isinstance(model, Mutex):
        return None if model.locked else mutex_adapter
    if isinstance(model, CASRegister):
        if model.value is not None:
            return None

        def adapt(f, v):
            if f == "read":
                return "read", [None, v]
            if f == "write":
                return "write", [None, v]
            if f == "cas":
                return "cas", [None, tuple(v)]
            return None

        return adapt
    return None


def check_entries(model, entries, max_configs: int = 5_000_000
                  ) -> Optional[dict]:
    """Run the native search over history entries. Returns the checker
    result dict, or None when the native path is unavailable or the
    history doesn't fit the register language."""
    lib = get_lib()
    if lib is None:
        return None
    adapter = _register_language(model)
    if adapter is None:
        return None

    n_all = len(entries)
    vids = ValueIds()
    val_id = vids.id

    required_rets = sorted(e.ret for e in entries if e.required)
    R = len(required_rets)
    if R == 0:
        return {"valid?": True, "configs": 0, "ops": n_all,
                "checker-impl": "native"}

    kept = []       # (entry, f_code, a1, a2, ver)
    for e in entries:
        try:
            m = adapter(e.f, e.value)
        except (TypeError, ValueError):
            return None
        if m is None:
            return None
        ef, ev = m
        if not e.required:
            if ef == "read":
                continue  # info reads can never change a verdict
            # info ops invoked after every required return can only
            # linearize after acceptance — droppable
            lo = 0
            hi = R
            while lo < hi:
                mid = (lo + hi) // 2
                if required_rets[mid] < e.invoke:
                    lo = mid + 1
                else:
                    hi = mid
            if lo >= R:
                continue
        ev = ev if ev is not None else (None, None)
        try:
            vassert, payload = ev
            ver_c = NO_ASSERT if vassert is None else as_version(vassert)
            if ef == "read":
                a1 = WILDCARD if payload is None else val_id(payload)
                kept.append((e, READ, a1, 0, ver_c))
            elif ef == "write":
                kept.append((e, WRITE, val_id(payload), 0, ver_c))
            elif ef == "cas":
                if not isinstance(payload, (list, tuple)) \
                        or len(payload) != 2:
                    return None
                old, new = payload
                kept.append((e, CAS, val_id(old), val_id(new), ver_c))
            else:
                return None
        except (TypeError, ValueError, UnsupportedValue):
            # malformed or semantically un-encodable value: the Python
            # DFS (the semantic reference) handles it
            return None

    # value-space reductions (ops/common.register_value_sets): merge
    # dead values into one id; drop info cas with unproducible olds —
    # the same collapse the kernel pack applies, equally sound here
    # (the C++ search honors the full semantics, this just shrinks the
    # reachable state space from 2^I to per-class counts)
    from ..ops.common import register_value_sets
    asserted, producible = register_value_sets(
        (kf, ka1, ka2) for (_e, kf, ka1, ka2, _v) in kept)
    dead = producible - asserted - {NONE_VAL}
    if len(dead) > 1:
        dead_id = min(dead)

        def remap(kf, ka1, ka2):
            if kf == WRITE and ka1 in dead:
                return kf, dead_id, ka2
            if kf == CAS and ka2 in dead:
                return kf, ka1, dead_id
            return kf, ka1, ka2

        kept = [(e, *remap(kf, ka1, ka2), kv)
                for (e, kf, ka1, ka2, kv) in kept]
    kept = [(e, kf, ka1, ka2, kv) for (e, kf, ka1, ka2, kv) in kept
            if e.required or not (kf == CAS and ka1 != NONE_VAL
                                  and ka1 not in producible)]

    n = len(kept)
    f = np.array([k[1] for k in kept], dtype=np.int8)
    a1 = np.array([k[2] for k in kept], dtype=np.int32)
    a2 = np.array([k[3] for k in kept], dtype=np.int32)
    ver = np.array([k[4] for k in kept], dtype=np.int32)
    inv = np.array([k[0].invoke for k in kept], dtype=np.int64)
    ret = np.array([np.iinfo(np.int64).max if k[0].ret == INF
                    else int(k[0].ret) for k in kept], dtype=np.int64)
    req = np.array([1 if k[0].required else 0 for k in kept],
                   dtype=np.uint8)
    # canonical firing order for interchangeable info ops: identical
    # (f, a1, a2, ver) info updates chained by (invoke, index) — a
    # lower-invoke member is enabled whenever a higher one is, so any
    # linearization rewrites to fire the chain in order.
    sym_pred = np.full(n, -1, dtype=np.int32)
    chains: dict = {}
    order = sorted(range(n), key=lambda j: (int(inv[j]), j))
    for j in order:
        if req[j]:
            continue
        key = (int(f[j]), int(a1[j]), int(a2[j]), int(ver[j]))
        if key in chains:
            sym_pred[j] = chains[key]
        chains[key] = j

    configs = ctypes.c_int64(0)
    blocked_op = ctypes.c_int32(-1)
    best_depth = ctypes.c_int32(-1)
    b_version = ctypes.c_int32(0)
    b_value = ctypes.c_int32(0)
    rc = lib.wgl_oracle_check(
        np.int32(n), f, a1, a2, ver, inv, ret, req, sym_pred,
        np.int64(max_configs), ctypes.byref(configs),
        ctypes.byref(blocked_op), ctypes.byref(best_depth),
        ctypes.byref(b_version), ctypes.byref(b_value))

    out = {"configs": int(configs.value), "ops": n_all,
           "checker-impl": "native"}
    if rc == 2:
        out["valid?"] = "unknown"
        out["error"] = "search budget exceeded"
        return out
    if rc == 1:
        out["valid?"] = True
        out["final-model"] = repr(_model_at(model, int(b_version.value),
                                            vids.rev.get(int(b_value.value))))
        return out
    out["valid?"] = False
    if blocked_op.value >= 0:
        e = kept[int(blocked_op.value)][0]
        out["op"] = dict(e.op)
        out["max-linearized"] = int(best_depth.value)
        state = _model_at(model, int(b_version.value),
                          vids.rev.get(int(b_value.value)))
        from ..models.base import Inconsistent
        nxt = state.step(e)
        out["error"] = (nxt.msg if isinstance(nxt, Inconsistent)
                        else "blocked")
    return out


def _model_at(model, version: int, value):
    """Reconstruct a model instance from the register-language state."""
    from ..models import VersionedRegister, Mutex, CASRegister
    from ..ops.wgl import MUTEX_LOCKED
    if isinstance(model, VersionedRegister):
        return VersionedRegister(version, value)
    if isinstance(model, Mutex):
        return Mutex(value == MUTEX_LOCKED)
    return CASRegister(value)
