"""Value encodings shared by the packer and the native oracle, and the
size routing of the device ops (a copy of the reference's
``ops/common.py`` minus its jax compile-cache hooks)."""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..device import resolve_device


class UnsupportedValue(Exception):
    """An op value the dense encodings can't represent faithfully;
    callers fall back to the Python oracle."""


_LIST, _TUPLE, _DICT, _SET = object(), object(), object(), object()


def _canon(v):
    """Hashable canonical form preserving Python == semantics (and the
    list/tuple/dict/set type distinctions the sequential models' ==
    sees). Unordered containers canonicalize to frozensets so == dicts
    (e.g. {True: 'x'} == {1: 'x'}) share a form regardless of order."""
    if isinstance(v, list):
        return (_LIST,) + tuple(_canon(x) for x in v)
    if isinstance(v, tuple):
        return (_TUPLE,) + tuple(_canon(x) for x in v)
    if isinstance(v, dict):
        return (_DICT, frozenset((k, _canon(x)) for k, x in v.items()))
    if isinstance(v, (set, frozenset)):
        return (_SET, frozenset(v))
    return v


class ValueIds:
    """Dense int ids for op values with id-equality iff value-equality
    under Python == — the comparison the sequential models use — so the
    packed encodings (device kernel, native oracle) can never disagree
    with the Python reference about whether two observed values match
    (1 == 1.0 == True share an id; '1' does not). None is id 0."""

    def __init__(self):
        self._map: dict = {}
        self.rev: dict = {0: None}

    def id(self, v) -> int:
        if v is None:
            return 0
        c = _canon(v)
        try:
            got = self._map.get(c)
        except TypeError as e:  # unhashable leaf (e.g. a set)
            raise UnsupportedValue(repr(v)) from e
        if got is None:
            got = len(self._map) + 1
            self._map[c] = got
            self.rev[got] = v
        return got


def register_value_sets(triples):
    """Classify register-language value ids over (f, a1, a2) triples
    (f: 0 read / 1 write / 2 cas; a1: read-expected|write-payload|
    cas-old; a2: cas-new; WILDCARD = -1 read asserts nothing).

    Returns (asserted, producible):
    - asserted: ids some step COMPARES against the register state
      (read expectations, cas olds);
    - producible: ids some step can MAKE the state (write payloads,
      cas news), plus 0 (the initial None).

    A producible id that is never asserted is a *dead value*: no guard
    distinguishes it from any other dead value, so all dead values can
    merge into one id without changing any verdict. And a cas whose old
    id is neither producible nor 0 can never fire."""
    asserted = set()
    producible = {0}
    for f, a1, a2 in triples:
        if f == 0:
            if a1 != -1:
                asserted.add(a1)
        elif f == 1:
            producible.add(a1)
        else:
            asserted.add(a1)
            producible.add(a2)
    return asserted, producible


def as_version(v) -> int:
    """An etcd version assertion as int, faithful to == against int
    model versions; raises UnsupportedValue for anything whose equality
    an int can't carry (non-integral or non-numeric)."""
    if isinstance(v, bool) or isinstance(v, int):
        iv = int(v)
    elif isinstance(v, float) and v.is_integer():
        iv = int(v)
    else:
        raise UnsupportedValue(f"version assertion {v!r}")
    if not -(2 ** 29) < iv < 2 ** 29:
        raise UnsupportedValue(f"version assertion {v!r} out of range")
    return iv


def bucket(n: int, minimum: int = 128) -> int:
    """Pad to the next power of two (min `minimum`)."""
    return max(minimum, 1 << max(0, math.ceil(math.log2(max(1, n)))))


def use_device(force_device: Optional[bool], n: int, cutoff: int,
               device=None) -> Optional[torch.device]:
    """Resolve the force_device tri-state against size: the device to
    run on, or None for the host path. True demands the device, False
    forces the host path, None picks the device when ``n >= cutoff``.
    The device is ``resolve_device(device)``, so a card that is asked
    for and missing raises."""
    if force_device is False or (not force_device and n < cutoff):
        return None
    return resolve_device(device)
