"""Rule registry: five families, each a module with ``FAMILY``,
``RULES`` (id -> one-line description) and ``check(module, ctx)``."""

from __future__ import annotations

from typing import Iterable, Optional

from . import col, det, tel, thr, torch_rules

FAMILIES = (det, col, torch_rules, thr, tel)

ALL_RULES = {rid: desc for fam in FAMILIES
             for rid, desc in fam.RULES.items()}


def select(rules: Optional[Iterable[str]] = None) -> list:
    """Rule-family modules matching the requested families/ids
    (None = all). Unknown selectors raise — a typo'd --rule must not
    silently lint nothing."""
    if not rules:
        return list(FAMILIES)
    want = {r.upper() for r in rules}
    unknown = {w for w in want
               if w not in ALL_RULES
               and w not in {f.FAMILY for f in FAMILIES}}
    if unknown:
        raise ValueError(f"unknown rules {sorted(unknown)}; known "
                         f"families {sorted(f.FAMILY for f in FAMILIES)}")
    return [f for f in FAMILIES
            if f.FAMILY in want or any(r in want for r in f.RULES)]
