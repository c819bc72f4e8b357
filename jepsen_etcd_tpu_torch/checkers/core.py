"""The checker protocol (the ``Checker`` base of the reference's
``checkers/core.py``; the composite and stat checkers come later)."""

from __future__ import annotations

from typing import Any, Optional


class Checker:
    def check(self, test: Any, history, opts: Optional[dict] = None) -> dict:
        raise NotImplementedError
