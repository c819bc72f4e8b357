"""Client-side error classification: the with-errors seam.

Mirrors ``client.clj:388-399``: a definite error (or an indefinite error on
an idempotent op) fails the op (:fail — it certainly didn't happen / can't
matter); anything else is :info (unknown outcome, the op may have taken
effect). The error taxonomy itself lives in sut/errors.py, preserving the
reference's remap-errors keywords (client.clj:279-379).
"""

from __future__ import annotations

from typing import Awaitable, Callable, Iterable

from ..core.op import Op
from ..sut.errors import SimError
from ..runner.sim import Cancelled


def client_error(e: BaseException) -> bool:
    return isinstance(e, (SimError, TimeoutError))


async def with_errors(op: Op, idempotent: Iterable[str],
                      thunk: Callable[[], Awaitable[Op]]) -> Op:
    """Run thunk; convert known errors to :fail / :info completions."""
    try:
        return await thunk()
    except TimeoutError:
        e = SimError("timeout", "client timeout")
        t = "fail" if op.get("f") in idempotent else "info"
        return op.evolve(type=t, error=e.as_error_value())
    except SimError as e:
        t = "fail" if (e.definite or op.get("f") in idempotent) else "info"
        return op.evolve(type=t, error=e.as_error_value())
    except Cancelled:
        raise


def remap_etcd_message(msg: str):
    """etcd hides specific conditions under generic gRPC codes
    (client.clj:302-353); both live adapters must remap by message
    text FIRST, identically, or the same server fault would classify
    differently per --client-type. Returns a SimError or None."""
    low = msg.lower()
    if "leader changed" in low:
        return SimError("leader-changed", msg)
    if "raft: stopped" in low:
        return SimError("raft-stopped", msg)
    if "lease not found" in low:
        return SimError("lease-not-found", msg)
    if "compacted" in low:
        return SimError("compacted", msg)
    return None
