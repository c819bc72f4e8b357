"""Network-event trace recorder (the ``--tcpdump`` analog).

The reference captures client-port pcaps per node (db.clj:276-277);
in the simulated net the equivalent is a message-level event log:
client->node RPCs and node->node replication/vote traffic, each with
virtual timestamps and payload summaries, written to
``store/<run>/trace.jsonl``.

Events STREAM to the file as they happen (small write-behind buffer,
flushed every ``FLUSH_EVERY`` events and at close) instead of
accumulating up to ``max_events`` dicts in memory — a long faulted run
records millions of replication heartbeats, and the old in-memory list
was hundreds of MB of host RAM held until teardown. Per-kind counts and
the dropped total accumulate incrementally and surface in the run's
``results.json`` (``net-trace``) and on the serve run page.
"""

from __future__ import annotations

import json
from typing import Any, Optional

#: events buffered between file writes; small enough that a crashed
#: run loses at most this many tail events
FLUSH_EVERY = 2048


class NetTrace:
    """Append-only message trace; one dict per event.

    With ``path`` set, events stream to that file and are not retained
    in memory. Without a path (unit-test / REPL use), events collect in
    ``self.events`` and ``to_jsonl()`` renders them, as before.
    """

    def __init__(self, loop, max_events: int = 2_000_000,
                 path: Optional[str] = None):
        self.loop = loop
        self.path = path
        self.events: list[dict] = []
        self.n = 0
        self.dropped = 0
        self.max_events = max_events
        self.by_kind: dict[str, int] = {}
        self._buf: list[str] = []
        self._fh = None
        self._closed = False

    def record(self, kind: str, src: str, dst: str, **info: Any) -> None:
        if self.n >= self.max_events:
            self.dropped += 1
            return
        e = {"t": self.loop.now, "kind": kind, "src": src, "dst": dst,
             **info}
        self.n += 1
        self.by_kind[kind] = self.by_kind.get(kind, 0) + 1
        if self.path is None:
            self.events.append(e)
            return
        self._buf.append(json.dumps(e, default=repr))
        if len(self._buf) >= FLUSH_EVERY:
            self._flush()

    def _flush(self) -> None:
        if not self._buf:
            return
        if self._fh is None:
            self._fh = open(self.path, "w")
        self._fh.write("\n".join(self._buf) + "\n")
        self._buf.clear()

    def counts(self) -> dict:
        return dict(self.by_kind)

    def summary(self) -> dict:
        """The results.json / serve surface: totals, dropped, per-kind."""
        return {"events": self.n, "dropped": self.dropped,
                "counts": dict(sorted(self.by_kind.items()))}

    def close(self) -> None:
        """Flush the stream (appending the truncation marker the old
        format carried when events were dropped). Idempotent; a no-op
        for in-memory traces."""
        if self._closed or self.path is None:
            return
        self._closed = True
        if self.dropped:
            self._buf.append(json.dumps({"truncated": self.dropped}))
        self._flush()
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def to_jsonl(self) -> str:
        lines = [json.dumps(e, default=repr) for e in self.events]
        if self.dropped:
            lines.append(json.dumps({"truncated": self.dropped}))
        return "\n".join(lines)
