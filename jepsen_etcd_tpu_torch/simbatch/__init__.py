"""simbatch: S seeds' discrete-event simulations in lockstep, histories
born as OpColumns (the port of the reference's ``simbatch/``).

Public surface:

- :func:`generate` / :func:`generate_for_opts` — run a seed batch,
  get back per-seed Histories (column-backed, zero conversion into the
  checker pipeline) plus genbatch stats. Epoch-v2 (``generate``) is
  numpy on the host; epoch-v3 (``generate_jax``) draws and drains on
  the device.
- :class:`BatchConfig` — the stable opts→sizing mapping golden hashes
  key on.
- :class:`BatchHeap` — the SoA event queue (tombstone cancels, batched
  same-instant drains, drain-order-neutral compaction).
- :func:`history_sha` — the golden-hash function (sha256 of the
  canonical jsonl serialization), test/bench use only: it materializes
  op dicts, which the hot paths never do.
"""

from __future__ import annotations

import hashlib

from .engine import (  # noqa: F401
    GEN_EPOCH_V1,
    GEN_EPOCH_V2,
    STRIDE,
    SUPPORTED_WORKLOADS,
    BatchConfig,
    default_schedule,
    generate,
    generate_for_opts,
    schedule_span,
    supports,
)
from .engine_v3 import (  # noqa: F401
    GEN_EPOCH_V3,
    default_schedule_jax,
    generate_jax,
)
from .heap import DONE, BatchHeap  # noqa: F401


def history_sha(history) -> str:
    """Golden hash of a history: sha256 over the canonical jsonl
    serialization (tests/bench only — materializes dicts)."""
    return hashlib.sha256(history.to_jsonl().encode()).hexdigest()
