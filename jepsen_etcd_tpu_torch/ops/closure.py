"""Transitive closure by boolean matrix squaring: the Elle cycle engine
(the port of the reference's ``ops/closure.py``, same names and return
contracts).

The Elle checkers find cycles in a transaction dependency graph. With
``R0 = A | I``, k squarings cover every path shorter than 2^k, so at
most ``ceil(log2 N)`` squarings reach the reflexive-transitive closure
R*. The nested anomaly subgraphs Elle distinguishes (ww ⊂ ww|wr ⊂
ww|wr|rw, each with and without realtime edges) close together as one
``[B, N, N]`` stack, one ``torch.bmm`` a squaring. A node lies on a
cycle iff some successor reaches back to it:
``on_cycle[i] = ∃j. A[i,j] ∧ R*[j,i]``.

On the card a squaring is a bf16 ``torch.bmm``; on the CPU (the plain
version the tests run) a float32 one. Either is exact for the only
question asked of it, whether an entry is positive (``_square``).
Sizes pad to bucketed powers of two, as in the reference, and round up
to a multiple of the lane count when the rows split over lanes
(``wgl_mxu.batch_lanes``: every visible card, or the one device named).

Routing is the reference's: below ``CPU_CUTOFF`` nodes the host numpy
squaring (``_closure_numpy``), at or above it the device; with more
than one lane and ``m >= SHARD_CUTOFF`` the rows split over the lanes.
The device is the caller's ``device`` (``cuda`` by default), and a card
that is asked for and missing raises: nothing falls back to the host.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..runner import telemetry
from . import wgl_mxu
from .common import bucket as _bucket, use_device

#: below this node count the host squaring runs, at or above it the
#: device. Copied from the reference (set there on a TPU) so that
#: routing and span labels match; chip_smoke.py prints the H100's
#: crossover, from which a later change may re-derive it
CPU_CUTOFF = 768
#: at/above this padded size, with more than one lane, split the rows
#: over the lanes
SHARD_CUTOFF = 1024

#: squarings launched on a CUDA device (torch.bmm calls), one per lane
#: per squaring; chip_smoke.py reads it around the Elle path
LAUNCHES = 0


def _square(rows: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """One squaring step of a row block: ``(rows @ r) > 0`` in r's
    dtype. On CUDA the operands are bf16 and ``torch.bmm`` returns bf16
    (cuBLAS accumulates in float32, and may reduce split sums in bf16).
    That is exact for the ``> 0`` test: every term is a non-negative
    path count of at most m, so no sum cancels, and a positive value
    never rounds to 0 in bf16 (the smallest positive sum is 1). On the
    CPU the operands are float32, whose integers are exact below 2^24.
    Do not use fp16 or int8 here without the same argument (fp16
    overflows to inf at 65,520 paths, int8 wraps)."""
    global LAUNCHES
    prod = torch.bmm(rows, r)
    if r.device.type == "cuda":
        LAUNCHES += 1
    return (prod > 0).to(r.dtype)


def _closure_device(a: torch.Tensor, iters: int,
                    lanes: Optional[list] = None):
    """a: [B, m, m] bool adjacency on ``lanes[0]`` (default: a's own
    device, one lane). Returns (reach [B, m, m] bool, the
    reflexive-transitive closure; on_cycle [B, m] bool; squarings run).

    Squaring stops at the first squaring that adds no reachable pair
    (R holds the identity, so R ⊆ R² and the count only grows), or
    after ``iters`` (ceil(log2 m), the worst case). The test needs the
    count on the host: one synchronization a squaring, at most
    ``iters``.

    With several lanes (the reference's row-sharded closure) the rows
    split evenly (m a multiple of the lane count): each lane squares its
    row block against the whole R, copied to its device; the blocks are
    gathered on ``lanes[0]`` before the next squaring, and the fixpoint
    test sums the lanes' counts."""
    lanes = lanes or [a.device]
    b, m, _ = a.shape
    if m % len(lanes):
        raise ValueError(f"m={m} does not split over {len(lanes)} lanes")
    step = m // len(lanes)
    dt = torch.bfloat16 if a.device.type == "cuda" else torch.float32
    r = (a | torch.eye(m, dtype=torch.bool, device=a.device)).to(dt)
    prev = int(torch.count_nonzero(r))
    squarings = 0
    while squarings < iters:
        blocks = []
        for i, dev in enumerate(lanes):
            rl = r.to(dev)
            blocks.append(_square(rl[:, i * step:(i + 1) * step], rl))
        # graftlint: ignore[TORCH001] fixpoint squaring: at most ceil(log2 m) rounds, each one squaring per lane and its fixpoint count
        cur = sum(int(torch.count_nonzero(blk)) for blk in blocks)
        # graftlint: ignore[TORCH001] fixpoint squaring: one gather of the lanes' blocks per round
        r = torch.cat([blk.to(a.device) for blk in blocks], dim=1)
        squarings += 1
        if cur == prev:   # fixpoint: the squaring added no pair
            break
        prev = cur
    reach = r > 0
    # A[i,j] & R*[j,i]: row-wise AND with the transpose, any over j
    on_cycle = (a & reach.transpose(-1, -2)).any(dim=-1)
    return reach, on_cycle, squarings


def _closure_from_edges(et_edges: list, lvl_mask: np.ndarray, m: int,
                        inv_v: np.ndarray, comp_v: np.ndarray, dev):
    """The [B, m, m] level stack built on ``dev`` from the typed edge
    lists and the realtime vectors (O(E + N) bytes copied, not the dense
    stack): plane b is the OR of the edge types t with lvl_mask[b, t]
    and, with lvl_mask[b, n_types], the realtime relation
    ``comp[i] < inv[j]`` (i != j), compared in float32 as the reference
    compares them (+inf pads rows past n). Edge lists carry only real
    nodes (< n <= m), so no index is ever out of range."""
    n_types = lvl_mask.shape[1] - 1
    et = torch.zeros((n_types, m, m), dtype=torch.bool, device=dev)
    typed = []
    for t, e in enumerate(et_edges):
        if len(e):
            ij = np.asarray(e, np.int64).reshape(-1, 2)
            typed.append(np.column_stack([np.full(len(ij), t, np.int64),
                                          ij]))
    if typed:   # every type's edges in one transfer
        idx = torch.from_numpy(np.concatenate(typed)).to(dev)
        et[idx[:, 0], idx[:, 1], idx[:, 2]] = True
    inv = torch.from_numpy(inv_v).to(dev)
    comp = torch.from_numpy(comp_v).to(dev)
    rt = (comp[:, None] < inv[None, :]) & \
        ~torch.eye(m, dtype=torch.bool, device=dev)
    planes = []
    for row in lvl_mask:
        # graftlint: ignore[TORCH001] one plane per Adya level: a handful, each ORed from the type planes on the card
        x = torch.zeros((m, m), dtype=torch.bool, device=dev)
        for t in range(n_types):
            if row[t]:
                x |= et[t]
        if row[n_types]:
            x |= rt
        planes.append(x)
    return torch.stack(planes)


class EdgeAccumulator:
    """Incremental typed-edge accumulation for the Elle dependency
    graph: ``add(t, i, j)`` appends into per-type growing int32 chunk
    buffers (amortized O(1), no Python set-of-tuples — the set was the
    memory floor on long streamed histories), and ``finalize()``
    returns per-type sorted-unique ``[E, 2]`` int32 arrays, row-for-row
    identical to ``np.array(sorted(set_of_pairs))`` — exactly the
    compact edge lists :func:`closure_levels_lazy` ships to the device.
    Feeding may resume after a finalize (the streaming/soak path
    accumulates edges chunk by chunk and snapshots between windows);
    finalize is cached until the next add."""

    CHUNK = 4096

    def __init__(self, n_types: int):
        self.n_types = n_types
        self._bufs: list[list] = [[] for _ in range(n_types)]
        self._fill = [0] * n_types
        self._final = None

    def add(self, t: int, i: int, j: int) -> None:
        if i == j:
            return
        bufs = self._bufs[t]
        f = self._fill[t]
        if not bufs or f == len(bufs[-1]):
            bufs.append(np.empty((self.CHUNK, 2), dtype=np.int32))
            f = 0
        cur = bufs[-1]
        cur[f, 0] = i
        cur[f, 1] = j
        self._fill[t] = f + 1
        self._final = None

    def __len__(self) -> int:
        """Raw (pre-dedup) edge count across all types."""
        return sum((len(b) - 1) * self.CHUNK + self._fill[t]
                   if (b := self._bufs[t]) else 0
                   for t in range(self.n_types))

    def finalize(self) -> list:
        if self._final is None:
            out = []
            for t in range(self.n_types):
                bufs = self._bufs[t]
                if not bufs:
                    out.append(np.zeros((0, 2), dtype=np.int32))
                    continue
                rows = np.concatenate(bufs[:-1]
                                      + [bufs[-1][:self._fill[t]]])
                out.append(np.unique(rows, axis=0))
            self._final = out
        return self._final


def _closure_numpy(a: np.ndarray) -> tuple:
    n = a.shape[-1]
    r = a | np.eye(n, dtype=bool)[None]
    iters = max(1, math.ceil(math.log2(max(2, n))))
    prev = int(r.sum())
    for _ in range(iters):
        # int32 accumulator: uint8 would wrap at 256 paths and silently
        # drop reachability (and so miss real cycles) on long histories
        r = np.matmul(r.astype(np.int32), r.astype(np.int32)) > 0
        cur = int(r.sum())
        if cur == prev:   # fixpoint: squaring added no pairs
            break
        prev = cur
    on_cycle = np.any(a & np.swapaxes(r, -1, -2), axis=-1)
    return r, on_cycle


def _geometry(n: int, device):
    """(lanes, m) of a device closure over n nodes: the lanes of
    ``wgl_mxu.batch_lanes(device)`` and the padded size, a bucketed
    power of two rounded up to a multiple of the lane count."""
    lanes = wgl_mxu.batch_lanes(device)
    m = _bucket(max(1, n))
    if m % len(lanes):  # the row axis must split evenly over the lanes
        m = ((m + len(lanes) - 1) // len(lanes)) * len(lanes)
    return lanes, m


def _lazy(reach: torch.Tensor, on_cycle: torch.Tensor, n: int):
    """(reach_fn, on_cycle numpy [B, n]) of a device closure: on_cycle
    comes back at once, reach only when reach_fn() is first called."""
    on_cycle = on_cycle[:, :n].cpu().numpy()
    cache: list = []

    def reach_fn():
        if not cache:
            cache.append(reach[:, :n, :n].cpu().numpy())
        return cache[0]

    return reach_fn, on_cycle


def closure_levels_lazy(et_edges: list, lvl_mask: np.ndarray, n: int,
                        rt_vecs, densify,
                        force_device: Optional[bool] = None, device=None):
    """closure_batch_lazy with COMPACT device inputs: per-type edge
    lists + the realtime (invoke, complete) vectors; the [B, N, N]
    level stack is built on the device (_closure_from_edges). densify()
    is only called on the host / row-split paths, which keep the dense
    pipeline. Same return contract as closure_batch_lazy."""
    b = lvl_mask.shape[0]
    if n == 0 or use_device(force_device, n, CPU_CUTOFF, device) is None:
        # host / empty: the dense pipeline handles these — one copy of
        # that routing lives in closure_batch_lazy
        return closure_batch_lazy(densify() if n else
                                  np.zeros((b, 0, 0), bool),
                                  force_device=force_device, device=device)
    lanes, m = _geometry(n, device)
    if len(lanes) > 1 and m >= SHARD_CUTOFF:
        return closure_batch_lazy(densify(), force_device=force_device,
                                  device=device)
    iters = max(1, math.ceil(math.log2(m)))
    inv_v = np.full(m, np.inf, dtype=np.float32)
    comp_v = np.full(m, np.inf, dtype=np.float32)
    if rt_vecs is not None:
        inv_v[:n] = rt_vecs[0]
        comp_v[:n] = rt_vecs[1]
    edges = sum(len(e) for e in et_edges)
    with telemetry.current().span("closure.device", n=n, b=b,
                                  compact=True, edges=edges):
        a = _closure_from_edges(et_edges, lvl_mask, m, inv_v, comp_v,
                                lanes[0])
        reach, on_cycle, _ = _closure_device(a, iters)
        return _lazy(reach, on_cycle, n)


def closure_batch_lazy(adj: np.ndarray, force_device: Optional[bool] = None,
                       device=None):
    """Close a [B, N, N] bool adjacency stack, deferring the reach
    transfer.

    Returns (reach_fn, on_cycle) where on_cycle is a numpy [B, N] bool
    and reach_fn() materializes the [B, N, N] closure on first call
    (cached). Cycle *detection* only needs on_cycle; the full reach
    matrix is consulted only for certificate recovery on INVALID
    histories — valid ones (the overwhelming case) skip the O(B*N^2)
    device->host transfer entirely.
    """
    adj = np.asarray(adj, dtype=bool)
    if adj.ndim == 2:
        adj = adj[None]
    b, n, _ = adj.shape
    if n == 0:
        empty = np.zeros((b, 0, 0), bool)
        return (lambda: empty), np.zeros((b, 0), bool)
    if use_device(force_device, n, CPU_CUTOFF, device) is None:
        with telemetry.current().span("closure.host", n=n, b=b):
            reach, on_cycle = _closure_numpy(adj)
        return (lambda: reach), on_cycle
    lanes, m = _geometry(n, device)
    sharded = len(lanes) > 1 and m >= SHARD_CUTOFF
    pad = np.zeros((b, m, m), dtype=bool)
    pad[:, :n, :n] = adj
    iters = max(1, math.ceil(math.log2(m)))
    with telemetry.current().span("closure.device", n=n, b=b,
                                  sharded=sharded):
        a = torch.from_numpy(pad).to(lanes[0])
        reach, on_cycle, _ = _closure_device(
            a, iters, lanes if sharded else None)
        return _lazy(reach, on_cycle, n)


def closure_batch(adj: np.ndarray, force_device: Optional[bool] = None,
                  device=None):
    """Close a [B, N, N] bool adjacency stack.

    Returns (reach [B, N, N], on_cycle [B, N]) as numpy bool arrays,
    trimmed back to the caller's N. Small problems run on the host
    (device dispatch would dominate); large ones pad to a bucketed size
    and square on the device. Prefer ``closure_batch_lazy`` when the
    reach matrix is only needed conditionally.
    """
    reach_fn, on_cycle = closure_batch_lazy(adj, force_device, device)
    return reach_fn(), on_cycle
