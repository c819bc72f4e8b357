"""BatchHeap: an SoA event queue with a leading seed axis (the port of
the reference's ``simbatch/heap.py``, copied).

The batched generator (engine.py) advances S independent discrete-event
simulations in lockstep; its event queue is therefore S priority queues
popped together, one numpy step per drain. Layout is
structure-of-arrays with the seed axis leading — ``time``/``ord``/
``kind``/``lane`` are ``(S, capacity)`` int arrays plus a tombstone
bitmap — so every queue operation is a handful of vectorized reductions
over the seed axis instead of S Python heap manipulations.

Ordering (the generator-epoch contract, documented next to the
epoch-v1 rule in runner/sim.py):

- epoch-v1: entries order by ``(time, seq)`` — same-instant entries
  drain in push order, exactly SimLoop's heap rule.
- epoch-v2: entries order by ``(time, lane, seq)`` — same-instant
  entries drain in ascending owning-lane order, push order only as the
  final tiebreak. This is the declared rule the per-seed golden hashes
  pin.

Tombstones mirror SimLoop.Timer.cancel: ``cancel`` marks matching live
entries dead in place (they keep their slot and are skipped by every
drain); ``compact`` squeezes them out when they pile up, and is
drain-order neutral (the compaction-parity unit test pins that).
Capacities grow geometrically on demand, so callers never size queues.
"""

from __future__ import annotations

import numpy as np

#: sentinel time for "free slot / no event"; all real event times are
#: far below it, so per-seed minima of full rows stay meaningful
DONE = np.int64(2) ** 62

EPOCH_V1 = "epoch-v1"
EPOCH_V2 = "epoch-v2"
#: device engine (engine_v3.py). Same ``(time, lane, seq)``
#: ordering rule as epoch-v2 — the drain order is materialized as one
#: argsort over lane-residue-unique times instead of popped
#: incrementally, identical by the unique-times argument above.
EPOCH_V3 = "epoch-v3"

#: lane id bit-position in the epoch-v2 ordinal; seq occupies the low
#: bits, so lanes must fit in the remaining headroom
_LANE_SHIFT = 40


class BatchHeap:
    """S seeds' event queues as one columnar structure.

    Every mutator takes ``(S,)`` column vectors (scalars broadcast) and
    an optional ``(S,)`` boolean mask selecting which seeds
    participate; every drain returns ``(S,)`` columns plus a validity
    mask. One entry per seed per call — the batched generator's natural
    cadence (each lockstep step pops one event per live seed and pushes
    that lane's next one).
    """

    def __init__(self, n_seeds: int, capacity: int = 8,
                 epoch: str = EPOCH_V2, auto_compact: int = 16,
                 unique_times: bool = False):
        if epoch not in (EPOCH_V1, EPOCH_V2, EPOCH_V3):
            raise ValueError(f"unknown generator epoch {epoch!r}")
        self.S = int(n_seeds)
        self.capacity = max(2, int(capacity))
        self.epoch = epoch
        #: caller guarantees no two live entries of one seed ever share
        #: a time (the engine's lane-residue encoding). The epoch
        #: ordering rule then never has to arbitrate, so pops skip the
        #: ordinal tie-break and slot-pushes skip ordinal bookkeeping —
        #: results are identical by construction, just cheaper.
        self.unique_times = bool(unique_times)
        #: tombstone count per seed that triggers an automatic compact
        #: on the next push (parity-tested; tests pin it low to force
        #: compaction traffic)
        self.auto_compact = int(auto_compact)
        self.time = np.full((self.S, self.capacity), DONE, np.int64)
        self.ordv = np.full((self.S, self.capacity), DONE, np.int64)
        self.kind = np.zeros((self.S, self.capacity), np.int64)
        self.lane = np.zeros((self.S, self.capacity), np.int64)
        self.dead = np.zeros((self.S, self.capacity), bool)
        self.live = np.zeros(self.S, np.int64)
        self.n_dead = np.zeros(self.S, np.int64)
        self.seq = np.zeros(self.S, np.int64)
        self.compactions = 0
        self._rows = np.arange(self.S)
        self._any_dead = False

    # -- internals -----------------------------------------------------------
    def _ord(self, lanes: np.ndarray) -> np.ndarray:
        if self.epoch == EPOCH_V2:
            return (lanes.astype(np.int64) << _LANE_SHIFT) | self.seq
        return self.seq.copy()

    def _eff_time(self) -> np.ndarray:
        """Per-slot times with tombstones masked out of every drain."""
        if not self._any_dead:
            return self.time
        return np.where(self.dead, DONE, self.time)

    def _grow(self) -> None:
        cap2 = self.capacity * 2
        for name in ("time", "ordv", "kind", "lane", "dead"):
            old = getattr(self, name)
            fill = DONE if name in ("time", "ordv") else 0
            new = np.full((self.S, cap2), fill, old.dtype)
            new[:, :self.capacity] = old
            setattr(self, name, new)
        self.capacity = cap2

    # -- mutators ------------------------------------------------------------
    def push(self, times, lanes, kinds, mask=None) -> None:
        """Insert one entry per selected seed."""
        times = np.broadcast_to(np.asarray(times, np.int64), (self.S,))
        lanes = np.broadcast_to(np.asarray(lanes, np.int64), (self.S,))
        kinds = np.broadcast_to(np.asarray(kinds, np.int64), (self.S,))
        if mask is None:
            mask = np.ones(self.S, bool)
        if not mask.any():
            return
        if int(self.n_dead.max()) >= self.auto_compact:
            self.compact()
        free = (self.time == DONE) & ~self.dead
        if ((free.sum(axis=1) == 0) & mask).any():
            if int(self.n_dead.max()) > 0:
                self.compact()
                free = (self.time == DONE) & ~self.dead
            if ((free.sum(axis=1) == 0) & mask).any():
                self._grow()
                free = (self.time == DONE) & ~self.dead
        slot = free.argmax(axis=1)
        ordv = self._ord(lanes)
        rows = self._rows[mask]
        sl = slot[mask]
        self.time[rows, sl] = times[mask]
        self.ordv[rows, sl] = ordv[mask]
        self.kind[rows, sl] = kinds[mask]
        self.lane[rows, sl] = lanes[mask]
        self.live += mask
        self.seq += mask

    def push_slots(self, times, lanes, kinds, mask) -> None:
        """Slot-addressed fast-path push: the entry for lane ``l`` goes
        to slot ``l`` directly. Sound ONLY under the lockstep
        generator's cadence — each lane owns at most one live entry at
        a time, so slot=lane is a free-slot assignment by construction
        (capacity must exceed the highest lane id, and the lane's slot
        must not hold a tombstone). Ordering semantics are identical to
        :meth:`push`: slots never influence drain order (pop resolves
        ties by the epoch ordinal alone), and the per-seed ``seq``
        counter advances exactly as a general push would, so histories
        are bit-identical across the two paths. Under ``unique_times``
        the ordinal is provably never consulted and its bookkeeping is
        skipped. All four operands must be ``(S,)`` arrays."""
        rows = self._rows[mask]
        sl = lanes[mask]
        self.time[rows, sl] = times[mask]
        self.kind[rows, sl] = kinds[mask]
        self.lane[rows, sl] = lanes[mask]
        self.live += mask
        if not self.unique_times:
            self.ordv[rows, sl] = self._ord(lanes)[mask]
            self.seq += mask

    def cancel(self, lanes, mask=None, kind=None) -> None:
        """Tombstone every live entry owned by the given lane (and
        kind, when given), per selected seed — SimLoop's Timer.cancel
        analog: the entry keeps its slot, drains skip it, compaction
        reclaims it."""
        lanes = np.broadcast_to(np.asarray(lanes, np.int64), (self.S,))
        m = (self.lane == lanes[:, None]) & (self.time != DONE) \
            & ~self.dead
        if kind is not None:
            m &= self.kind == kind
        if mask is not None:
            m &= mask[:, None]
        n = m.sum(axis=1)
        self.dead |= m
        self.n_dead += n
        self.live -= n
        self._any_dead = self._any_dead or bool(n.any())

    def compact(self) -> None:
        """Squeeze tombstones out, preserving live-entry slot order
        (stable), so drain order is unchanged by construction."""
        if not self.n_dead.any():
            return
        livem = (self.time != DONE) & ~self.dead
        order = np.argsort(~livem, axis=1, kind="stable")
        t = np.where(livem, self.time, DONE)
        o = np.where(livem, self.ordv, DONE)
        self.time = np.take_along_axis(t, order, axis=1)
        self.ordv = np.take_along_axis(o, order, axis=1)
        self.kind = np.take_along_axis(self.kind, order, axis=1)
        self.lane = np.take_along_axis(self.lane, order, axis=1)
        self.dead = np.zeros((self.S, self.capacity), bool)
        self.n_dead[:] = 0
        self._any_dead = False
        self.compactions += 1

    # -- drains --------------------------------------------------------------
    def peek_time(self) -> np.ndarray:
        """Per-seed minimum live event time (DONE where empty)."""
        return self._eff_time().min(axis=1)

    def pop_min(self):
        """Pop the per-seed minimum entry under the epoch's ordering.

        Returns ``(time, kind, lane, has)`` — ``(S,)`` columns plus the
        validity mask (False rows carry garbage)."""
        eff = self._eff_time()
        rows = self._rows
        if self.unique_times:
            # no ties by caller contract: argmin of time IS the epoch
            # order; a DONE re-write on empty rows is a no-op
            slot = eff.argmin(axis=1)
            tmin = eff[rows, slot]
            has = tmin != DONE
            kind = self.kind[rows, slot]
            lane = self.lane[rows, slot]
            self.time[rows, slot] = DONE
            self.live -= has
            return tmin, kind, lane, has
        tmin = eff.min(axis=1)
        has = tmin < DONE
        o = np.where(eff == tmin[:, None], self.ordv, DONE)
        slot = o.argmin(axis=1)
        kind = self.kind[rows, slot]
        lane = self.lane[rows, slot]
        r = rows[has]
        s = slot[has]
        self.time[r, s] = DONE
        self.ordv[r, s] = DONE
        self.live -= has
        return tmin, kind, lane, has

    def pop_same_instant(self):
        """Batched same-instant drain: pop EVERY entry at the per-seed
        minimum time, ordered along axis 1 by the epoch's rule.

        Returns ``(time, kinds, lanes, count)`` with kinds/lanes shaped
        ``(S, m)`` (m = widest batch; rows padded past ``count``)."""
        eff = self._eff_time()
        tmin = eff.min(axis=1)
        due = (eff == tmin[:, None]) & (tmin[:, None] < DONE)
        count = due.sum(axis=1)
        m = int(count.max()) if len(count) else 0
        o = np.where(due, self.ordv, DONE)
        order = np.argsort(o, axis=1, kind="stable")
        kinds = np.take_along_axis(self.kind, order, axis=1)[:, :m]
        lanes = np.take_along_axis(self.lane, order, axis=1)[:, :m]
        self.time[due] = DONE
        self.ordv[due] = DONE
        self.live -= count
        return tmin, kinds, lanes, count

    # -- introspection -------------------------------------------------------
    def size(self) -> np.ndarray:
        return self.live.copy()

    def __repr__(self) -> str:
        return (f"<BatchHeap {self.S} seeds cap={self.capacity} "
                f"epoch={self.epoch} live={self.live.tolist()}>")
