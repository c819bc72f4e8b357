"""Byte-level WAL and snapshot model for corruption faults.

The reference's corruption nemesis bitflips or truncates real etcd WAL/snap
files on disk (``nemesis.clj:145-198``), and etcd reacts by panicking on
CRC mismatch at replay. Our simulated nodes keep a ``RecordFile`` per
"file": records live as Python objects until a corruption fault touches
the file, at which point the framed per-record-CRC byte buffer is
materialized and becomes authoritative, so the same fault surface exists:
flipping a bit corrupts exactly one record's CRC; truncating drops tail
records; replay stops at the first bad record (etcd WAL semantics) or —
if a *committed* record is damaged — the node refuses to start with a
panic in its log (cf. the log-file-pattern crash checker,
etcd.clj:134-140). Lazy materialization matters because value-carrying
records made per-append pickling O(history²) on append-heavy workloads;
the reference pays that encoding cost for real, to real disks, while the
sim only needs the bytes when a fault inspects them.
"""

from __future__ import annotations

import dataclasses
import io
import itertools
import math
import pickle
import struct
import sys
import zlib
from typing import Any, Optional


MAGIC = b"WALR"

#: The simulated files' bytes are the reference's, byte for byte: a
#: record pickles this package's classes under the reference's module
#: paths (``jepsen_etcd_tpu.sut.cluster``, ...) and reads those paths
#: back as this package's. A record's length, and so where a seeded
#: bitflip lands and what replay keeps, is then the reference's, and a
#: run under corruption faults records the reference's history. This
#: exists only for that parity: nothing but the bitflip faults reads the
#: bytes, and without the reference the records can pickle plainly again.
_PKG = __name__.partition(".")[0]
_REF_PKG = "jepsen_etcd_tpu"


class _RecordPickler(pickle._Pickler):
    """The pure-Python pickler, whose ``save_global`` can be replaced,
    writing this package's classes under the reference's paths. The C
    pickler cannot do it: its ``save_global`` takes the module from the
    class's ``__module__`` and imports it to check the class, and a
    ``reducer_override`` that names the class another way writes other
    opcodes, so other bytes."""

    def save_global(self, obj, name=None):
        module = getattr(obj, "__module__", None) or ""
        if module.partition(".")[0] != _PKG:
            return super().save_global(obj, name)
        # interned: one string object a module, so the memo (keyed by
        # object) writes each module's name once a record, as the C
        # pickler does
        self.save(sys.intern(_REF_PKG + module[len(_PKG):]))
        self.save(name or obj.__qualname__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _RecordUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.partition(".")[0] == _REF_PKG:
            module = _PKG + module[len(_REF_PKG):]
        return super().find_class(module, name)


def _dumps(item: Any) -> bytes:
    buf = io.BytesIO()
    _RecordPickler(buf, protocol=4).dump(item)
    return buf.getvalue()


def _loads(payload: bytes) -> Any:
    return _RecordUnpickler(io.BytesIO(payload)).load()


def encode_records(items: list[Any]) -> bytes:
    """Encode items as length+crc framed records."""
    out = bytearray()
    for item in items:
        payload = _dumps(item)
        crc = zlib.crc32(payload)
        out += MAGIC + struct.pack("<II", len(payload), crc) + payload
    return bytes(out)


def record_bytes(item: Any) -> bytes:
    """One framed record (MAGIC + length + crc + pickled payload)."""
    payload = _dumps(item)
    crc = zlib.crc32(payload)
    return MAGIC + struct.pack("<II", len(payload), crc) + payload


def decode_records(buf: bytes) -> tuple[list[Any], Optional[str]]:
    """Decode records until the first damaged one.

    Returns (items, error) where error is None for a clean read,
    "crc-mismatch" for a corrupted record, "torn-record" for a truncated
    tail (etcd tolerates a torn final record: it was mid-write at crash).
    """
    items: list[Any] = []
    at = 0
    n = len(buf)
    while at < n:
        if at + 12 > n:
            return items, "torn-record"
        if buf[at:at + 4] != MAGIC:
            return items, "crc-mismatch"
        ln, crc = struct.unpack("<II", buf[at + 4:at + 12])
        if at + 12 + ln > n:
            return items, "torn-record"
        payload = buf[at + 12:at + 12 + ln]
        if zlib.crc32(payload) != crc:
            return items, "crc-mismatch"
        try:
            items.append(_loads(payload))
        except Exception:
            return items, "crc-mismatch"
        at += 12 + ln
    return items, None


#: walk one appended record's payload in every EST_SAMPLE for the
#: db-size estimate; the rest extrapolate from the running mean
EST_SAMPLE = 16


def _est_size(x: Any, _depth: int = 0) -> int:
    """Cheap framed-record size estimate for OBJ-mode files (db-size
    stat only). Big homogeneous containers are sampled, not walked, so
    the estimate is O(1) per value instead of O(len) — an append-heavy
    run must not pay per-element costs for an informational stat."""
    if isinstance(x, (int, float, bool)) or x is None:
        return 9
    if isinstance(x, (str, bytes)):
        return 10 + len(x)
    if isinstance(x, (list, tuple, set, frozenset)):
        n = len(x)
        if _depth > 4 or n == 0:
            return 10 + 9 * n
        xs = list(x) if isinstance(x, (set, frozenset)) else x
        if n > 64:
            per = sum(_est_size(v, _depth + 1) for v in xs[:16]) / 16.0
            return 10 + int(per * n)
        return 10 + sum(_est_size(v, _depth + 1) for v in xs)
    if isinstance(x, dict):
        n = len(x)
        if _depth > 4 or n == 0:
            return 16 + 18 * n
        if n > 32:
            per = sum(_est_size(k, _depth + 1) + _est_size(v, _depth + 1)
                      for k, v in itertools.islice(x.items(), 16)) / 16.0
            return 16 + int(per * n)
        return 16 + sum(_est_size(k, _depth + 1) + _est_size(v, _depth + 1)
                        for k, v in x.items())
    if hasattr(x, "est_size"):
        return x.est_size()     # e.g. the Store inside a snapshot record
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        # e.g. the Txn payload of a WAL record — its compare/success/
        # failure tuples carry the (possibly large) values
        return 32 + sum(_est_size(getattr(x, f.name), _depth + 1)
                        for f in dataclasses.fields(x))
    return 48


class RecordFile:
    """A simulated on-disk record file with lazy byte materialization.

    Two modes:

    - **OBJ mode** (default): records live as Python objects; the
      durable view is a second list. Appends, fsyncs, replay, and
      unfsynced-loss are all object operations — no pickling. This is
      the fast path for every run that never corrupts the file, and it
      removes the O(history²) byte-encoding cost of value-carrying
      records (the reference pays that cost for real, to real disks;
      the sim only needs bytes when a fault inspects them).
    - **BYTES mode**: entered when a corruption fault touches the raw
      bytes (``corrupt``). The framed CRC buffer from ``encode_records``
      becomes authoritative for both views and replay decodes it, so
      the reference's fault surface (nemesis.clj:145-198 — bitflips
      break one record's CRC, truncation drops tail records) is
      byte-exact. ``set_records`` / ``clear`` return to OBJ mode (etcd
      rewrites the file wholesale on recovery/snapshot).
    """

    def __init__(self) -> None:
        # each view is independently OBJ (items list) or BYTES (buffer
        # not None); an unsynced rewrite can leave the durable view as
        # damaged bytes while the current view is fresh objects — the
        # damage must survive until an fsynced rewrite replaces it
        self._items: list = []
        self._durable: list = []
        self._bytes: Optional[bytearray] = None
        self._durable_bytes: Optional[bytearray] = None
        # OBJ-mode size estimate (current view): a sampled running
        # average — walking every appended payload charged the hot
        # append path ~16% of a whole run's generation for a stat
        # (db-size) that is read rarely. One record in EST_SAMPLE is
        # walked; the rest extrapolate from the running per-record mean
        self._est_sampled = 0.0   # bytes across sampled records
        self._est_samples = 0
        self._est_count = 0       # records since last wholesale rewrite

    # -- mode helpers --------------------------------------------------------

    @property
    def byte_mode(self) -> bool:
        return self._bytes is not None

    # -- writes --------------------------------------------------------------

    def append(self, item: Any, sync: bool) -> None:
        if self._bytes is not None:
            self._bytes += record_bytes(item)
        else:
            self._items.append(item)
            self._est_count += 1
            if self._est_count % EST_SAMPLE == 1 or self._est_samples < 4:
                self._est_sampled += 22 + _est_size(item)
                self._est_samples += 1
        if sync:
            if self._durable_bytes is not None:
                self._durable_bytes += record_bytes(item)
            else:
                self._durable.append(item)

    def set_records(self, items: list, sync: bool) -> None:
        """Wholesale rewrite (recovery re-encode, snapshot save, conflict
        truncation): the current view returns to OBJ mode. Unsynced
        rewrites leave the durable view untouched — including damaged
        bytes, which must keep failing CRC at a later rollback+replay."""
        self._bytes = None
        self._items = list(items)
        self._reset_est()
        if sync:
            self._durable_bytes = None
            self._durable = list(items)

    def clear(self) -> None:
        self.set_records([], sync=True)

    def fsync(self) -> None:
        if self._bytes is not None:
            self._durable_bytes = bytearray(self._bytes)
            self._durable = []
        else:
            self._durable_bytes = None
            self._durable = list(self._items)

    def lose_unfsynced(self) -> None:
        """Crash without fsync: the current view rolls back to durable."""
        if self._durable_bytes is not None:
            self._bytes = bytearray(self._durable_bytes)
            self._items = []
        else:
            self._bytes = None
            self._items = list(self._durable)
            self._reset_est()

    def corrupt(self, rng, mode: str = "bitflip",
                probability: float = 1e-4, truncate_bytes: int = 1024) -> None:
        """Damage the file's bytes; both views end up with the damaged
        buffer (the fault hits the one real file on disk)."""
        if self._bytes is None:
            self._bytes = bytearray(encode_records(self._items))
            self._items = []
        buf = bytes(self._bytes)
        if mode == "bitflip":
            buf = bitflip(buf, rng, probability)
        else:
            buf = truncate(buf, rng, truncate_bytes)
        self._bytes = bytearray(buf)
        self._durable_bytes = bytearray(buf)
        self._durable = []

    # -- reads ---------------------------------------------------------------

    def read(self) -> tuple[list, Optional[str]]:
        """Replay the current view: (records, error)."""
        if self._bytes is not None:
            return decode_records(bytes(self._bytes))
        return list(self._items), None

    def _reset_est(self) -> None:
        """Re-seed the sampled estimate after a wholesale rewrite:
        walk up to EST_SAMPLE samples of the new contents,
        extrapolate."""
        items = self._items
        n = len(items)
        self._est_count = n
        if n <= EST_SAMPLE:
            self._est_sampled = float(
                sum(22 + _est_size(i) for i in items))
            self._est_samples = n
        else:
            step = n // EST_SAMPLE
            sample = items[::step][:EST_SAMPLE]
            self._est_sampled = float(
                sum(22 + _est_size(i) for i in sample))
            self._est_samples = len(sample)

    @property
    def size(self) -> int:
        # Unserialized files report a SAMPLED estimate (EST_SAMPLE items
        # extrapolated to the full count), not an exact byte size. Fine
        # for perf plots and relative comparisons; do NOT gate threshold
        # logic (quota, corruption windows) on it — serialize first if
        # an exact size matters.
        if self._bytes is not None:
            return len(self._bytes)
        if not self._est_samples:
            return 0
        return int(self._est_sampled / self._est_samples
                   * self._est_count)


def bitflip(buf: bytes, rng, probability: float) -> bytes:
    """Flip each bit independently with the given probability
    (nemesis.clj:183 uses probabilities 1e-3..1e-5)."""
    if not buf or probability <= 0:
        return buf
    probability = min(probability, 0.999999)
    out = bytearray(buf)
    nbits = len(out) * 8
    # Binomial sample via repeated geometric skips (cheap, deterministic).
    pos = -1
    while True:
        r = rng.random()
        skip = int(math.log(max(r, 1e-12)) / math.log(1 - probability)) + 1
        pos += skip
        if pos >= nbits:
            break
        out[pos // 8] ^= 1 << (pos % 8)
    return bytes(out)


def truncate(buf: bytes, rng, max_bytes: int = 1024) -> bytes:
    """Drop up to max_bytes from the tail (nemesis.clj:182)."""
    if not buf:
        return buf
    drop = rng.randint(1, max_bytes)
    return buf[:max(0, len(buf) - drop)]
