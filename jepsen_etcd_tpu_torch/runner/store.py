"""Per-test artifact store (the jepsen.store analog).

Layout: store/<test-name>/<seq-timestamp>/{history.jsonl, results.json,
test.json, timeline.html, latency-raw.png, rate.png, <node>/etcd.log},
with store/<test-name>/latest symlinked to the newest run and
store/latest to the newest run overall.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import shutil
from typing import Any

logger = logging.getLogger("jepsen_etcd_tpu_torch.store")

_seq = itertools.count()


def failure_signature(results: dict) -> str:
    """Canonical dedupe key for failing runs: the sorted set of
    ``checker=verdict`` entries that are not clean passes. THE single
    implementation — the dashboard (serve.py re-exports it as
    ``_failure_signature``), tel --coverage, shrink and the store
    index all import it from here, so index rows store the signature
    once and every reader agrees on it."""
    sig = []
    for k, v in results.items():
        if isinstance(v, dict) and "valid?" in v and \
                v.get("valid?") is not True:
            sig.append(f"{k}={v.get('valid?')}")
    return ", ".join(sorted(sig))

#: total store size cap: once exceeded, oldest runs are deleted after
#: each save (long test-all sweeps write GBs of artifacts and would
#: otherwise fill the disk). 0 disables rotation.
STORE_MAX_BYTES = int(os.environ.get(
    "JEPSEN_ETCD_TPU_STORE_MAX_BYTES", 2 * 1024 ** 3))


def _dir_size(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


def rotate_store(base: str, keep_dir: str = None,
                 max_bytes: int = None) -> list[str]:
    """Delete oldest run dirs until the store fits under max_bytes.
    The run at keep_dir (the one just written) is never deleted;
    dangling `latest` symlinks left by a deletion are removed."""
    max_bytes = STORE_MAX_BYTES if max_bytes is None else max_bytes
    if max_bytes <= 0 or not os.path.isdir(base):
        return []
    keep = os.path.abspath(keep_dir) if keep_dir else None
    runs = []
    for test_name in sorted(os.listdir(base)):
        td = os.path.join(base, test_name)
        if os.path.islink(td) or not os.path.isdir(td):
            continue
        for run_id in sorted(os.listdir(td)):
            rd = os.path.join(td, run_id)
            if os.path.islink(rd) or not os.path.isdir(rd):
                continue
            try:
                mtime = os.path.getmtime(rd)
            except OSError:
                continue
            runs.append((mtime, rd, _dir_size(rd)))
    total = sum(s for _, _, s in runs)
    removed: list[str] = []
    for _, rd, size in sorted(runs):
        if total <= max_bytes:
            break
        if keep and os.path.abspath(rd) == keep:
            continue
        shutil.rmtree(rd, ignore_errors=True)
        total -= size
        removed.append(rd)
    if removed:
        try:
            from .store_index import mark_deleted
            mark_deleted(base, [os.path.relpath(rd, base)
                                for rd in removed])
        except Exception:
            logger.debug("index tombstone failed", exc_info=True)
        # WARNING with the list: rotation is on by default (2 GiB cap)
        # and may remove runs of OTHER tests under the store base —
        # pre-existing artifacts a user cares about deserve a loud,
        # attributable line (JEPSEN_ETCD_TPU_STORE_MAX_BYTES=0 opts out)
        logger.warning(
            "store rotation: removed %d old run dirs under %s "
            "(cap %d bytes; set JEPSEN_ETCD_TPU_STORE_MAX_BYTES=0 to "
            "disable): %s", len(removed), base, max_bytes,
            ", ".join(removed))
        for link in [os.path.join(base, "latest")] + [
                os.path.join(base, t, "latest")
                for t in os.listdir(base)
                if os.path.isdir(os.path.join(base, t))]:
            if os.path.islink(link) and not os.path.exists(link):
                try:
                    os.unlink(link)  # dangling after rotation
                except OSError:
                    pass
    return removed


def _next_run_id(tdir: str) -> int:
    # max+1, NOT count: rotation deletes the lowest-numbered (oldest)
    # runs, so a count could collide with a surviving higher id and
    # silently overwrite its artifacts. Suffixed ids ("00007-1234abcd",
    # the concurrent-creation escape hatch below) count by their
    # numeric prefix.
    existing = os.listdir(tdir) if os.path.isdir(tdir) else []
    ids = [int(e.split("-")[0]) for e in existing
           if e.split("-")[0].isdigit()]
    return max(ids) + 1 if ids else 0


def make_store_dir(base: str, test_name: str) -> str:
    """Create the next run dir. `latest` symlinks are NOT repointed here
    — the dir is made before the run executes (debug provenance needs
    its name), and a crashed run must not leave `latest` dangling at an
    empty dir; save_run repoints them once artifacts exist.

    Concurrency-safe: campaign pool workers (runner/campaign.py) create
    run dirs under one test name simultaneously, so the bare
    list-then-max id claim races. The claim itself is an ATOMIC
    ``os.mkdir`` (never ``exist_ok=True``, which would silently hand
    two runs the same artifact dir); a loser re-lists and retries, and
    after a few lost races appends a pid+uuid suffix that cannot
    collide."""
    import uuid
    tdir = os.path.join(base, test_name)
    os.makedirs(tdir, exist_ok=True)
    for attempt in range(8):
        run_id = f"{_next_run_id(tdir):05d}"
        if attempt >= 4:
            run_id += f"-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        path = os.path.join(tdir, run_id)
        try:
            os.mkdir(path)
            return path
        except FileExistsError:
            continue  # lost the claim race; re-list and retry
    raise OSError(f"could not claim a run dir under {tdir}")


def link_latest(store_dir: str) -> None:
    """Point store/<test>/latest and store/latest at a completed run."""
    run_id = os.path.basename(store_dir)
    test_dir = os.path.dirname(store_dir)
    base = os.path.dirname(test_dir)
    test_name = os.path.basename(test_dir)
    for link_base, target in ((test_dir, run_id),
                              (base, os.path.join(test_name, run_id))):
        link = os.path.join(link_base, "latest")
        try:
            if os.path.islink(link):
                os.unlink(link)
            os.symlink(target, link)
        except OSError:
            pass


def _scrub(x: Any):
    if isinstance(x, dict):
        return {str(k): _scrub(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_scrub(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted((_scrub(v) for v in x), key=repr)
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    return repr(x)


def save_run(store_dir: str, test: dict, history, results: dict,
             node_logs: dict) -> None:
    link_latest(store_dir)
    with open(os.path.join(store_dir, "history.jsonl"), "w") as f:
        f.write(history.to_jsonl())
    with open(os.path.join(store_dir, "results.json"), "w") as f:
        json.dump(_scrub(results), f, indent=2, default=repr)
    cfg = {k: v for k, v in test.items()
           if k not in ("cluster", "db", "client", "checker", "generator",
                        "nemesis", "final_generator")}
    with open(os.path.join(store_dir, "test.json"), "w") as f:
        json.dump(_scrub(cfg), f, indent=2, default=repr)
    for node, lines in node_logs.items():
        nd = os.path.join(store_dir, node)
        os.makedirs(nd, exist_ok=True)
        with open(os.path.join(nd, "etcd.log"), "w") as f:
            f.write("\n".join(lines))
    # index the run the moment its artifacts are complete: readers
    # (/aggregate, tel) fold the new row instead of re-walking the
    # tree. Best-effort — an index failure must never fail the save.
    try:
        from .store_index import record_run
        record_run(store_dir)
    except Exception:
        logger.debug("index write failed for %s", store_dir,
                     exc_info=True)
    # keep long sweeps from filling the disk; never touches this run
    rotate_store(os.path.dirname(os.path.dirname(store_dir)),
                 keep_dir=store_dir)
