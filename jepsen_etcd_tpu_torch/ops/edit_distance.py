"""Indel edit distance for the watch checker: the anti-diagonal wavefront
on the card (the port of the reference's ``ops/edit_distance.py``).

The reference's watch checker measures per-thread log divergence with
clj-diff (``watch.clj:328-357``): *indel* edit distance (insertions +
deletions, no substitution), ``ed = n + m - 2*LCS``. The O(n*m) DP has
a sequential dependency along rows but none along anti-diagonals, so the
device form sweeps diagonals: diagonal k holds D[i, k-i] for all i,
computed elementwise from diagonals k-1 and k-2.

Two versions of the sweep take the same arguments: ``wavefront``
launches the hand-written CUDA kernel (csrc/indel_wave.cu, one block per
log) for CUDA tensors, and ``wavefront_reference`` is its plain PyTorch
version (the tests' and the CPU's path; it is also the reference's XLA
form ``_indel_device_batch``). Logs shorter than ``CPU_CUTOFF`` take the
Python DP, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .common import bucket, use_device

#: below this size the pure-python DP beats a device dispatch (copied
#: from the reference; re-derived only from measurements on the card)
CPU_CUTOFF = 128

INF = 2 ** 30

#: a block's threads; fewer for short canonical logs
THREADS = 1024

#: launches of the CUDA wavefront kernel in this process (the wrapper
#: adds one per launch; a caller may reset it to 0 to count one run)
LAUNCHES = 0


def wavefront_reference(a: torch.Tensor, b: torch.Tensor,
                        m: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the wavefront: a [n] int32 (the
    canonical log's codes), b [K, LB] int32 (the logs, padded with codes
    that match nothing), m [K] int32 (the logs' lengths) -> [K] int32,
    the indel distance of each log to a. Diagonals are [K, n + 1] rows
    indexed by i; the sweep stops at max(n + m)."""
    dev = a.device
    n = a.shape[0]
    K, LB = b.shape
    if K == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    i64 = torch.int64
    l = n + 1
    i_idx = torch.arange(l, device=dev)[None, :]               # [1, l]
    ai = torch.cat([torch.full((1,), -1, dtype=i64, device=dev),
                    a.to(i64)])[None, :]                       # a[i-1]
    b64 = b.to(i64)
    nm = n + m.to(i64)                                         # [K]
    dm2 = torch.where(i_idx == 0, 0, INF).expand(K, l)         # diag 0
    dm1 = torch.where(i_idx <= 1, 1, INF).expand(K, l)         # diag 1
    res = torch.where(nm == 0, 0, torch.where(nm == 1, 1, INF))
    inf_col = torch.full((K, 1), INF, dtype=i64, device=dev)
    for k in range(2, int(nm.max()) + 1):
        j_idx = k - i_idx
        bj = b64[:, (j_idx - 1).clamp(0, max(LB - 1, 0))[0]] if LB \
            else torch.full((K, l), -2, dtype=i64, device=dev)
        match = ai == bj
        up = torch.cat([inf_col, dm1[:, :-1]], 1)              # D[i-1, j]
        diag = torch.cat([inf_col, dm2[:, :-1]], 1)            # D[i-1, j-1]
        dk = torch.where(match, diag, torch.minimum(up, dm1) + 1)
        dk = torch.where(i_idx == 0, k, dk)
        dk = torch.where(j_idx == 0, i_idx, dk)
        dk = torch.where((j_idx < 0) | (i_idx > k), INF, dk)
        res = torch.where(nm == k, dk[:, n], res)
        dm2, dm1 = dm1, dk
    return res.to(torch.int32)


def _check_wavefront_inputs(a: torch.Tensor, b: torch.Tensor,
                            m: torch.Tensor) -> None:
    if a.dtype != torch.int32 or b.dtype != torch.int32 or \
            m.dtype != torch.int32:
        raise TypeError("a, b and m must be int32")
    if a.dim() != 1 or b.dim() != 2 or m.shape != (b.shape[0],):
        raise ValueError(f"want a [n], b [K, LB], m [K]; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(m.shape)}")
    if not (a.device == b.device == m.device):
        raise ValueError("a, b and m must be on one device")
    if not (a.is_contiguous() and b.is_contiguous()
            and m.is_contiguous()):
        raise ValueError("a, b and m must be contiguous")
    # the kernel reads b[k, j - 1] for j up to m_k: keep it in the row
    if m.numel() and not bool(((m >= 0) & (m <= b.shape[1])).all()):
        raise ValueError(f"log lengths m must lie in [0, {b.shape[1]}]")


def wavefront(a: torch.Tensor, b: torch.Tensor,
              m: torch.Tensor) -> torch.Tensor:
    """The indel distance of each log b_k (its first m_k codes, 0 <= m_k
    <= LB) to a: [K] int32. CUDA tensors go to the hand-written kernel
    (csrc/indel_wave.cu, one block per log, one launch), with the three
    diagonals in shared memory when 3 * (n + 1) int32 fit in the card's
    opt-in limit and in a global scratch buffer otherwise; CPU tensors
    to ``wavefront_reference``."""
    global LAUNCHES
    _check_wavefront_inputs(a, b, m)
    if a.device.type == "cpu":
        return wavefront_reference(a, b, m)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    from . import _cuda
    K = b.shape[0]
    out = torch.empty(K, dtype=torch.int32, device=a.device)
    if K == 0:
        return out
    n = a.shape[0]
    scratch = None
    if 3 * (n + 1) * 4 > _cuda.indel_smem_optin(a.device):
        scratch = torch.empty((K, 3, n + 1), dtype=torch.int32,
                              device=a.device)
    threads = min(THREADS, max(32, -(-(n + 1) // 32) * 32))
    _cuda.indel_wave(a, b, m, out, scratch, threads)
    LAUNCHES += 1
    return out


def edit_distance_batch(canonical, logs: list,
                        force_device: Optional[bool] = None,
                        device=None) -> list[int]:
    """Indel edit distance of each log vs the canonical, in one device
    launch (the watch checker's per-thread divergence measure). Logs
    under CPU_CUTOFF take the Python DP unless ``force_device``; the
    device is ``cuda`` unless ``device`` names another."""
    lens = [len(l) for l in logs] + [len(canonical)]
    if not logs:
        return []
    dev = use_device(force_device, max(lens), CPU_CUTOFF, device)
    if dev is None:
        return [_indel_python(list(canonical), list(l)) for l in logs]
    out = wavefront(*device_inputs(canonical, logs, dev))
    return [int(v) for v in out.cpu().numpy()]


def device_inputs(canonical, logs: list, dev: torch.device):
    """The wavefront's (a, b, m) on ``dev`` for a canonical log and
    non-empty ``logs``: codes from ``_encode``, the logs padded with -2
    (a code that matches nothing) to a ``bucket`` width."""
    enc = _encode([list(canonical)] + [list(l) for l in logs])
    ec, elogs = enc[0], enc[1:]
    pb = np.full((len(logs), bucket(max(len(el) for el in elogs))), -2,
                 np.int32)
    m = np.zeros(len(logs), np.int32)
    for k, el in enumerate(elogs):
        pb[k, :len(el)] = el
        m[k] = len(el)
    return (torch.from_numpy(ec).to(dev), torch.from_numpy(pb).to(dev),
            torch.from_numpy(m).to(dev))


def _indel_python(a, b) -> int:
    n, m = len(a), len(b)
    if n == 0 or m == 0:
        return n + m
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        ai = a[i - 1]
        for j in range(1, m + 1):
            cur[j] = prev[j - 1] if ai == b[j - 1] else \
                min(prev[j], cur[j - 1]) + 1
        prev = cur
    return prev[m]


def _encode(seqs: list) -> list[np.ndarray]:
    """Map arbitrary hashable elements to dense int32 codes, first seen
    first (the canonical log, then the logs)."""
    codes: dict = {}
    out = []
    for s in seqs:
        arr = np.empty(len(s), np.int32)
        for i, x in enumerate(s):
            arr[i] = codes.setdefault(x, len(codes))
        out.append(arr)
    return out


def edit_distance(a, b, force_device: Optional[bool] = None,
                  device=None) -> int:
    """Indel edit distance between two sequences of hashable elements
    (the K=1 case of the batched kernel)."""
    return edit_distance_batch(a, [b], force_device=force_device,
                               device=device)[0]


def diff_report(canonical, log) -> dict:
    """Host-side insert/delete report (the clj-diff :diff analog),
    computed only for divergent logs."""
    import difflib
    sm = difflib.SequenceMatcher(a=list(canonical), b=list(log),
                                 autojunk=False)
    additions, deletions = [], []
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag in ("replace", "delete"):
            deletions.append({"at": i1, "values": list(canonical[i1:i2])})
        if tag in ("replace", "insert"):
            additions.append({"at": i1, "values": list(log[j1:j2])})
    return {"additions": additions, "deletions": deletions}
