"""The port's bit-parallel LCS (kernel indel_bits) against the JAX
package's edit distance: its plain version ``lcs_bits_reference`` equals
the reference's Pallas wavefront (interpret mode), its XLA wavefront
``_indel_device_batch``, its Python DP and the port's anti-diagonal DP
``wavefront_reference``; the sorted match index both versions share;
and a lane-by-lane model of the CUDA kernel's step (32 lanes of 64-bit
words, the ballot carry lookahead, the match search), so that its
arithmetic is tested where the kernel itself cannot run. All values are
integers: tolerance 0."""

import random

import numpy as np
import pytest
import torch

from jepsen_etcd_tpu.ops import edit_distance as ref_ed
from jepsen_etcd_tpu_torch.checkers import watch
from jepsen_etcd_tpu_torch.ops import edit_distance as ed
from jepsen_etcd_tpu_torch.testing import gen_watch_history
from test_torch_fixtures import one_torch_thread  # noqa: F401
from test_torch_watch import _case, _tensors

CPU = torch.device("cpu")


def _padded(a, logs):
    """(a, b, m) int32 tensors from int codes, as the kernel takes them
    (no re-encoding: codes may be any int32)."""
    lb = max([len(l) for l in logs] + [1])
    b = np.full((len(logs), lb), -2, np.int32)
    for k, l in enumerate(logs):
        b[k, :len(l)] = l
    return (torch.tensor(a, dtype=torch.int32), torch.from_numpy(b),
            torch.tensor([len(l) for l in logs], dtype=torch.int32))


def _lane_words(n):
    """64-bit words of V each of the kernel's 32 lanes owns for a
    canonical log of n codes, ceil(ceil(n / 64) / 32) (indel_bits.cu's
    lane_words, the layout the model copies)."""
    return -(-(-(-n // 64)) // 32)


def _kernel_model(a, b, m):
    """indel_bits.cu's step in Python, lane by lane: 32 lanes, lane t
    owning the 64-bit words [t * L, (t + 1) * L) of V and a bitmap of
    which are all ones. A step with one match position takes the fast
    path: its lane clears the bit and sets the lowest zero bit above it
    (Lane::flip), and a carry out of the lane goes to the next lane that
    is not all ones. Otherwise a lane walks only its matched words and,
    where a carry leaves one, the first word that is not all ones; the
    lanes with a match report G (P is false for them), the others P =
    all ones; the carry into lane t is bit t of ((G | P) + G) ^ P; the
    lanes that match or take a carry write. Each lane's walk is checked
    against the dense add of its words, and every step's V against the
    dense update of the whole vector. Returns [K] distances."""
    ones64 = (1 << 64) - 1
    n = a.shape[0]
    L = _lane_words(n)
    top = (1 << (64 * L)) - 1
    order, lo, hi = (x.tolist() for x in ed.match_index(a, b))
    out = []
    for k, mk in enumerate(m.tolist()):
        V = [[ones64] * L for _ in range(32)]
        full = [[True] * L for _ in range(32)]
        ones = [True] * 32

        def put(t, i, v):
            V[t][i] = v
            full[t][i] = v == ones64

        def carry_through(t, carry, x, y, store):
            if not carry:
                return 0
            f = next((i for i in range(x, y) if not full[t][i]), y)
            if f == y:
                return 1
            if store:
                put(t, f, V[t][f] | (V[t][f] + 1))
            return 0

        def add(t, q, h, carry, store):
            base, nxt = t * L * 64, 0
            while q < h and order[q] < base + 64 * L:
                w = (order[q] - base) >> 6
                mask = 0
                while q < h and order[q] < base + (w + 1) * 64:
                    mask |= 1 << (order[q] & 63)
                    q += 1
                carry = carry_through(t, carry, nxt, w, store)
                v = V[t][w]
                total = v + (v & mask) + carry
                carry = total >> 64
                if store:
                    put(t, w, (total & ones64) | (v & ~mask))
                nxt = w + 1
            return carry_through(t, carry, nxt, L, store)

        def lane(t):
            return sum(v << (64 * i) for i, v in enumerate(V[t]))

        def vector():
            return sum(lane(t) << (64 * L * t) for t in range(32))

        def flip(t, p):
            w, b = (p - t * L * 64) >> 6, p & 63
            v = V[t][w]
            if not (v >> b) & 1:
                return 0
            v &= ~(1 << b)
            above = ~v & (ones64 << (b + 1)) & ones64
            put(t, w, v | (above & -above))
            return int(not above and carry_through(t, 1, w + 1, L, True))

        for j in range(mk):
            l, h = lo[k][j], hi[k][j]
            whole = vector()
            step_mask = sum(1 << order[i] for i in range(l, h))
            want = ((whole + (whole & step_mask))
                    & ((1 << (64 * L * 32)) - 1)) | (whole & ~step_mask)
            if h - l == 1:
                G, P = 0, 0
                for t in range(32):
                    if t * L * 64 <= order[l] < (t + 1) * L * 64:
                        G |= flip(t, order[l]) << t
                        ones[t] = False
                    P |= ones[t] << t
                cin = (((G | P) + G) & 0xFFFFFFFF) ^ P
                for t in range(32):
                    if not ones[t] and (cin >> t) & 1:
                        carry_through(t, 1, 0, L, True)
                        ones[t] = all(full[t])
                assert vector() == want
                continue
            qs, G, P = [], 0, 0
            for t in range(32):
                base, end = t * L * 64, (t + 1) * L * 64
                q = h
                if h > l and order[l] < end and order[h - 1] >= base:
                    if order[l] >= base:
                        q = l
                    else:
                        lo_q, hi_q = l + 1, h - 1
                        while lo_q < hi_q:
                            mid = (lo_q + hi_q) >> 1
                            if order[mid] >= base:
                                hi_q = mid
                            else:
                                lo_q = mid + 1
                        if order[lo_q] < end:
                            q = lo_q
                g = add(t, q, h, 0, False) if q < h else 0
                mask = sum(1 << (order[i] - base) for i in range(l, h)
                           if base <= order[i] < end)
                dense = lane(t) + (lane(t) & mask)
                assert g == dense >> (64 * L)
                assert (q < h) == bool(mask)
                assert not (mask and (dense & top) == top)
                G |= g << t
                P |= (q == h and ones[t]) << t
                qs.append((q, mask))
            cin = (((G | P) + G) & 0xFFFFFFFF) ^ P
            for t, (q, mask) in enumerate(qs):
                c = (cin >> t) & 1
                if q < h or c:
                    before = lane(t)
                    add(t, q, h, c, True)
                    assert lane(t) == ((before + (before & mask) + c) & top) \
                        | (before & ~mask)
                    ones[t] = all(full[t])
            assert vector() == want
        zeros = sum(((~V[w // L][w % L]) >> i) & 1
                    for w in range(32 * L) for i in range(64)
                    if w * 64 + i < n)
        out.append(n + mk - 2 * zeros)
    return out


# -- against the reference ------------------------------------------------

@pytest.mark.parametrize("seed,K,n", [(1, 1, 130), (2, 3, 200),
                                      (3, 5, 260), (4, 7, 400),
                                      (5, 9, 600), (6, 2, 0),
                                      (7, 4, 90)])
def test_lcs_bits_matches_pallas_xla_and_python(seed, K, n):
    """test_torch_watch's shapes: lengths 0..600, random edits, empty,
    reversed and unrelated logs over a 6-code alphabet."""
    canon, logs = _case(seed, K, n)
    t = _tensors(canon, logs)
    got = ed.lcs_bits_reference(*t).tolist()
    assert got == [ref_ed._indel_python(canon, l) for l in logs]
    assert got == ref_ed.edit_distance_batch(canon, logs, force_device=True,
                                             force_pallas=True)
    assert got == ref_ed.edit_distance_batch(canon, logs, force_device=True,
                                             force_pallas=False)
    assert got == ed.wavefront_reference(*t).tolist()


@pytest.mark.parametrize("a,b", [([], []), ([], [4]), ([4], []),
                                 ([4], [4]), ([4], [5]),
                                 ([1, 2], [2, 1]), ([], [1, 2, 3]),
                                 ([1, 2, 3], [])])
def test_lcs_bits_edges(a, b):
    """n + m in {0, 1} and empty logs."""
    want = ref_ed._indel_python(a, b)
    t = _tensors(a, [b])
    assert ed.lcs_bits_reference(*t).tolist() == [want]
    assert _kernel_model(*t) == [want]
    assert ref_ed.edit_distance_batch(a, [b], force_device=True,
                                      force_pallas=True) == [want]


@pytest.mark.parametrize("n,run", [(200, (0, 200)), (300, (20, 290)),
                                   (2500, (100, 2400))])
def test_carry_crosses_every_word(n, run):
    """A run of equal codes in a spans many words: the first step's
    V + (V & M) carries from the run's bottom across every word of it
    (in the kernel's model, across lanes too at n = 2,500)."""
    rng = np.random.default_rng(n)
    a = rng.integers(1, 50, n).astype(np.int32)
    a[run[0]:run[1]] = 0
    logs = [[0] * 40, [0] * 5 + a[:30].tolist() + [0] * 7,
            a[::-1][:60].tolist(), [int(x) for x in rng.integers(0, 3, 90)]]
    t = _padded(a.tolist(), logs)
    want = [ref_ed._indel_python(a.tolist(), l) for l in logs]
    assert ed.lcs_bits_reference(*t).tolist() == want
    assert _kernel_model(*t) == want
    assert ed.wavefront_reference(*t).tolist() == want


@pytest.mark.parametrize("seed,K,n", [(11, 3, 64), (12, 4, 700),
                                      (13, 2, 2049), (14, 3, 4200)])
def test_kernel_model_matches_the_plain_version(seed, K, n):
    """The kernel's lane layout at one, several and more than one word a
    lane (L = _lane_words(n): 1, 1, 2, 3), small alphabets (a step sets
    n/4 bits, found by binary search) and arbitrary int32 codes."""
    rng = np.random.default_rng(seed)
    codes = np.array([-7, 0, 2 ** 31 - 1, -2 ** 31], np.int32)
    a = codes[rng.integers(0, 4, n)]
    logs = [a[:120].tolist()] + [
        codes[rng.integers(0, 4, int(rng.integers(0, 150)))].tolist()
        for _ in range(K - 1)]
    t = _padded(a.tolist(), logs)
    got = ed.lcs_bits_reference(*t).tolist()
    assert got == [ref_ed._indel_python(a.tolist(), l) for l in logs]
    assert _kernel_model(*t) == got


@pytest.mark.parametrize("corrupt", ["drop", "reorder", "duplicate"])
def test_distinct_value_watch_logs(corrupt):
    """Watch logs of distinct values (a step matches one position or
    none), one watcher's log corrupted, as the watch checker hands them
    over (``device_inputs``): equal to the reference's Pallas kernel and
    Python DP, the kernel's model and the anti-diagonal DP."""
    h = gen_watch_history(random.Random(len(corrupt)), n_writers=3,
                          n_watchers=3, n_writes=300, per_watch=40,
                          corrupt=corrupt, corrupt_thread=1)
    test = {"concurrency": 6}
    logs = watch.per_thread_logs(test, h)
    threads = sorted(logs)
    canon = watch.canonical_log([logs[th] for th in threads])
    seqs = [logs[th] for th in threads]
    t = ed.device_inputs(canon, seqs, CPU)
    got = ed.lcs_bits_reference(*t).tolist()
    want = [ref_ed._indel_python(canon, l) for l in seqs]
    assert got == want and any(want) and not all(want)
    assert got == ref_ed.edit_distance_batch(canon, seqs, force_device=True,
                                             force_pallas=True)
    assert got == _kernel_model(*t)
    assert got == ed.wavefront_reference(*t).tolist()
    assert ed.edit_distance_batch(canon, seqs, device="cpu") == want


# -- the match index -------------------------------------------------------

@pytest.mark.parametrize("a,logs", [
    ([5, 3, 5, 1, 5, 3], [[5, 3, 9], [1], [9, 9, -2], []]),
    ([], [[1, 2]]),
    ([7, 7, 7], [[7, 6, 8, 7]]),
    ([-2 ** 31, 2 ** 31 - 1, 0, 0], [[0, 2 ** 31 - 1, -2 ** 31, 4]])])
def test_match_index_on_repeats_and_absent_codes(a, logs):
    """order is the stable argsort (ascending positions within a code),
    lo/hi the left/right searchsorted: order[lo:hi] lists exactly the
    positions of each code, none for a code a lacks."""
    at, b, _ = _padded(a, logs)
    order, lo, hi = ed.match_index(at, b)
    assert order.dtype == lo.dtype == hi.dtype == torch.int32
    na = np.array(a, np.int32)
    want_order = np.argsort(na, kind="stable")
    assert order.tolist() == want_order.tolist()
    sa = na[want_order]
    assert lo.tolist() == np.searchsorted(sa, b.numpy(), "left").tolist()
    assert hi.tolist() == np.searchsorted(sa, b.numpy(), "right").tolist()
    for k, log in enumerate(logs):
        for j, c in enumerate(log):
            got = order[lo[k, j]:hi[k, j]].tolist()
            assert got == [i for i, x in enumerate(a) if x == c]


@pytest.mark.parametrize("n,want", [(0, 0), (1, 1), (64, 1), (2048, 1),
                                    (2049, 2), (12_000, 6), (60_000, 30)])
def test_lane_words(n, want):
    """The model's layout: ceil(ceil(n / 64) / 32) words a lane, 6 at the
    watch cell's 12,000 values, 30 at 60,000 (held against the kernel's
    own definition on the card below)."""
    assert _lane_words(n) == want


@pytest.mark.cuda
def test_kernel_state_words_match_the_model():
    """indel_bits.cu's state for one log is the model's 32 lanes of L
    words of V plus a bitmap word a lane per 64 words of V."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from jepsen_etcd_tpu_torch.ops import _cuda
    for n in (0, 1, 2048, 2049, 12_000, 60_000, 140_000, 1 << 22):
        L = _lane_words(n)
        assert _cuda.indel_state_words(n) == 32 * (L + -(-L // 64))


def test_wavefront_on_cpu_runs_the_bits_version(monkeypatch):
    """``wavefront`` on CPU tensors is ``lcs_bits_reference`` (no
    launch), never the anti-diagonal DP."""
    def boom(*args, **kwargs):
        raise AssertionError("the DP ran on the CPU path")
    canon, logs = _case(3, 4, 200)
    t = _tensors(canon, logs)
    want = ed.wavefront_reference(*t)
    monkeypatch.setattr(ed, "wavefront_reference", boom)
    before = ed.LAUNCHES
    assert torch.equal(ed.wavefront(*t), want)
    assert ed.LAUNCHES == before
