"""A numpy model of ``csrc/drain_register.cu``, held against the plain
version ``drain_register_reference`` and the reference's ``lax.scan``
(``engine_jax._drain_register``) on all five output planes. Tolerance 0:
every value is an int32.

The kernel has no CPU mode, so its algorithm is checked here, step for
step as its source writes it:

- the blocking ``engine_v3.drain_blocking`` picks (SB seeds, KB keys a
  block, tiles of T rows), one lane per (seed, key), the lanes' warps
  first and the workers after them;
- the shared-memory layout (staging slots, records for three tiles, the
  lanes' pairs, sorted lists and their starts and lengths for two, the
  bit lists) is one byte array, so regions that overlapped would corrupt
  each other here as on the card;
- the copies read a byte image of device memory in which the planes lie,
  (N, S) or seed-major, at chosen alignments between garbage: four bytes
  an int32, the aligned word holding a flag when it lies inside the
  flag's plane, else the flag's byte alone; the workers take their
  entries in the order of that memory, and the outputs are written to
  the same layout;
- each iteration of the tile loop runs the lanes' walk of tile t and the
  workers' part (the outputs of tile t - 1, the records, bit lists,
  counts and sorted lists of tile t + 1, the copies of tile t + 2) in
  either order: they share no buffer, so both orders must give the plain
  version's planes;
- the lanes walk their sorted lists, the machine in four integers.

Every output entry must be written exactly once, by the block of its
key. ``chip_smoke.drain_bound``'s recounted chain is held against a
brute-force count.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from jepsen_etcd_tpu_torch.simbatch import engine_v3

from test_torch_fixtures import one_torch_thread  # noqa: F401

FC_READ, FC_WRITE, FC_CAS = 0, 1, 2
TC_OK, TC_FAIL = 1, 2
PK_RD_OK, PK_WR_OK, PK_CAS_OK, PK_CAS_FAIL = 2, 4, 6, 7
R_READ, R_WRITE, R_CAS, R_STALE, R_MINE = 1, 2, 4, 8, 16
R_OP = R_READ | R_WRITE | R_CAS
KEY_SHIFT = 8
GARBAGE = 0xA5


def layout(SB, KB, T):
    """drain_register.cu's ``layout``: byte offsets of each region."""
    entries, lanes = T * SB, SB * KB
    words = lanes * (T // 32)
    off = [0]

    def region(nbytes):
        at = off[0]
        off[0] += (nbytes + 15) // 16 * 16
        return at
    L = {"stage": region(entries * 32),
         "cls": [region(entries * 4) for _ in range(3)],
         "conl": [region(entries * 8) for _ in range(3)],
         "res": [], "lrec": [], "base": [], "tot": []}
    for _ in range(2):
        L["res"].append(region((entries + 1) * 8))
        L["lrec"].append(region(entries * 16))
        L["base"].append(region(lanes * 4))
        L["tot"].append(region(lanes * 4))
    L["mask"] = region(words * 4)
    L["word"] = region(words * 4)
    L["pre"] = region(words * 4)
    L["bytes"] = off[0]
    return L


class Device:
    """A byte image of device memory holding the seven planes (k, f,
    wv, co, cn int32, to, sg bytes), (N, S) or seed-major ([S, N]), at
    given misalignments, each plane between garbage bytes; ``mis`` None
    lays them out as the generator does (the five int32 planes one
    stacked tensor, the two flags another)."""

    def __init__(self, planes, flags, mis=None, seed_major=False):
        order = (lambda a: a.T) if seed_major else (lambda a: a)
        arrays = [np.ascontiguousarray(order(a), np.int32) for a in planes] \
            + [np.ascontiguousarray(order(a), np.uint8) for a in flags]
        self.base, chunks, addr = [], [], 4096
        for p, a in enumerate(arrays):
            if mis is None:
                if p in (0, 5):
                    addr = (addr + 255) // 256 * 256
            else:
                addr = (addr + 64 + 15) // 16 * 16 + mis[p]
            self.base.append(addr)
            chunks.append((addr, a.view(np.uint8).reshape(-1)))
            addr += a.nbytes
        self.mem = np.full(addr + 64, GARBAGE, np.uint8)
        for at, raw in chunks:
            self.mem[at:at + raw.size] = raw
        self.size = [a.nbytes for a in arrays]


def model_drain(state0, planes, flags, lanes=None, mis=None,
                walk_first=True, seed_major=False):
    """drain_register.cu's kernel over every block of its grid (``lanes``
    None: the default for an H100's 132 SMs), the phases of each
    iteration in the order its barriers impose and the lanes' walk
    before or after the workers' part; the planes and the outputs (N,
    S) or seed-major. Returns the [5, N, S] outputs and the number of
    writes of each entry."""
    N, S = planes[0].shape
    K = state0[0].shape[1]
    SB, KB, T = engine_v3.drain_blocking(
        S, K, engine_v3.drain_lanes(S, K, 132) if lanes is None else lanes)
    assert SB * KB <= engine_v3.DRAIN_MAX_LANES and T % 32 == 0
    L = layout(SB, KB, T)
    dev = Device(planes, flags, mis, seed_major)
    out = np.full((5, N * S), -(2 ** 31), np.int64)   # the output planes
    writes = np.zeros(N * S, np.int64)
    C = T // 32
    E = T * SB
    rng = np.random.default_rng(0)
    for bx in range(-(-S // SB)):
        for by in range(-(-K // KB)):
            s0, k0 = bx * SB, by * KB
            sbn, kbn = min(SB, S - s0), min(KB, K - k0)
            nl = sbn * kbn
            # shared memory starts as garbage
            smem = rng.integers(0, 256, L["bytes"], dtype=np.uint8)

            def view(at, n, dtype, shape=None):
                v = smem[at:at + n * np.dtype(dtype).itemsize].view(dtype)
                return v if shape is None else v.reshape(shape)
            stage = view(L["stage"], E * 8, np.int32, (E, 8))
            cls = [view(L["cls"][b], E, np.int32) for b in range(3)]
            conl = [view(L["conl"][b], E * 2, np.int32, (E, 2))
                    for b in range(3)]
            res = [view(L["res"][b], (E + 1) * 2, np.int32, (E + 1, 2))
                   for b in range(2)]
            lrec = [view(L["lrec"][b], E * 4, np.int32, (E, 4))
                    for b in range(2)]
            base = [view(L["base"][b], SB * KB, np.int32) for b in range(2)]
            tot = [view(L["tot"][b], SB * KB, np.int32) for b in range(2)]
            mask = view(L["mask"], SB * KB * C, np.uint32)
            word = view(L["word"], SB * KB * C, np.uint32)
            pre = view(L["pre"], SB * KB * C, np.int32)

            def locate(r0, rows, q):
                """Entry q of a worker's pass: its row, seed and index
                in a plane, seeds fastest or (seed-major) rows fastest."""
                if seed_major:
                    s, row = divmod(q, rows)
                    return row, s, (s0 + s) * N + r0 + row
                row, s = divmod(q, sbn)
                return row, s, (r0 + row) * S + s0 + s

            def stage_tile(u):
                r0 = u * T
                rows = min(T, N - r0)
                for q in range(rows * sbn):
                    row, s, i = locate(r0, rows, q)
                    slot = stage[row * sbn + s].view(np.uint8)
                    for p in range(5):
                        at = dev.base[p] + 4 * i
                        slot[4 * p:4 * p + 4] = dev.mem[at:at + 4]
                    for p in (5, 6):
                        lo, hi = dev.base[p], dev.base[p] + dev.size[p]
                        at = lo + i
                        w = at & ~3
                        if w >= lo and w + 4 <= hi:
                            slot[4 * p:4 * p + 4] = dev.mem[w:w + 4]
                        else:
                            slot[4 * p + (at & 3)] = dev.mem[at]

            # the lanes' machines, in registers
            mach = {}
            for lane in range(nl):
                ls, lk = divmod(lane, kbn)
                mach[lane] = [int(state0[j][s0 + ls, k0 + lk])
                              for j in range(4)]

            def step(b, e, w, co, nlv, m):
                """A step without a branch: a step of no entry has w = 0
                and stores to the spare slot E."""
                cv, cl, pv, pl = m
                res[b][e] = (pv, pl) if w & R_STALE else (cv, cl)
                if w & R_WRITE or (w & R_CAS and cl == co):
                    return [cv + 1, nlv, cv, cl]
                return m

            def walk_tile(t):
                b = t & 1
                for lane in range(nl):
                    m = mach[lane]
                    at, n = int(base[b][lane]), int(tot[b][lane])
                    recs = lrec[b][at:at + n].tolist()
                    recs += [[E, 0, 0, 0]] * (-n % 8)    # the last batch
                    for e, w, co, nlv in recs:
                        m = step(b, e, w, co, nlv, m)
                    mach[lane] = m

            def workers(t):
                if t >= 1:                      # the outputs of tile t - 1
                    r0 = (t - 1) * T
                    rows = min(T, N - r0)
                    for q in range(rows * sbn):
                        row, s, i = locate(r0, rows, q)
                        e = row * sbn + s
                        w = int(cls[(t - 1) % 3][e])
                        if not w & R_MINE:
                            continue
                        co, nlv = (int(x) for x in conl[(t - 1) % 3][e])
                        rx, ry = (int(x) for x in res[(t - 1) & 1][e])
                        is_r, is_w, is_c = w & R_READ, w & R_WRITE, w & R_CAS
                        cas_ok = bool(is_c) and ry == co
                        wr = bool(is_w) or cas_ok
                        writes[i] += 1
                        out[0, i] = TC_FAIL if is_c and not cas_ok \
                            else TC_OK
                        out[1, i] = (PK_RD_OK if is_r else PK_WR_OK
                                     if is_w else PK_CAS_OK if cas_ok
                                     else PK_CAS_FAIL)
                        out[2, i] = rx if is_r else rx + 1 if wr else co
                        out[3, i] = ry if is_r else co if cas_ok else nlv
                        out[4, i] = nlv if cas_ok else -1
                if t + 1 >= ntiles:
                    return
                u = t + 1                       # tile t + 1's records
                r0 = u * T
                rows = min(T, N - r0)
                n = rows * sbn
                sh5, sh6 = dev.base[5] & 3, dev.base[6] & 3
                for q in range(n):
                    row, s, i = locate(r0, rows, q)
                    e = row * sbn + s
                    x = [int(v) for v in stage[e]]
                    i3 = i & 3
                    k, f, wv, co, cn = x[:5]
                    ok = ((x[5] >> (8 * ((sh5 + i3) & 3))) & 0xFF) == 0
                    sgate = ((x[6] >> (8 * ((sh6 + i3) & 3))) & 0xFF) != 0
                    is_r = ok and f == FC_READ
                    is_w = ok and f == FC_WRITE
                    is_c = ok and f == FC_CAS
                    kk = k - k0
                    mine = 0 <= kk < kbn
                    w = ((R_READ if is_r else 0) | (R_WRITE if is_w else 0)
                         | (R_CAS if is_c else 0)
                         | (R_STALE if sgate and is_r else 0)
                         | (R_MINE if mine else 0) | (k << KEY_SHIFT))
                    cls[u % 3][e] = w
                    conl[u % 3][e] = (co, wv if is_w else cn)
                    if mine and w & R_OP:
                        mask[(s * kbn + kk) * C + (row >> 5)] |= \
                            np.uint32(1 << (row & 31))
                if t + 2 < ntiles:
                    stage_tile(t + 2)
                carry = 0                       # counts, starts
                for lane in range(nl):
                    run = 0
                    for c in range(C):
                        m = int(mask[lane * C + c])
                        word[lane * C + c] = m
                        mask[lane * C + c] = 0
                        pre[lane * C + c] = run
                        run += bin(m).count("1")
                    base[u & 1][lane] = carry
                    tot[u & 1][lane] = run
                    carry += run
                for e in range(n):              # each record to its rank
                    w = int(cls[u % 3][e])
                    if not (w & R_MINE and w & R_OP):
                        continue
                    row, s = divmod(e, sbn)
                    lane = s * kbn + (w >> KEY_SHIFT) - k0
                    c = row >> 5
                    below = int(word[lane * C + c]) & ((1 << (row & 31)) - 1)
                    rank = (int(base[u & 1][lane]) + int(pre[lane * C + c])
                            + bin(below).count("1"))
                    co, nlv = (int(x) for x in conl[u % 3][e])
                    lrec[u & 1][rank] = (e, w, co, nlv)

            ntiles = -(-N // T)
            stage_tile(0)
            mask[:nl * C] = 0
            for t in range(-1, ntiles + 1):
                walking = 0 <= t < ntiles
                if walk_first and walking:
                    walk_tile(t)
                workers(t)
                if not walk_first and walking:
                    walk_tile(t)
    if seed_major:
        return (out.reshape(5, S, N).transpose(0, 2, 1),
                writes.reshape(S, N).T)
    return out.reshape(5, N, S), writes.reshape(N, S)


def _inputs(seed, N, S, K, p_to=0.3, p_sg=0.5, skew=None):
    """Random drain inputs, as tests/test_torch_simbatch.py draws them;
    ``skew`` sends that share of the rows to key 0."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, K, (N, S))
    if skew is not None:
        keys = np.where(rng.random((N, S)) < skew, 0, keys)
    planes = [keys, rng.integers(0, 3, (N, S)), rng.integers(0, 5, (N, S)),
              rng.integers(-1, 5, (N, S)), rng.integers(0, 5, (N, S))]
    flags = [rng.random((N, S)) < p_to, rng.random((N, S)) < p_sg]
    state = [rng.integers(0, 3, (S, K)), rng.integers(-1, 5, (S, K)),
             rng.integers(0, 3, (S, K)), rng.integers(-1, 5, (S, K))]
    return ([a.astype(np.int32) for a in state],
            [a.astype(np.int32) for a in planes], flags)


def _torch(state, planes, flags):
    return ([torch.from_numpy(a) for a in state]
            + [torch.from_numpy(a) for a in planes]
            + [torch.from_numpy(a) for a in flags])


def _scan(state, planes, flags):
    import jax.numpy as jnp
    from jepsen_etcd_tpu.simbatch import engine_jax
    ys = engine_jax._drain_register(*[jnp.asarray(a) for a in state],
                                    *[jnp.asarray(a) for a in planes],
                                    *[jnp.asarray(a) for a in flags])
    return np.stack([np.asarray(y) for y in ys])


# (name, seed, N, S, K, p_to, p_sg, skew); T is 512 at one seed a block
# (the default here), 128 at 8 (32 lanes over 4 keys)
CASES = [
    ("N not a multiple of T", 0, 1100, 8, 4, 0.3, 0.5, None),
    ("N below T", 1, 40, 8, 4, 0.3, 0.5, None),
    ("N = 1", 2, 1, 5, 3, 0.3, 0.5, None),
    ("K = 1, one chain a seed", 3, 200, 6, 1, 0.2, 0.5, None),
    ("K = 64", 4, 120, 5, 64, 0.3, 0.5, None),
    ("K = 400", 5, 150, 3, 400, 0.3, 0.5, None),
    ("90% of rows on one key", 6, 260, 9, 6, 0.2, 0.5, 0.9),
    ("every row timed out", 7, 70, 4, 3, 1.0, 0.5, None),
    ("no row stale-gated", 8, 90, 7, 4, 0.2, 0.0, None),
    ("S = 1", 9, 130, 1, 4, 0.3, 0.5, None),
    ("S = 33", 10, 100, 33, 4, 0.3, 0.5, None),
]


# (lanes a block, seed-major planes): the generator's layout at the
# default blocking, then both layouts at blocks of 32 lanes (several
# seeds a block) and of 4 (one seed, keys split over blocks)
RUNS = [(None, True), (None, False), (32, False), (32, True), (4, True)]


@pytest.mark.parametrize("lanes,seed_major", RUNS)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_model_equals_plain_version_and_scan(case, lanes, seed_major):
    _, seed, N, S, K, p_to, p_sg, skew = case
    state, planes, flags = _inputs(seed, N, S, K, p_to, p_sg, skew)
    got, writes = model_drain(state, planes, flags, lanes,
                              seed_major=seed_major)
    assert (writes == 1).all()
    again, _ = model_drain(state, planes, flags, lanes,
                           walk_first=False, seed_major=seed_major)
    assert np.array_equal(again, got)
    want = engine_v3.drain_register_reference(*_torch(state, planes,
                                                      flags)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(want, _scan(state, planes, flags))


# other blockings (one seed a block, several keys a block, keys split
# over blocks) at other alignments of the planes: (lanes, misalignment of
# each plane in bytes, None = the generator's layout)
BLOCKINGS = [(4, None), (4, (12, 0, 4, 8, 8, 9, 2)), (32, (0, 4, 8, 12, 4,
                                                         3, 1)),
             (128, None), (2, (4, 8, 12, 4, 0, 1, 3))]


@pytest.mark.parametrize("seed_major", [False, True])
@pytest.mark.parametrize("lanes,mis", BLOCKINGS)
def test_model_blockings_and_alignments(lanes, mis, seed_major):
    state, planes, flags = _inputs(11, 203, 13, 3)
    got, writes = model_drain(state, planes, flags, lanes, mis,
                              seed_major=seed_major)
    assert (writes == 1).all()
    want = engine_v3.drain_register_reference(*_torch(state, planes, flags))
    assert np.array_equal(got, want.numpy())


def test_blocking():
    """Lanes never exceed DRAIN_MAX_LANES; a tile holds at most
    DRAIN_TILE_ENTRIES entries (32 rows at least), rows a multiple of
    32; keys past a block's lanes split over blocks of keys."""
    for S in (1, 5, 16, 33, 256, 1000):
        for K in (1, 4, 12, 64, 400):
            for lanes in (1, 4, 32, engine_v3.DRAIN_MAX_LANES):
                SB, KB, T = engine_v3.drain_blocking(S, K, lanes)
                assert 1 <= SB <= S and 1 <= KB <= K
                assert SB * KB <= lanes and T % 32 == 0
                assert 32 <= T <= 512
                assert SB * T <= engine_v3.DRAIN_TILE_ENTRIES
    assert engine_v3.drain_blocking(16, 4, 32) == (8, 4, 128)
    # the default: a block for each SM, as far as the pairs go
    assert engine_v3.drain_lanes(16, 4, 132) == 1
    assert engine_v3.drain_lanes(256, 4, 132) == 8
    assert engine_v3.drain_lanes(100_000, 400, 132) == \
        engine_v3.DRAIN_MAX_LANES
    with pytest.raises(ValueError):
        engine_v3.drain_blocking(16, 4, engine_v3.DRAIN_MAX_LANES + 1)


def test_drain_cuda_refuses_cpu_tensors():
    args = _torch(*_inputs(0, 4, 3, 2))
    with pytest.raises(ValueError, match="CUDA"):
        engine_v3.drain_register_cuda(*args)


@pytest.mark.parametrize("seed,N,S,K,p_to,skew", [
    (0, 50, 4, 3, 0.3, None), (1, 80, 2, 1, 0.0, None),
    (2, 60, 5, 7, 1.0, None), (3, 120, 3, 5, 0.1, 0.9)])
def test_chain_links_equal_brute_force(seed, N, S, K, p_to, skew):
    """The recounted chain of ``chip_smoke.drain_bound``: the most steps,
    over (seed, key), not timed out that write or CAS."""
    state, planes, flags = _inputs(seed, N, S, K, p_to, skew=skew)
    best = 0
    for s in range(S):
        for k in range(K):
            best = max(best, sum(
                1 for n in range(N)
                if planes[0][n, s] == k and not flags[0][n, s]
                and planes[1][n, s] in (FC_WRITE, FC_CAS)))
    b = chip_smoke.drain_bound(_torch(state, planes, flags), 1980.0, 25.0)
    assert b["links"] == best
    assert b["chain_ms"] == pytest.approx(best * 25.0 * 1e-6)
    assert b["chain_old_ms"] == pytest.approx(
        N * chip_smoke.DRAIN_CHAIN_CYCLES / 1980e6 * 1e3)
