"""The port's threefry (``jepsen_etcd_tpu_torch/simbatch/threefry.py``)
bit for bit against ``jax.random`` in JAX's original layout
(``jax.threefry_partitionable(False)``, the layout the epoch-v3 pins
were made with), and the epoch-v3 draw blocks (``_draw_device``,
``_draws_jax``) against the reference's. Tolerance 0: keys and draws
are compared as uint32 words and float32 bit patterns."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_etcd_tpu.simbatch import BatchConfig as RefBatchConfig
from jepsen_etcd_tpu.simbatch import engine_jax as ref_v3
from jepsen_etcd_tpu_torch.simbatch import BatchConfig, engine_v3, threefry

from test_torch_fixtures import one_torch_thread  # noqa: F401

SEEDS = [0, 1, 7, 123_456_789, 2 ** 31, 2 ** 32 - 1]
#: odd and even sizes, one and two dimensions, the epoch's (L, O) blocks
SHAPES = [(1,), (2,), (7,), (16,), (3, 5), (8, 50), (16, 47)]
#: the epoch's ranges (fsel, values, latency, nemesis kinds) and a few
#: more: an empty span, a power of two, a span past 2**16
RANGES = [(0, 2), (0, 5), (1_000_000, 5_000_000), (0, 1), (0, 3),
          (5, 5), (-7, 9), (0, 1 << 20), (-2 ** 31, 2 ** 31 - 1)]


def _ref_key(seed):
    return jax.random.PRNGKey(np.uint32(seed))


def _key(seed):
    return threefry.prng_key(torch.tensor([seed]))[0]


@pytest.fixture(autouse=True)
def original_layout():
    with jax.threefry_partitionable(False):
        yield


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split(seed):
    k = _key(seed)
    assert np.array_equal(np.asarray(_ref_key(seed)).astype(np.int64),
                          k.numpy())
    for n in (1, 2, 3, 12):
        want = np.asarray(jax.random.split(_ref_key(seed), n))
        got = threefry.split(k, n)
        assert tuple(got.shape) == (n, 2)
        assert np.array_equal(want.astype(np.int64), got.numpy()), n


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_2x32_odd_and_even_counts(seed):
    from jax._src import prng
    key = _ref_key(seed)
    for n in (1, 2, 5, 64, 101):
        counts = np.arange(n, dtype=np.uint32) * np.uint32(2654435761)
        want = np.asarray(prng.threefry_2x32(key, jnp.asarray(counts)))
        got = threefry.threefry_2x32(_key(seed),
                                     torch.from_numpy(counts.astype(
                                         np.int64)))
        assert np.array_equal(want.astype(np.int64), got.numpy()), n


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bit_equal(seed):
    ks = jax.random.split(_ref_key(seed), 12)
    kt = threefry.split(_key(seed), 12)
    for i, shape in enumerate(SHAPES):
        want = np.asarray(jax.random.uniform(ks[i], shape, jnp.float32))
        got = threefry.uniform(kt[i], shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        assert np.array_equal(want.view(np.int32),
                              got.numpy().view(np.int32)), shape
        assert (got >= 0).all() and (got < 1).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_bit_equal(seed):
    ks = jax.random.split(_ref_key(seed), 12)
    kt = threefry.split(_key(seed), 12)
    for i, (lo, hi) in enumerate(RANGES):
        for shape in ((7,), (8, 50)):
            want = np.asarray(jax.random.randint(ks[i % 12], shape, lo, hi,
                                                 jnp.int32))
            got = threefry.randint(kt[i % 12], shape, lo, hi)
            assert got.dtype == torch.int32
            assert np.array_equal(want, got.numpy()), (lo, hi, shape)
    with pytest.raises(ValueError):
        threefry.randint(kt[0], (3,), 0, 2 ** 31)


def test_batched_keys_draw_per_key():
    """A (S, 2) batch of keys draws what each key draws alone."""
    seeds = torch.tensor(SEEDS)
    keys = threefry.prng_key(seeds)
    u = threefry.uniform(keys, (3, 5))
    r = threefry.randint(keys, (9,), 1_000_000, 5_000_000)
    for i, s in enumerate(SEEDS):
        assert torch.equal(u[i], threefry.uniform(_key(s), (3, 5)))
        assert torch.equal(r[i], threefry.randint(_key(s), (9,),
                                                  1_000_000, 5_000_000))


@pytest.mark.parametrize("opts", [
    {"concurrency": 8, "rate": 200.0, "time_limit": 2.0},
    {"concurrency": 5, "rate": 333.0, "time_limit": 0.7,
     "nemesis": ["kill", "partition", "latency"]},
    {"concurrency": 16, "rate": 1000.0, "time_limit": 0.3,
     "nemesis": ["partition"]}])
def test_draw_blocks_equal_reference(opts):
    """All twelve blocks of ``_draw_device`` (every seed at once) and
    the host-scaled ``_draws_jax`` dict equal the reference's."""
    opts = dict(opts, workload="register", nodes=["n1", "n2", "n3"])
    cfg, rcfg = BatchConfig.from_opts(opts), RefBatchConfig.from_opts(opts)
    params = engine_v3._draws_shape_params(cfg)
    assert params == ref_v3._draws_shape_params(rcfg)
    L, O, ncy, nnem = params[:4]
    seeds = [0, 3, 2 ** 32 - 1, 77]
    want = ref_v3._draw_device(np.asarray(seeds, np.uint32), L, O, ncy,
                               nnem)
    got = engine_v3._draw_device(torch.tensor(seeds), L, O, ncy, nnem)
    assert len(got) == len(want) == engine_v3._N_SUBKEYS
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.dtype == {np.dtype(np.float32): torch.float32,
                           np.dtype(np.int32): torch.int32}[w.dtype]
        assert np.array_equal(w.view(np.int32), g.numpy().view(np.int32))
    host = engine_v3._to_host(got)
    assert all(np.array_equal(h, g.numpy()) for h, g in zip(host, got))
    d = engine_v3._draws_jax(cfg, seeds, torch.device("cpu"))
    rd = ref_v3._draws_jax(rcfg, seeds)
    assert sorted(d) == sorted(rd)
    for k in d:
        assert d[k].dtype == rd[k].dtype and np.array_equal(d[k], rd[k]), k
