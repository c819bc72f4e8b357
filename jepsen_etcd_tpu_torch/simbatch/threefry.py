"""Threefry-2x32 random draws as PyTorch ops: the part of ``jax.random``
that the epoch-v3 generator (engine_v3.py ``_draw_device``) uses, bit for
bit, in JAX's original (non-partitionable) layout.

The functions take a leading batch of keys, so one call draws for every
seed at once; they are the same code on the CPU and on the card. uint32
words ride in int64 tensors and every add and shift masks back to 32
bits. A key is a ``(..., 2)`` int64 tensor of two uint32 words.

Counterparts in JAX 0.9: ``prng_key`` is ``threefry_seed``
(``jax/_src/prng.py``), ``threefry_2x32`` the hash with its padding of odd
counts (``prng.py:1092``), ``split`` ``_threefry_split_original``
(``prng.py:1150``), ``random_bits`` ``_threefry_random_bits_original``
(``prng.py:1203``), ``uniform`` and ``randint`` ``random._uniform`` and
``random._randint`` (``jax/_src/random.py:435``, ``:581``). With
``jax_threefry_partitionable=True`` (JAX 0.9's default) ``split`` and
``random_bits`` lay out their counters differently and give other bits;
the committed epoch-v3 pins were made with the original layout.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
#: the Threefry key-schedule parity constant
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed_u32: torch.Tensor) -> torch.Tensor:
    """``PRNGKey(seed)`` for 32-bit seeds (values in [0, 2**32)), any
    batch shape -> ``(..., 2)``: the high word is the seed shifted right
    by 32 (0 for a 32-bit seed), the low word the seed."""
    s = seed_u32.to(torch.int64) & M32
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & M32) | (v >> (32 - r))


def _hash(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
          x1: torch.Tensor) -> tuple:
    """Threefry-2x32 with 20 rounds on broadcastable uint32 words
    (``_threefry2x32_lowering``, unrolled)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def threefry_2x32(key: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The Threefry hash of ``counts`` under ``key``: key ``(..., 2)``,
    counts ``(n,)`` or ``(..., n)`` uint32 words -> ``(..., n)``. The
    counts split into a first and a second half (an odd count padded
    with one 0 word), which hash pairwise; the halves' outputs
    concatenate back and the pad drops."""
    n = counts.shape[-1]
    odd = n % 2
    if odd:
        pad = torch.zeros((*counts.shape[:-1], 1), dtype=counts.dtype,
                          device=counts.device)
        counts = torch.cat([counts, pad], dim=-1)
    h = counts.shape[-1] // 2
    k1 = key[..., 0:1]
    k2 = key[..., 1:2]
    y0, y1 = _hash(k1, k2, counts[..., :h], counts[..., h:])
    out = torch.cat([y0, y1], dim=-1)
    return out[..., :n] if odd else out


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.split(key, n)`` in the original layout: the hash of
    ``iota(2n)`` reshaped to ``(..., n, 2)``."""
    bits = threefry_2x32(key, _iota(2 * n, key.device))
    return bits.reshape(*key.shape[:-1], n, 2)


def random_bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """32 random bits per element in the original layout: the hash of
    ``iota(prod(shape))`` -> ``(..., *shape)`` uint32 words in int64."""
    size = math.prod(shape)
    if size >= M32:
        raise ValueError("random_bits draws fewer than 2**32 - 1 words")
    bits = threefry_2x32(key, _iota(size, key.device))
    return bits.reshape(*key.shape[:-1], *shape)


def uniform(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` on [0, 1): the top 23
    bits as the mantissa of a float in [1, 2), minus 1."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return torch.clamp_min(fbits.view(torch.float32) - 1.0, 0.0)


def randint(key: torch.Tensor, shape: tuple, lo: int, hi: int) \
        -> torch.Tensor:
    """``jax.random.randint(key, shape, lo, hi, int32)``: two 32-bit draws
    (from the key's two split halves) folded into ``[lo, hi)`` modulo
    the span, with JAX's uint32 wrap-around arithmetic."""
    lo, hi = int(lo), int(hi)
    if not (-2 ** 31 <= lo and hi <= 2 ** 31 - 1):
        raise ValueError("randint takes int32 bounds")
    keys = split(key, 2)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    span = 1 if hi <= lo else (hi - lo) & M32
    mult = (2 ** 16) % span
    mult = ((mult * mult) & M32) % span
    off = (((higher % span) * mult) & M32) + (lower % span)
    off = (off & M32) % span
    out = (lo + off + 2 ** 31) % 2 ** 32 - 2 ** 31
    return out.to(torch.int32)
