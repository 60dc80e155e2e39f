"""Threefry2x32 keys and uniform draws, bit-equal to ``jax.random``.

The JAX package draws the noise of stochastic gradient rounding
(``quantize_gradients``) from ``jax.random`` threefry keys, so the port
needs the same bits to train the same quantized trees.  This module is
the port's own threefry2x32-20 (Salmon et al., "Parallel random numbers:
as easy as 1, 2, 3", SC 2011), with JAX's key derivation and bit layout
(``jax/_src/prng.py``: ``threefry_seed``, ``_threefry_fold_in``,
``threefry_2x32``, ``iota_2x32_shape``, the two ``_threefry_random_bits``
variants; ``jax/_src/random.py``: ``_uniform``):

- ``prng_key(seed)``: the ``jax.random.PRNGKey`` of an integer seed, a
  pair of uint32 words ``(seed >> 32, seed & 0xFFFFFFFF)`` (a seed that
  fits int32 gives ``(0, seed mod 2**32)``);
- ``fold_in(key, data)``: ``threefry2x32(key, (0, data))``;
- ``random_bits(key, shape)``: 32-bit words.  With JAX's
  ``jax_threefry_partitionable`` (the default since JAX 0.5) element i
  of the flattened shape is ``y1 ^ y2`` of ``threefry2x32(key, (i >> 32,
  i & 0xFFFFFFFF))``; without it the counters ``0..m-1`` (padded to even
  length) are split into halves that form the pairs, and the two output
  halves are concatenated;
- ``uniform(key, shape)``: f32 in [0, 1), ``bitcast((bits >> 9) |
  0x3F800000) - 1``;
- ``split(key, num)``: ``jax.random.split``.  Partitionable, key i is
  ``threefry2x32(key, (0, i))`` (the fold-in of i); otherwise the
  counters ``0..2 num - 1`` are split into halves that form the pairs,
  and the concatenated output words are read in pairs.

Keys are tuples of two Python ints, or a batch of keys: an int64
tensor [N, 2] of uint32 words, for which ``fold_in`` takes one datum
per key (or one for all) and ``random_bits``/``uniform`` draw [N,
*shape], key by key what the single-key draw gives (the grower's
per-node keys, one vectorised call per round).  Draws are plain PyTorch
on the device of the caller's choosing: torch has few operations on
uint32, so the words live in int64 tensors, masked to 32 bits after
every add and shift.  ``PARTITIONABLE`` selects the variant the trainer draws
with; it matches JAX's default, and tests set it from
``jax.config.jax_threefry_partitionable``.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

MASK = 0xFFFFFFFF
PARTITIONABLE = True
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Union[Tuple[int, int], torch.Tensor]
Word = Union[int, torch.Tensor]


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(key: Key, x1: Word, x2: Word) -> Tuple[Word, Word]:
    """Threefry2x32 with 20 rounds of the counter pair ``(x1, x2)``
    (Python ints or int64 tensors holding uint32 values) under ``key``
    (two words, ints or tensors that broadcast against the counters);
    returns the pair of output words, masked to 32 bits."""
    k1, k2 = key
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & MASK
    return x[0], x[1]


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``.  JAX without x64 holds a seed that
    fits int32 as int32, so its high word is 0 and the low word is the
    seed modulo 2**32."""
    seed = int(seed)
    if -(1 << 31) <= seed < (1 << 31):
        return 0, seed & MASK
    return (seed >> 32) & MASK, seed & MASK


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in(key, data)`` (``data`` taken as uint32).  For
    a batch of keys [N, 2] (or [1, 2]), ``data`` is an int or an integer
    tensor [N] (one datum per key); returns the [N, 2] folded keys."""
    if not isinstance(key, torch.Tensor):
        return threefry2x32(key, 0, int(data) & MASK)
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    k1, k2, d = torch.broadcast_tensors(key[:, 0], key[:, 1], d)
    y1, y2 = threefry2x32((k1, k2), torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=1)


def key_tensor(key: Key, device=None) -> torch.Tensor:
    """One key as a batch of one, [1, 2] int64."""
    return torch.tensor([[int(key[0]), int(key[1])]], dtype=torch.int64,
                        device=device)


def random_bits(key: Key, shape: Sequence[int], device=None,
                partitionable: bool = None) -> torch.Tensor:
    """32-bit random words of ``shape`` (int64 tensor of uint32 values);
    [N, *shape] for a batch of keys [N, 2]."""
    if partitionable is None:
        partitionable = PARTITIONABLE
    shape = tuple(int(s) for s in shape)
    m = 1
    for s in shape:
        m *= s
    batch = isinstance(key, torch.Tensor)
    if batch:
        device = key.device
        key = (key[:, 0:1], key[:, 1:2])
        out_shape = (key[0].shape[0],) + shape
    else:
        out_shape = shape
    if partitionable:
        i = torch.arange(m, dtype=torch.int64, device=device)
        y1, y2 = threefry2x32(key, i >> 32, i & MASK)
        return (y1 ^ y2).reshape(out_shape)
    if m >= MASK:
        raise NotImplementedError("the non-partitionable draw of 2**32 - 1 "
                                  "words or more is not ported")
    half = (m + 1) // 2
    counts = torch.arange(2 * half, dtype=torch.int64, device=device)
    counts[m:] = 0                                   # the odd-size pad
    y1, y2 = threefry2x32(key, counts[:half], counts[half:])
    return torch.cat([y1, y2], dim=-1)[..., :m].reshape(out_shape)


def uniform(key: Key, shape: Sequence[int], device=None,
            partitionable: bool = None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: f32 in [0, 1) ([N, *shape]
    for a batch of keys [N, 2])."""
    bits = random_bits(key, shape, device, partitionable)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def split(key: Key, num: int = 2, partitionable: bool = None) -> list:
    """``jax.random.split(key, num)``: a list of ``num`` keys (pairs of
    ints)."""
    if partitionable is None:
        partitionable = PARTITIONABLE
    num = int(num)
    if partitionable:
        return [threefry2x32(key, 0, i) for i in range(num)]
    counts = list(range(2 * num))
    pairs = [threefry2x32(key, counts[i], counts[num + i])
             for i in range(num)]
    words = [p[0] for p in pairs] + [p[1] for p in pairs]
    return [(words[2 * i], words[2 * i + 1]) for i in range(num)]
