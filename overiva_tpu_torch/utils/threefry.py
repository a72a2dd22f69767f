"""NumPy copy of ``jax.random``'s default generator (threefry2x32).

``separate(algo="fastmnmf"|"fastmnmf2")`` in the JAX package draws its NMF
init from ``jax.random.PRNGKey(0)``; the port cannot import JAX, so it
draws the same numbers here. Only what that draw needs is copied:
:func:`prng_key`, :func:`split` and :func:`uniform`, for float32 and
float64, in the counter layout of ``jax_threefry_partitionable=True`` (the
default since jax 0.5): the counters of an output of shape ``shape`` are
the 64-bit row-major indices ``0 .. prod(shape) - 1``, split into their
high and low 32-bit words, and both words of the hash are used (``split``
stacks them; 32-bit ``random_bits`` XORs them, 64-bit joins them).
``tests/test_torch_threefry.py`` holds each function bit for bit against
the installed ``jax.random``.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["prng_key", "random_bits", "split", "threefry2x32", "uniform"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, d):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter words (x0, x1)
    under ``key`` (2,) uint32; the words wrap modulo 2**32."""
    x0 = np.array(x0, dtype=np.uint32, ndmin=1)
    x1 = np.array(x1, dtype=np.uint32, ndmin=1)
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3]
            x1 = x1 + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**63): the two 32-bit
    words of the seed, high word first."""
    seed = int(seed)
    if not 0 <= seed < 2**63:
        raise ValueError(f"seed must be in [0, 2**63), got {seed}")
    return np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=np.uint32)


def _counters(shape):
    n = math.prod(shape)
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), idx.astype(np.uint32)


def split(key, num: int = 2):
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    b0, b1 = threefry2x32(key, *_counters((int(num),)))
    return np.stack([b0, b1], axis=-1)


def random_bits(key, bit_width: int, shape):
    """Uniform random 32- or 64-bit words of ``shape``."""
    shape = tuple(int(s) for s in shape)
    b0, b1 = threefry2x32(key, *_counters(shape))
    if bit_width == 32:
        bits = b0 ^ b1
    elif bit_width == 64:
        bits = (b0.astype(np.uint64) << np.uint64(32)) | b1.astype(np.uint64)
    else:
        raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")
    return bits.reshape(shape)


def uniform(key, shape, dtype=np.float32):
    """``jax.random.uniform(key, shape, dtype)`` on [0, 1): the mantissa
    bits of a float in [1, 2) drawn at random, minus 1. (Other ranges are
    not copied: XLA may fuse their scale and shift into one rounding.)"""
    dtype = np.dtype(dtype)
    if dtype not in (np.float32, np.float64):
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    nbits, nmant = dtype.itemsize * 8, np.finfo(dtype).nmant
    uint = np.uint32 if nbits == 32 else np.uint64
    bits = random_bits(key, nbits, shape)
    bits = (bits >> uint(nbits - nmant)) | np.array(1.0, dtype).view(uint)
    return bits.view(dtype) - dtype.type(1.0)
