"""PyTorch port: the NumPy copy of ``jax.random``'s threefry2x32 generator
(``overiva_tpu_torch/utils/threefry.py``) bit for bit against the installed
``jax.random``, in its default partitionable counter layout.

``separate(algo="fastmnmf"|"fastmnmf2")`` draws its NMF init from
``PRNGKey(0)`` in both packages; these tests hold the draw itself, at
float32 and, under x64, float64.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from overiva_tpu_torch.utils import threefry

SHAPES = [(), (1,), (5,), (3, 4), (8, 65, 2), (2, 3, 7, 5)]


def test_partitionable_layout_is_the_default():
    """The copy is of the partitionable layout: the other one orders the
    counters of ``split`` and of the bits differently."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_keys_and_split(seed):
    key = threefry.prng_key(seed)
    np.testing.assert_array_equal(key, np.asarray(jax.random.PRNGKey(seed)))
    for num in (2, 3, 8):
        got = threefry.split(key, num)
        assert got.dtype == np.uint32 and got.shape == (num, 2)
        np.testing.assert_array_equal(got, np.asarray(jax.random.split(jax.random.PRNGKey(seed), num)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [0, 7])
def test_uniform_bit_for_bit(seed, dtype):
    assert jax.config.jax_enable_x64  # float64 draws need it
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(seed), 3)):
        for shape in SHAPES:
            got = threefry.uniform(np.asarray(key), shape, dtype)
            want = np.asarray(jax.random.uniform(key, shape, dtype))
            assert got.dtype == want.dtype and got.shape == want.shape, (i, shape)
            np.testing.assert_array_equal(got, want)
    bits = jax.random.bits(key, (4, 9), jnp.uint32)
    np.testing.assert_array_equal(threefry.random_bits(np.asarray(key), 32, (4, 9)),
                                  np.asarray(bits))


def test_separate_nmf_draw():
    """The draw of the JAX package's fused FastMNMF branch, M=3 slots,
    F=129, L=2, T=95: (k1, k2) = split(PRNGKey(0)), then uniform + 0.1."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    t1, t2 = threefry.split(threefry.prng_key(0))
    for dtype in (np.float32, np.float64):
        for kj, kt, shape in ((k1, t1, (3, 129, 2)), (k2, t2, (3, 2, 95))):
            want = np.asarray(jax.random.uniform(kj, shape, jnp.dtype(dtype)) + 0.1)
            np.testing.assert_array_equal(threefry.uniform(kt, shape, dtype) + dtype(0.1), want)


def test_refusals():
    with pytest.raises(ValueError, match="seed"):
        threefry.prng_key(-1)
    with pytest.raises(ValueError, match="dtype"):
        threefry.uniform(threefry.prng_key(0), (3,), np.float16)
    with pytest.raises(ValueError, match="bit_width"):
        threefry.random_bits(threefry.prng_key(0), 16, (3,))
