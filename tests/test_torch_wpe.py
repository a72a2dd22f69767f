"""PyTorch port: WPE dereverberation against the JAX package and the f64
oracle copy on the CPU.

Gates (tests/test_wpe.py): the tap stack to 1e-12; complex128 to 1e-8 of
the largest output, against the JAX package and the oracle copy;
complex64 to 3e-3; the batch form equal to single runs at 1e-10, with
each mixture's activation floor its own; the ``separate`` front.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from overiva_tpu import api as japi
from overiva_tpu.ops import wpe as jwpe
from overiva_tpu_torch import api as tapi
from overiva_tpu_torch import oracle as toracle
from overiva_tpu_torch.ops import wpe as twpe

from helpers import make_mixture

C128 = np.complex128


def _crand(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _ar_reverb_scene(rng, T=80, F=9, M=2, taps=4, delay=2, strength=0.45):
    """Dry STFT D plus AR late reverb X[t] = D[t] + sum_k A_k X[t-delay-k]
    (the model WPE inverts; tests/test_wpe.py). Returns (X, D)."""
    env = 0.15 + rng.random((T, 1, 1)) ** 2
    D = _crand(rng, T, F, M) * env
    A = _crand(rng, taps, F, M, M) * (strength / np.sqrt(taps * M))
    X = np.zeros((T, F, M), complex)
    for t in range(T):
        acc = D[t].copy()
        for k in range(taps):
            if t - delay - k >= 0:
                acc += np.einsum("fnm,fm->fn", A[k], X[t - delay - k])
        X[t] = acc
    return X, D


@pytest.mark.parametrize("T", [11, 3])
def test_delayed_taps_matches_jax_and_oracle(T):
    """Channel-major, tap-minor, zero-padded at t < 0; at T=3 every shift
    reaches past the clip (zero columns)."""
    X = _crand(np.random.default_rng(T), T, 5, 3)
    want = toracle.delayed_taps(X, taps=4, delay=2)
    got = twpe.delayed_taps(torch.from_numpy(X), 4, 2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(jwpe.delayed_taps(jnp.asarray(X), 4, 2)),
                               atol=1e-12)
    # leading batch axes stack each element's taps
    Xb = np.stack([X, 2 * X])
    got_b = twpe.delayed_taps(torch.from_numpy(Xb), 4, 2).numpy()
    np.testing.assert_array_equal(got_b[1], twpe.delayed_taps(torch.from_numpy(2 * X), 4, 2))


@pytest.mark.parametrize("shape", [(60, 9, 2), (40, 7, 4)])
def test_wpe_matches_jax_and_oracle_c128(shape):
    X = _crand(np.random.default_rng(sum(shape)), *shape)
    ref = toracle.wpe(X, taps=3, delay=1, n_iter=2)
    got = tapi.wpe(X, taps=3, delay=1, n_iter=2, dtype=C128, device="cpu")
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(got, ref, atol=1e-8 * scale)
    np.testing.assert_allclose(got, japi.wpe(X, taps=3, delay=1, n_iter=2, dtype=C128),
                               atol=1e-8 * scale)


def test_wpe_c64_close_removes_reverb():
    X, D = _ar_reverb_scene(np.random.default_rng(3))
    ref = toracle.wpe(X, taps=4, delay=2, n_iter=2)
    got = tapi.wpe(X, taps=4, delay=2, n_iter=2, device="cpu")  # complex64 default
    assert got.dtype == np.complex64 and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=3e-3 * np.max(np.abs(ref)))
    assert np.mean(np.abs(got - D) ** 2) < np.mean(np.abs(X - D) ** 2) / 5
    # a tensor in gives a tensor out
    Yt = tapi.wpe(torch.from_numpy(X), taps=4, delay=2, n_iter=2)
    assert isinstance(Yt, torch.Tensor) and Yt.dtype == torch.complex64


def test_wpe_batch_matches_single():
    """Each element of the batch as its single run, at 1e-10: element 0
    has silent frames inside the clip (its activation floor bites there on
    the first pass) and element 1 is 1e3 louder, so a floor taken over the
    whole batch would move element 0 (by 0.37 of its largest value)."""
    rng = np.random.default_rng(4)
    Xs = [_ar_reverb_scene(rng, T=40, F=7, M=2)[0] for _ in range(3)]
    Xs[0][20:26] = 0.0
    Xs[1] *= 1e3
    Xb = np.stack(Xs)
    Yb = tapi.wpe_batch(Xb, taps=3, delay=1, n_iter=2, dtype=C128, device="cpu")
    for b, X in enumerate(Xs):
        Y1 = tapi.wpe(X, taps=3, delay=1, n_iter=2, dtype=C128, device="cpu")
        np.testing.assert_allclose(Yb[b], Y1, atol=1e-10 * np.abs(Y1).max())
    Yj = japi.wpe_batch(Xb, taps=3, delay=1, n_iter=2, dtype=C128)
    np.testing.assert_allclose(Yb, Yj, atol=1e-8 * np.abs(Yj).max())


def test_separate_wpe_front_matches_jax():
    rng = np.random.default_rng(5)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=3, n_samples=6000)
    kw = dict(n_src=2, nfft=256, n_iter=3, dtype=C128)
    y0 = tapi.separate(mix, device="cpu", **kw)
    yw = tapi.separate(mix, wpe={"taps": 4, "n_iter": 2}, device="cpu", **kw)
    assert yw.shape == y0.shape and np.isfinite(yw).all()
    assert not np.allclose(yw, y0)  # the front runs
    yj = japi.separate(mix, wpe={"taps": 4, "n_iter": 2}, **kw)
    np.testing.assert_allclose(yw, yj, atol=1e-8 * np.abs(yj).max())
    # wpe=True runs the defaults (taps 10, delay 3, n_iter 3)
    yt = tapi.separate(mix, wpe=True, algo="iss", device="cpu", **kw)
    np.testing.assert_allclose(yt, japi.separate(mix, wpe=True, algo="iss", **kw),
                               atol=1e-8 * np.abs(yt).max())
    with pytest.raises(ValueError, match="unknown wpe option"):
        tapi.separate(mix, wpe={"tap": 4}, device="cpu", **kw)


def test_validation():
    X = np.zeros((8, 9, 2), complex)
    with pytest.raises(ValueError, match="delay"):
        tapi.wpe(X, delay=0, device="cpu")
    with pytest.raises(ValueError, match="taps"):
        tapi.wpe(X, taps=0, device="cpu")
    with pytest.raises(ValueError, match="taps"):
        tapi.wpe_batch(X[None], taps=0, device="cpu")
    with pytest.raises(ValueError, match="B, T, F, M"):
        tapi.wpe_batch(X, device="cpu")
