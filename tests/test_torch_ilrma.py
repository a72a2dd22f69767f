"""PyTorch port: ILRMA against the JAX package on the CPU.

Parity gates (tests/test_ilrma.py): one epoch from the same state at
complex128, rtol 1e-8; runs at complex128, rtol 1e-6 / atol 1e-9; the bf16
tier at complex64 within 1e-4 of the JAX run's norm. The batch form keeps a
leading batch axis (the activations and the rescale sum over each
mixture's own bins), and each element equals its single-clip run.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overiva_tpu import api as japi
from overiva_tpu.models import ilrma as jilrma
from overiva_tpu_torch import api as tapi
from overiva_tpu_torch import oracle as toracle
from overiva_tpu_torch.models import ilrma as tilrma

from helpers import make_mixture, stft_mixture

C128 = np.complex128


@pytest.fixture(scope="module")
def X3():
    """3 mics, 2 sources, nfft 256 (F=129, T=95)."""
    rng = np.random.default_rng(31)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=3, n_samples=12000, snr_db=25)
    return stft_mixture(mix, nfft=256)


def test_epoch_matches_jax():
    rng = np.random.default_rng(3)
    T, F, M, K = 30, 9, 3, 2
    X = rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))
    W = np.eye(M) + 0.3 * (rng.standard_normal((F, M, M)) + 1j * rng.standard_normal((F, M, M)))
    B = rng.random((M, F, K)) + 0.1
    H = rng.random((M, K, T)) + 0.1
    Wj, Bj, Hj = jax.jit(jilrma._ilrma_epoch)(
        jnp.asarray(X), (jnp.asarray(W), jnp.asarray(B), jnp.asarray(H))
    )
    Wt, Bt, Ht = tilrma._ilrma_epoch(*(torch.from_numpy(a)[None] for a in (X, W, B, H)))
    for got, want in ((Wt, Wj), (Bt, Bj), (Ht, Hj)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("wcov", ["f32", "f32x3"])
def test_api_matches_jax(X3, wcov):
    Yt, Wt = tapi.ilrma(X3, n_iter=8, seed=3, return_filters=True, dtype=C128, wcov=wcov,
                        device="cpu")
    Yj, Wj = japi.ilrma(X3, n_iter=8, seed=3, return_filters=True, dtype=C128, wcov=wcov)
    assert isinstance(Yt, np.ndarray) and Yt.shape == X3.shape and Wt.shape == Wj.shape
    np.testing.assert_allclose(Wt, Wj, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(Yt, Yj, rtol=1e-6, atol=1e-9)


def test_api_matches_oracle_and_w0(X3):
    """The f64 oracle copy at the JAX package's gate, and a W0 start (the
    oracle's filters) that both packages continue alike."""
    Yt, Wt = tapi.ilrma(X3, n_iter=6, seed=4, return_filters=True, dtype=C128, device="cpu")
    Yo, Wo = toracle.ilrma(X3, n_iter=6, seed=4, return_filters=True)
    np.testing.assert_allclose(Wt, Wo, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(Yt, Yo, rtol=1e-6, atol=1e-9)
    kw = dict(n_iter=3, seed=1, W0=Wo, proj_back=False, dtype=C128)
    np.testing.assert_allclose(tapi.ilrma(X3, **kw, device="cpu"), japi.ilrma(X3, **kw),
                               rtol=1e-6, atol=1e-9)


def test_bf16_tier_matches_jax(X3):
    X = X3.astype(np.complex64)
    Yt = tapi.ilrma(X, n_iter=6, wcov="bf16", device="cpu")
    Yj = japi.ilrma(X, n_iter=6, wcov="bf16")
    assert Yt.dtype == np.complex64 and np.isfinite(Yt).all()
    assert np.linalg.norm(Yt - Yj) / np.linalg.norm(Yj) < 1e-4


def test_callback_cadence(X3):
    """21 epochs, a callback every 10: 3 projection-back-scaled snapshots,
    each the JAX package's, and the chunked run ends where the unchunked
    one does."""
    snaps_t, snaps_j = [], []
    Yt = tapi.ilrma(X3, n_iter=21, callback=snaps_t.append, dtype=C128, device="cpu")
    japi.ilrma(X3, n_iter=21, callback=snaps_j.append, dtype=C128)
    assert len(snaps_t) == len(snaps_j) == 3
    for a, b in zip(snaps_t, snaps_j):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(Yt, tapi.ilrma(X3, n_iter=21, dtype=C128, device="cpu"))


def test_batch_matches_jax_and_single_runs(X3):
    Xb = np.stack([X3[:60], 0.5 * X3[30:90]])
    Yb = tapi.ilrma_batch(Xb, n_iter=5, seed=9, dtype=C128, device="cpu")
    assert Yb.shape == Xb.shape
    np.testing.assert_allclose(Yb, japi.ilrma_batch(Xb, n_iter=5, seed=9, dtype=C128),
                               rtol=1e-6, atol=1e-9)
    for b in range(2):
        Y1 = tapi.ilrma(Xb[b], n_iter=5, seed=9 + b, dtype=C128, device="cpu")
        np.testing.assert_allclose(Yb[b], Y1, rtol=1e-9, atol=1e-12)
    Ys = tapi.ilrma_batch(torch.from_numpy(Xb), n_iter=3, seeds=[5, 5], proj_back=False,
                          dtype=C128)
    assert isinstance(Ys, torch.Tensor)
    for b in range(2):
        Y1 = tapi.ilrma(Xb[b], n_iter=3, seed=5, proj_back=False, dtype=C128, device="cpu")
        np.testing.assert_allclose(Ys[b].numpy(), Y1, rtol=1e-9, atol=1e-12)


def test_validation_probes():
    X = np.zeros((8, 5, 3), dtype=np.complex64)
    with pytest.raises(ValueError, match="determined"):
        tapi.ilrma(X, n_src=2, device="cpu")
    with pytest.raises(ValueError, match="determined"):
        tapi.ilrma_batch(X[None], n_src=2, device="cpu")
    for fn, arg in ((tapi.ilrma, X), (tapi.ilrma_batch, X[None])):
        with pytest.raises(ValueError, match="bf16pack"):
            fn(arg, wcov="bf16pack", device="cpu")
        with pytest.raises(ValueError, match="wcov must be one of"):
            fn(arg, wcov="fp8", device="cpu")
    with pytest.raises(ValueError, match="batch length"):
        tapi.ilrma_batch(np.stack([X, X]), seeds=[1], device="cpu")
    with pytest.raises(ValueError, match="B, T, F, M"):
        tapi.ilrma_batch(X, device="cpu")
