"""PyTorch port: ILRMA-T (joint dereverberation + ILRMA by source steering)
against the JAX package and the f64 oracle copy on the CPU.

Gates (tests/test_ilrma_t.py): one epoch from the same state at rtol
1e-8; runs at complex128, rtol 1e-6 / atol 1e-8; the batch form, with an
explicit batch axis and per-element ``seeds``, equal to single runs at
1e-8; validation and the callback cadence; ``separate(algo="ilrma_t")``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overiva_tpu import api as japi
from overiva_tpu.models import ilrma_t as jilrma_t
from overiva_tpu_torch import api as tapi
from overiva_tpu_torch import oracle as toracle
from overiva_tpu_torch.models import ilrma_t as tilrma_t
from overiva_tpu_torch.oracle.ilrma_t import ilrma_t_loglik

from helpers import make_mixture, stft_mixture

C128 = np.complex128


@pytest.fixture(scope="module")
def X2():
    """2 mics, 2 sources, a 150-tap room, nfft 128 (F=65, T=188)."""
    rng = np.random.default_rng(37)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=2, n_samples=12000, n_taps=150, snr_db=25)
    return stft_mixture(mix, nfft=128).astype(C128)


@pytest.mark.parametrize("taps", [2, 0])
def test_epoch_matches_jax(taps):
    rng = np.random.default_rng(30 + taps)
    T, F, M, K = 30, 9, 3, 2
    X = rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))
    Xt = np.concatenate([X, toracle.delayed_taps(X, taps, 1)], axis=2) if taps else X
    P = np.zeros((F, M, Xt.shape[2]), complex)
    P[:, :, :M] = np.eye(M)
    P += 0.2 * (rng.standard_normal(P.shape) + 1j * rng.standard_normal(P.shape))
    Y = np.einsum("fnj,tfj->tfn", P, Xt)
    B = rng.random((M, F, K)) + 0.1
    H = rng.random((M, K, T)) + 0.1
    want = jax.jit(jilrma_t._ilrma_t_epoch, static_argnames="n_chan")(
        jnp.asarray(Xt), tuple(jnp.asarray(a) for a in (P, Y, B, H)), n_chan=M)
    got = tilrma_t._ilrma_t_epoch(*(torch.from_numpy(a)[None] for a in (Xt, P, Y, B, H)), M)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), rtol=1e-8, atol=1e-12)


def test_api_matches_jax_and_oracle_c128(X2):
    kw = dict(taps=3, delay=2, n_iter=6, seed=3, return_filters=True)
    Yt, Pt = tapi.ilrma_t(X2, dtype=C128, device="cpu", **kw)
    Yj, Pj = japi.ilrma_t(X2, dtype=C128, **kw)
    Yo, Po = toracle.ilrma_t(X2, **kw)
    assert Yt.shape == X2.shape and Pt.shape == (X2.shape[1], 2, 8)
    for want in ((Yj, Pj), (Yo, Po)):
        np.testing.assert_allclose(Pt, want[1], rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(Yt, want[0], rtol=1e-6, atol=1e-8)


def test_w0_and_loglik_descent(X2):
    """A W0 start (the oracle's P) continues as the JAX package does; the
    exact negative log-likelihood of the oracle copy descends over the
    port's epochs (the oracle's B, H at the same epoch: the NMF updates do
    not depend on the steering's rounding at this tolerance)."""
    kw = dict(taps=2, delay=1, seed=1, proj_back=False)
    _, P0 = toracle.ilrma_t(X2, n_iter=2, return_filters=True, **kw)
    kw0 = dict(kw, n_iter=2, W0=P0)
    np.testing.assert_allclose(tapi.ilrma_t(X2, dtype=C128, device="cpu", **kw0),
                               japi.ilrma_t(X2, dtype=C128, **kw0), rtol=1e-6, atol=1e-8)
    lls = []
    for n in range(1, 5):
        _, P = tapi.ilrma_t(X2, n_iter=n, return_filters=True, dtype=C128, device="cpu", **kw)
        _, _, (B, H) = toracle.ilrma_t(X2, n_iter=n, return_filters=True, return_nmf=True, **kw)
        lls.append(ilrma_t_loglik(X2, P, B, H, 2, 1))
    assert all(b <= a + 1e-6 for a, b in zip(lls, lls[1:])), lls


def test_batch_matches_single(X2):
    Xb = np.stack([X2, 0.8 * X2[::-1]])
    kw = dict(taps=2, delay=1, n_iter=4, dtype=C128)
    Yb = tapi.ilrma_t_batch(Xb, seed=9, device="cpu", **kw)
    for b in range(2):
        Y1 = tapi.ilrma_t(Xb[b], seed=9 + b, device="cpu", **kw)
        np.testing.assert_allclose(Yb[b], Y1, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(Yb, japi.ilrma_t_batch(Xb, seed=9, **kw), rtol=1e-6, atol=1e-8)
    Ys = tapi.ilrma_t_batch(torch.from_numpy(Xb), seeds=[5, 5], **kw)
    assert isinstance(Ys, torch.Tensor)
    for b in range(2):
        Y1 = tapi.ilrma_t(Xb[b], seed=5, device="cpu", **kw)
        np.testing.assert_allclose(Ys[b].numpy(), Y1, rtol=1e-8, atol=1e-10)


def test_validation_and_callback(X2):
    with pytest.raises(ValueError, match="determined"):
        tapi.ilrma_t(X2, n_src=1, device="cpu")
    with pytest.raises(ValueError, match="delay"):
        tapi.ilrma_t(X2, taps=2, delay=0, device="cpu")
    with pytest.raises(ValueError, match="determined"):
        tapi.ilrma_t_batch(X2[None], n_src=1, device="cpu")
    with pytest.raises(ValueError, match="batch length"):
        tapi.ilrma_t_batch(np.stack([X2, X2]), seeds=[1], device="cpu")
    with pytest.raises(ValueError, match="B, T, F, M"):
        tapi.ilrma_t_batch(X2, device="cpu")
    kw = dict(taps=2, delay=1, n_iter=11, dtype=C128, seed=3)
    snaps_t, snaps_j = [], []
    Yt = tapi.ilrma_t(X2, callback=snaps_t.append, callback_every=5, device="cpu", **kw)
    japi.ilrma_t(X2, callback=snaps_j.append, callback_every=5, **kw)
    assert len(snaps_t) == len(snaps_j) == 3
    for a, b in zip(snaps_t, snaps_j):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)
    np.testing.assert_array_equal(Yt, tapi.ilrma_t(X2, device="cpu", **kw))


def test_separate_matches_jax():
    """The JAX package's ``PRNGKey(0)`` init from the threefry copy. With
    n_src < n_chan the most energetic outputs are kept, but the unit-power
    renormalization ties every output's energy to the last bit, so which
    ones is rounding's choice (in the JAX package too): there each kept
    output is held to one of the n_chan outputs."""
    rng = np.random.default_rng(49)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=3, n_samples=6000, snr_db=25)
    kw = dict(nfft=256, hop=128, n_iter=4, algo="ilrma_t", taps=2, delay=1, dtype=C128)
    y3 = tapi.separate(mix, n_src=3, device="cpu", **kw)
    assert y3.shape == (6000, 3) and np.isfinite(y3).all()
    yj = japi.separate(mix, n_src=3, **kw)
    np.testing.assert_allclose(y3, yj, atol=1e-8 * np.abs(yj).max())
    y2 = tapi.separate(mix, n_src=2, device="cpu", **kw)
    for k in range(2):
        d = [np.abs(y2[:, k] - y3[:, j]).max() for j in range(3)]
        assert min(d) <= 1e-10 * np.abs(y3).max(), d
