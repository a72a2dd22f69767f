"""PyTorch port: AuxIVA-ISS / OverIVA-ISS against the JAX package on the
CPU.

Parity gate: complex128, rtol 1e-6 (tests/test_overiva_iss.py,
tests/test_auxiva_iss.py); one epoch from the same state at rtol 1e-8.
ISS carries (W, Y) across callback chunks, so a chunked run equals an
unchunked one exactly.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overiva_tpu import api as japi
from overiva_tpu.models import auxiva_iss as jiss
from overiva_tpu_torch import api as tapi
from overiva_tpu_torch.models import auxiva_iss as tiss
from overiva_tpu_torch.utils.convert import state_to_numpy, state_to_torch

from helpers import make_mixture, stft_mixture

C128 = np.complex128


@pytest.fixture(scope="module")
def X5():
    """5 mics, 2 sources, nfft 128 (F=65, T=126)."""
    rng = np.random.default_rng(61)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=5, n_samples=8000, snr_db=20)
    return stft_mixture(mix, nfft=128)


def _case(X5, M):
    return X5[:, :, :M]


@pytest.mark.parametrize("M,N", [(2, 2), (5, 2), (4, 4)])
def test_iss_epoch_matches_jax(M, N):
    rng = np.random.default_rng(M * 10 + N)
    T, F = 40, 9
    X = rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))
    W = np.eye(M) + 0.3 * (rng.standard_normal((F, M, M)) + 1j * rng.standard_normal((F, M, M)))
    Y = np.einsum("fnm,tfm->tfn", W, X)
    Wj, Yj = jax.jit(partial(jiss._iss_epoch, model="laplace", n_src=N))(
        jnp.asarray(X), (jnp.asarray(W), jnp.asarray(Y))
    )
    s = state_to_torch({"W": W, "Y": Y}, "cpu", C128)
    Wt, Yt = tiss._iss_epoch(s["W"], s["Y"], "laplace", N)
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("model", ["laplace", "gauss"])
@pytest.mark.parametrize("M,N", [(2, 2), (5, 2), (4, 4)])
def test_api_matches_jax(X5, M, N, model):
    X = _case(X5, M)
    fn_t, fn_j = (tapi.auxiva_iss, japi.auxiva_iss) if N == M else (
        tapi.overiva_iss, japi.overiva_iss)
    Yt, Wt = fn_t(X, n_src=N, n_iter=10, model=model, return_filters=True, dtype=C128,
                  device="cpu")
    Yj, Wj = fn_j(X, n_src=N, n_iter=10, model=model, return_filters=True, dtype=C128)
    assert isinstance(Yt, np.ndarray) and Yt.shape == (X.shape[0], X.shape[1], N)
    assert Wt.shape == (X.shape[1], M, M)
    np.testing.assert_allclose(Wt, Wj, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(Yt, Yj, rtol=1e-6, atol=1e-8)


def test_overiva_iss_at_full_rank_is_auxiva_iss(X5):
    X = _case(X5, 4)
    a = tapi.auxiva_iss(X, n_iter=6, return_filters=True, dtype=C128, device="cpu")
    o = tapi.overiva_iss(X, n_src=4, n_iter=6, return_filters=True, dtype=C128, device="cpu")
    for x, y in zip(a, o):
        np.testing.assert_array_equal(x, y)


def test_callback_parity_across_chunks(X5):
    """Snapshots every 10 epochs equal the JAX package's; the chunked run
    carries (W, Y) and ends exactly where the unchunked one does."""
    snaps_t, snaps_j = [], []
    Yt = tapi.overiva_iss(X5, n_src=2, n_iter=21, callback=snaps_t.append, dtype=C128,
                          device="cpu")
    japi.overiva_iss(X5, n_src=2, n_iter=21, callback=snaps_j.append, dtype=C128)
    assert len(snaps_t) == len(snaps_j) == 3
    for a, b in zip(snaps_t, snaps_j):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)
    np.testing.assert_array_equal(
        Yt, tapi.overiva_iss(X5, n_src=2, n_iter=21, dtype=C128, device="cpu")
    )


@pytest.mark.parametrize("rows", [False, True])
def test_w0_round_trip(X5, rows):
    """A JAX run's filters, through utils/convert, start both packages'
    next runs: the full (F, M, M) W, or its (F, N, M) target rows placed
    into the identity."""
    _, Wj = japi.overiva_iss(X5, n_src=2, n_iter=4, return_filters=True, dtype=C128)
    W0 = Wj[:, :2, :] if rows else Wj
    s = state_to_torch({"X": X5, "W0": W0}, "cpu", C128)
    Yt, Wt = tapi.overiva_iss(s["X"], n_src=2, n_iter=3, W0=s["W0"], return_filters=True,
                              dtype=C128)
    assert isinstance(Yt, torch.Tensor)
    Yj, Wj3 = japi.overiva_iss(X5, n_src=2, n_iter=3, W0=W0, return_filters=True, dtype=C128)
    back = state_to_numpy({"Y": Yt, "W": Wt, "W0": s["W0"]})
    np.testing.assert_array_equal(back["W0"], W0)
    np.testing.assert_allclose(back["W"], Wj3, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(back["Y"], Yj, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("N", [2, 4])
def test_iss_batch_matches_jax_and_per_clip(X5, N):
    Xb = np.stack([X5[:60, :, :4], X5[50:110, :, :4]])
    Yt = tapi.overiva_iss_batch(Xb, N, n_iter=6, dtype=C128, device="cpu")
    Yj = japi.overiva_iss_batch(Xb, N, n_iter=6, dtype=C128)
    assert Yt.shape == (2, 60, X5.shape[1], N)
    np.testing.assert_allclose(Yt, Yj, rtol=1e-6, atol=1e-8)
    for b in range(2):
        Y1 = tapi.overiva_iss(Xb[b], n_src=N, n_iter=6, dtype=C128, device="cpu")
        np.testing.assert_allclose(Yt[b], Y1, rtol=1e-9, atol=1e-12)
    if N == 4:
        np.testing.assert_array_equal(
            tapi.auxiva_iss_batch(Xb, n_iter=6, dtype=C128, device="cpu"), Yt
        )
    Yn = tapi.auxiva_iss_batch(Xb, n_src=N, n_iter=6, proj_back=False, dtype=C128, device="cpu")
    np.testing.assert_allclose(
        Yn, japi.auxiva_iss_batch(Xb, n_src=N, n_iter=6, proj_back=False, dtype=C128),
        rtol=1e-6, atol=1e-8,
    )


def test_separate_iss_matches_jax():
    rng = np.random.default_rng(62)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=3, n_samples=6000)
    for N in (2, 3):
        yt = tapi.separate(mix, n_src=N, nfft=128, n_iter=5, algo="iss", dtype=C128,
                           device="cpu")
        yj = japi.separate(mix, n_src=N, nfft=128, n_iter=5, algo="iss", dtype=C128)
        assert yt.shape == (mix.shape[0], N)
        np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-8)


def test_validation_probes():
    X = np.zeros((8, 5, 3), dtype=np.complex64)
    with pytest.raises(ValueError, match="determined"):
        tapi.auxiva_iss(X, n_src=2, device="cpu")
    for n_src in (0, 4):
        with pytest.raises(ValueError, match="n_src"):
            tapi.overiva_iss(X, n_src=n_src, device="cpu")
        with pytest.raises(ValueError, match="n_src"):
            tapi.auxiva_iss_batch(X[None], n_src=n_src, device="cpu")
    with pytest.raises(ValueError, match="source model"):
        tapi.overiva_iss(X, n_src=2, model="bogus", device="cpu")
    with pytest.raises(ValueError, match="B, T, F, M"):
        tapi.overiva_iss_batch(X, 2, device="cpu")
