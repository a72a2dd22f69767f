"""PyTorch port: SparseAuxIVA against the JAX package and the f64 oracle
copy on the CPU.

Parity gates: complex128 runs at rtol 1e-6 / atol 1e-9 of the largest
value (tests/test_sparseauxiva.py gates the JAX package at 0.1 dB of the
oracle); S = every bin equals the port's ``auxiva`` exactly; the
``bf16pack`` tier (the JAX package's Pallas kernel in interpret mode) at
complex64 within 1e-4 of the JAX run's norm. Against the oracle copy the
port measured 1.3e-13 of the largest value of W here at the defaults
(``lasso_iter=50``, as ``chip_smoke.py`` phase 8 runs it and scales into
its gate), and up to 3.7e-12 with no polish on Gauss-model outputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from overiva_tpu import api as japi
from overiva_tpu.oracle.sparseauxiva import select_bins as jselect_bins
from overiva_tpu_torch import api as tapi
from overiva_tpu_torch import oracle as toracle
from overiva_tpu_torch.models import sparseauxiva as tsparse
from overiva_tpu_torch.ops import wcov_packed as twp

from helpers import make_mixture, stft_mixture

C128 = np.complex128
# port - oracle at complex128, as a share of max|oracle|, over (Y, W) of
# this file's mixture (measured here: 3.7e-12 at most)
ORACLE_TOL = 1e-11


@pytest.fixture(scope="module")
def X2():
    """2 mics, 2 sources, nfft 256 (F=129, T=126)."""
    rng = np.random.default_rng(11)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=2, n_samples=16000, n_taps=8, snr_db=25)
    return stft_mixture(mix, 256)


def _close(got, want, rtol=1e-6, atol=1e-9):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * np.abs(want).max())


def test_all_bins_is_auxiva(X2):
    S = np.arange(X2.shape[1])
    for dtype in (np.complex64, C128):
        np.testing.assert_array_equal(
            tapi.sparseauxiva(X2, S=S, n_iter=6, dtype=dtype, device="cpu"),
            tapi.auxiva(X2, n_iter=6, dtype=dtype, device="cpu"),
        )
    W0 = np.eye(2) + 0.1 * np.random.default_rng(2).standard_normal((X2.shape[1], 2, 2))
    a = tapi.sparseauxiva(X2, S=S, n_iter=3, W0=W0, return_filters=True, device="cpu")
    b = tapi.auxiva(X2, n_iter=3, W0=W0, return_filters=True, device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize(
    "kw",
    [
        {"n_iter": 10},
        {"n_iter": 6, "n_bins": 0.5, "polish_iter": 0, "model": "gauss", "lasso_iter": 40},
        {"n_iter": 6, "n_bins": 40, "filter_taps": 40, "acausal_taps": 8, "proj_back": False},
    ],
)
def test_api_matches_jax_and_oracle(X2, kw):
    Yt, Wt = tapi.sparseauxiva(X2, return_filters=True, dtype=C128, device="cpu", **kw)
    Yj, Wj = japi.sparseauxiva(X2, return_filters=True, dtype=C128, **kw)
    _close(Wt, Wj)
    _close(Yt, Yj)
    Yo, Wo = toracle.sparseauxiva(X2, return_filters=True, **kw)
    for got, ref in ((Yt, Yo), (Wt, Wo)):
        assert np.abs(got - ref).max() <= ORACLE_TOL * np.abs(ref).max()


def test_select_bins_and_dft_angles(X2):
    """The stratified selection is the oracle's; the DFT angles at nfft
    16384 are the JAX package's integer-mod path to the bit, and far from
    the float32 product path (tests/test_sparseauxiva.py)."""
    F = X2.shape[1]
    for k in (16, 33, F):
        np.testing.assert_array_equal(
            tsparse.select_bins(torch.from_numpy(X2)[None], k)[0], jselect_bins(X2, k))
    nfft, n_causal, n_acausal = 16384, 300, 30
    S = np.sort(np.random.default_rng(0).choice(nfft // 2 + 1, 64, False))
    ang = tsparse.dft_angles(S[None], nfft, n_causal, n_acausal, torch.float32, "cpu")[0].numpy()
    support = jnp.concatenate(
        [jnp.arange(n_causal), jnp.arange(nfft - n_acausal, nfft)]).astype(jnp.int32)
    S_i = jnp.asarray(S, jnp.int32) % nfft
    lo, hi = S_i & 0xFF, S_i >> 8
    prod = ((support[:, None] * hi[None, :]) % nfft * 256 + support[:, None] * lo[None, :]) % nfft
    np.testing.assert_array_equal(ang, np.asarray((-2.0 * jnp.pi / nfft) * prod.astype(jnp.float32)))
    sup64 = np.asarray(support, np.int64)
    exact = (-2.0 * np.pi / nfft) * ((sup64[:, None] * S[None, :]) % nfft)
    assert np.abs(ang - exact).max() < 1e-3
    ang_f32 = (-2.0 * np.pi / nfft) * sup64.astype(np.float32)[:, None] * S.astype(np.float32)
    assert np.abs(np.angle(np.exp(1j * (ang_f32 - exact)))).max() > 1e-3


def test_bf16pack_matches_jax_interpret():
    """Both IP phases through the packed tier: the plain version on the CPU
    against the JAX package's Pallas kernel in interpret mode."""
    rng = np.random.default_rng(7)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=2, n_samples=6000, snr_db=25)
    X = stft_mixture(mix, 128).astype(np.complex64)
    launches = twp.wcov_packed.launches
    Yt = tapi.sparseauxiva(X, n_iter=3, polish_iter=1, wcov="bf16pack", device="cpu")
    Yj = japi.sparseauxiva(X, n_iter=3, polish_iter=1, wcov="bf16pack")
    assert twp.wcov_packed.launches == launches  # CPU: the plain version, no launch
    assert Yt.dtype == np.complex64 and np.isfinite(Yt).all()
    assert np.linalg.norm(Yt - Yj) / np.linalg.norm(Yj) < 1e-4


def test_callback_snapshots(X2):
    """Full-band snapshots of the subset phase, zeros off the subset, each
    the JAX package's."""
    snaps_t, snaps_j = [], []
    tapi.sparseauxiva(X2, n_iter=6, callback=snaps_t.append, callback_every=3, dtype=C128,
                      device="cpu")
    japi.sparseauxiva(X2, n_iter=6, callback=snaps_j.append, callback_every=3, dtype=C128)
    assert len(snaps_t) == len(snaps_j) == 2
    S = jselect_bins(X2, 33)
    off = np.setdiff1d(np.arange(X2.shape[1]), S)
    for a, b in zip(snaps_t, snaps_j):
        assert a.shape == X2.shape and np.abs(a[:, off]).max() == 0.0
        _close(a, b)


def test_batch_matches_jax_and_single_runs(X2):
    Xb = np.stack([X2[:80], 0.5 * X2[40:120]])
    kw = dict(n_iter=5, polish_iter=2, lasso_iter=60, dtype=C128)
    Yb = tapi.sparseauxiva_batch(Xb, device="cpu", **kw)
    assert Yb.shape == Xb.shape
    _close(Yb, japi.sparseauxiva_batch(Xb, **kw))
    for b in range(2):
        _close(Yb[b], tapi.sparseauxiva(Xb[b], device="cpu", **kw), rtol=1e-9, atol=1e-12)
    Yt = tapi.sparseauxiva_batch(torch.from_numpy(Xb), n_iter=3, polish_iter=0, lasso_iter=20,
                                 proj_back=False, dtype=C128)
    assert isinstance(Yt, torch.Tensor)
    Y1 = tapi.sparseauxiva(Xb[1], n_iter=3, polish_iter=0, lasso_iter=20, proj_back=False,
                           dtype=C128, device="cpu")
    _close(Yt[1].numpy(), Y1, rtol=1e-9, atol=1e-12)


def test_validation_probes(X2):
    with pytest.raises(ValueError, match="determined"):
        tapi.sparseauxiva(X2, n_src=1, device="cpu")
    with pytest.raises(ValueError, match="strictly increasing"):
        tapi.sparseauxiva(X2, S=np.array([5, 3, 1]), device="cpu")
    with pytest.raises(ValueError, match="bin indices"):
        tapi.sparseauxiva(X2, S=np.array([0, X2.shape[1]]), device="cpu")
    with pytest.raises(ValueError, match="fractional"):
        tapi.sparseauxiva(X2, n_bins=1.5, device="cpu")
    with pytest.raises(ValueError, match="wcov must be one of"):
        tapi.sparseauxiva(X2, wcov="fp8", device="cpu")
    with pytest.raises(ValueError, match="source model"):
        tapi.sparseauxiva(X2, model="bogus", device="cpu")
    with pytest.raises(ValueError, match="all bins selected"):
        tapi.sparseauxiva_batch(X2[None], n_bins=1.0, device="cpu")
    with pytest.raises(ValueError, match="determined"):
        tapi.sparseauxiva_batch(X2[None], n_src=1, device="cpu")
    with pytest.raises(ValueError, match="B, T, F, M"):
        tapi.sparseauxiva_batch(X2, device="cpu")
