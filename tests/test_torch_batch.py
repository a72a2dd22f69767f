"""PyTorch port: the batch entry points, PCA + AuxIVA (IP, ISS and IP2
inside) and the ``f32x3`` tier against the JAX package on the CPU.

Parity gate: complex128, rtol 1e-6 (tests/test_jax_parity.py). A batched
result also equals the per-clip result of the port to f64 rounding
(rtol 1e-9): the batch is written out, so only summation order differs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from overiva_tpu import api as japi
from overiva_tpu.metrics import BssEvalReferences
from overiva_tpu.ops import covariance as jcov
from overiva_tpu.oracle import synthesis
from overiva_tpu_torch import api as tapi
from overiva_tpu_torch.models import auxiva_pca as tpca
from overiva_tpu_torch.ops import covariance as tcov

from helpers import make_mixture, stft_mixture

C128 = np.complex128


def _stft_batch(seed, B=2, T=40, F=17, M=4):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, T, F, M)) + 1j * rng.standard_normal((B, T, F, M))


@pytest.mark.parametrize(
    "model,init_eig,proj_back", [("laplace", False, True), ("gauss", True, False)]
)
def test_overiva_batch_matches_jax_and_per_clip(model, init_eig, proj_back):
    X = _stft_batch(5)
    kw = dict(n_src=2, n_iter=6, model=model, init_eig=init_eig, proj_back=proj_back)
    Yt = tapi.overiva_batch(X, dtype=C128, **kw, device="cpu")
    Yj = japi.overiva_batch(X, dtype=C128, **kw)
    assert isinstance(Yt, np.ndarray) and Yt.shape == (2, 40, 17, 2) and Yt.dtype == C128
    np.testing.assert_allclose(Yt, Yj, rtol=1e-6, atol=1e-8)
    for b in range(X.shape[0]):
        Y1 = tapi.overiva(
            X[b], n_src=2, n_iter=6, model=model, init_eig=init_eig,
            proj_back=proj_back, dtype=C128, device="cpu",
        )
        np.testing.assert_allclose(Yt[b], Y1, rtol=1e-9, atol=1e-12)


def test_overiva_batch_tensor_in_and_probes():
    X = torch.from_numpy(_stft_batch(6, B=3, T=24, F=9, M=3))
    Y = tapi.overiva_batch(X, n_src=3, n_iter=3)  # determined: AuxIVA
    assert isinstance(Y, torch.Tensor) and Y.dtype == torch.complex64
    assert Y.shape == (3, 24, 9, 3) and torch.isfinite(Y).all()
    with pytest.raises(ValueError, match="B, T, F, M"):
        tapi.overiva_batch(X[0], n_src=2)
    with pytest.raises(ValueError, match="n_src"):
        tapi.overiva_batch(X, n_src=4)
    with pytest.raises(ValueError, match="source model"):
        tapi.overiva_batch(X, n_src=2, model="bogus")


def test_stft_batch_forms_match_jax_and_per_clip():
    rng = np.random.default_rng(8)
    nfft, hop = 256, 128
    x = rng.standard_normal((3, 3000, 2))
    Xt = tapi.stft_analysis_batch(x, nfft, dtype=C128, device="cpu")
    Xj = japi.stft_analysis_batch(x, nfft, dtype=C128)
    assert Xt.shape == Xj.shape == (3, 22, nfft // 2 + 1, 2)
    np.testing.assert_allclose(Xt, Xj, rtol=1e-6, atol=1e-9)
    for b in range(3):
        np.testing.assert_allclose(
            Xt[b], tapi.stft_analysis(x[b], nfft, dtype=C128, device="cpu"),
            rtol=1e-12, atol=1e-12,
        )
    mono = tapi.stft_analysis_batch(x[:, :, 0], nfft, dtype=C128, device="cpu")
    np.testing.assert_allclose(mono, Xt[..., 0], rtol=1e-12, atol=1e-12)

    yt = tapi.stft_synthesis_batch(Xt, nfft, dtype=C128, device="cpu")
    yj = japi.stft_synthesis_batch(Xt, nfft, dtype=C128)
    np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-9)
    for b in range(3):
        np.testing.assert_allclose(
            yt[b], tapi.stft_synthesis(Xt[b], nfft, dtype=C128, device="cpu"), rtol=1e-12, atol=1e-12
        )
    # win_s is honoured, as its regression test in tests/test_pipeline_api.py
    # requires of the JAX version
    ones = np.ones(nfft)
    y_other = tapi.stft_synthesis_batch(Xt, nfft, hop, win_s=ones, dtype=C128, device="cpu")
    assert not np.allclose(y_other, yt)
    np.testing.assert_allclose(
        y_other, japi.stft_synthesis_batch(Xt, nfft, hop, win_s=ones, dtype=C128),
        rtol=1e-6, atol=1e-9,
    )
    np.testing.assert_allclose(
        y_other[1], tapi.stft_synthesis(Xt[1], nfft, win_s=ones, dtype=C128, device="cpu"),
        rtol=1e-12, atol=1e-12,
    )
    with pytest.raises(ValueError, match="unbatched"):
        tapi.stft_synthesis_batch(Xt[0], nfft, device="cpu")
    with pytest.raises(ValueError, match="B, n_samples"):
        tapi.stft_analysis_batch(x[0, :, 0], nfft, device="cpu")


@pytest.fixture(scope="module")
def mixture52():
    rng = np.random.default_rng(41)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=5, n_samples=12000, snr_db=20)
    return stft_mixture(mix, nfft=256)


def test_pca_matches_jax(mixture52):
    Xr_t, E_t = tapi.pca(mixture52, 2, return_basis=True, dtype=C128, device="cpu")
    Xr_j, E_j = japi.pca(mixture52, 2, return_basis=True, dtype=C128)
    assert Xr_t.shape == (mixture52.shape[0], mixture52.shape[1], 2)
    np.testing.assert_allclose(E_t, E_j, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(Xr_t, Xr_j, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tapi.pca(mixture52, 2, dtype=C128, device="cpu"), Xr_t, atol=1e-12)


@pytest.mark.parametrize("n_src", [2, 5])
def test_auxiva_pca_matches_jax(mixture52, n_src):
    Yt, Wt = tapi.auxiva_pca(
        mixture52, n_src=n_src, n_iter=8, return_filters=True, dtype=C128, device="cpu"
    )
    Yj, Wj = japi.auxiva_pca(mixture52, n_src=n_src, n_iter=8, return_filters=True, dtype=C128)
    assert Wt.shape == (mixture52.shape[1], n_src, n_src)
    np.testing.assert_allclose(Wt, Wj, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(Yt, Yj, rtol=1e-6, atol=1e-8)
    # the model-level run is the same AuxIVA on the reduced STFT
    Y_run, _ = tpca.auxiva_pca_run(torch.from_numpy(mixture52), n_src, 8, "laplace")
    Y_nopb = tapi.auxiva_pca(
        mixture52, n_src=n_src, n_iter=8, proj_back=False, dtype=C128, device="cpu"
    )
    np.testing.assert_allclose(Y_run.numpy(), Y_nopb, rtol=1e-9, atol=1e-12)


def test_auxiva_pca_callback_and_probes(mixture52):
    snaps_t, snaps_j = [], []
    tapi.auxiva_pca(
        mixture52, n_src=2, n_iter=11, callback=snaps_t.append, dtype=C128, device="cpu"
    )
    japi.auxiva_pca(mixture52, n_src=2, n_iter=11, callback=snaps_j.append, dtype=C128)
    assert len(snaps_t) == len(snaps_j) == 2
    assert all(isinstance(s, np.ndarray) for s in snaps_t)
    for a, b in zip(snaps_t, snaps_j):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)
    Yt = tapi.auxiva_pca(torch.from_numpy(mixture52), n_src=2, n_iter=2)
    assert isinstance(Yt, torch.Tensor) and Yt.dtype == torch.complex64
    with pytest.raises(ValueError, match="inner"):
        tapi.auxiva_pca(mixture52, n_src=2, inner="bogus", device="cpu")
    with pytest.raises(ValueError, match="n_src >= 2"):
        tapi.auxiva_pca(mixture52, n_src=1, inner="ip2", device="cpu")
    with pytest.raises(ValueError, match="n_src"):
        tapi.auxiva_pca(mixture52, n_src=6, device="cpu")


@pytest.mark.parametrize("inner", ["iss", "ip2"])
def test_auxiva_pca_inner_matches_jax(mixture52, inner):
    Yt, Wt = tapi.auxiva_pca(mixture52, n_src=2, n_iter=6, inner=inner, return_filters=True,
                             dtype=C128, device="cpu")
    Yj, Wj = japi.auxiva_pca(mixture52, n_src=2, n_iter=6, inner=inner, return_filters=True,
                             dtype=C128)
    assert Wt.shape == (mixture52.shape[1], 2, 2)
    np.testing.assert_allclose(Wt, Wj, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(Yt, Yj, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("inner", ["ip", "iss", "ip2"])
def test_auxiva_pca_batch_matches_jax_and_per_clip(mixture52, inner):
    Xb = np.stack([mixture52[:40, :65], mixture52[30:70, :65]])
    Yt = tapi.auxiva_pca_batch(Xb, n_src=2, n_iter=5, inner=inner, dtype=C128, device="cpu")
    Yj = japi.auxiva_pca_batch(Xb, n_src=2, n_iter=5, inner=inner, dtype=C128)
    assert Yt.shape == (2, 40, 65, 2)
    np.testing.assert_allclose(Yt, Yj, rtol=1e-6, atol=1e-8)
    for b in range(2):
        Y1 = tapi.auxiva_pca(Xb[b], n_src=2, n_iter=5, inner=inner, dtype=C128, device="cpu")
        np.testing.assert_allclose(Yt[b], Y1, rtol=1e-9, atol=1e-12)
    with pytest.raises(ValueError, match="inner"):
        tapi.auxiva_pca_batch(Xb, n_src=2, inner="bogus", device="cpu")


def test_wcov_f32x3_tier(mixture52):
    """f32x3 is the exact f32 tier here: at least as accurate as the TPU's
    3-pass tier (~1e-5 relative), so it meets the JAX f32x3 results at the
    parity gate and equals the port's f32 results exactly."""
    rng = np.random.default_rng(9)
    X = (rng.standard_normal((32, 17, 4)) + 1j * rng.standard_normal((32, 17, 4))).astype(
        np.complex64
    )
    phi = np.abs(rng.standard_normal((32, 2))).astype(np.float32)
    Xt, pt = torch.from_numpy(X), torch.from_numpy(phi)
    V3 = tcov.weighted_covariance_all(Xt, pt, "f32x3")
    assert torch.equal(V3, tcov.weighted_covariance_all(Xt, pt, "f32"))
    Vj = np.asarray(jcov.weighted_covariance_all(jnp.asarray(X), jnp.asarray(phi), "f32x3"))
    assert np.abs(V3.numpy() - Vj).max() < 1e-5 * np.abs(Vj).max()
    w_tf = np.abs(X[:, :, 0])
    assert torch.equal(
        tcov.weighted_covariance_tf(Xt, torch.from_numpy(w_tf), "f32x3"),
        tcov.weighted_covariance_tf(Xt, torch.from_numpy(w_tf)),
    )
    Yt = tapi.overiva(mixture52, n_src=2, n_iter=8, wcov="f32x3", dtype=C128, device="cpu")
    Yj = japi.overiva(mixture52, n_src=2, n_iter=8, wcov="f32x3", dtype=C128)
    np.testing.assert_allclose(Yt, Yj, rtol=1e-6, atol=1e-8)
    np.testing.assert_array_equal(
        Yt, tapi.overiva(mixture52, n_src=2, n_iter=8, dtype=C128, device="cpu")
    )


def test_wcov_f32x3_quality_parity(rng):
    """Full-pipeline SIR of the f32x3 tier within 0.3 dB of f32, the bound
    tests/test_bf16.py holds the JAX tiers to."""
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=4, n_samples=24000, n_taps=8, snr_db=25)
    nfft, hop = 512, 256
    X = stft_mixture(mix, nfft)
    ev = BssEvalReferences(premix[:, :, 0])
    sirs = {}
    for mode in ("f32", "f32x3"):
        Y = tapi.overiva(X, n_src=2, n_iter=15, wcov=mode, device="cpu")
        y = synthesis(Y, nfft, hop)[nfft - hop :][: mix.shape[0]]
        sirs[mode] = ev.evaluate(y.T)[1].mean()
    assert sirs["f32"] > 6.0, sirs
    assert abs(sirs["f32x3"] - sirs["f32"]) < 0.3, sirs
