"""PyTorch port: FastMNMF2 (tied g) and FastMNMF1 (per-frequency g) against
the JAX package and the f64 oracle copy on the CPU.

Parity gates: complex128 runs on Q, g, W, H and the Wiener images Y at
rtol 1e-6 / atol 1e-9 of each quantity's largest value (the JAX package's
own check, tests/test_fastmnmf2.py, is 5e-3 of it against the oracle).
Against the oracle copy the port measured at most 1.6e-13 (FastMNMF2) and
2.0e-13 (FastMNMF1) of the largest value here (W; Q 4.6e-14 to 8.3e-14, Y
below 1e-14), which ``chip_smoke.py`` phase 8 scales into its gate. The
batch form keeps a leading batch axis (H, g and nu sum over each
mixture's own bins).
"""

import warnings

import numpy as np
import pytest
import torch

from overiva_tpu import api as japi
from overiva_tpu.models import fastmnmf2 as jmnmf
from overiva_tpu_torch import api as tapi
from overiva_tpu_torch import oracle as toracle
from overiva_tpu_torch.models import fastmnmf2 as tmnmf
from overiva_tpu_torch.ops.covariance import covariance

from helpers import make_mixture, stft_mixture

C128 = np.complex128
# port - oracle at complex128, as a share of max|oracle|, over (Y, Q, g, W,
# H) of this file's mixture (measured here: 2.0e-13 at most)
ORACLE_TOL = 1e-12


@pytest.fixture(scope="module")
def mixture32():
    """3 mics, 2 sources, nfft 256 (F=129, T=95)."""
    rng = np.random.default_rng(11)
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=3, n_samples=12000, n_taps=8,
                                  snr_db=25)
    return mix, premix, stft_mixture(mix, 256)


def _close(got, want, rtol=1e-6, atol=1e-9):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * np.abs(want).max())


@pytest.mark.parametrize(
    "name,kw",
    [
        ("fastmnmf2", {}),
        ("fastmnmf", {}),
        ("fastmnmf2", {"n_q_sweeps": 2}),
        ("fastmnmf", {"n_q_sweeps": 2, "init": "eye", "n_noise": 0}),
    ],
)
def test_api_matches_jax_and_oracle(mixture32, name, kw):
    X = mixture32[2]
    Yt, pt = getattr(tapi, name)(X, n_src=2, n_iter=5, seed=5, return_filters=True,
                                 dtype=C128, device="cpu", **kw)
    Yj, pj = getattr(japi, name)(X, n_src=2, n_iter=5, seed=5, return_filters=True,
                                 dtype=C128, **kw)
    Yo, po = getattr(toracle, name)(X, n_src=2, n_iter=5, seed=5, return_filters=True, **kw)
    assert Yt.shape == (X.shape[0], X.shape[1], 2)
    slots = 2 + kw.get("n_noise", 1)
    assert pt[1].shape == ((slots, 3) if name == "fastmnmf2" else (slots, X.shape[1], 3))
    for got, want, ref in zip((Yt, *pt), (Yj, *pj), (Yo, *po)):
        _close(got, want)
        assert np.abs(got - ref).max() <= ORACLE_TOL * np.abs(ref).max()


def test_wiener_images_sum_to_mic0(mixture32):
    """The gains of all slots sum to D / D = 1, so the images of the whole
    model give back mic 0 at any parameters (the oracle's, here)."""
    X = mixture32[2]
    _, (Q, g, W, H) = toracle.fastmnmf2(X, n_src=3, n_iter=3, seed=2, n_noise=0,
                                       return_filters=True)
    Y = tmnmf.fastmnmf2_wiener(*(torch.from_numpy(np.asarray(a))[None] for a in (X, Q, g, W, H)))
    np.testing.assert_allclose(Y[0].sum(dim=2).numpy(), X[:, :, 0], rtol=1e-8, atol=1e-10)
    Yj = jmnmf.fastmnmf2_wiener(X, Q, g, W, H, 1)
    Yt = tmnmf.fastmnmf2_wiener(*(torch.from_numpy(np.asarray(a))[None] for a in (X, Q, g, W, H)),
                                mic_index=1)
    _close(Yt[0].numpy(), Yj)


def test_whiten_q_matches_jax(mixture32):
    """The whitening start Q itself at complex128: it depends on the
    eigenvector phase convention and the eigenvalue order."""
    Xu, _ = tmnmf.unit_power(torch.from_numpy(mixture32[2])[None])
    Q = tmnmf.whiten_q(Xu)[0].resolve_conj().numpy()
    Xj, _ = jmnmf.unit_power(mixture32[2])
    _close(Q, jmnmf.whiten_q(Xj), rtol=1e-9, atol=1e-12)


def test_whitening_start_is_set_only_to_1e3_eps_in_complex64():
    """The cause of the complex64 FastMNMF misses on the card (ROADMAP Queue
    3). With more mics than sources, the noise eigenvalues of a bin's input
    covariance lie within ~1e-4 of the largest, and complex64's ``eigh``
    fixes their eigenvectors only to ~5e-4 of max|Q| here, thousands of
    times its rounding, worst in the bins with the smallest eigenvalue gap.
    LAPACK (CPU) and cuSOLVER (CUDA) land that far apart, and farther on
    larger scenes (``examples/fastmnmf_stages.py``); the run follows."""
    rng = np.random.default_rng(11)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=5, n_samples=12000, n_taps=8, snr_db=25)
    X = torch.from_numpy(stft_mixture(mix, 256).astype(np.complex64))[None]
    Xu, _ = tmnmf.unit_power(X)
    Q64 = tmnmf.whiten_q(Xu)[0].to(torch.complex128)
    Q128 = tmnmf.whiten_q(Xu.to(torch.complex128))[0]
    rel = (Q64 - Q128).abs().amax(dim=(1, 2)) / Q128.abs().amax(dim=(1, 2))
    ev = torch.linalg.eigvalsh(covariance(Xu[0].to(torch.complex128)))
    gap = (ev[:, 1:] - ev[:, :-1]).min(dim=1).values / ev[:, -1]
    assert rel.max() > 1e3 * 2.0**-23
    worst = torch.argsort(rel, descending=True)[:10]
    assert gap[worst].median() < 0.5 * gap.median()


def test_callback_and_bf16_tier(mixture32):
    X = mixture32[2]
    snaps_t, snaps_j = [], []
    tapi.fastmnmf2(X, n_src=2, n_iter=6, seed=1, callback=snaps_t.append, callback_every=3,
                   dtype=C128, device="cpu")
    japi.fastmnmf2(X, n_src=2, n_iter=6, seed=1, callback=snaps_j.append, callback_every=3,
                   dtype=C128)
    assert len(snaps_t) == len(snaps_j) == 2
    for a, b in zip(snaps_t, snaps_j):
        _close(a, b)
    # the bf16 tier at complex64: 2.6e-4 of the norm from the JAX run here
    # (the f32 tier: 1.2e-6). On equal inputs the two bf16 covariances are
    # equal, but the f32 weights 1/D of the two runs differ in their last
    # bits, which flips the bf16 rounding (~4e-3) of some of them
    X64 = X.astype(np.complex64)
    Yt = tapi.fastmnmf2(X64, n_src=2, n_iter=6, wcov="bf16", device="cpu")
    Yj = japi.fastmnmf2(X64, n_src=2, n_iter=6, wcov="bf16")
    assert Yt.dtype == np.complex64
    assert np.linalg.norm(Yt - Yj) / np.linalg.norm(Yj) < 1e-3


@pytest.mark.parametrize("name", ["fastmnmf2_batch", "fastmnmf_batch"])
def test_batch_matches_jax_and_single_runs(mixture32, name):
    X = mixture32[2]
    Xb = np.stack([X[:60], 0.5 * X[30:90]])
    Yb = getattr(tapi, name)(Xb, n_src=2, n_iter=4, seed=9, dtype=C128, device="cpu")
    assert Yb.shape == (2, 60, X.shape[1], 2)
    _close(Yb, getattr(japi, name)(Xb, n_src=2, n_iter=4, seed=9, dtype=C128))
    single = tapi.fastmnmf2 if name == "fastmnmf2_batch" else tapi.fastmnmf
    for b in range(2):
        Y1 = single(Xb[b], n_src=2, n_iter=4, seed=9 + b, dtype=C128, device="cpu")
        np.testing.assert_allclose(Yb[b], Y1, rtol=1e-9, atol=1e-12 * np.abs(Y1).max())
    Ys = getattr(tapi, name)(torch.from_numpy(Xb), n_src=2, n_iter=3, seeds=[3, 3],
                             dtype=C128)
    assert isinstance(Ys, torch.Tensor)
    Y1 = single(Xb[1], n_src=2, n_iter=3, seed=3, dtype=C128, device="cpu")
    np.testing.assert_allclose(Ys[1].numpy(), Y1, rtol=1e-9, atol=1e-12 * np.abs(Y1).max())


@pytest.mark.parametrize("algo", ["fastmnmf", "fastmnmf2"])
def test_separate_matches_jax(mixture32, algo):
    """The fused pipeline with the JAX package's ``PRNGKey(0)`` NMF init
    (the port's threefry copy): complex128 to rounding, complex64 close."""
    mix = mixture32[0][:8000]
    for n_src in (2, 3):
        yt = tapi.separate(mix, n_src=n_src, nfft=256, n_iter=5, algo=algo, dtype=C128,
                           device="cpu")
        yj = japi.separate(mix, n_src=n_src, nfft=256, n_iter=5, algo=algo, dtype=C128)
        assert yt.shape == (mix.shape[0], n_src)
        _close(yt, yj)
    yt = tapi.separate(mix, n_src=2, nfft=256, n_iter=5, algo=algo, device="cpu")
    yj = japi.separate(mix, n_src=2, nfft=256, n_iter=5, algo=algo)
    assert yt.dtype == np.float32
    assert np.linalg.norm(yt - yj) / np.linalg.norm(yj) < 1e-4


def test_safe_regime_warning():
    rng = np.random.default_rng(12345)
    X = (rng.standard_normal((40, 9, 3)) + 1j * rng.standard_normal((40, 9, 3))).astype(
        np.complex64)
    with pytest.warns(UserWarning, match="safe regime"):
        tapi.fastmnmf2(X, n_src=2, n_iter=61, seed=1, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tapi.fastmnmf(X, n_src=2, n_iter=5, seed=1, device="cpu")


def test_validation_probes():
    X = np.zeros((8, 5, 2), dtype=np.complex64)
    for fn, arg in ((tapi.fastmnmf2, X), (tapi.fastmnmf, X), (tapi.fastmnmf2_batch, X[None])):
        with pytest.raises(ValueError, match="n_src"):
            fn(arg, n_src=0, device="cpu")
        with pytest.raises(ValueError, match="init"):
            fn(arg, init="bogus", device="cpu")
    for fn in (tapi.fastmnmf2, tapi.fastmnmf):
        with pytest.raises(ValueError, match="wcov must be one of"):
            fn(X, wcov="fp8", device="cpu")
        with pytest.raises(ValueError, match="bf16pack"):
            fn(X, wcov="bf16pack", device="cpu")
    with pytest.raises(ValueError, match="batch length"):
        tapi.fastmnmf_batch(np.stack([X, X]), seeds=[1, 2, 3], device="cpu")
    with pytest.raises(ValueError, match="B, T, F, M"):
        tapi.fastmnmf2_batch(X, device="cpu")
