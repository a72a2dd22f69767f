"""PyTorch port: the OverIVA/AuxIVA main path against the JAX package and
the f64 oracle on the CPU.

JAX reference runs sit in module-scoped fixtures so that each JAX program
compiles once. Tolerances follow tests/test_jax_parity.py (rtol 1e-6 at
complex128 over 10 iterations) and tests/test_integration.py (0.02 dB at
matched complex64 precision).
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import overiva_tpu.oracle as oracle
from overiva_tpu import api as japi
from overiva_tpu.metrics import BssEvalReferences, bss_eval_sources
from overiva_tpu.models import overiva as jcore
from overiva_tpu.ops.covariance import covariance as jcovariance
from overiva_tpu_torch import api as tapi
from overiva_tpu_torch.models import overiva as tcore
from overiva_tpu_torch.ops.wcov_packed import wcov_packed
from overiva_tpu_torch.utils.convert import state_to_numpy, state_to_torch

from helpers import make_mixture, stft_mixture

C128 = np.complex128


@pytest.fixture(scope="module")
def mixtures():
    """The mixtures of tests/test_jax_parity.py: 2x2 and 5 mics x 2 sources."""
    rng = np.random.default_rng(21)
    mix22, _, _ = make_mixture(rng, n_src=2, n_mics=2, n_samples=16000)
    mix52, _, _ = make_mixture(rng, n_src=2, n_mics=5, n_samples=16000, snr_db=20)
    return stft_mixture(mix22, nfft=256), stft_mixture(mix52, nfft=256)


@pytest.fixture(scope="module")
def jax_runs(mixtures):
    """JAX api runs at complex128, 10 iterations, with filters."""
    X22, X52 = mixtures
    runs = {}
    for model in ("laplace", "gauss"):
        runs["auxiva", model] = japi.auxiva(
            X22, n_iter=10, model=model, return_filters=True, dtype=C128
        )
        runs["overiva", model] = japi.overiva(
            X52, n_src=2, n_iter=10, model=model, return_filters=True, dtype=C128
        )
    runs["init_eig"] = japi.overiva(
        X52, n_src=2, n_iter=10, init_eig=True, return_filters=True, dtype=C128
    )
    return runs


@pytest.mark.parametrize("M,N", [(2, 2), (5, 2), (8, 3)])
def test_epoch_matches_jax(M, N):
    rng = np.random.default_rng(M * 10 + N)
    T, F = 40, 9
    X = rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))
    Cx = np.asarray(jcovariance(jnp.asarray(X)))
    W0 = rng.standard_normal((F, N, M)) + 1j * rng.standard_normal((F, N, M))
    W = np.asarray(jcore.init_w_hat(jnp.asarray(X), N, False, Cx=jnp.asarray(Cx), W0=jnp.asarray(W0)))
    Wj = np.asarray(
        jax.jit(partial(jcore._epoch, n_src=N, model="laplace"))(
            jnp.asarray(X), jnp.asarray(W), jnp.asarray(Cx)
        )
    )
    s = state_to_torch({"X": X, "W_hat": W, "Cx": Cx}, "cpu", C128)
    Wt = tcore._epoch(s["X"], s["W_hat"], s["Cx"], N, "laplace").numpy()
    np.testing.assert_allclose(Wt, Wj, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("algo", ["auxiva", "overiva"])
@pytest.mark.parametrize("model", ["laplace", "gauss"])
def test_api_matches_jax(mixtures, jax_runs, algo, model):
    X22, X52 = mixtures
    Yj, Wj = jax_runs[algo, model]
    if algo == "auxiva":
        Yt, Wt = tapi.auxiva(
            X22, n_iter=10, model=model, return_filters=True, dtype=C128, device="cpu"
        )
    else:
        Yt, Wt = tapi.overiva(
            X52, n_src=2, n_iter=10, model=model, return_filters=True, dtype=C128,
            device="cpu",
        )
    assert isinstance(Yt, np.ndarray) and Yt.dtype == C128
    np.testing.assert_allclose(Wt, Wj, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(Yt, Yj, rtol=1e-6, atol=1e-8)


def test_init_eig_matches_jax(mixtures, jax_runs):
    _, X52 = mixtures
    Yj, Wj = jax_runs["init_eig"]
    Yt, Wt = tapi.overiva(
        X52, n_src=2, n_iter=10, init_eig=True, return_filters=True, dtype=C128,
        device="cpu",
    )
    np.testing.assert_allclose(Wt, Wj, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(Yt, Yj, rtol=1e-6, atol=1e-8)


def test_w0_carried_across(mixtures, jax_runs):
    """Both packages continue from the JAX filters: the port gets them
    through utils/convert as tensors, and returns tensors for tensors."""
    _, X52 = mixtures
    _, Wj = jax_runs["overiva", "laplace"]
    Yj = japi.overiva(X52, n_src=2, n_iter=3, W0=Wj, dtype=C128)
    s = state_to_torch({"X": X52, "W_hat": Wj}, "cpu", C128)
    Yt = tapi.overiva(s["X"], n_src=2, n_iter=3, W0=s["W_hat"], dtype=C128)
    assert isinstance(Yt, torch.Tensor)
    back = state_to_numpy({"Y": Yt, "W_hat": s["W_hat"]})
    np.testing.assert_array_equal(back["W_hat"], Wj)
    np.testing.assert_allclose(back["Y"], Yj, rtol=1e-6, atol=1e-8)


def test_callback_cadence_and_values(mixtures):
    X22, _ = mixtures
    snaps_o, snaps_t = [], []
    oracle.auxiva(X22, n_iter=21, callback=lambda Y: snaps_o.append(Y.copy()))
    tapi.auxiva(
        X22, n_iter=21, callback=snaps_t.append, callback_every=10, dtype=C128, device="cpu"
    )
    assert len(snaps_o) == len(snaps_t) == 3
    for a, b in zip(snaps_o, snaps_t):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-8)


def test_chunked_frames_identical(mixtures):
    _, X52 = mixtures
    Ya = tapi.overiva(X52, n_src=2, n_iter=6, dtype=C128, device="cpu")
    Yb = tapi.overiva(X52, n_src=2, n_iter=6, dtype=C128, chunk_frames=32, device="cpu")
    np.testing.assert_allclose(Yb, Ya, rtol=1e-9, atol=1e-11)


def _sdr_sir(separate, mix, premix, nfft):
    hop = nfft // 2
    X = oracle.analysis(oracle.stft_pad(mix, nfft, hop), nfft, hop)
    y = oracle.synthesis(separate(X), nfft, hop)[nfft - hop :][: mix.shape[0]]
    sdr, sir, _, _ = bss_eval_sources(premix[:, :, 0], y.T)
    return sdr, sir


def test_same_precision_parity_gate():
    """Port c64 against oracle c64 at 0.02 dB (the shape of
    tests/test_integration.py::test_same_precision_parity_gate, laplace)."""
    rng = np.random.default_rng(102)
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=5, n_samples=24000, snr_db=25)
    sdr_o, sir_o = _sdr_sir(
        lambda X: oracle.overiva(X.astype(np.complex64), n_src=2, n_iter=20),
        mix, premix, 256,
    )
    sdr_t, sir_t = _sdr_sir(
        lambda X: tapi.overiva(X, n_src=2, n_iter=20, device="cpu"), mix, premix, 256
    )
    assert np.max(np.abs(sdr_t - sdr_o)) < 0.02, (sdr_t, sdr_o)
    assert np.max(np.abs(sir_t - sir_o)) < 0.02, (sir_t, sir_o)
    assert np.min(sir_t) > 8.0


def test_bf16pack_pipeline_quality(rng):
    """wcov="bf16pack" through the port's whole pipeline: SIR within
    0.1 dB of the JAX package's bf16pack run (Pallas interpret mode) and
    within 0.3 dB of the port's f32 run (tests/test_bf16.py's bound)."""
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=4, n_samples=24000, n_taps=8, snr_db=25)
    nfft, hop = 512, 256
    ev = BssEvalReferences(premix[:, :, 0])
    xp = oracle.stft_pad(mix, nfft, hop)

    def sir(y):
        return ev.evaluate(np.asarray(y)[nfft - hop :][: mix.shape[0]].T)[1].mean()

    X = tapi.stft_analysis(xp, nfft, device="cpu")
    launches = wcov_packed.launches
    sirs = {}
    for wcov in ("f32", "bf16pack"):
        Y = tapi.overiva(X, n_src=2, n_iter=15, wcov=wcov, device="cpu")
        assert np.isfinite(Y).all()
        sirs[wcov] = sir(tapi.stft_synthesis(Y, nfft, device="cpu"))
    Yj = japi.overiva(stft_mixture(mix, nfft), n_src=2, n_iter=15, wcov="bf16pack")
    sir_j = sir(oracle.synthesis(Yj, nfft, hop))
    assert wcov_packed.launches == launches  # CPU: the plain version, no launch
    assert sirs["f32"] > 6.0, sirs
    assert abs(sirs["bf16pack"] - sir_j) < 0.1, (sirs, sir_j)
    assert abs(sirs["bf16pack"] - sirs["f32"]) < 0.3, sirs


def test_f32x2_tier_is_complex128_of_complex64_input(mixtures):
    """acc="f32x2": complex128 on the complex64-rounded input, complex64
    out, within 1e-6 max|Y| of the f64 oracle on that input (the gate of
    tests/test_overiva_df.py; the complex64 output rounding is ~6e-8)."""
    _, X52 = mixtures
    Y = tapi.overiva(X52, n_src=2, n_iter=10, model="gauss", acc="f32x2", device="cpu")
    assert Y.dtype == np.complex64
    Yo = oracle.overiva(X52.astype(np.complex64).astype(C128), n_src=2, n_iter=10, model="gauss")
    assert np.abs(Y - Yo).max() / np.abs(Yo).max() < 1e-6


def test_validation_probes():
    X = np.zeros((8, 5, 3), dtype=np.complex64)
    for kwargs in [
        {"n_src": 0}, {"n_src": 4}, {"model": "bogus"}, {"acc": "bogus"},
        {"acc": "f32x2", "init_eig": True}, {"acc": "f32x2", "dtype": C128},
        {"acc": "f32x2", "wcov": "bf16"},
    ]:
        with pytest.raises(ValueError):
            tapi.overiva(X, **kwargs, device="cpu")
    with pytest.raises(ValueError, match="determined"):
        tapi.auxiva(X, n_src=2, device="cpu")


def test_separate_matches_oracle_pipeline():
    rng = np.random.default_rng(31)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=3, n_samples=6000)
    nfft, hop = 256, 128
    y = tapi.separate(mix, n_src=2, nfft=nfft, n_iter=5, dtype=C128, device="cpu")
    X = oracle.analysis(oracle.stft_pad(mix, nfft, hop), nfft, hop)
    yo = oracle.synthesis(oracle.overiva(X, n_src=2, n_iter=5), nfft, hop)
    np.testing.assert_allclose(y, yo[nfft - hop :][: mix.shape[0]], rtol=1e-8, atol=1e-10)
    yt = tapi.separate(torch.from_numpy(mix), n_src=2, nfft=nfft, n_iter=5, dtype=C128)
    assert isinstance(yt, torch.Tensor)
    np.testing.assert_allclose(yt.numpy(), y, atol=1e-12)
    # the joint family runs (tests/test_torch_tiss.py holds it to JAX)
    yj = tapi.separate(mix, n_src=2, nfft=nfft, n_iter=2, algo="tiss", device="cpu")
    assert yj.shape == (mix.shape[0], 2) and np.isfinite(yj).all()
    with pytest.raises(ValueError, match="unknown algo"):
        tapi.separate(mix, n_src=2, algo="bogus", device="cpu")


def test_degenerate_mixture_stays_finite():
    """A duplicated channel (rank-deficient Cx, singular update systems)
    comes out finite at complex64, gauss model with eig init."""
    rng = np.random.default_rng(2)
    T, F, M = 40, 17, 4
    X = rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))
    X[:, :, -1] = X[:, :, -2]
    Y = tapi.overiva(X.astype(np.complex64), n_src=2, n_iter=8, model="gauss",
                     init_eig=True, device="cpu")
    assert np.isfinite(Y).all()


@pytest.mark.parametrize("wcov", ["f32", "bf16pack"])
def test_near_singular_mixing_no_collapse(wcov):
    """Near-parallel 2x2 mixing makes every bin knife-edge: the guarded
    normalizer keeps unresolvable rows, so the output is finite and keeps
    its energy instead of collapsing to zeros."""
    rng = np.random.default_rng(11)
    T, F, M = 60, 33, 2
    S = rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))
    mix_mat = np.array([[1.0, 1.0], [1.0, 1.0 + 3e-7]], np.complex64)
    X = (S @ mix_mat.T).astype(np.complex64)
    Y = tapi.overiva(X, n_src=2, n_iter=10, wcov=wcov, device="cpu")
    assert np.isfinite(Y).all()
    assert np.sum(np.abs(Y) ** 2) > 1e-6 * np.sum(np.abs(X) ** 2)
