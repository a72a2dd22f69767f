"""PyTorch port: STFT analysis/synthesis and projection back against the
JAX package (``overiva_tpu.api``) at complex128 on the CPU."""

import numpy as np
import pytest
import torch

import overiva_tpu.oracle as oracle
from overiva_tpu import api as japi
from overiva_tpu.ops import stft as jstft
from overiva_tpu_torch import api as tapi
from overiva_tpu_torch.ops import stft as tstft

C128 = np.complex128


def test_stft_analysis_matches_jax(rng):
    x = rng.standard_normal((4096, 3))
    Xt = tapi.stft_analysis(x, 512, dtype=C128, device="cpu")
    Xj = japi.stft_analysis(x, 512, dtype=C128)
    assert isinstance(Xt, np.ndarray) and Xt.dtype == C128
    np.testing.assert_allclose(Xt, Xj, atol=1e-10)


def test_stft_analysis_window_matches_jax(rng):
    """A custom analysis window against the JAX trace-side analysis, and a
    1-D signal comes back without the channel axis."""
    x = rng.standard_normal(3000)
    win = rng.random(256) + 0.5
    Xj = np.asarray(jstft.analysis(x, 256, 64, win))
    Xt = tapi.stft_analysis(x, 256, hop=64, win=win, dtype=C128, device="cpu")
    assert Xt.shape == Xj.shape and Xt.ndim == 2
    np.testing.assert_allclose(Xt, Xj, atol=1e-10)


def test_stft_synthesis_matches_jax(rng):
    X = rng.standard_normal((20, 257, 2)) + 1j * rng.standard_normal((20, 257, 2))
    yt = tapi.stft_synthesis(X, 512, dtype=C128, device="cpu")
    yj = japi.stft_synthesis(X, 512, dtype=C128)
    np.testing.assert_allclose(yt, yj, atol=1e-10)


def test_projection_back_matches_jax(rng):
    Y = rng.standard_normal((30, 9, 2)) + 1j * rng.standard_normal((30, 9, 2))
    ref = rng.standard_normal((30, 9)) + 1j * rng.standard_normal((30, 9))
    Y[:, 4, 1] = 0.0  # a silent (bin, source): z = 1 there
    zt = tapi.projection_back(Y, ref, device="cpu")
    np.testing.assert_allclose(zt, japi.projection_back(Y, ref), atol=1e-12)
    assert zt[4, 1] == 1.0
    # all-zero outputs stay finite
    z0 = tapi.projection_back(np.zeros_like(Y), ref, device="cpu")
    assert np.all(z0 == 1.0)


def test_stft_round_trip(rng):
    nfft, hop = 512, 256
    x = rng.standard_normal((5000, 2))
    xp = oracle.stft_pad(x, nfft, hop)
    np.testing.assert_array_equal(
        tstft.stft_pad(torch.from_numpy(x), nfft, hop).numpy(), xp
    )
    X = tapi.stft_analysis(xp, nfft, dtype=C128, device="cpu")
    y = tapi.stft_synthesis(X, nfft, dtype=C128, device="cpu")
    np.testing.assert_allclose(y[nfft - hop :][: x.shape[0]], x, atol=1e-10)


def test_win_s_honoured_on_both_entry_points(rng):
    """A custom synthesis window changes the output on the public entry
    point and on the tensor function alike, and matches the JAX package."""
    nfft, hop = 256, 128
    X = rng.standard_normal((12, 129, 2)) + 1j * rng.standard_normal((12, 129, 2))
    win_s = rng.random(nfft)
    yj = japi.stft_synthesis(X, nfft, win_s=win_s, dtype=C128)
    y_api = tapi.stft_synthesis(X, nfft, win_s=win_s, dtype=C128, device="cpu")
    y_ops = tstft.synthesis(torch.from_numpy(X), nfft, hop, win_s).numpy()
    np.testing.assert_allclose(y_api, yj, atol=1e-10)
    np.testing.assert_allclose(y_ops, yj, atol=1e-10)
    y_default = tapi.stft_synthesis(X, nfft, dtype=C128, device="cpu")
    assert np.abs(y_default - y_api).max() > 1e-3


def test_tensor_in_tensor_out(rng):
    x = torch.from_numpy(rng.standard_normal((2048, 2)))
    X = tapi.stft_analysis(x, 256)
    assert isinstance(X, torch.Tensor) and X.dtype == torch.complex64
    y = tapi.stft_synthesis(X, 256)
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float32
    with pytest.raises(ValueError, match="shorter"):
        tapi.stft_analysis(np.zeros((100, 2)), 256, device="cpu")
