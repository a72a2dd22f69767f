"""PyTorch port: online (streaming) WPE against the JAX package on the CPU.

Gates: complex128 against the JAX class at rtol 1e-8, atol 1e-10 (the
stream's filter is re-solved every block, so this holds the solve, the
block-wise decay and the history across blocks); the validation
(``taps >= 1``, ``delay >= 1``); save/restore bit for bit, and a JAX
checkpoint continued in the port.
"""

import numpy as np
import pytest
import torch

from overiva_tpu import api as japi
from overiva_tpu_torch import api as tapi

from helpers import make_mixture, stft_mixture

C128 = np.complex128
B = 8


@pytest.fixture(scope="module")
def X():
    """2 mics, 2 sources, a 96-tap room, nfft 128: (T=64, F=65, M=2)."""
    rng = np.random.default_rng(21)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=2, n_samples=4100, n_taps=96, snr_db=30)
    return stft_mixture(mix, nfft=128)[:64]


def _stream(sep, X, block=B):
    return np.concatenate([sep.process(X[s : s + block]) for s in range(0, X.shape[0], block)])


@pytest.mark.parametrize(
    "kw",
    [
        {"taps": 3, "delay": 2},
        {"taps": 2, "delay": 1, "forget": 0.95, "diag_load": 1e-3},
    ],
)
def test_matches_jax_c128(X, kw):
    want = _stream(japi.OnlineWPE(X.shape[1], 2, dtype=C128, **kw), X)
    sep = tapi.OnlineWPE(X.shape[1], 2, dtype=C128, device="cpu", **kw)
    got = _stream(sep, X)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)
    assert sep.filters.shape == (X.shape[1], 2 * kw["taps"], 2)
    # the stream dereverberates: the output is not the input
    assert np.abs(got - X).max() > 1e-3 * np.abs(X).max()


def test_validation():
    with pytest.raises(ValueError, match="taps must be >= 1"):
        tapi.OnlineWPE(65, 2, taps=0, device="cpu")
    with pytest.raises(ValueError, match="delay must be >= 1"):
        tapi.OnlineWPE(65, 2, delay=0, device="cpu")
    with pytest.raises(ValueError, match="block must be"):
        tapi.OnlineWPE(65, 2, device="cpu").process(np.zeros((4, 64, 2), np.complex64))


def test_save_restore(X, tmp_path):
    kw = dict(taps=3, delay=2, dtype=C128)
    sep = tapi.OnlineWPE(X.shape[1], 2, device="cpu", **kw)
    _stream(sep, X[: 3 * B])
    path = sep.save(tmp_path / "wpe.npz")
    sep2 = tapi.OnlineWPE(X.shape[1], 2, device="cpu", **kw)
    assert sep2.restore(path) == {"class": "OnlineWPE"}
    assert sep2.state["t_eff"].dtype == torch.float64
    np.testing.assert_array_equal(_stream(sep2, X[3 * B :]), _stream(sep, X[3 * B :]))
    # a JAX checkpoint continues in the port
    jsep = japi.OnlineWPE(X.shape[1], 2, **kw)
    _stream(jsep, X[: 3 * B])
    jsep.save(tmp_path / "jwpe.npz")
    sep3 = tapi.OnlineWPE(X.shape[1], 2, device="cpu", **kw)
    sep3.restore(tmp_path / "jwpe.npz")
    np.testing.assert_allclose(_stream(sep3, X[3 * B :]), _stream(jsep, X[3 * B :]),
                               rtol=1e-8, atol=1e-10)
