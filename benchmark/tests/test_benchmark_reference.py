"""The frozen reference against the repository's float64 oracles, of
which it is a copy (the tests may import the program; the harness's
reference may not)."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.reference import overiva, stft
from benchmark.traffic.generate import make_mixture
from overiva_tpu_torch import oracle


SCENE = {"room_dim": [8.0, 9.0, 3.0], "rt60": 0.05, "snr_db": 25.0, "mic_radius": 0.05,
         "src_distance": 2.5}


def _mix(seed, n_src, n_chan, n):
    scene = dict(SCENE, n_src=n_src)
    return make_mixture(np.random.default_rng(seed), n_chan, n, 16000, scene)[0]


@pytest.mark.parametrize("nfft,n", [(256, 3000), (64, 1000)])
def test_stft_matches_oracle(nfft, n):
    x = _mix(1, 2, 3, n)
    hop = nfft // 2
    xp = stft.stft_pad(x, nfft, hop)
    np.testing.assert_array_equal(xp, oracle.stft_pad(x, nfft, hop))
    X = stft.analysis(xp, nfft, hop)
    np.testing.assert_allclose(X, oracle.analysis(xp, nfft, hop), rtol=0, atol=1e-12)
    np.testing.assert_allclose(stft.synthesis(X, nfft, hop), oracle.synthesis(X, nfft, hop),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("init_eig", [False, True])
@pytest.mark.parametrize("n_src,n_chan", [(2, 4), (3, 3)])
def test_overiva_matches_oracle(n_src, n_chan, init_eig):
    x = _mix(2, n_src, n_chan, 6000)
    X = oracle.analysis(oracle.stft_pad(x, 256, 128), 256, 128)
    want = oracle.overiva(X, n_src, n_iter=6, init_eig=init_eig)
    got = overiva.overiva(X, n_src, 6, init_eig=init_eig)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())
