"""PyTorch port: the one runner of the separating families
(``models/family.py::run_family``) that ``separate``, ``auxiva_pca`` and
the entry points and batch forms call.

Its outputs, scaled by projection back, are the public entry points'
outputs bit for bit; its callback runs before every ``callback_every``
epochs; on folded mixtures it equals its per-clip runs; and ``separate``
is its run between the STFT and the iSTFT. The entry points themselves
are held against the JAX package in tests/test_torch_{overiva,iss,ip2}.py.
"""

import numpy as np
import pytest
import torch

from overiva_tpu_torch import api as tapi
from overiva_tpu_torch.models import overiva as tcore
from overiva_tpu_torch.models.family import FAMILIES, run_family
from overiva_tpu_torch.ops import stft as tstft
from overiva_tpu_torch.ops.projection import apply_projection_back

from helpers import make_mixture, stft_mixture

ENTRY = {"ip": tapi.overiva, "iss": tapi.overiva_iss, "ip2": tapi.overiva_ip2}


@pytest.fixture(scope="module")
def mix4():
    rng = np.random.default_rng(23)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=4, n_samples=6000, snr_db=20)
    return mix


@pytest.mark.parametrize("algo", FAMILIES)
def test_run_family_is_the_entry_points_run(mix4, algo):
    X = stft_mixture(mix4, nfft=64)[:60]  # T=60, F=33, M=4
    Xt = torch.from_numpy(X)
    snaps = []
    Y, W = run_family(Xt, 2, 7, "laplace", algo, callback=snaps.append, callback_every=3)
    assert Y.shape == (60, 33, 2) and W.shape == (33, 4, 4)
    assert len(snaps) == 3  # before epochs 0, 3 and 6
    Ye, We = ENTRY[algo](X, n_src=2, n_iter=7, return_filters=True, dtype=np.complex128,
                         device="cpu")
    np.testing.assert_array_equal(apply_projection_back(Y, Xt[:, :, 0]).numpy(), Ye)
    np.testing.assert_array_equal(W.numpy(), We)
    # folded mixtures: each one's run equals its own single-clip run
    Xb = torch.from_numpy(np.stack([X[:40], X[20:]]))
    Yb, _ = run_family(tcore.fold_mixtures(Xb), 2, 5, "laplace", algo, n_mix=2)
    Yb = tcore.unfold_mixtures(Yb, 2)
    for b in range(2):
        Y1, _ = run_family(Xb[b], 2, 5, "laplace", algo)
        np.testing.assert_allclose(Yb[b].numpy(), Y1.numpy(), rtol=1e-9, atol=1e-12)
    # separate: STFT -> this run -> projection back -> iSTFT
    nfft, hop = 64, 32
    y = tapi.separate(mix4, n_src=2, nfft=nfft, n_iter=4, algo=algo, dtype=np.complex128,
                      device="cpu")
    x = torch.from_numpy(mix4)
    Xs = tstft.analysis(tstft.stft_pad(x, nfft, hop), nfft, hop)
    Ys, _ = run_family(Xs, 2, 4, "laplace", algo)
    ys = tstft.synthesis(apply_projection_back(Ys, Xs[:, :, 0]), nfft, hop)
    np.testing.assert_array_equal(y, ys[nfft - hop : nfft - hop + mix4.shape[0]].numpy())
