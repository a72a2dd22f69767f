"""PyTorch port: T-IP (joint dereverberation + separation with exact IP
rows) against the JAX package and the f64 oracle copy on the CPU.

Gates (tests/test_tip.py, tests/test_joint_df.py): one epoch from the
same state at rtol 1e-8 (the Schur reduction and the data-form
normalizer); runs at complex128, rtol 1e-6 / atol 1e-8; a W0 skips the
warm start; the batch form equal to single runs; the ``f32x3``/``bf16``
tiers near f32 and ``bf16pack`` refused; the callback path equal to the
plain one at 1e-10; taps=0 against AuxIVA; ``acc="f32x2"`` within 1e-6
of the oracle on the complex64-rounded input.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overiva_tpu import api as japi
from overiva_tpu.models import tip as jtip
from overiva_tpu_torch import api as tapi
from overiva_tpu_torch import oracle as toracle
from overiva_tpu_torch.models import tip as ttip

from helpers import make_mixture, stft_mixture
from test_torch_tiss import _joint_mixture

C128 = np.complex128


@pytest.fixture(scope="module")
def X3():
    """3 mics, 2 sources, a 200-tap room (F=65, T=110)."""
    rng = np.random.default_rng(37)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=3, n_samples=7000, n_taps=200, snr_db=25)
    return stft_mixture(mix, nfft=128).astype(C128)


@pytest.mark.parametrize("N,taps", [(2, 2), (3, 1), (3, 0)])
def test_epoch_matches_jax(N, taps):
    """One epoch from the same state, the background pieces (N < M)
    passed in as ``tip_iterations`` computes them."""
    rng = np.random.default_rng(20 * N + taps)
    T, F, M = 40, 9, 3
    X = rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))
    Xt = np.concatenate([X, toracle.delayed_taps(X, taps, 1)], axis=2) if taps else X
    P = np.zeros((F, M, Xt.shape[2]), complex)
    P[:, :, :M] = np.eye(M)
    P += 0.2 * (rng.standard_normal(P.shape) + 1j * rng.standard_normal(P.shape))
    bg_j = jtip._background_pieces(jnp.asarray(Xt), M) if N < M else None
    Pj = jax.jit(partial(jtip._tip_epoch, model="laplace", n_chan=M, n_src=N))(
        jnp.asarray(Xt), jnp.asarray(P), bg=bg_j)
    Xt_t = torch.from_numpy(Xt)
    bg_t = ttip._background_pieces(Xt_t, M) if N < M else None
    Pt = ttip._tip_epoch(Xt_t, torch.from_numpy(P), "laplace", M, N, bg=bg_t)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("model,N", [("laplace", 2), ("gauss", 3)])
def test_api_matches_jax_and_oracle_c128(X3, model, N):
    kw = dict(n_src=N, taps=3, delay=2, n_iter=4, warm_iter=3, model=model,
              return_filters=True)
    Yt, Pt = tapi.tip(X3, dtype=C128, device="cpu", **kw)
    Yj, Pj = japi.tip(X3, dtype=C128, **kw)
    Yo, Po = toracle.tip(X3, **kw)
    assert Yt.shape == (*X3.shape[:2], N) and Pt.shape == (X3.shape[1], 3, 12)
    for want in ((Yj, Pj), (Yo, Po)):
        np.testing.assert_allclose(Pt, want[1], rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(Yt, want[0], rtol=1e-6, atol=1e-8)


def test_w0_skips_warm_start(X3):
    _, P0 = toracle.tip(X3, n_src=2, taps=2, delay=1, n_iter=2, return_filters=True)
    kw = dict(n_src=2, taps=2, delay=1, n_iter=1, W0=P0, warm_iter=10)
    Yt = tapi.tip(X3, dtype=C128, device="cpu", **kw)
    np.testing.assert_allclose(Yt, toracle.tip(X3, **kw), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(Yt, japi.tip(X3, dtype=C128, **kw), rtol=1e-6, atol=1e-8)
    # the square and target-row forms start without the warm-up too
    for W0 in (P0[:, :, :3], P0[:, :2, :3]):
        kw["W0"] = W0
        np.testing.assert_allclose(tapi.tip(X3, dtype=C128, device="cpu", **kw),
                                   toracle.tip(X3, **kw), rtol=1e-6, atol=1e-8)


def test_batch_matches_single(X3):
    Xb = np.stack([X3, 0.7 * X3[::-1]])
    kw = dict(n_src=2, taps=2, delay=1, n_iter=3, warm_iter=2, dtype=C128)
    Yb = tapi.tip_batch(Xb, device="cpu", **kw)
    for b in range(2):
        Y1 = tapi.tip(Xb[b], device="cpu", **kw)
        np.testing.assert_allclose(Yb[b], Y1, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(Yb, japi.tip_batch(Xb, **kw), rtol=1e-6, atol=1e-8)
    # bf16: each mixture's covariances weighted by its own activations
    kw["dtype"] = None
    Yb16 = tapi.tip_batch(Xb.astype(np.complex64), wcov="bf16", device="cpu", **kw)
    for b in range(2):
        Y1 = tapi.tip(Xb[b].astype(np.complex64), wcov="bf16", device="cpu", **kw)
        assert np.linalg.norm(Yb16[b] - Y1) <= 1e-4 * np.linalg.norm(Y1)


def test_wcov_tiers(X3):
    """f32x3 is exact f32 here; bf16 lands near f32 and near the JAX
    package's bf16 run (tests/test_tip.py: 0.3 of the norm at most)."""
    X = X3.astype(np.complex64)
    kw = dict(n_src=2, taps=2, delay=1, n_iter=3, warm_iter=2)
    Yf = tapi.tip(X, device="cpu", **kw)
    np.testing.assert_array_equal(tapi.tip(X, wcov="f32x3", device="cpu", **kw), Yf)
    Yb = tapi.tip(X, wcov="bf16", device="cpu", **kw)
    assert np.isfinite(Yb).all()
    assert np.linalg.norm(Yb - Yf) / np.linalg.norm(Yf) < 0.3
    Yj = japi.tip(X, wcov="bf16", **kw)
    assert np.linalg.norm(Yb - Yj) / np.linalg.norm(Yj) < 1e-2


def test_callback_path_matches_plain(X3):
    kw = dict(n_src=2, taps=2, delay=1, n_iter=4, warm_iter=2, dtype=C128)
    Y_plain = tapi.tip(X3, device="cpu", **kw)
    snaps, snaps_j = [], []
    Y_cb = tapi.tip(X3, callback=snaps.append, callback_every=2, device="cpu", **kw)
    japi.tip(X3, callback=snaps_j.append, callback_every=2, **kw)
    assert len(snaps) == len(snaps_j) == 2
    np.testing.assert_allclose(Y_cb, Y_plain, rtol=1e-10, atol=1e-12)
    for a, b in zip(snaps, snaps_j):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("dtype", [C128, np.complex64])
def test_taps0_is_auxiva(X3, dtype):
    """taps=0, N=M: AuxIVA's IP trajectory. The JAX package's own pair is
    not bit for bit (its T-IP rows are normalized by the data form, its
    AuxIVA rows by the V form): after 5 epochs on this input they differ
    by 8.3e-16 (complex128) and 1.5e-6 (complex64) of max|Y|. The port's
    pair is held to 10x the JAX pair's delta, measured here."""
    def delta(a, b):
        return np.abs(a - b).max() / np.abs(b).max()

    d_jax = delta(japi.tip(X3, taps=0, n_iter=5, dtype=dtype),
                  japi.auxiva(X3, n_iter=5, dtype=dtype))
    d_port = delta(tapi.tip(X3, taps=0, n_iter=5, dtype=dtype, device="cpu"),
                   tapi.auxiva(X3, n_iter=5, dtype=dtype, device="cpu"))
    assert 0 < d_jax < (1e-14 if dtype == C128 else 1e-5)
    assert d_port <= 10 * d_jax, (d_port, d_jax)


@pytest.mark.parametrize("model", ["laplace", "gauss"])
def test_df_matches_f64_oracle(model):
    """acc="f32x2" (the warm-up included): complex64 out, within 1e-6 of
    the f64 oracle on the complex64-rounded input."""
    X = _joint_mixture(np.random.default_rng(12345))
    kw = dict(n_src=2, taps=2, delay=1, n_iter=4, warm_iter=3, model=model)
    Y = tapi.tip(X, acc="f32x2", device="cpu", **kw)
    Yo = toracle.tip(X.astype(C128), **kw)
    assert Y.dtype == np.complex64
    assert np.abs(Y - Yo).max() / np.abs(Yo).max() < 1e-6


def test_df_w0_and_filters():
    X = _joint_mixture(np.random.default_rng(12345))
    _, P0 = tapi.tiss(X, n_src=2, taps=2, delay=1, n_iter=2, return_filters=True,
                      device="cpu")
    Y, P = tapi.tip(X, n_src=2, taps=2, delay=1, n_iter=3, W0=P0, acc="f32x2",
                    return_filters=True, device="cpu")
    Yo, Po = toracle.tip(X.astype(C128), n_src=2, taps=2, delay=1, n_iter=3,
                         W0=P0.astype(C128), return_filters=True)
    assert P.dtype == np.complex64
    assert np.abs(Y - Yo).max() / np.abs(Yo).max() < 1e-6
    assert np.abs(P - Po).max() / np.abs(Po).max() < 1e-6


def test_separate_matches_jax():
    rng = np.random.default_rng(48)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=3, n_samples=6000, snr_db=25)
    kw = dict(n_src=2, nfft=256, hop=128, n_iter=3, algo="tip", taps=2, delay=1,
              dtype=C128)
    y = tapi.separate(mix, device="cpu", **kw)
    assert y.shape == (6000, 2) and np.isfinite(y).all()
    yj = japi.separate(mix, **kw)
    np.testing.assert_allclose(y, yj, atol=1e-8 * np.abs(yj).max())


def test_validation():
    X = np.zeros((8, 5, 2), np.complex64)
    for fn, arg in ((tapi.tip, X), (tapi.tip_batch, X[None])):
        with pytest.raises(ValueError, match="delay"):
            fn(arg, taps=2, delay=0, device="cpu")
        with pytest.raises(ValueError, match="n_src"):
            fn(arg, n_src=3, device="cpu")
        with pytest.raises(ValueError, match="bf16pack"):
            fn(arg, wcov="bf16pack", device="cpu")
        with pytest.raises(ValueError, match="wcov must be one of"):
            fn(arg, wcov="fp8", device="cpu")
    with pytest.raises(ValueError, match="wcov"):
        tapi.tip(X, acc="f32x2", wcov="bf16", device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        tapi.tip(X, acc="f32x2", dtype=C128, device="cpu")
