"""PyTorch port: T-ISS (joint dereverberation + separation by source
steering) against the JAX package and the f64 oracle copy on the CPU.

Gates (tests/test_tiss.py, tests/test_joint_df.py): one epoch from the
same state at rtol 1e-8; runs at complex128, rtol 1e-6 / atol 1e-8 on P
and Y; taps=0 equal to AuxIVA-ISS / OverIVA-ISS exactly; the batch form
equal to single runs at 1e-8; the callback cadence; the three W0 forms
at taps=0 and taps>0; ``acc="f32x2"`` within 1e-6 of the oracle on the
complex64-rounded input.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overiva_tpu import api as japi
from overiva_tpu.models import tiss as jtiss
from overiva_tpu_torch import api as tapi
from overiva_tpu_torch import oracle as toracle
from overiva_tpu_torch.models import tiss as ttiss

from helpers import make_mixture, stft_mixture

C128 = np.complex128


@pytest.fixture(scope="module")
def X3():
    """3 mics, 2 sources, a 200-tap room (F=65, T=110): the taps have work."""
    rng = np.random.default_rng(37)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=3, n_samples=7000, n_taps=200, snr_db=25)
    return stft_mixture(mix, nfft=128).astype(C128)


def _joint_mixture(rng):
    """tests/test_joint_df.py's mixture: random mixing with a delayed
    leak, complex64."""
    T, F, M, N = 60, 17, 3, 2
    S = rng.standard_normal((T, F, N)) + 1j * rng.standard_normal((T, F, N))
    A = rng.standard_normal((F, M, N)) + 1j * rng.standard_normal((F, M, N))
    X = np.einsum("fmn,tfn->tfm", A, S)
    X[2:] += 0.3 * np.einsum("fmn,tfn->tfm", A, S)[:-2]
    X += 0.01 * (rng.standard_normal(X.shape) + 1j * rng.standard_normal(X.shape))
    return X.astype(np.complex64)


@pytest.mark.parametrize("N,taps", [(2, 2), (3, 2), (2, 0)])
def test_epoch_matches_jax(N, taps):
    rng = np.random.default_rng(10 * N + taps)
    T, F, M = 30, 9, 3
    X = rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))
    Xt = np.concatenate([X, toracle.delayed_taps(X, taps, 1)], axis=2) if taps else X
    P = np.zeros((F, M, Xt.shape[2]), complex)
    P[:, :, :M] = np.eye(M)
    P += 0.2 * (rng.standard_normal(P.shape) + 1j * rng.standard_normal(P.shape))
    Y = np.einsum("fnj,tfj->tfn", P, Xt)
    Pj, Yj = jax.jit(partial(jtiss._tiss_epoch, model="laplace", n_chan=M, n_src=N))(
        jnp.asarray(Xt), (jnp.asarray(P), jnp.asarray(Y)))
    Pt, Yt = ttiss._tiss_epoch(*(torch.from_numpy(a) for a in (Xt, P, Y)), "laplace", M, N)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("model,N", [("laplace", 2), ("gauss", 3)])
def test_api_matches_jax_and_oracle_c128(X3, model, N):
    kw = dict(n_src=N, taps=3, delay=2, n_iter=6, model=model, return_filters=True)
    Yt, Pt = tapi.tiss(X3, dtype=C128, device="cpu", **kw)
    Yj, Pj = japi.tiss(X3, dtype=C128, **kw)
    Yo, Po = toracle.tiss(X3, **kw)
    assert Yt.shape == (*X3.shape[:2], N) and Pt.shape == (X3.shape[1], 3, 12)
    for want in ((Yj, Pj), (Yo, Po)):
        np.testing.assert_allclose(Pt, want[1], rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(Yt, want[0], rtol=1e-6, atol=1e-8)


def test_taps0_equals_iss_exactly(X3):
    """taps=0: the T-ISS epoch is the ISS epoch, bit for bit."""
    kw = dict(n_iter=5, dtype=C128, device="cpu", return_filters=True)
    for got, want in [
        (tapi.tiss(X3, taps=0, **kw), tapi.auxiva_iss(X3, **kw)),
        (tapi.tiss(X3, n_src=2, taps=0, **kw), tapi.overiva_iss(X3, n_src=2, **kw)),
    ]:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    # complex64 too
    X = X3.astype(np.complex64)
    np.testing.assert_array_equal(tapi.tiss(X, taps=0, n_iter=4, device="cpu"),
                                  tapi.auxiva_iss(X, n_iter=4, device="cpu"))


def test_batch_matches_single(X3):
    Xb = np.stack([X3, 0.7 * X3[::-1]])
    kw = dict(n_src=2, taps=3, delay=2, n_iter=5, dtype=C128)
    Yb = tapi.tiss_batch(Xb, device="cpu", **kw)
    assert Yb.shape == (2, *X3.shape[:2], 2)
    for b in range(2):
        Y1 = tapi.tiss(Xb[b], device="cpu", **kw)
        np.testing.assert_allclose(Yb[b], Y1, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(Yb, japi.tiss_batch(Xb, **kw), rtol=1e-6, atol=1e-8)
    Yt = tapi.tiss_batch(torch.from_numpy(Xb), proj_back=False, **kw)
    assert isinstance(Yt, torch.Tensor) and Yt.dtype == torch.complex128


def test_callback_cadence(X3):
    """11 epochs, a callback every 5: 3 scaled snapshots, each the JAX
    package's; the chunked run ends where the unchunked one does."""
    kw = dict(n_src=2, taps=3, delay=2, n_iter=11, dtype=C128)
    snaps_t, snaps_j = [], []
    Yt = tapi.tiss(X3, callback=snaps_t.append, callback_every=5, device="cpu", **kw)
    japi.tiss(X3, callback=snaps_j.append, callback_every=5, **kw)
    assert len(snaps_t) == len(snaps_j) == 3
    for a, b in zip(snaps_t, snaps_j):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)
    np.testing.assert_array_equal(Yt, tapi.tiss(X3, device="cpu", **kw))


@pytest.mark.parametrize("taps", [0, 2])
def test_w0_forms(X3, taps):
    """A full augmented P, a square (F, M, M) stack and (F, N, M) target
    rows, each continued as the JAX package continues it. At taps=0 the
    full and square widths coincide: the row count decides first."""
    rng = np.random.default_rng(8 + taps)
    F, M = X3.shape[1], 3
    P = toracle.tiss(X3, n_src=2, taps=taps, delay=1, n_iter=3, proj_back=False,
                     return_filters=True)[1]
    forms = {"full": P, "square": P[:, :, :M] + 0.01 * rng.standard_normal((F, M, M)),
             "rows": P[:, :2, :M]}
    for name, W0 in forms.items():
        kw = dict(n_src=2, taps=taps, delay=1, n_iter=2, W0=W0, dtype=C128)
        Yt, Pt = tapi.tiss(X3, device="cpu", return_filters=True, **kw)
        Yj, Pj = japi.tiss(X3, return_filters=True, **kw)
        np.testing.assert_allclose(Pt, Pj, rtol=1e-8, atol=1e-10, err_msg=name)
        np.testing.assert_allclose(Yt, Yj, rtol=1e-8, atol=1e-10, err_msg=name)
        Yo = toracle.tiss(X3, n_src=2, taps=taps, delay=1, n_iter=2, W0=W0)
        np.testing.assert_allclose(Yt, Yo, rtol=1e-6, atol=1e-8, err_msg=name)
    # n_iter=0 from a full P is the plain demix
    Y0 = tapi.tiss(X3, n_src=2, taps=taps, delay=1, n_iter=0, W0=P, proj_back=False,
                   dtype=C128, device="cpu")
    Xt = np.concatenate([X3, toracle.delayed_taps(X3, taps, 1)], axis=2) if taps else X3
    np.testing.assert_allclose(Y0, np.einsum("fnj,tfj->tfn", P, Xt)[:, :, :2], rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("model", ["laplace", "gauss"])
def test_df_matches_f64_oracle(model):
    """acc="f32x2": complex128 on the complex64-rounded input, complex64
    out, within 1e-6 of the f64 oracle on that input."""
    X = _joint_mixture(np.random.default_rng(12345))
    Y = tapi.tiss(X, n_src=2, taps=2, delay=1, n_iter=6, model=model, acc="f32x2",
                  device="cpu")
    Yo = toracle.tiss(X.astype(C128), n_src=2, taps=2, delay=1, n_iter=6, model=model)
    assert Y.dtype == np.complex64
    assert np.abs(Y - Yo).max() / np.abs(Yo).max() < 1e-6
    Y, P = tapi.tiss(X, taps=0, n_iter=5, acc="f32x2", return_filters=True, device="cpu")
    Yo, Po = toracle.tiss(X.astype(C128), taps=0, n_iter=5, return_filters=True)
    assert P.dtype == np.complex64
    assert np.abs(Y - Yo).max() / np.abs(Yo).max() < 1e-6
    assert np.abs(P - Po).max() / np.abs(Po).max() < 1e-6
    snaps, snaps_o = [], []
    tapi.tiss(X, n_src=2, taps=2, delay=1, n_iter=5, acc="f32x2", callback=snaps.append,
              callback_every=2, device="cpu")
    toracle.tiss(X.astype(C128), n_src=2, taps=2, delay=1, n_iter=5, callback=snaps_o.append,
                 callback_every=2)
    assert len(snaps) == len(snaps_o) == 3  # epochs 0, 2 and 4
    for a, b in zip(snaps, snaps_o):
        assert a.dtype == np.complex64
        assert np.abs(a - b).max() / np.abs(b).max() < 1e-6


def test_separate_matches_jax():
    """separate(algo="tiss") against the JAX package's at complex128; at
    taps=0 it is the "iss" pipeline exactly."""
    rng = np.random.default_rng(44)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=2, n_samples=6000, snr_db=25)
    kw = dict(n_src=2, nfft=256, hop=128, n_iter=5, dtype=C128)
    y = tapi.separate(mix, algo="tiss", taps=2, delay=1, device="cpu", **kw)
    assert y.shape == (6000, 2) and np.isfinite(y).all()
    yj = japi.separate(mix, algo="tiss", taps=2, delay=1, **kw)
    np.testing.assert_allclose(y, yj, atol=1e-8 * np.abs(yj).max())
    np.testing.assert_array_equal(
        tapi.separate(mix, algo="tiss", taps=0, device="cpu", **kw),
        tapi.separate(mix, algo="iss", device="cpu", **kw))


def test_validation():
    X = np.zeros((8, 5, 2), np.complex64)
    with pytest.raises(ValueError, match="delay"):
        tapi.tiss(X, taps=2, delay=0, device="cpu")
    with pytest.raises(ValueError, match="n_src"):
        tapi.tiss(X, n_src=3, device="cpu")
    with pytest.raises(ValueError, match="delay"):
        tapi.tiss_batch(X[None], taps=2, delay=0, device="cpu")
    with pytest.raises(ValueError, match="n_src"):
        tapi.tiss_batch(X[None], n_src=0, device="cpu")
    with pytest.raises(ValueError, match="B, T, F, M"):
        tapi.tiss_batch(X, device="cpu")
    with pytest.raises(ValueError, match="acc"):
        tapi.tiss(X, acc="bogus", device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        tapi.tiss(X, acc="f32x2", dtype=C128, device="cpu")
