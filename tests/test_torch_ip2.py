"""PyTorch port: AuxIVA-IP2 / OverIVA-IP2 against the JAX package on the
CPU.

Parity gates: the closed-form 2x2 GEVD at rtol 1e-10 on seeded pencils
(equal eigenvalues, a near-singular A, a negative real discriminant with
either sign of zero); one epoch at complex128, rtol 1e-8; runs at
complex128, rtol 1e-6 (tests/test_ip2.py). The bf16 tiers (JAX's Pallas
kernel in interpret mode for ``bf16pack``) at complex64: 1e-4 of the
output's norm, SIR within 0.1 dB of the JAX run and 0.3 dB of f32
(tests/test_bf16.py).
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overiva_tpu import api as japi
from overiva_tpu.metrics import BssEvalReferences
from overiva_tpu.models import overiva as jcore
from overiva_tpu.models import overiva_ip2 as jip2
from overiva_tpu.ops.covariance import covariance as jcovariance
from overiva_tpu.oracle import synthesis
from overiva_tpu_torch import api as tapi
from overiva_tpu_torch.models import overiva_ip2 as tip2
from overiva_tpu_torch.ops.wcov_packed import wcov_packed
from overiva_tpu_torch.utils.convert import state_to_torch

from helpers import make_mixture, stft_mixture

C128 = np.complex128


@pytest.fixture(scope="module")
def X5():
    """5 mics, 3 sources, nfft 128 (F=65, T=126)."""
    rng = np.random.default_rng(71)
    mix, _, _ = make_mixture(rng, n_src=3, n_mics=5, n_samples=8000, snr_db=25)
    return stft_mixture(mix, nfft=128)


def _hermitian(rng, F, scale=1.0):
    G = rng.standard_normal((F, 2, 2)) + 1j * rng.standard_normal((F, 2, 2))
    return scale * (G @ np.conj(np.swapaxes(G, 1, 2)) + 0.1 * np.eye(2))


def _pencils():
    rng = np.random.default_rng(72)
    F = 16
    A, B = _hermitian(rng, F), _hermitian(rng, F)
    B[:4] = 2.5 * A[:4]  # equal eigenvalues: the tie rule picks the vector
    A[4:8] = np.array([[1.0, 1.0], [1.0, 1.0 + 1e-31]])  # |det A| < 1e-30: floored
    # B = [[0, 1], [-1, 0]], A = I: tr^2 - 4 det is -4 with either sign of
    # a zero imaginary part (the principal branch of sqrt at the cut)
    A[8:12] = np.eye(2)
    B[8:10] = np.array([[0.0, 1.0], [-1.0, 0.0]])
    B[10:12] = np.array([[0.0, 1.0], [-1.0, 0.0]]) + np.array([[0.0, -0.0j], [0.0, 0.0]])
    return B, A


def test_gevd_2x2_matches_jax():
    B, A = _pencils()
    lam_j, V_j = jax.jit(jip2._gevd_2x2_fm)(
        jnp.asarray(np.transpose(B, (1, 2, 0))), jnp.asarray(np.transpose(A, (1, 2, 0)))
    )
    lam_t, V_t = tip2._gevd_2x2(torch.from_numpy(B), torch.from_numpy(A))
    lam, V = lam_t.numpy(), V_t.numpy()
    assert np.isfinite(V).all() and np.isfinite(lam).all()
    # distinct eigenvalues, the floored det A and the branch cut: the same
    # closed form gives the same pairs
    np.testing.assert_allclose(lam[4:], np.asarray(lam_j).T[4:], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(V[4:], np.transpose(np.asarray(V_j), (2, 0, 1))[4:],
                               rtol=1e-10, atol=1e-12)
    # equal eigenvalues: sqrt lifts the discriminant's rounding to ~1e-8,
    # and every vector is an eigenvector
    np.testing.assert_allclose(lam[:4], np.asarray(lam_j).T[:4], rtol=1e-7)
    np.testing.assert_allclose(lam[:4], 2.5, rtol=1e-7)
    for f in [*range(4), *range(12, 16)]:
        for k in range(2):
            v = V[f, :, k]
            np.testing.assert_allclose(B[f] @ v, lam[f, k] * A[f] @ v, rtol=1e-6,
                                       atol=1e-6 * np.abs(B[f] @ v).max())
        assert lam[f, 0] <= lam[f, 1]
    # at the branch cut torch.sqrt keeps the sign of a zero imaginary part
    # (sqrt(-4 - 0j) = -2j, as NumPy) where jnp.sqrt may not; only the
    # sign of the imaginary part can differ, and the eigenvalues take the
    # real part
    disc = torch.complex(torch.tensor([-4.0, -4.0], dtype=torch.float64),
                         torch.tensor([0.0, -0.0], dtype=torch.float64))
    root_t = torch.sqrt(disc).numpy()
    root_j = np.asarray(jnp.sqrt(jnp.asarray(disc.numpy())))
    np.testing.assert_array_equal(root_t, np.sqrt(disc.numpy()))
    np.testing.assert_array_equal(root_t.real, root_j.real)
    np.testing.assert_array_equal(np.abs(root_t.imag), np.abs(root_j.imag))
    np.testing.assert_array_equal(lam[8:12], 0.0)


@pytest.mark.parametrize("M,N", [(3, 3), (5, 2), (4, 3)])
def test_ip2_epoch_matches_jax(M, N):
    rng = np.random.default_rng(M * 10 + N)
    T, F = 24, 7
    X = rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))
    Cx = np.asarray(jcovariance(jnp.asarray(X)))
    W0 = rng.standard_normal((F, N, M)) + 1j * rng.standard_normal((F, N, M))
    W = np.asarray(jcore.init_w_hat(jnp.asarray(X), N, False, Cx=jnp.asarray(Cx),
                                    W0=jnp.asarray(W0)))
    Wj = jax.jit(partial(jip2._ip2_epoch, n_src=N, model="laplace"))(
        jnp.asarray(X), jnp.asarray(W), jnp.asarray(Cx)
    )
    s = state_to_torch({"X": X, "W": W, "Cx": Cx}, "cpu", C128)
    Wt = tip2._ip2_epoch(s["X"], s["W"], s["Cx"], N, "laplace")
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("model", ["laplace", "gauss"])
def test_api_matches_jax(X5, model):
    """overiva_ip2 at (M, N) = (5, 2) and auxiva_ip2 at (3, 3), filters
    included."""
    Yt, Wt = tapi.overiva_ip2(X5, n_src=2, n_iter=6, model=model, return_filters=True,
                              dtype=C128, device="cpu")
    Yj, Wj = japi.overiva_ip2(X5, n_src=2, n_iter=6, model=model, return_filters=True,
                              dtype=C128)
    np.testing.assert_allclose(Wt, Wj, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(Yt, Yj, rtol=1e-6, atol=1e-8)
    X3 = X5[:, :, :3]
    Yt, Wt = tapi.auxiva_ip2(X3, n_iter=6, model=model, return_filters=True, dtype=C128,
                             device="cpu")
    Yj, Wj = japi.auxiva_ip2(X3, n_iter=6, model=model, return_filters=True, dtype=C128)
    assert Yt.shape == X3.shape and Wt.shape == (X3.shape[1], 3, 3)
    np.testing.assert_allclose(Wt, Wj, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(Yt, Yj, rtol=1e-6, atol=1e-8)


def test_callback_init_eig_and_w0(X5):
    so, sj = [], []
    tapi.overiva_ip2(X5, n_src=2, n_iter=11, callback=so.append, dtype=C128, device="cpu")
    japi.overiva_ip2(X5, n_src=2, n_iter=11, callback=sj.append, dtype=C128)
    assert len(so) == len(sj) == 2
    for a, b in zip(so, sj):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)
    Yt, Wt = tapi.overiva_ip2(X5, n_src=2, n_iter=10, init_eig=True, return_filters=True,
                              dtype=C128, device="cpu")
    Yj, Wj = japi.overiva_ip2(X5, n_src=2, n_iter=10, init_eig=True, return_filters=True,
                              dtype=C128)
    np.testing.assert_allclose(Yt, Yj, rtol=1e-6, atol=1e-8)
    s = state_to_torch({"X": X5, "W": Wj}, "cpu", C128)
    Yt = tapi.overiva_ip2(s["X"], n_src=2, n_iter=10, W0=s["W"], dtype=C128)
    assert isinstance(Yt, torch.Tensor)
    np.testing.assert_allclose(
        Yt.numpy(), japi.overiva_ip2(X5, n_src=2, n_iter=10, W0=Wj, dtype=C128),
        rtol=1e-6, atol=1e-8,
    )


@pytest.fixture(scope="module")
def mixture42():
    rng = np.random.default_rng(12345)
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=4, n_samples=12000, n_taps=8,
                                  snr_db=25)
    return mix, premix


@pytest.mark.parametrize("wcov", ["bf16", "bf16pack"])
def test_bf16_tiers_match_jax(mixture42, wcov):
    mix, premix = mixture42
    nfft, hop = 128, 64
    X = stft_mixture(mix, nfft).astype(np.complex64)
    ev = BssEvalReferences(premix[:, :, 0])

    def sir(Y):
        return ev.evaluate(synthesis(Y, nfft, hop)[nfft - hop :][: mix.shape[0]].T)[1].mean()

    launches = wcov_packed.launches
    Yt = tapi.overiva_ip2(X, n_src=2, n_iter=12, wcov=wcov, device="cpu")
    Yj = japi.overiva_ip2(X, n_src=2, n_iter=12, wcov=wcov)
    Y32 = tapi.overiva_ip2(X, n_src=2, n_iter=12, device="cpu")
    assert wcov_packed.launches == launches  # CPU: the plain version, no launch
    assert Yt.dtype == np.complex64 and np.isfinite(Yt).all()
    assert np.linalg.norm(Yt - Yj) / np.linalg.norm(Yj) < 1e-4
    s_t, s_j, s_32 = sir(Yt), sir(Yj), sir(Y32)
    assert s_32 > 6.0, s_32
    assert abs(s_t - s_j) < 0.1, (s_t, s_j)
    assert abs(s_t - s_32) < 0.3, (s_t, s_32)


@pytest.mark.parametrize("wcov", ["f32", "bf16pack"])
def test_near_singular_mixing_no_collapse(wcov):
    """Near-parallel 2x2 mixing makes every bin knife-edge: the pair keeps
    its rows where a Gram is noise, so the output is finite and keeps its
    energy."""
    rng = np.random.default_rng(11)
    T, F, M = 60, 33, 2
    S = rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))
    mix_mat = np.array([[1.0, 1.0], [1.0, 1.0 + 3e-7]], np.complex64)
    X = (S @ mix_mat.T).astype(np.complex64)
    Y = tapi.auxiva_ip2(X, n_iter=10, wcov=wcov, device="cpu")
    assert np.isfinite(Y).all()
    assert np.sum(np.abs(Y) ** 2) > 1e-6 * np.sum(np.abs(X) ** 2)


def test_ip2_batch_matches_jax_and_per_clip(X5):
    Xb = np.stack([X5[:60], X5[50:110]])
    Yt = tapi.overiva_ip2_batch(Xb, n_src=2, n_iter=5, dtype=C128, device="cpu")
    Yj = japi.overiva_ip2_batch(Xb, n_src=2, n_iter=5, dtype=C128)
    assert Yt.shape == (2, 60, X5.shape[1], 2)
    np.testing.assert_allclose(Yt, Yj, rtol=1e-6, atol=1e-8)
    for b in range(2):
        Y1 = tapi.overiva_ip2(Xb[b], n_src=2, n_iter=5, dtype=C128, device="cpu")
        np.testing.assert_allclose(Yt[b], Y1, rtol=1e-9, atol=1e-12)
    Yd = tapi.overiva_ip2_batch(torch.from_numpy(Xb[:, :, :, :3]), n_iter=3, proj_back=False)
    assert isinstance(Yd, torch.Tensor) and Yd.dtype == torch.complex64
    # complex64: summation order moves the pairwise update a little
    Y1 = tapi.auxiva_ip2(torch.from_numpy(Xb[1, :, :, :3]), n_iter=3, proj_back=False)
    assert torch.linalg.norm(Yd[1] - Y1) / torch.linalg.norm(Y1) < 1e-3


def test_separate_ip2_matches_jax():
    rng = np.random.default_rng(73)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=3, n_samples=6000)
    for N in (2, 3):
        yt = tapi.separate(mix, n_src=N, nfft=128, n_iter=4, algo="ip2", dtype=C128,
                           device="cpu")
        yj = japi.separate(mix, n_src=N, nfft=128, n_iter=4, algo="ip2", dtype=C128)
        np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-8)


def test_validation_probes():
    X = np.zeros((10, 9, 3), np.complex128)
    with pytest.raises(ValueError, match="IP2 needs"):
        tapi.overiva_ip2(X, n_src=1, device="cpu")
    with pytest.raises(ValueError, match="IP2 needs"):
        tapi.overiva_ip2_batch(X[None], n_src=1, device="cpu")
    with pytest.raises(ValueError, match="determined"):
        tapi.auxiva_ip2(X, n_src=2, device="cpu")
    with pytest.raises(ValueError, match="wcov"):
        tapi.overiva_ip2(X, n_src=2, wcov="fast", device="cpu")
    with pytest.raises(ValueError, match="source model"):
        tapi.overiva_ip2(X, n_src=2, model="bogus", device="cpu")
    with pytest.raises(ValueError, match="n_src >= 2"):
        tapi.separate(np.zeros((4096, 3)), n_src=1, nfft=256, algo="ip2", device="cpu")
