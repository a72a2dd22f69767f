"""PyTorch port: batched small linear algebra and its guards against the
JAX package (``overiva_tpu.ops.linalg`` / ``ops.fminor``) on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overiva_tpu.oracle.models import align_eigvec_phase as oracle_align
from overiva_tpu.ops import fminor as jfm
from overiva_tpu.ops import linalg as jla
from overiva_tpu_torch.ops import linalg as tla

_jax_solve = jax.jit(jla.gauss_solve)


def _crandn(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 8])
def test_gauss_solve_matches_jax(m):
    rng = np.random.default_rng(100 + m)
    F = 24
    A = _crandn(rng, F, m, m)
    B = _crandn(rng, F, m, 2)
    # forced pivoting: a zero leading pivot, and a tie of equal magnitudes
    # in a column (argmax must take the first row, as jnp.argmax does)
    A[1, 0, 0] = 0.0
    if m >= 2:
        A[2, :, 0] = np.exp(1j * rng.uniform(0, 2 * np.pi, m))
    # singular bins: all zeros, and a zero column
    A[3] = 0.0
    A[4, :, m - 1] = 0.0
    Xj = np.asarray(_jax_solve(jnp.asarray(A), jnp.asarray(B)))
    Xt = tla.gauss_solve(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    assert np.isfinite(Xt).all()
    np.testing.assert_allclose(Xt, Xj, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(Xt[3], 0.0)
    healthy = np.r_[0:3, 5:F] if m > 1 else np.r_[0, 2, 5:F]
    np.testing.assert_allclose(
        Xt[healthy], np.linalg.solve(A[healthy], B[healthy]), rtol=0, atol=1e-10
    )


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_dead_threshold_follows_dtype(dtype):
    """A 1e-25 relative determinant is an essential zero in complex64
    (threshold sqrt(tiny) ~ 1.1e-19) but a valid pivot in complex128."""
    A = np.zeros((2, 2, 2), dtype)
    A[:, 0, 0] = 1.0
    A[:, 1, 1] = 1e-25
    A[1, 0, 1] = 0.5
    B = np.ones((2, 2, 1), dtype)
    Xt = tla.gauss_solve(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    Xj = np.asarray(_jax_solve(jnp.asarray(A), jnp.asarray(B)))
    np.testing.assert_allclose(Xt, Xj, rtol=1e-6, atol=0)
    if dtype == np.complex64:
        np.testing.assert_array_equal(Xt, 0.0)
    else:
        assert np.abs(Xt[0, 1, 0]) == pytest.approx(1e25)


def test_clamp_pow2():
    rng = np.random.default_rng(7)
    A = _crandn(rng, 16, 4, 3).astype(np.complex64)
    At = torch.from_numpy(A)
    # healthy bins: bit-unchanged
    assert torch.equal(tla.clamp_pow2(At), At)
    A[5] *= 1e30  # one huge bin: divided by an exact power of two
    got = tla.clamp_pow2(torch.from_numpy(A)).numpy()
    k = np.ceil(np.log2(np.abs(A[5]).max()))
    assert k == 101  # the same exponent as the JAX twin picks
    want = np.asarray(jla.clamp_pow2(jnp.asarray(A)))
    np.testing.assert_allclose(got[5], want[5], rtol=1e-6)
    # exact: each plane divided by 2**k (XLA's complex division on the CPU
    # is not exact here; the port's is)
    scale = np.float32(2.0**k)
    np.testing.assert_array_equal(got[5].real, A[5].real / scale)
    np.testing.assert_array_equal(got[5].imag, A[5].imag / scale)
    np.testing.assert_array_equal(np.delete(got, 5, axis=0), np.delete(A, 5, axis=0))


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_quad_form_good_mask_matches_jax(dtype):
    """Healthy bins carry significant bits; a w orthogonal to a rank-1 V
    cancels to rounding noise and is marked not good, as in JAX."""
    rng = np.random.default_rng(8)
    F, m = 10, 4
    u = _crandn(rng, F, m)
    V = np.einsum("fm,fn->fmn", u, u.conj()) + 0.1 * np.eye(m)
    w = _crandn(rng, F, m)
    for f in (2, 7):  # knife edge: rank-1 V, w orthogonal to u
        V[f] = np.outer(u[f], u[f].conj())
        w[f] = w[f] - (u[f].conj() @ w[f]) / (u[f].conj() @ u[f]) * u[f]
    V, w = V.astype(dtype), w.astype(dtype)
    s_t, good_t = tla.quad_form(torch.from_numpy(w), torch.from_numpy(V))
    s_j, good_j = jfm.quad_form_fm(
        jnp.asarray(w.T), jnp.asarray(np.transpose(V, (1, 2, 0)))
    )
    np.testing.assert_array_equal(good_t.numpy(), np.asarray(good_j))
    assert not good_t[2] and not good_t[7] and good_t.sum() == F - 2
    ok = good_t.numpy()
    np.testing.assert_allclose(s_t.numpy()[ok], np.asarray(s_j)[ok], rtol=1e-5)


def test_eigh_and_phase_alignment():
    rng = np.random.default_rng(9)
    E = _crandn(rng, 6, 5, 3)
    np.testing.assert_allclose(
        tla.align_eigvec_phase(torch.from_numpy(E)).numpy(), oracle_align(E),
        atol=1e-12,
    )
    X = _crandn(rng, 40, 6, 5)
    C = np.einsum("tfm,tfn->fmn", X, X.conj()) / 40
    vals, vecs = tla.eigh(torch.from_numpy(C))
    assert torch.all(vals[:, 1:] >= vals[:, :-1])  # ascending
    np.testing.assert_allclose(
        (torch.from_numpy(C) @ vecs).numpy(), (vecs * vals[:, None, :]).numpy(),
        atol=1e-10,
    )


@pytest.mark.parametrize("m", [1, 2, 3, 5, 8])
def test_gauss_solve_singular_is_finite(m):
    """Exactly singular systems (rank 1, zero) at complex64: finite output,
    never NaN/inf (tests/test_singular_robustness.py's cases)."""
    rng = np.random.default_rng(0)
    F = 7
    u = _crandn(rng, F, m)
    A1 = (u[:, :, None] * u[:, None, :].conj()).astype(np.complex64)
    B = (rng.standard_normal((F, m, 2)) + 0j).astype(np.complex64)
    for A in (A1, np.zeros((F, m, m), np.complex64)):
        X = tla.gauss_solve(torch.from_numpy(A), torch.from_numpy(B))
        assert torch.isfinite(X).all()


@pytest.mark.parametrize("m", [2, 3, 5, 8])
@pytest.mark.parametrize("spread", [1e-4, 1e-6])
def test_gauss_solve_spread_eigenvalues_not_zeroed(m, spread):
    """Near-rank-1 Hermitian systems (the healthy state of an N=1 weighted
    covariance) are solved, not declared dead: accurate at cond 1e4, and
    the right magnitude at cond 1e6 where complex64 keeps few digits."""
    rng = np.random.default_rng(3)
    F = 5
    Q, _ = np.linalg.qr(_crandn(rng, F, m, m))
    ew = np.geomspace(1.0, spread, m)[None, :] * np.ones((F, 1))
    A = ((Q * ew[:, None, :]) @ Q.conj().transpose(0, 2, 1)).astype(np.complex64)
    B = np.zeros((F, m, 1), np.complex64)
    B[:, 0, 0] = 1.0
    ref = np.linalg.solve(A.astype(np.complex128), B.astype(np.complex128))
    X = tla.gauss_solve(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    assert np.isfinite(X).all()
    if spread == 1e-4:
        rel = np.abs(X - ref) / np.abs(ref).max(axis=(1, 2), keepdims=True)
        assert rel.max() < 0.05, f"solve off by {rel.max():.2%}"
    else:  # a zeroed bin would be off by 1e6, not 10x
        ratio = np.abs(X).max(axis=(1, 2)) / np.abs(ref).max(axis=(1, 2))
        assert np.all((ratio > 0.1) & (ratio < 10.0)), ratio


def test_quad_form_cancellation_trips_guard():
    """A 1e12-spread spectrum and a large w in its near-null space: the
    complex64 form is rounding noise and every bin is marked not good."""
    rng = np.random.default_rng(7)
    F, m = 9, 4
    Q, _ = np.linalg.qr(_crandn(rng, F, m, m))
    ew = np.geomspace(1.0, 1e-12, m)[None, :] * np.ones((F, 1))
    V = ((Q * ew[:, None, :]) @ Q.conj().transpose(0, 2, 1)).astype(np.complex64)
    w = Q[:, :, -1].astype(np.complex64) * 1e4
    _, good = tla.quad_form(torch.from_numpy(w), torch.from_numpy(V))
    assert not good.any()


@pytest.mark.parametrize("shape", [(13, 4, 4), (3, 5, 3, 3), (7, 2, 2)])
def test_eigh_chunks_equal_one_call(monkeypatch, shape):
    """A batch above ``EIGH_BATCH`` runs as the fewest equal chunks, each
    matrix decomposed on its own: bit for bit one call's results, on the
    CPU as on a card (5 here in place of 24,576)."""
    monkeypatch.setattr(tla, "EIGH_BATCH", 5)
    rng = np.random.default_rng(sum(shape))
    A = _crandn(rng, *shape)
    A = torch.from_numpy(A + np.conj(np.swapaxes(A, -1, -2)))
    want = torch.linalg.eigh(A)
    calls = []
    eigh = torch.linalg.eigh
    monkeypatch.setattr(torch.linalg, "eigh", lambda a: calls.append(a.shape[0]) or eigh(a))
    w, v = tla.eigh(A)
    n = int(np.prod(shape[:-2]))
    assert len(calls) == tla.eigh_chunks(n) == -(-n // 5)
    assert max(calls) - min(calls) <= 1 and sum(calls) == n
    assert torch.equal(w, want[0]) and torch.equal(v, want[1])


def test_eigh_chunks_at_the_benchmark_groups():
    """8 folded rooms of 2,049 bins stay one call; 16 become two of
    16,392."""
    assert tla.eigh_chunks(2049) == tla.eigh_chunks(8 * 2049) == 1
    assert tla.eigh_chunks(16 * 2049) == 2
    assert [len(c) for c in torch.empty(16 * 2049).tensor_split(2)] == [16392, 16392]
