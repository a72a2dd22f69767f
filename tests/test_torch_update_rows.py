"""PyTorch port: the fused per-bin IP update (``ops/update_rows.py``)
against the JAX package on the CPU.

- The port's ``update_rows`` (its plain version on CPU tensors) against
  the Pallas kernel ``pallas_update_rows`` in interpret mode and its NumPy
  reference, on the well-conditioned inputs of tests/test_pallas_epoch.py,
  at that test's own gate: 1e-5 of max|W|.
- The plain version against the port's eager ``_epoch`` given the same phi,
  bit for bit, and the refactored ``_epoch`` against the loop it replaced.
- Knife-edge bins (silent, rank-1): finite, previous rows kept exactly
  where the eager epoch keeps them, and the same decisions as the JAX
  package's production ``_epoch``.
- ``_fused_epoch`` iterated against ``_epoch`` at complex128, for one
  mixture and for mixtures folded into the bin axis (phi (T, B, N)).
- The rule by which ``overiva_iterations`` runs the kernel
  (``kernel_route``), and ``overiva_iterations`` on the CPU: the eager
  epochs bit for bit, and the routed epochs too where the rule is forced.

The CUDA kernel against the plain version is in tests/test_torch_gpu.py.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overiva_tpu.models import overiva as jcore
from overiva_tpu.ops.pallas_epoch import BLOCK_F, pallas_update_rows
from overiva_tpu_torch.models import overiva as tcore
from overiva_tpu_torch.models.source_models import activations_from_power, power
from overiva_tpu_torch.ops import update_rows as tur
from overiva_tpu_torch.ops.linalg import clamp_pow2, gauss_solve, mat_h, quad_form
from overiva_tpu_torch.utils.convert import planes_to_torch, state_to_torch

from test_pallas_epoch import _numpy_update


def _pallas_inputs(M, N):
    """The inputs of tests/test_pallas_epoch.py::test_kernel_matches_numpy."""
    T, F = 16, BLOCK_F
    rng = np.random.default_rng(7)
    X = (rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))).astype(
        np.complex64
    )
    phi = (rng.random((T, N)) + 0.1).astype(np.float32)
    Cx = (np.einsum("tfm,tfn->fmn", X, np.conj(X)) / T).astype(np.complex64)
    W = np.tile(np.eye(M, dtype=np.complex64), (F, 1, 1))
    if N < M:
        W[:, N:, N:] = -np.eye(M - N, dtype=np.complex64)
        tmp = W[:, :N, :] @ Cx
        JH = np.linalg.solve(tmp[:, :, :N], tmp[:, :, N:])
        W[:, N:, :N] = np.conj(np.swapaxes(JH, 1, 2))
    return X, phi, Cx, W


@pytest.mark.parametrize("M,N", [(5, 2), (4, 4), (8, 3)])
def test_update_rows_matches_pallas_interpret(M, N):
    X, phi, Cx, W = _pallas_inputs(M, N)
    Wr, Wi = pallas_update_rows(
        jnp.asarray(phi), jnp.asarray(X.real), jnp.asarray(X.imag),
        jnp.asarray(Cx.real), jnp.asarray(Cx.imag),
        jnp.asarray(W.real), jnp.asarray(W.imag), n_src=N, interpret=True,
    )
    Wj = planes_to_torch(np.asarray(Wr), np.asarray(Wi), "cpu")
    s = state_to_torch({"X": X, "Cx": Cx, "W": W}, "cpu")
    before = tur.update_rows.launches
    Wt = tur.update_rows(torch.from_numpy(phi), s["X"], s["Cx"], s["W"], N)
    assert tur.update_rows.launches == before  # CPU: the plain version
    assert Wt.dtype == torch.complex64 and Wt.shape == (BLOCK_F, M, M)
    scale = Wj.abs().max().item()
    assert (Wt - Wj).abs().max().item() < 1e-5 * scale
    Wref = _numpy_update(X, phi, Cx, W, N)
    assert np.abs(Wt.numpy() - Wref).max() < 1e-5 * np.abs(Wref).max()


def _state(M, N, dtype, seed, T=40, F=9, n_mix=1):
    """X (T, n_mix * F, M): ``n_mix`` mixtures of F bins (9, not a multiple
    of the kernel's 8 bins a block) folded into the bin axis."""
    rng = np.random.default_rng(seed)
    F = F * n_mix
    X = rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))
    X = torch.from_numpy(X).to(dtype)
    W0 = rng.standard_normal((F, N, M)) + 1j * rng.standard_normal((F, N, M))
    W, Cx = tcore.prepare(X, N, False, W0=torch.from_numpy(W0).to(dtype))
    return X, W, Cx


def _epoch_loop_before_refactor(X, W_hat, Cx, n_src, model):
    """The eager epoch as it was written before its IP + OC chain moved
    into ``ops/update_rows.py::ip_rows`` (f32 tier)."""
    from overiva_tpu_torch.ops.covariance import weighted_covariance_all

    T, F, M = X.shape
    N = n_src
    _, phi = activations_from_power(power(tcore.demix(X, W_hat[:, :N, :])), F, model)
    W = W_hat.clone()
    tmp = W[:, :N, :] @ Cx if N < M else None
    Vs = weighted_covariance_all(X, phi, "f32")
    for k in range(N):
        V = Vs[k]
        e_k = torch.zeros((F, M, 1), dtype=X.dtype, device=X.device)
        e_k[:, k] = 1.0
        w = clamp_pow2(gauss_solve(W @ V, e_k)[:, :, 0])
        denom, good = quad_form(w, V)
        w = w / torch.sqrt(torch.where(good, denom, torch.ones_like(denom)))[:, None]
        w = torch.where(good[:, None], w, W[:, k].conj())
        W[:, k] = w.conj()
        if N < M:
            tmp[:, k] = (w.conj()[:, None, :] @ Cx)[:, 0]
            J_H = clamp_pow2(gauss_solve(tmp[:, :, :N], tmp[:, :, N:]))
            W[:, N:, :N] = mat_h(J_H)
    return W


@pytest.mark.parametrize("n_mix", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("M,N", [(2, 2), (5, 2), (8, 3)])
def test_reference_is_the_eager_epoch_bit_for_bit(M, N, dtype, n_mix):
    """phi (T, N), or (T, B, N) of B folded mixtures: the plain version is
    the eager epoch's covariances (``epoch_covariances``) and ``ip_rows``.
    Folded, each mixture's rows are those of the mixture run alone."""
    X, W, Cx = _state(M, N, dtype, seed=M * 10 + N, n_mix=n_mix)
    W_epoch = tcore._epoch(X, W, Cx, N, "laplace", n_mix=n_mix)
    if n_mix == 1:
        _, phi = activations_from_power(power(tcore.demix(X, W[:, :N, :])), X.shape[1],
                                        "laplace")
        assert torch.equal(tur.update_rows_reference(phi, X, Cx, W, N), W_epoch)
        assert torch.equal(_epoch_loop_before_refactor(X, W, Cx, N, "laplace"), W_epoch)
        return
    phi = tcore.mixture_activations(tcore.demix(X, W[:, :N, :]), "laplace", n_mix)
    assert phi.shape == (X.shape[0], n_mix, N)
    Vs = tcore.epoch_covariances(X, W, N, "laplace", n_mix=n_mix)
    assert torch.equal(tur.update_rows_reference(phi, X, Cx, W, N), W_epoch)
    assert torch.equal(tur.ip_rows(W, Vs, Cx, N), W_epoch)
    F = X.shape[1] // n_mix
    for b in range(n_mix):
        sl = slice(b * F, (b + 1) * F)
        alone = tur.update_rows_reference(phi[:, b], X[:, sl], Cx[sl], W[sl], N)
        tol = 1e-5 if dtype == torch.complex64 else 1e-12
        assert (W_epoch[sl] - alone).abs().max().item() <= tol * alone.abs().max().item()


def _knife_edge(seed, M=5, N=2, T=32, F=12):
    """Bins 0-2 silent, bins 3-5 rank-1, the rest well-conditioned."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))
    X[:, :3] = 0
    X[:, 3:6] = rng.standard_normal((T, 3, 1)) * (
        rng.standard_normal((1, 3, M)) + 1j * rng.standard_normal((1, 3, M))
    )
    return X.astype(np.complex64)


def _kept(W_new, W_old, N):
    return (W_new[:, :N] == W_old[:, :N]).all(axis=-1)


@pytest.mark.parametrize("M,N", [(5, 2), (4, 4)])
def test_knife_edge_bins_keep_rows_like_the_eager_epoch(M, N):
    X = _knife_edge(3 + M, M=M, N=N)
    Xt = torch.from_numpy(X)
    W, Cx = tcore.prepare(Xt, N, False)
    _, phi = activations_from_power(power(tcore.demix(Xt, W[:, :N, :])), X.shape[1], "laplace")
    W_new = tur.update_rows(phi, Xt, Cx, W, N)
    assert torch.isfinite(W_new).all()
    assert torch.equal(W_new, tcore._epoch(Xt, W, Cx, N, "laplace"))
    kept = _kept(W_new.numpy(), W.numpy(), N)
    assert kept[:3].all()  # silent bins: dead solve, previous rows kept exactly
    assert not kept[6:].any()  # healthy bins move
    if N < M:
        assert (W_new[:3, N:, :N] == 0).all()  # dead OC solve: J = 0
    # the JAX package's production epoch takes the same decisions
    Wj = np.asarray(
        jax.jit(partial(jcore._epoch, n_src=N, model="laplace"))(
            jnp.asarray(X), jnp.asarray(W.numpy()), jnp.asarray(Cx.numpy())
        )
    )
    assert np.isfinite(Wj).all()
    np.testing.assert_array_equal(kept, _kept(Wj, W.numpy(), N))


@pytest.mark.parametrize("n_mix", [1, 2, 3])
def test_fused_epochs_follow_the_eager_epochs(n_mix):
    """8 epochs through _fused_epoch against 8 through _epoch, complex128;
    with n_mix > 1 the mixtures (65 bins each) are folded into the bin axis
    and each weights its own bins."""
    rng = np.random.default_rng(64)
    T, F, M, N = 64, 65 * n_mix, 5, 2
    X = torch.from_numpy(rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M)))
    W0, Cx = tcore.prepare(X, N, False)
    Wf, We = W0, W0
    for _ in range(8):
        Wf = tcore._fused_epoch(X, Wf, Cx, N, "laplace", n_mix)
        We = tcore._epoch(X, We, Cx, N, "laplace", n_mix=n_mix)
    np.testing.assert_allclose(Wf.numpy(), We.numpy(), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize(
    "device_type,dtype,wcov,M,want",
    [
        ("cuda", torch.complex64, "f32", 8, True),
        ("cuda", torch.complex64, "f32x3", 8, True),
        ("cuda", torch.complex64, "f32", 1, True),
        ("cuda", torch.complex64, "f32", tur.MAX_M, True),
        ("cuda", torch.complex64, "f32", tur.MAX_M + 1, False),
        ("cpu", torch.complex64, "f32", 8, False),
        ("cuda", torch.complex128, "f32", 8, False),  # acc="f32x2", dtype=complex128
        ("cuda", torch.complex64, "bf16", 8, False),
        ("cuda", torch.complex64, "bf16pack", 8, False),
        ("meta", torch.complex64, "f32", 8, False),
    ],
)
def test_kernel_route(device_type, dtype, wcov, M, want):
    """The kernel runs the IP epochs of a CUDA complex64 X of the exact-f32
    tier within its M; everything else stays on the eager epoch."""
    assert tur.kernel_route(device_type, dtype, wcov, M) is want


def _eager_epochs(X, W, Cx, N, n_iter, wcov, n_mix):
    for _ in range(n_iter):
        W = tcore._epoch(X, W, Cx, N, "laplace", None, wcov, None, n_mix)
    return W


@pytest.mark.parametrize("wcov", ["f32", "f32x3", "bf16"])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n_mix", [1, 2])
def test_overiva_iterations_on_cpu_are_the_eager_epochs(n_mix, dtype, wcov):
    """On the CPU the route never engages: ``overiva_iterations`` is the
    loop of eager epochs bit for bit, and each epoch's span says
    ``kernel=0``."""
    from overiva_tpu_torch.utils.profiling import tracing

    X, W, Cx = _state(5, 2, dtype, seed=11, n_mix=n_mix)
    with tracing() as tr:
        got = tcore.overiva_iterations(X, W, Cx, 2, 3, "laplace", wcov=wcov, n_mix=n_mix)
    assert torch.equal(got, _eager_epochs(X, W, Cx, 2, 3, wcov, n_mix))
    assert [s["counts"]["kernel"] for s in tr.spans] == [0, 0, 0]


@pytest.mark.parametrize("n_mix", [1, 3])
def test_forced_route_runs_the_fused_epochs(monkeypatch, n_mix):
    """With the rule forced on the CPU, ``overiva_iterations`` runs
    ``_fused_epoch`` (the plain version of the kernel) on the same phi, so
    on strided inputs it still gives the eager epochs bit for bit, and each
    epoch's span says ``kernel=1``."""
    from overiva_tpu_torch.utils.profiling import tracing

    X, W, Cx = _state(5, 2, torch.complex64, seed=12, n_mix=n_mix)
    Xs = X.transpose(0, 1).contiguous().transpose(0, 1)  # same values, strided
    assert not Xs.is_contiguous()
    monkeypatch.setattr(tcore, "kernel_route", lambda *a: True)
    calls = []
    fused = tcore._fused_epoch
    monkeypatch.setattr(tcore, "_fused_epoch",
                        lambda X, *a: calls.append(X.is_contiguous()) or fused(X, *a))
    with tracing() as tr:
        got = tcore.overiva_iterations(Xs, W, Cx, 2, 4, "laplace", chunk_frames=8,
                                       n_mix=n_mix)
    assert calls == [True] * 4  # made contiguous once, before the loop
    assert torch.equal(got, _eager_epochs(X, W, Cx, 2, 4, "f32", n_mix))
    assert [s["counts"]["kernel"] for s in tr.spans] == [1, 1, 1, 1]


def test_launch_validation():
    """The kernel wrapper refuses what the kernel does not take, before any
    build."""
    T, F, M, N = 6, 3, 4, 2
    X = torch.zeros((T, F, M), dtype=torch.complex64)
    W = torch.zeros((F, M, M), dtype=torch.complex64)
    phi = torch.ones((T, N))
    with pytest.raises(ValueError, match="complex64 only"):
        tur._launch(phi, X.to(torch.complex128), W, W, N)
    with pytest.raises(ValueError, match="float32"):
        tur._launch(phi.double(), X, W, W, N)
    with pytest.raises(ValueError, match="phi must be"):
        tur._launch(torch.ones((T, N + 1)), X, W, W, N)
    for B in (2, 0):  # folded phi: B mixtures must split the F = 3 bins
        with pytest.raises(ValueError, match="B dividing"):
            tur._launch(torch.ones((T, B, N)), X, W, W, N)
    with pytest.raises(ValueError, match="M <= 32"):
        big = torch.zeros((F, 33, 33), dtype=torch.complex64)
        tur._launch(phi, torch.zeros((T, F, 33), dtype=torch.complex64), big, big, N)
    with pytest.raises(ValueError, match="contiguous"):
        tur._launch(phi, X, W.transpose(1, 2), W, N)
    with pytest.raises(ValueError, match="one device"):
        tur._launch(phi, X.to("meta"), W, W, N)
    with pytest.raises(ValueError, match="n_src"):
        tur._launch(torch.ones((T, 5)), X, W, W, 5)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tur.update_rows(phi.to("meta"), X.to("meta"), W.to("meta"), W.to("meta"), N)


def test_planes_to_torch():
    re = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = planes_to_torch(re, -re, "cpu")
    assert t.dtype == torch.complex64
    np.testing.assert_array_equal(t.numpy(), re - 1j * re)
    with pytest.raises(ValueError, match="plane shapes"):
        planes_to_torch(re, re.T, "cpu")
