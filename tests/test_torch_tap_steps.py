"""PyTorch port: the tap-steering steps of a T-ISS epoch
(``ops/tap_steps.py``) on the CPU.

- ``tap_steps_reference`` is the steps as ``models/tiss.py::tap_steps``
  computed them before the kernel (frozen below), bit for bit, at
  complex64 and complex128, for one mixture and for folded mixtures.
- With a weight a bin (``n_mix`` = B*F: ILRMA-T's weights phi (T, B*F, M))
  the plain version gives the tap steps of ILRMA-T's epoch as it ran them
  before it shared T-ISS's (frozen below: a leading mixture axis,
  per-(t, f) weights).
- The rule by which a T-ISS epoch runs the kernel (``kernel_route``).
- ``tiss_iterations`` on the CPU: the plain steps, each ``tiss.taps``
  span saying ``kernel=0``; with the rule forced and the launcher replaced
  by the plain version, every epoch's steps go through the launcher, the
  spans say ``kernel=1`` and the run is unchanged bit for bit.
- The wrapper refuses what the kernel does not take, before any build.

The CUDA kernel against the plain version is in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

from overiva_tpu_torch.models import tiss as ttiss
from overiva_tpu_torch.ops import tap_steps as tts
from overiva_tpu_torch.utils.profiling import tracing


def _pre_change_tap_steps(P, Y, Z, phi, n_mix: int = 1):
    """``models/tiss.py::tap_steps`` as it was before the kernel, verbatim."""
    T, BF, M = Y.shape
    MK = Z.shape[2]
    F = BF // n_mix
    Zb = Z.reshape(T, n_mix, F, MK)
    den_all = torch.einsum("tbm,tbfj->bfmj", phi, Zb.abs() ** 2).reshape(BF, M, MK)
    vs = []
    for j in range(MK):
        zj = Z[:, :, j]
        num = torch.einsum("tbfm,tbf->bfm", phi[:, :, None, :] * Y.reshape(T, n_mix, F, M),
                           Zb[:, :, :, j].conj()).reshape(BF, M)
        v = num / torch.clamp_min(den_all[:, :, j], 1e-15)
        Y = Y - v[None, :, :] * zj[:, :, None]
        vs.append(v)
    P = P.clone()
    P[:, :, M:] -= torch.stack(vs, dim=2)
    return P, Y


def _state(T, n_mix, F, M, taps, dtype, seed):
    """An augmented input Xt (T, B*F, M + M*taps), P, Y and phi (T, B, M)."""
    rng = np.random.default_rng(seed)
    BF, MJ = n_mix * F, M * (1 + taps)

    def cplx(*shape):
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(z).to(dtype)

    Xt, P, Y = cplx(T, BF, MJ), cplx(BF, M, MJ), cplx(T, BF, M)
    phi = torch.from_numpy(rng.random((T, n_mix, M)) + 0.1).to(Y.real.dtype)
    return Xt, P, Y, phi


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n_mix", [1, 2, 3])
def test_reference_is_the_pre_change_steps(dtype, n_mix):
    """The plain version, on the strided view of Xt the epoch passes, gives
    the pre-change steps' P and Y bit for bit and leaves its inputs as
    they were."""
    Xt, P, Y, phi = _state(13, n_mix, 5, 3, 2, dtype, seed=20 + n_mix)
    Z = Xt[:, :, 3:]
    assert not Z.is_contiguous()
    P0, Y0 = P.clone(), Y.clone()
    got = tts.tap_steps_reference(P, Y, Z, phi, n_mix)
    want = _pre_change_tap_steps(P, Y, Z, phi, n_mix)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(P, P0) and torch.equal(Y, Y0)


def _pre_share_ilrma_t_taps(Xt, P, Y, phi, M):
    """The tap steps of ``models/ilrma_t.py::_ilrma_t_epoch`` before they
    became T-ISS's, verbatim: Xt (nb, T, F, MJ), P (nb, F, M, MJ), Y (nb,
    T, F, M), phi (nb, T, F, M)."""
    MK = Xt.shape[-1] - M
    Z = Xt[..., M:]  # (nb, T, F, MK)
    den_all = torch.einsum("btfm,btfj->bfmj", phi, Z.abs() ** 2)
    vs = []
    for j in range(MK):
        zj = Z[..., j]
        v = torch.einsum("btfm,btf->bfm", phi * Y, zj.conj()) / torch.clamp_min(
            den_all[..., j], 1e-15)
        Y = Y - v[:, None] * zj[..., None]
        vs.append(v)
    P = P.clone()
    P[..., M:] -= torch.stack(vs, dim=-1)
    return P, Y


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("nb", [1, 2])
def test_bin_weights_are_ilrma_t_tap_steps(dtype, nb):
    """Weights phi (T, B*F, M), one "mixture" a bin: the plain steps on the
    folded layout equal ILRMA-T's own former loop on the leading-axis
    layout (within rounding: the two contract over frames in other
    orders; 1e-12 at complex128, 1e-5 at complex64)."""
    T, F, M, taps = 17, 6, 3, 2
    Xt, P, Y, _ = _state(T, nb, F, M, taps, dtype, seed=40 + nb)
    MJ = Xt.shape[2]
    rng = np.random.default_rng(45 + nb)
    phi = torch.from_numpy(rng.random((T, nb * F, M)) + 0.1).to(Y.real.dtype)
    got_P, got_Y = tts.tap_steps_reference(P, Y, Xt[:, :, M:], phi, nb * F)

    def lead(a):  # (T, B*F, K) -> (B, T, F, K)
        return a.reshape(T, nb, F, a.shape[2]).transpose(0, 1)

    want_P, want_Y = _pre_share_ilrma_t_taps(lead(Xt), P.reshape(nb, F, M, MJ), lead(Y),
                                             lead(phi), M)
    tol = 1e-12 if dtype == torch.complex128 else 1e-5
    for got, want in ((got_P.reshape(nb, F, M, MJ), want_P), (lead(got_Y), want_Y)):
        assert (got - want).abs().max() <= tol * want.abs().max()


@pytest.mark.parametrize("n_mix", [1, 3])
def test_wrapper_on_cpu_is_the_reference(n_mix):
    """CPU tensors take the plain version through the wrapper; no launch
    is counted."""
    Xt, P, Y, phi = _state(11, n_mix, 4, 2, 3, torch.complex64, seed=30 + n_mix)
    before = tts.tap_steps.launches
    got = tts.tap_steps(P, Y, Xt[:, :, 2:], phi, n_mix)
    want = tts.tap_steps_reference(P, Y, Xt[:, :, 2:], phi, n_mix)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tts.tap_steps.launches == before
    assert ttiss.tap_steps is tts.tap_steps


@pytest.mark.parametrize(
    "device_type,dtype,M,MK,T,want",
    [
        ("cuda", torch.complex64, 8, 40, 192, True),  # the tiss_batch cell
        ("cuda", torch.complex64, 1, 1, 1, True),
        ("cuda", torch.complex64, 3, 10, 37, True),
        ("cuda", torch.complex64, tts.MAX_M, tts.MAX_MK, tts.MAX_T, True),
        ("cuda", torch.complex64, tts.MAX_M + 1, 40, 192, False),
        ("cuda", torch.complex64, 8, tts.MAX_MK + 1, 192, False),
        ("cuda", torch.complex64, 8, 40, tts.MAX_T + 1, False),
        ("cuda", torch.complex64, 8, 0, 192, False),  # taps = 0: no tap steps
        ("cuda", torch.complex64, 8, 40, 0, False),
        ("cuda", torch.complex64, 0, 40, 192, False),
        ("cuda", torch.complex128, 8, 40, 192, False),  # acc="f32x2", dtype=complex128
        ("cpu", torch.complex64, 8, 40, 192, False),
        ("cpu", torch.complex128, 8, 40, 192, False),
        ("meta", torch.complex64, 8, 40, 192, False),
    ],
)
def test_kernel_route(device_type, dtype, M, MK, T, want):
    """The kernel runs the tap steps of a CUDA complex64 epoch within its
    M, MK and T; everything else stays on the plain steps."""
    assert tts.kernel_route(device_type, dtype, M, MK, T) is want


def _run(Xt, M, N, n_mix, n_iter=3):
    P0 = ttiss.augmented_eye(Xt, M)
    with tracing() as tr:
        P, Y = ttiss.tiss_iterations(Xt, P0, n_iter, "laplace", M, N, n_mix=n_mix)
    return P, Y, [s["counts"] for s in tr.spans if s["name"] == "tiss.taps"]


@pytest.mark.parametrize("n_mix", [1, 3])
def test_tiss_iterations_on_cpu_run_the_plain_steps(n_mix):
    """On the CPU the route never engages: each epoch's ``tiss.taps``
    span says ``kernel=0`` beside its counts."""
    Xt, _, _, _ = _state(12, n_mix, 4, 3, 2, torch.complex64, seed=40 + n_mix)
    _, _, taps = _run(Xt, 3, 2, n_mix)
    assert taps == [{"steps": 6, "bins": 4 * n_mix, "frames": 12, "outputs": 3, "kernel": 0}] * 3


@pytest.mark.parametrize("n_mix", [1, 3])
def test_forced_route_runs_the_tap_steps_through_the_launcher(monkeypatch, n_mix):
    """With the rule forced on the CPU and the launcher replaced by the
    plain version, every epoch's tap steps go through the launcher once,
    on the strided view of Xt, each ``tiss.taps`` span says ``kernel=1``,
    and the run equals the unforced one bit for bit."""
    Xt, _, _, _ = _state(12, n_mix, 4, 3, 2, torch.complex64, seed=50 + n_mix)
    P_want, Y_want, _ = _run(Xt, 3, 2, n_mix)
    monkeypatch.setattr(ttiss, "kernel_route", lambda *a: True)
    calls = []

    def launcher(P, Y, Z, phi, n):
        calls.append((Z.data_ptr() - Xt.data_ptr(), Z.stride(), n))
        return tts.tap_steps_reference(P, Y, Z, phi, n)

    monkeypatch.setattr(ttiss, "tap_steps", launcher)
    P, Y, taps = _run(Xt, 3, 2, n_mix)
    assert calls == [(3 * Xt.element_size(), Xt.stride(), n_mix)] * 3
    assert [t["kernel"] for t in taps] == [1, 1, 1]
    assert torch.equal(P, P_want) and torch.equal(Y, Y_want)


def test_launch_validation():
    """The kernel wrapper refuses what the kernel does not take, before any
    build."""
    T, F, M, taps = 6, 4, 2, 2
    Xt, P, Y, phi = _state(T, 1, F, M, taps, torch.complex64, seed=60)
    Z = Xt[:, :, M:]
    with pytest.raises(ValueError, match="complex64 only"):
        tts._launch(P, Y.to(torch.complex128), Z, phi, 1)
    with pytest.raises(ValueError, match="float32"):
        tts._launch(P, Y, Z, phi.double(), 1)
    with pytest.raises(ValueError, match="P .B\\*F, M"):
        tts._launch(P[:, :, :-1], Y, Z, phi, 1)
    with pytest.raises(ValueError, match="dividing"):  # 3 mixtures do not split 4 bins
        tts._launch(P, Y, Z, torch.ones((T, 3, M)), 3)
    with pytest.raises(ValueError, match="phi must be"):
        tts._launch(P, Y, Z, phi[:, :, :1], 1)
    Z_apart = torch.zeros((T, F, 2 * M * taps), dtype=Z.dtype)[:, :, ::2]
    Z_apart.copy_(Z)
    with pytest.raises(ValueError, match="adjacent"):
        tts._launch(P, Y, Z_apart, phi, 1)
    big_M = tts.MAX_M + 1
    Xb, Pb, Yb, phib = _state(T, 1, F, big_M, 1, torch.complex64, seed=61)
    with pytest.raises(ValueError, match="1 <= M <="):
        tts._launch(Pb, Yb, Xb[:, :, big_M:], phib, 1)
    Xk, Pk, Yk, phik = _state(T, 1, F, 1, tts.MAX_MK + 1, torch.complex64, seed=62)
    with pytest.raises(ValueError, match="1 <= MK <="):
        tts._launch(Pk, Yk, Xk[:, :, 1:], phik, 1)
    Xl, Pl, Yl, phil = _state(tts.MAX_T + 1, 1, 1, M, 1, torch.complex64, seed=63)
    with pytest.raises(ValueError, match="1 <= T <="):
        tts._launch(Pl, Yl, Xl[:, :, M:], phil, 1)


def test_wrapper_refuses_other_devices():
    Xt, P, Y, phi = _state(5, 1, 2, 2, 1, torch.complex64, seed=64)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tts.tap_steps(*(t.to("meta") for t in (P, Y, Xt[:, :, 2:], phi)))
