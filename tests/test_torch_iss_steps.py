"""PyTorch port: the source-steering steps of an ISS or T-ISS epoch
(``ops/iss_steps.py``) on the CPU.

- ``iss_steps_reference`` is the steps as ``models/auxiva_iss.py::iss_steps``
  computed them before the kernel (frozen below), bit for bit, at
  complex64 and complex128, for one mixture and for folded mixtures, with
  square rows (ISS) and augmented rows (T-ISS).
- The wrapper on the CPU is the reference.
- The rule by which an epoch runs the kernel (``kernel_route``).
- With the rule forced on the CPU and the launcher replaced by the plain
  version, every ISS and T-ISS epoch's source steps go through the
  launcher, the spans say ``kernel=1`` and the run is unchanged bit for bit.
- The launcher refuses what the kernel does not take, before any build.

The CUDA kernel against the plain version is in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

from overiva_tpu_torch.models import auxiva_iss as iss_model
from overiva_tpu_torch.models import tiss as ttiss
from overiva_tpu_torch.models.family import run_family
from overiva_tpu_torch.ops import iss_steps as tis
from overiva_tpu_torch.utils.profiling import tracing


def _pre_change_iss_steps(W, Y, phi, n_mix: int = 1):
    """``models/auxiva_iss.py::iss_steps`` as it was before the kernel, verbatim."""
    T, BF, M = Y.shape
    F = BF // n_mix
    col = torch.arange(M, device=Y.device)[None, :]
    for n in range(M):  # order-dependent
        Yb = Y.reshape(T, n_mix, F, M)
        ynb = Yb[:, :, :, n]  # (T, B, F)
        num = torch.einsum("tbfm,tbf->bfm", phi[:, :, None, :] * Yb, ynb.conj()).reshape(BF, M)
        den = torch.einsum("tbm,tbf->bfm", phi, (ynb * ynb.conj()).real).reshape(BF, M)
        v = num / torch.clamp_min(den, 1e-15)
        dnn = den[:, n] / T
        vnn = 1.0 - torch.rsqrt(torch.clamp_min(dnn, 1e-15))
        v = torch.where(col == n, vnn[:, None].to(v.dtype), v)
        Y = Y - v[None, :, :] * Y[:, :, n, None]
        W = W - v[:, :, None] * W[:, n, None, :]
    return W, Y


def _state(T, n_mix, F, M, J, dtype, seed):
    """W (B*F, M, J), Y (T, B*F, M) and phi (T, B, M)."""
    rng = np.random.default_rng(seed)
    BF = n_mix * F

    def cplx(*shape):
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(z).to(dtype)

    W, Y = cplx(BF, M, J), cplx(T, BF, M)
    phi = torch.from_numpy(rng.random((T, n_mix, M)) + 0.1).to(Y.real.dtype)
    return W, Y, phi


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n_mix", [1, 3])
@pytest.mark.parametrize("taps", [0, 2])
def test_reference_is_the_pre_change_steps(dtype, n_mix, taps):
    """The plain version gives the pre-change steps' W and Y bit for bit, for
    J = M and J = M + M x taps, and leaves its inputs as they were."""
    M = 3
    W, Y, phi = _state(13, n_mix, 5, M, M * (1 + taps), dtype, seed=70 + n_mix + taps)
    W0, Y0 = W.clone(), Y.clone()
    got = tis.iss_steps_reference(W, Y, phi, n_mix)
    want = _pre_change_iss_steps(W, Y, phi, n_mix)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(W, W0) and torch.equal(Y, Y0)


@pytest.mark.parametrize("n_mix", [1, 3])
def test_wrapper_on_cpu_is_the_reference(n_mix):
    """CPU tensors take the plain version through the wrapper, which the ISS
    epochs call; no launch is counted."""
    W, Y, phi = _state(11, n_mix, 4, 2, 8, torch.complex64, seed=80 + n_mix)
    before = tis.iss_steps.launches
    want = tis.iss_steps_reference(W, Y, phi, n_mix)
    got = tis.iss_steps(W, Y, phi, n_mix)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not tis.steps_route(W, Y)
    assert tis.iss_steps.launches == before
    assert iss_model.iss_steps is tis.iss_steps


@pytest.mark.parametrize(
    "device_type,dtype,M,J,T,want",
    [
        ("cuda", torch.complex64, 8, 48, 192, True),  # the tiss_batch cell
        ("cuda", torch.complex64, 8, 8, 56, True),  # ISS: J = M
        ("cuda", torch.complex64, 1, 1, 1, True),
        ("cuda", torch.complex64, 3, 9, 37, True),
        ("cuda", torch.complex64, 8, 136, 192, True),  # every routed tap_steps width
        ("cuda", torch.complex64, tis.MAX_M, 4096, tis.MAX_T, True),  # J: no upper limit
        ("cuda", torch.complex64, tis.MAX_M + 1, 48, 192, False),
        ("cuda", torch.complex64, 8, 7, 192, False),  # J < M: no such rows
        ("cuda", torch.complex64, 8, 48, tis.MAX_T + 1, False),
        ("cuda", torch.complex64, 8, 48, 0, False),
        ("cuda", torch.complex64, 0, 48, 192, False),
        ("cuda", torch.complex128, 8, 48, 192, False),  # acc="f32x2", dtype=complex128
        ("cpu", torch.complex64, 8, 48, 192, False),
        ("cpu", torch.complex128, 8, 48, 192, False),
        ("meta", torch.complex64, 8, 48, 192, False),
    ],
)
def test_kernel_route(device_type, dtype, M, J, T, want):
    """The kernel runs the source steps of a CUDA complex64 epoch within its
    M, J and T; everything else stays on the plain steps."""
    assert tis.kernel_route(device_type, dtype, M, J, T) is want


def _runs(n_mix, n_iter=3):
    """A T-ISS run (M=3, N=2, 2 taps) and an OverIVA-ISS run (M=3, N=2) on
    the CPU, traced: their outputs and the ``kernel`` counts of the spans
    around their source steps."""
    W, Y, _ = _state(12, n_mix, 4, 3, 9, torch.complex64, seed=90 + n_mix)
    Xt = ttiss.augment_taps(Y, 2, 1)
    with tracing() as tr:
        P, Yt = ttiss.tiss_iterations(Xt, ttiss.augmented_eye(Xt, 3), n_iter, "laplace", 3, 2,
                                      n_mix=n_mix)
        Yi, Wi = run_family(Y, 2, n_iter, "laplace", "iss", n_mix=n_mix)
    # T-ISS's epochs carry no kernel count (their steps have spans of their own)
    kernel = {name: [s["counts"]["kernel"] for s in tr.spans
                     if s["name"] == name and "kernel" in s["counts"]]
              for name in ("tiss.sources", "family.epoch")}
    return (P, Yt, Yi, Wi), kernel


@pytest.mark.parametrize("n_mix", [1, 3])
def test_forced_route_runs_the_source_steps_through_the_launcher(monkeypatch, n_mix):
    """On the CPU every span says ``kernel=0``. With the rule forced and the
    launcher replaced by the plain version, every epoch's source steps go
    through the launcher once, the spans (``tiss.sources``; ISS:
    ``family.epoch``) say ``kernel=1``, and both runs equal the unforced
    ones bit for bit."""
    want, kernel = _runs(n_mix)
    assert kernel == {"tiss.sources": [0] * 3, "family.epoch": [0] * 3}
    monkeypatch.setattr(tis, "kernel_route", lambda *a: True)
    calls = []

    def launcher(W, Y, phi, n):
        calls.append((W.shape[2], n))
        return tis.iss_steps_reference(W, Y, phi, n)

    monkeypatch.setattr(tis, "_launch", launcher)
    got, kernel = _runs(n_mix)
    assert calls == [(9, n_mix)] * 3 + [(3, n_mix)] * 3
    assert kernel == {"tiss.sources": [1] * 3, "family.epoch": [1] * 3}
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_launch_validation():
    """The kernel wrapper refuses what the kernel does not take, before any
    build."""
    T, F, M = 6, 4, 2
    W, Y, phi = _state(T, 1, F, M, 6, torch.complex64, seed=100)
    with pytest.raises(ValueError, match="complex64 only"):
        tis._launch(W, Y.to(torch.complex128), phi, 1)
    with pytest.raises(ValueError, match="complex64 only"):
        tis._launch(W.to(torch.complex128), Y, phi, 1)
    with pytest.raises(ValueError, match="float32"):
        tis._launch(W, Y, phi.double(), 1)
    with pytest.raises(ValueError, match="must be .T, B\\*F, M. and"):
        tis._launch(W, Y[0], phi, 1)
    with pytest.raises(ValueError, match="W must be"):
        tis._launch(W[:, :1], Y, phi, 1)
    with pytest.raises(ValueError, match="dividing"):  # 3 mixtures do not split 4 bins
        tis._launch(W, Y, torch.ones((T, 3, M)), 3)
    with pytest.raises(ValueError, match="phi must be"):
        tis._launch(W, Y, phi[:, :, :1], 1)
    big_M = tis.MAX_M + 1
    with pytest.raises(ValueError, match="1 <= M <="):
        tis._launch(*_state(T, 1, F, big_M, big_M, torch.complex64, seed=101), 1)
    W3, Y3, phi3 = _state(T, 1, F, 3, 3, torch.complex64, seed=103)
    with pytest.raises(ValueError, match="J >= M"):  # fewer columns than rows
        tis._launch(W3[:, :, :2], Y3, phi3, 1)
    with pytest.raises(ValueError, match="1 <= T <="):
        tis._launch(*_state(tis.MAX_T + 1, 1, 1, M, M, torch.complex64, seed=104), 1)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_launcher_refuses_other_devices(device):
    """The launcher takes CUDA tensors only."""
    W, Y, phi = _state(5, 1, 2, 2, 2, torch.complex64, seed=105)
    with pytest.raises(ValueError, match="runs on cuda"):
        tis._launch(*(t.to(device) for t in (W, Y, phi)), 1)
