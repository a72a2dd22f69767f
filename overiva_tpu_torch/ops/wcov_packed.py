"""Packed bf16 weighted covariance: the ``wcov="bf16pack"`` tier.

Counterpart of ``overiva_tpu/ops/pallas_wcov.py``. All sources' weighted
covariances V[k, f] = (1/T) sum_t phi[t, k] x[t, f] x[t, f]^H from bf16
planes of X, with the weighted operand rounded to bf16 and f32
accumulation, as the Pallas kernel computes them.

- :func:`pack_planes` is the once-per-run pre-pass: a transpose and a cast
  to ``(F, M, T)`` bf16 real and imaginary planes. The TPU's 16-bin MXU
  packing and F padding are not carried over.
- :func:`wcov_packed_reference` is the plain PyTorch version.
- :func:`wcov_packed` is the wrapper: the CUDA kernel
  (``csrc/wcov_packed.cu``) for CUDA tensors, the plain version for CPU
  tensors. On a CUDA tensor it launches the kernel or raises. The kernel
  writes the complex64 result divided by the frame count itself, so the
  CUDA path runs one launch and nothing else on the device.
"""

from __future__ import annotations

import torch

__all__ = ["pack_planes", "wcov_packed", "wcov_packed_reference"]

MAX_THREADS = 1024  # M*M: one thread per (m, n) output on the M > 8 route


def pack_planes(X):
    """(T, F, M) complex -> ((F, M, T) bf16 real plane, same for imag)."""
    xr = X.real.permute(1, 2, 0).to(torch.bfloat16).contiguous()
    xi = X.imag.permute(1, 2, 0).to(torch.bfloat16).contiguous()
    return xr, xi


def wcov_packed_reference(xr, xi, phi):
    """Plain PyTorch version of the kernel: (vr, vi), each (K, F, M, M) f32.

    xr, xi: (F, M, T) bf16; phi: (T, K). The phi weights and the weighted
    planes are rounded to bf16 (bf16 x bf16 rounds the exact product to
    nearest even, as the kernel does); the contraction runs in f32.
    """
    w = phi.t().to(torch.bfloat16)[:, None, None, :]  # (K, 1, 1, T)
    wr = (xr[None] * w).float()  # (K, F, M, T), bf16-rounded products
    wi = (xi[None] * w).float()
    ar, ai = xr.float(), xi.float()

    def mm(a, b):
        return torch.einsum("kfmt,fnt->kfmn", a, b)

    return mm(wr, ar) + mm(wi, ai), mm(wi, ar) - mm(wr, ai)


def _launch(xr, xi, phi, n_frames: int):
    """The kernel on CUDA planes: (K, F, M, M) complex64, divided by
    ``n_frames``."""
    from .._build import library

    if xr.dtype != torch.bfloat16 or xi.dtype != torch.bfloat16:
        raise ValueError(f"planes must be bfloat16, got {xr.dtype}, {xi.dtype}")
    if xr.shape != xi.shape or xr.ndim != 3:
        raise ValueError(
            f"planes must both be (F, M, T), got {tuple(xr.shape)} and "
            f"{tuple(xi.shape)}"
        )
    F, M, T = xr.shape
    if phi.ndim != 2 or phi.shape[0] != T:
        raise ValueError(f"phi must be (T={T}, K), got {tuple(phi.shape)}")
    K = phi.shape[1]
    if M * M > MAX_THREADS:
        raise ValueError(
            f"M*M = {M * M} exceeds the block's {MAX_THREADS} threads"
        )
    n_frames = int(n_frames)
    if min(F, M, T, K, n_frames) < 1 or K > 65535:
        raise ValueError(
            f"unsupported shape F={F} M={M} T={T} K={K} n_frames={n_frames}"
        )
    if xi.device != xr.device or phi.device != xr.device:
        raise ValueError(
            f"all inputs must be on one device, got {xr.device}, "
            f"{xi.device}, {phi.device}"
        )
    if not (xr.is_contiguous() and xi.is_contiguous()):
        raise ValueError("planes must be contiguous")
    phi = phi.to(torch.float32).contiguous()
    V = torch.empty((K, F, M, M), dtype=torch.complex64, device=xr.device)
    lib = library()
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream(xr.device).cuda_stream
        err = lib.wcov_packed_launch(
            xr.data_ptr(), xi.data_ptr(), phi.data_ptr(), V.data_ptr(),
            F, M, T, K, n_frames, stream,
        )
    if err != 0:
        msg = lib.wcov_packed_error_string(err).decode()
        raise RuntimeError(f"wcov_packed launch failed: {msg} (cuda error {err})")
    wcov_packed.launches += 1
    return V


def wcov_packed(xpack, phi, n_frames: int):
    """All-source weighted covariances from packed planes.

    xpack: (xr, xi) from :func:`pack_planes`; phi: (T, K) real. Returns
    (K, F, M, M) complex64, divided by ``n_frames`` — a drop-in for
    ``weighted_covariance_all(X, phi, "bf16")``. ``wcov_packed.launches``
    counts kernel launches (CPU calls do not count).
    """
    xr, xi = xpack
    phi = phi.to(torch.float32)  # the kernel's weights are f32 (as on the TPU)
    if xr.device.type == "cpu":
        vr, vi = wcov_packed_reference(xr, xi, phi)
        return torch.complex(vr, vi) / n_frames
    if xr.device.type == "cuda":
        return _launch(xr, xi, phi, n_frames)
    raise ValueError(f"wcov_packed runs on cpu or cuda, not {xr.device}")


wcov_packed.launches = 0
