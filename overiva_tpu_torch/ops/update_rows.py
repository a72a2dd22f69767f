"""Fused per-bin IP update: everything in an epoch after the activations.

Counterpart of ``overiva_tpu/ops/pallas_epoch.py::pallas_update_rows``.
Given phi, for each source k in order and every bin: the weighted
covariance V_k, the IP solve (W V_k) w = e_k, the guarded normalization
w / sqrt(w^H V_k w), the row write W[k] = conj(w) and, when N < M, the
orthogonal constraint J^H = solve((W1 Cx)[:, :N], (W1 Cx)[:, N:]).

- :func:`ip_rows` is the per-source IP + OC chain of the eager epoch
  (``models/overiva.py::_epoch``), given all N weighted covariances.
- :func:`update_rows_reference` is the plain PyTorch version of the kernel:
  the f32-tier weighted covariances, then :func:`ip_rows`.
- :func:`update_rows` is the wrapper: the CUDA kernel
  (``csrc/update_rows.cu``; a warp per bin for 2 <= M <= 8, a block per
  bin for larger M, chosen inside the launch) for CUDA tensors, the plain
  version for CPU tensors. On a CUDA tensor it launches the kernel or
  raises.
- :func:`kernel_route` is the rule by which the IP epochs
  (``models/overiva.py::overiva_iterations``) run the kernel: a CUDA
  complex64 X of the exact-f32 tier, within the kernel's M.

phi is (T, N) for one mixture, or (T, B, N) for B mixtures folded into the
bin axis (``models/overiva.py::fold_mixtures``): bin f is weighted by the
phi of mixture f // (F / B).

Unlike the Pallas kernel, both carry the production guards of
``ops/linalg.py`` (dead pivots, ``clamp_pow2``, the ``quad_form``
keep-previous-row mask). The JAX layout is kept at the public function:
X (T, F, M), W and Cx (F, M, M), phi (T, N); the TPU's F padding to 128 and
its split into float planes are not carried over.
"""

from __future__ import annotations

import torch

from .covariance import weighted_covariance_mixtures
from .linalg import clamp_pow2, gauss_solve, mat_h, quad_form

__all__ = ["MAX_M", "ip_rows", "kernel_route", "update_rows", "update_rows_reference"]

MAX_M = 32  # the block-per-bin kernel: one thread per (m, n), M * M <= 1024
# the wcov tiers whose weighted covariances are exact f32 products
KERNEL_WCOV = ("f32", "f32x3")


def kernel_route(device_type: str, dtype, wcov: str, M: int) -> bool:
    """Whether an IP epoch over X of this device type, dtype and channel
    count M, at weighted-covariance tier ``wcov``, runs the kernel: CUDA,
    complex64, the exact-f32 tier, and 1 <= M <= :data:`MAX_M`. Everything
    else (CPU, complex128, ``bf16``, ``bf16pack``) runs the eager epoch."""
    return (device_type == "cuda" and dtype == torch.complex64
            and str(wcov) in KERNEL_WCOV and 1 <= M <= MAX_M)


def ip_rows(W_hat, Vs, Cx, n_src: int):
    """The N IP row updates in order, each followed by the OC update.

    W_hat, Cx: (F, M, M); Vs: (N, F, M, M) weighted covariances. Returns
    the new W_hat. ``tmp = W1 Cx`` is kept up to date row by row: each IP
    step changes exactly one row of W1.
    """
    F, M, _ = W_hat.shape
    N = n_src
    W = W_hat.clone()
    tmp = W[:, :N, :] @ Cx if N < M else None
    for k in range(N):  # IP updates are order-dependent
        V = Vs[k]
        e_k = torch.zeros((F, M, 1), dtype=W.dtype, device=W.device)
        e_k[:, k] = 1.0
        w = gauss_solve(W @ V, e_k)[:, :, 0]  # (F, M)
        # knife-edge bins give a huge w whose quadratic form would overflow
        # f32; exact power-of-2 rescale (the normalization cancels it)
        w = clamp_pow2(w)
        # where the form has no significant bits, keep the previous row:
        # normalizing by rounding noise blows the row up, and the blow-up
        # spreads to every bin through the joint activations
        denom, good = quad_form(w, V)
        w = w / torch.sqrt(torch.where(good, denom, torch.ones_like(denom)))[:, None]
        w = torch.where(good[:, None], w, W[:, k].conj())
        W[:, k] = w.conj()
        if N < M:
            tmp[:, k] = (w.conj()[:, None, :] @ Cx)[:, 0]
            # clamp: a singular OC system gives a huge J (f32 overflow
            # next epoch); finite garbage instead, healthy bins unchanged
            J_H = clamp_pow2(gauss_solve(tmp[:, :, :N], tmp[:, :, N:]))
            W[:, N:, :N] = mat_h(J_H)
    return W


def update_rows_reference(phi, X, Cx, W, n_src: int):
    """Plain PyTorch version of the kernel. phi: (T, N) or (T, B, N) real;
    X: (T, F, M); Cx, W: (F, M, M). Returns the new W."""
    Vs = weighted_covariance_mixtures(X, phi if phi.ndim == 3 else phi[:, None])
    return ip_rows(W, Vs, Cx, n_src)


def _launch(phi, X, Cx, W, n_src: int):
    from .._build import library

    tensors = {"phi": phi, "X": X, "Cx": Cx, "W": W}
    if any(t.dtype != torch.complex64 for t in (X, Cx, W)):
        raise ValueError(
            "update_rows kernel: complex64 only (X, Cx, W), got "
            f"{X.dtype}, {Cx.dtype}, {W.dtype}"
        )
    if phi.dtype != torch.float32:
        raise ValueError(f"update_rows kernel: phi must be float32, got {phi.dtype}")
    if X.ndim != 3:
        raise ValueError(f"X must be (T, F, M), got {tuple(X.shape)}")
    T, F, M = X.shape
    if Cx.shape != (F, M, M) or W.shape != (F, M, M):
        raise ValueError(
            f"Cx and W must be (F={F}, M={M}, M), got {tuple(Cx.shape)} and "
            f"{tuple(W.shape)}"
        )
    if M > MAX_M:
        raise ValueError(
            f"M = {M} exceeds the kernel's bound M <= {MAX_M} (M*M threads a block)"
        )
    N = int(n_src)
    if not 1 <= N <= M:
        raise ValueError(f"need 1 <= n_src <= M = {M}, got {N}")
    n_mix = phi.shape[1] if phi.ndim == 3 else 1
    if phi.shape not in ((T, N), (T, n_mix, N)) or n_mix < 1 or F % n_mix:
        raise ValueError(
            f"phi must be (T={T}, N={N}) or (T={T}, B, N={N}) with B dividing "
            f"F={F}, got {tuple(phi.shape)}"
        )
    if min(T, F) < 1 or F > 2**31 - 1:
        raise ValueError(f"unsupported shape T={T} F={F}")
    devices = {name: t.device for name, t in tensors.items()}
    if len(set(devices.values())) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    loose = [name for name, t in tensors.items() if not t.is_contiguous()]
    if loose:
        raise ValueError(f"update_rows kernel: {loose} must be contiguous")
    out = torch.empty_like(W)
    lib = library()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.update_rows_launch(
            X.data_ptr(), phi.data_ptr(), Cx.data_ptr(), W.data_ptr(),
            out.data_ptr(), T, F, M, N, n_mix, stream,
        )
    if err != 0:
        msg = lib.update_rows_error_string(err).decode()
        raise RuntimeError(f"update_rows launch failed: {msg} (cuda error {err})")
    update_rows.launches += 1
    return out


def update_rows(phi, X, Cx, W, n_src: int):
    """The fused per-bin update: the new W (F, M, M) from phi (T, N) or
    (T, B, N) of B folded mixtures, X (T, F, M), Cx and W (F, M, M).

    CPU tensors take :func:`update_rows_reference`; CUDA tensors launch the
    kernel (complex64 and contiguous only) or raise.
    ``update_rows.launches`` counts kernel launches (CPU calls do not count).
    """
    if X.device.type == "cpu":
        return update_rows_reference(phi, X, Cx, W, n_src)
    if X.device.type == "cuda":
        return _launch(phi, X, Cx, W, n_src)
    raise ValueError(f"update_rows runs on cpu or cuda, not {X.device}")


update_rows.launches = 0
