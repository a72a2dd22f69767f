"""The source-steering steps of an ISS or T-ISS epoch
(``models/auxiva_iss.py``, ``models/tiss.py``).

Given the weights phi (T, B, M) of an epoch, the M steps, in order: for
step n, the weighted least-squares coefficients v of every output on y_n
(for n itself the rescaling 1 - 1/sqrt(den_n / T)), then
Y <- Y - v y_n and W <- W - v W[n], over the rows W (B*F, M, J) of any
width J (T-ISS steers its augmented rows).

- :func:`iss_steps_reference` is the plain PyTorch version: the eager
  steps, each two frame-sum contractions and a few element-wise passes over
  Y and W.
- :func:`iss_steps` is what the epochs (``models/auxiva_iss.py``,
  ``models/tiss.py``) call: one launch of the CUDA kernel
  (``csrc/iss_steps.cu``; a warp per bin, the bin's Y in registers through
  all M steps, W written once at the end from the steps' M x M transform)
  where the route holds, else the plain version.
- :func:`kernel_route` is the route: CUDA, complex64, and M and T within
  the kernel's limits (:data:`MAX_M`, :data:`MAX_T`); :func:`steps_route`
  reads it off the tensors, once an epoch loop, for the spans and the call.

Folded mixtures (``models/overiva.py::fold_mixtures``): bin f is weighted
by the phi of mixture f // (B*F / B).
"""

from __future__ import annotations

import torch

__all__ = ["MAX_M", "MAX_T", "iss_steps", "iss_steps_reference", "kernel_route", "steps_route"]

MAX_M = 8      # outputs: a lane holds one output, at least 4 lanes an output
MAX_T = 256    # frames: a bin's Y lives in one warp's registers
# The row width J has no limit past J >= M: W passes through a column a
# lane, so J takes no shared memory and no registers.

_EPS = 1e-15


def kernel_route(device_type: str, dtype, M: int, J: int, T: int) -> bool:
    """Whether the source steps of outputs Y (T, B*F, M) and rows W (B*F, M,
    J) of this device type and dtype run the kernel: CUDA, complex64,
    1 <= M <= :data:`MAX_M`, J >= M and 1 <= T <= :data:`MAX_T`. Everything
    else runs the plain steps."""
    return (device_type == "cuda" and dtype == torch.complex64 and 1 <= M <= MAX_M
            and J >= M and 1 <= T <= MAX_T)


def steps_route(W, Y) -> bool:
    """:func:`kernel_route` for the rows W (B*F, M, J) and outputs Y (T,
    B*F, M)."""
    T, _, M = Y.shape
    return kernel_route(Y.device.type, Y.dtype, M, W.shape[2], T)


def iss_steps_reference(W, Y, phi, n_mix: int = 1):
    """The M source-steering steps, in order, with the weights phi (T, B, M):
    W (B*F, M, J), Y (T, B*F, M). Returns the new (W, Y)."""
    T, BF, M = Y.shape
    F = BF // n_mix
    col = torch.arange(M, device=Y.device)[None, :]
    for n in range(M):  # order-dependent
        Yb = Y.reshape(T, n_mix, F, M)
        ynb = Yb[:, :, :, n]  # (T, B, F)
        num = torch.einsum("tbfm,tbf->bfm", phi[:, :, None, :] * Yb, ynb.conj()).reshape(BF, M)
        den = torch.einsum("tbm,tbf->bfm", phi, (ynb * ynb.conj()).real).reshape(BF, M)
        v = num / torch.clamp_min(den, _EPS)
        dnn = den[:, n] / T
        vnn = 1.0 - torch.rsqrt(torch.clamp_min(dnn, _EPS))
        v = torch.where(col == n, vnn[:, None].to(v.dtype), v)
        Y = Y - v[None, :, :] * Y[:, :, n, None]
        W = W - v[:, :, None] * W[:, n, None, :]
    return W, Y


def _launch(W, Y, phi, n_mix: int):
    from .._build import library

    tensors = {"W": W, "Y": Y, "phi": phi}
    if W.dtype != torch.complex64 or Y.dtype != torch.complex64:
        raise ValueError(f"iss_steps kernel: complex64 only (W, Y), got {W.dtype}, {Y.dtype}")
    if phi.dtype != torch.float32:
        raise ValueError(f"iss_steps kernel: phi must be float32, got {phi.dtype}")
    if Y.ndim != 3 or W.ndim != 3:
        raise ValueError(f"Y and W must be (T, B*F, M) and (B*F, M, J), got "
                         f"{tuple(Y.shape)} and {tuple(W.shape)}")
    T, BF, M = Y.shape
    J = W.shape[2]
    if W.shape[:2] != (BF, M):
        raise ValueError(f"W must be (B*F={BF}, M={M}, J), got {tuple(W.shape)}")
    n_mix = int(n_mix)
    if n_mix < 1 or BF % n_mix or phi.shape != (T, n_mix, M):
        raise ValueError(
            f"phi must be (T={T}, B, M={M}) with B = n_mix = {n_mix} dividing "
            f"B*F={BF}, got {tuple(phi.shape)}"
        )
    if not 1 <= M <= MAX_M:
        raise ValueError(f"M = {M} outside the kernel's 1 <= M <= {MAX_M} (lanes an output)")
    if J < M:
        raise ValueError(f"J = {J} outside the kernel's J >= M = {M} (row width)")
    if not 1 <= T <= MAX_T:
        raise ValueError(f"T = {T} outside the kernel's 1 <= T <= {MAX_T} (Y in registers)")
    if BF < 1 or BF > 2**31 - 1:
        raise ValueError(f"unsupported bin count B*F={BF}")
    devices = {name: t.device for name, t in tensors.items()}
    if len(set(devices.values())) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    if Y.device.type != "cuda":
        raise ValueError(f"iss_steps kernel runs on cuda, not {Y.device}")
    # W, Y and phi come dense from the epoch (no copy)
    W, Y, phi = W.contiguous(), Y.contiguous(), phi.contiguous()
    W_out, Y_out = torch.empty_like(W), torch.empty_like(Y)
    lib = library()
    with torch.cuda.device(Y.device):
        stream = torch.cuda.current_stream(Y.device).cuda_stream
        err = lib.iss_steps_launch(W.data_ptr(), W_out.data_ptr(), Y.data_ptr(), Y_out.data_ptr(),
                                   phi.data_ptr(), T, BF, M, J, n_mix, stream)
    if err != 0:
        msg = lib.iss_steps_error_string(err).decode()
        raise RuntimeError(f"iss_steps launch failed: {msg} (cuda error {err})")
    iss_steps.launches += 1
    return W_out, Y_out


def iss_steps(W, Y, phi, n_mix: int = 1, route=None):
    """The M source-steering steps of an epoch: the new (W, Y) from W (B*F,
    M, J), Y (T, B*F, M) and phi (T, B, M) of the ``n_mix`` folded
    mixtures. One launch of the kernel where ``route`` (default:
    :func:`steps_route`) holds, else :func:`iss_steps_reference`.

    Neither writes into its inputs. ``iss_steps.launches`` counts kernel
    launches.
    """
    if route is None:
        route = steps_route(W, Y)
    return (_launch if route else iss_steps_reference)(W, Y, phi, n_mix)


iss_steps.launches = 0
