"""The tap-steering steps of a T-ISS or ILRMA-T epoch
(``models/tiss.py::steer``).

Given the weights phi (T, B, M) of an epoch, the MK = M x taps steps, in
order, against the delayed observations z_j = Xt[:, :, M + j]: weighted
least squares of each output on z_j, no self term, then
Y <- Y - v_j z_j, and the tap block of P updated once from the stacked
coefficients.

- :func:`tap_steps_reference` is the plain PyTorch version: the eager
  steps, each a frame-sum contraction and a few element-wise passes over Y.
- :func:`tap_steps` is the wrapper: the CUDA kernel (``csrc/tap_steps.cu``;
  a warp per bin, the bin's Y in registers through all MK steps, Z staged
  from its strided view, one launch an epoch) for CUDA tensors, the plain
  version for CPU tensors. On a CUDA tensor it launches the kernel or
  raises.
- :func:`kernel_route` is the rule by which a T-ISS or ILRMA-T epoch
  (``models/tiss.py::steer``) runs the kernel: CUDA, complex64, and
  M, MK and T within the kernel's limits (:data:`MAX_M`, :data:`MAX_MK`,
  :data:`MAX_T`).

Folded mixtures (``models/overiva.py::fold_mixtures``): bin f is weighted
by the phi of mixture f // (B*F / B). At ``n_mix`` = B*F every bin has
weights of its own, phi (T, B*F, M): ILRMA-T's per-(t, f) weights.
"""

from __future__ import annotations

import torch

__all__ = ["MAX_M", "MAX_MK", "MAX_T", "kernel_route", "tap_steps", "tap_steps_reference"]

MAX_M = 8      # outputs: a lane holds one output, at least 4 lanes an output
MAX_MK = 128   # steps: the coefficients v (M x MK) wait in shared memory
MAX_T = 256    # frames: a bin's Y lives in one warp's registers

_EPS = 1e-15


def kernel_route(device_type: str, dtype, M: int, MK: int, T: int) -> bool:
    """Whether the tap steps of outputs Y (T, B*F, M) of this device type
    and dtype against MK delayed observations run the kernel: CUDA,
    complex64, 1 <= M <= :data:`MAX_M`, 1 <= MK <= :data:`MAX_MK` and
    1 <= T <= :data:`MAX_T`. Everything else runs the plain steps."""
    return (device_type == "cuda" and dtype == torch.complex64 and 1 <= M <= MAX_M
            and 1 <= MK <= MAX_MK and 1 <= T <= MAX_T)


def tap_steps_reference(P, Y, Z, phi, n_mix: int = 1):
    """The tap-steering steps against the delayed observations Z (T, B*F,
    MK), in order, with the weights phi (T, B, M): P (B*F, M, M + MK),
    Y (T, B*F, M). Returns the new (P, Y)."""
    T, BF, M = Y.shape
    MK = Z.shape[2]
    F = BF // n_mix
    Zb = Z.reshape(T, n_mix, F, MK)
    # every denominator depends on phi only: one contraction for all steps
    den_all = torch.einsum("tbm,tbfj->bfmj", phi, Zb.abs() ** 2).reshape(BF, M, MK)
    vs = []
    for j in range(MK):
        zj = Z[:, :, j]  # (T, B*F)
        num = torch.einsum("tbfm,tbf->bfm", phi[:, :, None, :] * Y.reshape(T, n_mix, F, M),
                           Zb[:, :, :, j].conj()).reshape(BF, M)
        v = num / torch.clamp_min(den_all[:, :, j], _EPS)
        Y = Y - v[None, :, :] * zj[:, :, None]
        vs.append(v)
    P = P.clone()
    P[:, :, M:] -= torch.stack(vs, dim=2)
    return P, Y


def _launch(P, Y, Z, phi, n_mix: int):
    from .._build import library

    tensors = {"P": P, "Y": Y, "Z": Z, "phi": phi}
    if any(t.dtype != torch.complex64 for t in (P, Y, Z)):
        raise ValueError(
            f"tap_steps kernel: complex64 only (P, Y, Z), got {P.dtype}, {Y.dtype}, {Z.dtype}"
        )
    if phi.dtype != torch.float32:
        raise ValueError(f"tap_steps kernel: phi must be float32, got {phi.dtype}")
    if Y.ndim != 3 or Z.ndim != 3:
        raise ValueError(f"Y and Z must be (T, B*F, M) and (T, B*F, MK), got "
                         f"{tuple(Y.shape)} and {tuple(Z.shape)}")
    T, BF, M = Y.shape
    MK = Z.shape[2]
    if Z.shape[:2] != (T, BF) or P.shape != (BF, M, M + MK):
        raise ValueError(
            f"Z must be (T={T}, B*F={BF}, MK) and P (B*F, M={M}, M + MK), got "
            f"{tuple(Z.shape)} and {tuple(P.shape)}"
        )
    n_mix = int(n_mix)
    if n_mix < 1 or BF % n_mix or phi.shape != (T, n_mix, M):
        raise ValueError(
            f"phi must be (T={T}, B, M={M}) with B = n_mix = {n_mix} dividing "
            f"B*F={BF}, got {tuple(phi.shape)}"
        )
    if not 1 <= M <= MAX_M:
        raise ValueError(f"M = {M} outside the kernel's 1 <= M <= {MAX_M} (lanes an output)")
    if not 1 <= MK <= MAX_MK:
        raise ValueError(
            f"MK = {MK} outside the kernel's 1 <= MK <= {MAX_MK} (v in shared memory)")
    if not 1 <= T <= MAX_T:
        raise ValueError(f"T = {T} outside the kernel's 1 <= T <= {MAX_T} (Y in registers)")
    if BF < 1 or BF > 2**31 - 1:
        raise ValueError(f"unsupported bin count B*F={BF}")
    devices = {name: t.device for name, t in tensors.items()}
    if len(set(devices.values())) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    if Z.stride(2) != 1:
        raise ValueError(f"tap_steps kernel: Z's steps must be adjacent, got strides {Z.stride()}")
    # P, Y and phi come dense from the epoch (no copy); Z is read in place
    P, Y, phi = P.contiguous(), Y.contiguous(), phi.contiguous()
    P_out, Y_out = torch.empty_like(P), torch.empty_like(Y)
    lib = library()
    with torch.cuda.device(Y.device):
        stream = torch.cuda.current_stream(Y.device).cuda_stream
        err = lib.tap_steps_launch(
            P.data_ptr(), P_out.data_ptr(), Y.data_ptr(), Y_out.data_ptr(), Z.data_ptr(),
            Z.stride(0), Z.stride(1), phi.data_ptr(), T, BF, M, MK, n_mix, stream,
        )
    if err != 0:
        msg = lib.tap_steps_error_string(err).decode()
        raise RuntimeError(f"tap_steps launch failed: {msg} (cuda error {err})")
    tap_steps.launches += 1
    return P_out, Y_out


def tap_steps(P, Y, Z, phi, n_mix: int = 1):
    """The MK tap-steering steps of an epoch: the new (P, Y) from P (B*F, M,
    M + MK), Y (T, B*F, M), the delayed observations Z (T, B*F, MK) (any
    strides with adjacent steps, e.g. ``Xt[:, :, M:]``) and phi (T, B, M)
    of the ``n_mix`` folded mixtures.

    CPU tensors take :func:`tap_steps_reference`; CUDA tensors launch the
    kernel (complex64, within its limits) or raise. Neither writes into
    its inputs. ``tap_steps.launches`` counts kernel launches (CPU calls do
    not count).
    """
    if Y.device.type == "cpu":
        return tap_steps_reference(P, Y, Z, phi, n_mix)
    if Y.device.type == "cuda":
        return _launch(P, Y, Z, phi, n_mix)
    raise ValueError(f"tap_steps runs on cpu or cuda, not {Y.device}")


tap_steps.launches = 0
