"""Online (streaming) AuxIVA-ISS on tensors: block-wise source steering.

Counterpart of ``overiva_tpu/models/online_iss.py`` (oracle twin
``oracle/online_iss.py``). STFT frames arrive in blocks; the demixing
matrix is refined by rank-1 source-steering passes per block with
exponentially forgotten statistics, so the separator tracks the mixture
with O(block) latency and no matrix solves.

State per stream (all on the device):
  W        (F, M, M)   demixing matrix
  num      (M, F, M)   EW sums  E_w[phi_m y_m conj(y_n)]  (indexed by n)
  den      (M, F, M)   EW sums  E_w[phi_m |y_n|^2]   (real)
  zn, zd   (F, M)      EW projection-back statistics vs mic 0 (zd real)
  t_eff    ()          effective frame count (real, for the self-scaling term)

A step never writes into the state it is given: it returns new tensors,
so a snapshot of the old state (``StreamingSeparator.warmup``, a caller's
copy) stays valid. Nothing in a step reads a value back to the host.

Bin-sharded (``parallel/sharded.py::sharded_online_iss``), a step takes
the JAX step's hook: ``group`` (in place of ``axis_name``), ``n_freq``
and ``bin_mask``; the per-pass (B, M) power psum is its one collective.
"""

from __future__ import annotations

import torch

from ..parallel.collectives import psum
from .overiva import demix
from .source_models import activations_from_power, power

__all__ = ["online_iss_init", "online_iss_step", "source_passes", "steer_source", "stream_emit"]

_EPS = 1e-15


def online_iss_init(F: int, M: int, dtype=torch.complex64, device=None):
    """The zero state of a stream of (F, M) frames: W = I, sums zero."""
    rdtype = dtype.to_real()
    return {
        "W": torch.eye(M, dtype=dtype, device=device).repeat(F, 1, 1),
        "num": torch.zeros((M, F, M), dtype=dtype, device=device),
        "den": torch.zeros((M, F, M), dtype=rdtype, device=device),
        "zn": torch.zeros((F, M), dtype=dtype, device=device),
        "zd": torch.zeros((F, M), dtype=rdtype, device=device),
        "t_eff": torch.zeros((), dtype=rdtype, device=device),
    }


def steer_source(W, Y, phi, num_n, den_n, lam, t_eff, n: int):
    """One source-steering step of source n with EW statistics: W (F, M, J)
    for any row width J (online T-ISS steers its augmented rows), the
    frozen outputs Y (B, F, M) and weights phi (B, M), the sums num_n
    (F, M) and den_n (F, M) of source n, the forgetting factor lam and
    the effective frame count t_eff (0-d tensors). Returns the new
    (W, num_n, den_n)."""
    M = Y.shape[2]
    yn = Y[:, :, n]
    blk_num = torch.einsum("tfm,tf->fm", phi[:, None, :] * Y, yn.conj())
    blk_den = torch.einsum("tm,tf->fm", phi, (yn * yn.conj()).real)
    num_n = lam * num_n + blk_num
    den_n = lam * den_n + blk_den
    v = num_n / torch.clamp_min(den_n, _EPS)
    dnn = den_n[:, n] / torch.clamp_min(t_eff, 1.0)
    vnn = 1.0 - torch.rsqrt(torch.clamp_min(dnn, _EPS))
    col = torch.arange(M, device=Y.device)[None, :]
    v = torch.where(col == n, vnn[:, None].to(v.dtype), v)
    W = W - v[:, :, None] * W[:, n, None, :]
    return W, num_n, den_n


def source_passes(X, W, num, den, lam, t_eff, model: str, group=None, n_freq=None,
                  bin_mask=None):
    """One pass's M source-steering steps, in order, on frozen outputs:
    Y = W X and phi from Y, then :func:`steer_source` for n = 0..M-1.
    X: (B, F, J) (the augmented input for T-ISS); W (F, M, J); num (M, F,
    M) complex and den (M, F, M) real. ``group``, ``n_freq``,
    ``bin_mask``: bin sharding, the power psum'd over ``group``. Returns
    (W, num, den, phi) as new tensors."""
    Y = demix(X, W)
    pw = psum(power(Y, bin_mask), group)
    _, phi = activations_from_power(pw, n_freq or Y.shape[1], model)  # (B, M)
    phi = phi.to(Y.real.dtype)
    nums, dens = list(num.unbind(0)), list(den.unbind(0))
    for n in range(Y.shape[2]):
        W, nums[n], dens[n] = steer_source(W, Y, phi, nums[n], dens[n], lam, t_eff, n)
    return W, torch.stack(nums), torch.stack(dens), phi


def stream_emit(X_blk, Y, zn, zd, pb_lam):
    """Streaming projection back vs mic 0: the block's outputs Y (B, F, M)
    scaled by the EW-forgotten statistics. Returns (Y_out, zn, zd)."""
    zn = zn * pb_lam + torch.sum(X_blk[:, :, 0, None].conj() * Y, dim=0)
    zd = zd * pb_lam + torch.sum(Y.abs() ** 2, dim=0)
    pos = zd > 0.0
    z = torch.where(pos, zn / torch.where(pos, zd, 1.0), 1.0)
    return Y * z.conj()[None, :, :], zn, zd


def online_iss_step(X_blk, state, forget, model: str = "laplace", n_pass: int = 1,
                    ramp: bool = False, pb_forget=None, group=None, n_freq=None,
                    bin_mask=None):
    """Process one STFT block X_blk (B, F, M) complex. ``forget`` and
    ``pb_forget`` are 0-d real tensors on the block's device.

    Returns (Y_blk projection-back scaled, new state).

    ``ramp``: forgetting-factor scheduling (the classic RLS warm-up): the
    first blocks run a growing uniform window and lam decays linearly to
    ``forget`` as the effective frame count reaches 1/(1-forget). The ramp
    reads the count before this block's update. Measured neutral to
    negative on stationary scenes in the JAX package; default off.

    ``pb_forget``: a separate (typically longer) forgetting factor for the
    projection-back statistics zn/zd; None follows lam (the ramped lam
    when ``ramp``).

    ``group``, ``n_freq``, ``bin_mask``: bin sharding (:func:`source_passes`).
    """
    B = X_blk.shape[0]
    lam = forget.to(state["den"].dtype)
    if ramp:
        frac = torch.clamp(1.0 - state["t_eff"] * (1.0 - lam), 0.0, 1.0)
        lam = lam + (1.0 - lam) * frac
    pb_lam = lam if pb_forget is None else pb_forget.to(lam.dtype)
    W, num, den = state["W"], state["num"], state["den"]
    t_eff = state["t_eff"] * lam + B
    for _ in range(n_pass):
        W, num, den, _ = source_passes(X_blk, W, num, den, lam, t_eff, model, group, n_freq,
                                       bin_mask)
    Y_out, zn, zd = stream_emit(X_blk, demix(X_blk, W), state["zn"], state["zd"], pb_lam)
    return Y_out, {"W": W, "num": num, "den": den, "zn": zn, "zd": zd, "t_eff": t_eff}
