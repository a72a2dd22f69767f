"""Online (streaming) T-ISS on tensors: joint dereverberation and
separation per block.

Counterpart of ``overiva_tpu/models/online_tiss.py`` (the design and its
measurements are in that module's docstring). The demixing P (F, M,
M + M*taps) acts on ``[X | delayed taps]``; each pass runs the M
source-steering steps of online ISS on the augmented rows (the same
code, ``models/online_iss.py::source_passes``), then one tap update:

- ``tap_update="steer"``: EW rank-1 steering of every delayed column
  from the residual outputs (measured negative in the JAX package, kept
  for parity);
- ``tap_update="solve"`` (default): U_m = -rp_m Rz_m^-1 per source and
  bin from EW sums of the raw delayed inputs, Rz_m = E[phi_m z z^H] and
  rp_m = E[phi_m (W_m x) z^H], with ``tap_forget`` (default ``forget``)
  and a trace-relative diagonal load; the (M*F, MK, MK) solve is one
  batched :func:`gauss_solve`.

State per stream (all on the device):
  P        (F, M, M + M*taps)  augmented demixing [W | U]
  num, den (M, F, M)   source-steering sums (den real)
  steer mode: tnum (MK, F, M) complex / tden (MK, F, M) real
  solve mode: Rz (M, F, MK, MK) / rp (M, F, MK) complex
  zn, zd   (F, M)      projection-back statistics (zd real)
  hist     (max(taps + delay - 1, 0), F, M)  raw frames of earlier blocks
  t_eff    ()          effective frame count (real)

At taps = 0 a step is the online ISS step exactly (same helpers, the
same order). A step returns new tensors and never writes into the state
it was given. The JAX step's ``axis_name``, ``n_freq`` and ``bin_mask``
(bin-sharded execution) are left out, as in ``online_iss.py``.
"""

from __future__ import annotations

import torch

from ..ops.linalg import gauss_solve
from ..ops.wpe import delayed_taps
from .online_iss import source_passes, stream_emit
from .overiva import demix

__all__ = ["online_tiss_init", "online_tiss_step"]

_EPS = 1e-15


def online_tiss_init(F: int, M: int, taps: int, delay: int, tap_update: str = "solve",
                     dtype=torch.complex64, device=None):
    """The zero state of a stream of (F, M) frames: P = [I | 0]."""
    rdtype = dtype.to_real()
    MK = M * taps
    P = torch.zeros((F, M, M + MK), dtype=dtype, device=device)
    P[:, :, :M] = torch.eye(M, dtype=dtype, device=device)
    state = {
        "P": P,
        "num": torch.zeros((M, F, M), dtype=dtype, device=device),
        "den": torch.zeros((M, F, M), dtype=rdtype, device=device),
        "zn": torch.zeros((F, M), dtype=dtype, device=device),
        "zd": torch.zeros((F, M), dtype=rdtype, device=device),
        # max(., 0): taps=0 permits delay=0, where no history is needed
        "hist": torch.zeros((max(taps + delay - 1, 0), F, M), dtype=dtype, device=device),
        "t_eff": torch.zeros((), dtype=rdtype, device=device),
    }
    if taps and tap_update == "steer":
        state["tnum"] = torch.zeros((MK, F, M), dtype=dtype, device=device)
        state["tden"] = torch.zeros((MK, F, M), dtype=rdtype, device=device)
    elif taps:
        state["Rz"] = torch.zeros((M, F, MK, MK), dtype=dtype, device=device)
        state["rp"] = torch.zeros((M, F, MK), dtype=dtype, device=device)
    return state


def _steer_taps(Xt_blk, Xd, P, phi, tnum, tden, tap_lam, M: int):
    """EW rank-1 steering of every delayed column from the residual outputs."""
    Y = demix(Xt_blk, P)
    tden = tap_lam * tden + torch.einsum("tm,tfj->jfm", phi, Xd.abs() ** 2)
    tnum = tap_lam * tnum + torch.einsum("tfm,tfj->jfm", phi[:, None, :] * Y, Xd.conj())
    v = tnum / torch.clamp_min(tden, _EPS)
    P = torch.cat([P[:, :, :M], P[:, :, M:] - v.permute(1, 2, 0)], dim=2)
    return P, tnum, tden


def _solve_taps(X_blk, Xd, P, phi, Rz, rp, tap_lam, diag_load: float, M: int):
    """Re-derive the tap block from the stationary statistics Rz, rp:
    U_m Rz_m = -rp_m (normal equations of min E[phi_m |W_m x + U_m z|^2])."""
    F, MK = Xd.shape[1], Xd.shape[2]
    Wx = demix(X_blk, P[:, :, :M])  # (B, F, M)
    pXd = phi[:, None, :, None] * Xd[:, :, None, :]  # (B, F, M, MK)
    Rz = tap_lam * Rz + torch.einsum("tfma,tfb->mfab", pXd, Xd.conj())
    rp = tap_lam * rp + torch.einsum("tfm,tfa->mfa", phi[:, None, :] * Wx, Xd.conj())
    tr = torch.diagonal(Rz, dim1=-2, dim2=-1).real.sum(dim=-1) / MK  # (M, F)
    load = diag_load * torch.clamp_min(tr, 1e-30)
    eye = torch.eye(MK, dtype=Rz.dtype, device=Rz.device)
    A = Rz.transpose(2, 3) + load[..., None, None] * eye
    U = gauss_solve(A.reshape(M * F, MK, MK), -rp.reshape(M * F, MK, 1)).reshape(M, F, MK)
    return torch.cat([P[:, :, :M], U.transpose(0, 1)], dim=2), Rz, rp


def online_tiss_step(X_blk, state, forget, taps: int, delay: int, model: str = "laplace",
                     n_pass: int = 1, pb_forget=None, tap_update: str = "solve",
                     diag_load: float = 1e-5, tap_forget=None):
    """Process one STFT block X_blk (B, F, M) complex. ``forget``,
    ``pb_forget`` and ``tap_forget`` are 0-d real tensors (or None) on the
    block's device.

    Statistics accumulate once per pass: with n_pass > 1 the effective
    per-block decay is forget**n_pass (tap stats: tap_forget**n_pass).

    Returns (Y_blk projection-back scaled, new state)."""
    B, F, M = X_blk.shape
    lam = forget.to(state["den"].dtype)
    pb_lam = lam if pb_forget is None else pb_forget.to(lam.dtype)
    tap_lam = lam if tap_forget is None else tap_forget.to(lam.dtype)
    P, num, den, hist = state["P"], state["num"], state["den"], state["hist"]
    t_eff = state["t_eff"] * lam + B
    stats = {k: state[k] for k in ("tnum", "tden", "Rz", "rp") if k in state}

    # tap stack with cross-block context: prepend the history frames, run
    # the batch tap builder, keep this block's rows
    Xcat = torch.cat([hist, X_blk], dim=0)
    Xd = delayed_taps(Xcat, taps, delay)[hist.shape[0]:] if taps else None
    Xt_blk = torch.cat([X_blk, Xd], dim=2) if taps else X_blk

    for _ in range(n_pass):
        P, num, den, phi = source_passes(Xt_blk, P, num, den, lam, t_eff, model)
        if taps and tap_update == "steer":
            P, stats["tnum"], stats["tden"] = _steer_taps(
                Xt_blk, Xd, P, phi, stats["tnum"], stats["tden"], tap_lam, M)
        elif taps:
            P, stats["Rz"], stats["rp"] = _solve_taps(
                X_blk, Xd, P, phi, stats["Rz"], stats["rp"], tap_lam, diag_load, M)

    Y_out, zn, zd = stream_emit(X_blk, demix(Xt_blk, P), state["zn"], state["zd"], pb_lam)
    H = max(taps + delay - 1, 0)
    # guard: x[-0:] would be the whole tensor
    new_hist = Xcat[-H:] if H else hist
    return Y_out, {**state, **stats, "P": P, "num": num, "den": den, "zn": zn, "zd": zd,
                   "hist": new_hist, "t_eff": t_eff}
