"""T-ISS: joint dereverberation + separation by iterative source steering.

Counterpart of ``overiva_tpu/models/tiss.py`` (oracle twin
``oracle/tiss.py``, derivation there). The demixing P (F, M, M + M*taps)
acts on the augmented input ``Xt = [X | delayed_taps(X)]`` (T, F, MJ).
Per epoch:

- the M source-steering steps of ``models/auxiva_iss.py`` (the same code,
  :func:`iss_steps`), applied to the augmented rows of P;
- the MK = M*taps tap-steering steps against the delayed observations
  z_j = Xt[:, :, M + j]: weighted least squares, no self term. The
  denominators depend only on phi, so they are one contraction before the
  loop; the loop carries Y only, and the tap block of P is updated once
  from the stacked coefficients (the JAX scan's rounding order).

``n_src < M`` adds the phi = 1 background outputs, as OverIVA-ISS. At
taps = 0 an epoch is the ISS epoch exactly. Folded mixtures (``n_mix``,
``models/overiva.py::fold_mixtures``) each get their own activations.
Each epoch is a ``family.epoch`` span (``index``, ``bins``, ``taps`` =
MK), its tap steps a ``tiss.taps`` span (``steps`` = MK, ``bins``,
``frames``, ``outputs`` = M).
"""

from __future__ import annotations

import torch

from ..ops.wpe import delayed_taps
from ..utils.profiling import span
from .auxiva_iss import iss_phi, iss_steps
from .overiva import demix

__all__ = ["augment_taps", "augmented_eye", "tap_steps", "tiss_iterations"]

_EPS = 1e-15


def augment_taps(X, taps: int, delay: int):
    """(..., T, F, M) -> (..., T, F, M + M*taps) augmented input."""
    if taps == 0:
        return X
    return torch.cat([X, delayed_taps(X, taps, delay)], dim=-1)


def augmented_eye(Xt, n_chan: int):
    """Identity-started augmented demixing (F, n_chan, MJ) for Xt (T, F,
    MJ): the instantaneous block is I, the tap block zero."""
    P = Xt.new_zeros((Xt.shape[1], n_chan, Xt.shape[2]))
    P[:, :, :n_chan] = torch.eye(n_chan, dtype=Xt.dtype, device=Xt.device)
    return P


def tap_steps(P, Y, Z, phi, n_mix: int = 1):
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


def _tiss_epoch(Xt, P, Y, model: str, n_chan: int, n_src=None, n_mix: int = 1, group=None,
                n_freq=None, bin_mask=None):
    """One T-ISS epoch. Xt: (T, B*F, MJ); P: (B*F, M, MJ); Y: (T, B*F, M).
    ``group``, ``n_freq``, ``bin_mask``: bin sharding; the tap steps are
    bin-local, so the power psum of :func:`iss_phi` stays the one
    collective. Returns the new (P, Y)."""
    phi = iss_phi(Y, model, n_src, n_mix, group, n_freq, bin_mask)
    P, Y = iss_steps(P, Y, phi, n_mix)
    if Xt.shape[2] > n_chan:
        T, BF, M = Y.shape
        with span("tiss.taps", steps=Xt.shape[2] - n_chan, bins=BF, frames=T, outputs=M):
            P, Y = tap_steps(P, Y, Xt[:, :, n_chan:], phi, n_mix)
    return P, Y


def tiss_iterations(Xt, P, n_iter: int, model: str, n_chan: int, n_src=None, Y=None,
                    n_mix: int = 1):
    """Run ``n_iter`` T-ISS epochs on the augmented input Xt (T, F, MJ) from
    P (F, M, MJ). ``Y`` resumes a run (default: demix Xt by P). Returns
    (P, Y) with the full M-output state; overdetermined callers take
    ``Y[:, :, :n_src]``."""
    if Y is None:
        Y = demix(Xt, P)
    for i in range(n_iter):
        with span("family.epoch", index=i, bins=Xt.shape[1], taps=Xt.shape[2] - n_chan):
            P, Y = _tiss_epoch(Xt, P, Y, model, n_chan, n_src, n_mix)
    return P, Y
