"""T-IP: joint dereverberation + separation with exact IP rows.

Counterpart of ``overiva_tpu/models/tip.py`` (oracle twin
``oracle/tip.py``: derivation, and the measured need for a T-ISS warm
start). Per epoch: the activations of the N target outputs, then for each
row k in order the MJ-dim weighted covariance V_k of the augmented input
(MJ = M + M*taps), its Schur reduction (:func:`_schur_pieces`: an L x L
solve, L = M*taps, with M right-hand sides), the M-dim solve for the
instantaneous part w1, the tap part w2 = -C w1, and the row normalized by
the data form of w^H V w.

The normalizer is (1/T) sum_t phi_t |w^H x_t|^2, a sum of non-negative
terms: the previous row is kept only where it is exactly 0, with
``clamp_pow2`` before and after. (The JAX package records that the
V-based quadratic form with the IP family's keep-row guard froze healthy
rows at MJ = 48, -2.4 dB median SIR at M = 8; ``ops/update_rows.py``'s
``ip_rows`` and ``quad_form`` are not used here.)

When n_src < M the background rows (phi = 1) use Schur pieces that depend
only on Xt: :func:`_background_pieces`, once a run (or a callback chunk).
Folded mixtures (``n_mix``) each weight their own bins.
"""

from __future__ import annotations

import torch

from ..ops.covariance import weighted_covariance_all, weighted_covariance_tf
from ..ops.linalg import clamp_pow2, gauss_solve
from .overiva import demix, mixture_activations

__all__ = ["_background_pieces", "_schur_pieces", "_tip_epoch", "tip_iterations"]


def _weighted_cov(Xt, w, wcov: str, n_mix: int):
    """V (B*F, MJ, MJ) = (1/T) sum_t w[t, b] x x^H over each folded
    mixture b's bins; w: (T, B)."""
    if n_mix == 1:
        return weighted_covariance_all(Xt, w, wcov)[0]
    return weighted_covariance_tf(Xt, w.repeat_interleave(Xt.shape[1] // n_mix, dim=1), wcov)


def _schur_pieces(V, n_chan: int):
    """Schur reduction of the T-IP system for V (F, MJ, MJ): C = V22^-1 V21
    (F, L, M) and S = V11 - V12 C (F, M, M). Solving (P_tilde V) w = e_k
    then reduces to (P[:, :, :M] S) w1 = e_k and w2 = -C w1. Returns
    (C, S)."""
    M = n_chan
    L = V.shape[1] - M
    if L == 0:
        return V.new_zeros((V.shape[0], 0, M)), V
    C = gauss_solve(V[:, M:, M:], V[:, M:, :M])  # (F, L, M)
    S = V[:, :M, :M] - V[:, :M, M:] @ C
    return C, S


def _background_pieces(Xt, n_chan: int, wcov: str = "f32", n_mix: int = 1):
    """The Schur pieces (C, S) of the plain augmented covariance (phi = 1),
    shared by every background row of a run."""
    ones = Xt.real.new_ones((Xt.shape[0], n_mix))
    return _schur_pieces(_weighted_cov(Xt, ones, wcov, n_mix), n_chan)


def _tip_epoch(Xt, P, model: str, n_chan: int, n_src=None, wcov: str = "f32", bg=None,
               n_mix: int = 1, group=None, n_freq=None, bin_mask=None):
    """One T-IP epoch. Xt: (T, B*F, MJ); P: (B*F, M, MJ). ``bg``: the
    background rows' :func:`_background_pieces` (needed when n_src < M).
    ``group``, ``n_freq``, ``bin_mask``: bin sharding
    (``models/overiva.py::mixture_activations``). Returns the new P."""
    T, BF, MJ = Xt.shape
    M = n_chan
    N = M if n_src is None else n_src
    F = BF // n_mix
    # only the N target outputs feed the activations
    phi = mixture_activations(demix(Xt, P[:, :N, :]), model, n_mix, group, n_freq,
                              bin_mask).to(Xt.real.dtype)
    if N < M:
        phi = torch.cat([phi, phi.new_ones((T, n_mix, M - N))], dim=2)

    for k in range(M):  # row updates are order-dependent
        if k < N or bg is None:
            C, S = _schur_pieces(_weighted_cov(Xt, phi[:, :, k], wcov, n_mix), M)
        else:
            C, S = bg
        rhs = Xt.new_zeros((BF, M, 1))
        rhs[:, k, 0] = 1.0
        w1 = gauss_solve(P[:, :, :M] @ S, rhs)[:, :, 0]  # (B*F, M)
        w2 = -torch.einsum("flm,fm->fl", C, w1)
        # exact pow-2 clamp: bounds the solve output on near-singular bins
        w = clamp_pow2(torch.cat([w1, w2], dim=1))  # (B*F, MJ)
        # w^H V w from the data: non-negative terms, no cancellation
        yk = torch.einsum("fa,tfa->tf", w.conj(), Xt)
        denom = torch.einsum("tb,tbf->bf", phi[:, :, k],
                             (yk.abs() ** 2).reshape(T, n_mix, F)).reshape(BF) / T
        good = denom > 0.0
        w = w / torch.sqrt(torch.where(good, denom, torch.ones_like(denom)))[:, None]
        w = clamp_pow2(w)  # an underflow-deep denominator stays in range
        P = P.clone()
        P[:, k, :] = torch.where(good[:, None], w.conj(), P[:, k, :])
    return P


def tip_iterations(Xt, P, n_iter: int, model: str, n_chan: int, n_src=None,
                   wcov: str = "f32", n_mix: int = 1):
    """Run ``n_iter`` T-IP epochs on the augmented input Xt (T, F, MJ) from
    P (F, M, MJ). Returns P. With n_src < M the background pieces are
    computed once here."""
    N = n_chan if n_src is None else n_src
    bg = _background_pieces(Xt, n_chan, wcov, n_mix) if N < n_chan else None
    for _ in range(n_iter):
        P = _tip_epoch(Xt, P, model, n_chan, n_src, wcov, bg, n_mix)
    return P
