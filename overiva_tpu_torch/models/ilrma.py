"""ILRMA (determined BSS with a rank-K NMF source model) on tensors.

Counterpart of ``overiva_tpu/models/ilrma.py`` (Kitamura et al., TASLP
2016, ILRMA1). Per epoch and per source k, in order: IS-NMF multiplicative
updates of the basis B_k (per bin) and the activations H_k (sums over all
bins), an iterative-projection row update with the per-(t,f) weights 1/R_k
(``ops/covariance.py::weighted_covariance_tf``) and the same guards as the
IP family (``gauss_solve``'s dead pivots, ``clamp_pow2``, the ``quad_form``
keep-row mask), then the unit-power rescale of the row over (t, f), which
also divides B_k by lam^2. P = |Y|^2 is taken once at the epoch start and
not written back: each source reads only its own column.

Every tensor carries a leading batch axis of independent mixtures: the
activations and the rescale sum over each mixture's own bins, so a batch
cannot be folded into the bin axis as the IP family's is. Only the per-bin
covariance and solve run on the folded (B*F) bins.
"""

from __future__ import annotations

import torch

from ..ops.covariance import weighted_covariance_tf
from ..ops.linalg import clamp_pow2, gauss_solve, quad_form
from ..parallel.collectives import psum
from .overiva import fold_mixtures

__all__ = ["_ilrma_epoch", "ilrma_demix", "ilrma_iterations"]

_EPS = 1e-15


def ilrma_demix(X, W):
    """Y[b,t,f,n] = sum_m W[b,f,n,m] X[b,t,f,m]."""
    return torch.einsum("bfnm,btfm->btfn", W, X)


def _ilrma_epoch(X, W, B, H, wcov: str = "f32", group=None, n_freq=None, bin_mask=None):
    """One epoch. X: (nb, T, F, M); W: (nb, F, M, M); B: (nb, N, F, K);
    H: (nb, N, K, T). Returns the new (W, B, H).

    Bin-sharded (``group``, ``n_freq`` the global bin count, ``bin_mask``
    (F,) zeroing the padded bins): the activation numerator and
    denominator and the rescale's power sum are psum'd, three collectives
    a source, so H stays the same on every rank."""
    nb, T, F, M = X.shape
    mask = None if bin_mask is None else bin_mask.to(X.real.dtype)[:, None]  # (F, 1)
    P = (ilrma_demix(X, W).abs() ** 2).permute(0, 3, 2, 1)  # (nb, N, F, T)
    Xf = fold_mixtures(X)  # (T, nb*F, M): the per-bin steps
    Wf = W.reshape(nb * F, M, M).clone()
    B, H = B.clone(), H.clone()

    for k in range(M):  # the row updates are order-dependent
        Pk, Bk, Hk = P[:, k], B[:, k], H[:, k]
        R = Bk @ Hk + _EPS
        # basis: per bin
        Bk = Bk * torch.sqrt(((Pk / R**2) @ Hk.mT) / ((1.0 / R) @ Hk.mT + _EPS))
        Bk = torch.clamp_min(Bk, _EPS)
        R = Bk @ Hk + _EPS
        # activations: sums over all of a mixture's bins
        hn, hd = Pk / R**2, 1.0 / R
        if mask is not None:
            hn, hd = hn * mask, hd * mask
        num = psum(Bk.mT @ hn, group)  # (nb, K, T)
        den = psum(Bk.mT @ hd, group)
        Hk = torch.clamp_min(Hk * torch.sqrt(num / (den + _EPS)), _EPS)
        R = Bk @ Hk + _EPS

        # IP row with the per-(t,f) weights 1/R, over the folded bins
        w_tf = (1.0 / R).permute(2, 0, 1).reshape(T, nb * F)
        V = weighted_covariance_tf(Xf, w_tf, wcov)  # (nb*F, M, M)
        e_k = torch.zeros((nb * F, M, 1), dtype=Wf.dtype, device=Wf.device)
        e_k[:, k] = 1.0
        w = clamp_pow2(gauss_solve(Wf @ V, e_k)[:, :, 0])  # overflow guard, exact
        denom, good = quad_form(w, V)
        w = w / torch.sqrt(torch.where(good, denom, torch.ones_like(denom)))[:, None]
        w = torch.where(good[:, None], w, Wf[:, k].conj())

        # unit-power rescale: mean over each mixture's (t, f)
        w = w.reshape(nb, F, M)
        yk = torch.einsum("bfm,btfm->btf", w.conj(), X)
        p = yk.abs() ** 2
        if mask is not None:
            p = p * mask.T
        lam = torch.sqrt(psum(p.sum(dim=(1, 2)), group) / (T * (n_freq or F))) + _EPS  # (nb,)
        w = w / lam[:, None, None]
        Wf[:, k] = w.conj().reshape(nb * F, M)
        B[:, k] = Bk / (lam**2)[:, None, None]
        H[:, k] = Hk
    return Wf.reshape(nb, F, M, M), B, H


def ilrma_iterations(X, W, B, H, n_iter: int, wcov: str = "f32"):
    """Run ``n_iter`` epochs. X: (nb, T, F, M); W: (nb, F, M, M); B: (nb,
    N, F, K) >= 0; H: (nb, N, K, T) >= 0. ``wcov="bf16"``: bf16 operands
    for the weighted covariances."""
    for _ in range(n_iter):
        W, B, H = _ilrma_epoch(X, W, B, H, wcov)
    return W, B, H
