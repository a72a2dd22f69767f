"""ILRMA-T: joint dereverberation + ILRMA by source steering.

Counterpart of ``overiva_tpu/models/ilrma_t.py`` (oracle twin
``oracle/ilrma_t.py``, derivation there): ILRMA's rank-K NMF variance
model driving T-ISS steering on the augmented input [X | delayed taps].
Per epoch:

- the IS-NMF multiplicative updates of each source in turn (the basis per
  bin, the activations summed over the mixture's bins), from |Y|^2 taken
  once at the epoch start;
- phi = 1/(B H) per (t, f, k);
- the M source-steering and MK tap-steering steps of T-ISS with those
  per-(t, f) weights (the tap denominators one contraction before the
  loop, the tap block of P updated once from the stacked coefficients);
- the unit-power renormalization of Y, P and B per source.

Every tensor carries a leading batch axis of independent mixtures: the
activations and the renormalization sum over each mixture's own bins, so
a batch is not folded into the bin axis.
"""

from __future__ import annotations

import torch

from ..parallel.collectives import psum

__all__ = ["_ilrma_t_epoch", "ilrma_t_demix", "ilrma_t_iterations"]

_EPS = 1e-15


def ilrma_t_demix(Xt, P):
    """Y[b,t,f,n] = sum_j P[b,f,n,j] Xt[b,t,f,j]."""
    return torch.einsum("bfnj,btfj->btfn", P, Xt)


def _ilrma_t_epoch(Xt, P, Y, B, H, n_chan: int, group=None, n_freq=None, bin_mask=None):
    """One epoch. Xt: (nb, T, F, MJ); P: (nb, F, M, MJ); Y: (nb, T, F, M);
    B: (nb, M, F, K); H: (nb, M, K, T). Returns the new (P, Y, B, H).

    Bin-sharded (``group``, ``n_freq``, ``bin_mask`` as in
    ``models/ilrma.py::_ilrma_epoch``): the activation numerator and
    denominator of each source and the renormalization's power sums are
    psum'd, 2M + 1 collectives an epoch; the steering is bin-local."""
    nb, T, F, MJ = Xt.shape
    mask = None if bin_mask is None else bin_mask.to(Y.real.dtype)[:, None]  # (F, 1)
    M = n_chan
    MK = MJ - M
    Pw = (Y.abs() ** 2).permute(0, 3, 2, 1)  # (nb, M, F, T)
    B, H = B.clone(), H.clone()
    for k in range(M):  # NMF per source
        Pk, Bk, Hk = Pw[:, k], B[:, k], H[:, k]
        R = Bk @ Hk + _EPS
        Bk = Bk * torch.sqrt(((Pk / R**2) @ Hk.mT) / ((1.0 / R) @ Hk.mT + _EPS))
        Bk = torch.clamp_min(Bk, _EPS)
        R = Bk @ Hk + _EPS
        hn, hd = Pk / R**2, 1.0 / R
        if mask is not None:
            hn, hd = hn * mask, hd * mask
        num = psum(Bk.mT @ hn, group)  # (nb, K, T): sums over the mixture's bins
        den = psum(Bk.mT @ hd, group)
        B[:, k] = Bk
        H[:, k] = torch.clamp_min(Hk * torch.sqrt(num / (den + _EPS)), _EPS)

    # per-(t, f, k) weights
    phi = 1.0 / (torch.einsum("bnfk,bnkt->btfn", B, H) + _EPS)  # (nb, T, F, M)
    col = torch.arange(M, device=Y.device)
    for n in range(M):  # source steering, f-resolved weights
        yn = Y[..., n]  # (nb, T, F)
        num = torch.einsum("btfm,btf->bfm", phi * Y, yn.conj())
        den = torch.einsum("btfm,btf->bfm", phi, yn.abs() ** 2)
        v = num / torch.clamp_min(den, _EPS)  # (nb, F, M)
        dnn = den[..., n] / T
        vnn = 1.0 - torch.rsqrt(torch.clamp_min(dnn, _EPS))
        v = torch.where(col == n, vnn[..., None].to(v.dtype), v)
        Y = Y - v[:, None] * yn[..., None]
        P = P - v[..., None] * P[:, :, n, None, :]

    if MK:
        Z = Xt[..., M:]  # (nb, T, F, MK)
        den_all = torch.einsum("btfm,btfj->bfmj", phi, Z.abs() ** 2)
        vs = []
        for j in range(MK):
            zj = Z[..., j]
            v = torch.einsum("btfm,btf->bfm", phi * Y, zj.conj()) / torch.clamp_min(
                den_all[..., j], _EPS)
            Y = Y - v[:, None] * zj[..., None]
            vs.append(v)
        P = P.clone()
        P[..., M:] -= torch.stack(vs, dim=-1)

    # unit-power renormalization per source (likelihood-invariant)
    p = Y.abs() ** 2
    if mask is not None:
        p = p * mask
    lam = torch.sqrt(psum(p.sum(dim=(1, 2)), group) / (T * (n_freq or F))) + _EPS  # (nb, M)
    Y = Y / lam[:, None, None, :]
    P = P / lam[:, None, :, None]
    B = B / (lam**2)[:, :, None, None]
    return P, Y, B, H


def ilrma_t_iterations(Xt, P, B, H, n_iter: int, n_chan: int, Y=None):
    """Run ``n_iter`` epochs. Xt: (nb, T, F, MJ); P: (nb, F, M, MJ); B:
    (nb, M, F, K) >= 0; H: (nb, M, K, T) >= 0. ``Y`` resumes a run
    (default: demix Xt by P). Returns (P, Y, B, H)."""
    if Y is None:
        Y = ilrma_t_demix(Xt, P)
    for _ in range(n_iter):
        P, Y, B, H = _ilrma_t_epoch(Xt, P, Y, B, H, n_chan)
    return P, Y, B, H
