"""FIVE (fast independent vector extraction) on tensors.

Counterpart of ``overiva_tpu/models/five.py`` (oracle twin
``oracle/five.py``): whiten once, then each epoch sets the extraction
filter to the minimum eigenvector of the phi-weighted whitened covariance
(the library's batched ``eigh``, as the JAX package leaves it to XLA), with
its phase fixed: the first largest-magnitude component real-positive.
Folded mixtures (``n_mix``) each get their own activations.
"""

from __future__ import annotations

import torch

from ..ops.covariance import covariance, weighted_covariance_tf
from ..ops.linalg import eigh, mat_h
from .overiva import mixture_activations

__all__ = ["five_demix", "five_init", "five_iterations", "five_unwhiten", "five_whiten"]


def five_whiten(X):
    """Returns (Xw, Q) with Q = Cx^{-1/2} (Hermitian), eigenvalues floored
    at 1e-15."""
    lam, E = eigh(covariance(X))
    scale = torch.clamp_min(lam, 1e-15)[:, None, :] ** -0.5
    Q = (E * scale.to(X.real.dtype)) @ mat_h(E)
    return torch.einsum("fmn,tfn->tfm", Q, X), Q


def five_init(Xw):
    """The starting filter e_0 in every bin: any unit vector serves, since
    the whitened covariance is I."""
    w = torch.zeros(Xw.shape[1:], dtype=Xw.dtype, device=Xw.device)
    w[:, 0] = 1.0
    return w


def five_demix(Xw, w):
    """y[t,f] = w[f]^H xw[t,f]."""
    return torch.einsum("fm,tfm->tf", w.conj(), Xw)


def five_unwhiten(Q, w):
    """The unwhitened demixing vector Q^H w: y = w^H Q x = (Q^H w)^H x."""
    return torch.einsum("fmn,fn->fm", mat_h(Q), w)


def _fix_phase(w):
    """Rotate each bin's first largest-|.| component to real-positive."""
    mag = w.abs()
    sel = (mag >= torch.amax(mag, dim=1, keepdim=True)).to(mag.dtype)
    first = (torch.cumsum(sel, dim=1) <= 1.0).to(mag.dtype) * sel
    ph = torch.sum(w * first, dim=1)
    ph = ph / torch.clamp_min(ph.abs(), 1e-30)
    return w * ph.conj()[:, None]


def five_iterations(Xw, w, n_iter: int, model: str, n_mix: int = 1, group=None,
                    n_freq=None, bin_mask=None):
    """Run ``n_iter`` minimum-eigenvector epochs in the whitened domain.
    Xw: (T, F, M), w: (F, M). ``group``, ``n_freq``, ``bin_mask``: bin
    sharding, one power psum an epoch
    (``models/overiva.py::mixture_activations``)."""
    T, BF, _ = Xw.shape
    F = BF // n_mix
    for _ in range(n_iter):
        phi = mixture_activations(five_demix(Xw, w)[:, :, None], model, n_mix, group,
                                  n_freq, bin_mask)
        # each mixture's phi weights its own bins
        w_tf = phi[:, :, None, 0].expand(T, n_mix, F).reshape(T, BF)
        _, E_v = eigh(weighted_covariance_tf(Xw, w_tf))
        w = _fix_phase(E_v[:, :, 0])
    return w
