"""AuxIVA-ISS / OverIVA-ISS: iterative source steering on tensors.

Counterpart of ``overiva_tpu/models/auxiva_iss.py`` (oracle twins
``oracle/auxiva_iss.py`` and ``oracle/overiva_iss.py``). Each epoch makes M
rank-1 "source steering" updates, in order,

    Y <- Y - v (x) Y[n],   W <- W - v (x) W[n],

with closed-form per-bin coefficients v: no solves at all. With
n_src < M the first n_src outputs carry the source model and the M - n_src
background outputs a stationary unit Gaussian (phi = 1).

ISS keeps Y up to date step by step, so the state is (W, Y) and a run is
resumed from both, never re-demixed. Folded mixtures (``n_mix``, see
``models/overiva.py::fold_mixtures``) each get their own activations.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from .overiva import demix, mixture_activations

__all__ = ["auxiva_iss_iterations", "iss_phi", "iss_steps"]

_EPS = 1e-15


def iss_phi(Y, model: str, n_src=None, n_mix: int = 1, group=None, n_freq=None,
            bin_mask=None):
    """The steering weights phi (T, B, M) of the outputs Y (T, B*F, M):
    the source model on the first n_src outputs (per mixture), phi = 1 on
    the M - n_src background outputs. ``group``, ``n_freq``,
    ``bin_mask``: bin sharding (``models/overiva.py::mixture_activations``)."""
    T, BF, M = Y.shape
    N = M if n_src is None else n_src
    phi = mixture_activations(Y[:, :, :N], model, n_mix, group, n_freq,
                              bin_mask).to(Y.real.dtype)  # (T, B, N)
    if N < M:
        phi = torch.cat([phi, phi.new_ones((T, n_mix, M - N))], dim=2)
    return phi


def iss_steps(W, Y, phi, n_mix: int = 1):
    """The M source-steering steps, in order, with the weights phi (T, B, M):
    W (B*F, M, J) for any row width J (T-ISS steers its augmented rows),
    Y (T, B*F, M). Returns the new (W, Y)."""
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


def _iss_epoch(W, Y, model: str, n_src=None, n_mix: int = 1, group=None, n_freq=None,
               bin_mask=None):
    """One ISS epoch on the full state: W (B*F, M, M), Y (T, B*F, M).
    Returns the new (W, Y). ``group``, ``n_freq``, ``bin_mask``: bin
    sharding (:func:`iss_phi`)."""
    return iss_steps(W, Y, iss_phi(Y, model, n_src, n_mix, group, n_freq, bin_mask), n_mix)


def auxiva_iss_iterations(X, W, n_iter: int, model: str, n_src=None, Y=None,
                          n_mix: int = 1):
    """Run ``n_iter`` ISS epochs (OverIVA-ISS when n_src < M).

    X: (T, F, M); W: (F, M, M). ``Y`` resumes a run (default: demix X by
    W). Returns (W, Y) with the full M-channel state; OverIVA-ISS callers
    take ``Y[:, :, :n_src]``."""
    if Y is None:
        Y = demix(X, W)
    for i in range(n_iter):
        with span("family.epoch", index=i, bins=X.shape[1]):
            W, Y = _iss_epoch(W, Y, model, n_src, n_mix)
    return W, Y
