"""WPE dereverberation on tensors (iterative, F-batched).

Counterpart of ``overiva_tpu/ops/wpe.py`` (oracle twin
``oracle/wpe.py``, update equations there): variance-normalized delayed
linear prediction, Nakatani et al. 2010. Per iteration the PSD estimate
lam, the weighted tap statistics R (F, MK, MK) and P (F, MK, M) as one
contraction over frames each, the trace-relative diagonal load on R, and
one batched :func:`gauss_solve` for R G = P.

Every tensor may carry leading batch axes (the batch form): the
activation floor ``1e-10 * mean(lam)`` takes the mean over each mixture's
own (T, F), so a batch is never folded into the bin axis here.
"""

from __future__ import annotations

import torch

from .linalg import gauss_solve

__all__ = ["delayed_taps", "wpe"]

_EPS = 1e-10


def delayed_taps(X, taps: int, delay: int):
    """Stack delayed frames: (..., T, F, M) -> (..., T, F, M*taps).

    Xd[t, f, m*taps + k] = X[t - delay - k, f, m], zero-padded at t < 0
    (channel-major, tap-minor, the oracle's memory order)."""
    T = X.shape[-3]
    cols = []
    for k in range(taps):
        s = delay + k
        if s < T:
            pad = X.new_zeros((*X.shape[:-3], s, *X.shape[-2:]))
            cols.append(torch.cat([pad, X[..., : T - s, :, :]], dim=-3))
        else:
            cols.append(torch.zeros_like(X))
    Xd = torch.stack(cols, dim=-1)  # (..., T, F, M, taps)
    return Xd.reshape(*X.shape[:-1], X.shape[-1] * taps)


def wpe(X, taps: int = 10, delay: int = 3, n_iter: int = 3, diag_load: float = 1e-5):
    """Dereverberate a multichannel STFT: (..., T, F, M) complex -> same."""
    M = X.shape[-1]
    Xd = delayed_taps(X, taps, delay)  # (..., T, F, MK)
    MK = M * taps
    eye = torch.eye(MK, dtype=X.dtype, device=X.device)
    Y = X
    for _ in range(n_iter):
        lam = torch.mean(Y.abs() ** 2, dim=-1)  # (..., T, F)
        floor = _EPS * torch.clamp_min(torch.mean(lam, dim=(-2, -1), keepdim=True), 1e-30)
        lam = torch.maximum(lam, floor)
        Xw = Xd / lam[..., None]
        R = torch.einsum("...tfa,...tfb->...fab", Xw, Xd.conj())
        P = torch.einsum("...tfa,...tfm->...fam", Xw, X.conj())
        tr = torch.diagonal(R, dim1=-2, dim2=-1).real.sum(dim=-1) / MK  # (..., F)
        load = diag_load * torch.clamp_min(tr, 1e-30)
        R = R + load[..., None, None] * eye
        G = gauss_solve(R.reshape(-1, MK, MK), P.reshape(-1, MK, M)).reshape(P.shape)
        Y = X - torch.einsum("...fam,...tfa->...tfm", G.conj(), Xd)
    return Y
