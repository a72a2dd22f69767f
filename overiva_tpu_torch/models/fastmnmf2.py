"""FastMNMF1/2 (full-rank spatial model, jointly diagonalized) on tensors.

Counterpart of ``overiva_tpu/models/fastmnmf2.py`` (Sekiguchi et al.:
FastMNMF1, EUSIPCO 2019; FastMNMF2, TASLP 2020). The shape of the spatial
weights g picks the variant: (nb, N, M) is FastMNMF2 (tied across
frequency), (nb, N, F, M) is FastMNMF1 (free per frequency). Each epoch:
IS-NMF multiplicative updates of the source PSDs (basis W per bin,
activations H summed over all bins), the multiplicative update of g, M
sequential iterative-projection rows of the shared diagonalizer Q with
per-(t,f) weights 1/D (``n_q_sweeps`` sweeps reuse the epoch's M
covariances), then the likelihood-invariant normalisation (phi, mu, nu).

Floors: ``_EPS`` on the PSDs and ratios, ``_G_FLOOR`` on g and ``_D_FLOOR``
on the modeled power D (it caps the IS weights y/D^2 at ~1e14, which keeps
60+-epoch float32 runs finite).

Every tensor carries a leading batch axis of independent mixtures: H, g
and nu sum over each mixture's own bins, so a batch cannot be folded into
the bin axis. Only the per-bin covariances and solves run on the folded
(nb*F) bins.
"""

from __future__ import annotations

import torch

from ..ops.covariance import covariance, weighted_covariance_tf
from ..ops.linalg import align_eigvec_phase, clamp_pow2, eigh, gauss_solve, mat_h, quad_form
from ..parallel.collectives import psum
from .overiva import fold_mixtures

__all__ = [
    "fastmnmf2_iterations",
    "fastmnmf2_wiener",
    "pick_loudest",
    "unit_power",
    "whiten_q",
]

_EPS = 1e-10
_G_FLOOR = 1e-4
_D_FLOOR = 1e-7


def unit_power(X):
    """(X / s, s) with s (nb, 1, 1, 1) = sqrt(mean |X|^2) of each mixture
    (1 for a silent one). X: (nb, T, F, M)."""
    s = torch.sqrt(torch.mean(X.abs() ** 2, dim=(1, 2, 3), keepdim=True))
    s = torch.where(s > 0, s, torch.ones_like(s))
    return X / s, s


def whiten_q(X):
    """Per-bin whitening basis Lam^{-1/2} E^H of each mixture's input
    covariance, eigenvector phases aligned: (nb, F, M, M)."""
    nb, T, F, M = X.shape
    ew, E = eigh(covariance(fold_mixtures(X)))
    E = align_eigvec_phase(E)
    scale = torch.sqrt(torch.clamp_min(ew, 1e-12))[:, None, :]
    return mat_h(E / scale).reshape(nb, F, M, M)


def _g_sub(g):
    """einsum index of the spatial weights: tied (nb, N, M) or untied
    (nb, N, F, M)."""
    return "bnm" if g.ndim == 3 else "bnfm"


def _psd(W, H):
    return torch.clamp_min(torch.einsum("bnfl,bnlt->bnft", W, H), _EPS)


def _denom(lam, g):
    return torch.clamp_min(torch.einsum(f"bnft,{_g_sub(g)}->btfm", lam, g), _D_FLOOR)


def _diag_power(X, Q):
    Qx = torch.einsum("bfmn,btfn->btfm", Q, X)
    return Qx, Qx.abs() ** 2


def _fmask(x, bin_mask):
    """Zero the padded bins (``bin_mask`` (F,)) along axis 2 of a (nb, n,
    F, ...) tensor."""
    if bin_mask is None:
        return x
    return x * bin_mask.to(x.dtype).reshape(x.shape[2], *[1] * (x.ndim - 3))


def _weights(y, lam, g):
    """The IS statistics (S1, S2) (nb, N, F, T) of the diagonal powers y
    under the PSDs lam and the spatial weights g."""
    D = _denom(lam, g)
    gs = _g_sub(g)
    S1 = torch.einsum(f"btfm,{gs}->bnft", y / D**2, g)
    S2 = torch.einsum(f"btfm,{gs}->bnft", 1.0 / D, g)
    return S1, S2


def _update_W(y, g, W, H):
    """The NMF basis W, per bin."""
    S1, S2 = _weights(y, _psd(W, H), g)
    num = torch.einsum("bnft,bnlt->bnfl", S1, H)
    den = torch.einsum("bnft,bnlt->bnfl", S2, H)
    return torch.clamp_min(W * torch.sqrt(num / torch.clamp_min(den, _EPS)), _EPS)


def _update_H(y, g, W, H, group=None, bin_mask=None):
    """The NMF activations H: sums over all of a mixture's bins."""
    S1, S2 = _weights(y, _psd(W, H), g)
    num = psum(torch.einsum("bnft,bnfl->bnlt", _fmask(S1, bin_mask), W), group)
    den = psum(torch.einsum("bnft,bnfl->bnlt", _fmask(S2, bin_mask), W), group)
    return torch.clamp_min(H * torch.sqrt(num / torch.clamp_min(den, _EPS)), _EPS)


def _update_g(y, g, W, H, group=None, bin_mask=None):
    """The spatial weights g: tied sums over all bins and frames, untied
    per bin."""
    gs = _g_sub(g)
    lam = _psd(W, H)
    D = _denom(lam, g)
    tied = g.ndim == 3  # a tied g sums over all bins, an untied one per bin
    lam_g = _fmask(lam, bin_mask) if tied else lam
    num = torch.einsum(f"bnft,btfm->{gs}", lam_g, y / D**2)
    den = torch.einsum(f"bnft,btfm->{gs}", lam_g, 1.0 / D)
    if tied:
        num, den = psum(num, group), psum(den, group)
    return torch.clamp_min(g * torch.sqrt(num / torch.clamp_min(den, _EPS)), _G_FLOOR)


def _q_covariances(X, g, W, H, wcov: str = "f32"):
    """The M covariances of the diagonalizer rows, weights 1/D on the
    folded (nb*F) bins; they depend only on D."""
    nb, T, F, M = X.shape
    D = _denom(_psd(W, H), g)
    Xf = fold_mixtures(X)
    return [
        weighted_covariance_tf(Xf, (1.0 / D[..., m]).transpose(0, 1).reshape(T, nb * F), wcov)
        for m in range(M)
    ]


def _q_rows(Q, Vs, n_q_sweeps: int = 1):
    """Sequential IP of the rows of Q (nb, F, M, M) on the covariances Vs,
    ``n_q_sweeps`` sweeps."""
    nb, F, M, _ = Q.shape
    Qf = Q.reshape(nb * F, M, M).clone()
    for _ in range(n_q_sweeps):
        for m in range(M):  # rows are order-dependent through Q
            V = Vs[m]
            e_m = torch.zeros((nb * F, M, 1), dtype=Qf.dtype, device=Qf.device)
            e_m[:, m] = 1.0
            q = clamp_pow2(gauss_solve(Qf @ V, e_m)[:, :, 0])  # overflow guard, exact
            # where the form cancels to rounding noise, keep the previous row
            nrm, good = quad_form(q, V)
            q = q / torch.sqrt(torch.where(good, torch.clamp_min(nrm, _EPS), torch.ones_like(nrm)))[:, None]
            q = torch.where(good[:, None], q, Qf[:, m].conj())
            Qf[:, m] = q.conj()
    return Qf.reshape(nb, F, M, M)


def _normalise(Q, g, W, H, group=None, bin_mask=None):
    """The likelihood-invariant normalisation (phi, mu, nu; nu sums over
    all bins)."""
    M = Q.shape[2]
    phi = torch.einsum("bfmn,bfmn->bf", Q, Q.conj()).real / M  # (nb, F)
    Q = Q / torch.sqrt(phi)[:, :, None, None]
    W = W / phi[:, None, :, None]
    mu = g.sum(dim=-1, keepdim=True)  # (nb, N, 1) tied / (nb, N, F, 1) untied
    g = g / mu
    W = W * (mu if g.ndim == 4 else mu[..., None])
    nu = torch.clamp_min(psum(_fmask(W, bin_mask).sum(dim=2, keepdim=True), group), _EPS)
    return Q, g, W / nu, H * nu.transpose(2, 3)  # nu: (nb, N, 1, L)


def _epoch(X, Q, g, W, H, wcov: str = "f32", n_q_sweeps: int = 1, group=None,
           bin_mask=None):
    """One epoch. X: (nb, T, F, M); Q: (nb, F, M, M); g: (nb, N, M) or
    (nb, N, F, M); W: (nb, N, F, L); H: (nb, N, L, T).

    Bin-sharded (``group``, ``bin_mask`` (F,) zeroing the padded bins):
    the frequency-reduced statistics are psum'd, the H pair, the tied g
    pair and the nu normalizer, five collectives an epoch (three for the
    untied g of FastMNMF1, whose update is per bin)."""
    _, y = _diag_power(X, Q)  # (nb, T, F, M)
    W = _update_W(y, g, W, H)
    H = _update_H(y, g, W, H, group, bin_mask)
    g = _update_g(y, g, W, H, group, bin_mask)
    Q = _q_rows(Q, _q_covariances(X, g, W, H, wcov), n_q_sweeps)
    return _normalise(Q, g, W, H, group, bin_mask)


def fastmnmf2_iterations(X, Q, g, W, H, n_iter: int, wcov: str = "f32",
                         n_q_sweeps: int = 1):
    """Run ``n_iter`` epochs. X: (nb, T, F, M) complex; Q: (nb, F, M, M);
    g: (nb, N, M) tied / (nb, N, F, M) untied; W: (nb, N, F, L); H: (nb,
    N, L, T). Returns (Q, g, W, H)."""
    for _ in range(n_iter):
        Q, g, W, H = _epoch(X, Q, g, W, H, wcov, n_q_sweeps)
    return Q, g, W, H


def fastmnmf2_wiener(X, Q, g, W, H, mic_index: int = 0):
    """Multichannel Wiener source images at one mic: (nb, T, F, N) complex,
    x_hat[n] = (Q^{-1} diag(lam_n g_n / D) Q x)[mic_index]. The row of
    Q^{-1} is solved per bin (Q^T r = e_mic)."""
    nb, T, F, M = X.shape
    Qx, _ = _diag_power(X, Q)
    lam = _psd(W, H)
    D = _denom(lam, g)
    e = torch.zeros((nb * F, M, 1), dtype=Q.dtype, device=Q.device)
    e[:, mic_index] = 1.0
    r = gauss_solve(Q.transpose(-1, -2).reshape(nb * F, M, M), e)[:, :, 0].reshape(nb, F, M)
    gb = g[:, :, None, None, :] if g.ndim == 3 else g[:, :, None, :, :]
    # gain[b, n, t, f, m] = lam[b, n, f, t] g[b, n, (f,) m] / D[b, t, f, m]
    gain = lam.transpose(2, 3)[..., None] * gb / D[:, None]
    return torch.einsum("bfm,bntfm->btfn", r, gain * Qx[:, None])


def pick_loudest(Y, n_out: int, group=None, bin_mask=None):
    """The ``n_out`` outputs of Y (nb, T, F, N) with the most energy in each
    mixture, in their original order (a stable sort, as ``jnp.argsort``).
    Bin-sharded, the energies are psum'd over ``group`` (padded bins
    masked out) so that every rank picks the same outputs."""
    if n_out >= Y.shape[3]:
        return Y
    p = Y.abs() ** 2
    if bin_mask is not None:
        p = p * bin_mask.to(p.dtype)[:, None]
    en = psum(p.sum(dim=(1, 2)), group)  # (nb, N)
    pick = torch.sort(torch.argsort(-en, dim=1, stable=True)[:, :n_out], dim=1).values
    return torch.gather(Y, 3, pick[:, None, None, :].expand(*Y.shape[:3], n_out))
