"""NumPy oracle OverIVA (overdetermined IVA, orthogonal-constraint background):
the port's copy of ``overiva_tpu/oracle/overiva.py``, the float64 reference
that ``chip_smoke.py`` holds the port to.

Reference behavior: the reference repo's ``overiva.py`` (SURVEY.md §2.3.3;
Scheibler & Ono, "Independent vector analysis with more microphones than
sources", WASPAA 2019; arXiv:1905.07880 / arXiv:2003.02458).

Structure: the full (M x M) demixing matrix is

    W_hat[f] = [[ W1[f]          ],      W1: (N, M) target rows
                [ J[f], -I_{M-N} ]]      J:  (M-N, N) background coupling

and after every target-row IP update the orthogonal constraint (OC)
``[J, -I] Cx W1^H = 0`` is re-imposed by solving for J.
"""

from __future__ import annotations

import numpy as np

from .models import activations, align_eigvec_phase
from .projection import apply_projection_back, projection_back

__all__ = ["overiva"]


def _demix_target(X: np.ndarray, W1: np.ndarray) -> np.ndarray:
    return np.einsum("fnm,tfm->tfn", W1, X)


def _update_J(W_hat: np.ndarray, Cx: np.ndarray, n_src: int) -> None:
    """Re-impose the orthogonal constraint: J = (E2^T Cx W1^H)(E1^T Cx W1^H)^-1.

    Implemented via ``tmp = W1 @ Cx`` (Cx Hermitian, so Cx W1^H = tmp^H):
    J^H = tmp[:, :, :N]^{-1} tmp[:, :, N:]  =>  J = solve(tmp[:,:,:N], tmp[:,:,N:])^H
    """
    N = n_src
    W1 = W_hat[:, :N, :]
    tmp = W1 @ Cx  # (F, N, M)
    J_H = np.linalg.solve(tmp[:, :, :N], tmp[:, :, N:])  # (F, N, M-N)
    W_hat[:, N:, :N] = np.conj(np.swapaxes(J_H, 1, 2))


def overiva(
    X: np.ndarray,
    n_src: int | None = None,
    n_iter: int = 20,
    proj_back: bool = True,
    W0: np.ndarray | None = None,
    model: str = "laplace",
    init_eig: bool = False,
    return_filters: bool = False,
    callback=None,
    callback_every: int = 10,
):
    """OverIVA: extract n_src sources from an n_chan > n_src mixture.

    X: (n_frames, n_freq, n_chan) complex mixture STFT.
    Returns Y (n_frames, n_freq, n_src) [, W_hat (n_freq, n_chan, n_chan)].

    With n_src == n_chan this reduces exactly to AuxIVA (no J block; the
    covariance Cx is then unused by the updates).
    """
    X = np.asarray(X)
    T, F, M = X.shape
    N = M if n_src is None else n_src
    if not (1 <= N <= M):
        raise ValueError("need 1 <= n_src <= n_chan")

    # input covariance (only needed for the OC update / init_eig)
    Cx = np.einsum("tfm,tfn->fmn", X, np.conj(X)) / T  # (F, M, M)

    W_hat = np.tile(np.eye(M, dtype=X.dtype), (F, 1, 1))
    if N < M:
        W_hat[:, N:, N:] = -np.eye(M - N, dtype=X.dtype)

    if W0 is not None:
        W_hat[:, :N, :] = W0[:, :N, :] if W0.shape[1] == M else W0
    elif init_eig:
        # principal subspace init: rows of W1 = conj(top-N eigenvectors)^T
        eigval, eigvec = np.linalg.eigh(Cx)  # ascending
        top = align_eigvec_phase(eigvec[:, :, ::-1][:, :, :N])  # (F, M, N)
        W_hat[:, :N, :] = np.conj(np.swapaxes(top, 1, 2))

    if N < M:
        _update_J(W_hat, Cx, N)

    eyes = np.tile(np.eye(M, dtype=X.dtype), (F, 1, 1))
    for epoch in range(n_iter):
        W1 = W_hat[:, :N, :]
        Y = _demix_target(X, W1)

        if callback is not None and epoch % callback_every == 0:
            callback(apply_projection_back(Y, X[:, :, 0]))

        r, phi = activations(Y, model)

        for k in range(N):
            V = np.einsum("t,tfm,tfn->fmn", phi[:, k], X, np.conj(X)) / T
            WV = W_hat @ V
            w = np.linalg.solve(WV, eyes[:, :, k : k + 1])[:, :, 0]  # (F, M)
            denom = np.einsum("fm,fmn,fn->f", np.conj(w), V, w)
            w = w / np.sqrt(np.real(denom))[:, None]
            W_hat[:, k, :] = np.conj(w)
            if N < M:
                _update_J(W_hat, Cx, N)

    Y = _demix_target(X, W_hat[:, :N, :])
    if proj_back:
        z = projection_back(Y, X[:, :, 0])
        Y = Y * np.conj(z)[None, :, :]
    if return_filters:
        return Y, W_hat
    return Y
