"""NumPy oracle AuxIVA (determined, iterative-projection updates): the port's
copy of ``overiva_tpu/oracle/auxiva.py``, which the SparseAuxIVA oracle runs.

Reference behavior: ``pyroomacoustics.bss.auxiva`` as used by the reference's
``example.py``/``mbss_sim.py`` (SURVEY.md §2.3.2; Ono, "Stable and fast update
rules for independent vector analysis based on auxiliary function technique",
WASPAA 2011).
"""

from __future__ import annotations

import numpy as np

from .models import activations
from .projection import apply_projection_back, projection_back

__all__ = ["auxiva"]


def _demix(X: np.ndarray, W: np.ndarray) -> np.ndarray:
    """Y[t,f,n] = sum_m W[f,n,m] X[t,f,m]."""
    return np.einsum("fnm,tfm->tfn", W, X)


def auxiva(
    X: np.ndarray,
    n_src: int | None = None,
    n_iter: int = 20,
    proj_back: bool = True,
    W0: np.ndarray | None = None,
    model: str = "laplace",
    return_filters: bool = False,
    callback=None,
    callback_every: int = 10,
):
    """AuxIVA with iterative-projection (IP) updates.

    X: (n_frames, n_freq, n_chan) complex mixture STFT.
    Returns Y (n_frames, n_freq, n_src) [, W (n_freq, n_src, n_chan)].

    The determined algorithm requires n_src == n_chan (reference asserts the
    same; use overiva/auxiva_pca for n_src < n_chan).
    """
    X = np.asarray(X)
    T, F, M = X.shape
    N = M if n_src is None else n_src
    if N != M:
        raise ValueError("auxiva is determined: n_src must equal n_chan")

    W = np.tile(np.eye(M, dtype=X.dtype), (F, 1, 1)) if W0 is None else W0.copy()

    eyes = np.tile(np.eye(M, dtype=X.dtype), (F, 1, 1))
    for epoch in range(n_iter):
        Y = _demix(X, W)

        if callback is not None and epoch % callback_every == 0:
            callback(apply_projection_back(Y, X[:, :, 0]))

        r, phi = activations(Y, model)  # (T, N)

        for k in range(N):
            # weighted covariance V[f] = (1/T) sum_t phi[t,k] x x^H
            V = np.einsum("t,tfm,tfn->fmn", phi[:, k], X, np.conj(X)) / T
            WV = W @ V
            w = np.linalg.solve(WV, eyes[:, :, k : k + 1])[:, :, 0]  # (F, M)
            # normalize: w^H V w == 1
            denom = np.einsum("fm,fmn,fn->f", np.conj(w), V, w)
            w = w / np.sqrt(np.real(denom))[:, None]
            W[:, k, :] = np.conj(w)

    Y = _demix(X, W)
    if proj_back:
        z = projection_back(Y, X[:, :, 0])
        Y = Y * np.conj(z)[None, :, :]
    if return_filters:
        return Y, W
    return Y
