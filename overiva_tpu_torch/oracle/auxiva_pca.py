"""NumPy oracle PCA + AuxIVA (dimensionality reduction, then determined IVA):
the port's copy of ``overiva_tpu/oracle/auxiva_pca.py``.

Reference behavior: the reference repo's ``auxiva_pca.py`` (SURVEY.md §2.3.5).
Per frequency bin, project the M-channel mixture onto the top-n_src principal
components of the input covariance, then run determined AuxIVA in the reduced
space, then projection-back against the ORIGINAL reference microphone.
"""

from __future__ import annotations

import numpy as np

from .auxiva import auxiva
from .models import align_eigvec_phase
from .projection import projection_back

__all__ = ["pca", "auxiva_pca"]


def pca(X: np.ndarray, n_src: int, return_basis: bool = False):
    """Per-bin PCA reduction to the top-n_src principal subspace.

    X: (T, F, M) -> X_r: (T, F, n_src), with X_r[t,f] = E_top[f]^H x[t,f].
    Eigenvectors are ordered by descending eigenvalue. No variance whitening is
    applied (VERIFY vs reference, SURVEY.md §2.3.5 — projection back at the end
    makes the pipeline scale-invariant either way).
    """
    T, F, M = X.shape
    Cx = np.einsum("tfm,tfn->fmn", X, np.conj(X)) / T
    eigval, eigvec = np.linalg.eigh(Cx)  # ascending
    E_top = eigvec[:, :, ::-1][:, :, :n_src]  # (F, M, n_src), largest first
    # deterministic phase so the LAPACK and XLA bases (and therefore the
    # reduced-space AuxIVA trajectories) coincide — PARITY round-2 fix
    E_top = align_eigvec_phase(E_top)
    X_r = np.einsum("fmk,tfm->tfk", np.conj(E_top), X)
    if return_basis:
        return X_r, E_top
    return X_r


def auxiva_pca(
    X: np.ndarray,
    n_src: int | None = None,
    n_iter: int = 20,
    proj_back: bool = True,
    model: str = "laplace",
    return_filters: bool = False,
    callback=None,
    **kwargs,
):
    """PCA to n_src channels, determined AuxIVA, projection back vs mic 0 of X."""
    X = np.asarray(X)
    T, F, M = X.shape
    N = M if n_src is None else n_src

    X_r = pca(X, N) if N < M else X
    res = auxiva(
        X_r,
        n_src=N,
        n_iter=n_iter,
        proj_back=False,
        model=model,
        return_filters=return_filters,
        callback=callback,
        **kwargs,
    )
    Y, W = res if return_filters else (res, None)

    if proj_back:
        z = projection_back(Y, X[:, :, 0])
        Y = Y * np.conj(z)[None, :, :]
    if return_filters:
        return Y, W
    return Y
