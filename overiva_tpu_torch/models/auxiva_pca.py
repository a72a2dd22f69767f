"""PCA + AuxIVA on tensors.

Counterpart of ``overiva_tpu/models/auxiva_pca.py`` (and the oracle's
``overiva_tpu/oracle/auxiva_pca.py``): reduce each bin to its top-n_src
principal subspace, then run determined AuxIVA (IP, ISS or IP2) on the
reduced STFT.
"""

from __future__ import annotations

import torch

from ..ops.covariance import covariance
from ..ops.linalg import align_eigvec_phase, eigh
from .family import run_family

__all__ = ["pca", "auxiva_pca_run"]


def pca(X, n_src: int, return_basis: bool = False):
    """Per-bin projection onto the top-n_src principal subspace.

    X: (T, F, M) -> (T, F, n_src). Eigenvectors by descending eigenvalue,
    no whitening, with the oracle's deterministic phase.
    """
    _, vecs = eigh(covariance(X))  # ascending
    E_top = align_eigvec_phase(vecs.flip(-1)[:, :, :n_src])  # (F, M, n_src)
    X_r = torch.einsum("fmk,tfm->tfk", E_top.conj(), X)
    if return_basis:
        return X_r, E_top
    return X_r


def auxiva_pca_run(X, n_src: int, n_iter: int, model: str, inner: str = "ip",
                   n_mix: int = 1):
    """PCA reduce then determined AuxIVA by ``inner`` ("ip", "iss" or
    "ip2") on ``n_mix`` folded mixtures. Returns (Y, W_reduced)."""
    X_r = pca(X, n_src) if n_src < X.shape[2] else X
    return run_family(X_r, n_src, n_iter, model, inner, n_mix=n_mix)
