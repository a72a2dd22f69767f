"""NumPy oracle ILRMA (determined BSS with an NMF source model): the port's
copy of ``overiva_tpu/oracle/ilrma.py``, the float64 reference that
``chip_smoke.py`` holds the port to.

Reference behavior: ``pyroomacoustics.bss.ilrma`` — the comparison baseline
the reference's sweep runs alongside OverIVA (SURVEY.md §2.1, §2.5).
Algorithm: Kitamura, Ono, Sawada, Kameoka, Saruwatari, "Determined blind
source separation unifying independent vector analysis and nonnegative
matrix factorization", IEEE/ACM TASLP 24(9), 2016 (ILRMA1).

Per source k the spectrogram variance is modeled rank-K: R_k = B_k H_k with
B_k (F, K) >= 0, H_k (K, T) >= 0. Each epoch: IS-NMF multiplicative updates
of (B_k, H_k), then an AuxIVA-style iterative-projection update with the
per-(t,f) weights 1/R_k, then per-source scale normalization.
"""

from __future__ import annotations

import numpy as np

from .projection import projection_back

__all__ = ["ilrma"]

_EPS = 1e-15


def ilrma(
    X: np.ndarray,
    n_src: int | None = None,
    n_iter: int = 20,
    proj_back: bool = True,
    W0: np.ndarray | None = None,
    n_components: int = 2,
    return_filters: bool = False,
    callback=None,
    callback_every: int = 10,
    seed: int = 0,
):
    """X: (n_frames, n_freq, n_chan) complex; determined (n_src == n_chan).

    Returns Y (n_frames, n_freq, n_src) [, W (n_freq, n_src, n_chan)].
    """
    X = np.asarray(X)
    T, F, M = X.shape
    N = M if n_src is None else n_src
    if N != M:
        raise ValueError("ilrma is determined: n_src must equal n_chan")
    K = n_components

    rng = np.random.default_rng(seed)
    W = np.tile(np.eye(M, dtype=X.dtype), (F, 1, 1)) if W0 is None else W0.copy()
    B = rng.random((N, F, K)) + 0.1  # nonneg basis
    H = rng.random((N, K, T)) + 0.1  # nonneg activations

    eyes = np.tile(np.eye(M, dtype=X.dtype), (F, 1, 1))

    def demix(W):
        return np.einsum("fnm,tfm->tfn", W, X)

    for epoch in range(n_iter):
        Y = demix(W)
        if callback is not None and epoch % callback_every == 0:
            num = projection_back(Y, X[:, :, 0])
            callback(Y * np.conj(num)[None, :, :])
        P = np.abs(Y) ** 2  # (T, F, N)

        for k in range(N):
            Pk = P[:, :, k].T  # (F, T)
            R = B[k] @ H[k] + _EPS  # (F, T)

            # IS-NMF multiplicative updates (auxiliary-function form)
            B[k] *= np.sqrt(((Pk / R**2) @ H[k].T) / ((1.0 / R) @ H[k].T + _EPS))
            B[k] = np.maximum(B[k], _EPS)
            R = B[k] @ H[k] + _EPS
            H[k] *= np.sqrt((B[k].T @ (Pk / R**2)) / (B[k].T @ (1.0 / R) + _EPS))
            H[k] = np.maximum(H[k], _EPS)
            R = B[k] @ H[k] + _EPS

            # IP update with per-(t,f) weights 1/R
            V = np.einsum("ft,tfm,tfn->fmn", 1.0 / R, X, np.conj(X)) / T
            WV = W @ V
            w = np.linalg.solve(WV, eyes[:, :, k : k + 1])[:, :, 0]
            denom = np.einsum("fm,fmn,fn->f", np.conj(w), V, w)
            w = w / np.sqrt(np.real(denom))[:, None]
            W[:, k, :] = np.conj(w)

            # rescale source k to unit average power (ILRMA1 normalization)
            yk = np.einsum("fm,tfm->tf", np.conj(w), X)  # (T, F)
            lam = np.sqrt(np.mean(np.abs(yk) ** 2)) + _EPS
            W[:, k, :] /= lam
            B[k] /= lam**2
            P[:, :, k] = np.abs(yk / lam) ** 2

    Y = demix(W)
    if proj_back:
        z = projection_back(Y, X[:, :, 0])
        Y = Y * np.conj(z)[None, :, :]
    if return_filters:
        return Y, W
    return Y
