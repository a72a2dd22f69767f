"""NumPy oracle FIVE (Fast Independent Vector Extraction): the port's copy of
``overiva_tpu/oracle/five.py``, the float64 reference that ``chip_smoke.py``
holds the port to.

Capability extension beyond the reference repo, same task as its ``ive.py``
(single-source extraction) but via iterative SINR maximization instead of
gradient ascent (Scheibler & Ono, "Fast independent vector extraction by
iterative SINR maximization", ICASSP 2020): work in the whitened domain,
where each outer iteration sets the extraction filter to the minimum
eigenvector of the weighted covariance. Converges in a handful of
iterations where OGIVE needs thousands.
"""

from __future__ import annotations

import numpy as np

from .models import activations
from .projection import apply_projection_back, projection_back

__all__ = ["five"]


def five(
    X: np.ndarray,
    n_iter: int = 10,
    proj_back: bool = True,
    model: str = "laplace",
    return_filters: bool = False,
    callback=None,
    callback_every: int = 1,
):
    """Extract one source. X: (n_frames, n_freq, n_chan) complex.

    Returns Y (n_frames, n_freq, 1) [, w (n_freq, n_chan) unwhitened filters].
    """
    X = np.asarray(X)
    T, F, M = X.shape

    # whitening: Cx^{-1/2} via eigh
    Cx = np.einsum("tfm,tfn->fmn", X, np.conj(X)) / T
    lam, E = np.linalg.eigh(Cx)
    lam = np.maximum(lam, 1e-15)
    Q = E * (lam[:, None, :] ** -0.5) @ np.conj(np.swapaxes(E, 1, 2))  # (F,M,M)
    Xw = np.einsum("fmn,tfn->tfm", Q, X)

    # init: direction of the strongest whitened component — use the
    # principal eigenvector of the phi-less (identity-weighted) covariance,
    # i.e. any unit vector works since Cxw = I; use e_0.
    w = np.zeros((F, M), dtype=X.dtype)
    w[:, 0] = 1.0

    for epoch in range(n_iter):
        y = np.einsum("fm,tfm->tf", np.conj(w), Xw)
        if callback is not None and epoch % callback_every == 0:
            Yc = y[:, :, None]
            callback(apply_projection_back(Yc, X[:, :, 0]))
        r, phi = activations(y[:, :, None], model)  # (T, 1)
        V = np.einsum("t,tfm,tfn->fmn", phi[:, 0], Xw, np.conj(Xw)) / T
        lam_v, E_v = np.linalg.eigh(V)
        w = E_v[:, :, 0]  # minimum-eigenvalue eigenvector
        # fix arbitrary phase for determinism: largest |component| real+
        idx = np.argmax(np.abs(w), axis=1)
        ph = w[np.arange(F), idx]
        w = w * np.conj(ph / np.abs(ph))[:, None]

    Y = np.einsum("fm,tfm->tf", np.conj(w), Xw)[:, :, None]
    if proj_back:
        z = projection_back(Y, X[:, :, 0])
        Y = Y * np.conj(z)[None, :, :]
    if return_filters:
        # unwhitened demixing vector: y = w^H Q x = (Q^H w)^H x
        w_un = np.einsum("fmn,fn->fm", np.conj(np.swapaxes(Q, 1, 2)), w)
        return Y, w_un
    return Y
