"""NumPy oracle T-IP: joint dereverberation + separation, IP updates: the
port's copy of ``overiva_tpu/oracle/tip.py``, the float64 reference that
``chip_smoke.py`` holds the port to.

Capability extension beyond the reference repo, completing the joint-
dereverb family (PARITY.md rows 19/20): the same augmented-demixing view
as T-ISS (``oracle/tiss.py``) driven by EXACT iterative-projection row
updates instead of rank-1 steering. Lineage: the ILRMA-T joint-
optimization framework (Ikeshita et al. 2019) restricted to the IVA
source model; the T-ISS paper (Nakashima et al., ICASSP 2021) uses this
IP variant as its baseline ("ILRMA-T-IP" there).

Model: y[t, f] = P_top x_tilde[t, f] with x_tilde = [x; delayed taps]
(C^{MJ}, MJ = M + M*taps) and the implicit full square demixing
P_tilde = [[W, U], [0, I]], whose log-determinant involves ONLY the
instantaneous block W. The auxiliary function is therefore the standard
AuxIVA surrogate with MJ-dimensional weighted covariances

    V_k[f] = (1/T) sum_t phi_k(t) x_tilde x_tilde^H      (F, MJ, MJ)

and the exact IP row update solves the MJ-dim system

    w_k = (P_tilde V_k)^{-1} e_k,   w_k <- w_k / sqrt(w_k^H V_k w_k),
    P_top[k] = conj(w_k)

— each step the exact minimizer of the surrogate over the full augmented
row (separation AND dereverberation coefficients jointly), so the
surrogate descends monotonically (validated by test). Because the bottom
block of P_tilde is the constant [0, I], the matrix product needs only
P_top @ V_k stacked on V_k's bottom rows — no MJ x MJ GEMM.

``taps = 0, n_src = M`` degenerates EXACTLY to AuxIVA (oracle/auxiva.py
trajectory). Overdetermined ``n_src < M`` uses the stationary
unit-Gaussian background view (phi = 1 extra outputs) exactly as
``oracle/overiva_iss.py`` — fixed points match OverIVA's, trajectories
are parity-tested against THIS oracle.
"""

from __future__ import annotations

import numpy as np

from .models import activations
from .projection import apply_projection_back, projection_back
from .wpe import delayed_taps

__all__ = ["tip"]

_EPS = 1e-15


def tip(
    X: np.ndarray,
    n_src: int | None = None,
    taps: int = 5,
    delay: int = 2,
    n_iter: int = 20,
    proj_back: bool = True,
    W0: np.ndarray | None = None,
    model: str = "laplace",
    return_filters: bool = False,
    callback=None,
    callback_every: int = 10,
    warm_iter: int = 10,
):
    """X: (n_frames, n_freq, n_chan) complex; returns Y (T, F, n_src) [, P].

    P is the (F, M, M + M*taps) augmented top block [W | U]. W0 may be a
    previous P, a square (F, M, M) stack, or (F, N, M) target rows.

    ``warm_iter``: number of T-ISS epochs run first (same objective,
    rank-1 steps) when no W0 is given. MEASURED ESSENTIAL: cold-start
    full-row IP updates collapse on some scenes (3-seed hard-room probe:
    SIR 0.7-6.2 cold vs 6.0-11.4 warm+gauss) — the exact MJ-dim solve
    gives early garbage activations full control of the taps, while the
    rank-1 warm-up routes the trajectory to the right basin first.
    """
    X = np.asarray(X)
    T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if not 1 <= N <= M:
        raise ValueError(f"n_src must be in [1, {M}], got {N}")
    if taps < 0 or (taps > 0 and delay < 1):
        raise ValueError("need taps >= 0 and delay >= 1 when taps > 0")
    MK = M * taps
    MJ = M + MK

    P = np.zeros((F, M, MJ), dtype=X.dtype)
    P[:, :, :M] = np.eye(M, dtype=X.dtype)
    if W0 is not None:
        # dispatch on the ROW count first: at taps=0 the full-augmented
        # and square widths coincide (models/family.py::_augmented_w0 has the same rule)
        W0 = np.asarray(W0)
        if W0.shape[1] != M:
            P[:, :N, :M] = W0
        elif W0.shape[2] == MJ:
            P = W0.copy()
        else:
            P[:, :, :M] = W0
    elif warm_iter > 0 and taps > 0:
        # (taps == 0 is plain AuxIVA — cold start is fine and keeps the
        # exact degeneration; the instability is tap-induced)
        from .tiss import tiss

        _, P = tiss(
            X, n_src=N, taps=taps, delay=delay, n_iter=warm_iter,
            proj_back=False, model=model, return_filters=True,
        )

    Xt = np.concatenate([X, delayed_taps(X, taps, delay)], axis=2) if taps else X
    ident = np.eye(MJ, dtype=X.dtype)

    for epoch in range(n_iter):
        Y = np.einsum("fnj,tfj->tfn", P, Xt)
        if callback is not None and epoch % callback_every == 0:
            callback(apply_projection_back(Y[:, :, :N], X[:, :, 0]))

        r, phi = activations(Y[:, :, :N], model)  # (T, N)
        if N < M:
            phi = np.concatenate([phi, np.ones((T, M - N), phi.dtype)], axis=1)

        for k in range(M):
            # MJ-dim weighted covariance of the augmented input
            V = np.einsum("t,tfa,tfb->fab", phi[:, k], Xt, np.conj(Xt)) / T
            # P_tilde @ V without forming P_tilde: top M rows are P @ V,
            # bottom MK rows of [0 I] @ V are V's bottom rows
            PV = np.concatenate([P @ V, V[:, M:, :]], axis=1)  # (F, MJ, MJ)
            w = np.linalg.solve(PV, ident[None, :, k : k + 1])[:, :, 0]
            denom = np.einsum("fa,fab,fb->f", np.conj(w), V, w)
            w = w / np.sqrt(np.maximum(np.real(denom), _EPS))[:, None]
            P[:, k, :] = np.conj(w)

    Y = np.einsum("fnj,tfj->tfn", P, Xt)[:, :, :N]
    if proj_back:
        z = projection_back(Y, X[:, :, 0])
        Y = Y * np.conj(z)[None, :, :]
    if return_filters:
        return Y, P
    return Y
