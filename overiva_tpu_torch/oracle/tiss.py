"""NumPy oracle T-ISS: JOINT dereverberation + separation by source steering:
the port's copy of ``overiva_tpu/oracle/tiss.py``, the float64 reference
that ``chip_smoke.py`` holds the port to.

Capability extension beyond the reference repo (SURVEY.md §2.1 covers
separation only), from the retrieved literature lineage (PAPERS.md:
arXiv:2009.09402 ISS; Nakashima, Scheibler, Togami & Ono, ICASSP 2021,
"Joint dereverberation and separation with iterative source steering").
The published idea: demix an AUGMENTED input

    x_tilde[t, f] = [ x[t, f] ; x[t-delay, f] ; ... ; x[t-delay-taps+1, f] ]

with P = [W | U] in C^{M x (M + M*taps)}, y = P x_tilde, and minimize the
usual IVA auxiliary function by rank-1 steering steps only — no solves:

  * source steps n = 0..M-1: identical to plain ISS (oracle/auxiva_iss.py),
    applied to the augmented rows — the log|det| term of the likelihood
    involves only the square instantaneous block W, so the self-coefficient
    keeps its 1 - 1/sqrt(E[phi_n |y_n|^2]) form;
  * tap steps j = 0..M*taps-1 against the DELAYED observations
    z_j = x_tilde[:, :, M+j]: the determinant is unaffected by U, so the
    exact coordinate minimizer is plain weighted least squares,
        v_m[f] = E[phi_m y_m conj(z_j)] / E[phi_m |z_j|^2],
    for every output m (no self term), then Y -= v z_j, P[:, M+j] -= v.

Each step exactly minimizes the auxiliary function over its coordinate
block, so the surrogate descends monotonically (validated by test, the
framework's standard for reconstructed update rules — PARITY.md).

Overdetermined n_src < M uses the same stationary unit-Gaussian background
view as ``oracle/overiva_iss.py`` (phi = 1 on the M - n_src background
outputs). ``taps == 0`` degenerates exactly to overiva_iss / auxiva_iss.

The separated outputs are also DEREVERBERATED — when scoring against
reverberant premix references, expect SIR (leakage) gains; SDR against the
wet reference can move either way because the target itself is drier.
"""

from __future__ import annotations

import numpy as np

from .models import activations
from .projection import apply_projection_back, projection_back
from .wpe import delayed_taps

__all__ = ["tiss"]

_EPS = 1e-15


def tiss(
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
):
    """X: (n_frames, n_freq, n_chan) complex; returns Y (T, F, n_src) [, P].

    P is the full (F, M, M + M*taps) augmented demixing stack. W0 may be a
    previous P, a full (F, M, M) square stack, or (F, N, M) target rows
    (placed into identity, zero tap block), mirroring ``oracle/overiva``.
    """
    X = np.asarray(X)
    T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if not 1 <= N <= M:
        raise ValueError(f"n_src must be in [1, {M}], got {N}")
    if taps < 0 or (taps > 0 and delay < 1):
        raise ValueError("need taps >= 0 and delay >= 1 when taps > 0")
    MK = M * taps

    P = np.zeros((F, M, M + MK), dtype=X.dtype)
    P[:, :, :M] = np.eye(M, dtype=X.dtype)
    if W0 is not None:
        # dispatch on the ROW count first: at taps=0 the full-augmented
        # and square widths coincide (models/family.py::_augmented_w0 has the same rule)
        W0 = np.asarray(W0)
        if W0.shape[1] != M:
            P[:, :N, :M] = W0
        elif W0.shape[2] == M + MK:
            P = W0.copy()
        else:
            P[:, :, :M] = W0

    Xt = np.concatenate([X, delayed_taps(X, taps, delay)], axis=2) if taps else X
    Y = np.einsum("fnj,tfj->tfn", P, Xt)

    for epoch in range(n_iter):
        if callback is not None and epoch % callback_every == 0:
            callback(apply_projection_back(Y[:, :, :N], X[:, :, 0]))

        r, phi = activations(Y[:, :, :N], model)  # (T, N)
        if N < M:
            phi = np.concatenate([phi, np.ones((T, M - N), phi.dtype)], axis=1)

        for n in range(M):  # source steering == plain ISS on augmented rows
            yn = Y[:, :, n]  # (T, F)
            num = np.einsum("tm,tfm,tf->fm", phi, Y, np.conj(yn))
            den = np.einsum("tm,tf->fm", phi, np.abs(yn) ** 2)
            v = num / np.maximum(den, _EPS)  # (F, M)
            dnn = den[:, n] / T
            v[:, n] = 1.0 - 1.0 / np.sqrt(np.maximum(dnn, _EPS))
            Y = Y - v[None, :, :] * yn[:, :, None]
            P = P - v[:, :, None] * P[:, n, :][:, None, :]

        for j in range(MK):  # tap steering: pure weighted LS, no self term
            zj = Xt[:, :, M + j]  # (T, F)
            num = np.einsum("tm,tfm,tf->fm", phi, Y, np.conj(zj))
            den = np.einsum("tm,tf->fm", phi, np.abs(zj) ** 2)
            v = num / np.maximum(den, _EPS)  # (F, M)
            Y = Y - v[None, :, :] * zj[:, :, None]
            P[:, :, M + j] = P[:, :, M + j] - v

    Y = Y[:, :, :N]
    if proj_back:
        z = projection_back(Y, X[:, :, 0])
        Y = Y * np.conj(z)[None, :, :]
    if return_filters:
        return Y, P
    return Y
