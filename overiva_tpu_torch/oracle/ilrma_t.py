"""NumPy oracle ILRMA-T: JOINT dereverberation + ILRMA by source steering:
the port's copy of ``overiva_tpu/oracle/ilrma_t.py``, the float64 reference
that ``chip_smoke.py`` holds the port to.

Capability extension beyond the reference repo (SURVEY.md §2.1 covers
separation only). Lineage (PAPERS.md context): ILRMA-T — dereverberation
taps unified into the ILRMA update (Ikeshita et al., "Computationally
efficient and versatile framework for joint optimization of blind speech
separation and dereverberation", 2019) — realized here with the rank-1
ISS solver of Nakashima/Scheibler/Togami/Ono (ICASSP 2021), i.e. the NMF
source model dropped into the T-ISS coordinate descent (``oracle/tiss.py``
has the augmented-demixing derivation):

  * the source variance model is ILRMA's rank-K NMF, R_k = B_k H_k with
    IS-divergence multiplicative updates (same as ``oracle/ilrma.py``);
  * the demixing update steps are T-ISS rank-1 steering on the augmented
    input [X | taps delayed frames], with the PER-(t,f) weights
    phi_k(t, f) = 1/R_k(t, f) replacing the per-frame IVA weights
    (every E[.] in the steering coefficients gains an f-resolved weight);
  * the self-coefficient keeps its 1 - rsqrt(E_t[phi_n |y_n|^2]) form
    per bin (the log-det involves only the square block, as in T-ISS);
  * ILRMA1's per-source unit-average-power renormalization is applied per
    epoch, scaling (Y_k row, P row k, B_k) jointly — likelihood-invariant.

Every steering step exactly minimizes the ILRMA auxiliary function over
its coordinate block, so the exact negative log-likelihood descends per
epoch (validated by test — the framework's standard for reconstructed
update rules, PARITY.md). ``taps == 0`` gives ILRMA-ISS (same model as
``oracle/ilrma.py``, different — solve-free — optimizer; trajectories
differ from the IP variant, so parity is against THIS oracle).
"""

from __future__ import annotations

import numpy as np

from .projection import apply_projection_back, projection_back
from .wpe import delayed_taps

__all__ = ["ilrma_t", "ilrma_t_loglik"]

_EPS = 1e-15


def ilrma_t_loglik(X, P, B, H, taps: int, delay: int):
    """Exact ILRMA-T negative log-likelihood (up to constants):
    sum_{t,f,k} [ |y_k|^2 / R_k + log R_k ] - 2 T sum_f log|det W_square|.
    """
    X = np.asarray(X)
    T, F, M = X.shape
    Xt = (
        np.concatenate([X, delayed_taps(X, taps, delay)], axis=2)
        if taps
        else X
    )
    Y = np.einsum("fnj,tfj->tfn", P, Xt)
    R = np.einsum("nfk,nkt->tfn", B, H) + _EPS
    term = np.sum(np.abs(Y) ** 2 / R + np.log(R))
    _, logdet = np.linalg.slogdet(P[:, :, :M])
    return float(term - 2 * T * np.sum(logdet))


def ilrma_t(
    X: np.ndarray,
    n_src: int | None = None,
    taps: int = 5,
    delay: int = 2,
    n_iter: int = 20,
    proj_back: bool = True,
    W0: np.ndarray | None = None,
    n_components: int = 2,
    return_filters: bool = False,
    callback=None,
    callback_every: int = 10,
    seed: int = 0,
    return_nmf: bool = False,
):
    """X: (n_frames, n_freq, n_chan) complex; determined (n_src == n_chan).

    Returns Y (T, F, M) [, P (F, M, M + M*taps)] [, (B, H) when
    ``return_nmf`` — for the exact-likelihood gate].
    """
    X = np.asarray(X)
    T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if N != M:
        raise ValueError("ilrma_t is determined: n_src must equal n_chan")
    if taps < 0 or (taps > 0 and delay < 1):
        raise ValueError("need taps >= 0 and delay >= 1 when taps > 0")
    K = n_components
    MK = M * taps

    rng = np.random.default_rng(seed)
    P = np.zeros((F, M, M + MK), dtype=X.dtype)
    P[:, :, :M] = np.eye(M, dtype=X.dtype)
    if W0 is not None:
        W0 = np.asarray(W0)
        if W0.shape[2] == M + MK:
            P = W0.copy()
        else:
            P[:, :, :M] = W0
    B = rng.random((N, F, K)) + 0.1
    H = rng.random((N, K, T)) + 0.1

    Xt = np.concatenate([X, delayed_taps(X, taps, delay)], axis=2) if taps else X
    Y = np.einsum("fnj,tfj->tfn", P, Xt)

    for epoch in range(n_iter):
        if callback is not None and epoch % callback_every == 0:
            callback(apply_projection_back(Y, X[:, :, 0]))

        # IS-NMF multiplicative updates per source (as oracle/ilrma.py)
        Pw = np.abs(Y) ** 2  # (T, F, N)
        for k in range(N):
            Pk = Pw[:, :, k].T  # (F, T)
            R = B[k] @ H[k] + _EPS
            B[k] *= np.sqrt(((Pk / R**2) @ H[k].T) / ((1.0 / R) @ H[k].T + _EPS))
            B[k] = np.maximum(B[k], _EPS)
            R = B[k] @ H[k] + _EPS
            H[k] *= np.sqrt((B[k].T @ (Pk / R**2)) / (B[k].T @ (1.0 / R) + _EPS))
            H[k] = np.maximum(H[k], _EPS)

        # per-(t, f, k) contrast weights
        phi = 1.0 / (np.einsum("nfk,nkt->tfn", B, H) + _EPS)  # (T, F, N)

        for n in range(M):  # source steering, f-resolved weights
            yn = Y[:, :, n]  # (T, F)
            num = np.einsum("tfm,tfm,tf->fm", phi, Y, np.conj(yn))
            den = np.einsum("tfm,tf->fm", phi, np.abs(yn) ** 2)
            v = num / np.maximum(den, _EPS)  # (F, M)
            dnn = den[:, n] / T
            v[:, n] = 1.0 - 1.0 / np.sqrt(np.maximum(dnn, _EPS))
            Y = Y - v[None, :, :] * yn[:, :, None]
            P = P - v[:, :, None] * P[:, n, :][:, None, :]

        for j in range(MK):  # tap steering: weighted LS, no self term
            zj = Xt[:, :, M + j]  # (T, F)
            num = np.einsum("tfm,tfm,tf->fm", phi, Y, np.conj(zj))
            den = np.einsum("tfm,tf->fm", phi, np.abs(zj) ** 2)
            v = num / np.maximum(den, _EPS)
            Y = Y - v[None, :, :] * zj[:, :, None]
            P[:, :, M + j] = P[:, :, M + j] - v

        # ILRMA1 renormalization: unit average power per source,
        # likelihood-invariant (scales filters and NMF model jointly)
        lam = np.sqrt(np.mean(np.abs(Y) ** 2, axis=(0, 1))) + _EPS  # (N,)
        Y /= lam[None, None, :]
        P /= lam[:, None]
        B /= (lam**2)[:, None, None]

    if proj_back:
        z = projection_back(Y, X[:, :, 0])
        Y = Y * np.conj(z)[None, :, :]
    out = (Y,)
    if return_filters:
        out += (P,)
    if return_nmf:
        out += ((B, H),)
    return out if len(out) > 1 else Y
