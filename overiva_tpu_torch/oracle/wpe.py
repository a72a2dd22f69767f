"""NumPy oracle WPE dereverberation (iterative, STFT domain): the port's
copy of ``overiva_tpu/oracle/wpe.py``, the float64 reference that
``chip_smoke.py`` holds the port to.

Capability extension beyond the reference repo (SURVEY.md §2.1 covers
separation only; real WASPAA'19-style scenes are reverberant, and the
classic production pipeline is dereverberation -> separation). This is the
standard iterative weighted-prediction-error algorithm (Nakatani et al.
2010, "Speech dereverberation based on variance-normalized delayed linear
prediction"; the nara_wpe package is the public reference implementation —
used here for the published update equations only, no code consulted):

    repeat n_iter times:
        lam[t,f]  = (1/M) sum_m |Y[t,f,m]|^2          (PSD estimate)
        R[f]      = sum_t Xd[t,f] Xd[t,f]^H / lam[t,f]   (MK x MK)
        P[f]      = sum_t Xd[t,f] X[t,f]^H  / lam[t,f]   (MK x M)
        G[f]      = R[f]^{-1} P[f]
        Y[t,f]    = X[t,f] - G[f]^H Xd[t,f]

where Xd stacks ``taps`` delayed frames X[t-delay], ..., X[t-delay-taps+1]
per channel. The delay keeps the direct path + early reflections out of the
prediction, so only late reverberation is subtracted. All frequency bins are
independent; the only cross-bin-free coupling is via lam's per-frame mean
over mics.

float64/complex128 throughout — this is the parity twin for
``overiva_tpu.ops.wpe`` (same role as every other ``oracle/`` module).
"""

from __future__ import annotations

import numpy as np

__all__ = ["wpe", "delayed_taps"]

_EPS = 1e-10


def delayed_taps(X: np.ndarray, taps: int, delay: int) -> np.ndarray:
    """Stack delayed frames: (T, F, M) -> (T, F, M*taps).

    Xd[t, f, m*taps + k] = X[t - delay - k, f, m], zero-padded at t < 0.
    """
    T, F, M = X.shape
    Xd = np.zeros((T, F, M, taps), dtype=X.dtype)
    for k in range(taps):
        s = delay + k
        if s < T:
            Xd[s:, :, :, k] = X[: T - s]
    return Xd.reshape(T, F, M * taps)


def wpe(
    X: np.ndarray,
    taps: int = 10,
    delay: int = 3,
    n_iter: int = 3,
    diag_load: float = 1e-5,
) -> np.ndarray:
    """Dereverberate a multichannel STFT: (T, F, M) complex -> (T, F, M).

    ``diag_load`` scales a trace-relative Tikhonov term on R (the tap
    correlation matrix is near-singular when T is short or sources are few).
    """
    X = np.asarray(X)
    T, F, M = X.shape
    Xd = delayed_taps(X, taps, delay)  # (T, F, MK)
    MK = M * taps
    eye = np.eye(MK)
    Y = X.copy()
    for _ in range(n_iter):
        lam = np.mean(np.abs(Y) ** 2, axis=2)  # (T, F)
        lam = np.maximum(lam, _EPS * np.maximum(np.mean(lam), 1e-300))
        Xw = Xd / lam[:, :, None]
        R = np.einsum("tfa,tfb->fab", Xw, np.conj(Xd))
        P = np.einsum("tfa,tfm->fam", Xw, np.conj(X))
        tr = np.trace(R, axis1=1, axis2=2).real / MK  # (F,)
        R = R + (diag_load * np.maximum(tr, 1e-300))[:, None, None] * eye
        G = np.linalg.solve(R, P)  # (F, MK, M)
        Y = X - np.einsum("fam,tfa->tfm", np.conj(G), Xd)
    return Y
