"""NumPy oracle for the online (streaming) AuxIVA-ISS separator: the
port's copy of ``overiva_tpu/oracle/online_iss.py``.

Float64 reference of the stream (same state, same block recursion, same
streaming projection back as ``overiva_tpu_torch/models/online_iss.py``),
the anchor that ``chip_smoke.py`` holds the port's ``OnlineAuxIVAISS`` to.
The algorithm is an extension beyond the reference repo (PAPERS.md:
arXiv:2209.00937 lineage).
"""

from __future__ import annotations

import numpy as np

from .models import activations

__all__ = ["online_iss_run"]

_EPS = 1e-15


def online_iss_run(
    X: np.ndarray,
    block: int,
    forget: float = 0.97,
    model: str = "laplace",
    n_pass: int = 1,
    pb_forget: float | None = None,
) -> np.ndarray:
    """Stream X (T, F, M) through block-wise online ISS; returns Y (T, F, M).

    Mirrors ``models.online_iss.online_iss_step`` exactly: exponentially-
    forgotten rank-1 steering statistics, a self-scaling diagonal from the
    effective frame count, and streaming projection back vs mic 0. The
    final partial block (T % block frames) is processed as its own block,
    matching a caller that feeds the tail through the same separator.
    """
    T, F, M = X.shape
    X = np.asarray(X, np.complex128)
    lam = float(forget)
    pb_lam = lam if pb_forget is None else float(pb_forget)

    W = np.tile(np.eye(M, dtype=np.complex128), (F, 1, 1))
    num = np.zeros((M, F, M), np.complex128)
    den = np.zeros((M, F, M), np.float64)
    zn = np.zeros((F, M), np.complex128)
    zd = np.zeros((F, M), np.float64)
    t_eff = 0.0

    outs = []
    for s in range(0, T, block):
        Xb = X[s : s + block]
        t_eff = t_eff * lam + Xb.shape[0]

        for _ in range(int(n_pass)):
            Y = np.einsum("fnm,tfm->tfn", W, Xb)
            _, phi = activations(Y, model)  # (B, M)
            for n in range(M):
                yn = Y[:, :, n]
                blk_num = np.einsum("tm,tfm,tf->fm", phi, Y, np.conj(yn))
                blk_den = np.real(
                    np.einsum("tm,tf,tf->fm", phi, yn, np.conj(yn))
                )
                num[n] = lam * num[n] + blk_num
                den[n] = lam * den[n] + blk_den

                v = num[n] / np.maximum(den[n], _EPS)
                dnn = den[n][:, n] / max(t_eff, 1.0)
                vnn = 1.0 - 1.0 / np.sqrt(np.maximum(dnn, _EPS))
                v[:, n] = vnn
                W = W - v[:, :, None] * W[:, n, :][:, None, :]

        Y = np.einsum("fnm,tfm->tfn", W, Xb)
        zn = zn * pb_lam + np.sum(np.conj(Xb[:, :, 0])[:, :, None] * Y, axis=0)
        zd = zd * pb_lam + np.sum(np.abs(Y) ** 2, axis=0)
        z = np.where(zd > 0.0, zn / np.where(zd > 0.0, zd, 1.0), 1.0)
        outs.append(Y * np.conj(z)[None, :, :])

    return np.concatenate(outs, axis=0)
