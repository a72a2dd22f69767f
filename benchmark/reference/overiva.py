"""OverIVA-IP of the reference, with the program's start and projection
back, and the clip pipeline it serves.

Frozen copy of ``overiva_tpu_torch/oracle/overiva.py``,
``overiva_tpu_torch/oracle/projection.py`` and
``overiva_tpu_torch/oracle/models.py::align_eigvec_phase`` (commit
76c639c): identity target rows, or with ``init_eig`` the conjugated top-N
eigenvectors of the input covariance (each with its largest component
real and positive), the background block ``[J, -I]`` with the orthogonal
constraint imposed once before the epochs and after every row update,
then ``n_iter`` epochs of activations followed by the N iterative-
projection row updates in order, and projection back against microphone
0. Departures, none of which changes the mathematics:

- the mixture is held bins-first, (F, M, T), so that demixing and the
  covariances are batched matrix products;
- in float64 the N weighted covariances of an epoch come from one product
  of the (N, T) weights with the frame outer products ``x x^H``, which are
  the same every epoch (the oracle forms each from the same epoch-start
  weights in its loop over sources);
- an :class:`~benchmark.reference.arith.Arith` sets the precision.
"""

from __future__ import annotations

import numpy as np

from .arith import F64, Arith
from .models import activations
from .stft import analysis, stft_pad, synthesis

__all__ = ["overiva", "separate_clip"]


def _h(A):
    return np.conj(np.swapaxes(A, -1, -2))


def _update_J(W_hat, Cx, n_src: int, ar: Arith):
    """Re-impose the orthogonal constraint [J, -I] Cx W1^H = 0:
    J = solve((W1 Cx)[:, :, :N], (W1 Cx)[:, :, N:])^H."""
    N = n_src
    tmp = ar.op(W_hat[:, :N, :]) @ ar.op(Cx)  # (F, N, M)
    J_H = np.linalg.solve(tmp[:, :, :N], tmp[:, :, N:])
    W_hat[:, N:, :N] = _h(J_H)


def _weighted_covariances(Xf, phi, ar: Arith, outer=None):
    """V[k, f] = (1/T) sum_t phi[t, k] x_tf x_tf^H, (N, F, M, M)."""
    F, M, T = Xf.shape
    if outer is not None:  # float64: one product with the outer products
        V = (phi.T @ outer.reshape(T, -1)).reshape(phi.shape[1], F, M, M)
        return V / T
    Xh = ar.op(_h(Xf))
    return np.stack([ar.op(Xf * ar.r(phi[:, k])) @ Xh for k in range(phi.shape[1])]) / T


def _align_eigvec_phase(E):
    """Eigenvectors (F, M, K) with each one's largest component real and
    positive."""
    idx = np.argmax(np.abs(E), axis=1)  # (F, K)
    anchor = np.take_along_axis(E, idx[:, None, :], axis=1)[:, 0, :]
    phase = anchor / np.maximum(np.abs(anchor), 1e-30)
    return E * np.conj(phase)[:, None, :]


def overiva(X: np.ndarray, n_src: int, n_iter: int, model: str = "laplace",
            ar: Arith = F64, init_eig: bool = False) -> np.ndarray:
    """X (T, F, M) -> projected sources Y (T, F, N)."""
    T, F, M = X.shape
    N = int(n_src)
    if not 1 <= N <= M:
        raise ValueError("need 1 <= n_src <= n_chan")
    Xf = np.ascontiguousarray(ar.c(X).transpose(1, 2, 0))  # (F, M, T)
    Cx = ar.op(Xf) @ ar.op(_h(Xf)) / T
    outer = None
    if not ar.tf32:
        outer = np.einsum("fmt,fnt->tfmn", Xf, np.conj(Xf), optimize=True)

    W_hat = np.tile(np.eye(M, dtype=ar.cdtype), (F, 1, 1))
    if N < M:
        W_hat[:, N:, N:] = -np.eye(M - N, dtype=ar.cdtype)
    if init_eig:
        _, vecs = np.linalg.eigh(Cx)  # ascending
        W_hat[:, :N, :] = _h(_align_eigvec_phase(vecs[:, :, ::-1][:, :, :N]))
    if N < M:
        _update_J(W_hat, Cx, N, ar)
    eyes = np.tile(np.eye(M, dtype=ar.cdtype), (F, 1, 1))
    for _ in range(n_iter):
        Y = ar.op(W_hat[:, :N, :]) @ ar.op(Xf)  # (F, N, T)
        _, phi = activations(np.sum(np.abs(Y) ** 2, axis=0).T, F, model)  # (T, N)
        Vs = _weighted_covariances(Xf, phi, ar, outer)
        for k in range(N):
            V = Vs[k]
            WV = ar.op(W_hat) @ ar.op(V)
            w = np.linalg.solve(WV, eyes[:, :, k : k + 1])[:, :, 0]  # (F, M)
            denom = np.einsum("fm,fmn,fn->f", np.conj(w), V, w)
            w = w / np.sqrt(np.real(denom))[:, None]
            W_hat[:, k, :] = np.conj(w)
            if N < M:
                _update_J(W_hat, Cx, N, ar)

    Y = ar.op(W_hat[:, :N, :]) @ ar.op(Xf)  # (F, N, T)
    # projection back against microphone 0: Y *= conj(z), z = sum_t conj(ref) Y / sum_t |Y|^2
    ref = Xf[:, 0, :]
    num = np.sum(np.conj(ref)[:, None, :] * Y, axis=2)
    den = np.sum(np.abs(Y) ** 2, axis=2)
    z = np.ones_like(num)
    np.divide(num, den, out=z, where=den > 0.0)
    return (Y * np.conj(z)[:, :, None]).transpose(2, 0, 1)


def separate_clip(x: np.ndarray, args: dict, ar: Arith = F64) -> np.ndarray:
    """The unpadded clip pipeline of a ``Separator(**args)``, (n_samples, M)
    -> (n_samples, N): ``synthesis(overiva(analysis(stft_pad(x))))``
    trimmed to the clip."""
    nfft = int(args["nfft"])
    hop = int(args.get("hop") or nfft // 2)
    X = analysis(stft_pad(x, nfft, hop), nfft, hop, ar)
    Y = overiva(X, args["n_src"], args["n_iter"], args.get("model", "laplace"), ar,
                bool(args.get("init_eig", False)))
    y = synthesis(Y, nfft, hop, ar)
    front = nfft - hop
    return y[front : front + x.shape[0]]
