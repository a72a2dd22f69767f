"""NumPy oracle AuxIVA-IP2 / OverIVA-IP2 (pairwise joint updates): the port's
copy of ``overiva_tpu/oracle/overiva_ip2.py``, the float64 reference that
``chip_smoke.py`` holds the port to.

Extension beyond the reference repo (which is IP1-only), from the retrieved
literature (PAPERS.md: arXiv:2003.09531 "Faster independent vector
analysis..." / Ono 2018 pairwise updates; arXiv:2003.02458 has the
overdetermined form): per epoch, every pair (i, j) of target rows is
jointly replaced by the EXACT minimizer of the MM surrogate restricted to
that pair. Derivation used here (validated numerically, see
tests/test_ip2.py):

  stationarity puts both new rows in per-source 2-dim subspaces,
      w~_k = P_k h_k,   P_k = (W_hat V_k)^{-1} E_ij   (M, 2),  k in {i, j}
  and reduces the pair problem to a 2x2 one whose solution is
      h_i, h_j = the two generalized eigenvectors v of the pencil
                 G_j v = lam G_i v,   G_k = P_k^H V_k P_k   (2, 2)
      with the SMALLER-lam eigenvector assigned to source i and each h
      normalized so h^H G_k h = 1.

  The assignment convention is pinned by the fixed-point property: starting
  from a converged IP1 solution, the update leaves the rows unchanged up to
  a phase (checked in tests); the opposite assignment is not a valid MM
  step (non-monotone surrogate).

Pairs sweep all (i < j) combinations each epoch — measured 3-5x faster
convergence per epoch than IP1 at M=3..4 (e.g. 25 dB SIR in 3 epochs where
IP1 needs 15). For N < M the orthogonal-constraint background is re-imposed
after every pair, exactly as OverIVA-IP1 re-imposes it per source
(SURVEY.md §2.3.3). N = 1 has no pairs: use ``overiva``/``ogive``.
"""

from __future__ import annotations

import numpy as np

from .models import activations, align_eigvec_phase
from .overiva import _update_J
from .projection import apply_projection_back, projection_back

__all__ = ["overiva_ip2", "auxiva_ip2"]

_EPS_DET = 1e-30


def _gevd_2x2(B, A):
    """Generalized eigenpairs of B v = lam A v for Hermitian (F, 2, 2)
    pencils. Returns (lam (F, 2) ascending, V (F, 2, 2) column vectors).
    Deterministic closed form (mirrored exactly by the JAX twin)."""
    detA = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    detA = np.where(np.abs(detA) < _EPS_DET, _EPS_DET, detA)
    # C = A^{-1} B via the adjugate
    C00 = (A[:, 1, 1] * B[:, 0, 0] - A[:, 0, 1] * B[:, 1, 0]) / detA
    C01 = (A[:, 1, 1] * B[:, 0, 1] - A[:, 0, 1] * B[:, 1, 1]) / detA
    C10 = (-A[:, 1, 0] * B[:, 0, 0] + A[:, 0, 0] * B[:, 1, 0]) / detA
    C11 = (-A[:, 1, 0] * B[:, 0, 1] + A[:, 0, 0] * B[:, 1, 1]) / detA
    tr = C00 + C11
    det = C00 * C11 - C01 * C10
    disc = np.sqrt(tr * tr - 4.0 * det + 0j)
    lam = np.stack([(tr - disc) / 2, (tr + disc) / 2], axis=1)
    lam = np.real(lam)  # Hermitian-definite pencil: real spectrum
    F = A.shape[0]
    V = np.empty((F, 2, 2), A.dtype)
    for idx in range(2):
        l = lam[:, idx]
        v1 = np.stack([C01, l - C00], axis=1)
        v2 = np.stack([l - C11, C10], axis=1)
        use1 = (np.abs(C01) + np.abs(l - C00)) >= (
            np.abs(l - C11) + np.abs(C10)
        )
        V[:, :, idx] = np.where(use1[:, None], v1, v2)
    return lam, V


def _pair_update(W_hat, X, phi, V, i, j):
    """Jointly update target rows i and j of W_hat in place."""
    F, M, _ = W_hat.shape
    E = np.zeros((M, 2), W_hat.dtype)
    E[i, 0] = 1.0
    E[j, 1] = 1.0
    Et = np.broadcast_to(E, (F, M, 2))
    P_i = np.linalg.solve(W_hat @ V[i], Et)  # (F, M, 2)
    P_j = np.linalg.solve(W_hat @ V[j], Et)
    G_i = np.conj(P_i).transpose(0, 2, 1) @ V[i] @ P_i  # (F, 2, 2)
    G_j = np.conj(P_j).transpose(0, 2, 1) @ V[j] @ P_j
    _, Vv = _gevd_2x2(G_j, G_i)

    def _h(v, G):
        s = np.real(np.einsum("fa,fab,fb->f", np.conj(v), G, v))
        return v / np.sqrt(np.maximum(s, 1e-30))[:, None]

    h_i = _h(Vv[:, :, 0], G_i)  # smaller lam -> source i
    h_j = _h(Vv[:, :, 1], G_j)
    W_hat[:, i, :] = np.conj(np.einsum("fma,fa->fm", P_i, h_i))
    W_hat[:, j, :] = np.conj(np.einsum("fma,fa->fm", P_j, h_j))


def overiva_ip2(
    X: np.ndarray,
    n_src: int | None = None,
    n_iter: int = 20,
    proj_back: bool = True,
    W0: np.ndarray | None = None,
    model: str = "laplace",
    init_eig: bool = False,
    return_filters: bool = False,
    callback=None,
    callback_every: int = 10,
):
    """Pairwise-update OverIVA. X: (T, F, M); returns Y (T, F, N) [, W_hat].

    Requires n_src >= 2 (IP2 updates pairs of target rows)."""
    X = np.asarray(X)
    T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if not 2 <= N <= M:
        raise ValueError(f"IP2 needs 2 <= n_src <= n_chan, got {N}")

    Cx = np.einsum("tfm,tfn->fmn", X, np.conj(X)) / T
    W_hat = np.tile(np.eye(M, dtype=X.dtype), (F, 1, 1))
    if N < M:
        W_hat[:, N:, N:] = -np.eye(M - N, dtype=X.dtype)
    if W0 is not None:
        W_hat[:, :N, :] = W0[:, :N, :] if W0.shape[1] == M else W0
    elif init_eig:
        eigval, eigvec = np.linalg.eigh(Cx)
        top = align_eigvec_phase(eigvec[:, :, ::-1][:, :, :N])
        W_hat[:, :N, :] = np.conj(np.swapaxes(top, 1, 2))
    if N < M:
        _update_J(W_hat, Cx, N)

    pairs = [(i, j) for i in range(N) for j in range(i + 1, N)]
    for epoch in range(n_iter):
        Y = np.einsum("fnm,tfm->tfn", W_hat[:, :N, :], X)
        if callback is not None and epoch % callback_every == 0:
            callback(apply_projection_back(Y, X[:, :, 0]))
        r, phi = activations(Y, model)
        V = [
            np.einsum("t,tfm,tfn->fmn", phi[:, k], X, np.conj(X)) / T
            for k in range(N)
        ]
        for (i, j) in pairs:
            _pair_update(W_hat, X, phi, V, i, j)
            if N < M:
                _update_J(W_hat, Cx, N)

    Y = np.einsum("fnm,tfm->tfn", W_hat[:, :N, :], X)
    if proj_back:
        z = projection_back(Y, X[:, :, 0])
        Y = Y * np.conj(z)[None, :, :]
    if return_filters:
        return Y, W_hat
    return Y


def auxiva_ip2(X, n_src=None, **kw):
    """Determined pairwise AuxIVA (n_src must equal n_chan)."""
    X = np.asarray(X)
    M = X.shape[2]
    N = M if n_src is None else int(n_src)
    if N != M:
        raise ValueError("auxiva_ip2 is determined: n_src must equal n_chan")
    return overiva_ip2(X, n_src=M, **kw)
