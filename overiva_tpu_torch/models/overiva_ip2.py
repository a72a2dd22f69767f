"""AuxIVA-IP2 / OverIVA-IP2: pairwise joint row updates on tensors.

Counterpart of ``overiva_tpu/models/overiva_ip2.py`` (oracle twin
``oracle/overiva_ip2.py``, which has the derivation), written F-major.
Each epoch sweeps every target pair (i < j): two solves with an (M, 2)
right-hand side give the pair's subspaces P_i, P_j, and a closed-form 2x2
generalized eigenproblem of their Gram matrices gives the new rows. For
n_src < M the orthogonal-constraint background is re-imposed after every
pair.

The guards are those of the JAX epoch: ``clamp_pow2`` on P_i, P_j and on
the OC solve, the ``|det A| < 1e-30`` floor of the GEVD, and the
``quad_form`` keep-previous-rows mask, applied to both rows of the pair
when either Gram matrix is rounding noise.
"""

from __future__ import annotations

import torch

from ..ops.linalg import clamp_pow2, gauss_solve, mat_h, quad_form
from ..ops.wcov_packed import pack_planes
from ..utils.profiling import span
from .overiva import _update_J, epoch_covariances

__all__ = ["overiva_ip2_iterations"]

_EPS_DET = 1e-30


def _gevd_2x2(B, A):
    """Generalized eigenpairs of B v = lam A v for Hermitian (F, 2, 2)
    pencils. Returns (lam (F, 2) ascending, V (F, 2, 2) column
    eigenvectors), by the closed form of the JAX package and the oracle.

    The principal branch of the complex square root is taken; where the
    discriminant is a negative real, its sign of zero only flips the
    imaginary part of ``disc``, which the real part taken for ``lam``
    drops."""
    detA = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    detA = torch.where(detA.abs() < _EPS_DET, torch.full_like(detA, _EPS_DET), detA)
    C00 = (A[:, 1, 1] * B[:, 0, 0] - A[:, 0, 1] * B[:, 1, 0]) / detA
    C01 = (A[:, 1, 1] * B[:, 0, 1] - A[:, 0, 1] * B[:, 1, 1]) / detA
    C10 = (-A[:, 1, 0] * B[:, 0, 0] + A[:, 0, 0] * B[:, 1, 0]) / detA
    C11 = (-A[:, 1, 0] * B[:, 0, 1] + A[:, 0, 0] * B[:, 1, 1]) / detA
    tr = C00 + C11
    det = C00 * C11 - C01 * C10
    disc = torch.sqrt(tr * tr - 4.0 * det)
    lam = torch.stack([(tr - disc) / 2, (tr + disc) / 2], dim=1).real

    def vec(l):
        v1 = torch.stack([C01, l - C00], dim=1)  # (F, 2)
        v2 = torch.stack([l - C11, C10], dim=1)
        # ties take v1, as in the JAX package
        use1 = (C01.abs() + (l - C00).abs()) >= ((l - C11).abs() + C10.abs())
        return torch.where(use1[:, None], v1, v2)

    return lam, torch.stack([vec(lam[:, 0]), vec(lam[:, 1])], dim=2)


def _pair_update(W, V_i, V_j, i: int, j: int):
    """Jointly update target rows i and j of W (F, M, M). Returns a new W."""
    F, M, _ = W.shape
    E = torch.zeros((M, 2), dtype=W.dtype, device=W.device)
    E[i, 0] = 1.0
    E[j, 1] = 1.0
    Et = E.expand(F, M, 2)
    # knife-edge bins give a huge P whose Gram P^H V P overflows f32; its
    # per-bin scale cancels through the GEVD and the normalization below
    P_i = clamp_pow2(gauss_solve(W @ V_i, Et))  # (F, M, 2)
    P_j = clamp_pow2(gauss_solve(W @ V_j, Et))
    G_i = mat_h(P_i) @ (V_i @ P_i)  # (F, 2, 2)
    G_j = mat_h(P_j) @ (V_j @ P_j)
    _, Vv = _gevd_2x2(G_j, G_i)

    def _h(v, G):
        s, good = quad_form(v, G)
        return v / torch.sqrt(torch.where(good, s, torch.ones_like(s)))[:, None].to(v.dtype), good

    h_i, good_i = _h(Vv[:, :, 0], G_i)  # the smaller eigenvalue goes to source i
    h_j, good_j = _h(Vv[:, :, 1], G_j)
    # the GEVD couples the pair: if either Gram is rounding noise, both
    # candidate rows are garbage, so both keep their previous values
    good = (good_i & good_j)[:, None]
    row_i = torch.where(good, (P_i @ h_i[:, :, None])[:, :, 0].conj(), W[:, i])
    row_j = torch.where(good, (P_j @ h_j[:, :, None])[:, :, 0].conj(), W[:, j])
    W = W.clone()
    W[:, i] = row_i
    W[:, j] = row_j
    return W


def _ip2_epoch(X, W, Cx, n_src: int, model: str, wcov: str = "f32", xpack=None,
               n_mix: int = 1, group=None, n_freq=None, bin_mask=None):
    """One IP2 epoch: activations, all N weighted covariances in one pass,
    then every pair's joint update (and the OC when n_src < M). ``group``,
    ``n_freq``, ``bin_mask``: bin sharding
    (``models/overiva.py::mixture_activations``)."""
    M = X.shape[2]
    N = n_src
    Vs = epoch_covariances(X, W, N, model, wcov, xpack=xpack, n_mix=n_mix, group=group,
                           n_freq=n_freq, bin_mask=bin_mask)
    for i in range(N):
        for j in range(i + 1, N):
            W = _pair_update(W, Vs[i], Vs[j], i, j)
            if N < M:  # the OC after every pair; the [-I] block never changes
                W = _update_J(W, Cx, N)
    return W


def overiva_ip2_iterations(X, W, Cx, n_src: int, n_iter: int, model: str,
                           wcov: str = "f32", n_mix: int = 1):
    """Run ``n_iter`` IP2 epochs. X: (T, F, M); W, Cx: (F, M, M).

    ``wcov="bf16pack"`` packs the bf16 planes of X once here (the JAX
    package packs them inside every epoch; the numbers are the same) and
    runs the packed kernel once an epoch for all sources."""
    xpack = pack_planes(X) if wcov == "bf16pack" else None
    for i in range(n_iter):
        with span("family.epoch", index=i, bins=X.shape[1]):
            W = _ip2_epoch(X, W, Cx, n_src, model, wcov, xpack, n_mix)
    return W
