"""OverIVA / AuxIVA iterative projection on tensors.

Counterpart of ``overiva_tpu/models/overiva.py``. The demixing matrix per
bin is W_hat = [[W1], [J, -I]] with N target rows W1 and the orthogonal
constraint (OC) background block; each epoch updates the N target rows in
order by iterative projection (IP) and re-imposes the OC after each one.

Runs eagerly: a Python loop over epochs and sources, every per-bin step
batched over the F bins. The update keeps the JAX epoch's guards:
``clamp_pow2`` on the solve outputs, the ``quad_form`` keep-previous-row
mask, and the dead-bin zeroing inside ``gauss_solve``.
"""

from __future__ import annotations

import torch

from ..ops.covariance import covariance, weighted_covariance_mixtures
from ..ops.linalg import align_eigvec_phase, clamp_pow2, eigh, gauss_solve, mat_h
from ..ops.update_rows import ip_rows, kernel_route, update_rows
from ..ops.wcov_packed import pack_planes, wcov_packed
from ..parallel.collectives import psum
from ..utils.profiling import span
from .source_models import activations_from_power, power

__all__ = [
    "demix", "epoch_covariances", "fold_mixtures", "init_w_hat",
    "mixture_activations", "overiva_iterations",
    "prepare", "unfold_mixtures",
]


def demix(X, W1):
    """Y[t,f,n] = sum_m W1[f,n,m] X[t,f,m]."""
    return torch.einsum("fnm,tfm->tfn", W1, X)


def _update_J(W_hat, Cx, n_src: int):
    """Re-impose the OC: J = solve(tmp[:, :, :N], tmp[:, :, N:])^H with
    tmp = W1 @ Cx. Returns a new W_hat."""
    N = n_src
    tmp = W_hat[:, :N, :] @ Cx  # (F, N, M)
    # clamp: a singular OC system gives a huge J -> f32 overflow later
    J_H = clamp_pow2(gauss_solve(tmp[:, :, :N], tmp[:, :, N:]))
    W_hat = W_hat.clone()
    W_hat[:, N:, :N] = mat_h(J_H)
    return W_hat


def init_w_hat(X, n_src: int, init_eig: bool, Cx=None, W0=None, dtype=None):
    """Initial W_hat (F, M, M): identity target rows (or W0's rows, or the
    conjugated top-N eigenvectors of Cx with ``init_eig``), the [J, -I]
    background block, and the OC imposed once."""
    T, F, M = X.shape
    N = n_src
    dtype = dtype or X.dtype
    W_hat = torch.eye(M, dtype=dtype, device=X.device).repeat(F, 1, 1)
    if N < M:
        W_hat[:, N:, N:] = -torch.eye(M - N, dtype=dtype, device=X.device)
    if W0 is not None:
        W_hat[:, :N, :] = W0[:, :N, :] if W0.shape[1] == M else W0
    elif init_eig:
        if Cx is None:
            Cx = covariance(X)
        _, vecs = eigh(Cx)  # ascending
        top = align_eigvec_phase(vecs.flip(-1)[:, :, :N])  # (F, M, N)
        W_hat[:, :N, :] = mat_h(top)
    if N < M:
        if Cx is None:
            Cx = covariance(X)
        W_hat = _update_J(W_hat, Cx, N)
    return W_hat


def fold_mixtures(Xb):
    """A batch of mixtures (B, T, F, M) folded into the bin axis, (T, B*F, M):
    mixture b holds bins b*F .. b*F + F - 1, so every per-bin step runs
    over the B*F bins in one batched call."""
    B, T, F, M = Xb.shape
    return Xb.transpose(0, 1).reshape(T, B * F, M)


def unfold_mixtures(Y, n_mix: int):
    """(T, B*F, K) -> (B, T, F, K): the inverse of :func:`fold_mixtures`."""
    T, BF, K = Y.shape
    return Y.reshape(T, n_mix, BF // n_mix, K).transpose(0, 1)


def mixture_activations(Y, model: str, n_mix: int = 1, group=None, n_freq=None,
                        bin_mask=None):
    """phi (T, B, K) of the outputs Y (T, B*F, K) of ``n_mix`` folded
    mixtures: the power sums over each mixture's own F bins.

    Bin-sharded (``overiva_tpu_torch/parallel/sharded.py``): F is the
    rank's slice, the power is psum'd over ``group`` (the one collective
    of an epoch), ``n_freq`` is the global bin count (the gauss model
    divides by it) and ``bin_mask`` (F,) zeroes the padded bins."""
    T, BF, K = Y.shape
    F = BF // n_mix
    pw = psum(power(Y.reshape(T, n_mix, F, K), bin_mask), group)
    _, phi = activations_from_power(pw, n_freq or F, model)
    return phi


def epoch_covariances(X, W_hat, n_src: int, model: str, wcov: str = "f32",
                      chunk_frames=None, xpack=None, n_mix: int = 1, group=None,
                      n_freq=None, bin_mask=None):
    """The start of an IP epoch: demix, activations, then all N weighted
    covariances (N, B*F, M, M) in one pass over X. ``xpack``: the bf16
    planes of X for ``bf16pack``, packed once per run by the caller. With
    ``n_mix`` > 1 folded mixtures (the batch forms, which have no ``wcov``)
    each one's phi weights its own bins in the f32 tier. ``group``,
    ``n_freq``, ``bin_mask``: bin sharding, as in
    :func:`mixture_activations`."""
    T = X.shape[0]
    phi = mixture_activations(demix(X, W_hat[:, :n_src, :]), model, n_mix, group, n_freq,
                              bin_mask)
    if n_mix == 1 and xpack is not None:
        return wcov_packed(xpack, phi[:, 0], T).to(X.dtype)
    return weighted_covariance_mixtures(X, phi, wcov, chunk_frames)


def _epoch(X, W_hat, Cx, n_src: int, model: str, chunk_frames=None,
           wcov: str = "f32", xpack=None, n_mix: int = 1, group=None, n_freq=None,
           bin_mask=None):
    """One epoch: activations from the current outputs, then the N IP row
    updates in order. Returns the new W_hat. ``group``, ``n_freq``,
    ``bin_mask``: bin sharding (:func:`mixture_activations`)."""
    # all N weighted covariances up front: they depend only on the
    # epoch-start phi, so one pass over X serves every source
    Vs = epoch_covariances(X, W_hat, n_src, model, wcov, chunk_frames, xpack, n_mix,
                           group, n_freq, bin_mask)
    return ip_rows(W_hat, Vs, Cx, n_src)


def _fused_epoch(X, W_hat, Cx, n_src: int, model: str, n_mix: int = 1):
    """One epoch through the fused update kernel: demix -> power -> phi in
    plain ops, as :func:`_epoch` has them, then :func:`update_rows` over
    all bins (the composition of ``overiva_tpu/ops/pallas_epoch.py:11-17``),
    each of the ``n_mix`` folded mixtures weighting its own bins. The f32
    tier of :func:`_epoch`; on a CUDA device X, W_hat and Cx must be
    complex64 and contiguous. Returns the new W_hat."""
    phi = mixture_activations(demix(X, W_hat[:, :n_src, :]), model, n_mix)  # (T, B, N)
    return update_rows(phi, X, Cx, W_hat, n_src)


def overiva_iterations(X, W_hat, Cx, n_src: int, n_iter: int, model: str,
                       chunk_frames=None, wcov: str = "f32", n_mix: int = 1):
    """Run ``n_iter`` epochs. X: (T,F,M); W_hat, Cx: (F,M,M); F covers
    ``n_mix`` folded mixtures.

    Where :func:`~overiva_tpu_torch.ops.update_rows.kernel_route` holds (a
    CUDA complex64 X of the exact-f32 tier), each epoch is
    :func:`_fused_epoch`: one launch of the ``update_rows`` kernel after the
    activations (``chunk_frames`` only bounds the eager weighted
    temporary, which the kernel does not have). Every other run takes the
    eager :func:`_epoch`. ``wcov="bf16pack"`` packs the bf16 planes of X
    once here (X is the same every epoch) and each epoch's weighted
    covariances run the packed kernel on them."""
    fused = kernel_route(X.device.type, X.dtype, wcov, X.shape[2])
    if fused:  # the kernel reads dense tensors
        X, Cx, W_hat = X.contiguous(), Cx.contiguous(), W_hat.contiguous()
    xpack = pack_planes(X) if wcov == "bf16pack" else None
    for i in range(n_iter):
        with span("family.epoch", index=i, bins=X.shape[1], kernel=int(fused)):
            if fused:
                W_hat = _fused_epoch(X, W_hat, Cx, n_src, model, n_mix)
            else:
                W_hat = _epoch(X, W_hat, Cx, n_src, model, chunk_frames, wcov, xpack, n_mix)
    return W_hat


def prepare(X, n_src: int, init_eig: bool, W0=None):
    """(W_hat, Cx) to start a run from. Cx is zeros where nothing reads it
    (AuxIVA without eig init)."""
    T, F, M = X.shape
    if n_src < M or init_eig:
        Cx = covariance(X)
    else:
        Cx = torch.zeros((F, M, M), dtype=X.dtype, device=X.device)
    return init_w_hat(X, n_src, init_eig, Cx=Cx, W0=W0), Cx
