"""OGIVE single-source extraction on tensors, with the early exit decided
on the device.

Counterpart of ``overiva_tpu/models/ogive.py`` (oracle twin
``oracle/ogive.py``): thousands of cheap gradient steps on the demixing
vector w (``update="demix"``), the mixing vector a (``"mix"``) or a
per-bin choice between the two refreshed every ``switch_every`` epochs
(``"switching"``), each followed by the orthogonal-constraint coupling of
w and a. The run stops once ``step_size * max_f ||step|| / ||w|| < tol``.

The JAX package runs the epochs in one on-device ``while_loop``. Here the
epochs run in fixed chunks of :data:`CHUNK`: every epoch freezes a
finished state with ``torch.where(done, old, new)`` (the JAX body's own
freeze), ``epoch`` and ``done`` stay device tensors, and the host reads
``done`` once per chunk. That gives the ``while_loop``'s trajectory and
epoch count, at the cost of at most one chunk of frozen epochs. Folded
mixtures (``n_mix``) each have their own convergence maximum, ``done``
and epoch count.
"""

from __future__ import annotations

import torch

from ..ops.covariance import covariance
from ..ops.linalg import align_eigvec_phase, eigh, matvec, small_inv
from ..parallel.collectives import pmax
from .overiva import mixture_activations

__all__ = ["CHUNK", "ogive_demix", "ogive_init", "ogive_iterations"]

CHUNK = 32  # epochs between two host reads of `done`


def _oc_a_from_w(w, Cx):
    """Mixing vector from demixing vector: a = Cx w / (w^H Cx w)."""
    v = matvec(Cx, w)
    return v / torch.sum(w.conj() * v, dim=1).real[:, None]


def _oc_w_from_a(a, Cx_inv):
    """Demixing vector from mixing vector: w = Cx^-1 a / (a^H Cx^-1 a)."""
    v = matvec(Cx_inv, a)
    return v / torch.sum(a.conj() * v, dim=1).real[:, None]


def _switch_mask(a, Cx, Cx_inv):
    """The bins that take the mixing-vector update: those where the MPDR
    power 1 / (a^H Cx^-1 a) exceeds the mean channel power."""
    M = Cx.shape[1]
    sigma_s2 = 1.0 / torch.sum(a.conj()[:, :, None] * Cx_inv * a[:, None, :], dim=(1, 2)).real
    mean_pow = torch.diagonal(Cx, dim1=1, dim2=2).sum(dim=1).real / M
    return sigma_s2 > mean_pow


def ogive_init(X, init_eig: bool):
    """Initial (w, a, Cx, Cx_inv); w: (F, M) demixing vectors, e_0 or the
    principal component."""
    T, F, M = X.shape
    Cx = covariance(X)
    Cx_inv = small_inv(Cx)
    if init_eig:
        _, vecs = eigh(Cx)
        w = align_eigvec_phase(vecs[:, :, -1:])[:, :, 0].conj()
    else:
        w = torch.zeros((F, M), dtype=X.dtype, device=X.device)
        w[:, 0] = 1.0
    return w, _oc_a_from_w(w, Cx), Cx, Cx_inv


def ogive_demix(X, w):
    """y[t,f] = w[f]^H x[t,f]."""
    return torch.einsum("fm,tfm->tf", w.conj(), X)


def _norm(v):
    return torch.sqrt(torch.sum(v.abs() ** 2, dim=1))


def _epoch(X, w, a, use_mix, Cx, Cx_inv, epoch, done, mu, tol, model, update,
           switch_every, n_mix, group=None, n_freq=None, bin_mask=None):
    """One epoch for every folded mixture; finished mixtures stay frozen.
    Bin-sharded, the power is psum'd and the convergence maximum pmax'd
    over ``group``, padded bins masked out of both."""
    T, BF, _ = X.shape
    F = BF // n_mix

    def bins(t):  # per mixture (B,) -> per bin (B*F,)
        return t[:, None].expand(n_mix, F).reshape(BF)

    if update == "switching":
        refresh = bins((epoch % switch_every == 0) & ~done)
        use_mix = torch.where(refresh, _switch_mask(a, Cx, Cx_inv), use_mix)
    y = ogive_demix(X, w)  # (T, B*F)
    phi = mixture_activations(y[:, :, None], model, n_mix, group, n_freq,
                              bin_mask)[:, :, 0]  # (T, B)
    wy = phi[:, :, None].expand(T, n_mix, F).reshape(T, BF).to(y.real.dtype) * y.conj()
    xi = torch.einsum("tf,tfm->fm", wy, X) / T
    nu = torch.clamp_min(torch.sum(wy * y, dim=0).real / T, 1e-30)
    resid = a - xi / nu[:, None]
    if update == "demix":
        w_new = w + mu * resid
        a_new = _oc_a_from_w(w_new, Cx)
        step = _norm(resid)
    elif update == "mix":
        delta_a = matvec(Cx_inv, resid)
        a_new = a + mu * delta_a
        w_new = _oc_w_from_a(a_new, Cx_inv)
        step = _norm(delta_a)
    else:  # switching
        delta_a = matvec(Cx_inv, resid)
        w_d = w + mu * resid
        a_d = _oc_a_from_w(w_d, Cx)
        a_m = a + mu * delta_a
        w_m = _oc_w_from_a(a_m, Cx_inv)
        w_new = torch.where(use_mix[:, None], w_m, w_d)
        a_new = torch.where(use_mix[:, None], a_m, a_d)
        step = torch.where(use_mix, _norm(delta_a), _norm(resid))
    rel_f = (step / torch.clamp_min(_norm(w_new), 1e-30)).reshape(n_mix, F)
    if bin_mask is not None:
        rel_f = rel_f * bin_mask.to(rel_f.dtype)
    rel = pmax(torch.amax(rel_f, dim=1), group)  # (B,)
    keep = bins(done)[:, None]
    w_new = torch.where(keep, w, w_new)
    a_new = torch.where(keep, a, a_new)
    epoch = torch.where(done, epoch, epoch + 1)
    return w_new, a_new, use_mix, epoch, done | (mu * rel < tol)


def ogive_iterations(X, w, a, use_mix, Cx, Cx_inv, epoch, done, step_size, tol,
                     n_iter: int, model: str, update: str, switch_every: int = 10,
                     n_mix: int = 1, group=None, n_freq=None, bin_mask=None):
    """Run up to ``n_iter`` more epochs, stopping each mixture once
    ``step_size * max_f ||step|| / ||w|| < tol``.

    X: (T, F, M) with ``n_mix`` folded mixtures; w, a: (F, M); use_mix:
    (F,) bool; epoch (int) and done (bool): scalars or one per mixture;
    step_size and tol: 0-dim tensors of the real dtype, so that the test
    rounds as the JAX package's does. Returns (w, a, use_mix, epoch, done),
    epoch and done one per mixture: pass them back in to resume. The host
    reads ``done`` once every :data:`CHUNK` epochs (counted in
    ``ogive_iterations.done_reads``) and never otherwise.

    ``group``, ``n_freq``, ``bin_mask``: bin sharding, one power psum and
    one pmax of the criterion an epoch. Every rank of ``group`` then reads
    the same ``done`` and stops at the same epoch.
    """
    epoch = epoch.reshape(n_mix)
    done = done.reshape(n_mix)
    remaining = int(n_iter)
    while remaining > 0:
        steps = min(CHUNK, remaining)
        for _ in range(steps):
            w, a, use_mix, epoch, done = _epoch(
                X, w, a, use_mix, Cx, Cx_inv, epoch, done, step_size, tol, model,
                update, switch_every, n_mix, group, n_freq, bin_mask,
            )
        remaining -= steps
        ogive_iterations.done_reads += 1
        if bool(done.all()):
            break
    return w, a, use_mix, epoch, done


ogive_iterations.done_reads = 0
