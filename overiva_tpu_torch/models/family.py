"""One runner for the IVA families that separate every source, and one for
the joint dereverberation families: how each one starts and iterates,
written once for every entry point of ``api`` that runs them (single
clip, batch, ``separate`` and ``auxiva_pca``), and so for every clip the
serving tier runs.

:func:`run_family`:

- ``"ip"``: iterative projection (``models/overiva.py``), from identity
  target rows (``W0``'s rows, or eigenvectors with ``init_eig``) with the
  OC imposed;
- ``"iss"``: iterative source steering (``models/auxiva_iss.py``), from the
  identity (or ``W0``), carrying (W, Y) across callback chunks;
- ``"ip2"``: pairwise updates (``models/overiva_ip2.py``), started as IP.

:func:`run_joint`, on the tap-augmented input ``[X | delayed taps]``:

- ``"tiss"``: T-ISS (``models/tiss.py``), from the augmented identity (or
  ``W0``), carrying (P, Y) across callback chunks;
- ``"tip"``: T-IP (``models/tip.py``), from the same start, after a T-ISS
  warm start when it starts from the identity with taps.

:func:`run_ilrma_t`: ILRMA-T (``models/ilrma_t.py``) from T-ISS's start,
with a given NMF start.
"""

from __future__ import annotations

import torch

from ..utils.convert import as_tensor
from ..utils.profiling import span
from .auxiva_iss import auxiva_iss_iterations
from .ilrma_t import ilrma_t_iterations
from .overiva import demix, overiva_iterations, prepare
from .overiva_ip2 import overiva_ip2_iterations
from .tip import tip_iterations
from .tiss import augment_taps, augmented_eye, tiss_iterations

__all__ = ["FAMILIES", "JOINT", "chunked", "run_family", "run_ilrma_t", "run_joint"]

FAMILIES = ("ip", "iss", "ip2")
JOINT = ("tiss", "tip")


def chunked(run, state, n_iter, callback, callback_every, snapshot):
    """``run(state, steps)`` for ``n_iter`` steps in all. With a callback,
    ``callback(snapshot(state))`` runs before every ``callback_every``
    steps, as the reference does."""
    if callback is None:
        return run(state, int(n_iter))
    done = 0
    while done < n_iter:
        callback(snapshot(state))
        step = min(int(callback_every), int(n_iter) - done)
        state = run(state, step)
        done += step
    return state


def _iss_start(X, n_src: int, W0):
    """Identity W (F, M, M), or ``W0``: (F, M, M), or (F, n_src, M) target
    rows placed into the identity."""
    T, F, M = X.shape
    W = torch.eye(M, dtype=X.dtype, device=X.device).repeat(F, 1, 1)
    if W0 is not None:
        if W0.shape[1] == M:
            return W0.clone()
        W[:, :n_src, :] = W0
    return W


def run_family(X, n_src: int, n_iter: int, model: str, algo: str = "ip",
               init_eig: bool = False, W0=None, wcov: str = "f32",
               chunk_frames=None, n_mix: int = 1, callback=None,
               callback_every: int = 10):
    """Start ``algo`` (one of :data:`FAMILIES`) on X (T, F, M), which holds
    ``n_mix`` folded mixtures, and run ``n_iter`` epochs.

    ``init_eig`` applies to "ip" and "ip2", ``wcov`` to "ip" and "ip2",
    ``chunk_frames`` to "ip". ``callback(Y)`` receives the unscaled outputs
    (T, F, n_src) before every ``callback_every`` epochs.

    Returns (Y (T, F, n_src) unscaled, W (F, M, M))."""
    N = n_src
    if algo == "iss":
        def run(state, steps):  # ISS resumes from (W, Y), never re-demixes
            return auxiva_iss_iterations(X, state[0], steps, model, n_src=N, Y=state[1],
                                         n_mix=n_mix)

        with span("family.start", mats=0):
            W = _iss_start(X, N, W0)
            state = (W, demix(X, W))
        W, Y = chunked(run, state, n_iter, callback, callback_every, lambda s: s[1][:, :, :N])
        return Y[:, :, :N], W
    # mats: the matrices of the batched eigh of the eigenvector start
    with span("family.start", mats=X.shape[1] if init_eig and W0 is None else 0):
        W, Cx = prepare(X, N, bool(init_eig), W0)
    if algo == "ip2":
        def run(W, steps):
            return overiva_ip2_iterations(X, W, Cx, N, steps, model, wcov, n_mix)
    else:
        def run(W, steps):
            return overiva_iterations(X, W, Cx, N, steps, model, chunk_frames, wcov, n_mix)

    W = chunked(run, W, n_iter, callback, callback_every, lambda W: demix(X, W[:, :N, :]))
    return demix(X, W[:, :N, :]), W


def _augmented_w0(W0, F, M, N, taps, dtype, device):
    """A user W0 -> the augmented stack (F, M, M + M*taps) of ``dtype``: a
    previous full augmented P, a square (F, M, M) stack (zero tap block),
    or (F, N, M) target rows placed into the identity. The row count is
    tested first: at taps=0 the full-augmented and square widths
    coincide."""
    W0 = as_tensor(W0, dtype, device)
    MJ = M + M * taps
    if W0.shape[1] != M:  # (F, N, M) target rows into the identity
        P0 = torch.zeros((F, M, MJ), dtype=dtype, device=device)
        P0[:, :, :M] = torch.eye(M, dtype=dtype, device=device)
        P0[:, :N, :M] = W0
    elif W0.shape[2] == MJ:  # full augmented (== square at taps=0)
        P0 = W0.clone()
    else:  # square (F, M, M), zero tap block
        P0 = torch.zeros((F, M, MJ), dtype=dtype, device=device)
        P0[:, :, :M] = W0
    return P0


def _joint_start(X, n_src: int, taps: int, delay: int, W0):
    """The joint families' start on X (T, F, M): the input with ``taps``
    delayed copies appended, Xt (T, F, M + M*taps), and the augmented
    identity, or ``W0`` made the augmented stack (:func:`_augmented_w0`).
    Returns (Xt, P)."""
    F, M = X.shape[1:]
    Xt = augment_taps(X, taps, delay)
    if W0 is None:
        return Xt, augmented_eye(Xt, M)
    return Xt, _augmented_w0(W0, F, M, n_src, taps, X.dtype, X.device)


def run_joint(X, n_src: int, n_iter: int, model: str, algo: str = "tiss", taps: int = 5,
              delay: int = 2, warm_iter: int = 0, wcov: str = "f32", W0=None,
              n_mix: int = 1, callback=None, callback_every: int = 10):
    """Start ``algo`` (one of :data:`JOINT`) on X (T, F, M), which holds
    ``n_mix`` folded mixtures, and run ``n_iter`` epochs.

    The start is one ``family.start`` span: the ``taps`` delayed copies
    appended to X (already folded, so the M + M*taps channel input is made
    once for all mixtures), the augmented identity or ``W0`` (a previous
    augmented P, a square stack or target rows, taken in X's dtype), the
    first demix, and T-IP's ``warm_iter`` T-ISS epochs when it starts from
    the identity with taps. ``wcov`` applies to "tip". ``callback(Y)``
    receives the unscaled outputs (T, F, n_src) before every
    ``callback_every`` epochs.

    Returns (Y (T, F, n_src) unscaled, P (F, M, M + M*taps))."""
    M = X.shape[2]
    N = n_src
    with span("family.start", mats=0):
        Xt, P = _joint_start(X, N, taps, delay, W0)
        warm = algo == "tip" and W0 is None and warm_iter > 0 and taps > 0
        Y = demix(Xt, P) if algo == "tiss" or warm else None
        if warm:
            P, _ = tiss_iterations(Xt, P, int(warm_iter), model, M, N, Y=Y, n_mix=n_mix)
    if algo == "tiss":
        def run(state, steps):  # resumes from (P, Y), never re-demixes
            return tiss_iterations(Xt, state[0], steps, model, M, N, Y=state[1], n_mix=n_mix)

        P, Y = chunked(run, (P, Y), n_iter, callback, callback_every, lambda s: s[1][:, :, :N])
        return Y[:, :, :N], P

    def run(P, steps):
        return tip_iterations(Xt, P, steps, model, M, N, wcov, n_mix)

    P = chunked(run, P, n_iter, callback, callback_every, lambda P: demix(Xt, P[:, :N, :]))
    return demix(Xt, P[:, :N, :]), P


def run_ilrma_t(X, n_iter: int, B, H, taps: int = 5, delay: int = 2, W0=None, frames=None,
                callback=None, callback_every: int = 10):
    """ILRMA-T on X (T, F, M), which holds the folded mixtures of the NMF
    start B (nb, M, F / nb, K), H (nb, M, K, T): T-ISS's start in one
    ``family.start`` span (the tap augmentation, the augmented identity or
    ``W0``, the first demix), then ``n_iter`` epochs. ``frames``: each
    mixture's real frame count, its padding at the front
    (``models/ilrma_t.py``), or None. ``callback(Y)`` receives the unscaled
    outputs (T, F, M) before every ``callback_every`` epochs.

    Returns (Y (T, F, M) unscaled, P (F, M, M + M*taps))."""
    M = X.shape[2]
    with span("family.start", mats=0):
        Xt, P = _joint_start(X, M, taps, delay, W0)
        Y = demix(Xt, P)

    def run(state, steps):  # resumes from (P, Y, B, H), never re-demixes
        P, Y, B, H = state
        return ilrma_t_iterations(Xt, P, B, H, steps, M, Y=Y, frames=frames)

    P, Y, _, _ = chunked(run, (P, Y, B, H), n_iter, callback, callback_every, lambda s: s[1])
    return Y, P
