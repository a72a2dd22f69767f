"""One runner for the IVA families that separate every source: how each one
starts and iterates, written once for every entry point of ``api`` that
runs them (single clip, batch, ``separate`` and ``auxiva_pca``).

- ``"ip"``: iterative projection (``models/overiva.py``), from identity
  target rows (``W0``'s rows, or eigenvectors with ``init_eig``) with the
  OC imposed;
- ``"iss"``: iterative source steering (``models/auxiva_iss.py``), from the
  identity (or ``W0``), carrying (W, Y) across callback chunks;
- ``"ip2"``: pairwise updates (``models/overiva_ip2.py``), started as IP.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from .auxiva_iss import auxiva_iss_iterations
from .overiva import demix, overiva_iterations, prepare
from .overiva_ip2 import overiva_ip2_iterations

__all__ = ["FAMILIES", "chunked", "run_family"]

FAMILIES = ("ip", "iss", "ip2")


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
