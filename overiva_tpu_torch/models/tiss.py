"""T-ISS: joint dereverberation + separation by iterative source steering.

Counterpart of ``overiva_tpu/models/tiss.py`` (oracle twin
``oracle/tiss.py``, derivation there). The demixing P (F, M, M + M*taps)
acts on the augmented input ``Xt = [X | delayed_taps(X)]`` (T, F, MJ).
Per epoch:

- the M source-steering steps of the ISS epoch (the same code,
  ``ops/iss_steps.py::iss_steps``: one launch of the ``iss_steps`` kernel
  where its ``kernel_route`` holds), applied to the augmented rows of P;
- the MK = M*taps tap-steering steps against the delayed observations
  z_j = Xt[:, :, M + j]: weighted least squares, no self term
  (``ops/tap_steps.py``). The loop carries Y only, and the tap block of P
  is updated once from the stacked coefficients (the JAX scan's rounding
  order). Where ``ops/tap_steps.py::kernel_route`` holds (CUDA,
  complex64, M, MK and T within the kernel's limits) the MK steps are one
  launch of the ``tap_steps`` kernel; every other input runs the plain
  steps.

``n_src < M`` adds the phi = 1 background outputs, as OverIVA-ISS. At
taps = 0 an epoch is the ISS epoch exactly. Folded mixtures (``n_mix``,
``models/overiva.py::fold_mixtures``) each get their own activations.
Each epoch is a ``family.epoch`` span (``index``, ``bins``, ``taps`` =
MK), its source steps a ``tiss.sources`` span (``steps`` = M, ``bins``,
``frames``, ``outputs`` = M, ``width`` = M + MK, ``kernel``: 1 where the
steps ran the ``iss_steps`` kernel) and its tap steps a ``tiss.taps`` span
(``steps`` = MK, ``bins``, ``frames``, ``outputs`` = M, ``kernel``: 1 where
the steps ran the ``tap_steps`` kernel).
"""

from __future__ import annotations

import torch

from ..ops.iss_steps import iss_steps, steps_route
from ..ops.tap_steps import kernel_route, tap_steps, tap_steps_reference
from ..ops.wpe import delayed_taps
from ..utils.profiling import span
from .auxiva_iss import iss_phi
from .overiva import demix

__all__ = ["augment_taps", "augmented_eye", "tap_steps", "tiss_iterations"]


def augment_taps(X, taps: int, delay: int):
    """(..., T, F, M) -> (..., T, F, M + M*taps) augmented input."""
    if taps == 0:
        return X
    return torch.cat([X, delayed_taps(X, taps, delay)], dim=-1)


def augmented_eye(Xt, n_chan: int):
    """Identity-started augmented demixing (F, n_chan, MJ) for Xt (T, F,
    MJ): the instantaneous block is I, the tap block zero."""
    P = Xt.new_zeros((Xt.shape[1], n_chan, Xt.shape[2]))
    P[:, :, :n_chan] = torch.eye(n_chan, dtype=Xt.dtype, device=Xt.device)
    return P


def _tiss_epoch(Xt, P, Y, model: str, n_chan: int, n_src=None, n_mix: int = 1, group=None,
                n_freq=None, bin_mask=None):
    """One T-ISS epoch. Xt: (T, B*F, MJ); P: (B*F, M, MJ); Y: (T, B*F, M).
    ``group``, ``n_freq``, ``bin_mask``: bin sharding; the tap steps are
    bin-local, so the power psum of :func:`iss_phi` stays the one
    collective. Returns the new (P, Y)."""
    phi = iss_phi(Y, model, n_src, n_mix, group, n_freq, bin_mask)
    T, BF, M = Y.shape
    route = steps_route(P, Y)
    with span("tiss.sources", steps=M, bins=BF, frames=T, outputs=M, width=P.shape[2],
              kernel=int(route)):
        P, Y = iss_steps(P, Y, phi, n_mix, route)
    if Xt.shape[2] > n_chan:
        MK = Xt.shape[2] - n_chan
        route = kernel_route(Y.device.type, Y.dtype, M, MK, T)
        steps = tap_steps if route else tap_steps_reference
        with span("tiss.taps", steps=MK, bins=BF, frames=T, outputs=M, kernel=int(route)):
            P, Y = steps(P, Y, Xt[:, :, n_chan:], phi, n_mix)
    return P, Y


def tiss_iterations(Xt, P, n_iter: int, model: str, n_chan: int, n_src=None, Y=None,
                    n_mix: int = 1):
    """Run ``n_iter`` T-ISS epochs on the augmented input Xt (T, F, MJ) from
    P (F, M, MJ). ``Y`` resumes a run (default: demix Xt by P). Returns
    (P, Y) with the full M-output state; overdetermined callers take
    ``Y[:, :, :n_src]``."""
    if Y is None:
        Y = demix(Xt, P)
    for i in range(n_iter):
        with span("family.epoch", index=i, bins=Xt.shape[1], taps=Xt.shape[2] - n_chan):
            P, Y = _tiss_epoch(Xt, P, Y, model, n_chan, n_src, n_mix)
    return P, Y
