"""The port's entry point: one forward step of the flagship model.

The twin of ``__graft_entry__.py::entry``: ``entry()`` returns ``(fn,
example_args)``, where ``fn(X, W_hat, Cx)`` is one OverIVA epoch
(``models/overiva.py::_epoch``, Laplace model, N=3) at T=128, F=513, M=8
and ``example_args`` are the JAX entry's inputs (``default_rng(0)``: X
from two float32 normals, Cx = X^H X / T per bin, W_hat the identity with
the -I background block) as complex64 tensors on the device. The JAX
entry splits them into float planes for its TPU's host boundary; here
they stay complex.

    from overiva_tpu_torch.entry import entry
    fn, args = entry()          # on CUDA; entry(device="cpu") on the CPU
    W_new = fn(*args)
"""

from __future__ import annotations

import numpy as np

__all__ = ["entry", "example_arrays"]

T, F, M, N = 128, 513, 8, 3


def example_arrays():
    """(X (T, F, M), W_hat (F, M, M), Cx (F, M, M)) complex64 NumPy arrays,
    drawn as ``__graft_entry__.entry`` draws them."""
    rng = np.random.default_rng(0)
    Xre = rng.standard_normal((T, F, M)).astype(np.float32)
    Xim = rng.standard_normal((T, F, M)).astype(np.float32)
    X = (Xre + 1j * Xim).astype(np.complex64)
    Cx = np.einsum("tfm,tfn->fmn", X, np.conj(X)) / T
    W = np.tile(np.eye(M, dtype=np.complex64), (F, 1, 1))
    W[:, N:, N:] = -np.eye(M - N, dtype=np.complex64)
    return X, W, Cx.astype(np.complex64)


def entry(device=None):
    """(fn, example_args): ``fn(X, W_hat, Cx)`` runs one OverIVA epoch and
    returns the new W_hat; ``example_args`` are complex64 tensors on
    ``device`` (default CUDA; without a card pass ``device="cpu"``)."""
    import torch

    from . import resolve_device
    from .models.overiva import _epoch

    dev = resolve_device(device)

    def fn(X, W_hat, Cx):
        return _epoch(X, W_hat, Cx, n_src=N, model="laplace")

    return fn, tuple(torch.from_numpy(a).to(dev) for a in example_arrays())
