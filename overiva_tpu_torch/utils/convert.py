"""Arrays in and out of the port, and state carried across from the JAX
package.

The JAX package hands its state out as NumPy arrays: ``W_hat`` from
``overiva(..., return_filters=True)`` or the IP2 epochs, the ISS state
``(W, Y)``, the FIVE filter ``w``, the OGIVE state ``(w, a, use_mix,
epoch, done)``, the input covariance ``Cx`` and the STFT ``X``.
:func:`state_to_torch` turns such a mapping into tensors on one device,
so the port can continue a run the JAX package started (or start from the
same state); :func:`state_to_numpy` goes back.
:func:`stream_state_to_torch` does the same for a streaming state (what
the JAX streaming classes' ``save`` writes, or ``load_state`` returns),
whose real statistics stay real.
:func:`planes_to_torch` joins the float planes that the JAX package's
Pallas kernels take and return (``Xr, Xi``, ``Wr, Wi``, ...) into one
complex tensor.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "as_tensor", "planes_to_torch", "state_to_numpy", "state_to_torch",
    "stream_state_to_torch", "to_torch_dtype",
]

# the real entries of a streaming state: the online statistics' real sums
# and frame count, and the serving tier's sample tail and overlap-add carry
STREAM_REAL_KEYS = ("den", "zd", "t_eff", "tden", "tail", "carry")

_NP_TO_TORCH = {
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def to_torch_dtype(dtype):
    """A torch dtype from a torch dtype, a NumPy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _NP_TO_TORCH[np.dtype(dtype)]
    except (KeyError, TypeError):
        raise ValueError(f"unsupported dtype {dtype!r}") from None


def as_tensor(x, dtype, device):
    """NumPy array or tensor -> tensor of ``dtype`` (None: keep) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    x = np.asarray(x)
    if not (x.flags.writeable and x.flags.c_contiguous):
        x = x.copy()  # torch wraps only writeable contiguous memory
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def state_to_torch(state, device, dtype=torch.complex64):
    """{name: NumPy array} -> {name: tensor on ``device``}: numbers as
    ``dtype``; flags (``use_mix``, ``done``) stay bool and counters
    (``epoch``) stay integers."""
    dtype = to_torch_dtype(dtype)

    def one(v):
        v = np.asarray(v)
        if v.dtype == np.bool_ or np.issubdtype(v.dtype, np.integer):
            return as_tensor(v, None, device)
        return as_tensor(v, dtype, device)

    return {k: one(v) for k, v in state.items()}


def stream_state_to_torch(state, device, dtype=torch.complex64):
    """{name: NumPy array} of a streaming state -> {name: tensor on
    ``device``}: the keys of ``STREAM_REAL_KEYS`` as the real dtype that
    matches the complex ``dtype``, every other key as ``dtype``. A complex
    array under a real key raises ValueError (its imaginary part would be
    dropped)."""
    dtype = to_torch_dtype(dtype)
    out = {}
    for k, v in state.items():
        v = np.asarray(v)
        if k in STREAM_REAL_KEYS:
            if np.iscomplexobj(v):
                raise ValueError(f"state {k!r} must be real, got {v.dtype}")
            out[k] = as_tensor(v, dtype.to_real(), device)
        else:
            out[k] = as_tensor(v, dtype, device)
    return out


def state_to_numpy(state):
    """{name: tensor} -> {name: NumPy array} (copied to the host)."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def planes_to_torch(re, im, device, dtype=torch.complex64):
    """Real and imaginary NumPy planes -> one complex tensor of ``dtype``."""
    re, im = np.asarray(re), np.asarray(im)
    if re.shape != im.shape:
        raise ValueError(f"plane shapes differ: {re.shape} and {im.shape}")
    return as_tensor(re + 1j * im, to_torch_dtype(dtype), device)
