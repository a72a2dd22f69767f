"""Filter and state checkpointing: the port's copy of
``overiva_tpu/utils/checkpoint.py``, with the same npz layout, so a file
written by either package loads in the other.

``save_filters``/``load_filters`` persist demixing filters (the batch
``(return_filters=True, W0=)`` pair) with JSON metadata; ``save_state``/
``load_state`` a flat dict of host arrays, complex ones split into
``<k>__re``/``<k>__im`` planes, with the metadata under ``__meta__``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

__all__ = ["save_filters", "load_filters", "save_state", "load_state"]


def save_filters(path, W, **meta) -> Path:
    """Save demixing filters W (any complex/real ndarray) + JSON metadata."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    W = np.asarray(W)
    np.savez(
        path,
        W_real=np.real(W),
        W_imag=np.imag(W),
        meta=json.dumps(meta),
    )
    # np.savez appends .npz when missing
    return path if path.suffix == ".npz" else Path(str(path) + ".npz")


def load_filters(path):
    """Returns (W, meta dict). W reconstructed as complex."""
    with np.load(path, allow_pickle=False) as z:
        W = z["W_real"] + 1j * z["W_imag"]
        meta = json.loads(str(z["meta"]))
    return W, meta


def save_state(path, state, **meta) -> Path:
    """Save a flat dict of HOST ndarrays (complex ones split into
    ``<k>__re``/``<k>__im`` planes) + JSON metadata. For streaming-class
    state use ``OnlineAuxIVAISS.save`` / ``OnlineWPE.save``, which copy
    the device state to the host first."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {}
    for k, v in state.items():
        v = np.asarray(v)
        if "__" in k:
            raise ValueError(f"state key {k!r} may not contain '__'")
        if np.iscomplexobj(v):
            arrays[k + "__re"] = np.real(v)
            arrays[k + "__im"] = np.imag(v)
        else:
            arrays[k] = v
    np.savez(path, __meta__=json.dumps(meta), **arrays)
    return path if path.suffix == ".npz" else Path(str(path) + ".npz")


def load_state(path):
    """Returns (state dict with complex planes re-merged, meta dict)."""
    state, meta = {}, {}
    with np.load(path, allow_pickle=False) as z:
        for k in z.files:
            if k == "__meta__":
                meta = json.loads(str(z[k]))
            elif k.endswith("__re"):
                state[k[:-4]] = z[k] + 1j * z[k[:-2] + "im"]
            elif k.endswith("__im"):
                pass
            else:
                state[k] = z[k]
    return state, meta
