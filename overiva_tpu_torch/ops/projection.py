"""Projection back (minimal-distortion rescaling) on tensors.

Counterpart of ``overiva_tpu/ops/projection.py``; same convention as the
oracle (``overiva_tpu/oracle/projection.py``).
"""

from __future__ import annotations

import torch

__all__ = ["projection_back", "apply_projection_back"]


def projection_back(Y, ref):
    """z[f,k] = sum_t conj(ref) Y / sum_t |Y|^2 (1 where the denom is 0).

    Y: (T, F, K) complex; ref: (T, F) complex. Returns z: (F, K)."""
    num = torch.sum(ref.conj()[:, :, None] * Y, dim=0)
    denom = torch.sum(Y.abs() ** 2, dim=0)
    ok = denom > 0.0
    z = num / torch.where(ok, denom, torch.ones_like(denom))
    return torch.where(ok, z, torch.ones_like(z))


def apply_projection_back(Y, ref):
    """Y scaled by conj(z) per (bin, source)."""
    return Y * projection_back(Y, ref).conj()[None, :, :]
