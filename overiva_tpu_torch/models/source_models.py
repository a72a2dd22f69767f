"""Source models: per-frame power and the IP weights phi = 1/r.

Counterpart of ``overiva_tpu/models/source_models.py`` (and the oracle's
``overiva_tpu/oracle/models.py``), with the same floors.
"""

from __future__ import annotations

import torch

EPS = 1e-15
# Relative activation floor r >= REL_EPS * max_t r per source: bounds the
# dynamic range of phi = 1/r so the weighted covariance stays invertible
# (without it the gauss model collapses at M >> N, in f64 too).
REL_EPS = 1e-3
MODELS = ("laplace", "gauss")

__all__ = ["EPS", "REL_EPS", "MODELS", "power", "activations_from_power", "activations"]


def power(Y, bin_mask=None):
    """Per-frame per-source power sum_f |Y|^2. Y: (..., F, N) -> (..., N).

    When the bins are sharded, this is the rank's partial sum, to be
    psum'd over the 'bins' group before :func:`activations_from_power`;
    ``bin_mask`` (F,) zeroes the padded bins' contribution."""
    p = Y.abs() ** 2
    if bin_mask is not None:
        p = p * bin_mask[:, None].to(p.dtype)
    return torch.sum(p, dim=-2)


def activations_from_power(pw, n_freq: int, model: str, eps: float = EPS):
    """r, phi = 1/r from the per-frame power (T, ..., N); the relative
    floor takes the maximum over frames."""
    if model == "laplace":
        r = 2.0 * torch.sqrt(pw)
    elif model == "gauss":
        r = pw / n_freq
    else:
        raise ValueError(f"unknown source model {model!r}")
    r = torch.clamp_min(r, eps)
    r = torch.maximum(r, REL_EPS * torch.amax(r, dim=0, keepdim=True))
    return r, 1.0 / r


def activations(Y, model: str, eps: float = EPS):
    """r, phi = 1/r from the current estimates Y (T, F, N)."""
    return activations_from_power(power(Y), Y.shape[1], model, eps)
