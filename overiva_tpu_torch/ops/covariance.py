"""Plain and weighted covariances — the IP epoch's dominant quantity.

Counterpart of ``overiva_tpu/ops/covariance.py``:
V_k[f] = (1/T) sum_t phi[t,k] x[t,f] x[t,f]^H, F-batched over bins.

Tiers of ``wcov``:

- ``"f32"``: exact products in the working dtype (TF32 is off on CUDA).
- ``"bf16"``: bf16 operands (x, phi and their product), f32 accumulation.
- ``"bf16pack"``: the same numerics through the packed kernel
  (``ops/wcov_packed.py``); the only tier with a hand-written CUDA kernel.
- ``"f32x3"``: the JAX package's middle tier (``lax.Precision.HIGH``, three
  bf16 MXU passes, about 1e-5 relative on the TPU). Here it is the exact
  f32 tier: TF32 is off and full f32 is the card's plain path, so it is at
  least as accurate as the TPU tier it stands for.
"""

from __future__ import annotations

import torch

WCOV_MODES = ("f32", "f32x3", "bf16", "bf16pack")

__all__ = [
    "WCOV_MODES",
    "check_tf_wcov",
    "check_wcov",
    "covariance",
    "weighted_covariance_all",
    "weighted_covariance_chunked",
    "weighted_covariance_mixtures",
    "weighted_covariance_tf",
]


def covariance(X):
    """Cx[f] = (1/T) sum_t x x^H. X: (T, F, M) -> (F, M, M)."""
    return torch.einsum("tfm,tfn->fmn", X, X.conj()) / X.shape[0]


def _bf16_contract(X, w, spec):
    """(sum over t of bf16(w x) conj(x)) in f32 real planes, cast to X's dtype.

    ``w`` broadcasts against X's real planes; ``spec`` is the einsum that
    contracts the weighted planes with the plain ones over frames."""
    xr, xi = X.real.to(torch.bfloat16), X.imag.to(torch.bfloat16)
    w = w.to(torch.bfloat16)
    wr, wi = (xr * w).float(), (xi * w).float()
    xr, xi = xr.float(), xi.float()

    def mm(a, b):
        return torch.einsum(spec, a, b)

    # (a + ib)(c - id) expanded in real planes
    return torch.complex(mm(wr, xr) + mm(wi, xi), mm(wi, xr) - mm(wr, xi)).to(X.dtype)


def weighted_covariance_all(X, phi, wcov: str = "f32", chunk=None):
    """All sources' weighted covariances in one pass over X.

    X: (T, F, M), phi: (T, K) -> (K, F, M, M). ``chunk`` accumulates over
    frame blocks of that size (zero-weight padding for a ragged tail), which
    bounds the (K, chunk, F, M) weighted temporary at the same result.
    """
    T = X.shape[0]
    if wcov == "f32x3":
        wcov = "f32"
    if wcov == "bf16pack" and chunk and chunk < T:
        # the packed kernel exists to avoid the weighted temporary; a
        # chunked form would re-pack X per block
        raise ValueError(
            "wcov='bf16pack' has no chunked form — drop chunk_frames or "
            "use wcov='bf16'"
        )
    if chunk and chunk < T:
        pad = -T % chunk
        if pad:
            X = torch.cat([X, X.new_zeros((pad, *X.shape[1:]))])
            phi = torch.cat([phi, phi.new_zeros((pad, phi.shape[1]))])
        V = 0
        for t0 in range(0, X.shape[0], chunk):
            xb, pb = X[t0 : t0 + chunk], phi[t0 : t0 + chunk]
            V = V + weighted_covariance_all(xb, pb, wcov) * chunk
        return V / T
    if wcov == "bf16pack":
        from .wcov_packed import pack_planes, wcov_packed

        return wcov_packed(pack_planes(X), phi, T).to(X.dtype)
    if wcov == "bf16":
        w = phi.t()[:, :, None, None]  # (K, T, 1, 1)
        return _bf16_contract(X, w, "ktfm,tfn->kfmn") / T
    if wcov != "f32":
        raise ValueError(f"wcov must be one of {WCOV_MODES}, got {wcov!r}")
    Xw = X[None] * phi.t()[:, :, None, None].to(X.real.dtype)  # (K, T, F, M)
    return torch.einsum("ktfm,tfn->kfmn", Xw, X.conj()) / T


def weighted_covariance_mixtures(X, phi, wcov: str = "f32", chunk=None):
    """The weighted covariances of B mixtures folded into the bin axis
    (``models/overiva.py::fold_mixtures``), each mixture's bins weighted by
    its own phi. X: (T, B*F, M), phi: (T, B, K) -> (K, B*F, M, M). One
    mixture is :func:`weighted_covariance_all` at ``wcov`` and ``chunk``;
    more take the f32 tier (the batch forms have no ``wcov``)."""
    if phi.shape[1] == 1:
        return weighted_covariance_all(X, phi[:, 0], wcov, chunk=chunk)
    T, BF, M = X.shape
    n_mix, K = phi.shape[1], phi.shape[2]
    Xm = X.reshape(T, n_mix, BF // n_mix, M)
    Xw = Xm[None] * phi.permute(2, 0, 1)[..., None, None].to(X.real.dtype)
    Vs = torch.einsum("ktbfm,tbfn->kbfmn", Xw, Xm.conj()) / T
    return Vs.reshape(K, BF, M, M)


def check_wcov(wcov):
    """Raise ValueError unless ``wcov`` is one of :data:`WCOV_MODES`."""
    if str(wcov) not in WCOV_MODES:
        raise ValueError(f"wcov must be one of {WCOV_MODES}, got {wcov!r}")


def check_tf_wcov(wcov):
    """Raise ValueError unless ``wcov`` is a tier of
    :func:`weighted_covariance_tf` (every tier but ``"bf16pack"``)."""
    check_wcov(wcov)
    if wcov == "bf16pack":
        # the packed kernel only implements the per-source phi weighting of
        # weighted_covariance_all; running exact f32 here would mislabel it
        raise ValueError(
            "wcov='bf16pack' is only available on the overiva/auxiva/ip2 "
            "IP epoch path; use wcov='bf16' for the per-(t,f)-weighted "
            "families"
        )


def weighted_covariance_tf(X, w_tf, wcov: str = "f32"):
    """Per-(t,f) weighted covariance (the ILRMA / FastMNMF families):
    V[f] = (1/T) sum_t w[t,f] x x^H. X: (T, F, M), w_tf: (T, F) -> (F, M, M).
    """
    check_tf_wcov(wcov)
    T = X.shape[0]
    if wcov == "bf16":
        return _bf16_contract(X, w_tf[:, :, None], "tfm,tfn->fmn") / T
    Xw = X * w_tf[:, :, None].to(X.real.dtype)
    return torch.einsum("tfm,tfn->fmn", Xw, X.conj()) / T


def weighted_covariance_chunked(X, phi, chunk: int = 256, wcov: str = "f32"):
    """Frame-chunked single-source weighted covariance, phi: (T,) -> (F, M, M).

    Same result as the dense form; only a (chunk, F, M) weighted
    temporary exists at a time. A ragged tail is padded with phi = 0.
    """
    if wcov == "bf16pack":
        raise ValueError(
            "wcov='bf16pack' has no chunked form — drop chunking or use "
            "wcov='bf16'"
        )
    return weighted_covariance_all(X, phi[:, None], wcov, chunk=chunk)[0]
