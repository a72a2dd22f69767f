"""SparseAuxIVA's reconstruction stage on tensors.

Counterpart of ``overiva_tpu/models/sparseauxiva.py`` (Jansky, Koldovsky,
Ono, IWAENC 2016 lineage; the oracle copy ``oracle/sparseauxiva.py``
carries the design notes). The IP phases on the selected bins and the
full-band polish run through ``models/family.py::run_family``
(``api.sparseauxiva`` wires the phases together); this module holds the
bin selection and the LASSO reconstruction of the other bins:

- :func:`select_bins`: the stratified top-power selection, one bin a band;
- :func:`sparse_rtfs`: the mixing-side RTFs at the measured bins;
- :func:`sparse_rtf_taps`: FISTA for the support-restricted impulse
  responses, two matrix products a step on (M(M-1), P) x (P, k);
- :func:`sparse_reconstruct`: the full-band demixing from the taps.

Each takes a leading batch axis: S differs between mixtures, so each has
its own partial-DFT matrix E and FISTA runs as a batched product.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.linalg import small_inv

__all__ = [
    "dft_angles", "select_bins", "sparse_reconstruct", "sparse_rtf_taps", "sparse_rtfs",
]


def select_bins(X, n_bins: int):
    """Stratified selection for each mixture of X (nb, T, F, M): split the
    spectrum into ``n_bins`` bands and take the highest-power bin of each
    (the oracle's ``select_bins``). The power is summed on X's device; the
    (nb, F) sums come to the host. Returns (nb, k) int64, sorted."""
    F = X.shape[2]
    power = (X.abs() ** 2).sum(dim=(1, 3)).cpu().numpy()
    edges = np.linspace(0, F, min(n_bins, F) + 1).astype(int)
    bands = [(a, b) for a, b in zip(edges[:-1], edges[1:]) if b > a]
    return np.array([sorted(a + int(np.argmax(p[a:b])) for a, b in bands) for p in power])


def sparse_rtfs(Ws):
    """Mixing-side RTFs at the measured bins (unit response at mic 0).

    Ws: (n, M, M) demixing -> (n, M, M), columns the normalized steering."""
    A_s = small_inv(Ws)
    return A_s / A_s[:, :1, :]


def dft_angles(S, nfft: int, n_causal: int, n_acausal: int, rdtype, device):
    """The partial-DFT angles -2 pi (p s mod nfft) / nfft (nb, P, k) for the
    support taps p and the bins S (nb, k). The index product is an exact
    integer mod nfft (in float32 it would pass 2**24 from nfft 8192 on);
    the angle is formed at ``rdtype``, as the JAX package forms it."""
    support = torch.cat([torch.arange(n_causal), torch.arange(nfft - n_acausal, nfft)])
    S_i = torch.as_tensor(S, dtype=torch.int64) % nfft
    prod = (support[None, :, None] * S_i[:, None, :]) % nfft
    ang = torch.tensor(-2.0 * math.pi / nfft, dtype=rdtype) * prod.to(rdtype)
    return ang.to(device)


def sparse_rtf_taps(R_s, S, nfft: int, n_causal: int, n_acausal: int,
                    lasso_iter: int, lam_ratio: float):
    """FISTA LASSO for the support-restricted RTF impulse responses.

    R_s: (nb, k, M, M) RTFs at bins S (nb, k) int. Returns the full-circle
    taps g_full (nb, M(M-1), nfft) real; the rfft of a row is that
    filter's full-band RTF."""
    nb, k, M, _ = R_s.shape
    cdtype = R_s.dtype
    rdtype = R_s.real.dtype
    dev = R_s.device

    ang = dft_angles(S, nfft, n_causal, n_acausal, rdtype, dev)
    E = torch.complex(torch.cos(ang), torch.sin(ang)).to(cdtype)  # (nb, P, k)
    Eh = E.conj().transpose(1, 2)  # (nb, k, P)

    B = R_s[:, :, 1:, :].permute(0, 3, 2, 1).reshape(nb, M * (M - 1), k)

    def AH(r):
        return (r @ Eh).real

    lam = lam_ratio * torch.amax(AH(B).abs(), dim=-1, keepdim=True)
    step = 1.0 / nfft  # rows of the full-circle partial DFT are orthogonal
    thr = step * lam

    # the momentum sequence depends on nothing but the step count: it is
    # formed on the host at the real dtype, as the loop carries it
    rt = np.dtype(np.float32 if rdtype == torch.float32 else np.float64)
    t = rt.type(1.0)
    g = torch.zeros((nb, M * (M - 1), n_causal + n_acausal), dtype=rdtype, device=dev)
    v = g
    for _ in range(lasso_iter):
        u = v - step * AH(v.to(cdtype) @ E - B)
        g_new = torch.sign(u) * torch.clamp_min(u.abs() - thr, 0.0)
        t_new = rt.type(0.5) * (rt.type(1.0) + np.sqrt(rt.type(1.0) + rt.type(4.0) * t * t))
        v = g_new + float((t - rt.type(1.0)) / t_new) * (g_new - g)
        g, t = g_new, t_new

    # the support ranges are contiguous: one concatenate into the circle
    mid = torch.zeros((nb, M * (M - 1), nfft - n_causal - n_acausal), dtype=rdtype, device=dev)
    return torch.cat([g[..., :n_causal], mid, g[..., n_causal:]], dim=-1)


def sparse_reconstruct(Ws, S, F: int, nfft: int, n_causal: int, n_acausal: int,
                       lasso_iter: int, lam_ratio: float):
    """Full-band demixing from IP results on the selected bins.

    Ws: (nb, k, M, M) demixing at bins S (nb, k). Returns W (nb, F, M, M):
    the inverse of the RTF-normalized mixing, the measured bins' RTFs
    verbatim."""
    nb, k, M, _ = Ws.shape
    cdtype = Ws.dtype
    R_s = sparse_rtfs(Ws.reshape(nb * k, M, M)).reshape(nb, k, M, M)
    g_full = sparse_rtf_taps(R_s, S, nfft, n_causal, n_acausal, lasso_iter, lam_ratio)
    R_rec = torch.fft.rfft(g_full, dim=-1).to(cdtype)  # (nb, M(M-1), F)
    A_rec = torch.cat(
        [
            torch.ones((nb, F, 1, M), dtype=cdtype, device=Ws.device),
            R_rec.reshape(nb, M, M - 1, F).permute(0, 3, 2, 1),
        ],
        dim=2,
    )
    S_t = torch.as_tensor(S, dtype=torch.int64, device=Ws.device)
    A_rec[torch.arange(nb, device=Ws.device)[:, None], S_t] = R_s
    return small_inv(A_rec.reshape(nb * F, M, M)).reshape(nb, F, M, M)
