"""The least time the card needs for a piece of work.

The peaks are those of one NVIDIA H100 SXM from NVIDIA's data sheet (dense
rates, no sparsity), which assume the card's full power limit of 700 W: a
share read on a card set below it reads low (the run prints the limit).
``bound``, ``wcov_bound`` and ``update_rows_bound`` are copies of
``chip_smoke.py``'s (commit 76c639c), returning seconds: each input byte is
read once and each output byte written once, whatever a kernel reads
again.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12  # HBM3
F32_FLOPS = 67e12  # float32 outside the tensor cores
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
POWER_LIMIT_W = 700.0  # the limit the peaks assume

__all__ = [
    "BF16_FLOPS", "F32_FLOPS", "HBM_BYTES_S", "POWER_LIMIT_W", "TF32_FLOPS",
    "bound", "update_rows_bound", "update_rows_work", "wcov_bound",
]


def bound(n_bytes, flops, peak_flops):
    """(seconds, what sets it) for work that moves ``n_bytes`` and does
    ``flops`` at ``peak_flops``."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, flops / peak_flops
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def wcov_bound(K, F, m, T):
    """``wcov_packed``: bf16 planes in, phi in, complex64 V out; 8 flops
    per weighted product (exact in f32 for bf16 operands, so the bf16
    tensor-core rate)."""
    n_bytes = 2 * F * m * T * 2 + T * K * 4 + 2 * K * F * m * m * 4
    flops = 8 * K * F * m * m * T + 2 * K * F * m * T
    return bound(n_bytes, flops, BF16_FLOPS)


def update_rows_work(m, n, F, T):
    """(bytes, flops) of the fused per-bin IP update ``update_rows``: X,
    phi, Cx, W in and W out, all in f32. The covariances are Hermitian and
    share x x^H: per bin and frame, each upper-triangle product once (6
    flops off the diagonal, 3 on it), then one real-weighted multiply-add
    per source (4 flops off the diagonal, 2 on it). Per bin and source, at
    8 flops per complex multiply-add: W V_k, the Gaussian elimination and
    back substitution of the m x (m+1) tableau, the quadratic form, the tmp
    row and the N x m OC elimination."""
    n_bytes = T * F * m * 8 + T * n * 4 + 3 * F * m * m * 8
    off = m * (m - 1) // 2
    cov = F * T * (off * (6 + 4 * n) + m * (3 + 2 * n))
    gauss = (m**3 - m) // 3 + m * (m - 1) // 2
    solves = n * F * 8 * (m**3 + gauss + m * m + m * m + n * n * m)
    return n_bytes, cov + solves


def update_rows_bound(m, n, F, T):
    return bound(*update_rows_work(m, n, F, T), F32_FLOPS)
