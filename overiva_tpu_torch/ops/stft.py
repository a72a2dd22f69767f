"""STFT analysis and synthesis on tensors.

Counterpart of ``overiva_tpu/ops/stft.py``, with the conventions of the
NumPy oracle (``overiva_tpu/oracle/stft.py``): hann analysis window,
canonical-dual synthesis window, hop = nfft // 2 by default, frames-first
complex output ``(T, nfft//2+1, M)``. The windows are those of the port's
copy of the oracle (``overiva_tpu_torch/oracle/stft.py``).
"""

from __future__ import annotations

import torch

from ..oracle.stft import hann, synthesis_window

__all__ = ["analysis", "synthesis", "stft_pad", "hann", "synthesis_window", "n_frames_of"]


def n_frames_of(n_samples: int, nfft: int, hop: int) -> int:
    """Frames of :func:`analysis` on ``n_samples`` samples."""
    return (n_samples - nfft) // hop + 1


def stft_pad(x, nfft: int, hop: int):
    """Tensor twin of ``oracle.stft_pad``: zero-pad the sample axis so every
    sample falls in fully overlapped frames."""
    n = x.shape[0]
    front = nfft - hop
    total = front + n
    n_frames = -(-max(total - nfft, 0) // hop) + 1
    back = (n_frames - 1) * hop + nfft - total + (nfft - hop)
    pad = torch.zeros((front + n + back, *x.shape[1:]), dtype=x.dtype, device=x.device)
    pad[front : front + n] = x
    return pad


def analysis(x, nfft: int, hop: int, win=None):
    """x: (n_samples[, M]) real -> X: (T, nfft//2+1[, M]) complex.

    A batch (B, n_samples, M) gives (B, T, nfft//2+1, M) in one transform."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    if x.shape[-2] < nfft:
        raise ValueError("signal shorter than one frame")
    win = torch.as_tensor(hann(nfft) if win is None else win, dtype=x.dtype, device=x.device)
    frames = x.unfold(-2, nfft, hop).transpose(-1, -2)  # (..., T, nfft, M)
    X = torch.fft.rfft(frames * win[:, None], n=nfft, dim=-2)
    return X[..., 0] if squeeze else X


def synthesis(X, nfft: int, hop: int, win_s=None):
    """X: (T, nfft//2+1[, M]) complex -> (n_samples[, M]) real.

    A batch (B, T, nfft//2+1, M) gives (B, n_samples, M) in one pass.
    Weighted overlap-add with ``index_add_``. On CUDA that sums with
    atomics, so overlapping samples add in a varying order: results agree
    between runs to rounding, not bit for bit.
    """
    squeeze = X.ndim == 2
    if squeeze:
        X = X[:, :, None]
    frames = torch.fft.irfft(X, n=nfft, dim=-2)  # (..., T, nfft, M)
    if win_s is None:
        win_s = synthesis_window(hann(nfft), hop)
    win_s = torch.as_tensor(win_s, dtype=frames.dtype, device=frames.device)
    frames = frames * win_s[:, None]
    *lead, T, _, M = frames.shape
    idx = (
        torch.arange(nfft, device=X.device)[None, :]
        + hop * torch.arange(T, device=X.device)[:, None]
    ).reshape(-1)
    out = torch.zeros((*lead, (T - 1) * hop + nfft, M), dtype=frames.dtype, device=X.device)
    out.index_add_(out.ndim - 2, idx, frames.reshape(*lead, T * nfft, M))
    return out[..., 0] if squeeze else out
