"""STFT analysis and synthesis of the reference.

Frozen copy of ``overiva_tpu_torch/oracle/stft.py`` (commit 76c639c):
``hann``, ``synthesis_window``, ``stft_pad``, ``analysis``, ``synthesis``.
Departures: ``analysis`` and ``synthesis`` take an
:class:`~benchmark.reference.arith.Arith` (float64 for the reference,
float32 for the control) and ``synthesis`` overlap-adds by hop-sized
slices instead of a loop over frames (the same sums, fewer Python steps).
"""

from __future__ import annotations

import numpy as np

from .arith import F64, Arith

__all__ = ["analysis", "hann", "stft_pad", "synthesis", "synthesis_window"]


def hann(nfft: int) -> np.ndarray:
    """Periodic hann window ``0.5 - 0.5 cos(2 pi n / nfft)`` of length nfft."""
    n = np.arange(nfft)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / nfft)


def synthesis_window(win: np.ndarray, hop: int) -> np.ndarray:
    """Canonical dual (biorthogonal) synthesis window for weighted OLA:
    ``dual[n] = win[n] / sum_m win[n - m*hop]^2`` over the overlapping
    shifts."""
    win = np.asarray(win, dtype=np.float64)
    nfft = win.shape[0]
    if nfft % hop != 0:
        raise ValueError("window length must be a multiple of hop")
    denom = np.zeros(nfft)
    for m in range(-(nfft // hop) + 1, nfft // hop):
        shifted = np.zeros(nfft)
        lo, hi = max(0, m * hop), min(nfft, nfft + m * hop)
        shifted[lo:hi] = win[lo - m * hop : hi - m * hop] ** 2
        denom += shifted
    if np.any(denom <= 0):
        raise ValueError("analysis window has zero-coverage positions")
    return win / denom


def stft_pad(x: np.ndarray, nfft: int, hop: int) -> np.ndarray:
    """``nfft - hop`` zeros in front, and enough at the end to complete
    the last frame."""
    x = np.asarray(x)
    n = x.shape[0]
    front = nfft - hop
    total = front + n
    n_frames = int(np.ceil(max(total - nfft, 0) / hop)) + 1
    back = (n_frames - 1) * hop + nfft - total + (nfft - hop)
    pad = [(front, back)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad)


def analysis(x: np.ndarray, nfft: int, hop: int, ar: Arith = F64) -> np.ndarray:
    """(n_samples, n_chan) real -> (n_frames, nfft//2 + 1, n_chan)."""
    x = ar.r(x)
    win = ar.r(hann(nfft))
    n = x.shape[0]
    if n < nfft:
        raise ValueError("signal shorter than one frame")
    n_frames = (n - nfft) // hop + 1
    idx = np.arange(nfft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = x[idx, :] * win[None, :, None]  # (T, nfft, M)
    return ar.c(np.fft.rfft(frames, n=nfft, axis=1))


def synthesis(X: np.ndarray, nfft: int, hop: int, ar: Arith = F64) -> np.ndarray:
    """(n_frames, nfft//2+1, n_chan) -> ((n_frames - 1) * hop + nfft, n_chan)
    by weighted overlap-add with the dual window."""
    win_s = ar.r(synthesis_window(hann(nfft), hop))
    T, _, K = X.shape
    frames = ar.r(np.fft.irfft(X, n=nfft, axis=1)) * win_s[None, :, None]
    n = (T - 1) * hop + nfft
    out = np.zeros((n, K), dtype=frames.dtype)
    for j in range(nfft // hop):
        part = frames[:, j * hop : (j + 1) * hop, :].reshape(T * hop, K)
        out[j * hop : j * hop + T * hop] += part
    return out
