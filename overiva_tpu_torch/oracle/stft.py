"""NumPy oracle STFT frontend: the port's copy of ``overiva_tpu/oracle/stft.py``.

The port keeps its own copy so that it imports nothing of the JAX package;
``tests/test_torch_oracle_copy.py`` holds it bit for bit against the
original. Implements the pyroomacoustics-convention STFT the reference pipeline uses
(reference: ``pyroomacoustics.transform.stft`` — see SURVEY.md §2.3.7; the
reference repo itself imports it, it does not ship one). Conventions:

- ``nfft``-point real FFT, frames-first output ``(n_frames, nfft//2+1, n_chan)``
- hann analysis window, hop = nfft // 2 by default
- biorthogonal (canonical dual) synthesis window computed for perfect
  reconstruction of the weighted overlap-add
- no implicit padding: analysis uses only full frames. Callers that need the
  whole signal reconstructed should pad with ``stft_pad`` first.

This module is pure NumPy (float64/complex128). ``ops/stft.py`` takes its
windows from here.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "hann",
    "synthesis_window",
    "stft_pad",
    "analysis",
    "synthesis",
]


def hann(nfft: int) -> np.ndarray:
    """Periodic hann window ``0.5 - 0.5 cos(2 pi n / nfft)`` of length nfft."""
    n = np.arange(nfft)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / nfft)


def synthesis_window(win: np.ndarray, hop: int) -> np.ndarray:
    """Canonical dual (biorthogonal) synthesis window for weighted OLA.

    Solves ``sum_m win[n - m*hop] * dual[n - m*hop] == 1`` for all n covered
    by full overlap, via ``dual[n] = win[n] / sum_m win[(n + m*hop) mod-range]^2``.

    Matches ``pyroomacoustics.transform.stft.compute_synthesis_window``
    semantics (SURVEY.md §2.3.7).
    """
    win = np.asarray(win, dtype=np.float64)
    nfft = win.shape[0]
    if nfft % hop != 0:
        raise ValueError("window length must be a multiple of hop")
    # Sum of squared shifted windows, evaluated per position within the window.
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
    """Zero-pad a time signal so every sample falls in fully-overlapped frames.

    Pads ``nfft - hop`` zeros in front (so sample 0 is covered by a full set of
    overlapping windows) and enough zeros at the end to complete the last frame.
    """
    x = np.asarray(x)
    n = x.shape[0]
    front = nfft - hop
    total = front + n
    n_frames = int(np.ceil(max(total - nfft, 0) / hop)) + 1
    back = (n_frames - 1) * hop + nfft - total + (nfft - hop)
    pad = [(front, back)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad)


def analysis(x: np.ndarray, nfft: int, hop: int, win: np.ndarray | None = None) -> np.ndarray:
    """STFT analysis. ``x``: (n_samples,) or (n_samples, n_chan) real.

    Returns ``X``: (n_frames, nfft//2 + 1, n_chan) complex (chan axis added for
    1-D input is squeezed away, matching pyroomacoustics).
    """
    x = np.asarray(x, dtype=np.float64)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    if win is None:
        win = hann(nfft)
    n = x.shape[0]
    if n < nfft:
        raise ValueError("signal shorter than one frame")
    n_frames = (n - nfft) // hop + 1
    idx = np.arange(nfft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = x[idx, :] * win[None, :, None]  # (T, nfft, M)
    X = np.fft.rfft(frames, n=nfft, axis=1)
    return X[:, :, 0] if squeeze else X


def synthesis(
    X: np.ndarray, nfft: int, hop: int, win_s: np.ndarray | None = None
) -> np.ndarray:
    """Inverse STFT via weighted overlap-add with the dual synthesis window.

    ``X``: (n_frames, nfft//2+1) or (n_frames, nfft//2+1, n_chan).
    Returns (n_samples,) or (n_samples, n_chan) with
    ``n_samples = (n_frames - 1) * hop + nfft``.
    """
    X = np.asarray(X)
    squeeze = X.ndim == 2
    if squeeze:
        X = X[:, :, None]
    if win_s is None:
        win_s = synthesis_window(hann(nfft), hop)
    T = X.shape[0]
    frames = np.fft.irfft(X, n=nfft, axis=1) * win_s[None, :, None]
    n = (T - 1) * hop + nfft
    out = np.zeros((n, X.shape[2]))
    for t in range(T):
        out[t * hop : t * hop + nfft, :] += frames[t]
    return out[:, 0] if squeeze else out
