"""Test sources (synthetic speech-like + user wav corpora) and SNR mixing:
the port's copy of ``overiva_tpu/sim/sources.py``.

The reference pulls CMU ARCTIC speech via ``pyroomacoustics.datasets``
(SURVEY.md §2.1 "sample data prep"); this environment has no corpus and no
network, so the benchmark harness generates seeded speech-like signals by
default (Laplacian excitation, slowly-varying syllabic gating, AR(2)
formant-ish coloration; deterministic per seed). Users with real speech on
disk point the demo/sweep at it with :func:`load_wav_sources` (CLI
``--source-dir`` / sweep-config ``"source_dir"``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["speech_like", "load_wav_sources", "scale_to_snr", "mix_premix"]


def speech_like(
    n_samples: int,
    fs: float = 16000,
    seed: int | None = None,
    syllable_hz: float = 3.0,
    voiced_ratio: float = 0.55,
) -> np.ndarray:
    """One speech-like source signal, unit variance."""
    rng = np.random.default_rng(seed)
    x = rng.laplace(size=n_samples)

    # syllabic on/off gating with smoothed edges
    block = max(int(fs / syllable_hz / 4), 1)
    n_blocks = -(-n_samples // block)
    gates = np.where(rng.random(n_blocks) < voiced_ratio, 1.0, 0.08)
    env = np.repeat(gates, block)[:n_samples]
    k = np.hanning(int(0.02 * fs) | 1)
    env = np.convolve(env, k / k.sum(), mode="same")
    x *= env

    # AR(2) resonance at a random formant-ish frequency
    f0 = rng.uniform(300.0, 1800.0) / fs
    r = 0.95
    a1, a2 = 2 * r * np.cos(2 * np.pi * f0), -(r**2)
    y = np.empty_like(x)
    y[0], y[1] = x[0], x[1]
    for t in range(2, n_samples):
        y[t] = x[t] + a1 * y[t - 1] + a2 * y[t - 2]
    y /= np.std(y) + 1e-12
    return y


def load_wav_sources(
    directory,
    n_src: int,
    n_samples: int,
    fs: float = 16000,
    seed: int | None = None,
) -> np.ndarray:
    """Load ``n_src`` unit-variance source signals from a directory of wavs.

    The real-speech hook the reference gets from CMU ARCTIC: point the sweep
    config ("source_dir") or the demo CLI (--source-dir) at any directory of
    .wav files. Per seed, picks n_src distinct files (random segment of each
    when longer than needed, looped when shorter), mono-izes multichannel
    files, converts integer PCM to float, and polyphase-resamples when the
    file rate differs from ``fs``. Deterministic per (directory contents,
    seed). Returns (n_src, n_samples) float64.
    """
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    rng = np.random.default_rng(seed)
    files = sorted(Path(directory).glob("*.wav"))
    if not files:
        raise ValueError(f"no .wav files found in {directory!r}")
    # distinct files first; reuse (reshuffled) only if the corpus is small
    order = []
    while len(order) < n_src:
        order.extend(rng.permutation(len(files)).tolist())
    out = np.empty((n_src, n_samples))
    for k in range(n_src):
        rate, data = wavfile.read(files[order[k]])
        data = np.asarray(data)
        if data.ndim > 1:
            data = data.mean(axis=1)
        if np.issubdtype(data.dtype, np.integer):
            data = data / float(np.iinfo(data.dtype).max)
        data = data.astype(np.float64)
        if rate != fs:
            from math import gcd

            g = gcd(int(fs), int(rate))
            data = resample_poly(data, int(fs) // g, int(rate) // g)
        if data.shape[0] < n_samples:
            reps = -(-n_samples // data.shape[0])
            data = np.tile(data, reps)
        start = rng.integers(0, data.shape[0] - n_samples + 1)
        seg = data[start : start + n_samples]
        std = np.std(seg)
        if std < 1e-12:
            raise ValueError(f"{files[order[k]]} segment is silent")
        out[k] = seg / std
    return out


def scale_to_snr(premix: np.ndarray, snr_db: float, ref_mic: int = 0, n_targets=None):
    """Scale background sources so target-vs-rest SNR at ref_mic is snr_db.

    premix: (n_src, n_mics, n_samples); the first ``n_targets`` sources are
    the targets (default all-but-last). Returns a scaled copy.
    """
    premix = premix.copy()
    n_src = premix.shape[0]
    n_targets = n_targets if n_targets is not None else n_src
    if n_targets >= n_src:
        return premix
    p_t = np.sum(premix[:n_targets, ref_mic, :] ** 2)
    p_b = np.sum(premix[n_targets:, ref_mic, :] ** 2)
    if p_b > 0:
        premix[n_targets:] *= np.sqrt(p_t / p_b * 10 ** (-snr_db / 10))
    return premix


def mix_premix(premix: np.ndarray) -> np.ndarray:
    """(n_src, n_mics, n) -> (n, n_mics) mixture, frames-last transposed."""
    return premix.sum(axis=0).T
