"""The seeded inputs of every cell.

A configuration's ``scene`` states the room: its dimensions, RT60 and
SNR, the microphone circle and the arc of sources around it, as the
paper's experiment sets them up. Each clip is a new room draw from one
``numpy.random.Generator`` seeded by the run's ``--seed``; sizes never
depend on the seed, only the content and the order do.

- ``speech_like`` is a copy of ``overiva_tpu_torch/sim/sources.py``'s
  (commit 76c639c), drawing from the run's generator, with its AR(2)
  recursion run by ``scipy.signal.lfilter`` (the same recursion).
- The layout copies ``bench/mbss_sim.py::simulate_instance`` (commit
  76c639c): a circular array at the room's centre, 1.5 m high, and the
  sources on an arc of pi/2 at 2.5 m around it, turned by a random angle.
- The room impulse responses are a statistical model of that room, not
  the image-source method: the direct path from the geometry (1/(4 pi r),
  a fractional delay by the image-source code's windowed sinc), then a
  diffuse tail of white noise decaying by 60 dB in RT60, one independent
  tail per microphone, whose energy stands to the direct path's as
  (r / r_c)^2 at Sabine's critical distance r_c = sqrt(A / (16 pi)),
  A = 0.161 V / RT60.
- White noise at the SNR against the premix's power at microphone 0, as
  the simulator's ``ShoeBox.simulate`` scales it.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter

__all__ = ["clip_lengths", "make_mixture", "mixtures", "room_rirs", "speech_like"]

C_SOUND = 343.0  # m/s


def speech_like(rng, n_samples: int, fs: float, syllable_hz: float = 3.0,
                voiced_ratio: float = 0.55) -> np.ndarray:
    """One speech-like source signal, unit variance."""
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
    y = lfilter([1.0], [1.0, -a1, -a2], x)
    y /= np.std(y) + 1e-12
    return y


def _frac_delay(frac: float, length: int = 81) -> np.ndarray:
    """A Hann-windowed sinc delaying by ``length // 2 + frac`` samples."""
    t = np.arange(length) - length // 2 - frac
    return np.sinc(t) * 0.5 * (1.0 + np.cos(2.0 * np.pi * t / length))


def room_rirs(rng, n_src: int, n_mics: int, fs: float, scene: dict) -> np.ndarray:
    """(n_mics, n_src, L) impulse responses of one room draw (module
    docstring)."""
    dim = np.asarray(scene["room_dim"], np.float64)
    rt60 = float(scene["rt60"])
    centre = np.array([dim[0] / 2, dim[1] / 2, 1.5])
    ang = 2.0 * np.pi * np.arange(n_mics) / n_mics
    mics = centre + float(scene["mic_radius"]) * np.stack(
        [np.cos(ang), np.sin(ang), np.zeros(n_mics)], axis=1)
    rot = rng.uniform(-np.pi, np.pi)
    arc = (np.linspace(-np.pi / 4, np.pi / 4, n_src) if n_src > 1 else np.zeros(1)) + rot
    dist = float(scene["src_distance"])
    srcs = centre + dist * np.stack([np.cos(arc), np.sin(arc), np.zeros(n_src)], axis=1)
    srcs = np.clip(srcs, 0.3, dim - 0.3)

    r_c = np.sqrt(0.161 * np.prod(dim) / rt60 / (16.0 * np.pi))
    n_tail = int(round(rt60 * fs))
    decay = np.exp(-3.0 * np.log(10.0) * np.arange(n_tail) / (rt60 * fs))
    r = np.linalg.norm(mics[:, None, :] - srcs[None, :, :], axis=2)  # (M, N)
    delay = r / C_SOUND * fs
    first = np.floor(delay).astype(int)
    L = int(first.max()) + 81 + n_tail
    h = np.zeros((n_mics, n_src, L))
    tails = rng.standard_normal((n_mics, n_src, n_tail)) * decay
    for m in range(n_mics):
        for k in range(n_src):
            a = 1.0 / (4.0 * np.pi * r[m, k])
            h[m, k, first[m, k] : first[m, k] + 81] += a * _frac_delay(delay[m, k] - first[m, k])
            tail = tails[m, k] * (a * r[m, k] / r_c / np.linalg.norm(tails[m, k]))
            h[m, k, first[m, k] + 40 : first[m, k] + 40 + n_tail] += tail
    return h


def make_mixture(rng, n_mics: int, n_samples: int, fs: float, scene: dict):
    """One room draw: (mix (n, M), premix (n_src, M, n)), both float64."""
    n_src = int(scene["n_src"])
    src = np.stack([speech_like(rng, n_samples, fs) for _ in range(n_src)])
    h = room_rirs(rng, n_src, n_mics, fs, scene)
    n_fft = 1 << int(np.ceil(np.log2(n_samples + h.shape[-1] - 1)))
    S = np.fft.rfft(src, n_fft)  # (N, K)
    H = np.fft.rfft(h, n_fft)  # (M, N, K)
    premix = np.fft.irfft(H * S[None], n_fft)[..., :n_samples].transpose(1, 0, 2)
    p_sig = np.mean(np.sum(premix[:, 0, :], axis=0) ** 2)
    noise = rng.standard_normal((n_mics, n_samples)) * np.sqrt(p_sig * 10 ** (-scene["snr_db"] / 10))
    return (premix.sum(axis=0) + noise).T, premix


def mixtures(rng, lengths, cfg: dict) -> list[np.ndarray]:
    """One float32 mixture (n, n_chan) for each length in ``lengths``, each
    a room of the configuration's ``scene``."""
    return [make_mixture(rng, cfg["n_chan"], int(n), cfg["fs"], cfg["scene"])[0].astype(np.float32)
            for n in lengths]


def clip_lengths(n_clips: int, lo_s: float, hi_s: float, fs: int) -> list[int]:
    """``n_clips`` lengths in samples, log-uniform over [lo_s, hi_s]: the
    midpoints of equal steps in log length, the same for every seed."""
    ratio = hi_s / lo_s
    return [int(round(lo_s * ratio ** ((i + 0.5) / n_clips) * fs)) for i in range(n_clips)]
