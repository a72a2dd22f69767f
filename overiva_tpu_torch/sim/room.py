"""Shoebox image-source room simulator (pure NumPy, CPU): the port's copy
of ``overiva_tpu/sim/room.py``.

In-repo replacement for the slice of ``pyroomacoustics`` the reference's
benchmark harness uses (SURVEY.md §2.5, §7.4 hard part #2): ShoeBox rooms
with Sabine-matched absorption, image-source RIRs (Allen & Berkley 1979)
with fractional-delay windowed-sinc injection, and premix simulation.

Not separation-path code — this generates the benchmark inputs on the host;
the card sees only the resulting mixtures.
"""

from __future__ import annotations

import numpy as np

__all__ = ["inverse_sabine", "shoebox_rir", "ShoeBox"]

C_SOUND = 343.0  # m/s


def inverse_sabine(rt60: float, room_dim, c: float = C_SOUND):
    """Sabine inversion: (energy absorption, image order) for a target RT60.

    RT60 = 24 ln(10) V / (c S a)  =>  a = 24 ln(10) V / (c S RT60).
    max_order covers the distance sound travels in RT60.
    """
    dim = np.asarray(room_dim, dtype=np.float64)
    V = float(np.prod(dim))
    S = 2.0 * float(dim[0] * dim[1] + dim[1] * dim[2] + dim[0] * dim[2])
    absorption = 24.0 * np.log(10.0) * V / (c * S * rt60)
    if absorption > 1.0:
        raise ValueError(f"rt60 = {rt60} unreachable for this room (a > 1)")
    max_order = int(np.ceil(c * rt60 / np.min(dim)))
    return absorption, max_order


def _frac_delay_filter(frac: np.ndarray, length: int = 81) -> np.ndarray:
    """Hann-windowed sinc fractional-delay filters. frac in [0,1), (n,) ->
    (n, length) taps centered at length//2 + frac."""
    n = np.arange(length)[None, :] - length // 2
    t = n - frac[:, None]
    h = np.sinc(t)
    win = 0.5 * (1.0 + np.cos(2.0 * np.pi * t / length))
    return h * win


def shoebox_rir(
    room_dim,
    src,
    mic,
    fs: float,
    absorption: float,
    max_order: int,
    c: float = C_SOUND,
    frac_len: int = 81,
    extra_samples: int = 64,
    use_native: bool | None = None,
) -> np.ndarray:
    """RIR between one source and one microphone via the image-source method.

    Images along axis d at ``(-1)^p s_d + 2 n L_d`` carry ``2|n|`` (p=0) or
    ``|2n-1|`` (p=1) reflections; amplitude = rho^reflections / (4 pi dist),
    rho = sqrt(1 - absorption). Total reflection order is pruned at
    ``max_order``. Each image injects a windowed-sinc fractional delay.

    Dispatches to the native C++ engine (``csrc/rir.cpp``) when available;
    ``use_native=False`` forces the NumPy path (same math).
    """
    if use_native is not False:
        from ._native import native_shoebox_rir

        rir = native_shoebox_rir(
            room_dim, src, mic, fs, absorption, max_order, c, frac_len, extra_samples
        )
        if rir is not None:
            return rir
        if use_native is True:
            raise RuntimeError("native RIR engine unavailable")
    L = np.asarray(room_dim, np.float64)
    s = np.asarray(src, np.float64)
    m = np.asarray(mic, np.float64)
    if np.any(s <= 0) or np.any(s >= L) or np.any(m <= 0) or np.any(m >= L):
        raise ValueError("source and mic must be strictly inside the room")

    half = max_order // 2 + 1
    n_rng = np.arange(-half, half + 1)

    pos_d, refl_d = [], []
    for d in range(3):
        # p = 0 branch: +s + 2nL, 2|n| reflections; p = 1: -s + 2nL, |2n-1|
        p0 = s[d] + 2.0 * n_rng * L[d]
        r0 = 2 * np.abs(n_rng)
        p1 = -s[d] + 2.0 * n_rng * L[d]
        r1 = np.abs(2 * n_rng - 1)
        pos_d.append(np.concatenate([p0, p1]))
        refl_d.append(np.concatenate([r0, r1]))

    px, py, pz = np.meshgrid(pos_d[0], pos_d[1], pos_d[2], indexing="ij")
    rx, ry, rz = np.meshgrid(refl_d[0], refl_d[1], refl_d[2], indexing="ij")
    order = rx + ry + rz
    keep = (order <= max_order).ravel()

    dx = px.ravel()[keep] - m[0]
    dy = py.ravel()[keep] - m[1]
    dz = pz.ravel()[keep] - m[2]
    dist = np.sqrt(dx * dx + dy * dy + dz * dz)
    dist = np.maximum(dist, 1e-3)
    rho = np.sqrt(max(1.0 - absorption, 0.0))
    amp = rho ** order.ravel()[keep] / (4.0 * np.pi * dist)

    delay = dist / c * fs + frac_len // 2
    base = np.floor(delay).astype(np.int64)
    frac = delay - base

    taps = _frac_delay_filter(frac, frac_len) * amp[:, None]
    rir_len = int(base.max()) + frac_len + extra_samples
    rir = np.zeros(rir_len)
    idx = base[:, None] + np.arange(frac_len)[None, :] - frac_len // 2
    np.add.at(rir, idx.ravel(), taps.ravel())
    return rir


class ShoeBox:
    """Minimal pyroomacoustics-style shoebox room.

    Mirrors the slice of the API the reference's ``example.py``/``mbss_sim.py``
    drive: construct, ``add_source``, ``add_mic_array``, ``simulate`` with
    ``return_premix`` (SURVEY.md §3.1).
    """

    def __init__(
        self,
        room_dim,
        fs: float = 16000,
        rt60: float | None = None,
        absorption: float | None = None,
        max_order: int | None = None,
        c: float = C_SOUND,
        seed: int | None = None,
    ):
        self.dim = np.asarray(room_dim, np.float64)
        self.fs = float(fs)
        self.c = c
        if rt60 is not None:
            self.absorption, self.max_order = inverse_sabine(rt60, room_dim, c)
            if max_order is not None:
                self.max_order = max_order
        else:
            if absorption is None or max_order is None:
                raise ValueError("give rt60, or absorption + max_order")
            self.absorption, self.max_order = float(absorption), int(max_order)
        self.sources: list[tuple[np.ndarray, np.ndarray]] = []
        self.mics: np.ndarray | None = None
        self.rng = np.random.default_rng(seed)

    def add_source(self, position, signal):
        self.sources.append((np.asarray(position, np.float64), np.asarray(signal)))
        return self

    def add_mic_array(self, positions):
        """positions: (M, 3)."""
        self.mics = np.atleast_2d(np.asarray(positions, np.float64))
        return self

    def compute_rirs(self):
        """rirs[m][s] like pyroomacoustics' room.rir."""
        return [
            [
                shoebox_rir(
                    self.dim, spos, mic, self.fs, self.absorption, self.max_order, self.c
                )
                for spos, _ in self.sources
            ]
            for mic in self.mics
        ]

    def simulate(self, return_premix: bool = True, ref_mic: int = 0, snr: float | None = None):
        """Convolve sources with RIRs (FFT overlap — like pyroomacoustics'
        ``fftconvolve``; direct ``np.convolve`` on a 6 s signal x ~4000-tap
        RIR costs ~0.4 GMAC per (src, mic) pair and dominated the benchmark
        harness's host time).

        Returns premix (n_src, n_mics, n_samples) when ``return_premix`` else
        the summed mixture (n_mics, n_samples). ``snr`` adds white noise
        scaled against the premix power at ``ref_mic``.
        """
        from scipy.signal import fftconvolve

        if self.mics is None or not self.sources:
            raise ValueError("add sources and mics first")
        rirs = self.compute_rirs()
        n_src, n_mics = len(self.sources), len(self.mics)
        n = max(len(sig) for _, sig in self.sources)
        rir_len = max(len(rirs[m][s]) for m in range(n_mics) for s in range(n_src))
        total = n + rir_len - 1
        premix = np.zeros((n_src, n_mics, total))
        for s, (_, sig) in enumerate(self.sources):
            for m in range(n_mics):
                premix[s, m, : len(sig) + len(rirs[m][s]) - 1] = fftconvolve(
                    sig, rirs[m][s]
                )
        if snr is not None:
            p_sig = np.mean(np.sum(premix[:, ref_mic, :], axis=0) ** 2)
            noise = self.rng.standard_normal((n_mics, total))
            noise *= np.sqrt(p_sig * 10 ** (-snr / 10))
            if return_premix:
                return premix, noise
            return premix.sum(axis=0) + noise
        if return_premix:
            return premix
        return premix.sum(axis=0)
