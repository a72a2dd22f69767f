"""Tracing and profiling helpers: per-phase wall timers with a report, a
device barrier, a ``torch.profiler`` trace context and a convergence
recorder for the algorithms' callbacks.

Counterpart of ``overiva_tpu/utils/profiling.py``. ``device_sync`` is
``torch.cuda.synchronize`` on the tensor's card (the JAX package's
scalar-fetch barrier exists for its TPU backend only), and
``profile_trace`` writes a Chrome trace of ``torch.profiler`` instead of
an XLA profile. ``ConvergenceRecorder`` scores with the port's copies of
the oracle's synthesis and of bss_eval.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

__all__ = ["device_sync", "PhaseTimer", "profile_trace", "ConvergenceRecorder"]


def device_sync(x) -> None:
    """Wait for the card that holds tensor ``x``; nothing for anything
    else (a NumPy array, a CPU tensor)."""
    import torch

    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


class PhaseTimer:
    """Accumulating per-phase wall-clock timer.

    >>> timer = PhaseTimer()
    >>> with timer("stft"): X = stft(...)
    >>> with timer("iterate", sync_on=W): W = run(...)
    >>> print(timer.report())

    ``sync_on``: a tensor whose card is synchronised before the clock
    stops, so that the phase's device work is inside its time.
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, phase: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                device_sync(sync_on)
            self.totals[phase] += time.perf_counter() - t0
            self.counts[phase] += 1

    def report(self) -> str:
        lines = []
        for phase, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[phase]
            lines.append(f"{phase:>16s}: {total*1e3:9.1f} ms  ({n}x, {total/n*1e3:.1f} ms avg)")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {k: {"total_s": v, "count": self.counts[k]} for k, v in self.totals.items()}


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """``torch.profiler`` over the block (CPU and, where there is a card,
    CUDA activity), written to ``log_dir/trace.json`` as a Chrome trace;
    nothing when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))


class ConvergenceRecorder:
    """Callback recording per-iteration SDR/SIR (the reference's
    ``example.py`` convergence-monitoring pattern).

    Pass ``recorder`` as ``callback=`` to any algorithm; it iSTFTs each
    snapshot and scores it against the reference signals. A tensor
    snapshot is copied to the host first.
    """

    def __init__(self, refs: np.ndarray, nfft: int, hop: int | None = None,
                 n_samples: int | None = None, filter_length: int = 512):
        self.refs = np.asarray(refs)  # (n_src, n_samples) mic-0 images
        self.nfft = nfft
        self.hop = hop or nfft // 2
        self.n_samples = n_samples or self.refs.shape[1]
        self.filter_length = filter_length
        self.sdr: list[np.ndarray] = []
        self.sir: list[np.ndarray] = []

    def __call__(self, Y) -> None:
        from ..metrics import bss_eval_sources
        from ..oracle import synthesis

        if not isinstance(Y, np.ndarray):  # a tensor, on any device
            Y = Y.resolve_conj().cpu().numpy()
        y = synthesis(Y, self.nfft, self.hop)
        start = self.nfft - self.hop
        y = y[start : start + self.n_samples]
        K = Y.shape[2]
        refs = self.refs[:K, : y.shape[0]]
        est = y.T[:, : refs.shape[1]]
        sdr, sir, _, perm = bss_eval_sources(
            refs, est, filter_length=self.filter_length
        )
        self.sdr.append(sdr)
        self.sir.append(sir)
