"""Tracing and profiling helpers: per-phase wall timers with a report, a
device barrier, a ``torch.profiler`` trace context, spans of the program's
stages (:func:`tracing`, :func:`span`) and a convergence recorder for the
algorithms' callbacks.

Counterpart of ``overiva_tpu/utils/profiling.py``. ``device_sync`` is
``torch.cuda.synchronize`` on the tensor's card (the JAX package's
scalar-fetch barrier exists for its TPU backend only), and
``profile_trace`` writes a Chrome trace of ``torch.profiler`` instead of
an XLA profile. ``ConvergenceRecorder`` scores with the port's copies of
the oracle's synthesis and of bss_eval.

**Spans.** The serving tier, the API and the epoch loops mark their stages
with :func:`span` (``serve.*``, ``api.*``, ``family.*``, ``tiss.*``,
``ilrma.*``, with counts such as bytes, frames, bins). Tracing is off
unless a :func:`tracing` block is open: ``span`` then returns one shared
no-op context, takes no time stamp and enters no profiler annotation. Inside
the block each span is kept in the block's :class:`Trace` and entered as
a ``torch.profiler`` annotation, so a running profiler names its events,
and the device's idle gaps, after the stage. Spans of one thread nest;
run one traced caller at a time.

    >>> with tracing() as tr:
    ...     sep.separate(x)
    >>> print(tr.table())
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

__all__ = ["device_sync", "PhaseTimer", "profile_trace", "ConvergenceRecorder",
           "Trace", "span", "tracing"]

_trace = None  # the Trace that span() records into; None: tracing is off
_NO_SPAN = contextlib.nullcontext()


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


class Trace:
    """The spans that one :func:`tracing` block recorded, in the order
    they began.

    Each span is a dict: ``name``; ``id`` (its index in :attr:`spans`);
    ``parent``, the id of the span it ran inside (None for a root);
    ``request``, shared by a root span and every span under it (one id a
    ``Separator.separate`` or ``separate_batch`` call); ``t0_ns`` and
    ``t1_ns`` on the profiler's clock (Unix-epoch nanoseconds, as
    ``torch.profiler`` events give them; 0 at ``t1_ns`` while open); and
    ``counts``, the keyword counts the span was opened with.
    """

    def __init__(self):
        self.spans: list[dict] = []
        # spans are timed by perf_counter_ns and exported on the profiler's
        # (wall) clock, by one offset taken at the block's start
        self.clock_offset_ns = time.time_ns() - time.perf_counter_ns()
        self._stack: list[dict] = []
        self._requests = 0

    def table(self) -> dict:
        """Per span name: ``count``, ``wall_ms`` (summed durations),
        ``self_ms`` (each duration less the part its child spans cover)
        and ``counts`` (each count summed)."""
        child_ns = defaultdict(int)
        for s in self.spans:
            if s["parent"] is not None:
                child_ns[s["parent"]] += s["t1_ns"] - s["t0_ns"]
        out: dict[str, dict] = {}
        for s in self.spans:
            row = out.setdefault(s["name"], {"count": 0, "wall_ms": 0.0, "self_ms": 0.0,
                                             "counts": defaultdict(int)})
            wall = s["t1_ns"] - s["t0_ns"]
            row["count"] += 1
            row["wall_ms"] += wall / 1e6
            row["self_ms"] += (wall - child_ns[s["id"]]) / 1e6
            for k, v in s["counts"].items():
                row["counts"][k] += v
        for row in out.values():
            row["counts"] = dict(row["counts"])
        return out


class _Span:
    """One recorded span: a record in its Trace and a profiler annotation."""

    __slots__ = ("_trace", "_name", "_counts", "_rec", "_annotation")

    def __init__(self, trace: Trace, name: str, counts: dict):
        self._trace, self._name, self._counts = trace, name, counts

    def __enter__(self):
        import torch

        tr = self._trace
        parent = tr._stack[-1] if tr._stack else None
        if parent is None:
            request = tr._requests
            tr._requests += 1
        else:
            request = parent["request"]
        rec = {"name": self._name, "id": len(tr.spans),
               "parent": None if parent is None else parent["id"], "request": request,
               "t0_ns": 0, "t1_ns": 0, "counts": self._counts}
        tr.spans.append(rec)
        tr._stack.append(rec)
        self._rec = rec
        self._annotation = torch.profiler.record_function(self._name)
        self._annotation.__enter__()
        rec["t0_ns"] = time.perf_counter_ns() + tr.clock_offset_ns
        return rec

    def __exit__(self, *exc):
        tr, rec = self._trace, self._rec
        rec["t1_ns"] = time.perf_counter_ns() + tr.clock_offset_ns
        self._annotation.__exit__(*exc)
        tr._stack.pop()
        return False


def span(name: str, **counts):
    """A context that marks one stage of the program as ``name`` with
    ``counts``, in the open :func:`tracing` block's :class:`Trace`; with
    tracing off, one shared context that does nothing."""
    if _trace is None:
        return _NO_SPAN
    return _Span(_trace, name, counts)


@contextlib.contextmanager
def tracing():
    """Tracing on for the block, which yields the :class:`Trace` its spans
    go to. A block opened inside another records the inner block's spans
    alone; the outer one resumes after it."""
    global _trace
    outer, _trace = _trace, Trace()
    try:
        yield _trace
    finally:
        _trace = outer


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """``torch.profiler`` over the block (CPU and, where there is a card,
    CUDA activity), with :func:`tracing` on so that the program's stages
    appear in it, written to ``log_dir/trace.json`` as a Chrome trace;
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
    with torch.profiler.profile(activities=acts) as prof, tracing():
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
