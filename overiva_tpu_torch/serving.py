"""Serving tier, the streaming half: time-domain sample blocks in,
separated sample blocks out, with every piece of stream state on the
device.

Counterpart of ``overiva_tpu/serving.py:283-482`` (``_stream_step_jit``
and ``StreamingSeparator``). Each block runs framing, STFT analysis
(``ops/stft.py``), the online step (``models/online_iss.py`` or
``models/online_tiss.py``), synthesis and the overlap-add with the carry
of the block before, all as torch ops on the device; the analysis and
synthesis windows are built on the device once, in the constructor. Only
the samples cross the host boundary (none at all for a tensor block), and
nothing in :meth:`StreamingSeparator.process` reads a value back to the
host.

Left out for a later slice: the JAX module's clip-serving half,
``Separator`` with its frame-bucket grid (``bucket_frames``), the
``SERVABLE`` list, ``separate_batch`` and the PCM16 tiers.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .api import (
    DEFAULT_DTYPE, _check_model, _check_taps, _output, restored_state,
)
from .models.online_iss import online_iss_init, online_iss_step
from .models.online_tiss import online_tiss_init, online_tiss_step
from .ops import stft as _stft
from .oracle.stft import hann, synthesis_window
from .utils.checkpoint import load_state, save_state
from .utils.convert import as_tensor, state_to_numpy, to_torch_dtype

__all__ = ["StreamingSeparator"]

STREAM_ALGOS = ("online-iss", "online-tiss")


def _stream_step(x_blk, tail, carry, state, step, nfft: int, hop: int, win, win_s):
    """One streaming block: framing + analysis + ``step`` (the online
    epoch(s), ``X, state -> Y, state``) + synthesis + overlap-add. x_blk
    (block_frames * hop, M) real; ``tail`` and ``carry`` (nfft - hop, M)
    are the input tail and the overlap-add carry of the block before.
    Returns (emitted samples, new tail, new carry, new state)."""
    B_hop = x_blk.shape[0]
    D = nfft - hop
    x = torch.cat([tail, x_blk], dim=0)
    X = _stft.analysis(x, nfft, hop, win)  # (block_frames, F, M)
    Y, state = step(X, state)
    y = _stft.synthesis(Y, nfft, hop, win_s)  # (B_hop + nfft - hop, M)
    emit = torch.cat([y[:D] + carry, y[D:B_hop]], dim=0)
    return emit, x[B_hop:], y[B_hop:], state


class StreamingSeparator:
    """Streaming serving surface: time-domain sample blocks in, separated
    sample blocks out, with the online separation state, the framing tail
    and the overlap-add carry on the device.

        sep = StreamingSeparator("online-iss", n_chan=4, nfft=512)
        for blk in stream:              # (block_frames*hop, n_chan) float
            y = sep.process(blk)        # same shape out (M channels)

    Output is delayed by ``nfft - hop`` samples relative to the input (the
    overlap-add tail of each synthesis window is held back until the next
    block completes it); :meth:`flush` drains that tail at stream end. The
    emitted samples equal running the STFT-domain online class over the
    same frames and synthesizing the concatenated stream.

    ``algo``: "online-iss" (rank-1 streaming separation) or "online-tiss"
    (joint streaming dereverberation + separation; ``taps``/``delay``,
    ``tap_update``). ``pb_forget`` and ``tap_forget`` default to
    ``forget``. ``device`` as in :func:`overiva_tpu_torch.resolve_device`
    (default CUDA; without a card pass ``device="cpu"``). A NumPy block
    gives a NumPy block, a tensor a tensor on the device.
    """

    def __init__(self, algo="online-iss", n_chan=2, nfft=512, hop=None, block_frames=8,
                 forget=0.97, model="laplace", n_pass=1, taps=4, delay=2,
                 tap_update="solve", pb_forget=None, tap_forget=None, dtype=None,
                 device=None):
        if algo not in STREAM_ALGOS:
            raise ValueError(
                f"unknown streaming algo {algo!r}; use 'online-iss' or 'online-tiss'"
            )
        _check_model(model)
        self.algo = algo
        self.nfft = int(nfft)
        self.hop = int(hop or nfft // 2)
        self.block_frames = int(block_frames)
        self.n_chan = int(n_chan)
        self.block_samples = self.block_frames * self.hop
        if self.block_samples < self.nfft - self.hop:
            raise ValueError(
                "block_frames * hop must be >= nfft - hop (the emitted "
                "block must cover the overlap-add carry)"
            )
        self.device = resolve_device(device)
        cdtype = to_torch_dtype(dtype or DEFAULT_DTYPE)
        self._cdtype, self._rdtype = cdtype, cdtype.to_real()
        F = self.nfft // 2 + 1
        self.model, self.n_pass = model, int(n_pass)
        if algo == "online-iss":
            self.taps = 0
            self.state = online_iss_init(F, self.n_chan, cdtype, self.device)
        else:
            self.taps, self.delay = _check_taps(taps, delay)
            if tap_update not in ("solve", "steer"):
                raise ValueError("tap_update must be 'solve' or 'steer'")
            self.tap_update = tap_update
            self.state = online_tiss_init(F, self.n_chan, self.taps, self.delay,
                                          tap_update, cdtype, self.device)

        def scalar(value):
            return torch.tensor(float(value), dtype=self._rdtype, device=self.device)

        self.forget = scalar(forget)
        self.pb_forget = self.forget if pb_forget is None else scalar(pb_forget)
        self.tap_forget = self.forget if tap_forget is None else scalar(tap_forget)
        win = hann(self.nfft)
        self.win = torch.as_tensor(win, dtype=self._rdtype).to(self.device)
        self.win_s = torch.as_tensor(synthesis_window(win, self.hop),
                                     dtype=self._rdtype).to(self.device)
        # tail primed with zeros = the stft_pad front padding, so frame 0
        # of the stream matches frame 0 of the offline pipeline
        D = self.nfft - self.hop
        self.tail = torch.zeros((D, self.n_chan), dtype=self._rdtype, device=self.device)
        self.carry = torch.zeros((D, self.n_chan), dtype=self._rdtype, device=self.device)
        self._numpy_out = True

    def _step(self, X, state):
        if self.algo == "online-iss":
            return online_iss_step(X, state, self.forget, self.model, self.n_pass,
                                   pb_forget=self.pb_forget)
        return online_tiss_step(X, state, self.forget, self.taps, self.delay, self.model,
                                self.n_pass, pb_forget=self.pb_forget,
                                tap_update=self.tap_update, tap_forget=self.tap_forget)

    def process(self, x_blk):
        """(block_frames*hop, n_chan) float -> same-shape separated block
        (delayed by nfft - hop samples; see the class docstring)."""
        if not isinstance(x_blk, torch.Tensor):
            x_blk = np.asarray(x_blk)
        if tuple(x_blk.shape) != (self.block_samples, self.n_chan):
            raise ValueError(
                f"block must be ({self.block_samples}, {self.n_chan}) "
                f"(block_frames*hop samples), got {tuple(x_blk.shape)}"
            )
        self._numpy_out = not isinstance(x_blk, torch.Tensor)
        x = as_tensor(x_blk, self._rdtype, self.device)
        emit, self.tail, self.carry, self.state = _stream_step(
            x, self.tail, self.carry, self.state, self._step, self.nfft, self.hop,
            self.win, self.win_s,
        )
        return _output(emit, self._numpy_out)

    def flush(self):
        """Drain the held-back overlap-add tail (nfft - hop samples) at
        stream end: NumPy after a NumPy block, else a tensor."""
        out = _output(self.carry, self._numpy_out)
        self.carry = torch.zeros_like(self.carry)
        return out

    def warmup(self) -> None:
        """Run one throwaway zero block, so that the first real block does
        not pay the first call's set-up (FFT plans, the allocator's first
        blocks) inside its latency budget. Safe mid-stream: the state,
        tail and carry are put back afterwards (a step never writes into
        the tensors it is given)."""
        snap = (self.state, self.tail, self.carry, self._numpy_out)
        self.process(torch.zeros((self.block_samples, self.n_chan), dtype=self._rdtype,
                                 device=self.device))
        self.state, self.tail, self.carry, self._numpy_out = snap

    def save(self, path, **meta):
        """Persist the full stream state (online statistics + framing tail
        + overlap-add carry) to ``path`` (npz), in the JAX package's
        layout. Returns the written path."""
        host = state_to_numpy(self.state)
        for k, v in (("tail", self.tail), ("carry", self.carry)):
            if k in host:
                raise ValueError(f"core state already has a {k!r} key")
            host[k] = v.cpu().numpy()
        meta.setdefault("class", type(self).__name__)
        meta.setdefault("algo", self.algo)
        return save_state(path, host, **meta)

    def restore(self, path) -> dict:
        """Resume a stream saved by :meth:`save` (by this package or the
        JAX package); keys and shapes must match the constructor's
        configuration. Returns the checkpoint metadata."""
        host, meta = load_state(path)
        current = {**self.state, "tail": self.tail, "carry": self.carry}
        new = restored_state(host, current, self._cdtype, self.device)
        self.tail, self.carry = new.pop("tail"), new.pop("carry")
        self.state = new
        return meta
