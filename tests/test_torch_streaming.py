"""PyTorch port: the serving tier's StreamingSeparator (samples in,
samples out, framing and overlap-add with the stream state) against the
JAX package on the CPU.

Gates (tests/test_serving.py): against the JAX StreamingSeparator and
against the port's STFT-domain class plus offline synthesis of the same
frames, at rtol 1e-8, atol 1e-10 of the largest sample (complex128);
``warmup()`` mid-stream changes no later block; ``save``/``restore``
resumes bit for bit, across packages at the complex128 gate; ``flush``,
the block-shape and configuration errors.
"""

import numpy as np
import pytest
import torch

from overiva_tpu.serving import StreamingSeparator as JStreamingSeparator
from overiva_tpu_torch import api as tapi
from overiva_tpu_torch.serving import StreamingSeparator

from helpers import make_mixture

NFFT, HOP, BF = 128, 64, 8
BLK = BF * HOP
C128 = np.complex128
ALGOS = [("online-iss", {}), ("online-tiss", {"taps": 2, "delay": 1})]


@pytest.fixture(scope="module")
def mixture():
    rng = np.random.default_rng(7)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=3, n_samples=4000)
    return mix[: (mix.shape[0] // BLK) * BLK]


def _sep(cls, algo, kw, **extra):
    return cls(algo, n_chan=3, nfft=NFFT, hop=HOP, block_frames=BF, forget=0.97, n_pass=2,
               dtype=C128, **kw, **extra)


def _run(sep, x, lo=0, hi=None):
    hi = x.shape[0] // BLK if hi is None else hi
    return [sep.process(x[i * BLK : (i + 1) * BLK]) for i in range(lo, hi)]


def _close(got, want):
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10 * scale)


@pytest.mark.parametrize("algo,kw", ALGOS)
def test_matches_jax(mixture, algo, kw):
    jsep = _sep(JStreamingSeparator, algo, kw)
    sep = _sep(StreamingSeparator, algo, kw, device="cpu")
    want = np.concatenate(_run(jsep, mixture) + [jsep.flush()])
    got = np.concatenate(_run(sep, mixture) + [sep.flush()])
    assert got.shape == want.shape == (mixture.shape[0] + NFFT - HOP, 3)
    _close(got, want)


@pytest.mark.parametrize("algo,kw", ALGOS)
def test_matches_offline_synthesis(mixture, algo, kw):
    sep = _sep(StreamingSeparator, algo, kw, device="cpu")
    y_stream = np.concatenate(_run(sep, mixture) + [sep.flush()])
    xp = np.concatenate([np.zeros((NFFT - HOP, 3)), mixture])
    X = tapi.stft_analysis(xp, NFFT, HOP, dtype=C128, device="cpu")
    cls = tapi.OnlineAuxIVAISS if algo == "online-iss" else tapi.OnlineTISS
    ref = cls(X.shape[1], 3, forget=0.97, n_pass=2, dtype=C128, device="cpu", **kw)
    Y = np.concatenate([ref.process(X[i * BF : (i + 1) * BF])
                        for i in range(mixture.shape[0] // BLK)])
    _close(y_stream, tapi.stft_synthesis(Y, NFFT, HOP, dtype=C128, device="cpu"))


def test_warmup_and_checkpoint(mixture, tmp_path):
    kw = {"taps": 2, "delay": 1}
    want = _run(_sep(StreamingSeparator, "online-tiss", kw, device="cpu"), mixture, 0, 4)
    sep = _sep(StreamingSeparator, "online-tiss", kw, device="cpu")
    sep.warmup()
    got = _run(sep, mixture, 0, 2)
    sep.warmup()
    path = sep.save(tmp_path / "stream", note="midpoint")
    got += _run(sep, mixture, 2, 4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    sep2 = _sep(StreamingSeparator, "online-tiss", kw, device="cpu")
    meta = sep2.restore(path)
    assert meta == {"note": "midpoint", "class": "StreamingSeparator", "algo": "online-tiss"}
    for a, b in zip(_run(sep2, mixture, 2, 4), want[2:]):
        np.testing.assert_array_equal(a, b)
    assert sep2.tail.dtype == sep2.carry.dtype == torch.float64
    # flush drains the carry once
    assert np.abs(sep2.flush()).max() > 0 and np.abs(sep2.flush()).max() == 0
    bad = StreamingSeparator("online-tiss", n_chan=2, nfft=NFFT, hop=HOP, block_frames=BF,
                             taps=2, delay=1, dtype=C128, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        bad.restore(path)
    with pytest.raises(ValueError, match="keys"):
        _sep(StreamingSeparator, "online-iss", {}, device="cpu").restore(path)


def test_jax_checkpoint_resumes(mixture, tmp_path):
    jsep = _sep(JStreamingSeparator, "online-iss", {})
    _run(jsep, mixture, 0, 3)
    jsep.save(tmp_path / "j.npz")
    sep = _sep(StreamingSeparator, "online-iss", {}, device="cpu")
    assert sep.restore(tmp_path / "j.npz")["algo"] == "online-iss"
    n = mixture.shape[0] // BLK
    _close(np.concatenate(_run(sep, mixture, 3, n) + [sep.flush()]),
           np.concatenate(_run(jsep, mixture, 3, n) + [jsep.flush()]))


def test_blocks_and_configuration(mixture, monkeypatch):
    sep = StreamingSeparator("online-iss", n_chan=3, nfft=NFFT, hop=HOP, block_frames=BF,
                             device="cpu")
    with pytest.raises(ValueError, match="block must be"):
        sep.process(mixture[: BLK - 1])
    with pytest.raises(ValueError, match="block must be"):
        sep.process(mixture[:BLK, :2])
    y = sep.process(torch.from_numpy(mixture[:BLK]))
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float32 and y.shape == (BLK, 3)
    assert isinstance(sep.flush(), torch.Tensor)  # a tensor stream flushes a tensor
    assert isinstance(sep.process(mixture[:BLK]), np.ndarray)
    with pytest.raises(ValueError, match="unknown streaming algo"):
        StreamingSeparator("overiva", device="cpu")
    with pytest.raises(ValueError, match="nfft - hop"):
        StreamingSeparator(nfft=512, hop=128, block_frames=2, device="cpu")
    with pytest.raises(ValueError, match="tap_update"):
        StreamingSeparator("online-tiss", tap_update="newton", device="cpu")
    with pytest.raises(ValueError, match="delay >= 1"):
        StreamingSeparator("online-tiss", taps=2, delay=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        StreamingSeparator()
