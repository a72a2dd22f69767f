"""PyTorch port: online (streaming) AuxIVA-ISS against the JAX package and
the f64 oracle copy on the CPU, and checkpoints in both directions.

Gates (tests/test_online_iss.py): complex128 against the JAX class and the
oracle copy at rtol 1e-8, atol 1e-10 (the oracle gate of the JAX package);
complex64 within 1e-5 of the largest complex128 output (measured 1.8e-6
for the port and 1.0e-6 for the JAX class on this stream); a resumed
stream bit for bit; a JAX checkpoint continues in the port, and a port
checkpoint in the JAX class, at the complex128 gate.
"""

import numpy as np
import pytest
import torch

from overiva_tpu import api as japi
from overiva_tpu_torch import api as tapi
from overiva_tpu_torch import oracle as toracle
from overiva_tpu_torch.models import online_iss as tonline

from helpers import make_mixture, stft_mixture

C128 = np.complex128
B = 16


@pytest.fixture(scope="module")
def X():
    """2 mics, 2 sources, nfft 256: (T=96, F=129, M=2), whole blocks of 16."""
    rng = np.random.default_rng(11)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=2, n_samples=12500, snr_db=20)
    X = stft_mixture(mix, nfft=256)
    return X[: (X.shape[0] // B) * B]


def _stream(sep, X, block=B):
    return np.concatenate([sep.process(X[s : s + block]) for s in range(0, X.shape[0], block)])


@pytest.mark.parametrize(
    "kw",
    [
        {"forget": 0.97, "n_pass": 2, "pb_forget": 0.9995},
        {"forget": 0.97, "n_pass": 2, "ramp": True, "model": "gauss"},
        {"forget": 0.9, "ramp": True, "pb_forget": 0.99},
    ],
)
def test_matches_jax_c128(X, kw):
    want = _stream(japi.OnlineAuxIVAISS(X.shape[1], 2, dtype=C128, **kw), X)
    sep = tapi.OnlineAuxIVAISS(X.shape[1], 2, dtype=C128, device="cpu", **kw)
    got = _stream(sep, X)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)
    assert got.dtype == C128
    assert sep.filters.shape == (X.shape[1], 2, 2) and np.isfinite(sep.filters).all()


def test_matches_oracle_copy(X):
    """tests/test_online_iss.py::test_online_iss_matches_numpy_oracle, and a
    final partial block (fed as its own block, as the oracle does)."""
    opts = dict(forget=0.97, n_pass=2, pb_forget=0.9995)
    sep = tapi.OnlineAuxIVAISS(X.shape[1], 2, dtype=C128, device="cpu", **opts)
    Xp = X[:-5]
    got = _stream(sep, Xp)
    np.testing.assert_allclose(got, toracle.online_iss_run(Xp, B, **opts), rtol=1e-8,
                               atol=1e-10)


def test_c64_within_the_c64_floor(X):
    kw = {"forget": 0.97, "n_pass": 2}
    ref = _stream(tapi.OnlineAuxIVAISS(X.shape[1], 2, dtype=C128, device="cpu", **kw), X)
    got = _stream(tapi.OnlineAuxIVAISS(X.shape[1], 2, device="cpu", **kw), X)
    want = _stream(japi.OnlineAuxIVAISS(X.shape[1], 2, **kw), X)
    assert got.dtype == want.dtype == np.complex64
    scale = np.abs(ref).max()
    assert np.abs(got - want).max() < 1e-5 * scale
    assert np.abs(got - ref).max() < 1e-5 * scale


def test_checkpoint_resume_bit_identical(X, tmp_path):
    sep = tapi.OnlineAuxIVAISS(X.shape[1], 2, n_pass=2, device="cpu")
    for s in range(0, 3 * B, B):
        sep.process(X[s : s + B])
    path = sep.save(tmp_path / "oiss", note="t")
    sep2 = tapi.OnlineAuxIVAISS(X.shape[1], 2, n_pass=2, device="cpu")
    meta = sep2.restore(path)
    assert meta == {"note": "t", "class": "OnlineAuxIVAISS"}
    for s in range(3 * B, X.shape[0], B):
        np.testing.assert_array_equal(sep.process(X[s : s + B]), sep2.process(X[s : s + B]))
    # the real statistics stay real
    assert sep2.state["den"].dtype == sep2.state["t_eff"].dtype == torch.float32
    with pytest.raises(ValueError, match="shape"):
        tapi.OnlineAuxIVAISS(X.shape[1] + 1, 2, device="cpu").restore(path)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(X, tmp_path, writer):
    """Three blocks in one package, save, restore into the other, stream
    on: the rest matches an uninterrupted JAX stream at the c128 gate."""
    kw = dict(forget=0.97, n_pass=2, pb_forget=0.9995, dtype=C128)
    first = (japi.OnlineAuxIVAISS(X.shape[1], 2, **kw) if writer == "jax"
             else tapi.OnlineAuxIVAISS(X.shape[1], 2, device="cpu", **kw))
    for s in range(0, 3 * B, B):
        first.process(X[s : s + B])
    path = first.save(tmp_path / "ck.npz")
    second = (tapi.OnlineAuxIVAISS(X.shape[1], 2, device="cpu", **kw) if writer == "jax"
              else japi.OnlineAuxIVAISS(X.shape[1], 2, **kw))
    assert second.restore(path)["class"] == "OnlineAuxIVAISS"
    want = _stream(japi.OnlineAuxIVAISS(X.shape[1], 2, **kw), X)[3 * B :]
    np.testing.assert_allclose(_stream(second, X[3 * B :]), want, rtol=1e-8, atol=1e-10)


def test_step_never_writes_its_input_state(X):
    state = tonline.online_iss_init(X.shape[1], 2, torch.complex128)
    _, state = tonline.online_iss_step(torch.from_numpy(X[:B]), state,
                                       torch.tensor(0.97, dtype=torch.float64))
    kept = {k: v.clone() for k, v in state.items()}
    _, new = tonline.online_iss_step(torch.from_numpy(X[B : 2 * B]), state,
                                     torch.tensor(0.97, dtype=torch.float64), n_pass=2)
    for k, v in state.items():
        assert torch.equal(v, kept[k]), k
        assert not torch.equal(new[k], v), k


def test_tensors_in_tensors_out_and_no_quiet_cpu(X, monkeypatch):
    sep = tapi.OnlineAuxIVAISS(X.shape[1], 2, device="cpu")
    Y = sep.process(torch.from_numpy(X[:B]))
    assert isinstance(Y, torch.Tensor) and Y.shape == (B, X.shape[1], 2)
    assert isinstance(sep.process(X[B : 2 * B]), np.ndarray)
    with pytest.raises(ValueError, match="block must be"):
        sep.process(X[:B, :, :1])
    with pytest.raises(ValueError, match="source model"):
        tapi.OnlineAuxIVAISS(X.shape[1], 2, model="bogus", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapi.OnlineAuxIVAISS(X.shape[1], 2)
