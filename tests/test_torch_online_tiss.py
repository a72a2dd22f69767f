"""PyTorch port: online T-ISS (streaming joint dereverberation and
separation) against the JAX package on the CPU.

Gates (tests/test_online_tiss.py): both tap updates against the JAX class
at complex128, rtol 1e-8, atol 1e-10; ``taps=0`` equal to
OnlineAuxIVAISS exactly (``assert_array_equal``); ``taps=0, delay=0``
constructs and runs; the validation errors; a resumed stream bit for bit,
and a JAX checkpoint continued in the port.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from overiva_tpu import api as japi
from overiva_tpu.models import online_tiss as jonline
from overiva_tpu_torch import api as tapi
from overiva_tpu_torch.models import online_tiss as tonline

from helpers import make_mixture, stft_mixture

C128 = np.complex128
B = 16


@pytest.fixture(scope="module")
def X():
    """2 mics, 2 sources, a 64-tap room, nfft 128: (T=80, F=65, M=2)."""
    rng = np.random.default_rng(7)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=2, n_samples=5200, n_taps=64, snr_db=25)
    X = stft_mixture(mix, nfft=128)
    return X[: (X.shape[0] // B) * B]


def _stream(sep, X, block=B):
    return np.concatenate([sep.process(X[s : s + block]) for s in range(0, X.shape[0], block)])


def _jax_steps(X, kw):
    """The JAX model step over X: the JAX class fixes ``diag_load`` at its
    default, the step takes it."""
    state = jonline.online_tiss_init(X.shape[1], 2, kw["taps"], kw["delay"], "solve",
                                     jnp.complex128)
    outs = []
    for s in range(0, X.shape[0], B):
        Y, state = jonline.online_tiss_step(
            jnp.asarray(X[s : s + B]), state, jnp.asarray(kw["forget"]), kw["taps"],
            kw["delay"], kw["model"], pb_forget=jnp.asarray(kw["pb_forget"]),
            diag_load=kw["diag_load"], tap_forget=jnp.asarray(kw["tap_forget"]))
        outs.append(np.asarray(Y))
    return np.concatenate(outs)


@pytest.mark.parametrize(
    "kw",
    [
        {"taps": 2, "delay": 2, "forget": 0.97, "n_pass": 2},
        {"taps": 3, "delay": 1, "forget": 0.95, "pb_forget": 0.999, "tap_forget": 0.99,
         "diag_load": 1e-3, "model": "gauss"},
        {"taps": 2, "delay": 1, "forget": 0.97, "n_pass": 2, "tap_update": "steer",
         "tap_forget": 0.99},
    ],
)
def test_matches_jax_c128(X, kw):
    if "diag_load" in kw:
        want = _jax_steps(X, kw)
    else:
        want = _stream(japi.OnlineTISS(X.shape[1], 2, dtype=C128, **kw), X)
    sep = tapi.OnlineTISS(X.shape[1], 2, dtype=C128, device="cpu", **kw)
    got = _stream(sep, X)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)
    assert sep.filters.shape == (X.shape[1], 2, 2 + 2 * kw["taps"])


@pytest.mark.parametrize("dtype", [None, C128])
def test_taps0_equals_online_iss(X, dtype):
    s0 = tapi.OnlineTISS(X.shape[1], 2, taps=0, forget=0.97, n_pass=2, dtype=dtype,
                         device="cpu")
    s1 = tapi.OnlineAuxIVAISS(X.shape[1], 2, forget=0.97, n_pass=2, dtype=dtype, device="cpu")
    for s in range(0, X.shape[0], B):
        np.testing.assert_array_equal(s0.process(X[s : s + B]), s1.process(X[s : s + B]))


def test_taps0_delay0_constructs(X):
    sep = tapi.OnlineTISS(X.shape[1], 2, taps=0, delay=0, device="cpu")
    assert sep.state["hist"].shape == (0, X.shape[1], 2)
    assert np.isfinite(sep.process(X[:8])).all()
    # taps=0 with delay 2 keeps one history frame, unused, as the JAX class
    sep = tapi.OnlineTISS(X.shape[1], 2, taps=0, delay=2, device="cpu")
    sep.process(X[:8])
    np.testing.assert_array_equal(sep.state["hist"].numpy(), X[7:8].astype(np.complex64))


def test_validation():
    with pytest.raises(ValueError, match="delay >= 1"):
        tapi.OnlineTISS(65, 2, taps=2, delay=0, device="cpu")
    with pytest.raises(ValueError, match="taps >= 0"):
        tapi.OnlineTISS(65, 2, taps=-1, device="cpu")
    with pytest.raises(ValueError, match="tap_update"):
        tapi.OnlineTISS(65, 2, tap_update="newton", device="cpu")
    with pytest.raises(ValueError, match="source model"):
        tapi.OnlineTISS(65, 2, model="bogus", device="cpu")


@pytest.mark.parametrize("tap_update", ["solve", "steer"])
def test_checkpoint_resume_bit_identical(X, tmp_path, tap_update):
    sep = tapi.OnlineTISS(X.shape[1], 2, taps=2, delay=2, tap_update=tap_update, device="cpu")
    for s in range(0, 3 * B, B):
        sep.process(X[s : s + B])
    path = sep.save(tmp_path / "otiss.npz", note="t")
    sep2 = tapi.OnlineTISS(X.shape[1], 2, taps=2, delay=2, tap_update=tap_update,
                           device="cpu")
    assert sep2.restore(path)["note"] == "t"
    real = {"den", "zd", "t_eff", "tden"} & set(sep2.state)
    assert all(not sep2.state[k].is_complex() for k in real)
    for s in range(3 * B, X.shape[0], B):
        np.testing.assert_array_equal(sep.process(X[s : s + B]), sep2.process(X[s : s + B]))
    other = "steer" if tap_update == "solve" else "solve"
    with pytest.raises(ValueError, match="keys"):
        tapi.OnlineTISS(X.shape[1], 2, taps=2, delay=2, tap_update=other,
                        device="cpu").restore(path)


def test_jax_checkpoint_continues(X, tmp_path):
    kw = dict(taps=2, delay=2, forget=0.97, n_pass=2, dtype=C128)
    jsep = japi.OnlineTISS(X.shape[1], 2, **kw)
    for s in range(0, 2 * B, B):
        jsep.process(X[s : s + B])
    path = jsep.save(tmp_path / "j.npz")
    sep = tapi.OnlineTISS(X.shape[1], 2, device="cpu", **kw)
    sep.restore(path)
    np.testing.assert_allclose(_stream(sep, X[2 * B :]), _stream(jsep, X[2 * B :]),
                               rtol=1e-8, atol=1e-10)


def test_step_never_writes_its_input_state(X):
    lam = torch.tensor(0.97, dtype=torch.float64)
    for mode in ("solve", "steer"):
        state = tonline.online_tiss_init(X.shape[1], 2, 2, 2, mode, torch.complex128)
        _, state = tonline.online_tiss_step(torch.from_numpy(X[:B]), state, lam, 2, 2,
                                            tap_update=mode)
        kept = {k: v.clone() for k, v in state.items()}
        tonline.online_tiss_step(torch.from_numpy(X[B : 2 * B]), state, lam, 2, 2,
                                 n_pass=2, tap_update=mode)
        for k, v in state.items():
            assert torch.equal(v, kept[k]), (mode, k)
