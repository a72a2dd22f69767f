"""PyTorch port: FIVE and OGIVE against the JAX package on the CPU.

Parity gates (complex128): FIVE rtol 1e-4 (tests/test_five.py); OGIVE
rtol 1e-5 over 80 epochs in each update mode, inside the horizon where
its chaotic gradient iteration keeps float64 trajectories together
(tests/test_jax_parity.py). The early exit stops at the JAX package's
epoch, per mixture in a batch, and the host reads ``done`` once per chunk
of epochs, never once per epoch.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from overiva_tpu import api as japi
from overiva_tpu.models import ogive as jogive
from overiva_tpu_torch import api as tapi
from overiva_tpu_torch.models import ogive as togive
from overiva_tpu_torch.utils.convert import state_to_numpy, state_to_torch

from helpers import make_mixture, stft_mixture

C128 = np.complex128
# stops within the horizon where float64 trajectories agree: 41 epochs on
# the first three mics, 31 on the last three (switching, step 0.05)
EXIT = {"step_size": 0.05, "tol": 5.8e-3, "update": "switching"}


@pytest.fixture(scope="module")
def X4():
    """4 mics, 2 sources, nfft 128 (F=65, T=126)."""
    rng = np.random.default_rng(81)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=4, n_samples=8000, snr_db=20)
    return stft_mixture(mix, nfft=128)


@pytest.mark.parametrize("model", ["laplace", "gauss"])
def test_five_matches_jax(X4, model):
    Yt, wt = tapi.five(X4, n_iter=5, model=model, return_filters=True, dtype=C128,
                       device="cpu")
    Yj, wj = japi.five(X4, n_iter=5, model=model, return_filters=True, dtype=C128)
    assert Yt.shape == (X4.shape[0], X4.shape[1], 1) and wt.shape == X4.shape[1:]
    np.testing.assert_allclose(Yt, Yj, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(wt, wj, rtol=1e-4, atol=1e-6)  # unwhitened filters
    snaps_t, snaps_j = [], []
    tapi.five(X4, n_iter=3, callback=snaps_t.append, dtype=C128, device="cpu")
    japi.five(X4, n_iter=3, callback=snaps_j.append, dtype=C128)
    assert len(snaps_t) == len(snaps_j) == 3
    for a, b in zip(snaps_t, snaps_j):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_five_batch_matches_jax_and_per_clip(X4):
    Xb = np.stack([X4[:60], X4[50:110]])
    Yt = tapi.five_batch(Xb, n_iter=4, dtype=C128, device="cpu")
    Yj = japi.five_batch(Xb, n_iter=4, dtype=C128)
    assert Yt.shape == (2, 60, X4.shape[1], 1)
    np.testing.assert_allclose(Yt, Yj, rtol=1e-4, atol=1e-6)
    for b in range(2):
        Y1 = tapi.five(Xb[b], n_iter=4, dtype=C128, device="cpu")
        np.testing.assert_allclose(Yt[b], Y1, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("update", ["demix", "mix", "switching"])
def test_ogive_matches_jax(X4, update):
    kw = dict(n_iter=80, step_size=0.05, tol=1e-4, update=update, return_filters=True)
    Yt, wt = tapi.ogive(X4, dtype=C128, device="cpu", **kw)
    Yj, wj = japi.ogive(X4, dtype=C128, **kw)
    assert Yt.shape == (X4.shape[0], X4.shape[1], 1) and wt.shape == X4.shape[1:]
    np.testing.assert_allclose(wt, wj, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(Yt, Yj, rtol=1e-5, atol=1e-7)


def _jax_epochs(X, n_iter, step_size, tol, update):
    Xd = jnp.asarray(X)
    w, a, Cx, Cx_inv = jogive.ogive_init(Xd, False)
    out = jogive.ogive_iterations(
        Xd, w, a, jnp.zeros((X.shape[1],), bool), Cx, Cx_inv, jnp.asarray(0, jnp.int32),
        jnp.asarray(step_size), jnp.asarray(tol), n_iter, "laplace", update,
    )
    return int(out[3]), bool(out[4])


def test_ogive_early_exit_epoch_and_host_reads(X4, monkeypatch):
    """The run stops at the JAX package's epoch, and the host reads
    ``done`` ceil(epochs / chunk) times: once a chunk, so a read per epoch
    would fail this count."""
    X = X4[:, :, :3]
    epochs, done = _jax_epochs(X, 200, **EXIT)
    assert done and 33 <= epochs <= 80, epochs
    for chunk in (togive.CHUNK, 8):
        monkeypatch.setattr(togive, "CHUNK", chunk)
        Xt = torch.from_numpy(X)
        w, a, Cx, Cx_inv = togive.ogive_init(Xt, False)
        togive.ogive_iterations.done_reads = 0
        out = togive.ogive_iterations(
            Xt, w, a, torch.zeros(X.shape[1], dtype=torch.bool), Cx, Cx_inv,
            torch.zeros((), dtype=torch.int32), torch.zeros((), dtype=torch.bool),
            torch.tensor(EXIT["step_size"], dtype=torch.float64),
            torch.tensor(EXIT["tol"], dtype=torch.float64), 200, "laplace",
            EXIT["update"],
        )
        assert int(out[3]) == epochs and bool(out[4])
        assert togive.ogive_iterations.done_reads == math.ceil(epochs / chunk)
    # the entry point: the same stop, the same filters as the JAX package
    monkeypatch.undo()
    togive.ogive_iterations.done_reads = 0
    Yt, wt = tapi.ogive(X, n_iter=200, return_filters=True, dtype=C128, device="cpu", **EXIT)
    assert togive.ogive_iterations.done_reads == math.ceil(epochs / togive.CHUNK)
    _, wj = japi.ogive(X, n_iter=200, return_filters=True, dtype=C128, **EXIT)
    np.testing.assert_allclose(wt, wj, rtol=1e-5, atol=1e-7)


def test_ogive_callback_chunks_match_jax(X4):
    """The JAX package's gate: as many callback chunks as its run, with a
    break on convergence (tests/test_jax_parity.py)."""
    nt, nj = [], []
    tapi.ogive(X4[:, :, :3], n_iter=200, callback=nt.append, callback_every=10,
               dtype=C128, device="cpu", **EXIT)
    japi.ogive(X4[:, :, :3], n_iter=200, callback=nj.append, callback_every=10,
               dtype=C128, **EXIT)
    assert len(nt) == len(nj) == 5
    for a, b in zip(nt, nj):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_ogive_batch_per_mixture_exit(X4):
    """Each mixture of a batch stops at its own single-clip epoch (JAX
    batch, JAX single, port single) and gives its single-clip output."""
    Xb = np.stack([X4[:, :, :3], X4[:, :, 1:]])
    Yt, et = tapi.ogive_batch(Xb, n_iter=200, return_epochs=True, dtype=C128,
                              device="cpu", **EXIT)
    Yj, ej = japi.ogive_batch(Xb, n_iter=200, return_epochs=True, dtype=C128, **EXIT)
    assert Yt.shape == (2, X4.shape[0], X4.shape[1], 1)
    singles = [_jax_epochs(Xb[b], 200, **EXIT)[0] for b in range(2)]
    assert list(et) == list(ej) == singles and singles[0] != singles[1], (et, ej, singles)
    np.testing.assert_allclose(Yt, Yj, rtol=1e-5, atol=1e-7)
    for b in range(2):
        Y1 = tapi.ogive(Xb[b], n_iter=200, dtype=C128, device="cpu", **EXIT)
        np.testing.assert_allclose(Yt[b], Y1, rtol=1e-9, atol=1e-12)
    Yd, ed = tapi.ogive_batch(torch.from_numpy(Xb), n_iter=5, return_epochs=True)
    assert isinstance(Yd, torch.Tensor) and Yd.dtype == torch.complex64
    assert ed.tolist() == [5, 5]


def test_jax_state_continued_in_the_port(X4):
    """40 JAX epochs, the state handed over through utils/convert, 40 more
    in the port: JAX's 80-epoch state at complex128."""
    Xd = jnp.asarray(X4)
    w, a, Cx, Cx_inv = jogive.ogive_init(Xd, False)
    mu, tol = jnp.asarray(0.05), jnp.asarray(0.0)

    def jrun(state, n):
        return jogive.ogive_iterations(Xd, *state[:3], Cx, Cx_inv, state[3], mu, tol, n,
                                       "laplace", "switching")

    start = (w, a, jnp.zeros((X4.shape[1],), bool), jnp.asarray(0, jnp.int32))
    s40 = jrun(start, 40)
    s80 = jrun(start, 80)
    names = ("w", "a", "use_mix", "epoch", "done")
    st = state_to_torch(
        {**dict(zip(names, map(np.asarray, s40))), "X": X4, "Cx": np.asarray(Cx),
         "Cx_inv": np.asarray(Cx_inv)}, "cpu", C128,
    )
    assert st["use_mix"].dtype == torch.bool and not st["epoch"].is_floating_point()
    out = togive.ogive_iterations(
        st["X"], st["w"], st["a"], st["use_mix"], st["Cx"], st["Cx_inv"], st["epoch"],
        st["done"], torch.tensor(0.05, dtype=torch.float64),
        torch.tensor(0.0, dtype=torch.float64), 40, "laplace", "switching",
    )
    back = state_to_numpy(dict(zip(names, out)))
    np.testing.assert_allclose(back["w"], np.asarray(s80[0]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(back["a"], np.asarray(s80[1]), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(back["use_mix"], np.asarray(s80[2]))
    assert int(back["epoch"][0]) == int(s80[3]) == 80 and not back["done"][0]


def test_validation_probes():
    X = np.zeros((8, 5, 3), dtype=np.complex64)
    with pytest.raises(ValueError, match="update mode"):
        tapi.ogive(X, update="bogus", device="cpu")
    with pytest.raises(ValueError, match="update mode"):
        tapi.ogive_batch(X[None], update="bogus", device="cpu")
    with pytest.raises(ValueError, match="source model"):
        tapi.ogive(X, model="bogus", device="cpu")
    with pytest.raises(ValueError, match="source model"):
        tapi.five(X, model="bogus", device="cpu")
    with pytest.raises(ValueError, match="B, T, F, M"):
        tapi.five_batch(X, device="cpu")
