"""PyTorch port: the algorithm registry against the JAX package's.

The same 30 names with the same flags, ``min_src``, defaults and batch
presence (introspection, no JAX run); every name dispatches through
``__call__`` and ``run_batch`` on a 3-mic mixture on the CPU; each spec's
call is the direct ``api`` call bit for bit; the joint family's names
against the JAX registry at complex128, their ``-df`` tier against the
f64 oracle on the complex64-rounded input; ``device`` reaches every
runner.
"""

import numpy as np
import pytest
import torch

from overiva_tpu import oracle as joracle
from overiva_tpu import registry as jreg
from overiva_tpu_torch import api as tapi
from overiva_tpu_torch import registry as treg

from helpers import make_mixture, stft_mixture

C128 = np.complex128
FLAGS = ("determined", "single_output", "min_src", "defaults")


@pytest.fixture(scope="module")
def X33():
    rng = np.random.default_rng(23)
    mix, _, _ = make_mixture(rng, n_src=3, n_mics=3, n_samples=4000, n_taps=6, snr_db=25)
    return stft_mixture(mix, 128).astype(np.complex64)  # (T=33, F=65, M=3)


def test_same_names_flags_and_defaults():
    assert set(treg.ALGORITHMS) == set(jreg.ALGORITHMS)
    assert len(treg.ALGORITHMS) == 30
    for name, spec in treg.ALGORITHMS.items():
        jspec = jreg.ALGORITHMS[name]
        for flag in FLAGS:
            assert getattr(spec, flag) == getattr(jspec, flag), (name, flag)
        assert (spec.batch is None) == (jspec.batch is None), name
        assert spec.name == name
    for n_src in range(4):
        for n_chan in range(1, 5):
            for name in treg.ALGORITHMS:
                assert treg.applicable(name, n_src, n_chan) == jreg.applicable(name, n_src, n_chan)
    with pytest.raises(ValueError, match="unknown algorithm"):
        treg.get_algorithm("fastica")


def _small_kw(spec):
    kw = {"device": "cpu"}
    if "n_iter" in spec.defaults:
        kw["n_iter"] = min(spec.defaults["n_iter"], 40 if spec.single_output else 3)
    if "warm_iter" in spec.defaults:
        kw["warm_iter"] = 2
    if spec.name == "sparseauxiva":
        kw["lasso_iter"] = 20
    return kw


@pytest.mark.parametrize("name", sorted(jreg.ALGORITHMS))
def test_every_name_dispatches(X33, name):
    """``__call__`` and ``run_batch`` of each name on the CPU: the
    documented shapes, finite, each batch element its single-clip run
    (the batch forms that fold mixtures into the bin axis round alike)."""
    X = X33
    T, F, M = X.shape
    spec = treg.get_algorithm(name)
    n_src = next(n for n in (1, 2, 3) if treg.applicable(name, n, M))
    kw = _small_kw(spec)
    Y = spec(X, n_src=n_src, **kw)
    assert isinstance(Y, np.ndarray) and Y.shape == (T, F, n_src), (name, Y.shape)
    assert np.isfinite(Y).all(), name
    Xb = np.stack([X, X[::-1]])
    Yb = spec.run_batch(Xb, n_src=n_src, **kw)
    assert Yb.shape == (2, T, F, n_src) and np.isfinite(Yb).all(), name
    if name != "sparseauxiva":  # its batch form refuses all-bins subsets
        tol = 1e-3 if name.startswith("fastmnmf") else 1e-4  # complex64 rounding
        np.testing.assert_allclose(Yb[0], Y, atol=tol * np.abs(Y).max(), err_msg=name)


@pytest.mark.parametrize("name", ["auxiva-gauss", "overiva-iss-gauss", "tiss-gauss",
                                  "tip", "tip-df", "ilrma-t", "ogive-mix", "auxiva_pca-ip2",
                                  "overiva-gauss-df"])
def test_spec_call_is_the_api_call(X33, name):
    """The spec fills in its defaults and its model/acc, and nothing else."""
    spec = treg.get_algorithm(name)
    kw = _small_kw(spec)
    n_src = next(n for n in (1, 2, 3) if treg.applicable(name, n, 3))
    direct = {**spec.defaults, **kw}
    if "gauss" in name:
        direct["model"] = "gauss"
    if name.endswith("-df"):
        direct["acc"] = "f32x2"
    fn = {"auxiva-gauss": tapi.auxiva, "overiva-iss-gauss": tapi.overiva_iss,
          "tiss-gauss": tapi.tiss, "tip": tapi.tip, "tip-df": tapi.tip,
          "ilrma-t": tapi.ilrma_t, "ogive-mix": tapi.ogive, "auxiva_pca-ip2": tapi.auxiva_pca,
          "overiva-gauss-df": tapi.overiva}[name]
    if not spec.single_output:
        direct["n_src"] = n_src
    np.testing.assert_array_equal(spec(X33, n_src=n_src, **kw), fn(X33, **direct))


@pytest.mark.parametrize("name", ["tiss", "tiss-gauss", "tip", "tip-gauss", "ilrma-t"])
def test_joint_names_match_jax_registry_c128(X33, name):
    X = X33.astype(C128)
    kw = dict(n_iter=3, warm_iter=2) if name.startswith("tip") else dict(n_iter=4)
    n_src = 3 if name == "ilrma-t" else 2
    Yt = treg.get_algorithm(name)(X, n_src=n_src, dtype=C128, device="cpu", **kw)
    Yj = jreg.get_algorithm(name)(X, n_src=n_src, dtype=C128, **kw)
    np.testing.assert_allclose(Yt, Yj, rtol=1e-6, atol=1e-8)
    Ybt = treg.get_algorithm(name).run_batch(np.stack([X, 0.5 * X]), n_src=n_src, dtype=C128,
                                             device="cpu", **kw)
    Ybj = jreg.get_algorithm(name).run_batch(np.stack([X, 0.5 * X]), n_src=n_src, dtype=C128,
                                             **kw)
    np.testing.assert_allclose(Ybt, Ybj, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("name", ["tiss-df", "tip-df"])
def test_joint_df_names_match_f64_oracle(X33, name):
    """complex128 on the complex64-rounded input: within 1e-6 of the JAX
    package's f64 oracle there, as its double-float tier is; the batch is
    a loop of single runs."""
    kw = dict(taps=1, delay=1, n_iter=2)
    if name == "tip-df":
        kw["warm_iter"] = 1
    spec = treg.get_algorithm(name)
    Y = spec(X33, n_src=2, device="cpu", **kw)
    Yo = getattr(joracle, name[:-3])(X33.astype(C128), n_src=2, **kw)
    assert Y.dtype == np.complex64
    assert np.abs(Y - Yo).max() / np.abs(Yo).max() < 1e-6
    Yb = spec.run_batch(np.stack([X33, X33]), n_src=2, device="cpu", **kw)
    np.testing.assert_array_equal(Yb[0], Y)
    np.testing.assert_array_equal(Yb[1], Y)


def test_device_reaches_every_runner(X33, monkeypatch):
    """A tensor batch stays a tensor on its device through the per-element
    loop; without a card a NumPy batch with no ``device`` raises rather
    than run on the CPU unasked."""
    spec = treg.get_algorithm("tiss-df")
    Yb = spec.run_batch(torch.from_numpy(np.stack([X33, X33])), n_src=2, n_iter=2)
    assert isinstance(Yb, torch.Tensor) and Yb.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("tiss-df", "overiva-gauss-df", "tiss", "ilrma-t"):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            treg.get_algorithm(name).run_batch(X33[None], n_src=3, n_iter=1)
    assert treg.get_algorithm("tip").run_batch(X33[None], n_src=2, n_iter=1, warm_iter=1,
                                               device="cpu").shape == (1, *X33.shape[:2], 2)
