"""The port's public surface against the JAX package's.

Every module of ``overiva_tpu`` has a twin of the same dotted name in
``overiva_tpu_torch`` that carries each of its public names (``__all__``
where the module has one, else its own top-level names), except for what
the port leaves out on purpose (ROADMAP North star). Each name the port
gained last is held against its JAX twin, and ``entry.entry()`` against
``__graft_entry__.entry()``.
"""

from __future__ import annotations

import importlib
import inspect
import pkgutil
import types

import numpy as np
import pytest
import torch

import overiva_tpu

# Modules the port does not carry: TPU workarounds (double-float emulation,
# the bin-minor layout, the float-plane host boundary, the compilation
# cache) and the Pallas kernels, whose work lives in csrc/.
SKIPPED_MODULES = {"ops.df", "ops.fminor", "models.overiva_df", "models.joint_df",
                   "utils.packing", "utils.cache"}
# A JAX matmul precision, and the dead code the port removed.
SKIPPED_NAMES = {"PRECISION", "weighted_covariance", "solve_vec", "solve_mat", "overiva_run"}
# max|port - JAX| / max|JAX| of entry()'s W, complex64 on the CPU:
# measured 4.2e-07 (each 3.4e-07 to 4.8e-07 from complex128)
ENTRY_TOL = 2e-6


def _jax_modules():
    mods = [""]
    for info in pkgutil.walk_packages(overiva_tpu.__path__, "overiva_tpu."):
        rel = info.name[len("overiva_tpu."):]
        if rel in SKIPPED_MODULES or rel.rsplit(".", 1)[-1].startswith("pallas_"):
            continue
        mods.append(rel)
    return mods


def _public_names(mod):
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)
            and getattr(v, "__module__", mod.__name__) == mod.__name__]


@pytest.mark.parametrize("rel", _jax_modules(), ids=lambda r: r or "overiva_tpu")
def test_every_public_name_has_a_twin(rel):
    mod = importlib.import_module("overiva_tpu" + (f".{rel}" if rel else ""))
    twin = importlib.import_module("overiva_tpu_torch" + (f".{rel}" if rel else ""))
    missing = [n for n in _public_names(mod) if n not in SKIPPED_NAMES and not hasattr(twin, n)]
    assert not missing, f"overiva_tpu_torch.{rel} lacks {missing}"


@pytest.mark.parametrize("compute_permutation", [True, False])
def test_bss_eval_images_bit_for_bit(compute_permutation):
    from overiva_tpu.metrics import bss_eval_images as jimages
    from overiva_tpu_torch.metrics import bss_eval_images as timages

    rng = np.random.default_rng(11)
    refs = rng.standard_normal((2, 1500, 3))
    ests = refs[::-1] + 0.1 * rng.standard_normal((2, 1500, 3))
    got = timages(refs, ests, compute_permutation=compute_permutation)
    want = jimages(refs, ests, compute_permutation=compute_permutation)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="matching"):
        timages(refs, ests[:, :, :2])


@pytest.mark.parametrize("path, name", [
    ("", "__version__"), ("version", "__version__"), ("oracle", "MODELS"),
    ("oracle.models", "MODELS"), ("models.source_models", "MODELS"),
])
def test_constants_equal(path, name):
    suffix = f".{path}" if path else ""
    got = getattr(importlib.import_module("overiva_tpu_torch" + suffix), name)
    assert got == getattr(importlib.import_module("overiva_tpu" + suffix), name)


@pytest.mark.parametrize("nfft", [64, 256, 1024, 4096])
def test_n_frames_of_equal(nfft):
    from overiva_tpu.ops.stft import n_frames_of as jframes
    from overiva_tpu_torch.ops.stft import n_frames_of as tframes
    from overiva_tpu_torch.ops.stft import analysis

    for hop in (nfft // 4, nfft // 2, nfft):
        for n in (nfft, nfft + 1, 3 * nfft - 1, 16000, 96000, 260096):
            assert tframes(n, nfft, hop) == jframes(n, nfft, hop)
    n = 5 * nfft + 3
    assert analysis(torch.zeros(n, 2), nfft, nfft // 2).shape[0] == tframes(n, nfft, nfft // 2)


@pytest.mark.parametrize("model", ["laplace", "gauss"])
def test_activations_match_jax(model):
    import jax.numpy as jnp

    from overiva_tpu.models.source_models import activations as jact
    from overiva_tpu_torch.models.source_models import activations as tact

    rng = np.random.default_rng(3)
    Y = rng.standard_normal((40, 17, 3)) + 1j * rng.standard_normal((40, 17, 3))
    Y[5] = 0.0  # a silent frame meets the floors
    for got, want in zip(tact(torch.from_numpy(Y), model), jact(jnp.asarray(Y), model)):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=0)


@pytest.mark.parametrize("module", ["tip", "ilrma_t"])
def test_augment_taps_reexported(module):
    from overiva_tpu_torch.models import tiss

    mod = importlib.import_module(f"overiva_tpu_torch.models.{module}")
    assert mod.augment_taps is tiss.augment_taps and "augment_taps" in mod.__all__


def test_entry_matches_graft_entry():
    """The same example numbers; W of one epoch within ENTRY_TOL."""
    import jax

    import __graft_entry__
    from overiva_tpu_torch.entry import entry

    fn_j, args_j = __graft_entry__.entry()
    fn, args = entry(device="cpu")
    assert all(a.dtype == torch.complex64 and a.device.type == "cpu" for a in args)
    for a, (re, im) in zip(args, zip(args_j[::2], args_j[1::2])):
        assert np.array_equal(a.real.numpy(), re) and np.array_equal(a.imag.numpy(), im)
    re, im = jax.jit(fn_j)(*args_j)
    W_j = np.asarray(re) + 1j * np.asarray(im)
    W = fn(*args)
    assert W.dtype == torch.complex64 and W.shape == W_j.shape
    assert np.abs(W.numpy() - W_j).max() <= ENTRY_TOL * np.abs(W_j).max()
    assert inspect.signature(entry).parameters["device"].default is None


def test_entry_needs_a_device_without_a_card(monkeypatch):
    from overiva_tpu_torch.entry import entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        entry()
