"""PyTorch port: package boundary — no JAX import, lazy exports, device
resolution, state conversion, and a kernel build that fails loudly."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import overiva_tpu_torch
from overiva_tpu_torch import _build
from overiva_tpu_torch.ops import update_rows as tur
from overiva_tpu_torch.ops import wcov_packed as twp
from overiva_tpu_torch.utils.convert import state_to_numpy, state_to_torch

REPO = Path(__file__).resolve().parents[1]


def test_package_never_imports_jax():
    code = (
        "import sys\n"
        "import overiva_tpu_torch\n"
        "from overiva_tpu_torch import api, _build\n"
        "from overiva_tpu_torch.models import auxiva_pca, overiva\n"
        "from overiva_tpu_torch.ops import covariance, linalg, projection, stft\n"
        "from overiva_tpu_torch.ops import update_rows, wcov_packed\n"
        "from overiva_tpu_torch.utils import convert\n"
        "assert overiva_tpu_torch.overiva is api.overiva\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 0, proc.stderr


def test_lazy_exports_and_device_resolution():
    from overiva_tpu_torch import api

    for name in ("overiva", "auxiva", "separate", "stft_analysis", "stft_synthesis",
                 "projection_back", "pca", "auxiva_pca", "overiva_batch",
                 "stft_analysis_batch", "stft_synthesis_batch"):
        assert getattr(overiva_tpu_torch, name) is getattr(api, name)
    with pytest.raises(AttributeError):
        overiva_tpu_torch.not_a_function  # noqa: B018
    resolve = overiva_tpu_torch.resolve_device
    assert resolve("cpu").type == "cpu"
    assert resolve(None, torch.zeros(1)).type == "cpu"
    want = "cuda" if torch.cuda.is_available() else "cpu"
    assert resolve().type == want


def test_state_conversion_round_trip():
    rng = np.random.default_rng(0)
    state = {
        "W_hat": rng.standard_normal((5, 3, 3)) + 1j * rng.standard_normal((5, 3, 3)),
        "Cx": rng.standard_normal((5, 3, 3)).astype(np.complex64),
    }
    t = state_to_torch(state, "cpu", np.complex128)
    assert all(v.dtype == torch.complex128 for v in t.values())
    back = state_to_numpy(t)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k])
    t64 = state_to_torch(state, "cpu")  # default complex64
    assert t64["W_hat"].dtype == torch.complex64
    with pytest.raises(ValueError, match="dtype"):
        state_to_torch(state, "cpu", "int7")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No toolkit: a clear error, and the kernel path does not fall back to
    the plain version."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_ROOTS", (str(tmp_path),))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build_library()
        xr = torch.zeros((3, 2, 4), dtype=torch.bfloat16)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            twp._launch(xr, xr.clone(), torch.ones((4, 1)))
        X = torch.zeros((4, 3, 2), dtype=torch.complex64)
        W = torch.zeros((3, 2, 2), dtype=torch.complex64)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tur._launch(torch.ones((4, 1)), X, W, W, 1)
    finally:
        _build.library.cache_clear()


def test_launch_validation():
    """The kernel wrapper refuses what the kernel does not take, before
    any build."""
    xr = torch.zeros((3, 2, 4), dtype=torch.bfloat16)
    phi = torch.ones((4, 1))
    with pytest.raises(ValueError, match="bfloat16"):
        twp._launch(xr.float(), xr.float(), phi)
    with pytest.raises(ValueError, match="phi"):
        twp._launch(xr, xr, torch.ones((5, 1)))
    big = torch.zeros((1, 33, 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="threads"):
        twp._launch(big, big, phi)
    with pytest.raises(ValueError, match="contiguous"):
        twp._launch(xr.transpose(0, 1), xr.transpose(0, 1), torch.ones((4, 1)))
    with pytest.raises(ValueError, match="cpu or cuda"):
        twp.wcov_packed((xr.to("meta"), xr.to("meta")), phi.to("meta"), 4)
