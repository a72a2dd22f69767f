"""PyTorch port: covariances and the packed bf16 weighted covariance
against the JAX package, including the Pallas kernel in interpret mode.

Tolerances: the plain ``wcov_packed_reference`` and the Pallas kernel round
the same operands to bf16 and differ only in f32 summation order (measured
~2e-7 max|V|), hence 1e-5 max|V|. The f32 covariances at complex128 are
exact up to f64 summation order, hence 1e-10. The CUDA kernel against the
plain version is in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from overiva_tpu import api as japi
from overiva_tpu.ops import covariance as jcov
from overiva_tpu.ops.pallas_wcov import pack_planes as jpack
from overiva_tpu.ops.pallas_wcov import wcov_packed as jwcov_packed
from overiva_tpu_torch import api as tapi
from overiva_tpu_torch.ops import covariance as tcov
from overiva_tpu_torch.ops import wcov_packed as twp


def _inputs(seed, T, F, M, K, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))).astype(dtype)
    phi = (rng.random((T, K)) + 0.1).astype(np.float32 if dtype == np.complex64 else np.float64)
    return X, phi


@pytest.mark.parametrize(
    "f,m,K,T",
    [
        (40, 4, 3, 64), (40, 8, 3, 64), (129, 4, 3, 64), (129, 8, 3, 64),
        # the shapes the CUDA kernel's tensor-core route takes at its edges:
        # all 8 sources in one pass with a ragged T, and one source at M=2
        (129, 8, 8, 77), (40, 2, 1, 16),
    ],
    ids=["40-4", "40-8", "129-4", "129-8", "K8-M8-T77", "K1-M2-T16"],
)
def test_wcov_packed_matches_pallas_interpret(f, m, K, T):
    X, phi = _inputs(3, T, f, m, K)
    Vj = np.asarray(
        jwcov_packed(jpack(jnp.asarray(X)), jnp.asarray(phi), f, T, interpret=True)
    )
    V16 = np.asarray(jcov.weighted_covariance_all(jnp.asarray(X), jnp.asarray(phi), "bf16"))
    Vt = twp.wcov_packed(twp.pack_planes(torch.from_numpy(X)), torch.from_numpy(phi), T)
    assert Vt.shape == (K, f, m, m) and Vt.dtype == torch.complex64
    scale = np.abs(Vj).max()
    np.testing.assert_allclose(Vt.numpy(), Vj, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(Vt.numpy(), V16, rtol=0, atol=1e-5 * scale)
    # the port's XLA-tier twin agrees too
    Vb = tcov.weighted_covariance_all(torch.from_numpy(X), torch.from_numpy(phi), "bf16")
    np.testing.assert_allclose(Vb.numpy(), V16, rtol=0, atol=1e-5 * scale)


def test_pack_planes_layout():
    X, _ = _inputs(5, 16, 33, 8, 1)
    xr, xi = twp.pack_planes(torch.from_numpy(X))
    assert xr.shape == xi.shape == (33, 8, 16) and xr.dtype == torch.bfloat16
    assert xr.is_contiguous() and xi.is_contiguous()
    np.testing.assert_array_equal(
        xr[5, 3].float().numpy(),
        torch.from_numpy(X[:, 5, 3].real.copy()).to(torch.bfloat16).float().numpy(),
    )
    np.testing.assert_array_equal(
        xi[7, 1].float().numpy(),
        torch.from_numpy(X[:, 7, 1].imag.copy()).to(torch.bfloat16).float().numpy(),
    )


def test_wrapper_on_cpu_takes_the_plain_version():
    X, phi = _inputs(6, 24, 9, 4, 2)
    xpack = twp.pack_planes(torch.from_numpy(X))
    before = twp.wcov_packed.launches
    V = twp.wcov_packed(xpack, torch.from_numpy(phi), 24)
    vr, vi = twp.wcov_packed_reference(*xpack, torch.from_numpy(phi))
    assert twp.wcov_packed.launches == before == 0
    assert torch.equal(V, torch.complex(vr, vi) / 24)


@pytest.mark.parametrize("chunk", [None, 7, 32])
def test_f32_covariances_match_jax(chunk):
    X, phi = _inputs(7, 30, 11, 5, 3, np.complex128)
    Xt, pt = torch.from_numpy(X), torch.from_numpy(phi)
    np.testing.assert_allclose(
        tcov.covariance(Xt).numpy(), np.asarray(jcov.covariance(jnp.asarray(X))), atol=1e-10
    )
    Vj = jcov.weighted_covariance_all(jnp.asarray(X), jnp.asarray(phi), "f32", chunk=chunk)
    Vt = tcov.weighted_covariance_all(Xt, pt, "f32", chunk=chunk)
    np.testing.assert_allclose(Vt.numpy(), np.asarray(Vj), atol=1e-10)
    w_tf = np.abs(X[:, :, 0])
    np.testing.assert_allclose(
        tcov.weighted_covariance_tf(Xt, torch.from_numpy(w_tf)).numpy(),
        np.asarray(jcov.weighted_covariance_tf(jnp.asarray(X), jnp.asarray(w_tf))),
        atol=1e-10,
    )
    np.testing.assert_allclose(
        tcov.weighted_covariance_chunked(Xt, pt[:, 0], chunk=chunk or 8).numpy(),
        np.asarray(jcov.weighted_covariance_chunked(jnp.asarray(X), jnp.asarray(phi[:, 0]), chunk or 8)),
        atol=1e-10,
    )


def test_bf16pack_scope_guards():
    """bf16pack exists only on the IP epoch path, without chunking, as in
    the JAX package; f32x3 runs (the exact f32 tier here)."""
    X, phi = _inputs(8, 16, 5, 2, 2)
    Xt, pt = torch.from_numpy(X), torch.from_numpy(phi)
    with pytest.raises(ValueError, match="bf16pack"):
        tcov.weighted_covariance_all(Xt, pt, "bf16pack", chunk=8)
    with pytest.raises(ValueError, match="bf16pack"):
        tcov.weighted_covariance_tf(Xt, pt[:, :1].expand(16, 5), "bf16pack")
    with pytest.raises(ValueError, match="bf16pack"):
        tcov.weighted_covariance_chunked(Xt, pt[:, 0], wcov="bf16pack")
    with pytest.raises(ValueError, match="bf16pack"):
        tapi.overiva(X, n_src=2, wcov="bf16pack", chunk_frames=8, device="cpu")
    with pytest.raises(ValueError, match="bf16pack"):
        japi.overiva(X, n_src=2, wcov="bf16pack", chunk_frames=8)
    Y3 = tapi.overiva(X, n_src=2, n_iter=1, wcov="f32x3", device="cpu")
    np.testing.assert_array_equal(Y3, tapi.overiva(X, n_src=2, n_iter=1, device="cpu"))
    with pytest.raises(ValueError, match="wcov"):
        tapi.overiva(X, n_src=2, wcov="f16", device="cpu")
