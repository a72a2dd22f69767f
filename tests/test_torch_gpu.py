"""PyTorch port on a CUDA card: the hand-written kernels (``wcov_packed``,
``update_rows``) against their plain versions, and the main path, the
fused epoch and the ISS, IP2, FIVE and OGIVE families on the card against
the same on the CPU.

Every test here needs a card and skips without one. This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from overiva_tpu_torch import api
from overiva_tpu_torch.models import overiva as core
from overiva_tpu_torch.ops import update_rows as tur
from overiva_tpu_torch.ops import wcov_packed as twp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed, T, F, M, K):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))
    phi = rng.random((T, K)) + 0.1
    return torch.from_numpy(X.astype(np.complex64)), torch.from_numpy(phi.astype(np.float32))


def _wcov_cases():
    """Both routes of the kernel: the tensor-core warp kernel at M in
    {1, 2, 5, 8} and the block kernel at M in {12, 32}, each with K in
    {1, 3, 8}; T in {1, 15, 16, 77, 128, 512} and F in {1, 129, 2049} in
    turn, and every fourth case on planes that start at an odd element
    offset (2-byte loads)."""
    cases, i = [], 0
    for M in (1, 2, 5, 8, 12, 32):
        for K in (1, 3, 8):
            T = (1, 15, 16, 77, 128, 512)[(i + i // 6) % 6]
            F = (1, 129, 2049)[(i + i // 3) % 3] if M <= 8 else (1, 129)[i % 2]
            cases.append((K, F, M, T, i % 4 == 3))
            i += 1
    return cases


def _at_odd_offset(plane):
    """The same values, contiguous, one element into a larger buffer."""
    buf = torch.zeros(plane.numel() + 1, dtype=plane.dtype, device=plane.device)
    buf[1:] = plane.reshape(-1)
    out = buf[1:].view(plane.shape)
    assert out.is_contiguous() and out.data_ptr() % 4 == 2
    return out


@pytest.mark.parametrize(
    "K,F,M,T,odd",
    [
        (3, 2049, 8, 128, False), (3, 2049, 8, 512, False), (2, 129, 5, 77, False),
        (1, 3, 32, 200, False), (3, 2049, 8, 128, True), *_wcov_cases(),
        # two source groups (K > 8), several staged tiles of phi, and a
        # long clip (the tensor cores' truncating sums are flushed often)
        (10, 129, 8, 1100, False), (10, 7, 3, 600, True), (3, 129, 8, 4096, False),
        (8, 7, 8, 4096, True),
    ],
)
def test_kernel_matches_plain(cuda, K, F, M, T, odd):
    """Same bf16 operands, f32 accumulation in another order: 1e-5 max|V|.
    One launch a call, complex64 (K, F, M, M) divided by T."""
    X, phi = _inputs(F + T + M, T, F, M, K)
    xr, xi = twp.pack_planes(X.to(cuda))
    if odd:
        xr, xi = _at_odd_offset(xr), _at_odd_offset(xi)
    phic = phi.to(cuda)
    before = twp.wcov_packed.launches
    V = twp.wcov_packed((xr, xi), phic, T)
    torch.cuda.synchronize()
    assert twp.wcov_packed.launches == before + 1
    assert V.dtype == torch.complex64 and V.shape == (K, F, M, M)
    V_plain = torch.complex(*twp.wcov_packed_reference(xr, xi, phic)) / T
    scale = V_plain.abs().max().item()
    assert (V - V_plain).abs().max().item() <= 1e-5 * scale
    # the plain version on the card equals the one on the CPU up to order
    V_cpu = twp.wcov_packed(twp.pack_planes(X), phi, T)
    assert (V.cpu() - V_cpu).abs().max().item() <= 1e-5 * scale


def test_kernel_refuses_bad_inputs(cuda):
    X, phi = _inputs(1, 16, 4, 4, 2)
    xr, xi = twp.pack_planes(X.to(cuda))
    phic = phi.to(cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        twp.wcov_packed((xr.float(), xi.float()), phic, 16)
    with pytest.raises(ValueError, match="contiguous"):
        twp.wcov_packed((xr.transpose(0, 1), xi.transpose(0, 1)), phic, 16)
    with pytest.raises(ValueError, match="one device"):
        twp.wcov_packed((xr, xi), phi, 16)
    with pytest.raises(ValueError, match="n_frames"):
        twp.wcov_packed((xr, xi), phic, 0)
    big = torch.zeros((2, 33, 4), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="threads"):
        twp.wcov_packed((big, big), torch.ones((4, 1), device=cuda), 4)


def _update_state(seed, M, N, F, T, device):
    """Random X and phi, with W and Cx prepared as ``api.overiva`` prepares
    them, all on ``device``."""
    X, phi = _inputs(seed, T, F, M, N)
    X, phi = X.to(device), phi.to(device)
    W, Cx = core.prepare(X, N, False)
    return phi, X, Cx.contiguous(), W.contiguous()


def _warp_kernel_cases():
    """Every specialisation M = 2..8 of the warp-per-bin kernel with
    N in {1, ceil(M/2), M}; F not a multiple of the bins per block (7, 129,
    2049) and T not a multiple of the staged chunk (77, 160, 512), in turn."""
    cases, i = [], 0
    for M in range(2, 9):
        for N in sorted({1, -(-M // 2), M}):
            cases.append((M, N, (7, 129, 2049)[i % 3], (77, 160, 512)[(i // 3) % 3]))
            i += 1
    return cases


@pytest.mark.parametrize(
    "M,N,F,T",
    [
        (8, 3, 2049, 128), (8, 3, 2049, 512), (2, 2, 129, 77), (5, 2, 129, 77),
        (8, 8, 129, 77), (7, 4, 129, 100), *_warp_kernel_cases(),
        # the block-per-bin kernel (9 <= M <= 32)
        (16, 16, 9, 96), (32, 5, 7, 160),
    ],
)
def test_update_rows_kernel_matches_plain(cuda, M, N, F, T):
    """f32 sums in another order, amplified by the condition of W V:
    1e-4 max|W|. Each call on the card is one launch."""
    phi, X, Cx, W = _update_state(F + T + M, M, N, F, T, cuda)
    before = tur.update_rows.launches
    W_k = tur.update_rows(phi, X, Cx, W, N)
    torch.cuda.synchronize()
    assert tur.update_rows.launches == before + 1
    W_p = tur.update_rows_reference(phi, X, Cx, W, N)
    assert tur.update_rows.launches == before + 1  # the plain version never counts
    assert torch.isfinite(W_k).all()
    assert (W_k - W_p).abs().max().item() <= 1e-4 * W_p.abs().max().item()


def test_update_rows_kernel_unaligned_input(cuda):
    """A contiguous X that does not start on a 16-byte boundary takes the
    8-byte staging copies and gives the same update."""
    phi, X, Cx, W = _update_state(9, 8, 3, 129, 77, cuda)
    base = torch.zeros(X.numel() + 1, dtype=X.dtype, device=cuda)
    base[1:] = X.reshape(-1)
    X_odd = base[1:].view(X.shape)
    assert X_odd.is_contiguous() and X_odd.data_ptr() % 16 != 0
    W_k = tur.update_rows(phi, X_odd, Cx, W, 3)
    W_p = tur.update_rows_reference(phi, X, Cx, W, 3)
    assert (W_k - W_p).abs().max().item() <= 1e-4 * W_p.abs().max().item()


def _knife_state(M, N, cuda):
    """Bins 0-3 silent, bins 4-7 rank 1, the rest healthy (F=129, T=77)."""
    rng = np.random.default_rng(M * 10 + N)
    T, F = 77, 129
    X = rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))
    X[:, :4] = 0
    X[:, 4:8] = rng.standard_normal((T, 4, 1)) * rng.standard_normal((1, 4, M))
    X = torch.from_numpy(X.astype(np.complex64)).to(cuda)
    phi = torch.from_numpy((rng.random((T, N)) + 0.1).astype(np.float32)).to(cuda)
    W, Cx = core.prepare(X, N, False)
    return phi, X, Cx.contiguous(), W.contiguous()


@pytest.mark.parametrize("M,N", [(8, 3), (4, 4)])
def test_update_rows_kernel_knife_edge_decisions(cuda, M, N):
    """Silent and rank-1 bins: the kernel keeps the same rows and zeroes the
    same OC bins as the plain version, and stays finite."""
    phi, X, Cx, W = _knife_state(M, N, cuda)
    W_k = tur.update_rows(phi, X, Cx, W, N)
    W_p = tur.update_rows_reference(phi, X, Cx, W, N)
    assert torch.isfinite(W_k).all()
    kept_k = (W_k[:, :N] == W[:, :N]).all(dim=-1)
    kept_p = (W_p[:, :N] == W[:, :N]).all(dim=-1)
    assert torch.equal(kept_k, kept_p)
    assert kept_k[:4].all()  # silent bins: the previous rows, exactly
    zero_k = (W_k[:, N:, :N] == 0).flatten(1).all(dim=1)
    zero_p = (W_p[:, N:, :N] == 0).flatten(1).all(dim=1)
    assert torch.equal(zero_k, zero_p)
    if N < M:
        assert zero_k[:4].all()  # dead OC solve: J = 0
    healthy = slice(8, None)
    assert (W_k[healthy] - W_p[healthy]).abs().max().item() <= 1e-4 * W_p.abs().max().item()


def test_update_rows_refuses_bad_inputs(cuda):
    phi, X, Cx, W = _update_state(2, 4, 2, 16, 8, cuda)
    with pytest.raises(ValueError, match="complex64 only"):
        tur.update_rows(phi, X.to(torch.complex128), Cx, W, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tur.update_rows(phi, X, Cx, W.transpose(1, 2), 2)
    with pytest.raises(ValueError, match="one device"):
        tur.update_rows(phi.cpu(), X, Cx, W, 2)
    big = torch.zeros((16, 33, 33), dtype=torch.complex64, device=cuda)
    X33 = torch.zeros((8, 16, 33), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="M <= 32"):
        tur.update_rows(phi, X33, big, big, 2)
    with pytest.raises(ValueError, match="phi must be"):
        tur.update_rows(phi[:, :1], X, Cx, W, 2)


def test_fused_epoch_on_card_matches_cpu(cuda):
    """complex64, 5 epochs of demix -> phi -> the fused kernel on the card
    against the same epochs on the CPU (the plain version)."""
    _, X, Cx, W = _update_state(4, 5, 2, 65, 64, "cpu")
    Wc, Xc, Cxc = W.to(cuda), X.to(cuda), Cx.to(cuda)
    before = tur.update_rows.launches
    for _ in range(5):
        W = core._fused_epoch(X, W, Cx, 2, "laplace")
        Wc = core._fused_epoch(Xc, Wc, Cxc, 2, "laplace")
    assert tur.update_rows.launches == before + 5
    assert (Wc.cpu() - W).abs().max().item() <= 1e-4 * W.abs().max().item()


def test_main_path_on_card_matches_cpu(cuda):
    """complex128 f32-tier run: the card and the CPU agree to rounding;
    bf16pack launches the kernel once per epoch and lands near the f32 run."""
    rng = np.random.default_rng(5)
    T, F, M = 64, 65, 5
    X = rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))
    Y_gpu = api.overiva(torch.from_numpy(X).to(cuda), n_src=2, n_iter=8, dtype=np.complex128)
    Y_cpu = api.overiva(X, n_src=2, n_iter=8, dtype=np.complex128, device="cpu")
    np.testing.assert_allclose(Y_gpu.cpu().numpy(), Y_cpu, rtol=1e-9, atol=1e-12)
    before = twp.wcov_packed.launches
    Y_pk = api.overiva(X, n_src=2, n_iter=8, wcov="bf16pack", device=cuda)
    assert twp.wcov_packed.launches == before + 8
    assert isinstance(Y_pk, np.ndarray) and np.isfinite(Y_pk).all()
    Y32 = api.overiva(X, n_src=2, n_iter=8, device=cuda)
    assert np.linalg.norm(Y_pk - Y32) / np.linalg.norm(Y32) < 3e-2


def _separable_mixture(seed, T=128, F=65, M=5, N=3):
    """N gated complex Laplacian sources, a random mixing matrix A per bin
    and a -40 dB noise floor: (X, A). IP2 separates it."""
    rng = np.random.default_rng(seed)
    gate = np.where(rng.random((T, 1, N)) < 0.5, 1.0, 0.1)
    S = (rng.laplace(size=(T, F, N)) + 1j * rng.laplace(size=(T, F, N))) * gate
    A = rng.standard_normal((F, M, N)) + 1j * rng.standard_normal((F, M, N))
    noise = rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))
    return np.einsum("fmn,tfn->tfm", A, S) + 0.01 * noise, A


def _dominance(W, A):
    """Mean over bins and outputs of max|g|^2 / sum|g|^2 for the global
    system G = W1 A: 1 for a scaled permutation, 1/N for no separation."""
    G = np.abs(W[:, : A.shape[2], :] @ A) ** 2
    return np.mean(G.max(axis=2) / G.sum(axis=2))


def test_ip2_bf16pack_launches_once_an_epoch(cuda):
    """IP2 with bf16pack runs the packed kernel once an epoch for all
    sources (K = n_src), never with f32, and separates as f32 does. (In
    complex64 IP2's pairwise branch makes single bins jump on rounding
    alone, so the check is the separation, as tests/test_bf16.py's is.)"""
    X, A = _separable_mixture(6)
    before = twp.wcov_packed.launches
    Y_pk, W_pk = api.overiva_ip2(X, n_src=3, n_iter=6, wcov="bf16pack", return_filters=True,
                                 device=cuda)
    assert twp.wcov_packed.launches == before + 6
    _, W32 = api.overiva_ip2(X, n_src=3, n_iter=6, return_filters=True, device=cuda)
    assert twp.wcov_packed.launches == before + 6
    assert np.isfinite(Y_pk).all()
    assert _dominance(W32, A) > 0.99
    assert abs(_dominance(W_pk, A) - _dominance(W32, A)) < 1e-3
    api.auxiva_ip2(X[:, :, :4], n_iter=3, wcov="bf16pack", device=cuda)  # K = M = 4
    assert twp.wcov_packed.launches == before + 9


@pytest.mark.parametrize(
    "algo,kw,tol",
    [
        ("overiva_iss", {"n_src": 2, "n_iter": 8}, 1e-9),
        ("auxiva_iss", {"n_iter": 8}, 1e-9),
        ("overiva_ip2", {"n_src": 2, "n_iter": 5}, 1e-9),
        # the library eigh on the card and on the CPU: eigenvectors agree
        # to rounding once their phase is fixed
        ("five", {"n_iter": 5}, 1e-7),
        ("ogive", {"n_iter": 80, "step_size": 0.05, "tol": 0.0, "update": "switching"}, 1e-7),
    ],
)
def test_family_on_card_matches_cpu(cuda, algo, kw, tol):
    """complex128: each family on the card against the same run on the CPU."""
    rng = np.random.default_rng(7)
    T, F, M = 64, 65, 5
    X = rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))
    fn = getattr(api, algo)
    Y_gpu = fn(torch.from_numpy(X).to(cuda), dtype=np.complex128, **kw)
    assert Y_gpu.device.type == "cuda"
    Y_cpu = fn(X, dtype=np.complex128, device="cpu", **kw)
    err = np.abs(Y_gpu.cpu().numpy() - Y_cpu).max() / np.abs(Y_cpu).max()
    assert err <= tol, err


def test_ogive_early_exit_on_card_matches_cpu(cuda):
    """The per-mixture stop on the card is the CPU's, epoch for epoch."""
    rng = np.random.default_rng(8)
    T, F, M = 64, 65, 3
    Xb = rng.standard_normal((2, T, F, M)) + 1j * rng.standard_normal((2, T, F, M))
    Xb[1, :, :, 0] += 3 * Xb[1, :, :, 1]
    kw = {"n_iter": 300, "step_size": 0.05, "tol": 5e-3, "return_epochs": True,
          "dtype": np.complex128}
    Y_gpu, e_gpu = api.ogive_batch(Xb, device=cuda, **kw)
    Y_cpu, e_cpu = api.ogive_batch(Xb, device="cpu", **kw)
    assert e_gpu.tolist() == e_cpu.tolist()
    assert np.abs(Y_gpu - Y_cpu).max() <= 1e-7 * np.abs(Y_cpu).max()


@pytest.mark.parametrize(
    "algo,kw,tol",
    [
        ("ilrma", {"n_iter": 6}, 1e-9),
        # the library eigh of FastMNMF's whitening start, as for FIVE
        ("fastmnmf2", {"n_src": 3, "n_iter": 4}, 1e-7),
        ("fastmnmf", {"n_src": 3, "n_iter": 4, "n_q_sweeps": 2}, 1e-7),
        ("sparseauxiva", {"n_iter": 6, "lasso_iter": 40}, 1e-7),
        ("ilrma_batch", {"n_iter": 4}, 1e-9),
        ("fastmnmf2_batch", {"n_src": 2, "n_iter": 3}, 1e-7),
        ("sparseauxiva_batch", {"n_iter": 4, "lasso_iter": 30}, 1e-7),
    ],
)
def test_tf_family_on_card_matches_cpu(cuda, algo, kw, tol):
    """complex128: ILRMA, FastMNMF1/2 and SparseAuxIVA (and batch forms) on
    the card against the same run on the CPU."""
    rng = np.random.default_rng(9)
    T, F, M = 64, 65, 4
    shape = (2, T, F, M) if algo.endswith("_batch") else (T, F, M)
    X = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    fn = getattr(api, algo)
    Y_gpu = fn(torch.from_numpy(X).to(cuda), dtype=np.complex128, **kw)
    assert Y_gpu.device.type == "cuda"
    Y_cpu = fn(X, dtype=np.complex128, device="cpu", **kw)
    err = np.abs(Y_gpu.cpu().numpy() - Y_cpu).max() / np.abs(Y_cpu).max()
    assert err <= tol, err


def test_separate_fastmnmf_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(10)
    mix = rng.standard_normal((6000, 3))
    for algo in ("fastmnmf", "fastmnmf2"):
        kw = dict(n_src=2, nfft=256, n_iter=4, algo=algo, dtype=np.complex128)
        y_gpu = api.separate(mix, device=cuda, **kw)
        y_cpu = api.separate(mix, device="cpu", **kw)
        assert np.abs(y_gpu - y_cpu).max() <= 1e-7 * np.abs(y_cpu).max()


def test_sparseauxiva_bf16pack_launches(cuda):
    """bf16pack runs the packed kernel once an epoch in both IP phases (the
    subset of F / 4 bins, then the polish over all F), never with f32, nor
    in ILRMA or FastMNMF. (At complex64 the polish after the LASSO
    reconstruction moves a few percent for rounding alone, so the check on
    the numbers is the all-bins run, which is AuxIVA's path.)"""
    X, _ = _separable_mixture(11, M=4, N=4)
    before = twp.wcov_packed.launches
    Y_pk = api.sparseauxiva(X, n_iter=6, polish_iter=3, lasso_iter=40, wcov="bf16pack",
                            device=cuda)
    assert twp.wcov_packed.launches == before + 9
    assert np.isfinite(Y_pk).all()
    api.sparseauxiva(X, n_iter=6, polish_iter=3, lasso_iter=40, device=cuda)
    assert twp.wcov_packed.launches == before + 9
    Y_all = api.sparseauxiva(X, S=np.arange(X.shape[1]), n_iter=4, wcov="bf16pack",
                             device=cuda)
    assert twp.wcov_packed.launches == before + 13  # all bins: no polish
    Y_aux = api.auxiva(X, n_iter=4, wcov="bf16pack", device=cuda)
    assert np.linalg.norm(Y_all - Y_aux) <= 1e-6 * np.linalg.norm(Y_aux)
    before = twp.wcov_packed.launches
    for algo in ("ilrma", "fastmnmf2"):
        getattr(api, algo)(X, n_iter=2, device=cuda)
    assert twp.wcov_packed.launches == before


@pytest.mark.parametrize(
    "algo,kw",
    [
        ("wpe", {"taps": 3, "delay": 2, "n_iter": 2}),
        ("tiss", {"n_src": 2, "taps": 3, "delay": 2, "n_iter": 6}),
        ("tip", {"n_src": 2, "taps": 2, "delay": 2, "n_iter": 3, "warm_iter": 3}),
        ("tip", {"taps": 0, "n_iter": 4}),
        ("ilrma_t", {"taps": 2, "delay": 2, "n_iter": 5}),
        ("wpe_batch", {"taps": 3, "delay": 2, "n_iter": 2}),
        ("tiss_batch", {"n_src": 2, "taps": 2, "delay": 2, "n_iter": 4}),
        ("tip_batch", {"n_src": 2, "taps": 2, "delay": 2, "n_iter": 2, "warm_iter": 2}),
        ("ilrma_t_batch", {"taps": 2, "delay": 2, "n_iter": 4}),
    ],
)
def test_joint_family_on_card_matches_cpu(cuda, algo, kw):
    """complex128: WPE, T-ISS, T-IP, ILRMA-T and their batch forms on the
    card against the same run on the CPU, outputs on the card, and no
    launch of either kernel."""
    rng = np.random.default_rng(12)
    T, F, M = 64, 33, 3
    shape = (2, T, F, M) if algo.endswith("_batch") else (T, F, M)
    X = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    X[..., 2:, :, :] += 0.4 * X[..., :-2, :, :]  # a delayed echo for the taps
    fn = getattr(api, algo)
    counts = (twp.wcov_packed.launches, tur.update_rows.launches)
    Y_gpu = fn(torch.from_numpy(X).to(cuda), dtype=np.complex128, **kw)
    assert Y_gpu.device.type == "cuda"
    assert (twp.wcov_packed.launches, tur.update_rows.launches) == counts
    Y_cpu = fn(X, dtype=np.complex128, device="cpu", **kw)
    err = np.abs(Y_gpu.cpu().numpy() - Y_cpu).max() / np.abs(Y_cpu).max()
    assert err <= 1e-9, err


def test_joint_separate_and_registry_on_card(cuda):
    """separate(algo="tiss"|"tip"|"ilrma_t", wpe=...) and the joint
    registry names (the -df tier included) on the card against the CPU;
    no kernel launch."""
    from overiva_tpu_torch.registry import get_algorithm

    rng = np.random.default_rng(13)
    mix = rng.standard_normal((6000, 3))
    counts = (twp.wcov_packed.launches, tur.update_rows.launches)
    # ILRMA-T at n_src = n_chan: below it, separate keeps the most energetic
    # outputs, and its unit-power renormalization ties their energies to
    # the last bit, so rounding picks them (in the JAX package too)
    for algo, n_src in (("tiss", 2), ("tip", 2), ("ilrma_t", 3)):
        kw = dict(n_src=n_src, nfft=256, n_iter=3, algo=algo, taps=2, delay=1,
                  wpe={"taps": 2, "n_iter": 1}, dtype=np.complex128)
        y_gpu = api.separate(mix, device=cuda, **kw)
        y_cpu = api.separate(mix, device="cpu", **kw)
        assert np.abs(y_gpu - y_cpu).max() <= 1e-8 * np.abs(y_cpu).max(), algo
    X = rng.standard_normal((40, 17, 3)) + 1j * rng.standard_normal((40, 17, 3))
    for name in ("tiss-df", "tip-df", "tip-gauss", "ilrma-t"):
        spec = get_algorithm(name)
        kw = dict(n_iter=2, taps=1, delay=1)
        kw |= {"warm_iter": 1} if name.startswith("tip") else {}
        # the -df tier: complex128 on the complex64-rounded input, complex64 out
        kw |= {} if name.endswith("-df") else {"dtype": np.complex128}
        n_src = 3 if name == "ilrma-t" else 2
        Yb_gpu = spec.run_batch(torch.from_numpy(X[None]).to(cuda), n_src=n_src, **kw)
        assert Yb_gpu.device.type == "cuda"
        Y_cpu = spec(X, n_src=n_src, device="cpu", **kw)
        err = np.abs(Yb_gpu[0].cpu().numpy() - Y_cpu).max() / np.abs(Y_cpu).max()
        assert err <= (1e-6 if name.endswith("-df") else 1e-9), (name, err)
    assert (twp.wcov_packed.launches, tur.update_rows.launches) == counts
