"""PyTorch port on a CUDA card: the hand-written kernels (``wcov_packed``,
``update_rows``) against their plain versions, and the main path, the
fused epoch, the ISS, IP2, FIVE and OGIVE families, the per-(t,f)-weighted
and joint families, the streaming classes and the clip-serving
``Separator`` on the card against the same on the CPU (the streaming
blocks and a Separator clip also without a host sync), and the parallel
tier: gloo ranks sharing the card, one NCCL rank, ``Separator(mesh=...)``
launch counts, and the FastMNMF whitening start's card-vs-CPU spread.

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


def _stream(sep, X, B):
    return torch.cat([torch.as_tensor(sep.process(X[s : s + B]))
                      for s in range(0, X.shape[0], B)])


@pytest.mark.parametrize(
    "cls,kw",
    [
        ("OnlineAuxIVAISS", {"forget": 0.97, "n_pass": 2, "pb_forget": 0.9995}),
        ("OnlineAuxIVAISS", {"forget": 0.9, "ramp": True, "model": "gauss"}),
        ("OnlineTISS", {"taps": 3, "delay": 2, "n_pass": 2}),
        ("OnlineTISS", {"taps": 2, "delay": 1, "tap_update": "steer", "tap_forget": 0.99}),
        ("OnlineWPE", {"taps": 4, "delay": 2}),
    ],
)
def test_online_classes_on_card_match_cpu(cuda, cls, kw):
    """complex128: the streaming classes on the card against the same
    stream on the CPU, outputs and state on the card, no kernel launch."""
    X, _ = _separable_mixture(21, T=96, F=33, M=3, N=3)
    X[2:] += 0.4 * X[:-2]  # a delayed echo for the taps
    counts = (twp.wcov_packed.launches, tur.update_rows.launches)
    sep = getattr(api, cls)(33, 3, dtype=np.complex128, device=cuda, **kw)
    Y_gpu = _stream(sep, torch.from_numpy(X).to(cuda), 16)
    assert Y_gpu.device.type == "cuda" and all(v.is_cuda for v in sep.state.values())
    assert (twp.wcov_packed.launches, tur.update_rows.launches) == counts
    Y_cpu = _stream(getattr(api, cls)(33, 3, dtype=np.complex128, device="cpu", **kw),
                    torch.from_numpy(X), 16).numpy()
    err = np.abs(Y_gpu.cpu().numpy() - Y_cpu).max() / np.abs(Y_cpu).max()
    assert err <= 1e-9, err


def test_online_blocks_never_sync_the_host(cuda):
    """A tensor-in block of OnlineAuxIVAISS, OnlineTISS (both tap updates)
    and OnlineWPE runs under torch.cuda.set_sync_debug_mode("error")."""
    X, _ = _separable_mixture(22, T=64, F=33, M=3, N=3)
    Xd = torch.from_numpy(X.astype(np.complex64)).to(cuda)
    for sep in (api.OnlineAuxIVAISS(33, 3, n_pass=2, ramp=True, device=cuda),
                api.OnlineTISS(33, 3, taps=2, n_pass=2, device=cuda),
                api.OnlineTISS(33, 3, taps=2, tap_update="steer", device=cuda),
                api.OnlineWPE(33, 3, taps=3, device=cuda)):
        sep.process(Xd[:16])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for s in range(16, 64, 16):
                sep.process(Xd[s : s + 16])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


@pytest.mark.parametrize("algo,kw", [("online-iss", {}), ("online-tiss", {"taps": 2, "delay": 1})])
def test_streaming_separator_on_card_matches_offline(cuda, algo, kw):
    """StreamingSeparator on the card (complex128) against the STFT-domain
    class plus offline synthesis of the same frames, also on the card
    (rtol 1e-8, atol 1e-10 of the largest sample); a tensor block stays on
    the card and runs without a host sync."""
    from overiva_tpu_torch.serving import StreamingSeparator

    nfft, hop, bf = 128, 64, 8
    blk = bf * hop
    x = np.random.default_rng(23).standard_normal((6 * blk, 3))
    x[1:] += 0.5 * x[:-1]
    sep = StreamingSeparator(algo, n_chan=3, nfft=nfft, hop=hop, block_frames=bf, forget=0.97,
                             n_pass=2, dtype=np.complex128, device=cuda, **kw)
    y = np.concatenate([sep.process(x[i * blk : (i + 1) * blk]) for i in range(6)]
                       + [sep.flush()])
    xp = np.concatenate([np.zeros((nfft - hop, 3)), x])
    X = api.stft_analysis(torch.from_numpy(xp).to(cuda), nfft, hop, dtype=np.complex128)
    cls = api.OnlineAuxIVAISS if algo == "online-iss" else api.OnlineTISS
    ref = cls(X.shape[1], 3, forget=0.97, n_pass=2, dtype=np.complex128, device=cuda, **kw)
    y_ref = api.stft_synthesis(_stream(ref, X, bf), nfft, hop, dtype=np.complex128)
    y_ref = y_ref.cpu().numpy()
    np.testing.assert_allclose(y, y_ref, rtol=1e-8, atol=1e-10 * np.abs(y_ref).max())
    xt = torch.from_numpy(x[:blk]).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = sep.process(xt)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.is_cuda and out.shape == (blk, 3)


# the serving tier's clip path: one case per fused branch (the CPU tests'
# cases, tests/test_torch_serving.py). The branches through the library
# eigh (FIVE's whitening and filter, the PCA basis) are held at the
# card-against-CPU gate of test_family_on_card_matches_cpu's eigh rows
SERVE_CASES = [
    ("overiva", 2, {}, 1e-9),
    ("overiva-ip2", 2, {}, 1e-9),
    ("auxiva-iss", None, {}, 1e-9),
    ("auxiva_pca", 2, {}, 1e-7),
    ("auxiva_pca-iss", 2, {}, 1e-7),
    ("five", None, {}, 1e-7),
    ("tiss", 2, {"taps": 2, "delay": 1}, 1e-9),
    ("tip", 2, {"taps": 2, "delay": 1, "warm_iter": 2}, 1e-9),
]


def _serve_clip(seed, n=4000, M=3):
    """A convolutive 2-source mixture at M mics, (n, M) float64."""
    rng = np.random.default_rng(seed)
    src = rng.laplace(size=(2, n)) * np.where(rng.random((2, n // 250 + 1)) < 0.5, 1.0, 0.1
                                              ).repeat(250, axis=1)[:, :n]
    H = rng.standard_normal((M, 2, 6))
    H[:, :, 0] += 2.0 * np.sign(H[:, :, 0])
    mix = np.stack([sum(np.convolve(src[k], H[m, k])[:n] for k in range(2)) for m in range(M)])
    return mix.T + 1e-3 * rng.standard_normal((n, M))


@pytest.mark.parametrize("algo,n_src,kw,tol", SERVE_CASES, ids=[c[0] for c in SERVE_CASES])
def test_separator_on_card_matches_cpu(cuda, algo, n_src, kw, tol):
    """complex128: each fused branch of Separator on the card against the
    same Separator on the CPU; no update_rows launch."""
    from overiva_tpu_torch.serving import Separator

    x = _serve_clip(24)
    args = dict(n_src=n_src, nfft=128, hop=64, n_iter=4, dtype=np.complex128, **kw)
    before = tur.update_rows.launches
    sep = Separator(algo, device=cuda, **args)
    got = sep.separate(x)
    want = Separator(algo, device="cpu", **args).separate(x)
    assert sep.stats["frames_padded"] > 0 and tur.update_rows.launches == before
    np.testing.assert_allclose(got, want, rtol=tol, atol=1e-12 * np.abs(want).max())


def test_separator_bf16pack_launches(cuda):
    """wcov_packed runs once an epoch for each clip: n_iter for one clip,
    n_iter x B for a bf16pack group of B (clip by clip); never under f32,
    and update_rows never."""
    from overiva_tpu_torch.serving import Separator

    x = _serve_clip(25)
    kw = dict(n_src=2, nfft=128, n_iter=5, device=cuda)
    counts = (twp.wcov_packed.launches, tur.update_rows.launches)
    y = Separator("overiva", wcov="bf16pack", **kw).separate(x)
    assert (twp.wcov_packed.launches, tur.update_rows.launches) == (counts[0] + 5, counts[1])
    sep = Separator("overiva", wcov="bf16pack", **kw)
    outs = sep.separate_batch([x, x[:3700], x[:2000]])
    assert (twp.wcov_packed.launches, tur.update_rows.launches) == (counts[0] + 20, counts[1])
    np.testing.assert_array_equal(outs[0], y)
    assert np.isfinite(y).all() and sep.n_buckets() == 2
    Separator("overiva", **kw).separate_batch([x, x[:3700]])
    Separator("overiva-ip2", wcov="bf16pack", **kw).separate(x)
    assert (twp.wcov_packed.launches, tur.update_rows.launches) == (counts[0] + 25, counts[1])


def test_separator_never_syncs_the_host(cuda):
    """A tensor clip on the card, float or int16 PCM in and out, f32 and
    bf16pack: no host sync between the upload and the download."""
    from overiva_tpu_torch.serving import Separator

    x = _serve_clip(26)
    x16 = np.clip(np.round(x / np.abs(x).max() * 20000), -32768, 32767).astype(np.int16)
    for clip, extra in ((x, {}), (x, {"wcov": "bf16pack"}), (x16, {"out_dtype": np.int16})):
        sep = Separator("overiva", n_src=2, nfft=128, n_iter=3, device=cuda, **extra)
        xt = torch.from_numpy(clip if clip.dtype == np.int16 else clip.astype(np.float32)).to(cuda)
        sep.separate(xt)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = sep.separate(xt)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert y.is_cuda and y.shape == (clip.shape[0], 2)
        assert y.dtype == (torch.int16 if "out_dtype" in extra else torch.float32)
        np.testing.assert_array_equal(y.cpu().numpy(), sep.separate(clip))


# ------------------------------------------------------ the parallel tier

def test_parallel_gloo_ranks_share_one_card(cuda):
    """Four gloo ranks on cuda:0 (NCCL refuses two ranks on one card): the
    sharded families on meshes (2, 2) and (1, 4) at complex128 equal the
    single-device runs on the card, each rank making the JAX epochs' count
    of collectives."""
    from overiva_tpu_torch.parallel import dryrun
    from overiva_tpu_torch.parallel.launch import launch

    X = dryrun.tiny_batch(2, 2)
    names = ("overiva", "ogive", "fastmnmf2", "sparseauxiva", "online_tiss")
    outs = launch(dryrun.rank_families, 4, ([(2, 2), (1, 4)], X, "cuda", names),
                  device_type="cuda", backend="gloo", timeout=300)
    for shape in ((2, 2), (1, 4)):
        for name in names:
            Y, calls = outs[0][shape, name]
            assert [o[shape, name][1] for o in outs] == [
                dryrun.expected_collectives(name, X.shape[0] // shape[0])] * 4
            assert dryrun.check_family(Y, X, name, cuda) <= 1.0, (shape, name)


def test_parallel_nccl_one_rank(cuda):
    """A 1 x 1 mesh on NCCL: sharded_overiva equals api.overiva on the card."""
    from overiva_tpu_torch.parallel import dryrun
    from overiva_tpu_torch.parallel.launch import launch

    X = dryrun.tiny_batch(1, 1)
    out = launch(dryrun.rank_families, 1, ([(1, 1)], X, "cuda", ("overiva",)),
                 device_type="cuda", timeout=300)[0]
    assert dryrun.check_family(out[(1, 1), "overiva"][0], X, "overiva", cuda) <= 1.0


def test_separator_mesh_bf16pack_launches(cuda):
    """Separator(mesh=(4, 1), wcov="bf16pack") on four gloo ranks on the
    card: each rank launches wcov_packed once an epoch for each clip it
    runs (the pad lane included), never update_rows, and every clip
    equals the meshless bf16pack run on the card."""
    from overiva_tpu_torch.parallel import dryrun
    from overiva_tpu_torch.parallel.launch import launch
    from overiva_tpu_torch.serving import Separator

    clips = dryrun.serve_clips()  # two buckets: 3 + 2 clips -> lanes 4 + 4
    kw = dict(dtype=np.complex64, n_iter=5, wcov="bf16pack")
    outs = launch(dryrun.rank_serving, 4, (4, "cuda", clips), kw, device_type="cuda",
                  backend="gloo", timeout=300)
    refs = Separator("overiva", n_src=2, nfft=128, device=cuda, **kw).separate_batch(clips)
    for ys, _, launches in outs:
        assert launches == dict(wcov_packed=5 * 2, update_rows=0)
        for y, r in zip(ys, refs):
            np.testing.assert_allclose(y, r, rtol=0, atol=1e-5 * np.abs(r).max())


def test_fastmnmf_whitening_eigh_card_vs_cpu(cuda):
    """The cause of the complex64 FastMNMF misses on the card (ROADMAP
    Queue 3): the whitening start's ``eigh`` (cuSOLVER on the card, LAPACK
    on the CPU) agrees to rounding in complex128 and leaves complex64
    rounding far behind in complex64 on parity_check's seed-7 scene."""
    from overiva_tpu_torch import oracle
    from overiva_tpu_torch.examples.parity_check import build_mixture
    from overiva_tpu_torch.models import fastmnmf2 as mn

    mix, _ = build_mixture(7)
    X = torch.from_numpy(oracle.analysis(oracle.stft_pad(mix, 1024, 512), 1024, 512))[None]

    def rel(dtype):
        Xu, _ = mn.unit_power(X.to(dtype))
        a, b = mn.whiten_q(Xu.to(cuda)).cpu(), mn.whiten_q(Xu)
        return float((a - b).abs().max() / b.abs().max())

    assert rel(torch.complex128) < 1e-9
    assert rel(torch.complex64) > 1e3 * 2.0**-23


def test_entry_on_card_matches_cpu(cuda):
    """``entry()`` runs on the card by default; its W is the CPU's within
    the complex64 tolerance chip_smoke.py holds it to."""
    from overiva_tpu_torch.entry import entry

    fn, args = entry()
    assert all(a.device.type == "cuda" and a.dtype == torch.complex64 for a in args)
    fn_cpu, args_cpu = entry(device="cpu")
    W, W_cpu = fn(*args).cpu(), fn_cpu(*args_cpu)
    assert float((W - W_cpu).abs().max() / W_cpu.abs().max()) <= 2e-6


def test_fastmnmf_rotation_control_on_card(cuda):
    """The rotation control of ``examples/fastmnmf_stages.py`` on the card,
    complex128, on 16 bins of parity_check's seed-7 scene: from each
    rotated start the card lands on the CPU's images (which
    tests/test_torch_fastmnmf_rotation.py holds to the JAX package's), and
    every rotation moves them."""
    from overiva_tpu_torch.examples import fastmnmf_stages as stages

    _, _, X64 = stages.parity_scene(7)
    X = torch.from_numpy(np.ascontiguousarray(X64[:, 100:116]))
    for tie_g in (True, False):
        Xu, scale, starts, _ = stages.rotation_starts(X, tie_g)
        ref = None
        for label, st in starts.items():
            Yc = stages.run_from(Xu, scale, st, torch.device("cpu"), 4)
            Yd = stages.run_from(Xu, scale, st, cuda, 4)
            norm = np.abs(Yc).max()
            assert np.abs(Yd - Yc).max() <= 1e-9 * norm, (tie_g, label)
            if ref is None:
                ref = Yc
            elif label.startswith("rotation"):
                assert np.abs(Yc - ref).max() > 1e-3 * norm, (tie_g, label)
