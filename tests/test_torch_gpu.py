"""PyTorch port on a CUDA card: the hand-written kernels (``wcov_packed``,
``update_rows``, ``tap_steps``, ``iss_steps``) against their plain versions, and the main path, the
fused epoch, the ISS, IP2, FIVE and OGIVE families, the per-(t,f)-weighted
and joint families, the streaming classes and the clip-serving
``Separator`` on the card against the same on the CPU (the streaming
blocks and a Separator clip also without a host sync), and the parallel
tier: gloo ranks sharing the card, one NCCL rank, ``Separator(mesh=...)``
launch counts, the FastMNMF whitening start's card-vs-CPU spread, the
Monte-Carlo sweep twin batched against serial, and the bench twin's rows;
the ``tiss_batch`` cell's T-ISS group, the chunked batched ``eigh`` and
the tiny T-ISS cell through the benchmark harness.

Every test here needs a card and skips without one. This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from overiva_tpu_torch import api
from overiva_tpu_torch.models import overiva as core
from overiva_tpu_torch.ops import iss_steps as tis
from overiva_tpu_torch.ops import tap_steps as tts
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


@pytest.mark.parametrize("N", [1, 2, 3])
def test_update_rows_kernel_knife_edge_rank1_at_m3(cuda, N):
    """At M=3 the keep-row test of a rank-1 bin sits at its threshold: the
    quadratic form is 1-100 times 4 eps of its terms (at M=4 and 8 it is
    well under 1, and every implementation keeps the row), so rounding
    decides, and the kernel, the plain version on the card, the plain
    version on the CPU and complex128 each keep a different set of those
    rows. How far that goes: only the four rank-1 bins differ; the silent
    bins keep their rows and zero their OC exactly as the plain version
    does; the healthy bins agree at 1e-4 of their own scale; all finite."""
    M = 3
    phi, X, Cx, W = _knife_state(M, N, cuda)
    W_k = tur.update_rows(phi, X, Cx, W, N)
    W_p = tur.update_rows_reference(phi, X, Cx, W, N)
    assert torch.isfinite(W_k).all()
    kept_k = (W_k[:, :N] == W[:, :N]).all(dim=-1)
    kept_p = (W_p[:, :N] == W[:, :N]).all(dim=-1)
    zero_k = (W_k[:, N:, :N] == 0).flatten(1).all(dim=1)
    zero_p = (W_p[:, N:, :N] == 0).flatten(1).all(dim=1)
    rank1 = torch.zeros(X.shape[1], dtype=torch.bool, device=cuda)
    rank1[4:8] = True
    assert torch.equal(kept_k[~rank1], kept_p[~rank1])
    assert torch.equal(zero_k[~rank1], zero_p[~rank1])
    assert kept_k[:4].all()
    if N < M:
        assert zero_k[:4].all()
    healthy = slice(8, None)
    err = (W_k[healthy] - W_p[healthy]).abs().max().item()
    assert err <= 1e-4 * W_p[healthy].abs().max().item()


def _folded_state(seed, B, M, N, F_mix, T, device):
    """B random mixtures of F_mix bins each, folded into the bin axis
    (``fold_mixtures``), phi (T, B, N), W and Cx prepared as
    ``api.overiva_batch`` prepares them."""
    rng = np.random.default_rng(seed)
    Xb = rng.standard_normal((B, T, F_mix, M)) + 1j * rng.standard_normal((B, T, F_mix, M))
    X = core.fold_mixtures(torch.from_numpy(Xb.astype(np.complex64)).to(device)).contiguous()
    phi = torch.from_numpy((rng.random((T, B, N)) + 0.1).astype(np.float32)).to(device)
    W, Cx = core.prepare(X, N, False)
    return phi, X, Cx.contiguous(), W.contiguous()


def _per_mixture(phi, X, Cx, W, N):
    """The kernel on each mixture of a folded state alone, rows stacked."""
    B = phi.shape[1]
    F_mix = X.shape[1] // B
    parts = []
    for b in range(B):
        sl = slice(b * F_mix, (b + 1) * F_mix)
        parts.append(tur.update_rows(phi[:, b].contiguous(), X[:, sl].contiguous(),
                                     Cx[sl].contiguous(), W[sl].contiguous(), N))
    return torch.cat(parts)


@pytest.mark.parametrize(
    "B,M,N,F_mix,T",
    [
        # the batch cell's group (8 rooms of 2049 bins, 56 frames) and a
        # pair: 2049 is not a multiple of the 8 bins of a block, so blocks
        # straddle two mixtures
        (8, 8, 3, 2049, 56), (2, 8, 3, 2049, 128), (2, 3, 2, 129, 77), (8, 3, 3, 13, 40),
        # mixtures narrower than a block: one block spans up to 8 of them
        (3, 5, 2, 3, 33), (8, 8, 3, 1, 20), (8, 2, 1, 2, 17),
        # the block-per-bin kernel (9 <= M <= 32)
        (2, 12, 4, 5, 40), (3, 16, 3, 2, 33),
    ],
)
def test_update_rows_kernel_folded_matches_plain(cuda, B, M, N, F_mix, T):
    """phi (T, B, N): each bin weighted by its own mixture's phi. Against the
    plain folded version at the 1e-4 gate of the one-mixture test, one
    launch a call, and each mixture's bins equal to the kernel run on that
    mixture alone, bit for bit (the same chain on the same values)."""
    phi, X, Cx, W = _folded_state(B * 100 + M + F_mix, B, M, N, F_mix, T, cuda)
    before = tur.update_rows.launches
    W_k = tur.update_rows(phi, X, Cx, W, N)
    torch.cuda.synchronize()
    assert tur.update_rows.launches == before + 1
    W_p = tur.update_rows_reference(phi, X, Cx, W, N)
    assert torch.isfinite(W_k).all()
    assert (W_k - W_p).abs().max().item() <= 1e-4 * W_p.abs().max().item()
    assert torch.equal(W_k, _per_mixture(phi, X, Cx, W, N))


@pytest.mark.parametrize("B,M,N", [(2, 8, 3), (8, 3, 2), (2, 12, 3)])
def test_update_rows_kernel_folded_knife_edge(cuda, B, M, N):
    """Silent and rank-1 bins on both sides of a mixture boundary inside one
    block: the folded kernel stays finite, keeps the previous rows of the
    silent bins and zeroes their OC as the plain folded version does, and
    runs every bin, the rank-1 ones included, as on its mixture alone, bit
    for bit. (A rank-1 bin's keep-row decision rests on rounding noise, so
    it is held to the one-mixture kernel, not to the plain version.)"""
    rng = np.random.default_rng(B * 10 + M)
    T, F_mix = 40, 13
    Xb = rng.standard_normal((B, T, F_mix, M)) + 1j * rng.standard_normal((B, T, F_mix, M))
    Xb[0, :, -3:] = 0  # the last bins of mixture 0 are silent
    Xb[1, :, :2] = 0  # the first bins of mixture 1 are silent
    Xb[1, :, 2:5] = rng.standard_normal((T, 3, 1)) * rng.standard_normal((1, 3, M))  # rank 1
    X = core.fold_mixtures(torch.from_numpy(Xb.astype(np.complex64)).to(cuda)).contiguous()
    phi = torch.from_numpy((rng.random((T, B, N)) + 0.1).astype(np.float32)).to(cuda)
    W, Cx = core.prepare(X, N, False)
    W, Cx = W.contiguous(), Cx.contiguous()
    W_k = tur.update_rows(phi, X, Cx, W, N)
    W_p = tur.update_rows_reference(phi, X, Cx, W, N)
    assert torch.isfinite(W_k).all()
    healthy = torch.ones(X.shape[1], dtype=torch.bool, device=cuda)
    healthy[F_mix - 3 : F_mix + 5] = False
    plain = healthy.clone()
    plain[F_mix - 3 : F_mix + 2] = True  # the silent bins
    kept_k = (W_k[:, :N] == W[:, :N]).all(dim=-1)
    assert torch.equal(kept_k[plain], (W_p[:, :N] == W[:, :N]).all(dim=-1)[plain])
    silent = [F_mix - 3, F_mix - 2, F_mix - 1, F_mix, F_mix + 1]
    assert kept_k[silent].all()  # silent bins: the previous rows, exactly
    zero_k = (W_k[:, N:, :N] == 0).flatten(1).all(dim=1)
    assert torch.equal(zero_k[plain], (W_p[:, N:, :N] == 0).flatten(1).all(dim=1)[plain])
    if N < M:
        assert zero_k[silent].all()  # dead OC solve: J = 0
    err = (W_k[healthy] - W_p[healthy]).abs().max().item()
    assert err <= 1e-4 * W_p.abs().max().item()
    assert torch.equal(W_k, _per_mixture(phi, X, Cx, W, N))


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
    with pytest.raises(ValueError, match="B dividing"):  # 3 mixtures do not split 16 bins
        tur.update_rows(torch.ones((8, 3, 2), device=cuda), X, Cx, W, 2)


# ------------------------------------------------------ the tap-steps kernel

def _tap_state(seed, T, n_mix, F, M, MK, device):
    """An augmented input Xt (T, B*F, M + MK), P (B*F, M, M + MK), Y and
    phi (T, B, M), complex64 / float32 on ``device``."""
    rng = np.random.default_rng(seed)
    BF = n_mix * F

    def cplx(*shape):
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(z.astype(np.complex64)).to(device)

    Xt, P, Y = cplx(T, BF, M + MK), cplx(BF, M, M + MK), cplx(T, BF, M)
    phi = torch.from_numpy((rng.random((T, n_mix, M)) + 0.1).astype(np.float32)).to(device)
    return Xt, P, Y, phi


def _gap(a, b, scale):
    return (a.to(b.dtype) - b).abs().max().item() / scale


@pytest.mark.parametrize(
    "T,n_mix,F,M,MK",
    [
        (192, 8, 513, 8, 40),  # the tiss_batch cell
        (37, 1, 129, 8, 40), (100, 3, 65, 8, 16), (192, 1, 513, 8, 40),
        (192, 2, 129, 2, 10), (77, 1, 129, 3, 15), (192, 1, 129, 8, 1), (64, 2, 33, 5, 10),
        # every compiled frame count: 4, 8, 16 and 32 lanes an output
        (16, 1, 9, 8, 6), (128, 3, 7, 6, 5), (256, 1, 9, 8, 40), (200, 2, 5, 4, 12),
        (128, 1, 9, 4, 7), (256, 1, 9, 2, 3), (256, 1, 9, 1, 9), (1, 1, 3, 8, 2),
    ],
)
def test_tap_steps_kernel_matches_plain(cuda, T, n_mix, F, M, MK):
    """The kernel and the plain version on the card, both complex64,
    against the plain version at complex128: each within 1e-5 of max|P|
    and of max|Y| (the larger of the input's and the result's: at T=1 the
    fit on z_0 cancels Y to rounding noise). The kernel sums over T in
    another order than cuBLAS does, each step's v to ~1e-7 relative, and
    MK sequential steps carry it (~2e-7 to 8e-7 in a host emulation of the
    kernel and on the card); 1e-5 leaves ten times that. One launch a call;
    the inputs are left as they were."""
    Xt, P, Y, phi = _tap_state(T + F + M + MK, T, n_mix, F, M, MK, cuda)
    Z = Xt[:, :, M:]
    inputs = [t.clone() for t in (Xt, P, Y, phi)]
    before = tts.tap_steps.launches
    P_k, Y_k = tts.tap_steps(P, Y, Z, phi, n_mix)
    torch.cuda.synchronize()
    assert tts.tap_steps.launches == before + 1
    P_p, Y_p = tts.tap_steps_reference(P, Y, Z, phi, n_mix)
    assert tts.tap_steps.launches == before + 1  # the plain version never counts
    P_d, Y_d = tts.tap_steps_reference(*(t.to(torch.complex128) for t in (P, Y, Z)),
                                       phi.double(), n_mix)
    assert all(torch.equal(a, b) for a, b in zip((Xt, P, Y, phi), inputs))
    assert torch.isfinite(P_k).all() and torch.isfinite(Y_k).all()
    assert torch.equal(P_k[:, :, :M], P[:, :, :M])
    p_scale = P_d.abs().max().item()
    y_scale = max(Y_d.abs().max().item(), Y.abs().max().item())
    gaps = [_gap(P_k, P_d, p_scale), _gap(Y_k, Y_d, y_scale),
            _gap(P_p, P_d, p_scale), _gap(Y_p, Y_d, y_scale)]
    assert max(gaps) <= 1e-5, gaps


def test_tap_steps_kernel_reads_z_in_place(cuda):
    """Z read through its strides: the view ``Xt[:, :, n_chan:]`` (16-byte
    copies), the same view one element into a larger buffer (8-byte
    copies) and a dense copy give the same P and Y bit for bit."""
    T, n_mix, F, M, MK = 192, 2, 65, 8, 40
    Xt, P, Y, phi = _tap_state(5, T, n_mix, F, M, MK, cuda)
    buf = torch.zeros(Xt.numel() + 1, dtype=Xt.dtype, device=cuda)
    buf[1:] = Xt.reshape(-1)
    Xt_odd = buf[1:].view(Xt.shape)
    assert Xt_odd.data_ptr() % 16 != 0
    outs = [tts.tap_steps(P, Y, z, phi, n_mix)
            for z in (Xt[:, :, M:], Xt_odd[:, :, M:], Xt[:, :, M:].contiguous())]
    for P_o, Y_o in outs[1:]:
        assert torch.equal(P_o, outs[0][0]) and torch.equal(Y_o, outs[0][1])


def test_tap_steps_refuses_bad_inputs(cuda):
    Xt, P, Y, phi = _tap_state(6, 16, 1, 8, 2, 4, cuda)
    Z = Xt[:, :, 2:]
    with pytest.raises(ValueError, match="complex64 only"):
        tts.tap_steps(P, Y.to(torch.complex128), Z, phi)
    with pytest.raises(ValueError, match="one device"):
        tts.tap_steps(P, Y, Z, phi.cpu())
    for T, M, MK, what in ((16, tts.MAX_M + 1, 9, "1 <= M <="),
                           (16, 1, tts.MAX_MK + 1, "1 <= MK <="),
                           (tts.MAX_T + 1, 2, 4, "1 <= T <=")):
        Xb, Pb, Yb, phib = _tap_state(7, T, 1, 8, M, MK, cuda)
        assert not tts.kernel_route("cuda", torch.complex64, M, MK, T)
        with pytest.raises(ValueError, match=what):
            tts.tap_steps(Pb, Yb, Xb[:, :, M:], phib)


def test_tiss_epochs_launch_tap_steps_once_an_epoch(cuda):
    """T-ISS at the ``tiss_batch`` cell's shapes (8 folded rooms of 513
    bins, 192 frames, M=8, 5 taps, N=2): ``tiss_iterations`` on the card
    launches the kernel once an epoch, every ``tiss.taps`` span says
    ``kernel=1``, an epoch makes fewer than 180 launches, and 4 epochs
    stay within 1e-4 of max|Y| of the same epochs run with the plain
    source and tap steps on the card (complex64 both; the sums' order
    differs, and each epoch feeds the next)."""
    from torch.profiler import ProfilerActivity, profile

    from overiva_tpu_torch.models import tiss as ttiss
    from overiva_tpu_torch.utils.profiling import tracing

    rng = np.random.default_rng(8)
    T, F, M, n_mix, n_ep = 192, 8 * 513, 8, 8, 4
    X = rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))
    Xt = ttiss.augment_taps(torch.from_numpy(X.astype(np.complex64)).to(cuda), 5, 2)
    P0 = ttiss.augmented_eye(Xt, M)
    ttiss.tiss_iterations(Xt, P0, 1, "laplace", M, 2, n_mix=n_mix)  # build, warm
    torch.cuda.synchronize()
    before = tts.tap_steps.launches
    with tracing() as tr, profile(activities=[ProfilerActivity.CPU]) as prof:
        P, Y = ttiss.tiss_iterations(Xt, P0, n_ep, "laplace", M, 2, n_mix=n_mix)
        torch.cuda.synchronize()
    assert tts.tap_steps.launches == before + n_ep
    taps = [s["counts"] for s in tr.spans if s["name"] == "tiss.taps"]
    assert len(taps) == n_ep and all(t["kernel"] == 1 for t in taps)
    launches = [e for e in prof.events()
                if e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))]
    assert len(launches) < 180 * n_ep, len(launches)
    P_p, Y_p = P0, ttiss.demix(Xt, P0)
    for _ in range(n_ep):
        phi = ttiss.iss_phi(Y_p, "laplace", 2, n_mix)
        P_p, Y_p = tis.iss_steps_reference(P_p, Y_p, phi, n_mix)
        P_p, Y_p = tts.tap_steps_reference(P_p, Y_p, Xt[:, :, M:], phi, n_mix)
    assert (Y - Y_p).abs().max().item() <= 1e-4 * Y_p.abs().max().item()


# ------------------------------------------------------ the source-steps kernel

def _iss_cases():
    """M in {2, 3, 8}, J in {M, M + 8 x 5}, n_mix in {1, 8} and T in {56,
    189, 192, 256}, the last three with zero tail frames (189 of 192 real:
    the ``tiss_batch`` cell's bucket), rows of the widest J routed, and
    T = 1 at M = 1 (at T = 1 and
    M >= 2 the data is rank 1, the first step fits every other output to
    rounding noise, and the plain steps themselves land 0.7-2.2 of max|W|
    away from complex128), and J = M + 128."""
    cases = []
    for M in (2, 3, 8):
        for J in (M, M + 40):
            for n_mix in (1, 8):
                for T, real in ((56, 56), (189, 186), (192, 189), (256, 250)):
                    cases.append((T, real, n_mix, 33 if n_mix == 8 else 65, M, J))
    cases += [(1, 1, n_mix, 9, 1, J) for n_mix in (1, 8) for J in (1, 41)]
    # the widest rows a routed T-ISS epoch gives (tap_steps takes M x taps <= 128)
    cases += [(64, 60, 1, 9, M, M + 128) for M in (3, 8)]
    return cases


def _iss_state(seed, T, real, n_mix, F, M, J, device):
    """W (B*F, M, J), Y (T, B*F, M) with frames from ``real`` on zero, and
    phi (T, B, M), complex64 / float32 on ``device``."""
    rng = np.random.default_rng(seed)
    BF = n_mix * F

    def cplx(*shape):
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(z.astype(np.complex64)).to(device)

    W, Y = cplx(BF, M, J), cplx(T, BF, M)
    Y[real:] = 0
    phi = torch.from_numpy((rng.random((T, n_mix, M)) + 0.1).astype(np.float32)).to(device)
    return W, Y, phi


@pytest.mark.parametrize("T,real,n_mix,F,M,J", [(192, 189, 8, 513, 8, 48)] + _iss_cases())
def test_iss_steps_kernel_matches_plain(cuda, T, real, n_mix, F, M, J):
    """The kernel and the plain version on the card, both complex64,
    against the plain version at complex128, and against each other: each
    within 1e-5 of max|W| and of max|Y| (the larger of the input's and the
    result's). The kernel sums over T in another order than cuBLAS does and
    applies the M steps to W as one transform at the end; M sequential
    steps carry each v's ~1e-7 relative rounding (1e-7 to 2e-7 in a host
    emulation of the kernel's lanes). One launch a call; the inputs are
    left as they were. The first case is the ``tiss_batch`` cell."""
    W, Y, phi = _iss_state(T + n_mix + F + M + J, T, real, n_mix, F, M, J, cuda)
    inputs = [t.clone() for t in (W, Y, phi)]
    before = tis.iss_steps.launches
    W_k, Y_k = tis.iss_steps(W, Y, phi, n_mix)
    torch.cuda.synchronize()
    assert tis.iss_steps.launches == before + 1
    W_p, Y_p = tis.iss_steps_reference(W, Y, phi, n_mix)
    assert tis.iss_steps.launches == before + 1  # the plain version never counts
    W_d, Y_d = tis.iss_steps_reference(W.to(torch.complex128), Y.to(torch.complex128),
                                       phi.double(), n_mix)
    assert all(torch.equal(a, b) for a, b in zip((W, Y, phi), inputs))
    assert torch.isfinite(W_k).all() and torch.isfinite(Y_k).all()
    assert not Y_k[real:].any()  # zero frames stay zero
    w_scale = W_d.abs().max().item()
    y_scale = max(Y_d.abs().max().item(), Y.abs().max().item())
    gaps = [_gap(W_k, W_d, w_scale), _gap(Y_k, Y_d, y_scale),
            _gap(W_p, W_d, w_scale), _gap(Y_p, Y_d, y_scale),
            _gap(W_k, W_p, w_scale), _gap(Y_k, Y_p, y_scale)]
    assert max(gaps) <= 1e-5, gaps


def test_iss_steps_refuses_bad_inputs(cuda):
    """The launcher refuses what the kernel does not take; the wrapper runs
    the plain steps there, and counts no launch."""
    W, Y, phi = _iss_state(6, 16, 16, 1, 8, 2, 6, cuda)
    with pytest.raises(ValueError, match="complex64 only"):
        tis._launch(W, Y.to(torch.complex128), phi, 1)
    with pytest.raises(ValueError, match="one device"):
        tis._launch(W, Y, phi.cpu(), 1)
    for T, M, J, what in ((16, tis.MAX_M + 1, 9, "1 <= M <="),
                          (16, 3, 2, "J >= M"),
                          (tis.MAX_T + 1, 2, 4, "1 <= T <=")):
        Wb, Yb, phib = _iss_state(7, T, T, 1, 8, M, J, cuda)
        assert not tis.kernel_route("cuda", torch.complex64, M, J, T)
        with pytest.raises(ValueError, match=what):
            tis._launch(Wb, Yb, phib, 1)
        if J >= M:
            before = tis.iss_steps.launches
            got = tis.iss_steps(Wb, Yb, phib)
            want = tis.iss_steps_reference(Wb, Yb, phib)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
            assert tis.iss_steps.launches == before


@pytest.mark.parametrize("algo", ["tiss", "iss"])
def test_epochs_launch_iss_steps_once_an_epoch(cuda, algo):
    """``tiss_iterations`` at the ``tiss_batch`` cell's shapes (8 folded
    rooms of 513 bins, 192 frames, M=8, 5 taps, N=2) and an OverIVA-ISS
    ``run_family`` (M=8, N=3, 8 rooms of 129 bins) on the card launch the
    kernel once an epoch, and ``iss_steps.launches`` equals the spans'
    ``kernel`` counts (``tiss.sources``; ISS: ``family.epoch``). A T-ISS
    epoch makes at most 25 launches."""
    from torch.profiler import ProfilerActivity, profile

    from overiva_tpu_torch.models import tiss as ttiss
    from overiva_tpu_torch.models.family import run_family
    from overiva_tpu_torch.utils.profiling import tracing

    rng = np.random.default_rng(9)
    n_ep, M, n_mix = 4, 8, 8
    T, F = (192, 8 * 513) if algo == "tiss" else (56, 8 * 129)
    X = rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))
    X = torch.from_numpy(X.astype(np.complex64)).to(cuda)
    if algo == "tiss":
        Xt = ttiss.augment_taps(X, 5, 2)
        P0 = ttiss.augmented_eye(Xt, M)
        Y0 = ttiss.demix(Xt, P0)

        def run(n):  # the epochs alone: the first demix is done
            return ttiss.tiss_iterations(Xt, P0, n, "laplace", M, 2, Y=Y0, n_mix=n_mix)
        span_name = "tiss.sources"
    else:
        def run(n):
            return run_family(X, 3, n, "laplace", "iss", n_mix=n_mix)
        span_name = "family.epoch"
    run(1)  # build, warm
    torch.cuda.synchronize()
    before = tis.iss_steps.launches
    with tracing() as tr, profile(activities=[ProfilerActivity.CPU]) as prof:
        run(n_ep)
        torch.cuda.synchronize()
    kernel = [s["counts"]["kernel"] for s in tr.spans if s["name"] == span_name]
    assert kernel == [1] * n_ep
    assert tis.iss_steps.launches - before == sum(kernel) == n_ep
    if algo == "tiss":
        launches = [e for e in prof.events()
                    if e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))]
        assert len(launches) <= 25 * n_ep, len(launches)


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
    n_iter x B for a bf16pack group of B (clip by clip); never under f32.
    update_rows never runs under bf16pack, and once an epoch for an f32
    group (folded into one run)."""
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
    assert (twp.wcov_packed.launches, tur.update_rows.launches) == (counts[0] + 25,
                                                                    counts[1] + 5)


def _room_clips(seed, n_clips, n=96_000, M=8, N=3):
    """``n_clips`` 6 s clips at 16 kHz: N gated Laplacian sources through
    random 16-tap responses with a dominant direct path at M mics, 30 dB of
    white noise. Returns [(mix (n, M), the images at mic 0 (N, n))]."""
    rng = np.random.default_rng(seed)
    clips = []
    for _ in range(n_clips):
        gate = np.where(rng.random((N, n // 4000 + 1)) < 0.5, 1.0, 0.1).repeat(4000, axis=1)
        src = rng.laplace(size=(N, n)) * gate[:, :n]
        H = rng.standard_normal((M, N, 16)) * np.exp(-np.arange(16) / 4.0)
        H[:, :, 0] += 3.0 * np.sign(H[:, :, 0])
        images = np.stack([[np.convolve(src[k], H[m, k])[:n] for m in range(M)]
                           for k in range(N)])  # (N, M, n)
        mix = images.sum(axis=0).T
        noise = rng.standard_normal(mix.shape)
        mix = mix + noise * np.linalg.norm(mix) / np.linalg.norm(noise) * 10 ** (-30 / 20)
        clips.append((mix, images[:, 0]))
    return clips


def test_separator_overiva_m8n3_runs_update_rows(cuda):
    """The benchmark's configuration (``Separator("overiva", n_src=3,
    nfft=4096, hop=2048, n_iter=30, init_eig=True)``, M=8, complex64) on the
    card: ``separate`` and ``separate_batch`` launch ``update_rows`` once an
    epoch (30 a request, 30 a group of three), and every output scores
    within 0.1 dB SDR and SIR of the same Separator at complex128 on the
    CPU."""
    from overiva_tpu_torch.metrics import bss_eval_sources
    from overiva_tpu_torch.serving import Separator

    args = dict(n_src=3, nfft=4096, hop=2048, n_iter=30, model="laplace", init_eig=True)
    clips = _room_clips(31, 3)
    sep = Separator("overiva", device=cuda, **args)
    before = tur.update_rows.launches
    y_one = sep.separate(clips[0][0])
    assert tur.update_rows.launches == before + 30
    ys = sep.separate_batch([mix for mix, _ in clips])
    assert tur.update_rows.launches == before + 60
    cpu = Separator("overiva", device="cpu", dtype=np.complex128, **args)
    for i, (y, (mix, refs)) in enumerate(zip([y_one, *ys], [clips[0], *clips])):
        want = cpu.separate(mix)
        assert np.isfinite(y).all() and y.shape == want.shape
        sdr, sir, _, _ = bss_eval_sources(refs, np.asarray(y, np.float64).T)
        sdr_w, sir_w, _, _ = bss_eval_sources(refs, want.T)
        assert np.abs(sdr - sdr_w).max() < 0.1 and np.abs(sir - sir_w).max() < 0.1, (
            i, sdr, sdr_w, sir, sir_w)


@pytest.mark.parametrize("n_mix", [1, 8])
def test_ip_epoch_launches_under_30(cuda, n_mix):
    """A routed IP epoch at the benchmark's shapes (M=8, N=3, F=2049 a
    mixture, 56 frames; one clip and a folded group of 8) makes fewer than
    30 launches and 30 device kernels, one of them ``update_rows``, and
    its ``family.epoch`` span says ``kernel=1``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from overiva_tpu_torch.utils.profiling import tracing

    rng = np.random.default_rng(n_mix)
    T, F, M, N, n_ep = 56, 2049 * n_mix, 8, 3, 4
    X = rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))
    X = torch.from_numpy(X.astype(np.complex64)).to(cuda)
    W, Cx = core.prepare(X, N, True)
    core.overiva_iterations(X, W, Cx, N, 1, "laplace", n_mix=n_mix)  # build, warm
    torch.cuda.synchronize()
    with tracing() as tr, profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        core.overiva_iterations(X, W, Cx, N, n_ep, "laplace", n_mix=n_mix)
        torch.cuda.synchronize()
    events = prof.events()
    launches = [e for e in events
                if e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset", "family."))]
    assert len(launches) < 30 * n_ep and len(kernels) < 30 * n_ep, (len(launches), len(kernels))
    assert sum("update_rows" in e.name for e in kernels) == n_ep
    epochs = [s for s in tr.spans if s["name"] == "family.epoch"]
    assert len(epochs) == n_ep and all(s["counts"]["kernel"] == 1 for s in epochs)


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


def test_separator_tiss_m8n2_taps5_group_on_card(cuda):
    """The ``tiss_batch`` cell's configuration (``Separator("tiss", n_src=2,
    nfft=1024, hop=512, n_iter=30, taps=5, delay=2)``, M=8, complex64): a
    group of 8 of its rooms folded into one run on the card (both kernels:
    ``iss_steps`` and ``tap_steps`` once an epoch) scores within 0.1 dB SDR
    and SIR of the same group at complex128 on the CPU, each source within
    the cell's 1e-4 limit of it (the norm of the gap over the reference's),
    and
    the clip path of a group (``Separator._separate_host``) syncs no host
    and gives ``separate_batch``'s samples bit for bit."""
    import json
    from pathlib import Path

    from benchmark.traffic.generate import make_mixture
    from overiva_tpu_torch import serving
    from overiva_tpu_torch.metrics import bss_eval_sources

    root = Path(__file__).resolve().parents[1]
    cfg = json.loads((root / "benchmark/configs/tiss_m8n2_taps5.json").read_text())
    args = {k: v for k, v in cfg["args"].items() if k != "algo"}
    rng = np.random.default_rng(41)
    rooms = [make_mixture(rng, cfg["n_chan"], 96_000, cfg["fs"], cfg["scene"])
             for _ in range(8)]
    mixes = [mix.astype(np.float32) for mix, _ in rooms]
    sep = serving.Separator("tiss", device=cuda, **args)
    ys = sep.separate_batch(mixes)
    assert sep.n_buckets() == 1
    wants = serving.Separator("tiss", device="cpu", dtype=np.complex128,
                              **args).separate_batch(mixes)
    for i, (y, want, (_, premix)) in enumerate(zip(ys, wants, rooms)):
        assert np.isfinite(y).all() and y.shape == want.shape == (96_000, 2)
        refs = premix[:, 0]
        sdr, sir, _, _ = bss_eval_sources(refs, np.asarray(y, np.float64).T)
        sdr_w, sir_w, _, _ = bss_eval_sources(refs, want.T)
        assert np.abs(sdr - sdr_w).max() < 0.1 and np.abs(sir - sir_w).max() < 0.1, (
            i, sdr, sdr_w, sir, sir_w)
        rel = np.linalg.norm(y - want, axis=0) / np.linalg.norm(want, axis=0)
        assert rel.max() <= 1e-4, (i, rel)  # the cell's limit on rel_err
    idxs = list(range(8))
    prepped = [sep._prep_clip(x.shape[0]) for x in mixes]
    xb = sep._group_bucket(mixes, idxs, prepped, cfg["n_chan"], False)
    t_pads = [p[2] for p in prepped]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yb = sep._separate_host(xb, t_pads)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    start = sep._start(prepped[0][2])
    np.testing.assert_array_equal(yb[0, start : start + 96_000].cpu().numpy(), ys[0])


def test_eigh_chunked_on_card(cuda):
    """16 folded rooms of 2,049 bins: the batched eigh runs as two calls of
    16,392 (one call of 32,784 is refused by cuSOLVER), and agrees with 16
    calls of 2,049 in eigenvalues and in each eigenvector up to its
    phase."""
    from overiva_tpu_torch.ops import linalg as tla

    rng = np.random.default_rng(43)
    A = rng.standard_normal((16 * 2049, 8, 8)) + 1j * rng.standard_normal((16 * 2049, 8, 8))
    A = torch.from_numpy((A @ np.conj(np.swapaxes(A, -1, -2))).astype(np.complex64)).to(cuda)
    assert tla.eigh_chunks(A.shape[0]) == 2
    w, v = tla.eigh(A)
    parts = [torch.linalg.eigh(c) for c in A.split(2049)]
    w_ref = torch.cat([p[0] for p in parts])
    v_ref = torch.cat([p[1] for p in parts])
    torch.testing.assert_close(w, w_ref, rtol=1e-5, atol=1e-5 * float(w_ref.abs().max()))
    overlap = (v.conj() * v_ref).sum(dim=-2).abs()
    torch.testing.assert_close(overlap, torch.ones_like(overlap), rtol=0, atol=1e-4)


def test_tiny_tiss_cell_on_card(cuda, tmp_path):
    """The tiny T-ISS cell through the harness on the card, traced: correct,
    and all nine of its per-layer metrics, the device trace's too."""
    import time

    from benchmark import run
    from benchmark.tests import tiny, tiny_cells

    root = tiny_cells.write_bench(tmp_path, cells={**tiny.CELLS, **tiny_cells.MORE})
    cell = run.load_cell("tiny_tiss", root, (tiny.DATA, run.HERE))
    res = run.run_cell(cell, 2**31 + 11, 2.0, True, "cuda", time.perf_counter())
    assert res["correct"] is True, res["compared"]
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer} == {
        "epoch_ms.tiss", "launches_per_epoch.tiss", "idle_frac.tiss", "tap_ms.tiss",
        "tap_share.tiss", "tap_hbm_frac.tiss", "source_ms.tiss", "source_share.tiss",
        "source_hbm_frac.tiss"}
    for name in ("tap_share.tiss", "tap_hbm_frac.tiss", "source_share.tiss",
                 "source_hbm_frac.tiss"):
        assert 0 < res["metrics"][name]["value"] <= 1, name


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


def test_parallel_gloo_sharded_tiss_complex64(cuda):
    """Four gloo ranks on cuda:0, T-ISS on the (2, 2) mesh at complex64,
    where each rank's epochs run the ``iss_steps`` and ``tap_steps``
    kernels on its slice of bins: within 1e-4 of max|Y| of the unsharded
    complex64 run of each mixture on the card (the bins' power psum sums
    in another order)."""
    from overiva_tpu_torch.parallel import dryrun
    from overiva_tpu_torch.parallel.launch import launch

    X = dryrun.tiny_batch(2, 2).astype(np.complex64)
    T, F, M = X.shape[1:]
    kw = dryrun.family_kwargs("tiss", F)
    J = M * (1 + kw["taps"])
    assert tis.kernel_route("cuda", torch.complex64, M, J, T)
    outs = launch(dryrun.rank_families, 4, ([(2, 2)], X, "cuda", ("tiss",)),
                  device_type="cuda", backend="gloo", timeout=300)
    Y = np.asarray(outs[0][(2, 2), "tiss"][0])
    assert all(np.array_equal(np.asarray(o[(2, 2), "tiss"][0]), Y) for o in outs[1:])
    for b in range(X.shape[0]):
        ref = np.asarray(api.tiss(X[b], **kw, dtype=np.complex64, device=cuda))
        assert np.abs(Y[b] - ref).max() <= 1e-4 * np.abs(ref).max(), b


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


def test_sweep_batched_matches_serial_on_card(cuda, tmp_path):
    """The sweep twin on the card: tests/test_torch_sweep.py's small config
    at batch 2 (a padded partial chunk) against batch 1, every score within
    tests/test_sweep_batch.py's 2e-4 dB, no error entry."""
    import json

    from overiva_tpu_torch.examples import mbss_sim

    cfg = {**mbss_sim.DEFAULT_CONFIG, "repeats": 3, "duration": 1.5, "nfft": 256,
           "n_mics": [2], "n_srcs": [1, 2], "seed": 777}
    cfg["algos"] = {"overiva": {"n_iter": 6}, "ilrma": {"n_iter": 4, "n_components": 2},
                    "five": {"n_iter": 4}, "overiva@c128": {"n_iter": 6, "dtype": "complex128"}}
    runs = {}
    for b in (1, 2):
        mbss_sim.sweep(cfg, tmp_path / str(b), batch=b)
        runs[b] = {f.name: json.loads(f.read_text())
                   for f in sorted((tmp_path / str(b)).glob("s*.json"))}
    assert set(runs[1]) == set(runs[2]) and len(runs[1]) == 6
    for name, rec in runs[1].items():
        for algo, res in rec["results"].items():
            bres = runs[2][name]["results"][algo]
            assert "error" not in res and "error" not in bres, (algo, res, bres)
            for key in ("sdr", "sir", "sdr_improvement", "sir_improvement"):
                if key in res:
                    np.testing.assert_allclose(res[key], bres[key], rtol=0, atol=2e-4,
                                               err_msg=f"{name}/{algo}/{key}")


def test_bench_twin_on_card(cuda):
    """The bench twin's rows at its small shape on the card: every key,
    every value finite, no row error, ``wcov_packed`` launched by the
    two bf16pack rows alone, (1 warm-up + 1 timed) x n_iter each,
    ``update_rows`` once for each IP epoch of the complex64 f32 and f32x3
    rows, and the ``family.epoch`` spans' ``kernel=1`` as many as those
    launches and the ISS rows' ``iss_steps`` launches (the T-ISS rows'
    count on their ``tiss.sources`` spans)."""
    from overiva_tpu_torch.examples import bench
    from overiva_tpu_torch.utils.profiling import tracing

    twp.wcov_packed.launches = tur.update_rows.launches = tis.iss_steps.launches = 0
    with tracing() as tr:
        extra = bench.run(cuda, bench.TINY, repeats=1)["extra"]
    assert set(extra) == set(bench.EXTRA_KEYS) | {"device"}, extra.get("bench_errors")
    assert all(np.isfinite(extra[k]) for k in bench.EXTRA_KEYS)
    assert twp.wcov_packed.launches == 2 * 2 * bench.TINY.n_iter
    # (1 warm-up + 1 timed) x the f32 and f32x3 IP epochs: the headline, f32x3,
    # T512, T512 f32x3 and batch16 rows (n_iter each), the marginal row
    # (n_iter + 200), the roofline row (n_iter + 100), two Separator calls of
    # one clip and two of 8 clips, which span two buckets at this shape (two
    # groups a call; one at the full shape)
    n = bench.TINY.n_iter
    assert tur.update_rows.launches == 2 * (5 * n + (n + 200) + (n + 100) + 2 * n + 2 * 2 * n)
    table = tr.table()
    tiss_sources = table["tiss.sources"]["counts"]["kernel"]
    iss_epochs = tis.iss_steps.launches - tiss_sources
    assert tiss_sources > 0 and iss_epochs > 0
    assert table["family.epoch"]["counts"]["kernel"] == tur.update_rows.launches + iss_epochs
