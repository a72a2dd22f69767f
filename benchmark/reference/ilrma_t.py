"""ILRMA-T of the reference: joint dereverberation and separation with
ILRMA's rank-K NMF source model (Kitamura et al., IEEE/ACM TASLP 2016)
driving the source- and tap-steering steps of T-ISS (Nakashima,
Scheibler, Togami and Ono, ICASSP 2021), and the clip pipeline it serves.

A translation into plain PyTorch of ``overiva_tpu_torch/oracle/ilrma_t.py``
(commit ec3bc57), which holds the derivation, with its
``oracle/wpe.py::delayed_taps`` and ``oracle/projection.py``: the input
augmented by ``taps`` delayed copies of every microphone (``delay``,
``delay + 1``, ... frames back, channel-major, zero before the first
frame), the demixing P = [I | 0] (F, M, M + M taps), the NMF start of one
``numpy.random.default_rng(seed)`` (the basis (M, F, K) drawn first, then
the activations (M, K, T), each plus 0.1), then ``n_iter`` epochs of:
the IS-NMF multiplicative updates of each source in turn from |Y|^2 taken
at the epoch start (the oracle's 1e-15 floors), the weights
phi = 1/(B H) per (t, f, source), the M source-steering steps in order (the
self term 1 - 1/sqrt(den / T)), the M taps weighted-least-squares tap
steps in order, and the unit-power renormalization of Y, P and B per
source; then projection back against microphone 0. Determined: N = M.
It runs on the CPU, and imports NumPy and torch only: nothing of the
program, of the JAX package or of JAX. It switches TF32 off in torch's
process-wide settings (``torch.backends``), as the configurations state.
Departures, none of which changes the mathematics:

- tensors are held bins-first, Xt (F, M + M taps, T), Y (F, M, T) and phi
  (F, M, T), so that each step's sums over frames are batched matrix
  products;
- a tap step's sums are formed as the source steps' are (the oracle forms
  the same numerator and denominator by ``einsum``);
- an :class:`~benchmark.reference.arith.Arith` sets the precision: float64
  for the reference; for the control complex64 and float32 storage, and
  each operand of every matrix product (the sums over frames, the NMF's
  over bins and bases) rounded by ``tf32_round``.
"""

from __future__ import annotations

import numpy as np
import torch

from .arith import F64, Arith, tf32_round
from .stft import analysis, stft_pad, synthesis
from .tiss import delayed_taps

__all__ = ["ilrma_t", "separate_clip"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_EPS = 1e-15  # the oracle's floors: the denominators, the NMF factors, the scales


def _op(a: torch.Tensor, ar: Arith) -> torch.Tensor:
    """An operand of a matrix product, in ``ar``'s arithmetic."""
    return torch.from_numpy(tf32_round(a.resolve_conj().numpy())) if ar.tf32 else a


def _mm(a: torch.Tensor, b: torch.Tensor, ar: Arith) -> torch.Tensor:
    return _op(a, ar) @ _op(b, ar)


def _nmf(Pw: torch.Tensor, B: torch.Tensor, H: torch.Tensor, ar: Arith):
    """The IS-NMF updates of every source in turn: power Pw (M, F, T), basis
    B (M, F, K), activations H (M, K, T). Returns the new (B, H)."""
    B, H = B.clone(), H.clone()
    for k in range(B.shape[0]):
        Pk = Pw[k]
        R = _mm(B[k], H[k], ar) + _EPS
        B[k] = B[k] * torch.sqrt(_mm(Pk / R**2, H[k].T, ar) / (_mm(1.0 / R, H[k].T, ar) + _EPS))
        B[k] = torch.clamp_min(B[k], _EPS)
        R = _mm(B[k], H[k], ar) + _EPS
        H[k] = H[k] * torch.sqrt(_mm(B[k].T, Pk / R**2, ar) / (_mm(B[k].T, 1.0 / R, ar) + _EPS))
        H[k] = torch.clamp_min(H[k], _EPS)
    return B, H


def _step(Y: torch.Tensor, z: torch.Tensor, phi: torch.Tensor, ar: Arith):
    """(num, den) (F, M) of a steering step against the row z (F, T):
    num[f, m] = sum_t phi[f, m, t] Y[f, m, t] conj(z[f, t]),
    den[f, m] = sum_t phi[f, m, t] |z[f, t]|^2."""
    num = _mm(phi * Y, z.conj()[:, :, None], ar)[:, :, 0]
    den = _mm(phi, (z.abs() ** 2)[:, :, None], ar)[:, :, 0]
    return num, den


def ilrma_t(X: np.ndarray, taps: int, delay: int, n_iter: int, n_components: int = 2,
            seed: int = 0, ar: Arith = F64) -> np.ndarray:
    """X (T, F, M) -> projected sources Y (T, F, M)."""
    T, F, M = X.shape
    if taps < 0 or (taps > 0 and delay < 1):
        raise ValueError("need taps >= 0, and delay >= 1 when taps > 0")
    rng = np.random.default_rng(seed)
    B = torch.from_numpy(ar.r(rng.random((M, F, n_components)) + 0.1))
    H = torch.from_numpy(ar.r(rng.random((M, n_components, T)) + 0.1))
    Xf = torch.from_numpy(np.ascontiguousarray(ar.c(X).transpose(1, 2, 0)))  # (F, M, T)
    Xt = torch.cat([Xf, delayed_taps(Xf, taps, delay)], dim=1)  # (F, MJ, T)
    P = Xf.new_zeros((F, M, Xt.shape[1]))
    P[:, :, :M] = torch.eye(M, dtype=P.dtype)
    Y = _mm(P, Xt, ar)  # (F, M, T)

    col = torch.arange(M)[None, :]
    for _ in range(n_iter):
        B, H = _nmf((Y.abs() ** 2).transpose(0, 1), B, H, ar)
        phi = (1.0 / (_mm(B, H, ar) + _EPS)).transpose(0, 1)  # (F, M, T)
        for n in range(M):  # source steering
            yn = Y[:, n, :]
            num, den = _step(Y, yn, phi, ar)
            v = num / torch.clamp_min(den, _EPS)
            vnn = 1.0 - 1.0 / torch.sqrt(torch.clamp_min(den[:, n] / T, _EPS))
            v = torch.where(col == n, vnn[:, None].to(v.dtype), v)
            Y = Y - v[:, :, None] * yn[:, None, :]
            P = P - v[:, :, None] * P[:, n, None, :]
        for j in range(M * taps):  # tap steering: weighted least squares
            z = Xt[:, M + j, :]
            num, den = _step(Y, z, phi, ar)
            v = num / torch.clamp_min(den, _EPS)
            Y = Y - v[:, :, None] * z[:, None, :]
            P[:, :, M + j] -= v
        # unit average power per source, Y, P and B scaled together
        lam = torch.sqrt((Y.abs() ** 2).mean(dim=(0, 2))) + _EPS  # (M,)
        Y = Y / lam[None, :, None]
        P = P / lam[None, :, None]
        B = B / (lam**2)[:, None, None]

    # projection back against microphone 0: Y *= conj(z),
    # z = sum_t conj(ref) Y / sum_t |Y|^2 (1 where the denominator is 0)
    ref = Xf[:, 0, :]
    num = (ref.conj()[:, None, :] * Y).sum(dim=2)
    den = (Y.abs() ** 2).sum(dim=2)
    z = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), torch.ones_like(num))
    return (Y * z.conj()[:, :, None]).permute(2, 0, 1).numpy()


def separate_clip(x: np.ndarray, args: dict, ar: Arith = F64) -> np.ndarray:
    """The unpadded clip pipeline of a ``Separator("ilrma-t", **args)``,
    (n_samples, M) -> (n_samples, M): ``synthesis(ilrma_t(analysis(
    stft_pad(x))))`` trimmed to the clip."""
    nfft = int(args["nfft"])
    hop = int(args.get("hop") or nfft // 2)
    X = analysis(stft_pad(x, nfft, hop), nfft, hop, ar)
    Y = ilrma_t(X, int(args["taps"]), int(args["delay"]), int(args["n_iter"]),
                int(args.get("n_components", 2)), int(args.get("seed", 0)), ar)
    y = synthesis(Y, nfft, hop, ar)
    front = nfft - hop
    return y[front : front + x.shape[0]]
