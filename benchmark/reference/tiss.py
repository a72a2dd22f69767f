"""T-ISS of the reference: joint dereverberation and separation by
iterative source steering (Nakashima, Scheibler, Togami and Ono, ICASSP
2021), and the clip pipeline it serves.

A translation into plain PyTorch of ``overiva_tpu_torch/oracle/tiss.py``
(commit 10f006b), which holds the derivation, with its
``oracle/wpe.py::delayed_taps``, ``oracle/models.py::activations`` and
``oracle/projection.py``: the input augmented by ``taps`` delayed copies
of every microphone (``delay``, ``delay + 1``, ... frames back,
channel-major, zero before the first frame), the demixing
P = [I | 0] (F, M, M + M taps), then ``n_iter`` epochs of the activations
(the ``EPS`` and ``REL_EPS`` floors; phi = 1 on the M - N background
outputs), the M source-steering steps in order and the M taps
weighted-least-squares tap steps in order, and projection back of the N
outputs against microphone 0. It runs on the CPU, and imports NumPy and
torch only: nothing of the program, of the JAX package or of JAX. It
leaves torch's process-wide settings (TF32) as they are. Departures, none
of which changes the mathematics:

- tensors are held bins-first, Xt (F, M + M taps, T) and Y (F, M, T), so
  that each step's sums over frames are batched matrix products;
- a tap step's denominators depend on phi alone, so each is formed from
  ``|z_j|^2`` and phi in one product (the oracle's ``den`` einsum);
- an :class:`~benchmark.reference.arith.Arith` sets the precision: float64
  for the reference; for the control complex64 storage, and each operand
  of a sum over frames rounded by ``tf32_round``.
"""

from __future__ import annotations

import numpy as np
import torch

from .arith import F64, Arith, tf32_round
from .models import EPS, REL_EPS
from .stft import analysis, stft_pad, synthesis

__all__ = ["delayed_taps", "separate_clip", "tiss"]

_EPS = 1e-15  # the steps' denominator floor


def _op(a: torch.Tensor, ar: Arith) -> torch.Tensor:
    """An operand of a sum over frames, in ``ar``'s arithmetic."""
    return torch.from_numpy(tf32_round(a.resolve_conj().numpy())) if ar.tf32 else a


def delayed_taps(X: torch.Tensor, taps: int, delay: int) -> torch.Tensor:
    """(F, M, T) -> (F, M taps, T): row m taps + k is microphone m
    ``delay + k`` frames back, zero before the first frame."""
    F, M, T = X.shape
    out = X.new_zeros((F, M, taps, T))
    for k in range(taps):
        s = delay + k
        if s < T:
            out[:, :, k, s:] = X[:, :, : T - s]
    return out.reshape(F, M * taps, T)


def _phi(Y: torch.Tensor, n_src: int, model: str) -> torch.Tensor:
    """The steering weights (M, T): the source model on the first n_src
    outputs, with the oracle's floors, and 1 on the background outputs."""
    F, M, T = Y.shape
    power = (Y[:, :n_src].abs() ** 2).sum(dim=0)  # (N, T)
    if model == "laplace":
        r = 2.0 * torch.sqrt(power)
    elif model == "gauss":
        r = power / F
    else:
        raise ValueError(f"unknown source model {model!r}")
    r = torch.clamp_min(r, EPS)
    r = torch.maximum(r, REL_EPS * r.amax(dim=1, keepdim=True))
    return torch.cat([1.0 / r, r.new_ones((M - n_src, T))])


def _step(Y: torch.Tensor, z: torch.Tensor, phi: torch.Tensor, ar: Arith):
    """(num, den) (F, M) of a steering step against the row z (F, T):
    num[f, m] = sum_t phi[m, t] Y[f, m, t] conj(z[f, t]),
    den[f, m] = sum_t phi[m, t] |z[f, t]|^2."""
    num = (_op(phi * Y, ar) @ _op(z.conj(), ar)[:, :, None])[:, :, 0]
    den = _op(z.abs() ** 2, ar) @ _op(phi, ar).T
    return num, den


def tiss(X: np.ndarray, n_src: int, taps: int, delay: int, n_iter: int,
         model: str = "laplace", ar: Arith = F64) -> np.ndarray:
    """X (T, F, M) -> projected sources Y (T, F, N)."""
    T, F, M = X.shape
    N = int(n_src)
    if not 1 <= N <= M:
        raise ValueError("need 1 <= n_src <= n_chan")
    if taps < 0 or (taps > 0 and delay < 1):
        raise ValueError("need taps >= 0, and delay >= 1 when taps > 0")
    Xf = torch.from_numpy(np.ascontiguousarray(ar.c(X).transpose(1, 2, 0)))  # (F, M, T)
    Xt = torch.cat([Xf, delayed_taps(Xf, taps, delay)], dim=1)  # (F, MJ, T)
    P = Xf.new_zeros((F, M, Xt.shape[1]))
    P[:, :, :M] = torch.eye(M, dtype=P.dtype)
    Y = _op(P, ar) @ _op(Xt, ar)  # (F, M, T)

    col = torch.arange(M)[None, :]
    for _ in range(n_iter):
        phi = _phi(Y, N, model)
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

    Y = Y[:, :N]
    # projection back against microphone 0: Y *= conj(z),
    # z = sum_t conj(ref) Y / sum_t |Y|^2 (1 where the denominator is 0)
    ref = Xf[:, 0, :]
    num = (ref.conj()[:, None, :] * Y).sum(dim=2)
    den = (Y.abs() ** 2).sum(dim=2)
    z = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), torch.ones_like(num))
    return (Y * z.conj()[:, :, None]).permute(2, 0, 1).numpy()


def separate_clip(x: np.ndarray, args: dict, ar: Arith = F64) -> np.ndarray:
    """The unpadded clip pipeline of a ``Separator("tiss", **args)``,
    (n_samples, M) -> (n_samples, N): ``synthesis(tiss(analysis(
    stft_pad(x))))`` trimmed to the clip."""
    nfft = int(args["nfft"])
    hop = int(args.get("hop") or nfft // 2)
    X = analysis(stft_pad(x, nfft, hop), nfft, hop, ar)
    Y = tiss(X, args["n_src"], int(args["taps"]), int(args["delay"]), int(args["n_iter"]),
             args.get("model", "laplace"), ar)
    y = synthesis(Y, nfft, hop, ar)
    front = nfft - hop
    return y[front : front + x.shape[0]]
