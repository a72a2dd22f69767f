"""ILRMA-T: joint dereverberation + ILRMA by source steering.

Counterpart of ``overiva_tpu/models/ilrma_t.py`` (oracle twin
``oracle/ilrma_t.py``, derivation there): ILRMA's rank-K NMF variance
model driving T-ISS steering on the augmented input [X | delayed taps].
Per epoch (:func:`ilrma_t_epoch`):

- the IS-NMF multiplicative updates of the sources, all at once (the basis
  per bin, the activations summed over the mixture's bins), from |Y|^2 taken
  once at the epoch start, and the weights phi = 1/(B H) per (t, f, k):
  one ``ilrma.nmf`` span (``sources`` = M, ``bases`` = K, ``bins``,
  ``frames``), on a CUDA device one replay of a CUDA graph of them
  (:class:`_NMFGraph`);
- T-ISS's steering half, ``models/tiss.py::steer``: the M source steps and
  the M x taps tap steps with a weight a bin (``n_mix`` = B*F), each one
  kernel launch where its route holds;
- the unit-power renormalization of Y, P and B per source.

The tensors are T-ISS's folded layout (``models/overiva.py::
fold_mixtures``): Xt (T, B*F, MJ), P (B*F, M, MJ), Y (T, B*F, M), with the
NMF on each mixture's own bins, B (nb, M, F, K) and H (nb, M, K, T).

**Padded clips.** ``frames`` gives each mixture's real frame count, its
padding at the front (the serving tier's buckets) and zero. Every sum
over frames and every division by the frame count then covers the real
frames alone: the basis update sees the activations of the real frames
only (a padded frame's activation falls to the 1e-15 floor, whose
reciprocal would weigh in otherwise), and phi is scaled by T / frames, so
that the source steps' self term, the one place where the steps divide by
T, divides by the real count (every other coefficient is a ratio of sums
in phi); the renormalization divides by it too. A padded clip so runs as
it would alone.
"""

from __future__ import annotations

import torch

from ..parallel.collectives import psum
from ..utils.profiling import span
from .overiva import demix, fold_mixtures, unfold_mixtures
from .tiss import augment_taps, steer

__all__ = ["_ilrma_t_epoch", "augment_taps", "ilrma_t_epoch", "ilrma_t_iterations"]

_EPS = 1e-15


def _real_frames(frames, T: int, like):
    """(mask (nb, 1, T): 1 on each mixture's last ``frames[b]`` frames, 0 on
    the padding before them; the counts (nb,)), in ``like``'s real dtype
    on its device, for :func:`ilrma_t_epoch`."""
    rdt = like.real.dtype
    counts = torch.as_tensor(frames, dtype=rdt).to(like.device, non_blocking=True)
    t = torch.arange(T, device=like.device, dtype=rdt)
    return (t >= T - counts[:, None]).to(rdt)[:, None, :], counts


def _psum_sources(x, group):
    """``psum`` of each source's slice of ``x`` (nb, M, ...): the JAX
    epoch's one collective a source."""
    if group is None:
        return x
    return torch.stack([psum(x[:, k], group) for k in range(x.shape[1])], dim=1)


def _nmf_phi(Y, B, H, real, group, bin_mask):
    """The NMF updates of every source and the weights phi (T, B*F, M).
    The sources' updates are independent, so each step runs on all of
    them at once."""
    T, BF, M = Y.shape
    nb = B.shape[0]
    F = BF // nb
    mask = None if bin_mask is None else bin_mask.to(Y.real.dtype)[:, None]  # (F, 1)
    # |Y|^2 per mixture and source, (nb, M, F, T)
    Pw = (Y.abs() ** 2).reshape(T, nb, F, M).permute(1, 3, 2, 0).contiguous()
    Hr = H if real is None else H * real[0][:, None]  # the real frames' activations
    R = B @ H + _EPS
    B = B * torch.sqrt(((Pw / R**2) @ Hr.mT) / ((1.0 / R) @ Hr.mT + _EPS))
    B = torch.clamp_min(B, _EPS)
    R = B @ H + _EPS
    hn, hd = Pw / R**2, 1.0 / R
    if mask is not None:
        hn, hd = hn * mask, hd * mask
    num = _psum_sources(B.mT @ hn, group)  # (nb, M, K, T): sums over the mixture's bins
    den = _psum_sources(B.mT @ hd, group)
    H = torch.clamp_min(H * torch.sqrt(num / (den + _EPS)), _EPS)
    R = B @ H + _EPS  # (nb, M, F, T)
    phi = 1.0 / R if real is None else (T / real[1])[:, None, None, None] / R
    return B, H, phi.permute(3, 0, 2, 1).reshape(T, BF, M)


class _NMFGraph:
    """:func:`_nmf_phi` at one set of shapes, captured once as a CUDA graph,
    so that an epoch's NMF and weights are one launch (a replay) in place
    of ~35. A call copies its inputs into the graph's own tensors and
    returns the graph's outputs, which the next replay overwrites."""

    def __init__(self, Y, B, H, real):
        self.ins = [Y.clone(), B.clone(), H.clone()]
        self.real = None if real is None else tuple(r.clone() for r in real)
        with torch.cuda.device(Y.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):  # the libraries' first calls, outside the capture
                _nmf_phi(*self.ins, self.real, None, None)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.outs = _nmf_phi(*self.ins, self.real, None, None)

    def set_real(self, real):
        for mine, r in zip(self.real or (), real or ()):
            mine.copy_(r)

    def __call__(self, Y, B, H, real, group, bin_mask):
        for mine, x in zip(self.ins, (Y, B, H)):
            mine.copy_(x)
        self.graph.replay()
        return self.outs


_GRAPHS: dict = {}  # (shapes, dtypes, device, padded) -> _NMFGraph, the last few


def _nmf_graph(Y, B, H, real):
    """The :class:`_NMFGraph` of these shapes, with ``real`` copied in."""
    key = (Y.shape, B.shape, H.shape, Y.dtype, B.dtype, Y.device, real is None)
    graph = _GRAPHS.pop(key, None)
    if graph is None:
        while len(_GRAPHS) >= 4:
            _GRAPHS.pop(next(iter(_GRAPHS)))
        graph = _NMFGraph(Y, B, H, real)
    _GRAPHS[key] = graph
    graph.set_real(real)
    return graph


def ilrma_t_epoch(Xt, P, Y, B, H, n_chan: int, real=None, group=None, n_freq=None,
                  bin_mask=None, nmf=_nmf_phi):
    """One epoch. Xt: (T, B*F, MJ); P: (B*F, M, MJ); Y: (T, B*F, M); B:
    (nb, M, F, K); H: (nb, M, K, T); ``real``: :func:`_real_frames` of padded
    mixtures, or None; ``nmf``: :func:`_nmf_phi` or its
    :class:`_NMFGraph`. Returns the new (P, Y, B, H).

    Bin-sharded (``group``, ``n_freq``, ``bin_mask`` as in
    ``models/ilrma.py::_ilrma_epoch``): the activation numerator and
    denominator of each source and the renormalization's power sums are
    psum'd, 2M + 1 collectives an epoch; the steering is bin-local."""
    T, BF, M = Y.shape
    nb = B.shape[0]
    F = BF // nb
    with span("ilrma.nmf", sources=M, bases=B.shape[3], bins=BF, frames=T):
        B, H, phi = nmf(Y, B, H, real, group, bin_mask)
    P, Y = steer(Xt, P, Y, phi, n_chan, BF)

    # unit-power renormalization per source (likelihood-invariant)
    p = (Y.abs() ** 2).reshape(T, nb, F, M)
    if bin_mask is not None:
        p = p * bin_mask.to(p.dtype)[:, None]
    frames = T if real is None else real[1][:, None]
    lam = torch.sqrt(psum(p.sum(dim=(0, 2)), group) / (frames * (n_freq or F))) + _EPS
    Y = (Y.reshape(T, nb, F, M) / lam[:, None, :]).reshape(T, BF, M)
    P = (P.reshape(nb, F, M, -1) / lam[:, None, :, None]).reshape(P.shape)
    B = B / (lam**2)[:, :, None, None]
    return P, Y, B, H


def _ilrma_t_epoch(Xt, P, Y, B, H, n_chan: int, group=None, n_freq=None, bin_mask=None):
    """:func:`ilrma_t_epoch` in the JAX twin's layout, a leading mixture
    axis: Xt (nb, T, F, MJ), P (nb, F, M, MJ), Y (nb, T, F, M); B and H as
    there. Returns (P, Y, B, H) in that layout."""
    nb, T, F, MJ = Xt.shape
    P, Y, B, H = ilrma_t_epoch(fold_mixtures(Xt), P.reshape(nb * F, -1, MJ), fold_mixtures(Y),
                               B, H, n_chan, None, group, n_freq, bin_mask)
    return P.reshape(nb, F, -1, MJ), unfold_mixtures(Y, nb), B, H


def ilrma_t_iterations(Xt, P, B, H, n_iter: int, n_chan: int, Y=None, frames=None):
    """Run ``n_iter`` epochs, each a ``family.epoch`` span (``index``,
    ``bins`` = B*F, ``taps`` = MJ - M). Xt: (T, B*F, MJ); P: (B*F, M, MJ);
    B: (nb, M, F, K) >= 0; H: (nb, M, K, T) >= 0. ``Y`` resumes a run
    (default: demix Xt by P). ``frames``: each mixture's real frame count
    (the module docstring's padded clips), or None. On a CUDA device the
    NMF runs as a replay of its :class:`_NMFGraph`. Returns (P, Y, B, H)."""
    if Y is None:
        Y = demix(Xt, P)
    T, BF, MJ = Xt.shape
    real = None if frames is None else _real_frames(frames, T, Y)
    nmf = _nmf_graph(Y, B, H, real) if Y.is_cuda and n_iter > 0 else _nmf_phi
    for i in range(n_iter):
        with span("family.epoch", index=i, bins=BF, taps=MJ - n_chan):
            P, Y, B, H = ilrma_t_epoch(Xt, P, Y, B, H, n_chan, real, nmf=nmf)
    if nmf is not _nmf_phi:
        H = H.clone()  # the graph's own, which its next replay overwrites
    return P, Y, B, H
