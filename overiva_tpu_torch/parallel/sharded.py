"""Sharded multi-device separation over a ('mix', 'bins') ``DeviceMesh``.

Counterpart of ``overiva_tpu/parallel/sharded.py``: the same seventeen
functions, arguments and defaults. JAX runs one ``shard_map`` program from
one controller; here every rank of the mesh's process group calls the
same function with the same full batch (B, T, F, M) and gets the full
result back, so callers are the same on one rank and on many. Inside:

1. each rank takes its block: the mixtures of its 'mix' coordinate and
   the bins of its 'bins' coordinate, the bins replicate-padded to a
   multiple of the 'bins' size (:func:`pad_bins`: the padding repeats the
   last real bin, which keeps every solve well-conditioned, and a mask
   zeroes it out of every cross-bin sum);
2. it runs the port's epochs on its own device, its mixtures folded into
   the bin axis (``models/overiva.py::fold_mixtures``) or on the leading
   batch axis, with the epochs' hook ``group`` (the 'bins' group),
   ``n_freq`` (the global F) and ``bin_mask``. The collectives are those
   of the JAX epochs (``parallel/collectives.py`` counts them): one power
   psum an epoch for the IP/ISS/IP2/PCA/FIVE/T-ISS/T-IP families, plus
   OGIVE's pmax of its criterion; 3M for ILRMA and 2M + 1 for ILRMA-T;
   five for FastMNMF2 and three for FastMNMF1 (one more, once, to pick the
   loudest outputs); one a pass for the streaming scans; none for WPE;
3. it assembles the output on every rank: each rank writes its block into
   a zero-filled full tensor and one all-reduce sums them
   (``collectives.assemble``). gloo has no all-gather for CUDA tensors and
   has an all-reduce, so this one form serves NCCL and gloo, CPU and CUDA
   alike; the sum with zeros is exact. SparseAuxIVA gathers its k
   selected bins' demixing matrices over the 'bins' group the same way.

Per-element seeds are ``seed + b``, b the global batch index. A NumPy
batch gives NumPy results; a tensor gives a tensor on the rank's device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..api import (
    _check_ogive, _eyes, _mnmf_slots, _mnmf_start, _nmf_init, _ogive_start, _output,
    _sparse_taps,
)
from ..models import auxiva_iss as _iss
from ..models import fastmnmf2 as _mnmf
from ..models import five as _five
from ..models import ilrma as _ilrma
from ..models import ilrma_t as _ilrma_t
from ..models import ogive as _ogive
from ..models import overiva as _core
from ..models import overiva_ip2 as _ip2
from ..models import sparseauxiva as _sparse
from ..models import tip as _tip
from ..models import tiss as _tiss
from ..models.auxiva_pca import pca
from ..models.family import _iss_start
from ..models.online_iss import online_iss_init, online_iss_step
from ..models.online_tiss import online_tiss_init, online_tiss_step
from ..ops import wpe as _wpe
from ..ops.projection import apply_projection_back
from ..oracle.sparseauxiva import _resolve_n_bins, select_bins
from .collectives import assemble
from .mesh import AXIS_BINS, AXIS_MIX, axis_size, rank_device

__all__ = [
    "pad_bins",
    "sharded_overiva",
    "sharded_auxiva_pca",
    "sharded_ogive",
    "sharded_auxiva_iss",
    "sharded_ilrma",
    "sharded_overiva_iss",
    "sharded_overiva_ip2",
    "sharded_fastmnmf2",
    "sharded_five",
    "sharded_ilrma_t",
    "sharded_sparseauxiva",
    "sharded_tip",
    "sharded_tiss",
    "sharded_wpe",
    "sharded_online_iss",
    "sharded_online_tiss",
]


def pad_bins(F: int, n_shards: int):
    """(padded F, per-bin validity mask of length padded F)."""
    F_pad = -(-F // n_shards) * n_shards
    mask = np.zeros(F_pad, np.float32)
    mask[:F] = 1.0
    return F_pad, mask


class _Block:
    """This rank's block of a batch X (B, T, F, M) on the mesh: its
    mixtures ``X`` (nb, T, Fl, M) on its device, the 'bins' group and the
    hook (``group``, ``n_freq``, ``bin_mask``) of the epochs."""

    def __init__(self, mesh, X_batch):
        B, T, F, M = X_batch.shape
        n_mix, n_bins = axis_size(mesh, AXIS_MIX), axis_size(mesh, AXIS_BINS)
        if B % n_mix != 0:
            raise ValueError(f"batch {B} not divisible by mix axis {n_mix}")
        if mesh.size() != dist.get_world_size():
            raise ValueError("the mesh must span every rank of the process group")
        i_mix, self.i_bins = mesh.get_coordinate()
        self.numpy_in = not isinstance(X_batch, torch.Tensor)
        self.device = rank_device(mesh.device_type, dist.get_rank())
        self.B, self.F = B, F
        self.nb = B // n_mix
        self.mixes = slice(i_mix * self.nb, (i_mix + 1) * self.nb)
        self.F_pad, mask = pad_bins(F, n_bins)
        Fl = self.F_pad // n_bins
        self.bins = slice(self.i_bins * Fl, (self.i_bins + 1) * Fl)
        # the padded bins replicate bin F - 1
        self.idx = torch.clamp(torch.arange(self.bins.start, self.bins.stop), max=F - 1)
        self.X_batch = X_batch
        self.X = self.local(self.mixtures())
        self.group = mesh.get_group(AXIS_BINS)
        mask_l = torch.as_tensor(mask[self.bins], dtype=self.X.real.dtype, device=self.device)
        self.hook = dict(group=self.group, n_freq=F, bin_mask=mask_l)

    def mixtures(self):
        """This rank's mixtures, every bin: (nb, T, F, M) on its device."""
        Xm = self.X_batch[self.mixes]
        if not isinstance(Xm, torch.Tensor):
            Xm = torch.from_numpy(np.ascontiguousarray(Xm))
        return Xm.to(self.device)

    def local(self, t, axis: int = 2):
        """The rank's (replicate-padded) bins of ``t`` along ``axis``."""
        return t.index_select(axis, self.idx.to(t.device))

    def gather(self, Y):
        """The full (B, T, F, K) result on every rank from each rank's
        block Y (nb, T, Fl, K); NumPy for a NumPy batch."""
        full = Y.new_zeros((self.B, Y.shape[1], self.F_pad, Y.shape[3]))
        full[self.mixes, :, self.bins] = Y
        return _output(assemble(full)[:, :, : self.F], self.numpy_in)

    def output(self, Y, X, proj_back: bool):
        """:meth:`gather` of the folded outputs Y (T, nb*Fl, K), scaled by
        projection back against mic 0 of the folded X when ``proj_back``
        (per bin: no collective)."""
        if proj_back:
            Y = apply_projection_back(Y, X[:, :, 0])
        return self.gather(_core.unfold_mixtures(Y, self.nb))


# ------------------------------------------------- the single-psum families

def sharded_overiva(mesh, X_batch, n_src: int, n_iter: int = 20, model: str = "laplace",
                    proj_back: bool = True):
    """Separate a batch of mixtures over the mesh.

    X_batch: (B, T, F, M) complex, B divisible by the 'mix' axis size.
    Returns Y: (B, T, F, n_src)."""
    blk = _Block(mesh, X_batch)
    X = _core.fold_mixtures(blk.X)
    W, Cx = _core.prepare(X, int(n_src), False)
    for _ in range(int(n_iter)):
        W = _core._epoch(X, W, Cx, int(n_src), model, n_mix=blk.nb, **blk.hook)
    return blk.output(_core.demix(X, W[:, :n_src, :]), X, proj_back)


def sharded_auxiva_pca(mesh, X_batch, n_src: int, n_iter: int = 20, model: str = "laplace",
                       proj_back: bool = True):
    """PCA + determined AuxIVA over the mesh: the per-bin eigh is local,
    the inner AuxIVA psums its power. Projection back targets the
    original mic 0. Returns Y: (B, T, F, n_src)."""
    blk = _Block(mesh, X_batch)
    X = _core.fold_mixtures(blk.X)
    X_r = pca(X, int(n_src)) if n_src < X.shape[2] else X
    W, Cx = _core.prepare(X_r, int(n_src), False)
    for _ in range(int(n_iter)):
        W = _core._epoch(X_r, W, Cx, int(n_src), model, n_mix=blk.nb, **blk.hook)
    return blk.output(_core.demix(X_r, W), X, proj_back)


def sharded_auxiva_iss(mesh, X_batch, n_iter: int = 20, model: str = "laplace",
                       proj_back: bool = True, n_src: int | None = None):
    """AuxIVA-ISS (or OverIVA-ISS when ``n_src < M``) over the mesh.

    X_batch: (B, T, F, M) complex; returns (B, T, F, n_src or M)."""
    blk = _Block(mesh, X_batch)
    X = _core.fold_mixtures(blk.X)
    W = _iss_start(X, n_src, None)
    Y = _core.demix(X, W)
    for _ in range(int(n_iter)):
        W, Y = _iss._iss_epoch(W, Y, model, n_src, blk.nb, **blk.hook)
    if n_src is not None:
        Y = Y[:, :, :n_src]
    return blk.output(Y, X, proj_back)


def sharded_overiva_iss(mesh, X_batch, n_src: int, n_iter: int = 20, model: str = "laplace",
                        proj_back: bool = True):
    """OverIVA-ISS over the mesh (see ``models/auxiva_iss.py``)."""
    return sharded_auxiva_iss(mesh, X_batch, n_iter=n_iter, model=model, proj_back=proj_back,
                              n_src=n_src)


def sharded_overiva_ip2(mesh, X_batch, n_src: int, n_iter: int = 10, model: str = "laplace",
                        proj_back: bool = True):
    """Pairwise-update OverIVA over the mesh. X_batch: (B, T, F, M) complex;
    returns (B, T, F, n_src). Requires n_src >= 2."""
    if n_src < 2:
        raise ValueError("IP2 needs n_src >= 2")
    blk = _Block(mesh, X_batch)
    X = _core.fold_mixtures(blk.X)
    W, Cx = _core.prepare(X, int(n_src), False)
    for _ in range(int(n_iter)):
        W = _ip2._ip2_epoch(X, W, Cx, int(n_src), model, n_mix=blk.nb, **blk.hook)
    return blk.output(_core.demix(X, W[:, :n_src, :]), X, proj_back)


def sharded_five(mesh, X_batch, n_iter: int = 10, model: str = "laplace",
                 proj_back: bool = True):
    """FIVE single-source extraction over the mesh: whitening, the
    minimum eigenvectors and their phases are per bin, the power psums.
    Returns Y: (B, T, F, 1)."""
    blk = _Block(mesh, X_batch)
    X = _core.fold_mixtures(blk.X)
    Xw, _ = _five.five_whiten(X)
    w = _five.five_iterations(Xw, _five.five_init(Xw), int(n_iter), model, blk.nb, **blk.hook)
    return blk.output(_five.five_demix(Xw, w)[:, :, None], X, proj_back)


def sharded_ogive(mesh, X_batch, n_iter: int = 4000, step_size: float = 0.1, tol: float = 1e-3,
                  model: str = "laplace", update: str = "demix", switch_every: int = 10,
                  proj_back: bool = True):
    """OGIVE extraction of a batch of mixtures over the mesh. Returns Y:
    (B, T, F, 1). Convergence is global: the criterion is pmax'd over the
    'bins' group, so every rank of a mixture stops at the same epoch, that
    of the single-device run."""
    _check_ogive(update, model)
    blk = _Block(mesh, X_batch)
    X = _core.fold_mixtures(blk.X)
    w, a, use_mix, Cx, Cx_inv, epoch, done, mu, tolt = _ogive_start(
        X, step_size, tol, False, blk.nb)
    w, *_ = _ogive.ogive_iterations(X, w, a, use_mix, Cx, Cx_inv, epoch, done, mu, tolt,
                                    int(n_iter), model, update, int(switch_every), blk.nb,
                                    **blk.hook)
    return blk.output(_ogive.ogive_demix(X, w)[:, :, None], X, proj_back)


def sharded_tiss(mesh, X_batch, n_src: int | None = None, taps: int = 5, delay: int = 2,
                 n_iter: int = 20, model: str = "laplace", proj_back: bool = True):
    """T-ISS (joint dereverberation + separation) over the mesh: the tap
    stack is a frame shift, bin-local. Returns (B, T, F, n_src or M)."""
    blk = _Block(mesh, X_batch)
    M = blk.X.shape[3]
    Xt = _core.fold_mixtures(_tiss.augment_taps(blk.X, int(taps), int(delay)))
    P = _tiss.augmented_eye(Xt, M)
    Y = _core.demix(Xt, P)
    for _ in range(int(n_iter)):
        P, Y = _tiss._tiss_epoch(Xt, P, Y, model, M, n_src, blk.nb, **blk.hook)
    if n_src is not None:
        Y = Y[:, :, :n_src]
    return blk.output(Y, _core.fold_mixtures(blk.X), proj_back)


def sharded_tip(mesh, X_batch, n_src: int | None = None, taps: int = 5, delay: int = 2,
                n_iter: int = 10, warm_iter: int = 10, model: str = "laplace",
                proj_back: bool = True):
    """T-IP (exact IP rows, warm-started by T-ISS epochs) over the mesh.
    Returns (B, T, F, n_src or M)."""
    blk = _Block(mesh, X_batch)
    M = blk.X.shape[3]
    Xt = _core.fold_mixtures(_tiss.augment_taps(blk.X, int(taps), int(delay)))
    P = _tiss.augmented_eye(Xt, M)
    if warm_iter > 0 and taps > 0:
        Y = _core.demix(Xt, P)
        for _ in range(int(warm_iter)):
            P, Y = _tiss._tiss_epoch(Xt, P, Y, model, M, n_src, blk.nb, **blk.hook)
    # the background (phi = 1) pieces are run-constant and bin-local
    bg = _tip._background_pieces(Xt, M, n_mix=blk.nb) if n_src is not None and n_src < M else None
    for _ in range(int(n_iter)):
        P = _tip._tip_epoch(Xt, P, model, M, n_src, bg=bg, n_mix=blk.nb, **blk.hook)
    N = M if n_src is None else n_src
    return blk.output(_core.demix(Xt, P[:, :N, :]), _core.fold_mixtures(blk.X), proj_back)


# ------------------------------------------------ the NMF-weighted families

def _nmf_block(blk, N, n_components, seed, dtype):
    """The NMF start of this rank's mixtures (seeds seed + b, b global):
    basis (nb, N, Fl, K) on its bins, activations (nb, N, K, T)."""
    B0, H0 = _nmf_init(range(seed + blk.mixes.start, seed + blk.mixes.stop), N, blk.F,
                       int(n_components), blk.X.shape[1], dtype, blk.device)
    return blk.local(B0), H0


def sharded_ilrma(mesh, X_batch, n_iter: int = 20, n_components: int = 2, seed: int = 0,
                  proj_back: bool = True):
    """Determined ILRMA over the mesh. X_batch: (B, T, F, M) complex.

    NMF init matches ``api.ilrma(seed=seed + b)`` per batch element; the
    padded bins' basis rows replicate the last real bin's (masked out of
    the psum'd activation updates)."""
    blk = _Block(mesh, X_batch)
    nb, T, Fl, M = blk.X.shape
    B, H = _nmf_block(blk, M, n_components, seed, blk.X.dtype)
    W = _eyes(nb, Fl, M, blk.X.dtype, blk.device)
    for _ in range(int(n_iter)):
        W, B, H = _ilrma._ilrma_epoch(blk.X, W, B, H, **blk.hook)
    X = _core.fold_mixtures(blk.X)
    return blk.output(_core.fold_mixtures(_ilrma.ilrma_demix(blk.X, W)), X, proj_back)


def sharded_ilrma_t(mesh, X_batch, taps: int = 5, delay: int = 2, n_iter: int = 20,
                    n_components: int = 2, seed: int = 0, proj_back: bool = True):
    """Determined ILRMA-T (joint dereverberation + ILRMA) over the mesh.
    NMF init as :func:`sharded_ilrma` (``api.ilrma_t(seed=seed + b)``)."""
    blk = _Block(mesh, X_batch)
    nb, T, Fl, M = blk.X.shape
    B, H = _nmf_block(blk, M, n_components, seed, blk.X.dtype)
    Xt = _tiss.augment_taps(blk.X, int(taps), int(delay))
    P = _tiss.augmented_eye(Xt[0], M).expand(nb, -1, -1, -1)
    Y = _ilrma_t.ilrma_t_demix(Xt, P)
    for _ in range(int(n_iter)):
        P, Y, B, H = _ilrma_t._ilrma_t_epoch(Xt, P, Y, B, H, M, **blk.hook)
    return blk.output(_core.fold_mixtures(Y), _core.fold_mixtures(blk.X), proj_back)


def sharded_fastmnmf2(mesh, X_batch, n_src: int | None = None, n_iter: int = 30,
                      n_components: int = 2, mic_index: int = 0, n_noise="auto", seed: int = 0,
                      tie_g: bool = True):
    """FastMNMF2 (or FastMNMF1 with ``tie_g=False``) over the mesh.
    X_batch: (B, T, F, M) complex.

    The start is ``api.fastmnmf2(seed=seed + b)``'s: the unit power over
    all of a mixture's bins, then the whitening Q of the rank's bins alone,
    g and the NMF init sliced to them. The padded bins' rows replicate the
    last real bin's, masked out of the psum'd statistics. FastMNMF1's per-bin g updates locally. The
    loudest outputs are picked by energies psum'd over the 'bins' group."""
    blk = _Block(mesh, X_batch)
    M = blk.X.shape[3]
    N_out, N = _mnmf_slots(n_src, n_noise, M, "whiten")
    seeds = range(seed + blk.mixes.start, seed + blk.mixes.stop)
    Xu, x_scale, (Q, g, W, H) = _mnmf_start(blk.mixtures(), N, n_components, seeds, "whiten",
                                           tie_g, local=blk.local)
    hook = dict(group=blk.group, bin_mask=blk.hook["bin_mask"])
    for _ in range(int(n_iter)):
        Q, g, W, H = _mnmf._epoch(Xu, Q, g, W, H, **hook)
    Y = _mnmf.fastmnmf2_wiener(Xu, Q, g, W, H, int(mic_index)) * x_scale
    return blk.gather(_mnmf.pick_loudest(Y, N_out, **hook))


# --------------------------------------------------------------- SparseAuxIVA

def sharded_sparseauxiva(mesh, X_batch, S=None, n_bins=None, n_iter: int = 20,
                         model: str = "laplace", lasso_iter: int = 300, lasso_lam: float = 0.05,
                         filter_taps=None, acausal_taps=None, polish_iter: int = 3,
                         proj_back: bool = True):
    """SparseAuxIVA (determined) over the mesh. X_batch: (B, T, F, M)
    complex; returns (B, T, F, M), ``api.sparseauxiva`` per element.

    Phase 1 runs IP on the selected bins, sharded over the 'bins' axis
    with one power psum an epoch; the k demixing matrices are then
    gathered to every rank of the 'bins' group (one (k, M, M) assemble),
    the FISTA products run replicated, and each rank keeps its own bins of
    the reconstruction; phase 3's polish is the single-psum IP epoch.

    ``S``: (k,) shared or (B, k) per element; defaults to the stratified
    top-power selection of each element (the oracle copy's
    ``select_bins``)."""
    B, T, F, M = X_batch.shape
    nfft, n_causal, n_acausal = _sparse_taps(F, filter_taps, acausal_taps)
    if S is None:
        k = _resolve_n_bins(n_bins, F, M)
        Xh = X_batch.cpu().numpy() if isinstance(X_batch, torch.Tensor) else np.asarray(X_batch)
        S_arr = np.stack([select_bins(Xh[b], k) for b in range(B)])
    else:
        S_arr = np.asarray(S, np.int64)
        if S_arr.ndim == 1:
            S_arr = np.tile(S_arr[None, :], (B, 1))
        if S_arr.shape[0] != B:
            raise ValueError("S must be (k,) or (B, k)")
        if (S_arr.shape[1] == 0 or S_arr.min() < 0 or S_arr.max() >= F
                or np.any(np.diff(S_arr, axis=1) <= 0)):
            raise ValueError("each S row must be strictly increasing bin indices < F")
    k = S_arr.shape[1]
    if k >= F:
        raise ValueError("all bins selected: use sharded_overiva instead")
    blk = _Block(mesh, X_batch)
    S_loc = S_arr[blk.mixes]

    # phase 1: IP on the selected bins, sharded over the k axis
    k_pad, k_mask = pad_bins(k, axis_size(mesh, AXIS_BINS))
    kl = k_pad // axis_size(mesh, AXIS_BINS)
    k_bins = slice(blk.i_bins * kl, (blk.i_bins + 1) * kl)
    S_pad = np.concatenate([S_loc, np.tile(S_loc[:, -1:], (1, k_pad - k))], axis=1)
    S_t = torch.as_tensor(S_pad[:, k_bins], device=blk.device)
    Xm = blk.mixtures()
    Xs = _core.fold_mixtures(torch.gather(Xm, 2, S_t[:, None, :, None].expand(-1, T, -1, M)))
    W, Cx = _core.prepare(Xs, M, False)
    hook = dict(group=blk.group, n_freq=k,
                bin_mask=torch.as_tensor(k_mask[k_bins], dtype=Xm.real.dtype, device=blk.device))
    for _ in range(int(n_iter)):
        W = _core._epoch(Xs, W, Cx, M, model, n_mix=blk.nb, **hook)
    Ws = W.new_zeros((blk.nb, k_pad, M, M))
    Ws[:, k_bins] = W.reshape(blk.nb, kl, M, M)
    Ws = assemble(Ws, blk.group)[:, :k]

    # phases 2 + 3: the reconstruction (replicated), then the polish on
    # the rank's bins of the full band
    W = _sparse.sparse_reconstruct(Ws, S_loc, F, nfft, n_causal, n_acausal, int(lasso_iter),
                                   float(lasso_lam))
    X = _core.fold_mixtures(blk.X)
    W, Cx = _core.prepare(X, M, False, W0=blk.local(W, 1).reshape(-1, M, M))
    for _ in range(int(polish_iter)):
        W = _core._epoch(X, W, Cx, M, model, n_mix=blk.nb, **blk.hook)
    return blk.output(_core.demix(X, W), X, proj_back)


# ------------------------------------------------------------------------ WPE

def sharded_wpe(mesh, X_batch, taps: int = 10, delay: int = 3, n_iter: int = 3,
                diag_load: float = 1e-5):
    """WPE-dereverberate a batch of mixtures over the mesh: (B, T, F, M)
    -> (B, T, F, M). Every bin is local, so there is no collective at all
    (as in the JAX package, the activation floor's mean is over the rank's
    own bins). The padded bins are sliced off on the way out."""
    blk = _Block(mesh, X_batch)
    return blk.gather(_wpe.wpe(blk.X, int(taps), int(delay), int(n_iter), float(diag_load)))


# ------------------------------------------------------------------ streaming

def _streams(blk, block: int, step):
    """Each of this rank's streams, block by block through ``step(X_blk,
    state) -> (Y_blk, state)`` from ``step``'s own start; (nb, T, Fl, M)."""
    T = blk.X.shape[1]
    outs = []
    for x in blk.X:  # the rank's streams one after the other
        state, ys = None, []
        for t0 in range(0, T, block):
            Y, state = step(x[t0:t0 + block], state)
            ys.append(Y)
        outs.append(torch.cat(ys))
    return torch.stack(outs)


def _check_stream(X_batch, block):
    T = X_batch.shape[1]
    if T % int(block) != 0:
        raise ValueError(f"stream length {T} not divisible by block {block}")


def sharded_online_iss(mesh, X_batch, block: int, forget: float = 0.97, model: str = "laplace",
                       n_pass: int = 1, pb_forget: float | None = None):
    """Streaming AuxIVA-ISS over the mesh: B parallel streams data-parallel
    on 'mix' and bin-sharded on 'bins', block by block with exponentially
    forgotten statistics. X_batch: (B, T, F, M) complex, T divisible by
    ``block``; returns (B, T, F, M), each stream what
    ``api.OnlineAuxIVAISS`` gives for the same blocks. Each pass costs one
    (block, M) power psum; a rank's streams run one after the other."""
    _check_stream(X_batch, block)
    blk = _Block(mesh, X_batch)
    Fl, M = blk.X.shape[2:]
    rdt = blk.X.real.dtype
    f = torch.tensor(forget, dtype=rdt, device=blk.device)
    pb = None if pb_forget is None else torch.tensor(pb_forget, dtype=rdt, device=blk.device)

    def step(x, state):
        state = state or online_iss_init(Fl, M, blk.X.dtype, blk.device)
        return online_iss_step(x, state, f, model, int(n_pass), pb_forget=pb, **blk.hook)

    return blk.gather(_streams(blk, int(block), step))


def sharded_online_tiss(mesh, X_batch, block: int, taps: int = 4, delay: int = 2,
                        forget: float = 0.97, model: str = "laplace", n_pass: int = 1,
                        pb_forget: float | None = None, tap_forget: float | None = None,
                        tap_update: str = "solve", diag_load: float = 1e-5):
    """Streaming joint dereverberation + separation (online T-ISS) over
    the mesh, as :func:`sharded_online_iss`; each stream is what
    ``api.OnlineTISS`` gives. The tap statistics and their solve are per
    bin, so the collectives are those of online ISS."""
    _check_stream(X_batch, block)
    if tap_update not in ("solve", "steer"):
        raise ValueError("tap_update must be 'solve' or 'steer'")
    blk = _Block(mesh, X_batch)
    Fl, M = blk.X.shape[2:]
    rdt = blk.X.real.dtype

    def scalar(v):
        return None if v is None else torch.tensor(v, dtype=rdt, device=blk.device)

    f, pb, tf = scalar(forget), scalar(pb_forget), scalar(tap_forget)

    def step(x, state):
        state = state or online_tiss_init(Fl, M, int(taps), int(delay), tap_update, blk.X.dtype,
                                          blk.device)
        return online_tiss_step(x, state, f, int(taps), int(delay), model, int(n_pass),
                                pb_forget=pb, tap_update=tap_update, diag_load=float(diag_load),
                                tap_forget=tf, **blk.hook)

    return blk.gather(_streams(blk, int(block), step))
