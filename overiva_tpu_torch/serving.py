"""Serving tier: variable-length clips on a frame-bucket grid
(:class:`Separator`), and sample streams (:class:`StreamingSeparator`),
with the work on the device and only samples crossing the host boundary.

Counterpart of ``overiva_tpu/serving.py`` without its ``mesh`` option
(multi-device serving waits for the port's parallel tier, ROADMAP item
17).

**Clips.** A clip is padded so that its STFT lands on a geometric grid of
frame counts (:func:`bucket_frames`, ~``bucket_ratio``-spaced, so the
padding overhead is bounded by ``bucket_ratio - 1``). Every frame before
the clip's own is zeroed in the STFT domain, and the algorithm runs on
the bucketed tensor. The JAX package needs the grid to bound its compiled
executables. Here it decides the same results (which frames are zero and
how many there are, which clips share a batched run, ``stats``), so the
port keeps it exactly; one CUDA graph per (bucket, n_chan) is what the
grid makes possible later. The path from the upload of the samples to
the download of the separated samples (analysis, the frame mask, the
algorithm, projection back, synthesis, the int16 quantization) is torch
ops on the device that read nothing back to the host. Correctness rests
on an algebraic property of the IP/ISS family, not on approximation:

- an all-zero frame contributes nothing to any data statistic: the
  per-frame power and every weighted covariance carry an ``|x|^2``
  factor, so a huge padded-frame weight ``phi`` multiplies zero;
- the padded frame count enters only as the ``1/T`` normalization of
  ``Cx`` and the weighted covariances, a global scalar per epoch. The IP
  normalizer ``w^H V w = 1`` re-pins every row's scale each epoch, so the
  padded trajectory stays a per-source scalar multiple of the unpadded
  one, and projection back against the masked reference channel cancels
  that scalar exactly.

Padding is prepended, which extends exactness to the tap-augmented joint
family (tiss/tip): delayed copies of leading zero frames are zero, and
the first real frames' taps reach back into zeros exactly as the
unpadded run's zero fill does. Appended padding would put real data in
the padded frames' tap blocks.

NMF-family algorithms (ilrma, ilrma-t, fastmnmf*) are not
padding-invariant (their multiplicative-update denominators sum model
terms over frames without an ``|x|^2`` factor), and sparseauxiva's LASSO
threshold is scale-absolute. :data:`SERVABLE` lists the algorithms whose
invariance is gated (``tests/test_torch_serving.py``); anything else
needs ``allow_unverified=True`` and runs through the registry runner.

**Streams.** Each block runs framing, STFT analysis (``ops/stft.py``),
the online step (``models/online_iss.py`` or ``models/online_tiss.py``),
synthesis and the overlap-add with the carry of the block before, all as
torch ops on the device; the analysis and synthesis windows are built on
the device once, in the constructor. Nothing in
:meth:`StreamingSeparator.process` reads a value back to the host.
"""

from __future__ import annotations

import math
from collections import Counter

import numpy as np
import torch

from . import api, resolve_device
from .api import (
    DEFAULT_DTYPE, _check_model, _check_taps, _output, _real_np, restored_state,
)
from .models import five as _five
from .models import tip as _tip
from .models import tiss as _tiss
from .models.auxiva_pca import auxiva_pca_run
from .models.family import run_family
from .models.online_iss import online_iss_init, online_iss_step
from .models.online_tiss import online_tiss_init, online_tiss_step
from .models.overiva import demix, fold_mixtures, unfold_mixtures
from .ops import stft as _stft
from .ops.projection import apply_projection_back
from .oracle.stft import hann, stft_pad, synthesis_window
from .registry import get_algorithm
from .utils.checkpoint import load_state, save_state
from .utils.convert import as_tensor, state_to_numpy, to_torch_dtype

__all__ = ["SERVABLE", "Separator", "StreamingSeparator", "bucket_frames"]

# Padding invariance of every name here is gated against the unpadded
# pipeline by tests/test_torch_serving.py. Keep the two lists in sync when
# adding a family.
SERVABLE = (
    "auxiva",
    "auxiva-gauss",
    "auxiva-iss",
    "auxiva-iss-gauss",
    "overiva",
    "overiva-gauss",
    "overiva-iss",
    "overiva-iss-gauss",
    "overiva-ip2",
    "overiva-ip2-gauss",
    "auxiva_pca",
    "auxiva_pca-iss",
    "five",
    # joint dereverberation + separation: exact because the padding is
    # prepended (ilrma-t stays out: NMF model)
    "tiss",
    "tiss-gauss",
    "tip",
    "tip-gauss",
)

# registry name -> (fused branch, default model). Every SERVABLE family has
# a branch in _spectral below. "pca" resolves to pca_ip / pca_iss from the
# ``inner`` kwarg at Separator construction.
_FUSED_BRANCH = {
    "auxiva": ("ip", "laplace"),
    "auxiva-gauss": ("ip", "gauss"),
    "auxiva-iss": ("iss", "laplace"),
    "auxiva-iss-gauss": ("iss", "gauss"),
    "overiva": ("ip", "laplace"),
    "overiva-gauss": ("ip", "gauss"),
    "overiva-iss": ("iss", "laplace"),
    "overiva-iss-gauss": ("iss", "gauss"),
    "overiva-ip2": ("ip2", "laplace"),
    "overiva-ip2-gauss": ("ip2", "gauss"),
    "auxiva_pca": ("pca", "laplace"),
    "auxiva_pca-iss": ("pca", "laplace"),
    "five": ("five", "laplace"),
    "tiss": ("tiss", "laplace"),
    "tiss-gauss": ("tiss", "gauss"),
    "tip": ("tip", "laplace"),
    "tip-gauss": ("tip", "gauss"),
}


def bucket_frames(
    n_frames: int,
    min_frames: int = 32,
    ratio: float = 1.25,
    multiple: int = 8,
) -> int:
    """Smallest grid frame count >= n_frames.

    The grid starts at ``min_frames`` (rounded up to ``multiple``) and
    grows geometrically by ``ratio``: compute cost is linear in frames, so
    the worst-case padding overhead is ``ratio - 1`` while the number of
    distinct shapes stays logarithmic in the clip-length range.
    """
    if n_frames <= 0:
        raise ValueError("n_frames must be positive")
    b = -(-int(min_frames) // multiple) * multiple
    while b < n_frames:
        b = -(-int(max(b * ratio, b + multiple)) // multiple) * multiple
    return b


# ------------------------------------------------------------ the clip path

def _spectral(X, n_src, n_iter, model, branch, taps, delay, warm_iter, wcov, n_mix=1):
    """Masked STFT (T, F, M) in -> projected sources (T, F, n_out) out.

    Each branch starts and iterates as its registry runner does, through
    the same model functions (``run_family`` for ip, ip2 and iss,
    ``auxiva_pca_run`` for the PCA pair), so the clip path runs the
    unpadded pipeline's trajectory. ``n_mix`` > 1: X holds that many
    folded clips (``fold_mixtures``), each with its own activations; the
    batch forms have no ``wcov`` tier, so a folded X runs f32 only.
    """
    M = X.shape[2]
    N = M if n_src is None else int(n_src)
    if branch in ("ip", "ip2", "iss"):
        # ip/ip2: Cx only when N < M (models/overiva.py::prepare);
        # iss: from the identity
        Y, _ = run_family(X, N, n_iter, model, branch, wcov=wcov, n_mix=n_mix)
    elif branch in ("pca_ip", "pca_iss"):
        Y, _ = auxiva_pca_run(X, N, n_iter, model, inner=branch[4:], n_mix=n_mix)
    elif branch == "five":
        Xw, _ = _five.five_whiten(X)
        # from e_0 in the whitened domain, as api.five starts
        w = _five.five_iterations(Xw, _five.five_init(Xw), n_iter, model, n_mix)
        Y = _five.five_demix(Xw, w)[:, :, None]
    elif branch in ("tiss", "tip"):
        Xt = _tiss.augment_taps(X, taps, delay)
        P = _tiss.augmented_eye(Xt, M)
        if branch == "tiss":
            _, Y = _tiss.tiss_iterations(Xt, P, n_iter, model, M, N, n_mix=n_mix)
        else:
            if warm_iter > 0 and taps > 0:  # api.tip's built-in warm start
                P, _ = _tiss.tiss_iterations(Xt, P, warm_iter, model, M, N, n_mix=n_mix)
            P = _tip.tip_iterations(Xt, P, n_iter, model, M, N, wcov, n_mix=n_mix)
            Y = demix(Xt, P)
        Y = Y[:, :, :N]
    else:
        raise ValueError(f"unknown fused branch {branch!r}")
    # projection back against the masked reference channel: this is what
    # cancels the bucket-dependent covariance scale
    return apply_projection_back(Y, X[:, :, 0])


def _pcm16(y):
    """Quantize separated float samples to int16 PCM on the device:
    round half to even at scale 32768 (``torch.round`` rounds as
    ``np.round`` does), then saturate before the cast, so the values are
    those a host-side wav writer produces."""
    return torch.clamp(torch.round(y * 32768.0), -32768.0, 32767.0).to(torch.int16)


def _masked_clip(x, t_pad, nfft, hop, cfg, win, win_s, pcm_out=False):
    """Bucketed samples on the device -> separated samples (or int16 PCM).

    x: (n_bucket, M), or (B, n_bucket, M) for a group of clips; int16 is
    widened and scaled by 2^-15 here, both exact, so it gives the values
    of ``x.astype(rd) / 32768``. ``t_pad``: the padded frame count, a
    Python int (or 0-d tensor) for one clip, a (B,) tensor for a group.
    """
    if not x.is_floating_point():
        x = x.to(win.dtype) * (1.0 / 32768.0)
    X = _stft.analysis(x, nfft, hop, win)
    # the last prepended frames straddle the padding/real boundary (hop
    # overlap): zero every padded frame in the STFT domain, so that padded
    # frames are exactly zero, as the invariance argument needs
    frames = torch.arange(X.shape[-3], device=X.device)
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    if X.ndim == 4:
        B = X.shape[0]
        keep = frames[None, :] >= t_pad[:, None]
        X = torch.where(keep[:, :, None, None], X, zero)
        Y = unfold_mixtures(_spectral(fold_mixtures(X), n_mix=B, **cfg), B)
    else:
        X = torch.where((frames >= t_pad)[:, None, None], X, zero)
        Y = _spectral(X, **cfg)
    y = _stft.synthesis(Y, nfft, hop, win_s)
    return _pcm16(y) if pcm_out else y


def _is_int16(x):
    return x.dtype == (torch.int16 if isinstance(x, torch.Tensor) else np.int16)


class Separator:
    """Fixed-configuration separator for variable-length clips.

    One instance = one algorithm + STFT configuration + device:

        sep = Separator("overiva", n_src=2, nfft=2048)
        y = sep.separate(x)          # x: (n_samples, n_chan)
        # y: (n_samples, n_src), the samples the unpadded pipeline yields

    ``algo_kwargs`` are forwarded to the algorithm on every clip (n_iter,
    model, wcov, ...). ``proj_back=False`` is refused: projection back is
    what cancels the bucket-dependent global scale (module docstring).

    Every SERVABLE family runs through the device-resident clip path: the
    samples go up once, everything from analysis to synthesis runs on the
    device without reading a value back, and the separated samples come
    down once. A NumPy clip gives a NumPy result, a tensor a tensor on
    ``device``. int16 PCM input is uploaded as int16 and scaled 1/32768
    on the device, bit-identical to the float path; ``out_dtype=np.int16``
    quantizes the output on the device (round half to even at 32768,
    saturating), as a wav writer would on the host. Kwargs outside the
    fused surface (callback, W0, return_filters, chunk_frames, acc, ...)
    and ``allow_unverified`` algorithms go through the registry runner
    instead, on the same device.

    ``device`` as in :func:`overiva_tpu_torch.resolve_device` (default
    CUDA; without a card pass ``device="cpu"``). ``mesh`` is refused: the
    port's multi-device tier is ROADMAP item 17.
    """

    # kwargs each fused branch accepts (beyond n_iter/model, always taken)
    _BRANCH_KW = {
        "ip": {"wcov"},
        "ip2": {"wcov"},
        "iss": set(),
        "pca_ip": set(),
        "pca_iss": set(),
        "five": set(),
        "tiss": {"taps", "delay"},
        "tip": {"taps", "delay", "warm_iter", "wcov"},
    }

    def __init__(
        self,
        algo: str = "overiva",
        n_src: int | None = None,
        nfft: int = 2048,
        hop: int | None = None,
        dtype=None,
        min_frames: int = 32,
        bucket_ratio: float = 1.25,
        bucket_multiple: int = 8,
        allow_unverified: bool = False,
        out_dtype=None,
        mesh=None,
        device=None,
        **algo_kwargs,
    ):
        if mesh is not None:
            raise ValueError(
                "mesh serving is not in the port yet: it needs the port's "
                "parallel tier (parallel/mesh.py, ROADMAP item 17)"
            )
        self.spec = get_algorithm(algo)
        if algo not in SERVABLE and not allow_unverified:
            raise ValueError(
                f"algorithm {algo!r} is not verified padding-invariant "
                f"(servable: {', '.join(SERVABLE)}); NMF-family updates "
                "change under zero-frame padding. Pass "
                "allow_unverified=True to serve it anyway."
            )
        if algo_kwargs.get("proj_back") is False:
            raise ValueError(
                "serving requires proj_back=True: projection back cancels "
                "the bucket-dependent covariance scale (see module docstring)"
            )
        if self.spec.single_output and n_src not in (None, 1):
            raise ValueError(f"{algo!r} always extracts one source")
        if out_dtype is not None and np.dtype(out_dtype) != np.int16:
            raise ValueError(
                f"out_dtype must be None (float) or int16, got {out_dtype!r}"
            )
        self.algo = algo
        self.n_src = n_src
        self.nfft = int(nfft)
        self.hop = int(hop or nfft // 2)
        self.dtype = dtype
        self.pcm_out = out_dtype is not None
        self.min_frames = int(min_frames)
        self.bucket_ratio = float(bucket_ratio)
        self.bucket_multiple = int(bucket_multiple)
        self.algo_kwargs = dict(algo_kwargs)
        self._fused = self._fused_config()
        self.device = resolve_device(device)
        self._rdt = to_torch_dtype(dtype or DEFAULT_DTYPE).to_real()
        # the windows live on the device, built once: nothing in a clip's
        # run copies from the host
        win = hann(self.nfft)
        self._win = torch.as_tensor(win, dtype=self._rdt).to(self.device)
        self._win_s = torch.as_tensor(synthesis_window(win, self.hop),
                                      dtype=self._rdt).to(self.device)
        self.stats = {
            "clips": 0,
            "frames_real": 0,
            "frames_padded": 0,
            "bucket_hits": Counter(),
        }

    def _fused_config(self) -> dict | None:
        """Static config of the device-resident path, or None -> registry
        runner."""
        ent = _FUSED_BRANCH.get(self.algo)
        if ent is None:
            return None
        branch, model = ent
        params = {**self.spec.defaults, **self.algo_kwargs}
        params.pop("proj_back", None)  # always True here (checked above)
        if branch == "pca":
            inner = params.pop("inner", "ip")
            if inner not in ("ip", "iss"):
                return None
            branch = f"pca_{inner}"
        allowed = self._BRANCH_KW[branch]
        cfg = dict(
            branch=branch,
            model=str(params.pop("model", model)),
            n_iter=int(params.pop("n_iter", 20)),
            taps=int(params.pop("taps", 0)) if "taps" in allowed else 0,
            delay=int(params.pop("delay", 2)) if "delay" in allowed else 2,
            warm_iter=(
                int(params.pop("warm_iter", 0)) if "warm_iter" in allowed else 0
            ),
            wcov=str(params.pop("wcov", "f32")) if "wcov" in allowed else "f32",
        )
        if params:  # kwargs outside the fused surface -> registry runner
            return None
        if cfg["branch"] == "tip" and cfg["wcov"] == "bf16pack":
            raise ValueError(
                "wcov='bf16pack' is untested on the tap-augmented epochs "
                "— use wcov='bf16' for T-IP serving"
            )
        return cfg

    @property
    def fused(self) -> bool:
        """Whether clips run through the device-resident clip path."""
        return self._fused is not None

    # -- bucket plumbing ---------------------------------------------------

    def _bucket(self, n_frames: int) -> int:
        return bucket_frames(
            n_frames, self.min_frames, self.bucket_ratio, self.bucket_multiple
        )

    def n_buckets(self) -> int:
        """Distinct (frame-bucket, n_chan) shapes seen so far."""
        return len(self.stats["bucket_hits"])

    def _rdtype(self):
        """The NumPy real dtype of the working precision."""
        return _real_np(to_torch_dtype(self.dtype or DEFAULT_DTYPE))

    def _t_real_of(self, n_samples: int) -> int:
        """Frame count the clip path produces for an ``n_samples`` clip."""
        xp_len = stft_pad(np.empty(n_samples), self.nfft, self.hop).shape[0]
        return (xp_len - self.nfft) // self.hop + 1

    def _prep_clip(self, n_samples: int):
        """(t_real, t_bucket, t_pad, n_bucket) of an ``n_samples`` clip.

        The padding goes at the front (module docstring: tap exactness):
        the clip starts at sample ``t_pad * hop + nfft - hop`` of the
        bucket, after its own ``stft_pad`` front zeros. The +hop-1 tail
        fixes the per-bucket sample count when hop does not divide nfft
        (analysis ignores samples past the last frame)."""
        t_real = self._t_real_of(n_samples)
        t_bucket = self._bucket(t_real)
        t_pad = t_bucket - t_real
        n_bucket = (t_bucket - 1) * self.hop + self.nfft + (self.hop - 1)
        return t_real, t_bucket, t_pad, n_bucket

    def _start(self, t_pad: int) -> int:
        """The bucket sample where a clip with ``t_pad`` padded frames
        starts: after the padding and its own ``stft_pad`` front zeros."""
        return t_pad * self.hop + self.nfft - self.hop

    def _place(self, xb, clip, t_pad: int):
        """Write ``clip`` into the zeroed bucket ``xb`` after its padding."""
        start = self._start(t_pad)
        xb[start : start + clip.shape[0]] = clip

    def _count(self, t_real: int, t_pad: int, n_chan: int) -> None:
        self.stats["clips"] += 1
        self.stats["frames_real"] += t_real
        self.stats["frames_padded"] += t_pad
        self.stats["bucket_hits"][(t_pad + t_real, n_chan)] += 1

    def _to_float(self, x):
        """int16 PCM -> the working real dtype, scaled 1/32768 (exact)."""
        if isinstance(x, torch.Tensor):
            return x.to(self._rdt) * (1.0 / 32768.0)
        rd = self._rdtype()
        return x.astype(rd) / np.asarray(32768, rd)

    @staticmethod
    def _clip2d(x, i=None):
        x = x if isinstance(x, torch.Tensor) else np.asarray(x)
        if x.ndim == 1:
            x = x[:, None]
        if x.ndim != 2:
            where = "" if i is None else f"clip {i}: "
            raise ValueError(f"{where}expected (n_samples, n_chan), got {tuple(x.shape)}")
        return x

    def _upload(self, x):
        """A clip on the device: int16 stays int16, the rest becomes the
        working real dtype."""
        return as_tensor(x, None if _is_int16(x) else self._rdt, self.device)

    # -- the clip path -----------------------------------------------------

    def separate(self, x):
        """(n_samples, n_chan) -> (n_samples, n_out).

        The output samples match the unpadded pipeline
        ``stft_synthesis(algo(stft_analysis(stft_pad(x))))`` trimmed back
        to the input span (``tests/test_torch_serving.py`` gates this per
        algorithm). int16 output when ``out_dtype=np.int16``, else the
        working real dtype.
        """
        numpy_in = not isinstance(x, torch.Tensor)
        x = self._clip2d(x)
        n, n_chan = x.shape
        if _is_int16(x) and self._fused is None:
            # the registry runner has no cast stage: convert first
            x = self._to_float(x)
        t_real, _, t_pad, n_bucket = self._prep_clip(n)
        xd = self._upload(x)
        xb = xd.new_zeros((n_bucket, n_chan))
        self._place(xb, xd, t_pad)
        if self._fused is None:
            y = self._separate_host(xb[None], [t_pad], batch=False)[0]
        else:
            y = _masked_clip(xb, t_pad, self.nfft, self.hop,
                             dict(n_src=self.n_src, **self._fused), self._win,
                             self._win_s, self.pcm_out)
        self._count(t_real, t_pad, n_chan)
        start = self._start(t_pad)
        return _output(y[start : start + n], numpy_in)

    def _separate_host(self, xb, t_pads, batch=True):
        """The registry runner's path (``allow_unverified`` algorithms,
        kwargs outside the fused surface): bucketed clips (B, n_bucket, M)
        through ``stft_analysis_batch``, the padded frames zeroed, the
        runner's ``run_batch`` (``__call__`` for one clip of
        :meth:`separate`, ``batch=False``) and ``stft_synthesis_batch``,
        on the Separator's device."""
        kw = dict(self.algo_kwargs)
        if self.dtype is not None:
            kw.setdefault("dtype", self.dtype)
        X = api.stft_analysis_batch(xb, self.nfft, self.hop, dtype=self.dtype)
        for b, t_pad in enumerate(t_pads):
            X[b, :t_pad] = 0.0
        if not batch:
            Y = self.spec(X[0], n_src=self.n_src, **kw)
            if isinstance(Y, tuple):  # return_filters=True passthrough
                Y = Y[0]
            Y = Y[None]
        else:
            Y = self.spec.run_batch(X, n_src=self.n_src, **kw)
        if Y.ndim == 3:  # single-output extractors return (B, T, F)
            Y = Y[..., None]
        y = api.stft_synthesis_batch(Y, self.nfft, self.hop, dtype=self.dtype)
        return _pcm16(y) if self.pcm_out else y

    def separate_batch(self, clips) -> list:
        """Separate a sequence of clips, running same-bucket clips together.

        Clips are grouped by (frame bucket, n_chan), and a group of the
        device-resident path runs as one batched program: the clips'
        STFTs folded into the bin axis (``fold_mixtures``), per-clip frame
        masks and activations, so a traffic mix of similar lengths pays
        one run per bucket instead of one per clip. The batch forms have
        no ``wcov`` tier: a group whose config carries ``wcov`` other than
        "f32" (``bf16pack`` included) runs its clips one by one through
        :meth:`separate`, so its results equal the per-clip ones by
        construction and ``wcov_packed`` runs once an epoch for each clip.
        Without a fused branch, groups go through the registry
        ``run_batch``. Returns outputs in input order, each NumPy or a
        tensor as its clip was.
        """
        clips = [self._clip2d(c, i) for i, c in enumerate(clips)]
        if self._fused is None:
            # the registry runner has no cast stage (see separate())
            clips = [self._to_float(c) if _is_int16(c) else c for c in clips]
        groups: dict[tuple[int, int], list[int]] = {}
        prepped = []
        for i, x in enumerate(clips):
            prepped.append(self._prep_clip(x.shape[0]))
            groups.setdefault((prepped[i][1], x.shape[1]), []).append(i)

        out: list = [None] * len(clips)
        for (_, n_chan), idxs in groups.items():
            if self._fused is not None and self._fused["wcov"] != "f32":
                for i in idxs:
                    out[i] = self.separate(clips[i])
                continue
            # all-int16 groups ride the int16 upload; mixed groups convert
            # their int16 members exactly (1/32768) first
            all_i16 = all(_is_int16(clips[i]) for i in idxs)
            group = [clips[i] if all_i16 or not _is_int16(clips[i])
                     else self._to_float(clips[i]) for i in idxs]
            t_pads = [prepped[i][2] for i in idxs]
            n_bucket = prepped[idxs[0]][3]
            xs = [self._upload(c) for c in group]
            xb = xs[0].new_zeros((len(idxs), n_bucket, n_chan))
            for b, (xd, t_pad) in enumerate(zip(xs, t_pads)):
                self._place(xb[b], xd, t_pad)
            if self._fused is None:
                ys = self._separate_host(xb, t_pads)
            else:
                tp = torch.tensor(t_pads, device=self.device)
                ys = _masked_clip(xb, tp, self.nfft, self.hop,
                                  dict(n_src=self.n_src, **self._fused), self._win,
                                  self._win_s, self.pcm_out)
            # one download for the group when any of its clips is NumPy
            host = None
            if any(not isinstance(clips[i], torch.Tensor) for i in idxs):
                host = _output(ys, True)
            for b, i in enumerate(idxs):
                t_real, _, t_pad, _ = prepped[i]
                span = slice(self._start(t_pad), self._start(t_pad) + clips[i].shape[0])
                tensor_in = isinstance(clips[i], torch.Tensor)
                out[i] = ys[b, span] if tensor_in else host[b, span]
                self._count(t_real, t_pad, n_chan)
        return out

    def warmup(self, n_chan: int, n_samples: int, seed: int = 0, dtype=None) -> int:
        """Run every bucket needed up to ``n_samples`` once.

        Runs seeded noise clips through each grid bucket up to the one
        covering ``n_samples``, so that first real traffic finds the
        allocator's blocks and the FFT plans of its bucket ready. Returns
        the number of buckets touched. ``dtype=np.int16`` sends int16 PCM
        clips instead.
        """
        rng = np.random.default_rng(seed)
        top = self._bucket(self._t_real_of(max(int(n_samples), self.nfft)))
        # walk clip lengths by a factor strictly below the bucket ratio so
        # no grid bucket is skipped; dedup by the bucket actually hit
        step = 1.0 + (self.bucket_ratio - 1.0) / 2.0
        n = self.nfft
        done: set[int] = set()
        while True:
            b = self._bucket(self._t_real_of(n))
            if b not in done:
                clip = rng.standard_normal((n, n_chan))
                if dtype is not None and np.dtype(dtype) == np.int16:
                    # clip before casting: |z| >= 4 sigma would overflow
                    # int16 (8192*4 = 32768), an undefined float->int cast
                    clip = np.clip(
                        np.round(clip * 8192), -32768, 32767
                    ).astype(np.int16)
                self.separate(clip)
                done.add(b)
            if b >= top:
                return len(done)
            n = int(math.ceil(n * step))


STREAM_ALGOS = ("online-iss", "online-tiss")


def _stream_step(x_blk, tail, carry, state, step, nfft: int, hop: int, win, win_s):
    """One streaming block: framing + analysis + ``step`` (the online
    epoch(s), ``X, state -> Y, state``) + synthesis + overlap-add. x_blk
    (block_frames * hop, M) real; ``tail`` and ``carry`` (nfft - hop, M)
    are the input tail and the overlap-add carry of the block before.
    Returns (emitted samples, new tail, new carry, new state)."""
    B_hop = x_blk.shape[0]
    D = nfft - hop
    x = torch.cat([tail, x_blk], dim=0)
    X = _stft.analysis(x, nfft, hop, win)  # (block_frames, F, M)
    Y, state = step(X, state)
    y = _stft.synthesis(Y, nfft, hop, win_s)  # (B_hop + nfft - hop, M)
    emit = torch.cat([y[:D] + carry, y[D:B_hop]], dim=0)
    return emit, x[B_hop:], y[B_hop:], state


class StreamingSeparator:
    """Streaming serving surface: time-domain sample blocks in, separated
    sample blocks out, with the online separation state, the framing tail
    and the overlap-add carry on the device.

        sep = StreamingSeparator("online-iss", n_chan=4, nfft=512)
        for blk in stream:              # (block_frames*hop, n_chan) float
            y = sep.process(blk)        # same shape out (M channels)

    Output is delayed by ``nfft - hop`` samples relative to the input (the
    overlap-add tail of each synthesis window is held back until the next
    block completes it); :meth:`flush` drains that tail at stream end. The
    emitted samples equal running the STFT-domain online class over the
    same frames and synthesizing the concatenated stream.

    ``algo``: "online-iss" (rank-1 streaming separation) or "online-tiss"
    (joint streaming dereverberation + separation; ``taps``/``delay``,
    ``tap_update``). ``pb_forget`` and ``tap_forget`` default to
    ``forget``. ``device`` as in :func:`overiva_tpu_torch.resolve_device`
    (default CUDA; without a card pass ``device="cpu"``). A NumPy block
    gives a NumPy block, a tensor a tensor on the device.
    """

    def __init__(self, algo="online-iss", n_chan=2, nfft=512, hop=None, block_frames=8,
                 forget=0.97, model="laplace", n_pass=1, taps=4, delay=2,
                 tap_update="solve", pb_forget=None, tap_forget=None, dtype=None,
                 device=None):
        if algo not in STREAM_ALGOS:
            raise ValueError(
                f"unknown streaming algo {algo!r}; use 'online-iss' or 'online-tiss'"
            )
        _check_model(model)
        self.algo = algo
        self.nfft = int(nfft)
        self.hop = int(hop or nfft // 2)
        self.block_frames = int(block_frames)
        self.n_chan = int(n_chan)
        self.block_samples = self.block_frames * self.hop
        if self.block_samples < self.nfft - self.hop:
            raise ValueError(
                "block_frames * hop must be >= nfft - hop (the emitted "
                "block must cover the overlap-add carry)"
            )
        self.device = resolve_device(device)
        cdtype = to_torch_dtype(dtype or DEFAULT_DTYPE)
        self._cdtype, self._rdtype = cdtype, cdtype.to_real()
        F = self.nfft // 2 + 1
        self.model, self.n_pass = model, int(n_pass)
        if algo == "online-iss":
            self.taps = 0
            self.state = online_iss_init(F, self.n_chan, cdtype, self.device)
        else:
            self.taps, self.delay = _check_taps(taps, delay)
            if tap_update not in ("solve", "steer"):
                raise ValueError("tap_update must be 'solve' or 'steer'")
            self.tap_update = tap_update
            self.state = online_tiss_init(F, self.n_chan, self.taps, self.delay,
                                          tap_update, cdtype, self.device)

        def scalar(value):
            return torch.tensor(float(value), dtype=self._rdtype, device=self.device)

        self.forget = scalar(forget)
        self.pb_forget = self.forget if pb_forget is None else scalar(pb_forget)
        self.tap_forget = self.forget if tap_forget is None else scalar(tap_forget)
        win = hann(self.nfft)
        self.win = torch.as_tensor(win, dtype=self._rdtype).to(self.device)
        self.win_s = torch.as_tensor(synthesis_window(win, self.hop),
                                     dtype=self._rdtype).to(self.device)
        # tail primed with zeros = the stft_pad front padding, so frame 0
        # of the stream matches frame 0 of the offline pipeline
        D = self.nfft - self.hop
        self.tail = torch.zeros((D, self.n_chan), dtype=self._rdtype, device=self.device)
        self.carry = torch.zeros((D, self.n_chan), dtype=self._rdtype, device=self.device)
        self._numpy_out = True

    def _step(self, X, state):
        if self.algo == "online-iss":
            return online_iss_step(X, state, self.forget, self.model, self.n_pass,
                                   pb_forget=self.pb_forget)
        return online_tiss_step(X, state, self.forget, self.taps, self.delay, self.model,
                                self.n_pass, pb_forget=self.pb_forget,
                                tap_update=self.tap_update, tap_forget=self.tap_forget)

    def process(self, x_blk):
        """(block_frames*hop, n_chan) float -> same-shape separated block
        (delayed by nfft - hop samples; see the class docstring)."""
        if not isinstance(x_blk, torch.Tensor):
            x_blk = np.asarray(x_blk)
        if tuple(x_blk.shape) != (self.block_samples, self.n_chan):
            raise ValueError(
                f"block must be ({self.block_samples}, {self.n_chan}) "
                f"(block_frames*hop samples), got {tuple(x_blk.shape)}"
            )
        self._numpy_out = not isinstance(x_blk, torch.Tensor)
        x = as_tensor(x_blk, self._rdtype, self.device)
        emit, self.tail, self.carry, self.state = _stream_step(
            x, self.tail, self.carry, self.state, self._step, self.nfft, self.hop,
            self.win, self.win_s,
        )
        return _output(emit, self._numpy_out)

    def flush(self):
        """Drain the held-back overlap-add tail (nfft - hop samples) at
        stream end: NumPy after a NumPy block, else a tensor."""
        out = _output(self.carry, self._numpy_out)
        self.carry = torch.zeros_like(self.carry)
        return out

    def warmup(self) -> None:
        """Run one throwaway zero block, so that the first real block does
        not pay the first call's set-up (FFT plans, the allocator's first
        blocks) inside its latency budget. Safe mid-stream: the state,
        tail and carry are put back afterwards (a step never writes into
        the tensors it is given)."""
        snap = (self.state, self.tail, self.carry, self._numpy_out)
        self.process(torch.zeros((self.block_samples, self.n_chan), dtype=self._rdtype,
                                 device=self.device))
        self.state, self.tail, self.carry, self._numpy_out = snap

    def save(self, path, **meta):
        """Persist the full stream state (online statistics + framing tail
        + overlap-add carry) to ``path`` (npz), in the JAX package's
        layout. Returns the written path."""
        host = state_to_numpy(self.state)
        for k, v in (("tail", self.tail), ("carry", self.carry)):
            if k in host:
                raise ValueError(f"core state already has a {k!r} key")
            host[k] = v.cpu().numpy()
        meta.setdefault("class", type(self).__name__)
        meta.setdefault("algo", self.algo)
        return save_state(path, host, **meta)

    def restore(self, path) -> dict:
        """Resume a stream saved by :meth:`save` (by this package or the
        JAX package); keys and shapes must match the constructor's
        configuration. Returns the checkpoint metadata."""
        host, meta = load_state(path)
        current = {**self.state, "tail": self.tail, "carry": self.carry}
        new = restored_state(host, current, self._cdtype, self.device)
        self.tail, self.carry = new.pop("tail"), new.pop("carry")
        self.state = new
        return meta
