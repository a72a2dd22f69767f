"""Public API: the OverIVA/AuxIVA main path, NumPy or tensors in and out.

Counterpart of the main-path slice of ``overiva_tpu/api.py``, with the same
signatures and validation plus ``device=``:

    stft_analysis(x, nfft) -> X            (n_frames, n_freq, n_chan)
    overiva(X, n_src, ...) -> Y [, W_hat]  (n_frames, n_freq, n_src)
    auxiva(X, ...), projection_back(Y, ref), stft_synthesis(Y, nfft)
    pca(X, n_src), auxiva_pca(X, n_src, inner="ip")
    separate(mix, n_src, algo="ip")        samples in, samples out
    stft_analysis_batch, overiva_batch, stft_synthesis_batch
                                           a leading batch axis, written out

A NumPy input gives a NumPy output; a tensor input gives a tensor on the
device the work ran on. ``device`` defaults to the input tensor's device,
else CUDA; without a card a NumPy input needs ``device="cpu"``
(:func:`resolve_device` raises otherwise). The default
dtype is complex64. Complex values cross the host boundary as they are.
"""

from __future__ import annotations

import torch

from . import resolve_device
from .models import auxiva_pca as _pca
from .models import overiva as _core
from .models.source_models import MODELS
from .ops import projection as _proj
from .ops import stft as _stft
from .ops.covariance import WCOV_MODES
from .utils.convert import as_tensor, to_torch_dtype

__all__ = [
    "auxiva",
    "auxiva_pca",
    "overiva",
    "overiva_batch",
    "pca",
    "projection_back",
    "separate",
    "stft_analysis",
    "stft_analysis_batch",
    "stft_synthesis",
    "stft_synthesis_batch",
]

DEFAULT_DTYPE = torch.complex64
# the other algorithms of overiva_tpu.api.separate, and the ROADMAP.md
# Queue 1 item that ports each
_UNPORTED_ALGOS = {
    "iss": 11, "ip2": 11, "fastmnmf": 13, "fastmnmf2": 13,
    "tiss": 14, "tip": 14, "ilrma_t": 14,
}


def _output(t, numpy_in: bool):
    return t.cpu().numpy() if numpy_in else t


def _check_model(model):
    if model not in MODELS:
        raise ValueError(f"unknown source model {model!r}; use one of {MODELS}")


def overiva(
    X,
    n_src=None,
    n_iter=20,
    proj_back=True,
    W0=None,
    model="laplace",
    init_eig=False,
    return_filters=False,
    callback=None,
    callback_every=10,
    dtype=None,
    chunk_frames=None,
    wcov="f32",
    acc="f32",
    device=None,
):
    """OverIVA (AuxIVA when n_src == n_chan). Reference: ``overiva.py``.

    X: (n_frames, n_freq, n_chan) complex. Returns Y (n_frames, n_freq,
    n_src) [, W_hat (n_freq, n_chan, n_chan)].

    ``chunk_frames`` accumulates the weighted covariances over frame blocks
    (bounded memory, same result). ``wcov``: ``"f32"`` (default, exact),
    ``"bf16"`` (bf16 operands, f32 accumulation) or ``"bf16pack"`` (the
    same numerics through the CUDA kernel on a CUDA device; no chunked
    form). ``"f32x3"`` (the TPU's 3-pass tier) runs exact f32 here, at
    least as accurate as on the TPU. ``acc="f32x2"`` is the
    certification tier: on this hardware it runs complex128 on the
    complex64-rounded input and returns complex64; not combinable with
    ``init_eig`` or a non-default ``dtype``/``wcov``.

    ``callback(Y)`` receives a projection-back-scaled copy of the outputs
    before every ``callback_every`` epochs, as the reference does.
    """
    numpy_in = not isinstance(X, torch.Tensor)
    M = X.shape[2]
    N = M if n_src is None else int(n_src)
    if not 1 <= N <= M:
        raise ValueError("need 1 <= n_src <= n_chan")
    cdtype = to_torch_dtype(dtype or DEFAULT_DTYPE)
    if str(wcov) not in WCOV_MODES:
        raise ValueError(f"wcov must be one of {WCOV_MODES}, got {wcov!r}")
    if str(wcov) == "bf16pack" and chunk_frames:
        raise ValueError(
            "wcov='bf16pack' has no chunked form (the packed kernel's "
            "point is avoiding the weighted temporary) — drop "
            "chunk_frames or use wcov='bf16'"
        )
    if str(acc) not in ("f32", "f32x2"):
        raise ValueError(f"acc must be 'f32' or 'f32x2', got {acc!r}")
    _check_model(model)
    out_dtype = cdtype
    if acc == "f32x2":
        if init_eig:
            raise ValueError("init_eig is not supported with acc='f32x2'")
        if dtype is not None and cdtype != torch.complex64:
            raise ValueError(
                "acc='f32x2' is the double-float-of-complex64 tier; "
                f"dtype={dtype!r} is not combinable with it"
            )
        if str(wcov) != "f32":
            raise ValueError(
                f"wcov={wcov!r} is not combinable with acc='f32x2' "
                "(the df tier has its own precision)"
            )
        cdtype = torch.complex128  # out_dtype stays complex64

    dev = resolve_device(device, X)
    # acc="f32x2" runs on the complex64-rounded input (as its TPU tier does)
    Xd = as_tensor(X, out_dtype, dev).to(cdtype)
    W0d = None if W0 is None else as_tensor(W0, out_dtype, dev).to(cdtype)
    W_hat, Cx = _core.prepare(Xd, N, bool(init_eig), W0d)

    def run(W, steps):
        return _core.overiva_iterations(
            Xd, W, Cx, N, steps, model,
            chunk_frames=int(chunk_frames) if chunk_frames else None,
            wcov=str(wcov),
        )

    def outputs(W, scaled):
        Y = _core.demix(Xd, W[:, :N, :])
        if scaled:
            Y = _proj.apply_projection_back(Y, Xd[:, :, 0])
        return _output(Y.to(out_dtype), numpy_in)

    if callback is None:
        W_hat = run(W_hat, int(n_iter))
    else:
        done = 0
        while done < n_iter:
            callback(outputs(W_hat, True))
            step = min(int(callback_every), int(n_iter) - done)
            W_hat = run(W_hat, step)
            done += step

    Y = outputs(W_hat, bool(proj_back))
    if return_filters:
        return Y, _output(W_hat.to(out_dtype), numpy_in)
    return Y


def auxiva(
    X,
    n_src=None,
    n_iter=20,
    proj_back=True,
    W0=None,
    model="laplace",
    return_filters=False,
    callback=None,
    callback_every=10,
    dtype=None,
    wcov="f32",
    acc="f32",
    device=None,
):
    """Determined AuxIVA. Reference: ``pyroomacoustics.bss.auxiva``."""
    M = X.shape[2]
    N = M if n_src is None else int(n_src)
    if N != M:
        raise ValueError("auxiva is determined: n_src must equal n_chan")
    return overiva(
        X, n_src=N, n_iter=n_iter, proj_back=proj_back, W0=W0, model=model,
        init_eig=False, return_filters=return_filters, callback=callback,
        callback_every=callback_every, dtype=dtype, wcov=wcov, acc=acc,
        device=device,
    )


def pca(X, n_src, return_basis=False, dtype=None, device=None):
    """Per-bin principal-subspace reduction. Reference: ``auxiva_pca.pca``.

    X: (n_frames, n_freq, n_chan) -> (n_frames, n_freq, n_src) [, basis
    (n_freq, n_chan, n_src)]."""
    numpy_in = not isinstance(X, torch.Tensor)
    cdtype = to_torch_dtype(dtype or DEFAULT_DTYPE)
    Xd = as_tensor(X, cdtype, resolve_device(device, X))
    if return_basis:
        X_r, E = _pca.pca(Xd, int(n_src), True)
        return _output(X_r, numpy_in), _output(E, numpy_in)
    return _output(_pca.pca(Xd, int(n_src)), numpy_in)


def auxiva_pca(
    X,
    n_src=None,
    n_iter=20,
    proj_back=True,
    model="laplace",
    return_filters=False,
    callback=None,
    callback_every=10,
    dtype=None,
    inner="ip",
    device=None,
):
    """PCA to n_src dims then determined AuxIVA; projection back against the
    original mic 0. Reference: ``auxiva_pca.py``.

    ``inner="ip"`` (iterative projection) is ported; ``"iss"`` and
    ``"ip2"`` raise NotImplementedError naming the ROADMAP item that ports
    them. ``return_filters`` gives the reduced (n_freq, n_src, n_src) W."""
    if inner != "ip":
        if inner in _UNPORTED_ALGOS:
            raise NotImplementedError(
                f"auxiva_pca(inner={inner!r}) is not ported yet (ROADMAP.md "
                f"Queue 1 item {_UNPORTED_ALGOS[inner]}); use inner='ip'"
            )
        raise ValueError(f"unknown inner {inner!r}; use 'ip'")
    numpy_in = not isinstance(X, torch.Tensor)
    M = X.shape[2]
    N = M if n_src is None else int(n_src)
    if not 1 <= N <= M:
        raise ValueError("need 1 <= n_src <= n_chan")
    cdtype = to_torch_dtype(dtype or DEFAULT_DTYPE)
    Xd = as_tensor(X, cdtype, resolve_device(device, X))
    X_r = _pca.pca(Xd, N) if N < M else Xd
    cb = callback
    if callback is not None and numpy_in:  # NumPy in: the callback sees NumPy
        def cb(Y):
            callback(Y.cpu().numpy())

    res = auxiva(
        X_r, n_src=N, n_iter=n_iter, proj_back=False, model=model,
        return_filters=return_filters, callback=cb,
        callback_every=callback_every, dtype=cdtype,
    )
    Y, W = res if return_filters else (res, None)
    if proj_back:
        Y = _proj.apply_projection_back(Y, Xd[:, :, 0])
    if return_filters:
        return _output(Y, numpy_in), _output(W, numpy_in)
    return _output(Y, numpy_in)


def overiva_batch(
    X,
    n_src=None,
    n_iter=20,
    proj_back=True,
    model="laplace",
    init_eig=False,
    dtype=None,
    device=None,
):
    """Separate a batch of same-shape mixtures at once.

    X: (batch, n_frames, n_freq, n_chan) complex. Returns (batch, n_frames,
    n_freq, n_src). The batch is written out, not looped over: the per-bin
    linear algebra runs over batch * n_freq bins in one call, and power and
    the activations are per mixture (the JAX package's ``vmap``). No
    callback (use :func:`overiva` per mixture for that).
    """
    numpy_in = not isinstance(X, torch.Tensor)
    if X.ndim != 4:
        raise ValueError(
            f"overiva_batch expects (B, T, F, M); got shape {tuple(X.shape)}"
        )
    M = X.shape[3]
    N = M if n_src is None else int(n_src)
    if not 1 <= N <= M:
        raise ValueError("need 1 <= n_src <= n_chan")
    _check_model(model)
    cdtype = to_torch_dtype(dtype or DEFAULT_DTYPE)
    Xd = as_tensor(X, cdtype, resolve_device(device, X))
    Y = _core.overiva_batch_run(
        Xd, N, int(n_iter), model, init_eig=bool(init_eig), proj_back=bool(proj_back)
    )
    return _output(Y, numpy_in)


def projection_back(Y, ref, device=None):
    """Minimal-distortion rescale factors z (F, K). The caller applies
    ``Y *= conj(z)[None]``, the reference's convention."""
    numpy_in = not isinstance(Y, torch.Tensor)
    dev = resolve_device(device, Y)
    Yd = as_tensor(Y, None, dev)
    z = _proj.projection_back(Yd, as_tensor(ref, Yd.dtype, dev))
    return _output(z, numpy_in)


def stft_analysis(x, nfft, hop=None, win=None, dtype=None, device=None):
    """Time signal (n_samples[, M]) -> complex STFT (T, nfft//2+1[, M]).

    ``dtype`` is the complex output type (default complex64); ``win``
    overrides the hann analysis window."""
    numpy_in = not isinstance(x, torch.Tensor)
    hop = hop or nfft // 2
    rdtype = to_torch_dtype(dtype or DEFAULT_DTYPE).to_real()
    xd = as_tensor(x, rdtype, resolve_device(device, x))
    return _output(_stft.analysis(xd, int(nfft), int(hop), win), numpy_in)


def stft_analysis_batch(x, nfft, hop=None, dtype=None, device=None):
    """Batch of time signals (B, n_samples[, M]) -> (B, T, nfft//2+1[, M]),
    in one transform over the whole batch."""
    numpy_in = not isinstance(x, torch.Tensor)
    if x.ndim not in (2, 3):
        raise ValueError(
            f"stft_analysis_batch expects (B, n_samples[, M]); got shape {tuple(x.shape)}"
        )
    hop = hop or nfft // 2
    rdtype = to_torch_dtype(dtype or DEFAULT_DTYPE).to_real()
    xd = as_tensor(x, rdtype, resolve_device(device, x))
    mono = xd.ndim == 2
    X = _stft.analysis(xd[..., None] if mono else xd, int(nfft), int(hop))
    return _output(X[..., 0] if mono else X, numpy_in)


def stft_synthesis_batch(X, nfft, hop=None, win_s=None, dtype=None, device=None):
    """Batch of STFTs (B, T, nfft//2+1, N) -> (B, n_samples, N), in one
    overlap-add over the whole batch. ``win_s`` as in :func:`stft_synthesis`."""
    numpy_in = not isinstance(X, torch.Tensor)
    if X.ndim != 4:
        raise ValueError(
            "stft_synthesis_batch expects (B, T, nfft//2+1, N); got shape "
            f"{tuple(X.shape)} — use stft_synthesis for unbatched input "
            "or add a leading batch axis"
        )
    hop = hop or nfft // 2
    cdtype = to_torch_dtype(dtype or DEFAULT_DTYPE)
    Xd = as_tensor(X, cdtype, resolve_device(device, X))
    return _output(_stft.synthesis(Xd, int(nfft), int(hop), win_s), numpy_in)


def stft_synthesis(X, nfft, hop=None, win_s=None, dtype=None, device=None):
    """Complex STFT -> time signal by weighted overlap-add. ``win_s``
    overrides the dual synthesis window (default: perfect reconstruction)."""
    numpy_in = not isinstance(X, torch.Tensor)
    hop = hop or nfft // 2
    cdtype = to_torch_dtype(dtype or DEFAULT_DTYPE)
    Xd = as_tensor(X, cdtype, resolve_device(device, X))
    return _output(_stft.synthesis(Xd, int(nfft), int(hop), win_s), numpy_in)


def separate(
    mix,
    n_src=None,
    nfft=4096,
    hop=None,
    n_iter=20,
    model="laplace",
    init_eig=False,
    algo="ip",
    dtype=None,
    device=None,
):
    """Time-domain in, time-domain out: STFT -> OverIVA/AuxIVA iterative
    projection -> projection back -> iSTFT, on one device.

    mix: (n_samples, n_chan) real. Returns (n_samples, n_src) real.
    ``algo="ip"`` is the ported algorithm; the JAX package's others raise
    NotImplementedError naming the ROADMAP item that ports them.
    """
    if algo != "ip":
        if algo in _UNPORTED_ALGOS:
            raise NotImplementedError(
                f"separate(algo={algo!r}) is not ported yet (ROADMAP.md "
                f"Queue 1 item {_UNPORTED_ALGOS[algo]}); use algo='ip'"
            )
        raise ValueError(f"unknown algo {algo!r}; use 'ip'")
    numpy_in = not isinstance(mix, torch.Tensor)
    hop = hop or nfft // 2
    n, M = mix.shape
    N = M if n_src is None else int(n_src)
    if not 1 <= N <= M:
        raise ValueError("need 1 <= n_src <= n_chan")
    _check_model(model)
    rdtype = to_torch_dtype(dtype or DEFAULT_DTYPE).to_real()
    x = as_tensor(mix, rdtype, resolve_device(device, mix))
    X = _stft.analysis(_stft.stft_pad(x, int(nfft), int(hop)), int(nfft), int(hop))
    Y, _ = _core.overiva_run(X, N, int(n_iter), model, init_eig=bool(init_eig))
    Y = _proj.apply_projection_back(Y, X[:, :, 0])
    y = _stft.synthesis(Y, int(nfft), int(hop))
    start = nfft - hop
    return _output(y[start : start + n], numpy_in)
