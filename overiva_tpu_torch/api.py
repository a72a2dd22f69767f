"""Public API: the IP family, the per-(t,f)-weighted families, the joint
dereverberation family and the streaming classes, NumPy or tensors in and
out.

Counterpart of the batch entry points and streaming classes of
``overiva_tpu/api.py``, with the same signatures and validation plus
``device=``:

    stft_analysis(x, nfft) -> X            (n_frames, n_freq, n_chan)
    overiva(X, n_src, ...) -> Y [, W_hat]  (n_frames, n_freq, n_src)
    auxiva(X, ...), projection_back(Y, ref), stft_synthesis(Y, nfft)
    auxiva_iss, overiva_iss                iterative source steering
    overiva_ip2, auxiva_ip2                pairwise updates (n_src >= 2)
    ogive, five                            one source extracted
    pca(X, n_src), auxiva_pca(X, n_src, inner="ip"|"iss"|"ip2")
    ilrma, fastmnmf2, fastmnmf             per-(t,f)-weighted NMF models
    sparseauxiva                           IP on a bin subset + LASSO fill
    wpe                                    dereverberation (delayed prediction)
    tiss, tip, ilrma_t                     joint dereverberation + separation
    OnlineAuxIVAISS, OnlineTISS, OnlineWPE streaming: STFT blocks in and out,
                                           state on the device, save/restore
    separate(mix, n_src, algo="ip"|"iss"|"ip2"|"tiss"|"tip"|"ilrma_t"|
             "fastmnmf"|"fastmnmf2", wpe=None|True|dict)
                                           samples in, samples out
    stft_analysis_batch, stft_synthesis_batch, overiva_batch,
    auxiva_iss_batch, overiva_iss_batch, overiva_ip2_batch, ogive_batch,
    five_batch, auxiva_pca_batch, ilrma_batch, fastmnmf2_batch,
    fastmnmf_batch, sparseauxiva_batch, wpe_batch, tiss_batch, tip_batch,
    ilrma_t_batch                          a leading batch axis, written out
    to_device(X)                           an array uploaded once, as a complex tensor

A NumPy input gives a NumPy output; a tensor input gives a tensor on the
device the work ran on. ``device`` defaults to the input tensor's device,
else CUDA; without a card a NumPy input needs ``device="cpu"``
(:func:`resolve_device` raises otherwise). The default
dtype is complex64. Complex values cross the host boundary as they are.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import resolve_device
from .models import auxiva_pca as _pca
from .models import fastmnmf2 as _mnmf
from .models import five as _five
from .models import ilrma as _ilrma
from .models import ogive as _ogive
from .models import online_iss as _online_iss
from .models import online_tiss as _online_tiss
from .models import online_wpe as _online_wpe
from .models import overiva as _core
from .models import ilrma_t as _ilrma_t
from .models import sparseauxiva as _sparse
from .models import tip as _tip
from .models import tiss as _tiss
from .models.family import FAMILIES, chunked, run_family
from .models.source_models import MODELS
from .ops import projection as _proj
from .ops import stft as _stft
from .ops import wpe as _wpe
from .ops.covariance import check_tf_wcov, check_wcov
from .oracle.sparseauxiva import _resolve_n_bins
from .utils import threefry
from .utils.checkpoint import load_state, save_state
from .utils.convert import as_tensor, state_to_numpy, stream_state_to_torch, to_torch_dtype

__all__ = [
    "OnlineAuxIVAISS",
    "OnlineTISS",
    "OnlineWPE",
    "auxiva",
    "auxiva_ip2",
    "auxiva_iss",
    "auxiva_iss_batch",
    "auxiva_pca",
    "auxiva_pca_batch",
    "fastmnmf",
    "fastmnmf2",
    "fastmnmf2_batch",
    "fastmnmf_batch",
    "five",
    "five_batch",
    "ilrma",
    "ilrma_batch",
    "ilrma_t",
    "ilrma_t_batch",
    "ogive",
    "ogive_batch",
    "overiva",
    "overiva_batch",
    "overiva_ip2",
    "overiva_ip2_batch",
    "overiva_iss",
    "overiva_iss_batch",
    "pca",
    "projection_back",
    "separate",
    "sparseauxiva",
    "sparseauxiva_batch",
    "stft_analysis",
    "stft_analysis_batch",
    "stft_synthesis",
    "stft_synthesis_batch",
    "tip",
    "tip_batch",
    "tiss",
    "tiss_batch",
    "to_device",
    "wpe",
    "wpe_batch",
]

DEFAULT_DTYPE = torch.complex64
_MNMF_ALGOS = ("fastmnmf", "fastmnmf2")
_OGIVE_UPDATES = ("demix", "mix", "switching")


def _output(t, numpy_in: bool):
    return t.resolve_conj().cpu().numpy() if numpy_in else t


def _check_model(model):
    if model not in MODELS:
        raise ValueError(f"unknown source model {model!r}; use one of {MODELS}")


def _check_batch(X, name):
    if X.ndim != 4:
        raise ValueError(f"{name} expects (B, T, F, M); got shape {tuple(X.shape)}")


def _n_src(n_src, M, low=1):
    N = M if n_src is None else int(n_src)
    if not low <= N <= M:
        raise ValueError(
            f"IP2 needs 2 <= n_src <= n_chan, got {N}" if low == 2
            else "need 1 <= n_src <= n_chan"
        )
    return N


def _setup(X, dtype, device):
    """(NumPy in?, complex dtype, X as a tensor on the resolved device)."""
    cdtype = to_torch_dtype(dtype or DEFAULT_DTYPE)
    return not isinstance(X, torch.Tensor), cdtype, as_tensor(X, cdtype, resolve_device(device, X))


def _finish(Y, X, scaled, numpy_in, out_dtype=None):
    """Outputs Y, projection-back-scaled against mic 0 of X when
    ``scaled``, then cast to ``out_dtype``; NumPy for a NumPy input."""
    if scaled:
        Y = _proj.apply_projection_back(Y, X[:, :, 0])
    return _output(Y if out_dtype is None else Y.to(out_dtype), numpy_in)


def _check_algo(algo, what):
    if algo not in FAMILIES:
        raise ValueError(f"unknown {what} {algo!r}; use 'ip', 'iss' or 'ip2'")


def _scaled_callback(callback, X, numpy_in, out_dtype=None):
    """The user's callback on projection-back-scaled outputs (against mic 0
    of X), NumPy for a NumPy input; None stays None."""
    if callback is None:
        return None

    def cb(Y):
        callback(_finish(Y, X, True, numpy_in, out_dtype))

    return cb


def _run(X, N, n_iter, algo, model, proj_back, return_filters, callback,
         callback_every, numpy_in, out_dtype=None, **opts):
    """A single-clip entry point's run of ``algo`` through
    :func:`run_family`: outputs scaled when ``proj_back``, cast to
    ``out_dtype`` and returned as NumPy for a NumPy input, with W when
    ``return_filters``."""
    Y, W = run_family(
        X, N, int(n_iter), model, algo, n_mix=1,
        callback=_scaled_callback(callback, X, numpy_in, out_dtype),
        callback_every=callback_every, **opts,
    )
    return _outputs(Y, W, X, proj_back, return_filters, numpy_in, out_dtype)


def _outputs(Y, W, X, proj_back, return_filters, numpy_in, out_dtype=None):
    """An entry point's return: Y as :func:`_finish` gives it, with the
    filters W (cast to ``out_dtype``) when ``return_filters``."""
    Y = _finish(Y, X, bool(proj_back), numpy_in, out_dtype)
    if return_filters:
        return Y, _output(W if out_dtype is None else W.to(out_dtype), numpy_in)
    return Y


def _joint_df_guard(acc, dtype, cdtype, wcov=None):
    """The ``acc`` checks of the certification tier (the JAX package's, of
    overiva/auxiva and the joint family); True for ``acc="f32x2"``."""
    if str(acc) not in ("f32", "f32x2"):
        raise ValueError(f"acc must be 'f32' or 'f32x2', got {acc!r}")
    if acc != "f32x2":
        return False
    if dtype is not None and cdtype != torch.complex64:
        raise ValueError(
            "acc='f32x2' is the double-float-of-complex64 tier; "
            f"dtype={dtype!r} is not combinable with it"
        )
    if wcov is not None and str(wcov) != "f32":
        raise ValueError(
            f"wcov={wcov!r} is not combinable with acc='f32x2' "
            "(the df tier has its own precision)"
        )
    return True


def _df_setup(X, dtype, acc, device, wcov=None):
    """(NumPy in?, working dtype, output dtype, X on the device) of an entry
    point with ``acc``: ``"f32x2"`` runs complex128 on the complex64-rounded
    input (as its TPU tier does) and returns complex64."""
    cdtype = to_torch_dtype(dtype or DEFAULT_DTYPE)
    out_dtype = cdtype
    if _joint_df_guard(acc, dtype, cdtype, wcov):
        cdtype = torch.complex128
    Xd = as_tensor(X, out_dtype, resolve_device(device, X)).to(cdtype)
    return not isinstance(X, torch.Tensor), cdtype, out_dtype, Xd


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
    N = _n_src(n_src, X.shape[2])
    check_wcov(wcov)
    if str(wcov) == "bf16pack" and chunk_frames:
        raise ValueError(
            "wcov='bf16pack' has no chunked form (the packed kernel's "
            "point is avoiding the weighted temporary) — drop "
            "chunk_frames or use wcov='bf16'"
        )
    _check_model(model)
    if acc == "f32x2" and init_eig:
        raise ValueError("init_eig is not supported with acc='f32x2'")
    numpy_in, cdtype, out_dtype, Xd = _df_setup(X, dtype, acc, device, wcov)
    W0d = None if W0 is None else as_tensor(W0, out_dtype, Xd.device).to(cdtype)
    return _run(
        Xd, N, n_iter, "ip", model, proj_back, return_filters, callback, callback_every,
        numpy_in, out_dtype, init_eig=bool(init_eig), W0=W0d, wcov=str(wcov),
        chunk_frames=int(chunk_frames) if chunk_frames else None,
    )


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

    ``inner``: "ip" (iterative projection), "iss" (source steering) or
    "ip2" (pairwise updates; needs n_src >= 2). ``return_filters`` gives the
    reduced (n_freq, n_src, n_src) W."""
    _check_algo(inner, "inner")
    N = _n_src(n_src, X.shape[2])
    if inner == "ip2" and N < 2:
        raise ValueError("inner='ip2' needs n_src >= 2")
    _check_model(model)
    numpy_in, _, Xd = _setup(X, dtype, device)
    X_r = _pca.pca(Xd, N) if N < Xd.shape[2] else Xd
    # the callback sees outputs scaled against the reduced STFT, as the
    # inner AuxIVA's own callback does in the JAX package
    Y, W = run_family(X_r, N, int(n_iter), model, inner,
                      callback=_scaled_callback(callback, X_r, numpy_in),
                      callback_every=callback_every)
    # projection back against the original mic 0
    Y = _finish(Y, Xd, bool(proj_back), numpy_in)
    if return_filters:
        return Y, _output(W, numpy_in)
    return Y


def _run_iss(X, N, n_iter, proj_back, W0, model, return_filters, callback,
             callback_every, dtype, device):
    """ISS from identity (or ``W0``: (F, M, M), or (F, N, M) target rows
    placed into the identity)."""
    _check_model(model)
    numpy_in, cdtype, Xd = _setup(X, dtype, device)
    W0d = None if W0 is None else as_tensor(W0, cdtype, Xd.device)
    return _run(Xd, N, n_iter, "iss", model, proj_back, return_filters, callback,
                callback_every, numpy_in, W0=W0d)


def auxiva_iss(
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
    device=None,
):
    """AuxIVA by iterative source steering (rank-1, solve-free updates).
    Determined: n_src == n_chan. Reference: ``oracle/auxiva_iss.py``."""
    M = X.shape[2]
    N = M if n_src is None else int(n_src)
    if N != M:
        raise ValueError("auxiva_iss is determined: n_src must equal n_chan")
    return _run_iss(X, N, n_iter, proj_back, W0, model, return_filters, callback,
                    callback_every, dtype, device)


def overiva_iss(
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
    device=None,
):
    """Overdetermined IVA by iterative source steering: the M - n_src
    background outputs carry a stationary unit Gaussian (phi = 1). N == M
    is :func:`auxiva_iss`. ``W0`` may be (F, M, M) or (F, N, M) target
    rows. Reference: ``oracle/overiva_iss.py``."""
    M = X.shape[2]
    N = M if n_src is None else int(n_src)
    if not 1 <= N <= M:
        raise ValueError(f"n_src must be in [1, {M}], got {N}")
    return _run_iss(X, N, n_iter, proj_back, W0, model, return_filters, callback,
                    callback_every, dtype, device)


def overiva_ip2(
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
    wcov="f32",
    device=None,
):
    """Pairwise-update OverIVA/AuxIVA (IP2). Reference:
    ``oracle/overiva_ip2.py``.

    Requires 2 <= n_src <= n_chan. X: (n_frames, n_freq, n_chan); returns
    Y (n_frames, n_freq, n_src) [, W_hat]. ``wcov`` as in :func:`overiva`:
    ``"bf16pack"`` runs the packed CUDA kernel once an epoch on a CUDA
    device."""
    N = _n_src(n_src, X.shape[2], low=2)
    check_wcov(wcov)
    _check_model(model)
    numpy_in, cdtype, Xd = _setup(X, dtype, device)
    W0d = None if W0 is None else as_tensor(W0, cdtype, Xd.device)
    return _run(Xd, N, n_iter, "ip2", model, proj_back, return_filters, callback,
                callback_every, numpy_in, init_eig=bool(init_eig), W0=W0d, wcov=str(wcov))


def auxiva_ip2(X, n_src=None, **kw):
    """Determined pairwise AuxIVA (n_src must equal n_chan)."""
    M = X.shape[2]
    N = M if n_src is None else int(n_src)
    if N != M:
        raise ValueError("auxiva_ip2 is determined: n_src must equal n_chan")
    return overiva_ip2(X, n_src=M, **kw)


def five(
    X,
    n_iter=10,
    proj_back=True,
    model="laplace",
    return_filters=False,
    callback=None,
    callback_every=1,
    dtype=None,
    device=None,
):
    """FIVE: one source by iterative SINR maximization. Returns Y
    (n_frames, n_freq, 1) [, w (n_freq, n_chan), the unwhitened filter].
    Reference: ``oracle/five.py``."""
    _check_model(model)
    numpy_in, _, Xd = _setup(X, dtype, device)
    Xw, Q = _five.five_whiten(Xd)

    def outputs(w, scaled):
        return _finish(_five.five_demix(Xw, w)[:, :, None], Xd, scaled, numpy_in)

    w = chunked(lambda w, steps: _five.five_iterations(Xw, w, steps, model),
                 _five.five_init(Xw), n_iter, callback, callback_every,
                 lambda w: outputs(w, True))
    Y = outputs(w, bool(proj_back))
    if return_filters:
        return Y, _output(_five.five_unwhiten(Q, w), numpy_in)
    return Y


def _check_ogive(update, model):
    if update not in _OGIVE_UPDATES:
        raise ValueError(f"unknown update mode {update!r}")
    _check_model(model)


def _ogive_start(X, step_size, tol, init_eig, n_mix):
    """The initial OGIVE state of ``n_mix`` folded mixtures: (w, a,
    use_mix, Cx, Cx_inv, epoch, done, mu, tol)."""
    w, a, Cx, Cx_inv = _ogive.ogive_init(X, bool(init_eig))
    use_mix = torch.zeros(X.shape[1], dtype=torch.bool, device=X.device)
    epoch = torch.zeros(n_mix, dtype=torch.int32, device=X.device)
    done = torch.zeros(n_mix, dtype=torch.bool, device=X.device)
    # the real dtype's own rounding of the step and the tolerance, as the
    # JAX package passes them
    rdtype = X.real.dtype
    mu = torch.tensor(step_size, dtype=rdtype, device=X.device)
    return w, a, use_mix, Cx, Cx_inv, epoch, done, mu, torch.tensor(tol, dtype=rdtype, device=X.device)


def ogive(
    X,
    n_iter=4000,
    step_size=0.1,
    tol=1e-3,
    update="demix",
    proj_back=True,
    model="laplace",
    init_eig=False,
    return_filters=False,
    callback=None,
    callback_every=100,
    switch_every=10,
    dtype=None,
    device=None,
):
    """OGIVE single-source extraction with the early exit decided on the
    device (``models/ogive.py``). Reference: ``ive.py``.

    Returns Y (n_frames, n_freq, 1) [, w (n_freq, n_chan)]. With a
    callback the run stops at the first callback chunk after convergence.
    """
    _check_ogive(update, model)
    numpy_in, _, Xd = _setup(X, dtype, device)
    w, a, use_mix, Cx, Cx_inv, epoch, done, mu, tolt = _ogive_start(
        Xd, step_size, tol, init_eig, 1
    )

    def outputs(w, scaled):
        return _finish(_ogive.ogive_demix(Xd, w)[:, :, None], Xd, scaled, numpy_in)

    remaining = int(n_iter)
    while remaining > 0:
        step = remaining if callback is None else min(int(callback_every), remaining)
        if callback is not None:
            callback(outputs(w, True))
        w, a, use_mix, epoch, done = _ogive.ogive_iterations(
            Xd, w, a, use_mix, Cx, Cx_inv, epoch, done, mu, tolt, step, model,
            update, int(switch_every),
        )
        remaining -= step
        if callback is not None and bool(done.all()):
            break
    Y = outputs(w, bool(proj_back))
    if return_filters:
        return Y, _output(w, numpy_in)
    return Y


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
    callback (use :func:`overiva` per mixture for that); the same holds for
    every ``*_batch`` form below.
    """
    _check_batch(X, "overiva_batch")
    N = _n_src(n_src, X.shape[3])
    _check_model(model)
    return _batch_run(X, N, n_iter, "ip", model, proj_back, dtype, device,
                      init_eig=bool(init_eig))


def _batch_out(Y, X, n_mix, proj_back, numpy_in):
    """Folded outputs (T, B*F, K) -> (B, T, F, K), projection-back-scaled
    against each mixture's mic 0 when ``proj_back``."""
    if proj_back:
        Y = _proj.apply_projection_back(Y, X[:, :, 0])
    return _output(_core.unfold_mixtures(Y, n_mix), numpy_in)


def _batch_run(X, N, n_iter, algo, model, proj_back, dtype, device, **opts):
    """A batch (B, T, F, M) through :func:`run_family`, folded into the bin
    axis (``models/overiva.py::fold_mixtures``). Returns (B, T, F, N)."""
    numpy_in, _, Xb = _setup(X, dtype, device)
    Xf = _core.fold_mixtures(Xb)
    Y, _ = run_family(Xf, N, int(n_iter), model, algo, n_mix=Xb.shape[0], **opts)
    return _batch_out(Y, Xf, Xb.shape[0], proj_back, numpy_in)


def auxiva_iss_batch(X, n_src=None, n_iter=20, proj_back=True, model="laplace",
                     dtype=None, device=None):
    """A batch (B, T, F, M) through AuxIVA-ISS (OverIVA-ISS when
    n_src < n_chan), folded into the bin axis as in :func:`overiva_batch`.
    Returns (B, T, F, n_src)."""
    _check_batch(X, "auxiva_iss_batch")
    N = _n_src(n_src, X.shape[3])
    _check_model(model)
    return _batch_run(X, N, n_iter, "iss", model, proj_back, dtype, device)


def overiva_iss_batch(X, n_src, **kw):
    """:func:`auxiva_iss_batch` with a required n_src."""
    return auxiva_iss_batch(X, n_src=n_src, **kw)


def overiva_ip2_batch(X, n_src=None, n_iter=10, proj_back=True, model="laplace",
                      dtype=None, device=None):
    """A batch (B, T, F, M) through OverIVA-IP2, folded into the bin axis
    as in :func:`overiva_batch` (f32 covariances). Returns (B, T, F, n_src)."""
    _check_batch(X, "overiva_ip2_batch")
    N = _n_src(n_src, X.shape[3], low=2)
    _check_model(model)
    return _batch_run(X, N, n_iter, "ip2", model, proj_back, dtype, device)


def ogive_batch(
    X,
    n_iter=4000,
    step_size=0.1,
    tol=1e-3,
    update="demix",
    proj_back=True,
    model="laplace",
    init_eig=False,
    switch_every=10,
    return_epochs=False,
    dtype=None,
    device=None,
):
    """A batch (B, T, F, M) through OGIVE, folded into the bin axis, with
    the early exit per mixture: a converged mixture freezes while the rest
    run on, and each stops at its single-clip epoch. Returns (B, T, F, 1)
    [, the epoch count of each mixture]."""
    _check_ogive(update, model)
    _check_batch(X, "ogive_batch")
    numpy_in, _, Xb = _setup(X, dtype, device)
    B = Xb.shape[0]
    Xf = _core.fold_mixtures(Xb)
    w, a, use_mix, Cx, Cx_inv, epoch, done, mu, tolt = _ogive_start(
        Xf, step_size, tol, init_eig, B
    )
    w, _, _, epoch, _ = _ogive.ogive_iterations(
        Xf, w, a, use_mix, Cx, Cx_inv, epoch, done, mu, tolt, int(n_iter), model,
        update, int(switch_every), n_mix=B,
    )
    Y = _batch_out(_ogive.ogive_demix(Xf, w)[:, :, None], Xf, B, proj_back, numpy_in)
    if return_epochs:
        return Y, _output(epoch, numpy_in)
    return Y


def five_batch(X, n_iter=10, proj_back=True, model="laplace", dtype=None,
               device=None):
    """A batch (B, T, F, M) through FIVE, folded into the bin axis.
    Returns (B, T, F, 1)."""
    _check_batch(X, "five_batch")
    _check_model(model)
    numpy_in, _, Xb = _setup(X, dtype, device)
    Xf = _core.fold_mixtures(Xb)
    Xw, _ = _five.five_whiten(Xf)
    w = _five.five_iterations(Xw, _five.five_init(Xw), int(n_iter), model, n_mix=Xb.shape[0])
    return _batch_out(_five.five_demix(Xw, w)[:, :, None], Xf, Xb.shape[0], proj_back,
                      numpy_in)


def auxiva_pca_batch(X, n_src=None, n_iter=20, proj_back=True, model="laplace",
                     inner="ip", dtype=None, device=None):
    """A batch (B, T, F, M) through PCA + determined AuxIVA (``inner`` as
    in :func:`auxiva_pca`), folded into the bin axis; projection back
    against each mixture's original mic 0. Returns (B, T, F, n_src)."""
    _check_batch(X, "auxiva_pca_batch")
    N = _n_src(n_src, X.shape[3])
    _check_algo(inner, "inner")
    if inner == "ip2" and N < 2:
        raise ValueError("inner='ip2' needs n_src >= 2")
    _check_model(model)
    numpy_in, _, Xb = _setup(X, dtype, device)
    Xf = _core.fold_mixtures(Xb)
    Y, _ = _pca.auxiva_pca_run(Xf, N, int(n_iter), model, inner=inner, n_mix=Xb.shape[0])
    return _batch_out(Y, Xf, Xb.shape[0], proj_back, numpy_in)


# ------------------------------------------- the per-(t,f)-weighted families

def _real_np(cdtype):
    return np.float32 if cdtype == torch.complex64 else np.float64


def _seeds(seed, seeds, n):
    """Each mixture's NMF seed: ``seeds`` if given, else seed + b."""
    seeds = [seed + b for b in range(n)] if seeds is None else list(seeds)
    if len(seeds) != n:
        raise ValueError(f"seeds must have batch length {n}")
    return seeds


def _nmf_init(seeds, N, F, K, T, cdtype, device):
    """Each mixture's NMF start, (nb, N, F, K) basis and (nb, N, K, T)
    activations: one ``default_rng(seed).random`` draw each, basis first,
    plus 0.1, as the JAX package draws them."""
    rdtype = _real_np(cdtype)
    basis, act = [], []
    for s in seeds:
        rng = np.random.default_rng(s)
        basis.append((rng.random((N, F, K)) + 0.1).astype(rdtype))
        act.append((rng.random((N, K, T)) + 0.1).astype(rdtype))
    return as_tensor(np.stack(basis), None, device), as_tensor(np.stack(act), None, device)


def _eyes(nb, F, M, dtype, device):
    return torch.eye(M, dtype=dtype, device=device).repeat(nb, F, 1, 1)


def _determined(n_src, M, name):
    if (M if n_src is None else int(n_src)) != M:
        raise ValueError(f"{name} is determined: n_src must equal n_chan")


def ilrma(
    X,
    n_src=None,
    n_iter=20,
    proj_back=True,
    W0=None,
    n_components=2,
    return_filters=False,
    callback=None,
    callback_every=10,
    seed=0,
    dtype=None,
    wcov="f32",
    device=None,
):
    """ILRMA (determined, rank-``n_components`` NMF source model;
    ``models/ilrma.py``). Reference: ``pyroomacoustics.bss.ilrma``. The
    NMF init is one ``default_rng(seed).random`` draw each for basis and
    activations, as the oracle's. ``wcov``: ``"f32"``, ``"f32x3"`` (exact
    f32 here) or ``"bf16"``; ``"bf16pack"`` raises (no per-(t,f) kernel).

    X: (n_frames, n_freq, n_chan). Returns Y (n_frames, n_freq, n_chan)
    [, W (n_freq, n_chan, n_chan)]."""
    T, F, M = X.shape
    _determined(n_src, M, "ilrma")
    check_tf_wcov(wcov)
    numpy_in, cdtype, Xd = _setup(X, dtype, device)
    Xb = Xd[None]
    W = (_eyes(1, F, M, cdtype, Xd.device) if W0 is None
         else as_tensor(W0, cdtype, Xd.device)[None])
    B, H = _nmf_init([seed], M, F, int(n_components), T, cdtype, Xd.device)

    def run(state, steps):
        return _ilrma.ilrma_iterations(Xb, *state, steps, str(wcov))

    W = chunked(run, (W, B, H), n_iter, _scaled_callback(callback, Xd, numpy_in),
                callback_every, lambda s: _core.demix(Xd, s[0][0]))[0][0]
    Y = _finish(_core.demix(Xd, W), Xd, bool(proj_back), numpy_in)
    if return_filters:
        return Y, _output(W, numpy_in)
    return Y


def ilrma_batch(X, n_src=None, n_iter=20, proj_back=True, n_components=2, seed=0,
                seeds=None, dtype=None, wcov="f32", device=None):
    """A batch (B, T, F, M) through ILRMA, with a leading batch axis (the
    activations and the rescale sum over each mixture's own bins, so the
    batch is not folded into them). Element b's NMF init is
    ``ilrma(X[b], seed=seed + b)``'s, or ``seed=seeds[b]``. Returns
    (B, T, F, M)."""
    _check_batch(X, "ilrma_batch")
    nb, T, F, M = X.shape
    _determined(n_src, M, "ilrma")
    check_tf_wcov(wcov)
    seeds = _seeds(seed, seeds, nb)
    numpy_in, cdtype, Xb = _setup(X, dtype, device)
    B, H = _nmf_init(seeds, M, F, int(n_components), T, cdtype, Xb.device)
    W, _, _ = _ilrma.ilrma_iterations(Xb, _eyes(nb, F, M, cdtype, Xb.device), B, H,
                                      int(n_iter), str(wcov))
    Xf = _core.fold_mixtures(Xb)
    return _batch_out(_core.fold_mixtures(_ilrma.ilrma_demix(Xb, W)), Xf, nb, proj_back,
                      numpy_in)


def _mnmf_slots(n_src, n_noise, M, init):
    """(outputs returned, model slots) of a FastMNMF run."""
    N_out = M if n_src is None else int(n_src)
    if N_out < 1:
        raise ValueError("need n_src >= 1")
    if init not in ("whiten", "eye"):
        raise ValueError(f"init must be 'whiten' or 'eye', got {init!r}")
    if n_noise == "auto":
        n_noise = M - N_out if N_out < M else 0
    return N_out, N_out + int(n_noise)


def _mnmf_start(Xb, N, n_components, seeds, init, tie_g):
    """The unit-power input, its scale and the start (Q, g, W, H) of a
    FastMNMF run on the mixtures Xb (nb, T, F, M): whitened (or identity)
    Q, diagonal-dominant g, the NMF init of each seed."""
    nb, T, F, M = Xb.shape
    Xu, x_scale = _mnmf.unit_power(Xb)
    Q = _mnmf.whiten_q(Xu) if init == "whiten" else _eyes(nb, F, M, Xb.dtype, Xb.device)
    g = np.full((N, M), 1e-2)
    for n in range(N):
        g[n, n % M] = 1.0
    g /= g.sum(axis=1, keepdims=True)
    if not tie_g:  # FastMNMF1: free per-frequency spatial weights
        g = np.tile(g[:, None, :], (1, F, 1))
    g = as_tensor(g.astype(_real_np(Xb.dtype)), None, Xb.device)
    W, H = _nmf_init(seeds, N, F, int(n_components), T, Xb.dtype, Xb.device)
    return Xu, x_scale, (Q, g.expand(nb, *g.shape).clone(), W, H)


def _mnmf_images(Xu, x_scale, state, mic_index, n_out):
    """The Wiener images at ``mic_index``, rescaled to the input, the
    ``n_out`` loudest of each mixture: (nb, T, F, n_out)."""
    Y = _mnmf.fastmnmf2_wiener(Xu, *state, int(mic_index)) * x_scale
    return _mnmf.pick_loudest(Y, n_out)


def _fastmnmf_impl(
    X,
    n_src=None,
    n_iter=30,
    n_components=2,
    mic_index=0,
    init="whiten",
    n_noise="auto",
    return_filters=False,
    callback=None,
    callback_every=10,
    seed=0,
    dtype=None,
    wcov="f32",
    tie_g=True,
    n_q_sweeps=1,
    device=None,
):
    """Shared FastMNMF1/2 runner (``tie_g`` picks the variant;
    ``models/fastmnmf2.py``). X: (n_frames, n_freq, n_chan). Returns Y
    (n_frames, n_freq, n_src), the multichannel Wiener images at
    ``mic_index`` (no projection back) [, (Q, g, W, H) of the whole model,
    fitted to the unit-power input, if ``return_filters``]. ``n_noise``
    extra slots ("auto": up to n_chan in all) absorb the noise floor; the
    n_src loudest images are returned. ``n_q_sweeps`` IP sweeps over the
    rows of Q an epoch reuse the epoch's covariances. ``wcov`` as in
    :func:`ilrma`."""
    T, F, M = X.shape
    # the measured regime boundary of the JAX package (PARITY.md): with
    # starved frames the full-rank model overfits at long horizons
    if T < 150 and n_iter > 60:
        warnings.warn(
            f"FastMNMF with only T={T} frames and n_iter={n_iter}: below "
            "the measured safe regime (T >= ~150 for 100+ epochs — "
            "PARITY.md). The full-rank model overfits starved frames at "
            "long horizons; float32 can go non-finite. Use a smaller nfft "
            "(more frames) or n_iter <= 60.",
            UserWarning,
            stacklevel=3,
        )
    N_out, N = _mnmf_slots(n_src, n_noise, M, init)
    check_tf_wcov(wcov)
    numpy_in, _, Xd = _setup(X, dtype, device)
    Xu, x_scale, state = _mnmf_start(Xd[None], N, n_components, [seed], init, tie_g)

    def outputs(state):
        return _output(_mnmf_images(Xu, x_scale, state, mic_index, N_out)[0], numpy_in)

    def run(state, steps):
        return _mnmf.fastmnmf2_iterations(Xu, *state, steps, str(wcov), int(n_q_sweeps))

    state = chunked(run, state, n_iter, callback, callback_every, outputs)
    Y = outputs(state)
    if return_filters:
        return Y, tuple(_output(s[0], numpy_in) for s in state)
    return Y


def fastmnmf2(X, **kwargs):
    """FastMNMF2: spatial weights g (N, M) tied across frequency (Sekiguchi
    et al., TASLP 2020). Parameters as in :func:`_fastmnmf_impl`."""
    return _fastmnmf_impl(X, tie_g=True, **kwargs)


def fastmnmf(X, **kwargs):
    """FastMNMF1: free per-frequency spatial weights g (N, F, M) (Sekiguchi
    et al., EUSIPCO 2019). Parameters as in :func:`_fastmnmf_impl`."""
    return _fastmnmf_impl(X, tie_g=False, **kwargs)


def fastmnmf2_batch(X, n_src=None, n_iter=30, n_components=2, mic_index=0,
                    init="whiten", n_noise="auto", seed=0, seeds=None, dtype=None,
                    tie_g=True, device=None):
    """A batch (B, T, F, M) through FastMNMF2 (``tie_g=False``: FastMNMF1),
    with a leading batch axis (H, g and nu sum over each mixture's own
    bins). Element b's NMF init is ``fastmnmf2(X[b], seed=seed + b)``'s,
    or ``seed=seeds[b]``. Returns (B, T, F, n_src)."""
    _check_batch(X, "fastmnmf2_batch")
    nb, T, F, M = X.shape
    N_out, N = _mnmf_slots(n_src, n_noise, M, init)
    seeds = _seeds(seed, seeds, nb)
    numpy_in, _, Xb = _setup(X, dtype, device)
    Xu, x_scale, state = _mnmf_start(Xb, N, n_components, seeds, init, tie_g)
    state = _mnmf.fastmnmf2_iterations(Xu, *state, int(n_iter))
    return _output(_mnmf_images(Xu, x_scale, state, mic_index, N_out), numpy_in)


def fastmnmf_batch(X, **kwargs):
    """Batched FastMNMF1: :func:`fastmnmf2_batch` with ``tie_g=False``."""
    return fastmnmf2_batch(X, tie_g=False, **kwargs)


def _sparse_taps(F, filter_taps, acausal_taps):
    """(nfft, causal taps, acausal taps) of the RTF support."""
    nfft = 2 * (F - 1)
    return (nfft, nfft // 4 if filter_taps is None else int(filter_taps),
            nfft // 16 if acausal_taps is None else int(acausal_taps))


def sparseauxiva(
    X,
    S=None,
    n_bins=None,
    n_src=None,
    n_iter=20,
    proj_back=True,
    W0=None,
    model="laplace",
    lasso_iter=300,
    lasso_lam=0.05,
    filter_taps=None,
    acausal_taps=None,
    polish_iter=3,
    return_filters=False,
    callback=None,
    callback_every=10,
    dtype=None,
    wcov="f32",
    device=None,
):
    """SparseAuxIVA: AuxIVA (IP) on a bin subset ``S``, LASSO reconstruction
    of the other bins' demixing from the mixing-side RTFs, then
    ``polish_iter`` full-band IP epochs (``models/sparseauxiva.py``; the
    oracle copy carries the design notes). Determined. S defaults to the
    stratified top-power F/4 bins, or ``n_bins`` of them (a count, or a
    fraction of F). ``wcov`` as in :func:`overiva`: ``"bf16pack"`` runs
    the packed CUDA kernel once an epoch in both IP phases on a CUDA
    device. ``callback`` receives full-band snapshots with zeros at the
    unselected bins during the subset phase. S = all bins is
    :func:`auxiva` exactly.

    X: (n_frames, n_freq, n_chan). Returns Y (n_frames, n_freq, n_chan)
    [, W (n_freq, n_chan, n_chan)]."""
    T, F, M = X.shape
    _determined(n_src, M, "sparseauxiva")
    check_wcov(wcov)
    _check_model(model)
    numpy_in, cdtype, Xd = _setup(X, dtype, device)
    if S is None:
        S = _sparse.select_bins(Xd[None], _resolve_n_bins(n_bins, F, M))[0]
    S = np.asarray(S)
    if S.ndim != 1 or S.size == 0 or S[-1] >= F or S[0] < 0:
        raise ValueError("S must be a non-empty 1-D array of bin indices < F")
    if np.any(np.diff(S) <= 0):
        raise ValueError("S must be strictly increasing (sorted, unique)")
    nfft, n_causal, n_acausal = _sparse_taps(F, filter_taps, acausal_taps)

    # phase 1: determined IP on the selected bins only
    S_t = torch.as_tensor(S, device=Xd.device)
    Xs = Xd[:, S_t, :]
    W0s = None if W0 is None else as_tensor(W0, cdtype, Xd.device)[S_t]
    cb = None
    if callback is not None:
        def cb(Ys):  # the scaled subset snapshot, placed into a full band
            full = Xd.new_zeros((T, F, M))
            full[:, S_t] = _proj.apply_projection_back(Ys, Xs[:, :, 0])
            callback(_output(full, numpy_in))
    Y, W = run_family(Xs, M, int(n_iter), model, "ip", W0=W0s, wcov=str(wcov),
                      callback=cb, callback_every=callback_every)

    if S.size < F:
        # phase 2: RTF LASSO reconstruction of the unselected bins
        W = _sparse.sparse_reconstruct(W[None], S[None], F, nfft, n_causal, n_acausal,
                                       int(lasso_iter), float(lasso_lam))[0]
        Xs = Xd
        if polish_iter > 0:  # phase 3: full-band polish, warm-started
            Y, W = run_family(Xd, M, int(polish_iter), model, "ip", W0=W, wcov=str(wcov))
        else:
            Y = _core.demix(Xd, W)
    Y = _finish(Y, Xs, bool(proj_back), numpy_in)
    if return_filters:
        return Y, _output(W, numpy_in)
    return Y


def sparseauxiva_batch(X, n_bins=None, n_src=None, n_iter=20, proj_back=True,
                       model="laplace", lasso_iter=300, lasso_lam=0.05, filter_taps=None,
                       acausal_taps=None, polish_iter=3, dtype=None, device=None):
    """A batch (B, T, F, M) through SparseAuxIVA: each mixture's own
    stratified subset (all of one size), the IP phases folded into the bin
    axis, FISTA as batched products (one partial-DFT matrix a mixture).
    Returns (B, T, F, M)."""
    _check_batch(X, "sparseauxiva_batch")
    nb, T, F, M = X.shape
    _determined(n_src, M, "sparseauxiva")
    _check_model(model)
    numpy_in, _, Xb = _setup(X, dtype, device)
    S = _sparse.select_bins(Xb, _resolve_n_bins(n_bins, F, M))
    k = S.shape[1]
    if k == F:
        raise ValueError("all bins selected: use auxiva_iss/overiva_batch")
    nfft, n_causal, n_acausal = _sparse_taps(F, filter_taps, acausal_taps)
    S_t = torch.as_tensor(S, device=Xb.device)
    Xs = torch.gather(Xb, 2, S_t[:, None, :, None].expand(nb, T, k, M))
    _, Ws = run_family(_core.fold_mixtures(Xs), M, int(n_iter), model, "ip", n_mix=nb)
    W = _sparse.sparse_reconstruct(Ws.reshape(nb, k, M, M), S, F, nfft, n_causal, n_acausal,
                                   int(lasso_iter), float(lasso_lam)).reshape(nb * F, M, M)
    Xf = _core.fold_mixtures(Xb)
    if polish_iter > 0:
        Y, _ = run_family(Xf, M, int(polish_iter), model, "ip", W0=W, n_mix=nb)
    else:
        Y = _core.demix(Xf, W)
    return _batch_out(Y, Xf, nb, proj_back, numpy_in)


# ------------------------------------------- the joint dereverberation family

def _check_taps(taps, delay):
    taps, delay = int(taps), int(delay)
    if taps < 0 or (taps > 0 and delay < 1):
        raise ValueError("need taps >= 0 and delay >= 1 when taps > 0")
    return taps, delay


def _check_wpe(taps, delay):
    if taps < 1:
        raise ValueError("taps must be >= 1")
    if delay < 1:
        raise ValueError("delay must be >= 1 (delay 0 would predict the current frame "
                         "from itself; with 50% STFT overlap use delay >= 2)")


def wpe(X, taps=10, delay=3, n_iter=3, diag_load=1e-5, dtype=None, device=None):
    """WPE dereverberation (``ops/wpe.py``; oracle twin ``oracle/wpe.py``).
    X: (n_frames, n_freq, n_chan) complex STFT -> the same shape, with the
    late reverberation subtracted by variance-normalized delayed linear
    prediction (Nakatani et al. 2010). Chain its tensor output into any
    separation call to keep the cascade on the device."""
    _check_wpe(taps, delay)
    numpy_in, _, Xd = _setup(X, dtype, device)
    return _output(_wpe.wpe(Xd, int(taps), int(delay), int(n_iter), float(diag_load)), numpy_in)


def wpe_batch(X, taps=10, delay=3, n_iter=3, diag_load=1e-5, dtype=None, device=None):
    """Batched WPE: (B, n_frames, n_freq, n_chan) -> the same, with a
    leading batch axis (each mixture's activation floor is its own)."""
    _check_wpe(taps, delay)
    _check_batch(X, "wpe_batch")
    numpy_in, _, Xb = _setup(X, dtype, device)
    return _output(_wpe.wpe(Xb, int(taps), int(delay), int(n_iter), float(diag_load)), numpy_in)


def _augmented_w0(W0, F, M, N, taps, dtype, device):
    """A user W0 -> the augmented stack (F, M, M + M*taps): a previous full
    augmented P, a square (F, M, M) stack (zero tap block), or (F, N, M)
    target rows placed into the identity. The row count is tested first:
    at taps=0 the full-augmented and square widths coincide."""
    W0 = as_tensor(W0, dtype, device)
    MJ = M + M * taps
    if W0.shape[1] != M:  # (F, N, M) target rows into the identity
        P0 = torch.zeros((F, M, MJ), dtype=dtype, device=device)
        P0[:, :, :M] = torch.eye(M, dtype=dtype, device=device)
        P0[:, :N, :M] = W0
    elif W0.shape[2] == MJ:  # full augmented (== square at taps=0)
        P0 = W0.clone()
    else:  # square (F, M, M), zero tap block
        P0 = torch.zeros((F, M, MJ), dtype=dtype, device=device)
        P0[:, :, :M] = W0
    return P0


def _joint_start(X, W0, N, taps, delay, out_dtype, cdtype):
    """(augmented input Xt, start P) of a joint run on X (T, F, M): the
    augmented identity, or ``W0`` through :func:`_augmented_w0` (rounded
    to ``out_dtype`` first, as the df tier takes it)."""
    T, F, M = X.shape
    Xt = _tiss.augment_taps(X, taps, delay)
    if W0 is None:
        return Xt, _tiss.augmented_eye(Xt, M)
    return Xt, _augmented_w0(W0, F, M, N, taps, out_dtype, X.device).to(cdtype)


def tiss(
    X,
    n_src=None,
    taps=5,
    delay=2,
    n_iter=20,
    proj_back=True,
    W0=None,
    model="laplace",
    return_filters=False,
    callback=None,
    callback_every=10,
    dtype=None,
    acc="f32",
    device=None,
):
    """T-ISS: joint dereverberation + separation by iterative source
    steering on ``[X | taps delayed copies]`` (``models/tiss.py``; oracle
    twin ``oracle/tiss.py``). ``taps=0`` is :func:`auxiva_iss` /
    :func:`overiva_iss` exactly; ``n_src < n_chan`` steers phi = 1
    background outputs. ``delay >= 1`` keeps the direct path out of the
    predictor. W0 may be a previous (F, M, M + M*taps) stack, a square
    (F, M, M) stack or (F, n_src, M) target rows. ``acc="f32x2"``: the
    certification tier, complex128 on the complex64-rounded input,
    complex64 out.

    Returns Y (n_frames, n_freq, n_src) [, P (n_freq, n_chan, n_chan +
    n_chan * taps)]."""
    M = X.shape[2]
    N = _n_src(n_src, M)
    taps, delay = _check_taps(taps, delay)
    numpy_in, cdtype, out_dtype, Xd = _df_setup(X, dtype, acc, device)
    Xt, P = _joint_start(Xd, W0, N, taps, delay, out_dtype, cdtype)

    def run(state, steps):  # resumes from (P, Y), never re-demixes
        return _tiss.tiss_iterations(Xt, state[0], steps, model, M, N, Y=state[1])

    P, Y = chunked(run, (P, _core.demix(Xt, P)), n_iter,
                   _scaled_callback(callback, Xd, numpy_in, out_dtype), callback_every,
                   lambda s: s[1][:, :, :N])
    return _outputs(Y[:, :, :N], P, Xd, proj_back, return_filters, numpy_in, out_dtype)


def _check_tip_wcov(wcov):
    check_wcov(wcov)
    if str(wcov) == "bf16pack":
        raise ValueError(
            "wcov='bf16pack' is untested on the tap-augmented (M(1+taps)-dim) "
            "epochs — use wcov='bf16' for T-IP's bf16 tier"
        )


def tip(
    X,
    n_src=None,
    taps=5,
    delay=2,
    n_iter=10,
    warm_iter=10,
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
    """T-IP: joint dereverberation + separation with exact IP rows on the
    augmented input (``models/tip.py``; oracle twin ``oracle/tip.py``).
    Without ``W0`` and with ``taps > 0``, ``warm_iter`` T-ISS epochs run
    first (cold-start full-row solves collapse on some scenes). ``taps=0,
    n_src=n_chan`` is AuxIVA's IP trajectory. ``wcov``: ``"f32"``,
    ``"f32x3"`` (exact f32 here) or ``"bf16"`` for the MJ-dim weighted
    covariances; ``"bf16pack"`` raises. ``acc="f32x2"`` as in
    :func:`tiss` (the warm-up included).

    Returns Y (n_frames, n_freq, n_src) [, P]."""
    M = X.shape[2]
    N = _n_src(n_src, M)
    taps, delay = _check_taps(taps, delay)
    _check_tip_wcov(wcov)
    numpy_in, cdtype, out_dtype, Xd = _df_setup(X, dtype, acc, device, wcov)
    Xt, P = _joint_start(Xd, W0, N, taps, delay, out_dtype, cdtype)
    if W0 is None and warm_iter > 0 and taps > 0:
        P, _ = _tiss.tiss_iterations(Xt, P, int(warm_iter), model, M, N)

    def run(P, steps):
        return _tip.tip_iterations(Xt, P, steps, model, M, N, str(wcov))

    P = chunked(run, P, n_iter, _scaled_callback(callback, Xd, numpy_in, out_dtype),
                callback_every, lambda P: _core.demix(Xt, P[:, :N, :]))
    return _outputs(_core.demix(Xt, P[:, :N, :]), P, Xd, proj_back, return_filters,
                    numpy_in, out_dtype)


def ilrma_t(
    X,
    n_src=None,
    taps=5,
    delay=2,
    n_iter=20,
    proj_back=True,
    W0=None,
    n_components=2,
    return_filters=False,
    callback=None,
    callback_every=10,
    seed=0,
    dtype=None,
    device=None,
):
    """ILRMA-T: joint dereverberation + ILRMA, the NMF model driving T-ISS
    steering on ``[X | delayed taps]`` (``models/ilrma_t.py``; oracle twin
    ``oracle/ilrma_t.py``). Determined (n_src == n_chan); ``taps=0`` is
    ILRMA-ISS. The NMF init is one ``default_rng(seed).random`` draw each
    for basis and activations, as the oracle's.

    Returns Y (n_frames, n_freq, n_chan) [, P]."""
    T, F, M = X.shape
    _determined(n_src, M, "ilrma_t")
    taps, delay = _check_taps(taps, delay)
    numpy_in, cdtype, Xd = _setup(X, dtype, device)
    Xt, P = _joint_start(Xd, W0, M, taps, delay, cdtype, cdtype)
    Xt, P = Xt[None], P[None]
    B, H = _nmf_init([seed], M, F, int(n_components), T, cdtype, Xd.device)

    def run(state, steps):
        P, Y, B, H = state
        return _ilrma_t.ilrma_t_iterations(Xt, P, B, H, steps, M, Y=Y)

    P, Y, _, _ = chunked(run, (P, _ilrma_t.ilrma_t_demix(Xt, P), B, H), n_iter,
                         _scaled_callback(callback, Xd, numpy_in), callback_every,
                         lambda s: s[1][0])
    return _outputs(Y[0], P[0], Xd, proj_back, return_filters, numpy_in)


def tiss_batch(X, n_src=None, taps=5, delay=2, n_iter=20, proj_back=True, model="laplace",
               dtype=None, device=None):
    """A batch (B, T, F, M) through T-ISS, folded into the bin axis (each
    mixture's own activations). Returns (B, T, F, n_src)."""
    _check_batch(X, "tiss_batch")
    M = X.shape[3]
    N = _n_src(n_src, M)
    taps, delay = _check_taps(taps, delay)
    numpy_in, _, Xb = _setup(X, dtype, device)
    nb = Xb.shape[0]
    Xt = _core.fold_mixtures(_tiss.augment_taps(Xb, taps, delay))
    _, Y = _tiss.tiss_iterations(Xt, _tiss.augmented_eye(Xt, M), int(n_iter), model, M, N,
                                 n_mix=nb)
    return _batch_out(Y[:, :, :N], _core.fold_mixtures(Xb), nb, proj_back, numpy_in)


def tip_batch(X, n_src=None, taps=5, delay=2, n_iter=10, warm_iter=10, proj_back=True,
              model="laplace", dtype=None, wcov="f32", device=None):
    """A batch (B, T, F, M) through T-IP (the T-ISS warm-up included),
    folded into the bin axis (each mixture's activations weight its own
    bins' covariances). Returns (B, T, F, n_src)."""
    _check_batch(X, "tip_batch")
    M = X.shape[3]
    N = _n_src(n_src, M)
    taps, delay = _check_taps(taps, delay)
    _check_tip_wcov(wcov)
    numpy_in, _, Xb = _setup(X, dtype, device)
    nb = Xb.shape[0]
    Xt = _core.fold_mixtures(_tiss.augment_taps(Xb, taps, delay))
    P = _tiss.augmented_eye(Xt, M)
    if warm_iter > 0 and taps > 0:
        P, _ = _tiss.tiss_iterations(Xt, P, int(warm_iter), model, M, N, n_mix=nb)
    P = _tip.tip_iterations(Xt, P, int(n_iter), model, M, N, str(wcov), n_mix=nb)
    return _batch_out(_core.demix(Xt, P[:, :N, :]), _core.fold_mixtures(Xb), nb, proj_back,
                      numpy_in)


def ilrma_t_batch(X, n_src=None, taps=5, delay=2, n_iter=20, proj_back=True, n_components=2,
                  seed=0, seeds=None, dtype=None, device=None):
    """A batch (B, T, F, M) through ILRMA-T, with a leading batch axis (the
    NMF activations and the renormalization sum over each mixture's own
    bins). Element b's NMF init is ``ilrma_t(X[b], seed=seed + b)``'s, or
    ``seed=seeds[b]``. Returns (B, T, F, M)."""
    _check_batch(X, "ilrma_t_batch")
    nb, T, F, M = X.shape
    _determined(n_src, M, "ilrma_t")
    taps, delay = _check_taps(taps, delay)
    seeds = _seeds(seed, seeds, nb)
    numpy_in, cdtype, Xb = _setup(X, dtype, device)
    B, H = _nmf_init(seeds, M, F, int(n_components), T, cdtype, Xb.device)
    Xt = _tiss.augment_taps(Xb, taps, delay)
    P = _tiss.augmented_eye(Xt[0], M).expand(nb, -1, -1, -1)
    _, Y, _, _ = _ilrma_t.ilrma_t_iterations(Xt, P, B, H, int(n_iter), M)
    Xf = _core.fold_mixtures(Xb)
    return _batch_out(_core.fold_mixtures(Y), Xf, nb, proj_back, numpy_in)


# -------------------------------------------------------------- streaming

def restored_state(host, current, dtype, device):
    """A checkpoint's host arrays as the state that replaces ``current``:
    the key sets and every shape must match (else ValueError), complex
    entries become ``dtype`` and the real ones its real dtype
    (:func:`utils.convert.stream_state_to_torch`), on ``device``."""
    if set(host) != set(current):
        raise ValueError(
            f"checkpoint keys {sorted(host)} != state keys {sorted(current)}"
        )
    for k, cur in current.items():
        if tuple(np.shape(host[k])) != tuple(cur.shape):
            raise ValueError(
                f"state {k!r}: checkpoint shape {np.shape(host[k])} != "
                f"configured {tuple(cur.shape)}"
            )
    return stream_state_to_torch(host, device, dtype)


class _StreamingState:
    """What the streaming classes share: the device and dtypes, block
    checks, and checkpoint/resume (the streaming analog of the batch
    ``(return_filters, W0)`` pair). The state stays on the device between
    calls; :meth:`save` copies it to the host, in the JAX package's npz
    layout, so either package resumes the other's checkpoints."""

    def _configure(self, n_freq, n_chan, dtype, device):
        self.device = resolve_device(device)
        self._cdtype = to_torch_dtype(dtype or DEFAULT_DTYPE)
        self._rdtype = self._cdtype.to_real()
        self._frame = (int(n_freq), int(n_chan))

    def _scalar(self, value):
        """A forgetting factor as a 0-d real tensor on the device (None stays)."""
        if value is None:
            return None
        return torch.tensor(float(value), dtype=self._rdtype, device=self.device)

    def _block(self, X_blk):
        """(NumPy in?, the block as a complex tensor on the device)."""
        numpy_in = not isinstance(X_blk, torch.Tensor)
        X = as_tensor(X_blk, self._cdtype, self.device)
        if X.ndim != 3 or tuple(X.shape[1:]) != self._frame:
            raise ValueError(
                f"block must be (block_frames, {self._frame[0]}, {self._frame[1]}), "
                f"got {tuple(X.shape)}"
            )
        return numpy_in, X

    def save(self, path, **meta):
        """Persist the full streaming state + metadata to ``path`` (npz).
        Returns the written path."""
        meta.setdefault("class", type(self).__name__)
        return save_state(path, state_to_numpy(self.state), **meta)

    def restore(self, path) -> dict:
        """Load state saved by :meth:`save` (by this package or the JAX
        package) into this instance; the keys and shapes must match the
        constructor's configuration. Returns the metadata."""
        host, meta = load_state(path)
        self.state = restored_state(host, self.state, self._cdtype, self.device)
        return meta


class OnlineAuxIVAISS(_StreamingState):
    """Streaming determined separation: feed STFT blocks, get separated
    blocks with O(block) latency (online rank-1 source steering with
    exponential forgetting, ``models/online_iss.py``).

    >>> sep = OnlineAuxIVAISS(n_freq=513, n_chan=4, forget=0.97)
    >>> for X_blk in stream:          # (block_frames, n_freq, n_chan) complex
    ...     y_blk = sep.process(X_blk)

    ``ramp``: forgetting-factor scheduling (RLS-style warm-up), default
    off; ``pb_forget``: a separate forgetting factor for the
    projection-back scale statistics (see ``online_iss_step``).
    ``device`` as in :func:`resolve_device` (default CUDA; without a card,
    pass ``device="cpu"``). The state stays on the device; a NumPy block
    gives a NumPy block, a tensor a tensor on the device.
    """

    def __init__(self, n_freq, n_chan, forget=0.97, model="laplace", n_pass=1,
                 ramp=False, pb_forget=None, dtype=None, device=None):
        _check_model(model)
        self._configure(n_freq, n_chan, dtype, device)
        self.model = model
        self.n_pass = int(n_pass)
        self.ramp = bool(ramp)
        self.state = _online_iss.online_iss_init(*self._frame, self._cdtype, self.device)
        self.forget = self._scalar(forget)
        self.pb_forget = self._scalar(pb_forget)

    def process(self, X_blk):
        """(block_frames, n_freq, n_chan) complex -> separated block."""
        numpy_in, X = self._block(X_blk)
        Y, self.state = _online_iss.online_iss_step(
            X, self.state, self.forget, self.model, self.n_pass, ramp=self.ramp,
            pb_forget=self.pb_forget,
        )
        return _output(Y, numpy_in)

    @property
    def filters(self) -> np.ndarray:
        """Current demixing matrix (n_freq, n_chan, n_chan), a host copy."""
        return _output(self.state["W"].clone(), True)


class OnlineTISS(_StreamingState):
    """Streaming joint dereverberation + separation (online T-ISS,
    ``models/online_tiss.py``): feed STFT blocks, get separated and
    dereverberated blocks with O(block) latency. The taps live inside the
    one demixing optimization on ``[X | delayed taps]``.

    >>> sep = OnlineTISS(n_freq=257, n_chan=2, taps=4, delay=2)
    >>> for X_blk in stream:          # (block_frames, n_freq, n_chan)
    ...     y_blk = sep.process(X_blk)

    ``tap_update``: "solve" (default; the tap rows re-derived each block
    from stationary statistics, with ``tap_forget`` and ``diag_load``) or
    "steer" (EW rank-1 tap steering, measured worse in the JAX package).
    ``taps=0`` reproduces :class:`OnlineAuxIVAISS` exactly. ``device`` and
    the input/output types as in :class:`OnlineAuxIVAISS`.
    """

    def __init__(self, n_freq, n_chan, taps=4, delay=2, forget=0.97, model="laplace",
                 n_pass=1, pb_forget=None, tap_update="solve", tap_forget=None,
                 diag_load=1e-5, dtype=None, device=None):
        self.taps, self.delay = _check_taps(taps, delay)
        if tap_update not in ("solve", "steer"):
            raise ValueError("tap_update must be 'solve' or 'steer'")
        _check_model(model)
        self._configure(n_freq, n_chan, dtype, device)
        self.model = model
        self.n_pass = int(n_pass)
        self.tap_update = tap_update
        self.diag_load = float(diag_load)
        self.state = _online_tiss.online_tiss_init(
            *self._frame, self.taps, self.delay, tap_update, self._cdtype, self.device
        )
        self.forget = self._scalar(forget)
        self.pb_forget = self._scalar(pb_forget)
        self.tap_forget = self._scalar(tap_forget)

    def process(self, X_blk):
        """(block_frames, n_freq, n_chan) complex -> separated and
        dereverberated block."""
        numpy_in, X = self._block(X_blk)
        Y, self.state = _online_tiss.online_tiss_step(
            X, self.state, self.forget, self.taps, self.delay, self.model, self.n_pass,
            pb_forget=self.pb_forget, tap_update=self.tap_update,
            diag_load=self.diag_load, tap_forget=self.tap_forget,
        )
        return _output(Y, numpy_in)

    @property
    def filters(self) -> np.ndarray:
        """Current augmented demixing stack (n_freq, M, M + M*taps), a host copy."""
        return _output(self.state["P"].clone(), True)


class OnlineWPE(_StreamingState):
    """Streaming WPE dereverberation (``models/online_wpe.py``): feed STFT
    blocks, get dereverberated blocks with O(block) latency (recursive tap
    statistics with exponential forgetting, the filter re-solved per
    block). ``forget`` is per frame (effective memory 1/(1-forget)
    frames).

    >>> drv = OnlineWPE(n_freq=513, n_chan=4, taps=8, delay=2)
    >>> sep = OnlineAuxIVAISS(n_freq=513, n_chan=4)
    >>> for X_blk in stream:          # (block_frames, n_freq, n_chan)
    ...     y_blk = sep.process(drv.process(X_blk))

    As a cascade into the online separator it measured negative in the
    JAX package (the per-block re-solve keeps the channel moving under
    the tracker); :class:`OnlineTISS` is the joint alternative. ``device``
    and the input/output types as in :class:`OnlineAuxIVAISS`.
    """

    def __init__(self, n_freq, n_chan, taps=8, delay=2, forget=0.99, diag_load=1e-5,
                 dtype=None, device=None):
        _check_wpe(taps, delay)
        self._configure(n_freq, n_chan, dtype, device)
        self.taps, self.delay = int(taps), int(delay)
        self.diag_load = float(diag_load)
        self.state = _online_wpe.online_wpe_init(
            *self._frame, self.taps, self.delay, self._cdtype, self.device
        )
        self.forget = self._scalar(forget)

    def process(self, X_blk):
        """(block_frames, n_freq, n_chan) complex -> dereverberated block."""
        numpy_in, X = self._block(X_blk)
        Y, self.state = _online_wpe.online_wpe_step(
            X, self.state, self.forget, self.taps, self.delay, self.diag_load
        )
        return _output(Y, numpy_in)

    @property
    def filters(self) -> np.ndarray:
        """Current prediction filter (n_freq, n_chan*taps, n_chan), a host copy."""
        return _output(self.state["G"].clone(), True)


def to_device(X, dtype=None, device=None):
    """A (complex or real) array or tensor as a complex tensor of ``dtype``
    (default complex64) on the resolved device; a real input gains a zero
    imaginary part. Upload a batch STFT once and pass the result to many
    ``*_batch`` calls: a tensor on the device skips each call's own copy."""
    cdtype = to_torch_dtype(dtype or DEFAULT_DTYPE)
    return as_tensor(X, cdtype, resolve_device(device, X))


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


def _separate_mnmf(X, n_src, n_iter, algo):
    """FastMNMF2 (or FastMNMF1) on X (T, F, M) as the JAX package's fused
    ``separate`` runs it: unit power, whitened Q, M slots, L = 2 NMF
    components drawn from ``jax.random.PRNGKey(0)``, the Wiener images at
    mic 0 rescaled, the ``n_src`` loudest. Returns (T, F, n_src)."""
    T, F, M = X.shape
    rdtype = X.real.dtype
    Xu, x_scale = _mnmf.unit_power(X[None])
    g = torch.full((M, M), 1e-2, dtype=rdtype, device=X.device)
    g.fill_diagonal_(1.0)
    g = g / g.sum(dim=1, keepdim=True)
    if algo == "fastmnmf":  # FastMNMF1: per-frequency spatial weights
        g = g[:, None, :].expand(M, F, M)
    rnp = np.dtype(_real_np(X.dtype))
    k1, k2 = threefry.split(threefry.prng_key(0))
    W = threefry.uniform(k1, (M, F, 2), rnp) + rnp.type(0.1)
    H = threefry.uniform(k2, (M, 2, T), rnp) + rnp.type(0.1)
    state = (_mnmf.whiten_q(Xu), g[None], as_tensor(W[None], None, X.device),
             as_tensor(H[None], None, X.device))
    state = _mnmf.fastmnmf2_iterations(Xu, *state, n_iter)
    return _mnmf_images(Xu, x_scale, state, 0, n_src)[0]


_SEPARATE_ALGOS = FAMILIES + ("tiss", "tip", "ilrma_t") + _MNMF_ALGOS


def _separate_joint(X, n_src, n_iter, model, algo, taps, delay):
    """T-ISS, T-IP (10 warm T-ISS epochs when taps > 0) or ILRMA-T on X
    (T, F, M) as the JAX package's fused ``separate`` runs them; ILRMA-T's
    NMF init is drawn from ``jax.random.PRNGKey(0)`` (the port's copy
    ``utils/threefry.py``) and its n_src most energetic outputs are kept.
    Returns the unscaled outputs (T, F, n_src)."""
    T, F, M = X.shape
    Xt = _tiss.augment_taps(X, taps, delay)
    P = _tiss.augmented_eye(Xt, M)
    if algo == "tiss":
        return _tiss.tiss_iterations(Xt, P, n_iter, model, M, n_src)[1][:, :, :n_src]
    if algo == "tip":
        if taps:  # the warm start
            P, _ = _tiss.tiss_iterations(Xt, P, 10, model, M, n_src)
        return _core.demix(Xt, _tip.tip_iterations(Xt, P, n_iter, model, M, n_src))[:, :, :n_src]
    rnp = np.dtype(_real_np(X.dtype))
    k1, k2 = threefry.split(threefry.prng_key(0))
    B = as_tensor(threefry.uniform(k1, (M, F, 2), rnp) + rnp.type(0.1), None, X.device)
    H = as_tensor(threefry.uniform(k2, (M, 2, T), rnp) + rnp.type(0.1), None, X.device)
    _, Y, _, _ = _ilrma_t.ilrma_t_iterations(Xt[None], P[None], B[None], H[None], n_iter, M)
    return _mnmf.pick_loudest(Y, n_src)[0]


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
    wpe=None,
    taps=5,
    delay=2,
    device=None,
):
    """Time-domain in, time-domain out: STFT -> [WPE] -> separation ->
    projection back -> iSTFT, on one device.

    ``algo``: "ip" (OverIVA/AuxIVA iterative projection), "iss" (source
    steering; OverIVA-ISS when n_src < n_chan), "ip2" (pairwise updates,
    n_src >= 2; ``init_eig`` does not apply, as in the JAX package),
    "tiss" (joint dereverberation + separation by steering on delayed
    taps; ``taps``/``delay`` apply), "tip" (joint with exact IP rows, 10
    warm T-ISS epochs built in), "ilrma_t" (joint dereverberation + ILRMA;
    the extra outputs picked by energy), or "fastmnmf"/"fastmnmf2" (the
    full-rank spatial model with n_chan slots, Wiener images at mic 0 and
    no projection back; the n_src loudest are returned). The NMF inits of
    "ilrma_t" and "fastmnmf*" are the JAX package's ``jax.random.PRNGKey(0)``
    draws, from the port's copy ``utils/threefry.py``.
    ``wpe``: None, True, or a dict of :func:`wpe` options (``taps``,
    ``delay``, ``n_iter``; defaults 10, 3, 3): the dereverberation front.
    mix: (n_samples, n_chan) real. Returns (n_samples, n_src) real.
    """
    if algo not in _SEPARATE_ALGOS:
        raise ValueError(
            f"unknown algo {algo!r}; use 'ip', 'iss', 'ip2', 'tiss', 'tip', 'ilrma_t', "
            "'fastmnmf' or 'fastmnmf2'"
        )
    numpy_in = not isinstance(mix, torch.Tensor)
    hop = hop or nfft // 2
    n, M = mix.shape
    N = _n_src(n_src, M)
    if algo == "ip2" and N < 2:
        raise ValueError("algo='ip2' needs n_src >= 2")
    _check_model(model)
    wkw = {"taps": 10, "delay": 3, "n_iter": 3}
    if isinstance(wpe, dict):
        bad = set(wpe) - set(wkw)
        if bad:
            raise ValueError(f"unknown wpe option(s): {sorted(bad)}")
        wkw.update(wpe)
    rdtype = to_torch_dtype(dtype or DEFAULT_DTYPE).to_real()
    x = as_tensor(mix, rdtype, resolve_device(device, mix))
    X = _stft.analysis(_stft.stft_pad(x, int(nfft), int(hop)), int(nfft), int(hop))
    if wpe:  # the dereverberation front
        X = _wpe.wpe(X, int(wkw["taps"]), int(wkw["delay"]), int(wkw["n_iter"]))
    if algo in _MNMF_ALGOS:
        Y = _separate_mnmf(X, N, int(n_iter), algo)
    else:
        if algo in FAMILIES:
            # init_eig applies to "ip" only, as in the JAX package's separate
            Y, _ = run_family(X, N, int(n_iter), model, algo,
                              init_eig=bool(init_eig) and algo == "ip")
        else:
            Y = _separate_joint(X, N, int(n_iter), model, algo, int(taps), int(delay))
        Y = _proj.apply_projection_back(Y, X[:, :, 0])
    y = _stft.synthesis(Y, int(nfft), int(hop))
    start = nfft - hop
    return _output(y[start : start + n], numpy_in)
