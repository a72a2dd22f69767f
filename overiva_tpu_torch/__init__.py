"""overiva_tpu_torch — OverIVA/AuxIVA and its sibling families in PyTorch,
for CUDA.

A port of ``overiva_tpu`` (the JAX package, which stays the reference)
to PyTorch on an NVIDIA H100. The public API mirrors ``overiva_tpu.api``:

    stft_analysis(x, nfft) -> X            (n_frames, n_freq, n_chan)
    overiva(X, n_src, n_iter, proj_back, W0, model, init_eig,
            return_filters, callback, ...) -> Y
    auxiva(...), projection_back(Y, ref), stft_synthesis(Y, nfft),
    auxiva_iss, overiva_iss, overiva_ip2, auxiva_ip2, ogive, five,
    ilrma, fastmnmf2, fastmnmf, sparseauxiva,
    wpe, tiss, tip, ilrma_t (joint dereverberation + separation),
    separate(mix, n_src, algo="ip"|"iss"|"ip2"|"tiss"|"tip"|"ilrma_t"|
             "fastmnmf"|"fastmnmf2", wpe=None|True|dict),
    pca, auxiva_pca(inner="ip"|"iss"|"ip2"),
    stft_analysis_batch, stft_synthesis_batch and the batch forms
    overiva_batch, auxiva_iss_batch, overiva_iss_batch, overiva_ip2_batch,
    ogive_batch, five_batch, auxiva_pca_batch, ilrma_batch,
    fastmnmf2_batch, fastmnmf_batch, sparseauxiva_batch, wpe_batch,
    tiss_batch, tip_batch, ilrma_t_batch,
    OnlineAuxIVAISS, OnlineTISS, OnlineWPE (streaming: STFT blocks in and
    out, the state on the device, save/restore)

``to_device(X)`` uploads an array once as a complex tensor.

``overiva_tpu_torch.serving.Separator`` (also exported here, with
``SERVABLE`` and ``bucket_frames``) serves clips of any length on a
frame-bucket grid, samples in and out, ``separate_batch`` for a group and
int16 PCM tiers; ``serving.StreamingSeparator`` streams samples in and
out (framing and overlap-add on the device too); ``overiva_tpu_torch.sim``
builds simulated rooms (the copy of ``overiva_tpu/sim/``). The CLI twins
``python -m overiva_tpu_torch.examples.oneshot``, ``.serving``,
``.parity_check`` and ``.streaming`` drive them.

``overiva_tpu_torch.parallel`` is the multi-device tier: a ('mix',
'bins') ``torch.distributed`` mesh, the 17 ``sharded_*`` families of
``overiva_tpu.parallel.sharded``, a rank launcher and a dry run
(``python -m overiva_tpu_torch.parallel.dryrun``); ``Separator(mesh=...)``
shards ``separate_batch`` over it.

``overiva_tpu_torch.registry`` maps the 30 algorithm names of
``overiva_tpu.registry`` (``get_algorithm(name)(X, n_src=...)``, and
``run_batch`` for a (B, T, F, M) stack) to these functions.

Inputs may be NumPy arrays or tensors. NumPy in gives NumPy out; a tensor
in gives a tensor out, on the device the work ran on. Every public
function takes ``device=``; see :func:`resolve_device`: a NumPy input runs
on CUDA unless ``device="cpu"`` is given. The package imports ``torch`` and
never ``jax``, nor anything of ``overiva_tpu``: the NumPy references it
needs are its own copies (``oracle/``, ``metrics/``).

Two CUDA C++ kernels for ``sm_90a``, built with ``nvcc`` at first use: the
weighted covariance of ``wcov="bf16pack"`` (``csrc/wcov_packed.cu``) and
the fused per-bin IP update (``csrc/update_rows.cu``, ``ops/update_rows.py``,
run by ``models/overiva.py::_fused_epoch``). ``overiva_ip2`` and both IP
phases of ``sparseauxiva`` with ``wcov="bf16pack"`` run the first once an
epoch too.
"""

from .version import __version__

__all__ = ["__version__", "resolve_device"]

_API = {
    name: "api"
    for name in (
        "OnlineAuxIVAISS", "OnlineTISS", "OnlineWPE",
        "auxiva", "auxiva_ip2", "auxiva_iss", "auxiva_iss_batch", "auxiva_pca",
        "auxiva_pca_batch", "fastmnmf", "fastmnmf2", "fastmnmf2_batch",
        "fastmnmf_batch", "five", "five_batch", "ilrma", "ilrma_batch", "ilrma_t",
        "ilrma_t_batch", "ogive",
        "ogive_batch", "overiva", "overiva_batch", "overiva_ip2",
        "overiva_ip2_batch", "overiva_iss", "overiva_iss_batch", "pca",
        "projection_back", "separate", "sparseauxiva", "sparseauxiva_batch",
        "stft_analysis", "stft_analysis_batch", "stft_synthesis",
        "stft_synthesis_batch", "tip", "tip_batch", "tiss", "tiss_batch", "to_device",
        "wpe", "wpe_batch",
    )
}
_SERVING = {name: "serving" for name in ("SERVABLE", "Separator", "bucket_frames")}
__all__ += sorted(_API) + sorted(_SERVING)


def __getattr__(name):
    # lazy: `import overiva_tpu_torch` stays light until the API is used
    module = _API.get(name) or _SERVING.get(name)
    if module is not None:
        return getattr(__import__(f"overiva_tpu_torch.{module}", fromlist=[name]), name)
    raise AttributeError(f"module 'overiva_tpu_torch' has no attribute {name!r}")


def resolve_device(device=None, like=None):
    """The device a call runs on: ``device`` if given, else the device of
    the tensor ``like``, else CUDA. Without a card that last case raises
    RuntimeError: the port never falls back to the CPU unasked, so a CPU
    run passes ``device="cpu"``.

    On CUDA it also turns TF32 off for matrix products and cuDNN, so that
    float32 work is full float32 (the JAX package's ``Precision.HIGHEST``).
    """
    import torch

    if device is not None:
        dev = torch.device(device)
    elif isinstance(like, torch.Tensor):
        dev = like.device
    elif torch.cuda.is_available():
        dev = torch.device("cuda")
    else:
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False): the port "
            'runs on CUDA unless asked otherwise; pass device="cpu" to run '
            "on the CPU"
        )
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
