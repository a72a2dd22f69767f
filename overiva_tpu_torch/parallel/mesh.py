"""The ('mix', 'bins') device mesh of the multi-device tier.

Counterpart of ``overiva_tpu/parallel/mesh.py``. JAX drives every device
from one controller; PyTorch runs one process per rank, so the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, with the JAX package's axis names:

- ``mix``: independent mixtures, data parallel, no collective;
- ``bins``: frequency bins, independent given the activations, so an
  epoch's collectives are the small psums of per-rank partial sums over
  the ranks of one 'bins' group (``mesh.get_group("bins")``).

Rank r works on ``cuda:(r % torch.cuda.device_count())``. The backend is
NCCL for CUDA and gloo for the CPU unless asked otherwise: gloo on CUDA
tensors (collectives staged through the host) is the explicit choice for
several ranks on one card, which NCCL refuses.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["AXIS_BINS", "AXIS_MIX", "axis_size", "default_backend", "make_mesh", "rank_device"]

AXIS_MIX = "mix"
AXIS_BINS = "bins"


def default_backend(device_type: str) -> str:
    """NCCL for ``"cuda"``, gloo for ``"cpu"``. Raises RuntimeError for
    ``"cuda"`` without a card (no quiet CPU run), whatever backend the
    caller then picks, and ValueError for any other device type."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False): the mesh "
            'runs on CUDA unless asked otherwise; pass device_type="cpu"'
        )
    return "nccl"


def rank_device(device_type: str, rank: int) -> torch.device:
    """The device rank ``rank`` works on: ``cuda:(rank % device_count)``,
    or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The size of the mesh axis ``name``."""
    return mesh.size(mesh.mesh_dim_names.index(name))


def make_mesh(n_mix: int | None = None, n_bins: int | None = None, *,
              device_type: str = "cuda", backend: str | None = None) -> DeviceMesh:
    """Build a ('mix', 'bins') mesh over every rank of the process group.

    With no sizes, every rank goes on the 'bins' axis (one mixture
    separated as fast as possible); a missing factor is inferred, and
    n_mix * n_bins must equal the world size (else ValueError), as in the
    JAX package. Initializes the default process group from the
    environment (``torchrun``'s ``env://``) with ``backend`` if nothing
    has (``parallel/launch.py`` initializes it for its ranks); an
    initialized group must already use ``backend`` when one is given.
    """
    default = default_backend(device_type)  # "cuda" without a card raises here
    backend = backend or default
    if not dist.is_initialized():
        dist.init_process_group(backend)
    elif dist.get_backend() != backend:
        raise ValueError(
            f"the process group runs {dist.get_backend()!r}, not the requested {backend!r}"
        )
    n = dist.get_world_size()
    if n_mix is None and n_bins is None:
        n_mix, n_bins = 1, n
    elif n_mix is None:
        n_mix = n // n_bins
    elif n_bins is None:
        n_bins = n // n_mix
    if n_mix * n_bins != n:
        raise ValueError(f"mesh {n_mix}x{n_bins} != {n} ranks")
    if device_type == "cuda":
        torch.cuda.set_device(rank_device(device_type, dist.get_rank()))
    return DeviceMesh(device_type, torch.arange(n).reshape(n_mix, n_bins),
                      mesh_dim_names=(AXIS_MIX, AXIS_BINS))
