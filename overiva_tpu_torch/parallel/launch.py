"""Spawn the ranks of a multi-device run: one process per rank, one
process group between them.

    results = launch(fn, n_ranks, args, kwargs, device_type="cpu")

Each rank is a process started with ``torch.multiprocessing``'s ``spawn``
(it imports the port afresh, and nothing of JAX). It sets its CUDA device
(``mesh.rank_device``), joins the process group through a ``file://``
store in a temporary directory, runs ``fn(*args, **kwargs)`` and sends its return
value back pickled in a file of that directory; ``launch`` returns the
values in rank order. ``fn`` must be importable by name (a module-level
function). If a rank raises or dies, the others are terminated and
``launch`` raises; so it does after ``timeout`` seconds.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import default_backend, rank_device

__all__ = ["launch"]


def _rank_main(rank, fn, args, kwargs, n_ranks, tmp, device_type, backend):
    if device_type == "cuda":
        torch.cuda.set_device(rank_device(device_type, rank))
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=rank, world_size=n_ranks)
    try:
        out = fn(*args, **kwargs)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def launch(fn, n_ranks: int, args=(), kwargs=None, *, device_type: str = "cuda",
           backend: str | None = None, timeout: float = 900.0) -> list:
    """Run ``fn(*args, **kwargs)`` on ``n_ranks`` spawned ranks of one process group
    (``backend``, default NCCL on ``"cuda"``, gloo on ``"cpu"``) and return
    each rank's return value, in rank order."""
    default = default_backend(device_type)  # "cuda" without a card raises here
    backend = backend or default
    with tempfile.TemporaryDirectory(prefix="ovt_ranks_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, tuple(args), dict(kwargs or {}), n_ranks, tmp, device_type,
                              backend),
            nprocs=n_ranks, join=False, start_method="spawn",
        )
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n_ranks} ranks still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        results = []
        for rank in range(n_ranks):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
