"""The two collectives of the bin-sharded epochs, ``psum`` and ``pmax``.

Counterparts of ``jax.lax.psum`` and ``jax.lax.pmax`` over the 'bins' mesh
axis: ``dist.all_reduce`` over the process group of the ranks that share a
mixture (``DeviceMesh.get_group("bins")``). Each takes the group as its
``group`` argument and returns its input unchanged when that is None, so
a model's epoch with ``group=None`` is the single-device epoch bit for
bit. Every call with a group adds one to :data:`counts` under its name:
the number of collectives a run made, which the tests and
``chip_smoke.py`` hold to the number of ``psum``/``pmax`` calls the JAX
epoch makes.

The all-reduce runs in place on a private contiguous copy (a complex
tensor as its real view), so no caller's tensor is written. That works on
every backend the port uses: NCCL, and gloo on CPU and on CUDA tensors.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

__all__ = ["assemble", "counts", "pmax", "psum"]

counts: Counter = Counter()


def _all_reduce(t, group, op=dist.ReduceOp.SUM):
    """All-reduce the contiguous tensor ``t`` in place over ``group`` (a
    complex tensor through its real view); returns ``t``."""
    dist.all_reduce(torch.view_as_real(t) if t.is_complex() else t, op=op, group=group)
    return t


def assemble(t, group=None):
    """Every rank's block of ``t``, in place: each rank of ``group`` (None:
    all ranks) writes its own block into a zero-filled ``t`` and the sum
    over the ranks fills in the others, exactly (a sum with zeros). This
    is the port's all-gather: gloo has none for CUDA tensors. Counted
    under ``"assemble"``, apart from the epochs' collectives. int16 (PCM)
    is summed as int32: gloo has no int16 reduction."""
    counts["assemble"] += 1
    if t.dtype == torch.int16:
        return t.copy_(_all_reduce(t.to(torch.int32), group))
    return _all_reduce(t, group)


def psum(x, group):
    """The sum of ``x`` over the ranks of ``group``; ``x`` itself when
    ``group`` is None."""
    if group is None:
        return x
    counts["psum"] += 1
    return _all_reduce(x.clone(memory_format=torch.contiguous_format), group)


def pmax(x, group):
    """The elementwise maximum of the real ``x`` over the ranks of
    ``group``; ``x`` itself when ``group`` is None."""
    if group is None:
        return x
    counts["pmax"] += 1
    return _all_reduce(x.clone(memory_format=torch.contiguous_format), group, dist.ReduceOp.MAX)
