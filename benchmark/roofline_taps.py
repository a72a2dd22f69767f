"""The least time the card needs for one epoch's tap steps of T-ISS.

``tap_steps_bound`` counts the bytes that any implementation of the MK
tap-steering steps of an epoch (``overiva_tpu_torch/models/tiss.py::
tap_steps``) must move, whatever implements them: the delayed
observations Z (T, BF, MK) read once, the outputs Y (T, BF, M) read and
written once, the weights phi (T, B, M) read once, and the tap block of
the demixing P (BF, M, MK) written once; complex64 and float32. Their
operations (two complex multiply-adds a step for each of T x BF x M) take
less than the bytes at ``roofline.F32_FLOPS``, so the bytes set the
bound, at ``roofline.HBM_BYTES_S``.
"""

from __future__ import annotations

from .roofline import HBM_BYTES_S

__all__ = ["tap_steps_bound", "tap_steps_bytes"]


def tap_steps_bytes(T, BF, B, M, MK) -> int:
    """Bytes of one epoch's tap steps: T frames, BF bins of B folded
    mixtures, M outputs, MK delayed observations."""
    return 8 * T * BF * MK + 2 * 8 * T * BF * M + 4 * T * B * M + 8 * BF * M * MK


def tap_steps_bound(T, BF, B, M, MK):
    """(seconds, what sets it) of one epoch's tap steps."""
    return tap_steps_bytes(T, BF, B, M, MK) / HBM_BYTES_S, "bytes"
