"""The least time the card needs for one epoch's source steps of ISS and
T-ISS.

``source_steps_bound`` counts the bytes that any implementation of the M
source-steering steps of an epoch (``overiva_tpu_torch/models/
auxiva_iss.py::iss_steps``) must move, whatever implements them: the
outputs Y (T, BF, M) read and written once, the demixing rows W (BF, M, J)
read and written once, and the weights phi (T, B, M) read once; complex64
and float32. Their operations (~20 flops a step for each of T x BF x M)
take less than the bytes at ``roofline.F32_FLOPS``, so the bytes set the
bound, at ``roofline.HBM_BYTES_S``.
"""

from __future__ import annotations

from .roofline import HBM_BYTES_S

__all__ = ["source_steps_bound", "source_steps_bytes"]


def source_steps_bytes(T, BF, B, M, J) -> int:
    """Bytes of one epoch's source steps: T frames, BF bins of B folded
    mixtures, M outputs, rows of width J."""
    return 2 * 8 * T * BF * M + 2 * 8 * BF * M * J + 4 * T * B * M


def source_steps_bound(T, BF, B, M, J):
    """(seconds, what sets it) of one epoch's source steps."""
    return source_steps_bytes(T, BF, B, M, J) / HBM_BYTES_S, "bytes"
