"""The arithmetic a reference run computes in.

``F64`` is the reference itself: complex128, every product exact to
float64. ``TF32`` is the control, the nearest precision below what the
configurations state (complex64 with TF32 off): complex64 storage, and
every operand of a contraction (matmul, einsum over frames or mics)
rounded to TF32's 10-bit mantissa before the product, as cuBLAS would
with TF32 switched on. Element-wise steps, solves and FFTs stay float32.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Arith", "F64", "TF32", "tf32_round"]


def tf32_round(a: np.ndarray) -> np.ndarray:
    """``a`` (float32 or complex64) rounded to nearest-even at TF32's
    10-bit mantissa, as a new array of the same dtype."""
    a = np.ascontiguousarray(a)
    u = a.view(np.float32).view(np.uint32)
    lsb = (u >> np.uint32(13)) & np.uint32(1)
    r = (u + np.uint32(0xFFF) + lsb) & np.uint32(0xFFFFE000)
    return r.view(np.float32).view(a.dtype)


class Arith:
    """Storage dtypes and the rounding of contraction operands."""

    def __init__(self, name: str, complex_dtype, tf32: bool):
        self.name = name
        self.cdtype = np.dtype(complex_dtype)
        self.rdtype = np.empty(0, self.cdtype).real.dtype
        self.tf32 = tf32

    def c(self, a) -> np.ndarray:
        return np.asarray(a, dtype=self.cdtype)

    def r(self, a) -> np.ndarray:
        return np.asarray(a, dtype=self.rdtype)

    def op(self, a) -> np.ndarray:
        """An operand of a contraction, in this arithmetic."""
        return tf32_round(a) if self.tf32 else a


F64 = Arith("f64", np.complex128, tf32=False)
TF32 = Arith("tf32", np.complex64, tf32=True)
