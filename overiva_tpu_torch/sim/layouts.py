"""Source / microphone layout helpers: the port's copy of
``overiva_tpu/sim/layouts.py``.

Mirrors the reference's ``routines.py`` layout functions (SURVEY.md §2.1):
``semi_circle_layout``, ``random_layout``, ``grid_layout``, plus a circular
mic array builder used by the demo/benchmarks.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "semi_circle_layout",
    "random_layout",
    "grid_layout",
    "circular_mic_array",
]


def semi_circle_layout(center, angle: float, distance: float, n: int, rot: float = 0.0):
    """n points on a semi-circular arc of given angular ``angle`` span (rad),
    at ``distance`` from ``center``, rotated by ``rot``. Returns (n, 3)."""
    center = np.asarray(center, np.float64)
    if n == 1:
        angles = np.array([rot])
    else:
        angles = np.linspace(-angle / 2, angle / 2, n) + rot
    pts = np.zeros((n, 3))
    pts[:, 0] = center[0] + distance * np.cos(angles)
    pts[:, 1] = center[1] + distance * np.sin(angles)
    pts[:, 2] = center[2] if center.shape[0] > 2 else 0.0
    return pts


def random_layout(bounds_lo, bounds_hi, n: int, rng=None, margin: float = 0.0):
    """n uniform random points in the box [lo+margin, hi-margin]. (n, 3)."""
    rng = rng or np.random.default_rng()
    lo = np.asarray(bounds_lo, np.float64) + margin
    hi = np.asarray(bounds_hi, np.float64) - margin
    return lo + (hi - lo) * rng.random((n, lo.shape[0]))


def grid_layout(bounds_lo, bounds_hi, n: int, z: float | None = None):
    """n points on a near-square 2D grid spanning the xy box. (n, 3)."""
    lo = np.asarray(bounds_lo, np.float64)
    hi = np.asarray(bounds_hi, np.float64)
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    xs = np.linspace(lo[0], hi[0], cols)
    ys = np.linspace(lo[1], hi[1], rows)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.zeros((rows * cols, 3))
    pts[:, 0] = gx.ravel()
    pts[:, 1] = gy.ravel()
    pts[:, 2] = z if z is not None else (lo[2] if lo.shape[0] > 2 else 0.0)
    return pts[:n]


def circular_mic_array(center, radius: float, n: int, rot: float = 0.0):
    """n mics on a circle in the xy plane. (n, 3)."""
    center = np.asarray(center, np.float64)
    angles = 2.0 * np.pi * np.arange(n) / n + rot
    pts = np.zeros((n, 3))
    pts[:, 0] = center[0] + radius * np.cos(angles)
    pts[:, 1] = center[1] + radius * np.sin(angles)
    pts[:, 2] = center[2] if center.shape[0] > 2 else 0.0
    return pts
