"""What the metric files share. A reader returns None when its run holds
nothing to read, and the metric is then left out of the line."""

from __future__ import annotations

import numpy as np


def latency_percentile_ms(ctx, q: float):
    lat = [r["t1"] - r["t0"] for r in ctx.records]
    return float(np.percentile(lat, q)) * 1e3 if lat else None


def pad_frac(ctx):
    """Padded frames over all frames the serving tier ran, in the window."""
    c = ctx.counters
    total = c.get("frames_real", 0) + c.get("frames_padded", 0)
    return c["frames_padded"] / total if total else None


def launches_per_item(ctx):
    t = ctx.trace
    return t["launches"] / t["items"] if t and t["items"] else None


def idle_frac(ctx):
    """1 - the device's busy time per item, read in the traced stretch,
    over the wall per item of the untraced window: the profiler slows the
    host, so the traced stretch's own span would read the idle share of a
    traced run, not of the program."""
    t = ctx.trace
    if not t or t["busy_s"] <= 0 or not t["items"] or not ctx.records:
        return None
    return 1.0 - (t["busy_s"] / t["items"]) / (ctx.window_s / len(ctx.records))
