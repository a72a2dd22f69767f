from benchmark.roofline_taps import tap_steps_bound
from benchmark.spans import summary

TAPS = "tiss.taps"


def read(ctx):
    """The tap steps' byte floor (``roofline_taps.tap_steps_bound``, from
    the ``tiss.taps`` span's counts: frames, bins, outputs, steps; the
    folded mixtures are the traffic's group) over the device time queued
    in one ``tiss.taps`` span, stretch (a)."""
    s = summary(ctx)
    taps = s["spans"].get(TAPS) if s else None
    if not taps or taps["device_ms"] <= 0:
        return None
    per = taps["per_item"]  # spans an item
    c = {k: v / per for k, v in taps["counts"].items()}  # one span's counts
    bound_s, _ = tap_steps_bound(c["frames"], c["bins"], int(ctx.traffic.get("group", 1)),
                                 c["outputs"], c["steps"])
    return bound_s / (taps["device_ms"] / per / 1e3)
