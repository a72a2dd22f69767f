from benchmark.roofline_sources import source_steps_bound
from benchmark.spans import summary

SOURCES = "tiss.sources"


def read(ctx):
    """The source steps' byte floor (``roofline_sources.source_steps_bound``,
    from the ``tiss.sources`` span's counts: frames, bins, outputs, row
    width; ILRMA-T weighs every bin on its own, so phi has a column a bin)
    over the device time queued in one ``tiss.sources`` span, stretch (a)."""
    s = summary(ctx)
    sources = s["spans"].get(SOURCES) if s else None
    if not sources or sources["device_ms"] <= 0:
        return None
    per = sources["per_item"]  # spans an item
    c = {k: v / per for k, v in sources["counts"].items()}  # one span's counts
    bound_s, _ = source_steps_bound(c["frames"], c["bins"], c["bins"], c["outputs"], c["width"])
    return bound_s / (sources["device_ms"] / per / 1e3)
