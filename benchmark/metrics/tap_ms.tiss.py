from benchmark.spans import summary

TAPS = "tiss.taps"


def read(ctx):
    """The median wall of one epoch's tap steps, ``tiss.taps``, stretch (b)."""
    s = summary(ctx)
    return s["spans"][TAPS]["median_ms"] if s and TAPS in s["spans"] else None
