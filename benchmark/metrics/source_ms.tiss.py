from benchmark.spans import summary

SOURCES = "tiss.sources"


def read(ctx):
    """The median wall of one epoch's source steps, ``tiss.sources``,
    stretch (b)."""
    s = summary(ctx)
    return s["spans"][SOURCES]["median_ms"] if s and SOURCES in s["spans"] else None
