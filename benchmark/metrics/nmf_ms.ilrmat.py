from benchmark.spans import summary

NMF = "ilrma.nmf"


def read(ctx):
    """The median wall of one epoch's NMF updates and weights, ``ilrma.nmf``,
    stretch (b)."""
    s = summary(ctx)
    return s["spans"][NMF]["median_ms"] if s and NMF in s["spans"] else None
