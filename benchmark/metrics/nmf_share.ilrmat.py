from benchmark.spans import EPOCH, summary

NMF = "ilrma.nmf"


def read(ctx):
    """Device time queued in the NMF updates and weights, ``ilrma.nmf``,
    over that queued in the epochs, ``family.epoch``, per item, stretch
    (a)."""
    s = summary(ctx)
    if not s or NMF not in s["spans"] or EPOCH not in s["spans"]:
        return None
    epochs = s["spans"][EPOCH]["device_ms"]
    return s["spans"][NMF]["device_ms"] / epochs if epochs > 0 else None
