from benchmark.spans import EPOCH, summary

SOURCES = "tiss.sources"


def read(ctx):
    """Device time queued in the source steps, ``tiss.sources``, over that
    queued in the epochs, ``family.epoch``, per item, stretch (a)."""
    s = summary(ctx)
    if not s or SOURCES not in s["spans"] or EPOCH not in s["spans"]:
        return None
    epochs = s["spans"][EPOCH]["device_ms"]
    return s["spans"][SOURCES]["device_ms"] / epochs if epochs > 0 else None
