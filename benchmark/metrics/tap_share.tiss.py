from benchmark.spans import EPOCH, summary

TAPS = "tiss.taps"


def read(ctx):
    """Device time queued in the tap steps, ``tiss.taps``, over that queued
    in the epochs, ``family.epoch``, per item, stretch (a)."""
    s = summary(ctx)
    if not s or TAPS not in s["spans"] or EPOCH not in s["spans"]:
        return None
    epochs = s["spans"][EPOCH]["device_ms"]
    return s["spans"][TAPS]["device_ms"] / epochs if epochs > 0 else None
