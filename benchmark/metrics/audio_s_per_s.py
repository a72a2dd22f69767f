def read(ctx):
    """Seconds of input audio completed in the window over the window's
    wall, from its start to the end of its last item."""
    return sum(r["audio_s"] for r in ctx.records) / ctx.window_s if ctx.records else None
