from benchmark.readers import latency_percentile_ms


def read(ctx):
    """The 90th percentile of every request's latency in the window."""
    return latency_percentile_ms(ctx, 90)
