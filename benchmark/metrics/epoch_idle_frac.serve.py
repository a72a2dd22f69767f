from benchmark.spans import epoch_idle_frac as read  # noqa: F401
