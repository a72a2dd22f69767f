from benchmark.spans import epoch_ms as read  # noqa: F401
