from benchmark.spans import start_ms as read  # noqa: F401
