from benchmark.spans import launches_per_epoch as read  # noqa: F401
