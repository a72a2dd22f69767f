from benchmark.readers import launches_per_item as read  # noqa: F401
