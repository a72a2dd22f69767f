from benchmark.readers import pad_frac as read  # noqa: F401
