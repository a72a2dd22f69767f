from benchmark.readers import idle_frac as read  # noqa: F401
