"""The user entries a window drives, one module each, found by the
``entry`` of a traffic mix. Each defines ``Driver(system, cfg, traffic,
rng)`` with ``warmup()``, ``item(i)`` (one timed item: its record),
``counters()``, ``release()`` and ``check(control=None)``."""
