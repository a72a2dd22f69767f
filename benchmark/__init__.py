"""The benchmark of ``overiva_tpu_torch`` on one NVIDIA H100.

    python3 -m benchmark --workload <name> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` once and prints one JSON line. The
harness is driven by data: a cell names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``), the
mix names the user entry that its window drives (``entries/<entry>.py``),
each metric is read by ``metrics/<name>.py`` and each cell's limits on the
output check sit in ``limits/<workload>.json``. A new cell, configuration
or metric is new files and new entries in ``BENCHMARK.json``.
"""
