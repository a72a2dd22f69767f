"""``tiny.write_bench`` fails once BENCHMARK.json's metrics list cells that
have no tiny stand-in (``tiss_batch``, ``overiva_batch16``): the harness's
tests build their tiny benchmark with ``tiny_cells.write_bench``, which
writes the same file for the same cells."""

from benchmark.tests import tiny, tiny_cells

tiny.write_bench = tiny_cells.write_bench
