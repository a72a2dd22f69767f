"""The tiny benchmark of ``tiny.py`` once BENCHMARK.json's metrics name
cells that ``tiny.CELLS`` has no stand-in for, and the tiny T-ISS cell.

``tiny.write_bench`` maps every cell a metric lists to its tiny stand-in,
and fails on a cell without one. :func:`write_bench` here writes the same
file, leaving such cells out of the lists; ``conftest.py`` puts it in
``tiny``'s place for the harness's own tests. ``MORE`` holds the tiny
cells beyond ``tiny.CELLS``, which a caller passes as ``cells``.
"""

from __future__ import annotations

import json
from pathlib import Path

from benchmark import run
from benchmark.tests import tiny

MORE = {  # tiny cell -> (the real cell it stands for, config, traffic)
    "tiny_tiss": ("tiss_batch", "tiny_tiss", "tiny_tiss_batch"),
}


def write_bench(root: Path, extra_configs=(), extra_cells=(), extra_per_layer=(),
                cells=None) -> Path:
    """``root/BENCHMARK.json`` for the tiny ``cells`` (``tiny.CELLS`` by
    default), plus any extra entries."""
    cells = tiny.CELLS if cells is None else cells
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    real = {v[0]: k for k, v in cells.items()}
    bench["configs"] = [
        {"name": c, "source": "tiny", "file": str(tiny.DATA / "configs" / f"{c}.json"),
         "reduced": [], "why": "tiny"} for c in sorted({c for _, c, _ in cells.values()})
    ] + list(extra_configs)
    bench["workloads"] = [
        {"name": k, "config": c, "traffic": t, "chips": 1, "why": "tiny"}
        for k, (_, c, t) in cells.items()
    ] + list(extra_cells)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [real[w] for w in m["workloads"] if w in real]
    bench["per_layer"] += list(extra_per_layer)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
