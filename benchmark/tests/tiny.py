"""A benchmark of tiny cells for the CPU tests: the real BENCHMARK.json's
metrics, with its cells replaced by tiny ones on the tiny
configurations, mixes and limits under ``data/``."""

from __future__ import annotations

import json
import time
from pathlib import Path

from benchmark import run

DATA = Path(__file__).resolve().parent / "data"
CELLS = {  # tiny cell -> (the real cell it stands for, config, traffic)
    "tiny_batch": ("overiva_batch", "tiny_overiva", "tiny_batch"),
    "tiny_serve": ("overiva_serve", "tiny_overiva", "tiny_serve"),
}


def write_bench(root: Path, extra_configs=(), extra_cells=(), extra_per_layer=()) -> Path:
    """``root/BENCHMARK.json`` for the tiny cells, plus any extra entries."""
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    real = {v[0]: k for k, v in CELLS.items()}
    bench["configs"] = [
        {"name": c, "source": "tiny", "file": str(DATA / "configs" / f"{c}.json"),
         "reduced": [], "why": "tiny"} for c in ("tiny_overiva",)
    ] + list(extra_configs)
    bench["workloads"] = [
        {"name": k, "config": c, "traffic": t, "chips": 1, "why": "tiny"}
        for k, (_, c, t) in CELLS.items()
    ] + list(extra_cells)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [real[w] for w in m["workloads"]]
    bench["per_layer"] += list(extra_per_layer)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_tiny(root: Path, workload: str, trace: bool = False, seconds: float = 2.0,
             seed: int = 2**31 + 11, dirs=()) -> dict:
    cell = run.load_cell(workload, root, tuple(dirs) + (DATA, run.HERE))
    return run.run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter())
