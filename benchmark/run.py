"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

    python3 -m benchmark --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the system the configuration names, makes the cell's inputs
from the seed and warms every shape the traffic uses. The window then
drives the traffic's entry, item after item, for ``--seconds``. With
``--trace 1`` a stretch of ``trace_items`` more items follows under
``torch.profiler``, and the line carries the cell's per-layer metrics in
place of its end-to-end ones. Once the device's peak memory is read and
the program let go, the outputs kept from the run are compared with the
float64 reference and each compared number is printed beside its limit:
last on standard error, and last in the line under ``compared``.

Beside the keys the contract reads, the line carries ``window`` (items,
seconds, first, median and slowest item, and the median of each half of
the window), ``setup_parts`` (process start to the build, the system, the
inputs, the warm-up), ``trace_counts`` (launches by
name, device operations) with ``--trace 1``, and ``card`` (nvidia-smi's
name and power limit).

A run needs as many CUDA cards as its cell asks for, and fails (exit 2)
without them; it fails (exit 3) if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from .guard import forbidden_loaded
from .trace import ITEM_SPAN, summarize

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _find(dirs, *parts) -> Path:
    """The first of ``dirs`` that holds ``parts``."""
    for d in dirs:
        p = Path(d, *parts)
        if p.is_file():
            return p
    raise FileNotFoundError(f"{Path(*parts)} in none of {[str(d) for d in dirs]}")


def _module(path: Path):
    name = "benchmark_file_" + "".join(c if c.isalnum() else "_" for c in str(path))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str, root: Path = ROOT, dirs=(HERE,)) -> SimpleNamespace:
    """Everything one cell of ``root/BENCHMARK.json`` names: its entry in
    ``workloads``, its configuration, traffic mix and limits, and its
    end-to-end and per-layer metrics. Files are looked up in ``dirs`` in
    order."""
    bench = _json(Path(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return SimpleNamespace(
        name=workload, chips=int(w["chips"]), run_seconds=bench["run_seconds"],
        cfg=_json(Path(root, cfg_entry["file"])),
        traffic=_json(_find(dirs, "traffic", f"{w['traffic']}.json")),
        limits=_json(_find(dirs, "limits", f"{workload}.json")),
        end_to_end=e2e, per_layer=per_layer, dirs=tuple(dirs),
    )


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def _window(driver, seconds: float):
    """Items back to back until ``seconds`` have passed: (records,
    attempted, failed, window_s). An item that raises ends the window."""
    records, i, failed = [], 0, 0
    w0 = time.perf_counter()
    deadline = w0 + seconds
    while time.perf_counter() < deadline:
        i += 1
        try:
            records.append(driver.item(i - 1))
        except Exception:  # the run reports it as failed and judges what it has
            traceback.print_exc()
            failed += 1
            break
    end = records[-1]["t1"] if records else time.perf_counter()
    return records, i, failed, end - w0


def _median_ms(records):
    lat = sorted(r["t1"] - r["t0"] for r in records)
    return 1e3 * lat[len(lat) // 2] if lat else None


def _traced(driver, n_items: int, start: int, device: str):
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=acts) as prof:
        for j in range(n_items):
            with record_function(ITEM_SPAN):
                driver.item(start + j)
    _sync(device)
    return summarize(prof)


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.splitlines()[0] if out else "nvidia-smi gave nothing"


def build_driver(cell, seed: int, device: str):
    """The cell's system on ``device``, driven by its traffic's entry with
    the inputs of ``seed``, warmed up."""
    t0 = time.perf_counter()
    from overiva_tpu_torch import serving

    cfg, traffic = cell.cfg, cell.traffic
    system = getattr(serving, cfg["system"])(**cfg["args"], device=device)
    t1 = time.perf_counter()
    driver = _module(_find(cell.dirs, "entries", f"{traffic['entry']}.py")).Driver(
        system, cfg, traffic, np.random.default_rng(seed))
    t2 = time.perf_counter()
    driver.warmup()
    _sync(device)
    driver.setup_parts = {"system_s": t1 - t0, "inputs_s": t2 - t1,
                          "warmup_s": time.perf_counter() - t2}
    return driver


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float) -> dict:
    """One run of ``cell`` on ``device``: the result line as a dict, the
    ``compared`` key last."""
    import torch

    cfg, traffic = cell.cfg, cell.traffic
    t_build = time.perf_counter()
    driver = build_driver(cell, seed, device)
    c0 = driver.counters()
    setup_s = time.perf_counter() - t_start
    setup_parts = {"start_s": t_build - t_start, **driver.setup_parts}

    records, attempted, failed, window_s = _window(driver, seconds)
    c1 = driver.counters()
    summary = None
    if trace and not failed:
        summary = _traced(driver, int(traffic["trace_items"]), attempted, device)
    peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") else 0
    driver.release()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()

    ctx = SimpleNamespace(records=records, window_s=window_s, setup_s=setup_s,
                          counters={k: c1[k] - c0[k] for k in c1}, trace=summary,
                          cfg=cfg, traffic=traffic)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = _module(_find(cell.dirs, "metrics", f"{m['name']}.py")).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    compared = driver.check()
    correct = attempted > 0 and failed == 0 and all(
        bool(compared[k] <= lim) for k, lim in cell.limits.items())
    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.startswith("cuda") else "cpu",
            "kind": torch.cuda.get_device_name(0) if device.startswith("cuda") else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(peak),
        },
    }
    if summary is not None:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    lat = sorted(r["t1"] - r["t0"] for r in records)
    half = len(records) // 2
    result["window"] = {"items": len(records), "seconds": window_s,
                        "first_ms": 1e3 * (records[0]["t1"] - records[0]["t0"]) if records else None,
                        "median_ms": 1e3 * lat[len(lat) // 2] if lat else None,
                        "max_ms": 1e3 * lat[-1] if lat else None,
                        "halves_median_ms": [_median_ms(records[:half]), _median_ms(records[half:])]}
    result["setup_parts"] = setup_parts
    if summary is not None:
        result["trace_counts"] = {k: summary[k] for k in ("items", "launches", "launch_names",
                                                          "device_events")}
    result["compared"] = {k: {"value": compared[k], "limit": cell.limits[k]}
                          for k in cell.limits}
    return result


def _cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton-cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch-extensions")


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python3 -m benchmark", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = load_cell(args.workload)
    _cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    bad = forbidden_loaded()
    if bad:
        print(f"benchmark: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    result["card"] = _card()
    result["compared"] = result.pop("compared")
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
