"""The readings that a cell's limits are set from.

    python3 -m benchmark.control --workload <name> --seeds <n> [<n> ...] [--seconds 10]

For each seed: the cell's set-up and a short window at its own load, as a
run makes them, then the numbers that decide ``correct`` twice: for the
program's outputs (the lower reading) and for the control, the reference
computed in TF32 in the program's place (the upper reading). One JSON line
a seed. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import time

from .reference.arith import TF32
from .run import build_driver, load_cell


def readings(cell, seed: int, seconds: float, device: str) -> dict:
    """The program's and the control's readings of one seed."""
    driver = build_driver(cell, seed, device)
    i, t_end = 0, time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        driver.item(i)
        i += 1
    driver.release()
    t0 = time.perf_counter()
    program = driver.check()
    t1 = time.perf_counter()
    control = driver.check(control=TF32)
    return {"workload": cell.name, "seed": seed, "items": i, "program": program,
            "control": control, "limits": cell.limits, "check_s": t1 - t0,
            "control_s": time.perf_counter() - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.seconds, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
