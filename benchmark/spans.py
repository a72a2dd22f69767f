"""The program's own spans in a ``--trace 1`` run: what the epoch-loop
metrics read.

The program marks its stages with ``overiva_tpu_torch.utils.profiling``'s
spans (``serve.*``, ``api.*``, ``family.*``), which are off unless a
``tracing()`` block is open. The window and the harness's profiled stretch
run with them off. So the first of these metrics that a traced run reads
starts a fresh process (``python -m benchmark.spans``) that builds the
cell's system once more, from the same configuration, traffic and seed
(the window's rooms), warms it up as set-up does, and runs two stretches
with the spans on. A fresh one, because a profiled stretch leaves its
process slower: one room's untraced requests ran 1.1-1.6x slower after
three under ``torch.profiler``, with CPU activity alone too (NVIDIA H100
80GB HBM3 host).

- (b), first, without the profiler: ``2 * trace_items`` items with the
  spans on and off in turns. The items with them on give the spans'
  walls; ``tracing_on_ratio`` is the median item wall with the spans on
  over that with them off, as the host's speed drifts too much between
  the window and the stretch for a ratio to the window's items.
- (a) under ``torch.profiler``, as the harness's stretch runs, each item in
  a ``bench.item`` span. The program's spans appear in the trace as
  annotations on the trace's own clock. Each launch (as ``trace.py``
  counts them) goes to every span open at its host start, and to the
  innermost one alone in ``launches_by_stage`` (``outside`` where none is
  open), so those sum to the stretch's launches exactly. Device time of a
  span is the union of the intervals of the kernels and copies its
  launches queued, matched by correlation id. ``idle_by_span`` sums every
  idle gap of the device under the innermost span open as it began.
  ``span_clock_skew_us`` is the median distance between the starts of the
  program's span records and of their annotations.

A program without ``tracing`` (a commit before the spans) gives nothing,
and the metrics are left out of the line. The whole summary is written to
standard error as one line, ``spans {json}``: the result line has no room
for it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
from types import SimpleNamespace

from . import run
from .trace import _LAUNCH, _TOP, ITEM_SPAN, _host_at, _is_device, _union

EPOCH, START = "family.epoch", "family.start"
OUTSIDE = "outside"


def _run_seed() -> int:
    """This process's ``--seed`` (0 where the harness runs as a library, as
    its CPU tests run it)."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_known_args(sys.argv[1:])[0].seed


def _open_spans(spans, points):
    """(t, payload, names) for each (t, payload) of ``points`` in time
    order: the names of the ``spans`` ((start, end, name), nested) open at
    t, outermost first."""
    order = sorted(spans, key=lambda s: (s[0], -s[1]))
    stack, j = [], 0
    for t, payload in sorted(points, key=lambda p: p[0]):
        while j < len(order) and order[j][0] <= t:
            while stack and stack[-1][1] <= order[j][0]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        yield t, payload, [name for _, _, name in stack]


def _ms(ns) -> float:
    return ns / 1e6


def _profiled(prof, traced) -> dict:
    """Stretch (a): launches, device time and idle gaps by span."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    names = {s["name"] for s in traced.spans}
    items, spans, host, launches, device = [], [], [], [], {}
    for e in prof.profiler.kineto_results.events():
        s, name = e.start_ns(), e.name()
        end = s + e.duration_ns()
        if _is_device(e):
            # the device timeline's copies of the spans are no device work
            if end > s and name not in names:
                device.setdefault(e.correlation_id(), []).append((s, end))
        elif e.device_type() == cpu and name == ITEM_SPAN:
            items.append((s, end))
        elif e.device_type() == cpu and name in names:
            spans.append((s, end, name))
        else:
            host.append((s, end, name))
            if _LAUNCH.match(name):
                launches.append((s, e.correlation_id()))
    w0, w1 = min(s for s, _ in items), max(e for _, e in items)
    launches = [(s, c) for s, c in launches if w0 <= s <= w1]

    inclusive, by_stage, queued = {}, {}, {}
    for _, corr, open_names in _open_spans(spans, launches):
        stage = open_names[-1] if open_names else OUTSIDE
        by_stage[stage] = by_stage.get(stage, 0) + 1
        for name in set(open_names):
            inclusive[name] = inclusive.get(name, 0) + 1
            queued.setdefault(name, []).extend(device.get(corr, ()))

    busy = _union((max(s, w0), min(e, w1)) for ivs in device.values() for s, e in ivs
                  if e > w0 and s < w1)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1] - edges[i]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle, named = {}, []
    for g0, length, open_names in _open_spans(spans, gaps):
        where = open_names[-1] if open_names else OUTSIDE
        idle[where] = idle.get(where, 0) + length
        named.append((length, where, g0))
    top = [[where, _host_at(host, g0), length / 1e9]
           for length, where, g0 in sorted(named, reverse=True)[:_TOP]]

    annotated = {}
    for s, _, name in spans:
        annotated.setdefault(name, []).append(s)
    recorded = {}
    for rec in traced.spans:
        recorded.setdefault(rec["name"], []).append(rec["t0_ns"])
    skew = [abs(a - b) for name, starts in annotated.items()
            for a, b in zip(sorted(starts), sorted(recorded.get(name, ())))]

    counts = {name: sum(1 for *_, n in spans if n == name) for name in names}
    return {
        "items": len(items),
        "window_ns": w1 - w0,
        "busy_ns": sum(e - s for s, e in busy),
        "launches": len(launches),
        "counts": counts,
        "launches_in": inclusive,
        "launches_by_stage": by_stage,
        "device_ns": {name: sum(e - s for s, e in _union(ivs)) for name, ivs in queued.items()},
        "idle_by_span": {k: _ms(v) for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
        "idle_gaps": top,
        "span_clock_skew_us": statistics.median(skew) / 1e3 if skew else None,
    }


def _stretches(ctx):
    """The summary of both stretches, run in a fresh process (the module
    docstring says why), or None without the program's tracer."""
    try:
        from overiva_tpu_torch.utils.profiling import tracing  # noqa: F401
    except ImportError:
        return None
    import torch

    # the run drove CUDA if CUDA is initialised in this process
    device = "cuda" if torch.cuda.is_available() and torch.cuda.is_initialized() else "cpu"
    spec = {"cfg": ctx.cfg, "traffic": ctx.traffic, "seed": _run_seed(), "device": device}
    done = subprocess.run([sys.executable, "-m", "benchmark.spans", json.dumps(spec)],
                          cwd=run.ROOT, stdout=subprocess.PIPE, text=True, check=True)
    out = json.loads(done.stdout.strip().splitlines()[-1])
    window = [r["t1"] - r["t0"] for r in ctx.records]
    out["item_ms"]["window"] = 1e3 * statistics.median(window) if window else None
    print("spans " + json.dumps(out), file=sys.stderr, flush=True)
    return out


def measure(cfg: dict, traffic: dict, seed: int, device: str) -> dict:
    """Both stretches of one cell, in this process, as a dict."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from overiva_tpu_torch.utils.profiling import tracing

    cell = SimpleNamespace(cfg=cfg, traffic=traffic, dirs=(run.HERE,))
    driver = run.build_driver(cell, seed, device)
    n = int(traffic["trace_items"])
    # (b): 2n items with tracing on and off in turns, on first in every
    # other pair, so that the host's drift falls on both alike
    walls, timed = {True: [], False: []}, []
    for j in range(2 * n):
        on = j % 2 == j // 2 % 2
        with tracing() if on else contextlib.nullcontext() as tr:
            r = driver.item(j)
        walls[on].append(r["t1"] - r["t0"])
        if on:
            timed.append(tr)
    # (a)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    run._sync(device)
    with profile(activities=acts) as prof, tracing() as traced:
        for j in range(n):
            with record_function(ITEM_SPAN):
                driver.item(2 * n + j)
    run._sync(device)
    driver.release()

    a = _profiled(prof, traced)
    durations, rows = {}, {}
    for tr in timed:
        for rec in tr.spans:
            durations.setdefault(rec["name"], []).append(rec["t1_ns"] - rec["t0_ns"])
        for name, row in tr.table().items():
            acc = rows.setdefault(name, {"wall_ms": 0.0, "self_ms": 0.0, "count": 0})
            for k in acc:
                acc[k] += row[k]
    counts = traced.table()
    spans = {}
    for name, row in rows.items():
        spans[name] = {
            "per_item": row["count"] / n,
            "wall_ms": row["wall_ms"] / n,
            "self_ms": row["self_ms"] / n,
            "median_ms": _ms(statistics.median(durations[name])),
            "launches": a["launches_in"].get(name, 0) / a["items"],
            "device_ms": _ms(a["device_ns"].get(name, 0)) / a["items"],
            "counts": {k: v / a["items"] for k, v in counts[name]["counts"].items()},
        }
    item_ms = {"on": 1e3 * statistics.median(walls[True]),
               "off": 1e3 * statistics.median(walls[False])}
    out = {
        "items": n,
        "spans": spans,
        "item_ms": item_ms,
        "tracing_on_ratio": item_ms["on"] / item_ms["off"],
        "launches_per_item": a["launches"] / a["items"],
        "launches_by_stage": {k: v / a["items"] for k, v in a["launches_by_stage"].items()},
        "epochs_traced": a["counts"].get(EPOCH, 0),
        "epoch_launches": a["launches_in"].get(EPOCH, 0),
        "epoch_device_ms": _ms(a["device_ns"].get(EPOCH, 0)),
        "idle_by_span": a["idle_by_span"],
        "span_clock_skew_us": a["span_clock_skew_us"],
        "idle_gaps": a["idle_gaps"],
        "busy_ms_per_item": _ms(a["busy_ns"]) / a["items"],
        "window_ms_per_item": _ms(a["window_ns"]) / a["items"],
    }
    return out


def summary(ctx):
    """:func:`_stretches` of this run, run once and kept on ``ctx``."""
    if not hasattr(ctx, "program_spans"):
        ctx.program_spans = _stretches(ctx)
    return ctx.program_spans


def _median_ms(ctx, name):
    s = summary(ctx)
    return s["spans"][name]["median_ms"] if s and name in s["spans"] else None


def epoch_ms(ctx):
    """The median wall of one epoch, ``family.epoch``, stretch (b)."""
    return _median_ms(ctx, EPOCH)


def start_ms(ctx):
    """The median wall of the start, ``family.start``, stretch (b)."""
    return _median_ms(ctx, START)


def launches_per_epoch(ctx):
    """Launches whose host start lies in a ``family.epoch`` span over the
    epochs, stretch (a)."""
    s = summary(ctx)
    return s["epoch_launches"] / s["epochs_traced"] if s and s["epochs_traced"] else None


def epoch_idle_frac(ctx):
    """1 - the device time of the epochs' launches per epoch (stretch (a),
    profiled) over the median epoch wall (stretch (b), unprofiled): the
    profiler slows the host, as ``readers.idle_frac`` says."""
    s = summary(ctx)
    wall = epoch_ms(ctx)
    if not s or not s["epochs_traced"] or s["epoch_device_ms"] <= 0 or not wall:
        return None
    return 1.0 - (s["epoch_device_ms"] / s["epochs_traced"]) / wall


if __name__ == "__main__":
    print(json.dumps(measure(**json.loads(sys.argv[1]))), flush=True)
