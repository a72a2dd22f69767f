"""Reading the profiler's trace of a traced stretch, in memory.

The stretch runs under ``torch.profiler`` with host and device activity;
each item sits in a ``bench.item`` span of the benchmark's own. Nothing is
written to disk. What comes out:

- ``window_s``: from the start of the first item's span to the end of the
  last, on the trace's clock;
- ``busy_s``: the union of the device's kernel, copy and set intervals
  inside the window;
- ``launches``: the host's CUDA runtime and driver calls that launch a
  kernel or a graph or queue a copy (``cudaLaunchKernel*``,
  ``cuLaunchKernel*``, ``cudaGraphLaunch``, ``cudaMemcpy*Async``), and
  their counts by name; ``device_events``, the device's operations;
- ``device_ops``: the device operations that took the most time, summed
  by name;
- ``idle_gaps``: the longest stretches with nothing running on the
  device, each named by the innermost host operation running as it began.
"""

from __future__ import annotations

import re

import torch

ITEM_SPAN = "bench.item"
_LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel|cudaGraphLaunch$|cudaMemcpy\w*Async)")
_TOP = 10


def _is_device(e) -> bool:
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    kind = str(e.activity_type()).lower() if hasattr(e, "activity_type") else ""
    return "annotation" not in kind and e.name() != ITEM_SPAN


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(prof) -> dict:
    """The summary of a finished ``torch.profiler.profile``."""
    events = prof.profiler.kineto_results.events()
    items, device, host = [], [], []
    for e in events:
        s = e.start_ns()
        end = s + e.duration_ns()
        name = e.name()
        if name == ITEM_SPAN and e.device_type() == torch.autograd.DeviceType.CPU:
            items.append((s, end))
        elif _is_device(e):
            if end > s:
                device.append((s, end, name))
        else:
            host.append((s, end, name))
    if not items:
        raise RuntimeError("the trace holds no item span")
    w0, w1 = min(s for s, _ in items), max(e for _, e in items)
    busy = _union((max(s, w0), min(e, w1)) for s, e, _ in device if e > w0 and s < w1)
    busy_ns = sum(e - s for s, e in busy)

    by_name: dict[str, int] = {}
    for s, e, name in device:
        if e > w0 and s < w1:
            by_name[name] = by_name.get(name, 0) + (e - s)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:_TOP]

    launch_names: dict[str, int] = {}
    for s, _, name in host:
        if w0 <= s <= w1 and _LAUNCH.match(name):
            launch_names[name] = launch_names.get(name, 0) + 1

    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:_TOP]
    named_gaps = [[_host_at(host, g0), length / 1e9] for length, g0 in gaps]

    return {
        "items": len(items),
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "launches": sum(launch_names.values()),
        "launch_names": launch_names,
        "device_events": sum(1 for s, e, _ in device if e > w0 and s < w1),
        "device_ops": [[name, ns / 1e9] for name, ns in top_ops],
        "idle_gaps": named_gaps,
    }


def _host_at(host, t) -> str:
    """The innermost host span running at ``t`` other than the item span
    (the item span when nothing else runs)."""
    best, best_len = ITEM_SPAN, None
    for s, e, name in host:
        if s <= t < e and name != ITEM_SPAN and (best_len is None or e - s < best_len):
            best, best_len = name, e - s
    return best
