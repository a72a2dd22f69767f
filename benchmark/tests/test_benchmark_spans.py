"""CPU tests of the epoch-loop metrics (``benchmark/spans.py``), at tiny
sizes (``tiny.py``)."""

from __future__ import annotations

import json
import types

import pytest
import torch

from benchmark import spans
from benchmark.tests.tiny import CELLS, DATA, run_tiny, write_bench
from overiva_tpu_torch.serving import Separator
from overiva_tpu_torch.utils import profiling

TINY = sorted(CELLS)
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "window", "setup_parts",
             "compared"}
SUMMARY_KEYS = {"spans", "idle_by_span", "span_clock_skew_us", "tracing_on_ratio",
                "launches_by_stage"}


@pytest.fixture
def root(tmp_path):
    return write_bench(tmp_path)


def _suffix(workload):
    return CELLS[workload][0].split("_")[-1]


def _summary_line(err: str):
    lines = [ln for ln in err.splitlines() if ln.startswith("spans ")]
    return json.loads(lines[-1][len("spans "):]) if lines else None


@pytest.fixture
def calls(monkeypatch):
    """Whether tracing was on at each call of the serving entries."""
    seen = []
    for name in ("separate", "separate_batch"):
        method = getattr(Separator, name)

        def wrapped(self, *a, _method=method, **k):
            seen.append(profiling._trace is not None)
            return _method(self, *a, **k)

        monkeypatch.setattr(Separator, name, wrapped)
    return seen


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", TINY)
def test_spans_only_in_their_own_process(root, capsys, calls, workload, trace):
    """The run's own process never turns tracing on: the window and the
    harness's profiled stretch run with it off, and the span stretches of
    a traced run run in a process of their own. An untraced run's line
    has the keys it had before the spans."""
    res = run_tiny(root, workload, trace)
    assert res["correct"] is True, res["compared"]
    assert calls and not any(calls)
    assert profiling._trace is None
    got = _summary_line(capsys.readouterr().err)
    if not trace:
        assert set(res) == LINE_KEYS
        assert got is None
        return
    assert set(res) == LINE_KEYS | {"breakdown", "trace_counts"}
    s = _suffix(workload)
    metrics = res["metrics"]
    assert {f"epoch_ms.{s}", f"start_ms.{s}", f"launches_per_epoch.{s}"} <= set(metrics)
    assert f"epoch_idle_frac.{s}" not in metrics  # no kernel on the CPU
    assert metrics[f"epoch_ms.{s}"]["value"] > 0 and metrics[f"start_ms.{s}"]["value"] > 0
    assert metrics[f"launches_per_epoch.{s}"]["value"] == 0.0
    assert SUMMARY_KEYS <= set(got)
    n_iter = 5  # tiny_overiva's
    n = json.loads((DATA / "traffic" / f"{CELLS[workload][2]}.json").read_text())["trace_items"]
    assert got["items"] == n
    assert got["spans"]["family.epoch"]["per_item"] == n_iter
    assert got["spans"]["family.start"]["per_item"] == 1
    assert 0 < got["tracing_on_ratio"] and got["span_clock_skew_us"] < 1000
    assert got["spans"]["serve.upload"]["counts"]["bytes"] > 0
    assert set(got["idle_by_span"]) == {spans.OUTSIDE}


def test_no_tracer_no_span_metric(root, monkeypatch, capsys):
    """A program without ``tracing`` (the commit before the spans) gives
    the traced line without the new metrics, and the run does not fail."""
    monkeypatch.delattr(profiling, "tracing")
    res = run_tiny(root, "tiny_serve", trace=True)
    assert res["correct"] is True
    assert not [m for m in res["metrics"] if m.split(".")[0] in
                ("epoch_ms", "start_ms", "launches_per_epoch", "epoch_idle_frac")]
    assert _summary_line(capsys.readouterr().err) is None


class _Event:
    """The part of a ``torch.profiler`` event that the readers call."""

    def __init__(self, name, start, end, kind="cpu_op", corr=0):
        self._name, self._s, self._e, self._kind, self._corr = name, start, end, kind, corr

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        kind = torch.autograd.DeviceType
        return kind.CUDA if self._kind == "kernel" else kind.CPU

    def activity_type(self):
        return self._kind

    def correlation_id(self):
        return self._corr


def test_launches_device_time_and_idle_by_span():
    """Launches go to every span open at their host start and to the
    innermost alone by stage; device time is the union of what they
    queued; each idle gap goes to the innermost span open as it began."""
    ms = 1_000_000
    annotated = [("serve.separate", 5, 95), ("family.epoch", 10, 40), ("family.epoch", 40, 70)]
    events = [_Event("bench.item", 0, 100 * ms, "user_annotation")]
    events += [_Event(n, s * ms, e * ms, "user_annotation") for n, s, e in annotated]
    events.append(_Event("family.epoch", 10 * ms, 40 * ms, "kernel", 99))  # its device copy
    for corr, (t, k0, k1) in enumerate([(12, 15, 25), (20, 22, 30), (45, 50, 60),
                                        (80, 85, 90), (98, 99, 100)], start=1):
        events.append(_Event("cudaLaunchKernel", t * ms, t * ms + 1000, "cuda_runtime", corr))
        events.append(_Event("gemm", k0 * ms, k1 * ms, "kernel", corr))
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    traced = types.SimpleNamespace(spans=[{"name": n, "t0_ns": s * ms + 3000}
                                          for n, s, _ in annotated])
    a = spans._profiled(prof, traced)
    assert a["items"] == 1 and a["launches"] == 5
    assert a["counts"] == {"serve.separate": 1, "family.epoch": 2}
    assert a["launches_in"] == {"serve.separate": 4, "family.epoch": 3}
    assert a["launches_by_stage"] == {"family.epoch": 3, "serve.separate": 1, spans.OUTSIDE: 1}
    assert sum(a["launches_by_stage"].values()) == a["launches"]
    assert a["device_ns"] == {"family.epoch": 25 * ms, "serve.separate": 30 * ms}
    assert a["idle_by_span"] == {"family.epoch": 45.0, spans.OUTSIDE: 15.0,
                                 "serve.separate": 9.0}
    assert a["span_clock_skew_us"] == 3.0
    assert a["busy_ns"] == 31 * ms and a["window_ns"] == 100 * ms
    assert [g[0] for g in a["idle_gaps"]] == ["family.epoch", "family.epoch",
                                              spans.OUTSIDE, "serve.separate"]
