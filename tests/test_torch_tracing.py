"""PyTorch port: the spans of the clip path (``utils/profiling.py``'s
``tracing`` and ``span``), on the CPU.

Gates:
- the span tree of one ``Separator.separate`` and of one
  ``separate_batch`` of three clips: names, nesting and order, one
  ``request`` a call, one ``family.start`` and ``n_iter`` numbered
  ``family.epoch`` spans, and the counts (bytes, frames, bins, matrices);
- the start and epochs of each family that ``run_family`` runs;
- T-ISS's start, its epochs (``taps``) and the ``tiss.taps`` span inside
  each (``steps``, ``bins``, ``frames``, ``outputs``), and its outputs bit
  for bit with tracing on and off;
- with tracing off nothing is recorded and no stage reaches a running
  profiler; the outputs are bit for bit the same with it on;
- each exported span agrees with its ``torch.profiler`` annotation within
  1 ms at both ends (the clock);
- ``Trace.table()``'s self wall, nested ``tracing`` blocks, and the stages
  in ``profile_trace``'s Chrome trace.
"""

import numpy as np
import pytest
import torch

from overiva_tpu_torch.models.family import run_family
from overiva_tpu_torch.serving import Separator
from overiva_tpu_torch.utils import profiling

N_ITER = 3
N_SRC = 2
M = 4
STAGES = (["serve.upload", "serve.analysis", "family.start"] + ["family.epoch"] * N_ITER
          + ["api.proj_back", "serve.synthesis", "serve.download"])
ROOTS = {"separate": "serve.separate", "separate_batch": "serve.separate_batch"}
PREFIXES = ("serve.", "family.", "api.")


@pytest.fixture(scope="module")
def sep():
    return Separator("overiva", n_src=N_SRC, init_eig=True, n_iter=N_ITER, device="cpu")


@pytest.fixture(scope="module")
def clips():
    rng = np.random.default_rng(17)
    return [rng.standard_normal((20000, M)).astype(np.float32) for _ in range(3)]


def _call(sep, clips, how):
    """(clips sent, outputs) of one ``how`` call."""
    if how == "separate":
        return clips[:1], [sep.separate(clips[0])]
    return clips, sep.separate_batch(clips)


@pytest.mark.parametrize("how", sorted(ROOTS))
def test_span_tree(sep, clips, how):
    before = dict(sep.stats)
    with profiling.tracing() as tr:
        sent, outs = _call(sep, clips, how)
    spans = tr.spans
    root = spans[0]
    assert root["name"] == ROOTS[how] and root["parent"] is None
    assert [s["id"] for s in spans] == list(range(len(spans)))
    assert {s["request"] for s in spans} == {root["request"]}
    children = spans[1:]
    assert [s["name"] for s in children] == STAGES
    assert all(s["parent"] == root["id"] for s in children)
    for s in spans:
        assert root["t0_ns"] <= s["t0_ns"] < s["t1_ns"] <= root["t1_ns"]
    for a, b in zip(children, children[1:]):
        assert a["t1_ns"] <= b["t0_ns"]
    by_name = {}
    for s in children:
        by_name.setdefault(s["name"], []).append(s["counts"])

    B = len(sent)
    F = sep.nfft // 2 + 1
    t_bucket = sep._prep_clip(sent[0].shape[0])[1]
    assert root["counts"] == {k: sep.stats[k] - before[k]
                              for k in ("clips", "frames_real", "frames_padded")}
    assert root["counts"]["clips"] == B
    assert by_name["serve.upload"] == [{"bytes": sum(x.nbytes for x in sent)}]
    assert by_name["serve.analysis"] == [{"frames": B * t_bucket, "bins": B * F}]
    assert by_name["family.start"] == [{"mats": B * F}]
    # kernel: whether the epoch ran the update_rows kernel (never on the CPU)
    assert by_name["family.epoch"] == [{"index": i, "bins": B * F, "kernel": 0}
                                       for i in range(N_ITER)]
    assert by_name["api.proj_back"] == [{"bins": B * F}]
    assert by_name["serve.synthesis"] == [{"frames": B * t_bucket}]
    # separate downloads the clip's span, separate_batch the group's whole
    # synthesized buckets
    n_synth = (t_bucket - 1) * sep.hop + sep.nfft
    want = outs[0].nbytes if how == "separate" else B * n_synth * N_SRC * outs[0].itemsize
    assert by_name["serve.download"] == [{"bytes": want}]


@pytest.mark.parametrize("algo, init_eig, mats", [
    ("ip", True, True), ("ip", False, False), ("ip2", True, True), ("iss", False, False),
])
def test_family_spans(algo, init_eig, mats):
    rng = np.random.default_rng(3)
    T, F = 24, 9
    X = torch.from_numpy((rng.standard_normal((T, F, M))
                          + 1j * rng.standard_normal((T, F, M))).astype(np.complex64))
    with profiling.tracing() as tr:
        run_family(X, N_SRC, N_ITER, "laplace", algo, init_eig=init_eig)
    assert [s["name"] for s in tr.spans] == ["family.start"] + ["family.epoch"] * N_ITER
    assert tr.spans[0]["counts"] == {"mats": F if mats else 0}
    # the IP epochs say whether they ran the update_rows kernel (never on the CPU)
    routed = {"kernel": 0} if algo == "ip" else {}
    assert [s["counts"] for s in tr.spans[1:]] == [{"index": i, "bins": F, **routed}
                                                   for i in range(N_ITER)]


def test_tracing_off_records_nothing(sep, clips):
    assert profiling._trace is None
    assert profiling.span("serve.x") is profiling.span("family.y", bins=3)
    with profiling.span("serve.x") as rec:
        assert rec is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sep.separate(clips[0])
        sep.separate_batch(clips)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert names and not [n for n in names if n.startswith(PREFIXES)]
    assert profiling._trace is None


@pytest.mark.parametrize("how", sorted(ROOTS))
def test_outputs_identical_with_tracing(sep, clips, how):
    _, off = _call(sep, clips, how)
    with profiling.tracing():
        _, on = _call(sep, clips, how)
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _clock_gaps(sep, clips):
    """Per span of one profiled ``separate`` and ``separate_batch``: the
    larger distance, at its two ends, between the exported record and the
    profiler's annotation of it."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.tracing() as tr:
            sep.separate(clips[0])
            sep.separate_batch(clips)
    annotated = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(PREFIXES):
            annotated.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    recorded = {}
    for s in tr.spans:
        recorded.setdefault(s["name"], []).append((s["t0_ns"], s["t1_ns"]))
    assert set(annotated) == set(recorded)
    gaps = []
    for name, ends in recorded.items():
        assert len(annotated[name]) == len(ends)
        gaps += [max(abs(a0 - r0), abs(a1 - r1))
                 for (a0, a1), (r0, r1) in zip(sorted(annotated[name]), sorted(ends))]
    return gaps


def test_spans_on_the_profiler_clock(sep, clips):
    """Every exported span lies within 1 ms of its profiler annotation at
    both ends. The two time stamps of an end are taken a few microseconds
    apart; a host that deschedules the thread between them (a loaded test
    machine does, for a time slice of a few ms) makes no clock error, so
    one of three profiled calls has to agree throughout. A clock that is
    not the profiler's is off by far more, in every call."""
    tries = [_clock_gaps(sep, clips) for _ in range(3)]
    assert min(max(gaps) for gaps in tries) < 1e6, [max(gaps) for gaps in tries]


def test_table_self_wall():
    with profiling.tracing() as tr:
        with profiling.span("outer", n=1):
            with profiling.span("inner", n=2):
                pass
            with profiling.span("inner", n=3):
                pass
        with profiling.span("outer", n=4):
            pass
    spans = tr.spans
    assert [(s["name"], s["parent"], s["request"]) for s in spans] == [
        ("outer", None, 0), ("inner", 0, 0), ("inner", 0, 0), ("outer", None, 1)]
    table = tr.table()
    wall = {name: sum(s["t1_ns"] - s["t0_ns"] for s in spans if s["name"] == name) / 1e6
            for name in ("outer", "inner")}
    assert table["inner"] == {"count": 2, "wall_ms": pytest.approx(wall["inner"]),
                              "self_ms": pytest.approx(wall["inner"]), "counts": {"n": 5}}
    assert table["outer"]["count"] == 2 and table["outer"]["counts"] == {"n": 5}
    assert table["outer"]["wall_ms"] == pytest.approx(wall["outer"])
    assert table["outer"]["self_ms"] == pytest.approx(wall["outer"] - wall["inner"])


def test_nested_tracing_blocks():
    with profiling.tracing() as outer:
        with profiling.span("a"):
            with profiling.tracing() as inner:
                with profiling.span("b"):
                    pass
            with profiling.span("c"):
                pass
    assert profiling._trace is None
    assert [s["name"] for s in inner.spans] == ["b"]
    assert [(s["name"], s["parent"]) for s in outer.spans] == [("a", None), ("c", 0)]


def test_profile_trace_holds_the_stages(sep, clips, tmp_path):
    with profiling.profile_trace(tmp_path):
        sep.separate(clips[0])
    text = (tmp_path / "trace.json").read_text()
    assert '"family.epoch"' in text and '"serve.separate"' in text
    assert profiling._trace is None


TISS_TAPS = 2  # taps a microphone: M x 2 tap steps an epoch


@pytest.fixture(scope="module")
def tiss_sep():
    return Separator("tiss", n_src=N_SRC, n_iter=N_ITER, taps=TISS_TAPS, delay=1, device="cpu")


@pytest.mark.parametrize("how", sorted(ROOTS))
def test_tiss_spans(tiss_sep, clips, how):
    """T-ISS's start (augmentation, augmented identity, first demix), its
    epochs and, inside each, its tap steps, with their counts."""
    with profiling.tracing() as tr:
        sent, _ = _call(tiss_sep, clips, how)
    spans = tr.spans
    assert [s["name"] for s in spans[1:]] == (
        ["serve.upload", "serve.analysis", "family.start"] + ["family.epoch", "tiss.taps"] * N_ITER
        + ["api.proj_back", "serve.synthesis", "serve.download"])
    B, F = len(sent), tiss_sep.nfft // 2 + 1
    T = tiss_sep._prep_clip(sent[0].shape[0])[1]
    start = spans[3]
    assert start["counts"] == {"mats": 0} and start["parent"] == spans[0]["id"]
    epochs = [s for s in spans if s["name"] == "family.epoch"]
    taps = [s for s in spans if s["name"] == "tiss.taps"]
    assert [s["counts"] for s in epochs] == [{"index": i, "bins": B * F, "taps": M * TISS_TAPS}
                                            for i in range(N_ITER)]
    assert [s["counts"] for s in taps] == [{"steps": M * TISS_TAPS, "bins": B * F, "frames": T,
                                            "outputs": M}] * N_ITER
    for e, t in zip(epochs, taps):
        assert t["parent"] == e["id"] and e["t0_ns"] <= t["t0_ns"] < t["t1_ns"] <= e["t1_ns"]


@pytest.mark.parametrize("how", sorted(ROOTS))
def test_tiss_outputs_identical_with_tracing(tiss_sep, clips, how):
    _, off = _call(tiss_sep, clips, how)
    with profiling.tracing():
        _, on = _call(tiss_sep, clips, how)
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and np.array_equal(a, b)
