"""CPU tests of the benchmark harness, at tiny sizes (``tiny.py``)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from benchmark import control, readers, roofline, run
from benchmark.guard import forbidden_loaded
from benchmark.reference.arith import tf32_round
from benchmark.tests.tiny import CELLS, DATA, run_tiny, write_bench

TINY = sorted(CELLS)


@pytest.fixture
def root(tmp_path):
    return write_bench(tmp_path)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", TINY)
def test_cell_runs_end_to_end(root, workload, trace):
    res = run_tiny(root, workload, trace)
    assert res["correct"] is True, res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "compared"
    assert set(res) >= {"correct", "attempted", "failed", "metrics", "device"}
    cell = run.load_cell(workload, root, (DATA, run.HERE))
    want = cell.per_layer if trace else cell.end_to_end
    names = {m["name"] for m in want}
    assert set(res["metrics"]) <= names
    if not trace:
        assert set(res["metrics"]) == names
        assert "setup_s" in res["metrics"]
    else:
        assert res["device"]["window_s"] > 0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(res)


@pytest.mark.parametrize("workload", TINY)
def test_control_reads_not_correct(root, workload):
    """The reference in TF32 in the program's place fails a limit; the
    program, in the same run, passes them all."""
    cell = run.load_cell(workload, root, (DATA, run.HERE))
    r = control.readings(cell, 2**32 + 3, 2.0, "cpu")
    assert all(r["program"][k] <= lim for k, lim in cell.limits.items()), r
    assert not all(r["control"][k] <= lim for k, lim in cell.limits.items()), r


def _unchanged_epochs(monkeypatch):
    import overiva_tpu_torch.models.family as family

    monkeypatch.setattr(family, "overiva_iterations", lambda X, W, *a, **k: W)


def _half_batch(monkeypatch):
    """Each group runs its first half; the rest get the mean of its outputs
    (the eigenvector start runs through the registry runner's path)."""
    from overiva_tpu_torch.serving import Separator

    run_host = Separator._separate_host

    def half(self, xb, t_pads, batch=True):
        keep = max(1, len(t_pads) // 2)
        ys = run_host(self, xb[:keep], t_pads[:keep], batch)
        rest = ys.mean(dim=0, keepdim=True).expand(len(t_pads) - keep, *ys.shape[1:])
        return torch.cat([ys, rest])

    monkeypatch.setattr(Separator, "_separate_host", half)


def _altered_answers(monkeypatch):
    import overiva_tpu_torch.serving as serving

    output = serving._output

    def altered(y, numpy_out):
        out = output(y, numpy_out)
        if not isinstance(out, np.ndarray):  # a tensor out: no user answer
            return out
        return out * (1.0 + 1e-2 * np.cos(np.arange(out.shape[-2]))[:, None]).astype(out.dtype)

    monkeypatch.setattr(serving, "_output", altered)


FAULTS = {
    "unchanged_state": {"tiny_batch": _unchanged_epochs, "tiny_serve": _unchanged_epochs},
    "half_batch": {"tiny_batch": _half_batch},
    "altered_answer": {w: _altered_answers for w in TINY},
}


@pytest.mark.parametrize("fault,workload",
                         [(f, w) for f, by in FAULTS.items() for w in sorted(by)])
def test_fault_reads_not_correct(root, monkeypatch, fault, workload):
    """A run with its timed path broken underneath comes out not correct
    (the cells run on one card: no exchange between chips to leave out)."""
    FAULTS[fault][workload](monkeypatch)
    res = run_tiny(root, workload)
    assert res["correct"] is False, res["compared"]


def test_guard_compares_whole_top_level_names():
    planted = {"jax.numpy": None, "overiva_tpu_torch.serving": None, "numpy": None,
               "jaxlib": None, "overiva_tpu.api": None, "flax_like": None}
    assert forbidden_loaded(planted) == ["jax.numpy", "jaxlib", "overiva_tpu.api"]


def test_guard_catches_a_planted_import(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert "jax" in forbidden_loaded()


def test_reference_loads_nothing_of_the_program():
    code = (
        "import sys, benchmark.reference.overiva, "
        "benchmark.traffic.generate, benchmark.roofline, benchmark.check; "
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, check=True).stdout.split()
    assert not {"jax", "jaxlib", "flax", "overiva_tpu", "overiva_tpu_torch", "torch"} & set(out)


def test_no_card_no_result(capsys):
    """Without the cards its cell asks for, a run fails and prints nothing
    on standard output (run on a card, it would measure: skipped there)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rc = run.main(["--workload", "overiva_serve", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_fails_without_the_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's own
    files gives no result."""
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "benchmark", "--workload", "overiva_serve",
                        "--seed", "1", "--seconds", "1"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_new_files_are_found_without_edits(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files run without any existing file being edited."""
    extra = tmp_path / "extra"
    for d in ("configs", "traffic", "metrics", "limits"):
        (extra / d).mkdir(parents=True)
    cfg = json.loads((DATA / "configs" / "tiny_overiva.json").read_text())
    cfg.update(name="tiny_overiva_n3", args={**cfg["args"], "n_src": 3, "n_iter": 3})
    (extra / "configs" / "tiny_overiva_n3.json").write_text(json.dumps(cfg))
    mix = json.loads((DATA / "traffic" / "tiny_batch.json").read_text())
    mix.update(group=3, pool_groups=1)
    (extra / "traffic" / "tiny_batch3.json").write_text(json.dumps(mix))
    (extra / "metrics" / "clips_per_batch.new.py").write_text(
        "def read(ctx):\n    return ctx.counters['clips'] / len(ctx.records)\n")
    (extra / "limits" / "tiny_new.json").write_text('{"rel_err": 1e-3}')
    root = write_bench(
        tmp_path,
        extra_configs=[{"name": "tiny_overiva_n3", "source": "tiny",
                        "file": str(extra / "configs" / "tiny_overiva_n3.json"),
                        "reduced": [], "why": "tiny"}],
        extra_cells=[{"name": "tiny_new", "config": "tiny_overiva_n3",
                      "traffic": "tiny_batch3", "chips": 1, "why": "tiny"}],
        extra_per_layer=[{"name": "clips_per_batch.new", "unit": "clips", "better": "higher",
                          "source": "program_counter", "layer": "serving tier",
                          "moves": "audio_s_per_s", "workloads": ["tiny_new"]}],
    )
    res = run_tiny(root, "tiny_new", trace=True, dirs=(extra,))
    assert res["correct"] is True, res["compared"]
    assert res["metrics"]["clips_per_batch.new"]["value"] == 3.0


def test_roofline_reproduces_the_kernel_bounds():
    """chip_smoke.py's bounds at the headline, T=128: 3.45 us and 5.95 us."""
    t, what = roofline.wcov_bound(3, 2049, 8, 128)
    assert round(t * 1e6, 2) == 3.45 and what == "bytes"
    t, what = roofline.update_rows_bound(8, 3, 2049, 128)
    assert round(t * 1e6, 2) == 5.95 and what == "bytes"


def test_idle_frac_divides_by_the_untraced_wall():
    """The traced stretch gives the busy time per item; the untraced window
    gives the wall per item."""
    ctx = types.SimpleNamespace(trace={"busy_s": 0.3, "items": 3, "window_s": 3.0},
                                records=[{}] * 10, window_s=4.0)
    assert readers.idle_frac(ctx) == pytest.approx(1.0 - 0.1 / 0.4)


def test_tf32_rounding():
    x = np.array([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-10), 3.0], np.float32)
    assert tf32_round(x).tolist() == [1.0, 1.0, 1.0 + 2**-9, -(1.0 + 2**-10), 3.0]
    z = (x + 1j * x[::-1]).astype(np.complex64)
    np.testing.assert_array_equal(tf32_round(z), tf32_round(x) + 1j * tf32_round(x[::-1]))
