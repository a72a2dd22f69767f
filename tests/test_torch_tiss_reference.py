"""PyTorch port: the benchmark's plain T-ISS reference
(``benchmark/reference/tiss.py``), and the port's clip path against it,
on the CPU.

Gates:
- the reference against the float64 oracle ``overiva_tpu_torch.oracle.tiss``
  (M=4, N=2, taps 2, delay 1, nfft 256, 3 epochs) at rtol 1e-10, both in
  float64;
- ``Separator("tiss")`` at complex128, one clip and a folded group of 3,
  against the reference's clip pipeline within 1e-9 of max|y| (the serving
  tests' complex128 gate), and the same group at complex64 within the tiny
  T-ISS cell's ``rel_err`` limit;
- importing the reference loads nothing of the program, the JAX package
  or JAX;
- the tap steps' byte floor at the ``tiss_batch`` cell's shapes;
- the tiny T-ISS cell through the harness: correct, with its per-layer
  metrics; the TF32 control fails its limit.
"""

import json
import subprocess
import sys

import numpy as np
import pytest

from benchmark import control, run
from benchmark.check import rel_err_cols
from benchmark.reference import tiss as ref
from benchmark.roofline_taps import tap_steps_bound, tap_steps_bytes
from benchmark.tests import tiny, tiny_cells
from benchmark.traffic.generate import make_mixture
from overiva_tpu_torch import oracle
from overiva_tpu_torch.serving import Separator

C128 = np.complex128
ARGS = {"algo": "tiss", "n_src": 2, "nfft": 256, "hop": 128, "n_iter": 3, "model": "laplace",
        "taps": 2, "delay": 1}
SCENE = {"n_src": 2, "room_dim": [8.0, 9.0, 3.0], "rt60": 0.2, "snr_db": 25.0,
         "mic_radius": 0.05, "src_distance": 2.5}
# the tiny T-ISS cell's limit (benchmark/tests/data/limits/tiny_tiss.json):
# its complex64 program read 1.07e-06 to 1.62e-06 and its TF32 control
# 1.25e-03 to 1.89e-03 over five seeds on the CPU
TINY_TISS_LIMIT = json.loads((tiny.DATA / "limits" / "tiny_tiss.json").read_text())["rel_err"]


def _rooms(seed, lengths, M=4):
    rng = np.random.default_rng(seed)
    return [make_mixture(rng, M, n, 16000, SCENE)[0] for n in lengths]


def _separator(dtype=None):
    kw = {k: v for k, v in ARGS.items() if k != "algo"}
    return Separator("tiss", device="cpu", dtype=dtype, **kw)


def test_reference_matches_oracle():
    (x,) = _rooms(1, [8000])
    X = oracle.analysis(oracle.stft_pad(x, 256, 128), 256, 128)
    want = oracle.tiss(X, n_src=2, taps=2, delay=1, n_iter=3)
    got = ref.tiss(X, 2, 2, 1, 3)
    assert got.dtype == C128 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


@pytest.fixture(scope="module")
def group():
    """Three rooms whose lengths share a bucket, so that they fold into
    one run."""
    return _rooms(2, [4000, 4400, 4800])


def test_separator_c128_matches_reference(group):
    sep = _separator(C128)
    outs = [sep.separate(group[0])] + sep.separate_batch(group)
    assert sep.stats["frames_padded"] > 0 and sep.n_buckets() == 1
    for y, x in zip(outs, [group[0], *group]):
        want = ref.separate_clip(x, ARGS)
        assert y.shape == want.shape
        np.testing.assert_allclose(y, want, rtol=0, atol=1e-9 * np.abs(want).max())


def test_separator_c64_within_the_tiny_limit(group):
    outs = _separator().separate_batch(group)
    for y, x in zip(outs, group):
        assert y.dtype == np.float32
        assert rel_err_cols(y, ref.separate_clip(x, ARGS)) <= TINY_TISS_LIMIT


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, benchmark.reference.tiss, benchmark.roofline_taps; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, check=True).stdout.split()
    assert "torch" in out
    assert not {"jax", "jaxlib", "overiva_tpu", "overiva_tpu_torch"} & set(out)


def test_tap_steps_bound_at_the_cell():
    """8 rooms of 513 bins folded, bucket 192, M=8, 5 taps: Z 252.1 MB, Y
    read and written 100.9 MB, P's tap block 10.5 MB, phi 49 kB."""
    T, BF, B, M, MK = 192, 8 * 513, 8, 8, 40
    assert tap_steps_bytes(T, BF, B, M, MK) == 363_565_056
    seconds, what = tap_steps_bound(T, BF, B, M, MK)
    assert what == "bytes" and round(seconds * 1e6, 1) == 108.5


@pytest.fixture
def root(tmp_path):
    return tiny_cells.write_bench(tmp_path, cells={**tiny.CELLS, **tiny_cells.MORE})


def _cell(root):
    return run.load_cell("tiny_tiss", root, (tiny.DATA, run.HERE))


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_tiss_cell_runs(root, trace):
    """Untraced: the end-to-end metrics. Traced: the six T-ISS metrics;
    the three read from the device trace find no device on the CPU."""
    res = tiny.run_tiny(root, "tiny_tiss", trace)
    assert res["correct"] is True, res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    got = res["metrics"]
    if not trace:
        assert set(got) == {"audio_s_per_s", "setup_s"}
        return
    names = {m["name"] for m in _cell(root).per_layer}
    assert names == {"epoch_ms.tiss", "launches_per_epoch.tiss", "idle_frac.tiss",
                     "tap_ms.tiss", "tap_share.tiss", "tap_hbm_frac.tiss"}
    assert set(got) == {"epoch_ms.tiss", "tap_ms.tiss", "launches_per_epoch.tiss"}
    assert 0 < got["tap_ms.tiss"]["value"] < got["epoch_ms.tiss"]["value"]
    assert got["launches_per_epoch.tiss"]["value"] == 0.0


def test_tiny_tiss_control_reads_not_correct(root):
    cell = _cell(root)
    r = control.readings(cell, 2**32 + 3, 1.0, "cpu")
    assert all(r["program"][k] <= lim for k, lim in cell.limits.items()), r
    assert not all(r["control"][k] <= lim for k, lim in cell.limits.items()), r
