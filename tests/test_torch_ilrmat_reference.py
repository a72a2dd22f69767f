"""PyTorch port: the benchmark's plain ILRMA-T reference
(``benchmark/reference/ilrma_t.py``), and the port's clip path against it,
on the CPU.

Gates:
- the reference against the float64 oracle ``overiva_tpu_torch.oracle.ilrma_t``
  (M=3, taps 2, delay 1, nfft 256, 3 epochs) at rtol 1e-10, both in
  float64;
- ``Separator("ilrma-t")`` on a group of three clip lengths that share a
  bucket, in two orders, against the reference's clip pipeline of each
  clip: within 1e-9 of max|y| at complex128 (the serving tests'
  complex128 gate), and within the tiny ILRMA-T cell's ``rel_err`` limit at
  complex64;
- planted faults read as a mismatch: the weights of a mixture in place of
  a bin's, and the clips' padding counted as frames;
- importing the reference loads nothing of the program, the JAX package
  or JAX, and leaves TF32 off;
- both steering kernels' byte floors at the ``ilrmat_batch`` cell's shapes;
- the tiny ILRMA-T cell through the harness: correct, with its per-layer
  metrics; the TF32 control fails its limit.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import control, run
from benchmark.check import rel_err_cols
from benchmark.reference import ilrma_t as ref
from benchmark.roofline_sources import source_steps_bound, source_steps_bytes
from benchmark.roofline_taps import tap_steps_bound, tap_steps_bytes
from benchmark.tests import tiny, tiny_cells
from benchmark.traffic.generate import make_mixture
from overiva_tpu_torch import oracle
from overiva_tpu_torch.models import ilrma_t as tilrma_t
from overiva_tpu_torch.serving import Separator

C128 = np.complex128
ARGS = {"algo": "ilrma-t", "n_src": 3, "nfft": 256, "hop": 128, "n_iter": 3,
        "n_components": 2, "taps": 2, "delay": 1}
SCENE = {"n_src": 3, "room_dim": [8.0, 9.0, 3.0], "rt60": 0.2, "snr_db": 25.0,
         "mic_radius": 0.05, "src_distance": 2.5}
# the tiny ILRMA-T cell's limit (benchmark/tests/data/limits/tiny_ilrmat.json):
# its complex64 program read 8.2e-07 to 1.30e-06 and its TF32 control
# 1.07e-03 to 1.66e-03 over five seeds on the CPU
TINY_LIMIT = json.loads((tiny.DATA / "limits" / "tiny_ilrmat.json").read_text())["rel_err"]
# the tiny cells with the tiny ILRMA-T cell beside tiny_cells.MORE's:
# tiny cell -> (the real cell it stands for, config, traffic)
TINY_CELLS = {**tiny.CELLS, **tiny_cells.MORE,
              "tiny_ilrmat": ("ilrmat_batch", "tiny_ilrmat", "tiny_tiss_batch")}
# three lengths in one bucket (33, 36 and 39 real frames, bucket 40)
LENGTHS = [4000, 4400, 4800]


def _rooms(seed, lengths, M=3):
    rng = np.random.default_rng(seed)
    return [make_mixture(rng, M, n, 16000, SCENE)[0] for n in lengths]


def _separator(dtype=None):
    kw = {k: v for k, v in ARGS.items() if k != "algo"}
    return Separator("ilrma-t", device="cpu", dtype=dtype, **kw)


def test_reference_matches_oracle():
    (x,) = _rooms(1, [8000])
    X = oracle.analysis(oracle.stft_pad(x, 256, 128), 256, 128)
    want = oracle.ilrma_t(X, taps=2, delay=1, n_iter=3, seed=0)
    got = ref.ilrma_t(X, 2, 1, 3)
    assert got.dtype == C128 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


@pytest.fixture(scope="module")
def group():
    return _rooms(2, LENGTHS)


@pytest.fixture(scope="module")
def wants(group):
    return [ref.separate_clip(x, ARGS) for x in group]


@pytest.mark.parametrize("order", [(0, 1, 2), (2, 0, 1)])
def test_separator_c128_matches_reference(group, wants, order):
    """A folded group of three padded clips equals each clip's own unpadded
    pipeline, whichever clips share it and in whichever order."""
    sep = _separator(C128)
    outs = sep.separate_batch([group[i] for i in order])
    assert sep.n_buckets() == 1 and sep.stats["frames_padded"] > 0
    for y, i in zip(outs, order):
        assert y.shape == wants[i].shape
        np.testing.assert_allclose(y, wants[i], rtol=0, atol=1e-9 * np.abs(wants[i]).max())


@pytest.mark.parametrize("order", [(0, 1, 2), (2, 0, 1)])
def test_separator_c64_within_the_tiny_limit(group, wants, order):
    outs = _separator().separate_batch([group[i] for i in order])
    for y, i in zip(outs, order):
        assert y.dtype == np.float32
        assert rel_err_cols(y, wants[i]) <= TINY_LIMIT


def _mixture_weights(steer):
    """``steer`` given each mixture's mean weights in place of each bin's."""
    def planted(Xt, P, Y, phi, n_chan, n_mix):
        T, BF, M = phi.shape
        F = ARGS["nfft"] // 2 + 1
        per_mix = phi.reshape(T, BF // F, F, M).mean(dim=2, keepdim=True)
        return steer(Xt, P, Y, per_mix.expand(T, BF // F, F, M).reshape(T, BF, M), n_chan,
                     n_mix)
    return planted


def _frames_ignored(iterations):
    """``iterations`` told that every frame is real."""
    def planted(*args, frames=None, **kw):
        return iterations(*args, **kw)
    return planted


@pytest.mark.parametrize("fault", ["mixture_weights", "frames_ignored"])
def test_planted_fault_reads_not_correct(group, wants, monkeypatch, fault):
    """A fault in what this configuration adds (the weights a bin, or the
    clips' real frames) is read as a mismatch, ten times the tiny limit or
    more (the frames fault reads 8.3e-03 here, the weights fault more)."""
    if fault == "mixture_weights":
        monkeypatch.setattr(tilrma_t, "steer", _mixture_weights(tilrma_t.steer))
    else:
        from overiva_tpu_torch.models import family

        monkeypatch.setattr(family, "ilrma_t_iterations",
                            _frames_ignored(family.ilrma_t_iterations))
    outs = _separator(C128).separate_batch(group)
    assert max(rel_err_cols(y, w) for y, w in zip(outs, wants)) > 10 * TINY_LIMIT


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, torch, benchmark.reference.ilrma_t; "
            "assert not torch.backends.cuda.matmul.allow_tf32; "
            "assert not torch.backends.cudnn.allow_tf32; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, check=True).stdout.split()
    assert "torch" in out
    assert not {"jax", "jaxlib", "overiva_tpu", "overiva_tpu_torch"} & set(out)


def test_steering_bounds_at_the_cell():
    """8 rooms of 513 bins folded, bucket 192, M=3, 5 taps, a weight a bin
    (phi's columns B = B*F = 4,104): the source steps read and write Y
    (37.8 MB) and the rows of width 18 (3.5 MB) and read phi (9.5 MB), 15.2
    us; the tap steps read Z (94.6 MB), Y and phi, and write P's tap block
    (1.5 MB), 42.8 us."""
    T, BF, M, MK = 192, 8 * 513, 3, 15
    assert source_steps_bytes(T, BF, BF, M, M + MK) == 37_822_464 + 3_545_856 + 9_455_616
    assert tap_steps_bytes(T, BF, BF, M, MK) == 94_556_160 + 37_822_464 + 9_455_616 + 1_477_440
    s_sources, what_s = source_steps_bound(T, BF, BF, M, M + MK)
    s_taps, what_t = tap_steps_bound(T, BF, BF, M, MK)
    assert what_s == what_t == "bytes"
    assert (round(s_sources * 1e6, 1), round(s_taps * 1e6, 1)) == (15.2, 42.8)


@pytest.fixture
def root(tmp_path):
    return tiny_cells.write_bench(tmp_path, cells=TINY_CELLS)


def _cell(root):
    return run.load_cell("tiny_ilrmat", root, (tiny.DATA, run.HERE))


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_ilrmat_cell_runs(root, trace):
    """Untraced: the end-to-end metrics. Traced: the seven ILRMA-T metrics;
    the five read from the device trace find no device on the CPU."""
    res = tiny.run_tiny(root, "tiny_ilrmat", trace, seconds=1.0)
    assert res["correct"] is True, res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    got = res["metrics"]
    if not trace:
        assert set(got) == {"audio_s_per_s", "setup_s"}
        return
    names = {m["name"] for m in _cell(root).per_layer}
    assert names == {"epoch_ms.ilrmat", "launches_per_epoch.ilrmat", "idle_frac.ilrmat",
                     "nmf_ms.ilrmat", "nmf_share.ilrmat", "source_hbm_frac.ilrmat",
                     "tap_hbm_frac.ilrmat"}
    assert set(got) == {"epoch_ms.ilrmat", "nmf_ms.ilrmat", "launches_per_epoch.ilrmat"}
    assert 0 < got["nmf_ms.ilrmat"]["value"] < got["epoch_ms.ilrmat"]["value"]
    assert got["launches_per_epoch.ilrmat"]["value"] == 0.0


def test_tiny_ilrmat_control_reads_not_correct(root):
    cell = _cell(root)
    r = control.readings(cell, 2**32 + 3, 1.0, "cpu")
    assert all(r["program"][k] <= lim for k, lim in cell.limits.items()), r
    assert not all(r["control"][k] <= lim for k, lim in cell.limits.items()), r


def test_group_start_is_each_clips_own():
    """A group's NMF start: each clip's activations drawn at its own real
    frames from the one seed, on the last frames of the bucket, zero on
    the padding before them; the basis the same draw's first."""
    from overiva_tpu_torch.api import _nmf_init

    B, H = _nmf_init([0, 0], 3, 5, 2, 12, torch.complex128, "cpu", frames=[12, 9])
    rng = np.random.default_rng(0)
    basis = rng.random((3, 5, 2)) + 0.1
    np.testing.assert_array_equal(B[1].numpy(), basis)
    np.testing.assert_array_equal(H[1, :, :, 3:].numpy(), rng.random((3, 2, 9)) + 0.1)
    assert not H[1, :, :, :3].any() and torch.equal(B[0], B[1])


def test_batch_with_frames_runs_each_clip_alone():
    """``ilrma_t_batch`` given ``frames`` and no ``seeds`` starts every
    element from ``seed``, so element b is ``ilrma_t(X[b], frames=...)``
    whatever its place in the batch."""
    from overiva_tpu_torch import api

    rng = np.random.default_rng(5)
    X = rng.standard_normal((2, 12, 5, 2)) + 1j * rng.standard_normal((2, 12, 5, 2))
    X[1, :3] = 0
    got = api.ilrma_t_batch(X, taps=1, delay=1, n_iter=2, seed=4, frames=[12, 9],
                             dtype=torch.complex128, device="cpu")
    for b, n in enumerate([12, 9]):
        want = api.ilrma_t(X[b], taps=1, delay=1, n_iter=2, seed=4, frames=n,
                           dtype=torch.complex128, device="cpu")
        np.testing.assert_allclose(got[b], want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("entry,frames", [
    ("ilrma_t", 0), ("ilrma_t", 13), ("batch", [12, 0]), ("batch", [13, 9]),
    ("batch", [12]),
])
def test_frames_out_of_range_is_refused(entry, frames):
    """A real frame count outside [1, T], or a batch's list of the wrong
    length, is refused before anything runs."""
    from overiva_tpu_torch import api

    X = np.zeros((2, 12, 5, 2), np.complex128)
    with pytest.raises(ValueError, match="frames"):
        if entry == "ilrma_t":
            api.ilrma_t(X[0], n_iter=1, frames=frames, device="cpu")
        else:
            api.ilrma_t_batch(X, n_iter=1, frames=frames, device="cpu")
