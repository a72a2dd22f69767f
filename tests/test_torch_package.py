"""PyTorch port: package boundary — no JAX import, lazy exports, device
resolution, state conversion, and a kernel build that fails loudly."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import overiva_tpu_torch
from overiva_tpu_torch import _build
from overiva_tpu_torch.ops import update_rows as tur
from overiva_tpu_torch.ops import wcov_packed as twp
from overiva_tpu_torch.utils.convert import state_to_numpy, state_to_torch

REPO = Path(__file__).resolve().parents[1]


def test_package_never_imports_jax():
    code = (
        "import sys\n"
        "import overiva_tpu_torch\n"
        "from overiva_tpu_torch import api, _build\n"
        "from overiva_tpu_torch.models import auxiva_iss, auxiva_pca, five, ogive\n"
        "from overiva_tpu_torch.models import overiva, overiva_ip2\n"
        "from overiva_tpu_torch.models import fastmnmf2, ilrma, sparseauxiva\n"
        "from overiva_tpu_torch.models import ilrma_t, tip, tiss\n"
        "from overiva_tpu_torch.models import online_iss, online_tiss, online_wpe\n"
        "from overiva_tpu_torch import serving, sim\n"
        "from overiva_tpu_torch.sim import _native, layouts, room, sources\n"
        "from overiva_tpu_torch.examples import streaming, oneshot, parity_check\n"
        "from overiva_tpu_torch.examples import serving as serving_cli\n"
        "from overiva_tpu_torch.utils import audio, profiling\n"
        "import overiva_tpu_torch.oracle.auxiva_pca\n"
        "assert overiva_tpu_torch.Separator is serving.Separator\n"
        "from overiva_tpu_torch.utils import checkpoint\n"
        "import overiva_tpu_torch.oracle.online_iss\n"
        "from overiva_tpu_torch.ops import covariance, linalg, projection, stft\n"
        "from overiva_tpu_torch.ops import update_rows, wcov_packed, wpe\n"
        "from overiva_tpu_torch import registry\n"
        "from overiva_tpu_torch.parallel import collectives, dryrun, launch, mesh, sharded\n"
        "from overiva_tpu_torch.examples import fastmnmf_stages\n"
        "from overiva_tpu_torch import entry, version\n"
        "assert overiva_tpu_torch.__version__ == version.__version__\n"
        "assert len(sharded.__all__) == 17\n"
        "from overiva_tpu_torch.utils import convert, threefry\n"
        "from overiva_tpu_torch import metrics, oracle\n"
        "from overiva_tpu_torch.metrics import bss_eval\n"
        "from overiva_tpu_torch.oracle import models, overiva, projection, stft\n"
        "from overiva_tpu_torch.oracle import auxiva_iss, five, ogive, overiva_ip2\n"
        "from overiva_tpu_torch.oracle import overiva_iss\n"
        "import overiva_tpu_torch.oracle.auxiva, overiva_tpu_torch.oracle.ilrma\n"
        "import overiva_tpu_torch.oracle.fastmnmf2, overiva_tpu_torch.oracle.sparseauxiva\n"
        "import overiva_tpu_torch.oracle.ilrma_t, overiva_tpu_torch.oracle.tip\n"
        "import overiva_tpu_torch.oracle.tiss, overiva_tpu_torch.oracle.wpe\n"
        "assert len(registry.ALGORITHMS) == 30\n"
        "assert overiva_tpu_torch.overiva is api.overiva\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "jax_pkg = sorted(m for m in sys.modules\n"
        "                 if m == 'overiva_tpu' or m.startswith('overiva_tpu.'))\n"
        "assert not jax_pkg, jax_pkg\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 0, proc.stderr


def test_lazy_exports_and_device_resolution(monkeypatch):
    from overiva_tpu_torch import api

    assert sorted(overiva_tpu_torch._API) == sorted(api.__all__)
    for name in api.__all__:
        assert getattr(overiva_tpu_torch, name) is getattr(api, name)
    from overiva_tpu_torch import serving

    for name in ("Separator", "SERVABLE", "bucket_frames"):
        assert name in overiva_tpu_torch.__all__
        assert getattr(overiva_tpu_torch, name) is getattr(serving, name)
    with pytest.raises(AttributeError):
        overiva_tpu_torch.not_a_function  # noqa: B018
    resolve = overiva_tpu_torch.resolve_device
    assert resolve("cpu").type == "cpu"
    assert resolve(None, torch.zeros(1)).type == "cpu"
    if torch.cuda.is_available():
        assert resolve().type == "cuda"
    # without a card there is no quiet CPU fallback: the caller must ask
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve(None, np.zeros(3))
    assert resolve("cpu", np.zeros(3)).type == "cpu"
    assert resolve(None, torch.zeros(1)).type == "cpu"  # a tensor runs where it lies


def test_numpy_input_needs_device_without_a_card(monkeypatch):
    """A NumPy input with no ``device`` raises on a host without CUDA, at
    every entry point; with ``device="cpu"`` it runs as before."""
    from overiva_tpu_torch import api
    from overiva_tpu_torch.serving import Separator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(3)
    X = (rng.standard_normal((16, 5, 3)) + 1j * rng.standard_normal((16, 5, 3))).astype(
        np.complex64
    )
    mix = rng.standard_normal((1024, 3))
    calls = {
        "overiva": lambda **kw: api.overiva(X, n_src=2, n_iter=2, **kw),
        "auxiva": lambda **kw: api.auxiva(X, n_iter=2, **kw),
        "pca": lambda **kw: api.pca(X, 2, **kw),
        "auxiva_pca": lambda **kw: api.auxiva_pca(X, n_src=2, n_iter=2, **kw),
        "overiva_batch": lambda **kw: api.overiva_batch(X[None], n_src=2, n_iter=2, **kw),
        "projection_back": lambda **kw: api.projection_back(X[:, :, :2], X[:, :, 0], **kw),
        "stft_analysis": lambda **kw: api.stft_analysis(mix, 256, **kw),
        "stft_analysis_batch": lambda **kw: api.stft_analysis_batch(mix[None], 256, **kw),
        "stft_synthesis": lambda **kw: api.stft_synthesis(X, 8, **kw),
        "stft_synthesis_batch": lambda **kw: api.stft_synthesis_batch(X[None], 8, **kw),
        "separate": lambda **kw: api.separate(mix, n_src=2, nfft=256, n_iter=2, **kw),
        "separate iss": lambda **kw: api.separate(mix, n_src=2, nfft=256, n_iter=2,
                                                  algo="iss", **kw),
        "separate ip2": lambda **kw: api.separate(mix, n_src=2, nfft=256, n_iter=2,
                                                  algo="ip2", **kw),
        "auxiva_iss": lambda **kw: api.auxiva_iss(X, n_iter=2, **kw),
        "overiva_iss": lambda **kw: api.overiva_iss(X, n_src=2, n_iter=2, **kw),
        "overiva_ip2": lambda **kw: api.overiva_ip2(X, n_src=2, n_iter=2, **kw),
        "auxiva_ip2": lambda **kw: api.auxiva_ip2(X, n_iter=2, **kw),
        "ogive": lambda **kw: api.ogive(X, n_iter=3, **kw),
        "five": lambda **kw: api.five(X, n_iter=2, **kw),
        "auxiva_iss_batch": lambda **kw: api.auxiva_iss_batch(X[None], n_iter=2, **kw),
        "overiva_iss_batch": lambda **kw: api.overiva_iss_batch(X[None], 2, n_iter=2, **kw),
        "overiva_ip2_batch": lambda **kw: api.overiva_ip2_batch(X[None], n_src=2, n_iter=2,
                                                                **kw),
        "ogive_batch": lambda **kw: api.ogive_batch(X[None], n_iter=3, **kw),
        "five_batch": lambda **kw: api.five_batch(X[None], n_iter=2, **kw),
        "auxiva_pca_batch": lambda **kw: api.auxiva_pca_batch(X[None], n_src=2, n_iter=2,
                                                              inner="iss", **kw),
        "ilrma": lambda **kw: api.ilrma(X, n_iter=2, **kw),
        "ilrma_batch": lambda **kw: api.ilrma_batch(X[None], n_iter=2, **kw),
        "fastmnmf2": lambda **kw: api.fastmnmf2(X, n_src=2, n_iter=2, **kw),
        "fastmnmf": lambda **kw: api.fastmnmf(X, n_src=2, n_iter=2, **kw),
        "fastmnmf2_batch": lambda **kw: api.fastmnmf2_batch(X[None], n_src=2, n_iter=2, **kw),
        "fastmnmf_batch": lambda **kw: api.fastmnmf_batch(X[None], n_iter=2, **kw),
        "sparseauxiva": lambda **kw: api.sparseauxiva(X[:, :, :2], n_iter=2, lasso_iter=5,
                                                      **kw),
        "sparseauxiva_batch": lambda **kw: api.sparseauxiva_batch(
            X[None, :, :, :2], n_bins=2, n_iter=2, lasso_iter=5, **kw),
        "separate fastmnmf": lambda **kw: api.separate(mix, n_src=2, nfft=256, n_iter=2,
                                                       algo="fastmnmf", **kw),
        "separate fastmnmf2": lambda **kw: api.separate(mix, n_src=2, nfft=256, n_iter=2,
                                                        algo="fastmnmf2", **kw),
        "wpe": lambda **kw: api.wpe(X, taps=2, delay=1, n_iter=1, **kw),
        "wpe_batch": lambda **kw: api.wpe_batch(X[None], taps=2, delay=1, n_iter=1, **kw),
        "tiss": lambda **kw: api.tiss(X, n_src=2, taps=1, delay=1, n_iter=2, **kw),
        "tip": lambda **kw: api.tip(X, n_src=2, taps=1, delay=1, n_iter=1, warm_iter=1, **kw),
        "ilrma_t": lambda **kw: api.ilrma_t(X, taps=1, delay=1, n_iter=2, **kw),
        "tiss_batch": lambda **kw: api.tiss_batch(X[None], n_src=2, taps=1, delay=1, n_iter=2,
                                                  **kw),
        "tip_batch": lambda **kw: api.tip_batch(X[None], n_src=2, taps=1, delay=1, n_iter=1,
                                                warm_iter=1, **kw),
        "ilrma_t_batch": lambda **kw: api.ilrma_t_batch(X[None], taps=1, delay=1, n_iter=2,
                                                        **kw),
        "separate tiss": lambda **kw: api.separate(mix, n_src=2, nfft=256, n_iter=2,
                                                   algo="tiss", **kw),
        "separate tip": lambda **kw: api.separate(mix, n_src=2, nfft=256, n_iter=1,
                                                  algo="tip", **kw),
        "separate ilrma_t": lambda **kw: api.separate(mix, n_src=2, nfft=256, n_iter=2,
                                                      algo="ilrma_t", **kw),
        "separate wpe": lambda **kw: api.separate(mix, n_src=2, nfft=256, n_iter=2,
                                                  wpe={"taps": 2}, **kw),
        "Separator": lambda **kw: Separator("overiva", n_src=2, nfft=256, n_iter=2,
                                            **kw).separate(mix),
        "Separator int16": lambda **kw: Separator(
            "five", nfft=256, n_iter=2, out_dtype=np.int16, **kw
        ).separate_batch([(mix[:900] * 1000).astype(np.int16), mix[:1000]])[1],
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
        out = call(device="cpu")
        assert all(isinstance(o, np.ndarray) and np.isfinite(o).all()
                   for o in (out if isinstance(out, tuple) else (out,))), name


def test_to_device(monkeypatch):
    """api.to_device: a complex tensor of the asked dtype on the asked
    device; a real input gains a zero imaginary part; a tensor stays where
    it lies; no card and no device raises."""
    from overiva_tpu_torch import api

    rng = np.random.default_rng(8)
    X = rng.standard_normal((6, 5, 3)) + 1j * rng.standard_normal((6, 5, 3))
    t = api.to_device(X, device="cpu")
    assert t.dtype == torch.complex64 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), X.astype(np.complex64))
    t = api.to_device(X, dtype=np.complex128, device="cpu")
    assert t.dtype == torch.complex128
    np.testing.assert_array_equal(t.numpy(), X)
    real = api.to_device(X.real, dtype="complex128", device="cpu")
    assert real.is_complex() and torch.equal(real.imag, torch.zeros_like(real.imag))
    np.testing.assert_array_equal(real.real.numpy(), X.real)
    assert api.to_device(t).dtype == torch.complex64  # a tensor input, default dtype
    assert api.to_device(X.real.astype(np.float32), device="cpu").dtype == torch.complex64
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        api.to_device(X)
    assert api.to_device(t).device.type == "cpu"


def test_profiling_helpers(tmp_path):
    """PhaseTimer keeps the JAX package's report; device_sync passes a CPU
    tensor or an array through; profile_trace writes a Chrome trace, and
    nothing without a directory."""
    from overiva_tpu_torch.utils import profiling

    timer = profiling.PhaseTimer()
    for _ in range(2):
        with timer("stft", sync_on=torch.ones(3)):
            pass
    with timer("iterate", sync_on=np.ones(3)):
        pass
    assert timer.counts == {"stft": 2, "iterate": 1}
    assert set(timer.as_dict()) == {"stft", "iterate"}
    assert timer.report().splitlines()[0].split(":")[0].strip() in ("stft", "iterate")
    with profiling.profile_trace(None):
        pass
    with profiling.profile_trace(tmp_path / "trace"):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_state_conversion_round_trip():
    rng = np.random.default_rng(0)
    state = {
        "W_hat": rng.standard_normal((5, 3, 3)) + 1j * rng.standard_normal((5, 3, 3)),
        "Cx": rng.standard_normal((5, 3, 3)).astype(np.complex64),
    }
    t = state_to_torch(state, "cpu", np.complex128)
    assert all(v.dtype == torch.complex128 for v in t.values())
    back = state_to_numpy(t)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k])
    t64 = state_to_torch(state, "cpu")  # default complex64
    assert t64["W_hat"].dtype == torch.complex64
    with pytest.raises(ValueError, match="dtype"):
        state_to_torch(state, "cpu", "int7")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No toolkit: a clear error, and the kernel path does not fall back to
    the plain version."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_ROOTS", (str(tmp_path),))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build_library()
        xr = torch.zeros((3, 2, 4), dtype=torch.bfloat16)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            twp._launch(xr, xr.clone(), torch.ones((4, 1)), 4)
        X = torch.zeros((4, 3, 2), dtype=torch.complex64)
        W = torch.zeros((3, 2, 2), dtype=torch.complex64)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tur._launch(torch.ones((4, 1)), X, W, W, 1)
    finally:
        _build.library.cache_clear()


def test_ptxas_summary():
    """One line per kernel of an ``-Xptxas -v`` log, template argument kept:
    the instances of a template (one a source count for ``wcov_tc_kernel``)
    are told apart."""
    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114wcov_tc_kernelILi3EEEv"
        "PK13__nv_bfloat16S3_PKfP6float2iiiifb' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_114wcov_tc_kernelILi3EEEv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 106 registers, used 1 barriers, 3072 bytes smem\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123update_rows_warp_"
        "kernelILi8EEEvPK6float2PKfS3_S3_PS1_iiib' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_123update_rows_warp_kernel\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 127 registers, used 1 barriers, 400 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z18wcov_packed_kernelPK13__nv_bfloat16' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z18wcov_packed_kernelPK13__nv_bfloat16\n"
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 40 registers, 392 bytes cmem[0]\n"
    )
    assert _build.ptxas_summary(log) == [
        "wcov_tc_kernel<3>: 106 registers, 0 B stack, 0 B spill stores, 0 B spill loads",
        "update_rows_warp_kernel<8>: 127 registers, 0 B stack, 0 B spill stores, "
        "0 B spill loads",
        "wcov_packed_kernel: 40 registers, 8 B stack, 4 B spill stores, 12 B spill loads",
    ]


def test_chip_smoke_bounds():
    """The least times ``chip_smoke.py`` reports beside each kernel, from
    the headline shapes and the benchmark cells' (one clip, and 8 rooms
    folded; the T-ISS group for ``tap_steps`` and ``iss_steps``, equal to
    the benchmark's own floors): all are bound by bytes. update_rows' covariances
    share x x^H across sources over the Hermitian triangle: 576 flops per
    frame and bin at M=8, N=3."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    ms, by = chip_smoke.update_rows_bound(8, 3, 2049, 128)
    assert by == "bytes" and 0.00594 < ms < 0.00596
    ms, by = chip_smoke.update_rows_bound(8, 3, 2049, 512)
    assert by == "bytes" and 0.02097 < ms < 0.02100
    # the benchmark's cells: one 56-frame clip, and a group of 8 rooms folded
    ms, by = chip_smoke.update_rows_bound(8, 3, 2049, 56)
    assert by == "bytes" and 0.00312 < ms < 0.00314
    ms, by = chip_smoke.update_rows_bound(8, 3, 8 * 2049, 56, 8)
    assert by == "bytes" and 0.02504 < ms < 0.02506
    ms, by = chip_smoke.wcov_bound(3, 2049, 8, 128)
    assert by == "bytes" and 0.0034 < ms < 0.0035
    # tap_steps at the tiss_batch cell: the benchmark's byte floor, 108.5 us
    from benchmark.roofline_taps import tap_steps_bound

    ms, by = chip_smoke.tap_steps_bound(192, 8 * 513, 8, 8, 40)
    assert by == "bytes" and ms == 1e3 * tap_steps_bound(192, 8 * 513, 8, 8, 40)[0]
    assert 0.1085 < ms < 0.1086
    # iss_steps at the tiss_batch cell: the benchmark's byte floor, 37.6 us
    from benchmark.roofline_sources import source_steps_bound

    ms, by = chip_smoke.iss_steps_bound(192, 8 * 513, 8, 8, 48)
    assert by == "bytes" and ms == 1e3 * source_steps_bound(192, 8 * 513, 8, 8, 48)[0]
    assert 0.0376 < ms < 0.0377


def test_chip_smoke_bin_weight_bounds():
    """Phase 3f's floors at the ``ilrmat_batch`` cell (T=192, 8 rooms of 513
    bins, M=3, 5 taps, a weight a bin): the benchmark's own, 15.2 us for
    the source steps and 42.8 us for the tap steps, both set by bytes."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    from benchmark.roofline_sources import source_steps_bound
    from benchmark.roofline_taps import tap_steps_bound

    BF = 8 * 513
    ms, by = chip_smoke.iss_steps_bound(192, BF, BF, 3, 18)
    assert by == "bytes" and ms == 1e3 * source_steps_bound(192, BF, BF, 3, 18)[0]
    assert 0.0151 < ms < 0.0152
    ms, by = chip_smoke.tap_steps_bound(192, BF, BF, 3, 15)
    assert by == "bytes" and ms == 1e3 * tap_steps_bound(192, BF, BF, 3, 15)[0]
    assert 0.0427 < ms < 0.0428


def test_chip_smoke_steps_launches():
    """The launches of (iss_steps, tap_steps) that ``chip_smoke.py`` asks of
    its ``separate`` calls and joint runs: one of each kernel an epoch that
    runs it (ISS: iss_steps alone; T-IP: its 10 warm T-ISS epochs; ILRMA-T:
    every epoch, as its steps are T-ISS's), none past 256 frames, under
    complex128 or without such epochs."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    for frames in (64, 128, 256):
        n = chip_smoke.samples_for_frames(frames)
        want = {algo: chip_smoke.separate_steps_want(algo, n, 30)
                for algo in ("iss", "tiss", "tip", "ip", "ilrma_t")}
        assert want == {"iss": (30, 0), "tiss": (30, 30), "tip": (10, 10), "ip": (0, 0),
                        "ilrma_t": (30, 30)}
    assert chip_smoke.separate_steps_want("iss", chip_smoke.samples_for_frames(257), 30) == (0, 0)
    assert chip_smoke.steps_want(126, 5, 3, 15) == (15, 15)
    assert chip_smoke.steps_want(512, 8, 5, 30) == (0, 0)
    assert chip_smoke.steps_want(128, 8, 5, 4, torch.complex128) == (0, 0)


def test_launch_validation():
    """The kernel wrapper refuses what the kernel does not take, before
    any build."""
    xr = torch.zeros((3, 2, 4), dtype=torch.bfloat16)
    phi = torch.ones((4, 1))
    with pytest.raises(ValueError, match="bfloat16"):
        twp._launch(xr.float(), xr.float(), phi, 4)
    with pytest.raises(ValueError, match="phi"):
        twp._launch(xr, xr, torch.ones((5, 1)), 4)
    big = torch.zeros((1, 33, 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="threads"):
        twp._launch(big, big, phi, 4)
    with pytest.raises(ValueError, match="contiguous"):
        twp._launch(xr.transpose(0, 1), xr.transpose(0, 1), torch.ones((4, 1)), 4)
    with pytest.raises(ValueError, match="n_frames"):
        twp._launch(xr, xr, phi, 0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        twp.wcov_packed((xr.to("meta"), xr.to("meta")), phi.to("meta"), 4)
