"""PyTorch port: the simulation copies (``overiva_tpu_torch.sim``) against
``overiva_tpu.sim`` bit for bit, the native RIR engine's own build, and
the streaming CLI twin end to end on the CPU.

The copies are host NumPy code that makes the inputs; each is held with
``np.array_equal`` on seeded inputs: the layouts, ``speech_like``,
``load_wav_sources``, ``scale_to_snr``/``mix_premix``, ``inverse_sabine``,
the NumPy RIR path, the native RIR path (against the JAX package's native
build where it loads, else against its NumPy path at the 1e-12 of
tests/test_native_rir.py) and a whole ``ShoeBox.simulate``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile

import overiva_tpu.sim as jsim
from overiva_tpu.sim import _native as jnative
import overiva_tpu_torch.sim as tsim
from overiva_tpu_torch.sim import _native as tnative

REPO = Path(__file__).resolve().parents[1]
DIM, SRC, MIC, FS = [6.0, 5.0, 3.2], [2.1, 3.0, 1.6], [4.4, 2.2, 1.4], 16000


def test_exports_match():
    assert tsim.__all__ == jsim.__all__


def test_layouts_and_sources_bit_for_bit(tmp_path):
    for name, args in [
        ("semi_circle_layout", ([3.5, 3.0, 1.5], np.pi / 2, 2.2, 3)),
        ("semi_circle_layout", ([1.0, 2.0], 1.0, 0.5, 1, 0.3)),
        ("grid_layout", ([0.5, 0.5, 1.0], [4.0, 3.0, 2.0], 7)),
        ("grid_layout", ([0.5, 0.5], [4.0, 3.0], 5, 1.2)),
        ("circular_mic_array", ([3.5, 2.2, 1.5], 0.04, 6, 0.1)),
    ]:
        assert np.array_equal(getattr(tsim, name)(*args), getattr(jsim, name)(*args)), name
    assert np.array_equal(
        tsim.random_layout([0, 0, 0], [5, 4, 3], 6, np.random.default_rng(3), margin=0.5),
        jsim.random_layout([0, 0, 0], [5, 4, 3], 6, np.random.default_rng(3), margin=0.5))
    for seed in (0, 5):
        assert np.array_equal(tsim.speech_like(3000, 16000, seed=seed),
                              jsim.speech_like(3000, 16000, seed=seed))
    premix = np.random.default_rng(2).standard_normal((3, 2, 500))
    for kw in ({"snr_db": 10.0}, {"snr_db": 0.0, "ref_mic": 1, "n_targets": 1}):
        assert np.array_equal(tsim.scale_to_snr(premix, **kw), jsim.scale_to_snr(premix, **kw))
    assert np.array_equal(tsim.mix_premix(premix), jsim.mix_premix(premix))
    # the wav loader: int16 and float32 files, a resampled one, stereo
    s = jsim.speech_like(8000, 16000, seed=1)
    wavfile.write(tmp_path / "a.wav", 16000, (s * 0.3 * 32767).astype(np.int16))
    wavfile.write(tmp_path / "b.wav", 8000, (s[:4000] * 0.5).astype(np.float32))
    wavfile.write(tmp_path / "c.wav", 16000, (np.stack([s, 0.8 * s], 1) * 9000).astype(np.int16))
    for n_src in (2, 4):
        assert np.array_equal(tsim.load_wav_sources(tmp_path, n_src, 6000, seed=4),
                              jsim.load_wav_sources(tmp_path, n_src, 6000, seed=4))


@pytest.mark.parametrize("max_order", [0, 3, 10])
def test_numpy_rir_bit_for_bit(max_order):
    got = tsim.shoebox_rir(DIM, SRC, MIC, FS, 0.3, max_order, use_native=False)
    assert np.array_equal(got, jsim.shoebox_rir(DIM, SRC, MIC, FS, 0.3, max_order,
                                                use_native=False))
    assert tsim.inverse_sabine(0.3, DIM) == jsim.inverse_sabine(0.3, DIM)
    with pytest.raises(ValueError, match="strictly inside"):
        tsim.shoebox_rir(DIM, [9.0, 1.0, 1.0], MIC, FS, 0.3, 3, use_native=False)


def test_native_rir_matches_the_jax_package():
    """Where g++ builds the copy of rir.cpp: the same RIR as the JAX
    package's native engine (same source, same flags), into the port's
    own build directory; without a toolchain the NumPy path runs."""
    for order in (3, 12):
        got = tsim.shoebox_rir(DIM, SRC, MIC, FS, 0.3, order)
        if not tnative.native_available():
            assert np.array_equal(got, jsim.shoebox_rir(DIM, SRC, MIC, FS, 0.3, order,
                                                        use_native=False))
            continue
        if jnative.native_available():
            want = jsim.shoebox_rir(DIM, SRC, MIC, FS, 0.3, order, use_native=True)
            assert np.array_equal(got, want)
        else:  # the JAX package's build failed here: its NumPy path, its tolerance
            want = jsim.shoebox_rir(DIM, SRC, MIC, FS, 0.3, order, use_native=False)
            n = min(len(got), len(want))
            np.testing.assert_allclose(got[:n], want[:n], atol=1e-12)
    if tnative.native_available():
        # the port's own build, never the JAX package's build/librir.so
        assert tnative._BUILD == REPO / "build" / "overiva_tpu_torch"
        assert (tnative._BUILD / "librir.so").exists()
        with pytest.raises(ValueError, match="strictly inside"):
            tsim.shoebox_rir(DIM, [9.0, 1.0, 1.0], MIC, FS, 0.3, 3, use_native=True)


def test_native_build_is_rebuilt_for_another_host(tmp_path, monkeypatch):
    """A library whose sidecar names another source, flags or host is
    rebuilt, never loaded."""
    if not tnative.native_available():
        pytest.skip("no C++ toolchain: the NumPy path runs (tested above)")
    monkeypatch.setattr(tnative, "_BUILD", tmp_path)
    for stale in (None, "built-on-another-host"):
        monkeypatch.setattr(tnative, "_LIB", None)
        monkeypatch.setattr(tnative, "_TRIED", False)
        if stale is not None:
            # a new file, not the loaded one rewritten in place
            (tmp_path / "librir.so").unlink()
            (tmp_path / "librir.so").write_bytes(b"not a library")
            (tmp_path / "librir.so.sha256").write_text(stale)
        assert tnative.native_available()
        assert (tmp_path / "librir.so.sha256").read_text() == tnative._build_key()
    assert not list(tmp_path.glob("*.tmp"))


def test_room_simulation_bit_for_bit():
    """examples/streaming.py's room, short: the whole premix and noise."""
    def room(sim):
        r = sim.ShoeBox([7.0, 5.0, 3.0], fs=FS, rt60=0.15, seed=3)
        for k, pos in enumerate(sim.semi_circle_layout([3.5, 3.5, 1.5], np.pi / 2, 1.8, 2)):
            r.add_source(pos, sim.speech_like(2000, FS, seed=k))
        r.add_mic_array(sim.circular_mic_array([3.5, 2.2, 1.5], 0.04, 2))
        return r.simulate(return_premix=True, snr=25.0)

    for a, b in zip(room(tsim), room(jsim)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="rt60"):
        tsim.ShoeBox([7.0, 5.0, 3.0])


def test_streaming_cli_end_to_end():
    proc = subprocess.run(
        [sys.executable, "-m", "overiva_tpu_torch.examples.streaming", "--device", "cpu",
         "--duration", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "streaming 64 frames in blocks of 16" in proc.stdout
    assert "x realtime" in proc.stdout


@pytest.mark.parametrize("argv", [["--fused", "--tiss", "2", "--nfft", "512"],
                                  ["--wpe", "2", "--nfft", "512", "--block", "8"]])
def test_streaming_cli_modes(capsys, argv):
    from overiva_tpu_torch.examples import streaming

    streaming.main(["--device", "cpu", "--duration", "2", "--mics", "2", *argv])
    out = capsys.readouterr().out
    assert ("fused stream: online-tiss" in out) == ("--fused" in argv)
    assert "realtime" in out
    with pytest.raises(SystemExit):
        streaming.main(["--device", "cpu", "--wpe", "2", "--tiss", "2"])
