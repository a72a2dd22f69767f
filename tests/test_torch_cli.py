"""PyTorch port: the CLI twins ``python -m overiva_tpu_torch.examples.oneshot``,
``.serving`` and ``.parity_check`` on the CPU (``--device cpu``), each in a
child process that fails if it imported JAX or the JAX package; the
oneshot report (convergence recorder, figures, wavs) in process.
"""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

# runs ``python -m <module> <args>`` and exits 97 if the run imported jax or
# anything of the JAX package
CHILD = """
import runpy, sys
module = sys.argv[1]
sys.argv = [module] + sys.argv[2:]
try:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
finally:
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "overiva_tpu"))
    if bad:
        print("imported", bad, file=sys.stderr)
        sys.exit(97)
"""


def _run(module, *args):
    return subprocess.run(
        [sys.executable, "-c", CHILD, f"overiva_tpu_torch.examples.{module}", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )


def test_oneshot_cli(tmp_path):
    proc = _run("oneshot", "--device", "cpu", "-a", "auxiva-iss", "-m", "2", "-s", "2",
                "--nfft", "128", "--duration", "1.0", "--n_iter", "5", "--save", str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert "SDR" in proc.stdout and "device: cpu" in proc.stdout
    assert (tmp_path / "sep_0.wav").exists() and (tmp_path / "mix.wav").exists()
    bad = _run("oneshot", "--device", "cpu", "-a", "not-an-algo")
    assert bad.returncode not in (0, 97), bad.stderr
    assert "invalid choice" in bad.stderr


@pytest.mark.parametrize("extra", [[], ["--pcm16", "--warmup"]])
def test_serving_cli(extra):
    proc = _run("serving", "--device", "cpu", "-m", "3", "-s", "2", "--nfft", "256",
                "--n-iter", "3", "--lengths", "1.0", "0.6", "0.9", *extra)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("-> bucket") == 3
    assert "served" in proc.stdout and "buckets" in proc.stdout
    assert ("warmup:" in proc.stdout) == bool(extra)


def test_parity_check_cli_quick():
    proc = _run("parity_check", "--quick", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PASS" in proc.stdout and "overiva M=5,N=2" in proc.stdout


def test_oneshot_report(tmp_path, capsys):
    """--report: the convergence recorder through the callback, both
    figures, the wavs and the HTML page (matplotlib imported only here)."""
    pytest.importorskip("matplotlib")
    from overiva_tpu_torch.examples import oneshot

    oneshot.main(["--device", "cpu", "-a", "overiva", "-m", "3", "-s", "2", "--nfft", "256",
                  "--duration", "1.0", "--n_iter", "4", "--report", str(tmp_path)])
    out = capsys.readouterr().out
    assert "listening report" in out
    for name in ("index.html", "convergence.png", "spectrogram.png", "sep_1.wav"):
        assert (tmp_path / name).exists(), name
