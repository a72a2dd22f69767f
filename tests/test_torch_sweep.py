"""PyTorch port: the Monte-Carlo sweep twin
(``overiva_tpu_torch/examples/mbss_sim.py``) against the JAX sweep
(``bench/mbss_sim.py``, imported by path as tests/test_sweep_batch.py does)
on the CPU: the simulated rooms bit for bit, the per-instance scores of
both sweeps on one small config, batched against serial in the port,
resume-by-skip, the aggregate / compare tables, the CLI, and what the
sweep records or lets escape when an algorithm fails.

    python tests/test_torch_sweep.py [--rooms 2,1 3,2 3,3 5,3 8,2 8,3]

runs the demo config's rooms (``bench/waspaa_demo_config.json``, its first
seed) on the CPU through both packages: each arm's mean SDR / SIR in the
TPU snapshot ``data/waspaa_demo/``, the JAX sweep's ``one_instance`` against
it and the port's against the JAX sweep's, then OverIVA's f32, bf16 and
bf16pack tiers in both packages (a few minutes).
"""

import copy
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "bench"))

import mbss_sim as jsweep  # noqa: E402
from test_torch_cli import CHILD  # noqa: E402
from test_wav_sources import wav_dir  # noqa: E402,F401  (the wav fixture)

from overiva_tpu_torch import registry  # noqa: E402
from overiva_tpu_torch.examples import mbss_sim as tsweep  # noqa: E402

KEYS = ("sdr", "sir", "sdr_improvement", "sir_improvement")
# JAX sweep vs port sweep, both at batch=2 on the CPU. The complex128 arm
# runs on the complex64 STFT both packages take (and synthesises in
# complex64), so FFT rounding alone sets it: measured max 9.8e-07 dB (an
# N=1 SDR near 17 dB). The complex64 arms: measured max 4.3e-04 dB (five),
# gated at 10x that.
C128_TOL = 1e-6
C64_TOL = 10 * 4.3e-4
SERIAL_TOL = 2e-4  # batched vs serial, tests/test_sweep_batch.py's


def _small_cfg():
    cfg = copy.deepcopy(tsweep.DEFAULT_CONFIG)
    cfg.update(repeats=3, duration=1.5, nfft=256, n_mics=[2], n_srcs=[1, 2], seed=777)
    cfg["algos"] = {
        "overiva": {"n_iter": 6},
        "ilrma": {"n_iter": 4, "n_components": 2},
        "five": {"n_iter": 4},
        "overiva@c128": {"n_iter": 6, "dtype": "complex128"},
    }
    return cfg


def _records(out):
    return {f.name: json.loads(f.read_text()) for f in sorted(Path(out).glob("s*.json"))}


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """The small config through the JAX sweep (batch 2) and the port's
    (batch 2, and batch 1): 3 seeds x 2 cells, so cap 2 runs chunks [2, 1
    padded to 2] per cell."""
    root = tmp_path_factory.mktemp("sweeps")
    cfg = _small_cfg()
    jsweep.sweep(cfg, root / "jax", batch=2)
    tsweep.sweep(cfg, root / "port", batch=2, device="cpu")
    tsweep.sweep(cfg, root / "serial", batch=1, device="cpu")
    return root


def _room(mod, cfg, seed, M, N):
    return mod.simulate_instance(cfg, seed, M, N, 0.25, 25.0)


@pytest.mark.parametrize("seed,M,N", [(981238343, 2, 1), (1920203758, 5, 3), (7, 8, 2)])
def test_simulate_instance_bit_for_bit(seed, M, N):
    cfg = _small_cfg()
    (jm, jp), (tm, tp) = _room(jsweep, cfg, seed, M, N), _room(tsweep, cfg, seed, M, N)
    assert np.array_equal(jm, tm) and np.array_equal(jp, tp)
    assert tm.shape == (int(cfg["duration"] * cfg["fs"]), M) and tp.shape[0] == N


def test_simulate_instance_wav_sources_bit_for_bit(wav_dir):  # noqa: F811
    cfg = {"fs": 8000, "duration": 1.0, "room_dim": [6.0, 5.0, 3.0],
           "source_dir": str(wav_dir)}
    (jm, jp), (tm, tp) = _room(jsweep, cfg, 5, 2, 2), _room(tsweep, cfg, 5, 2, 2)
    assert np.array_equal(jm, tm) and np.array_equal(jp, tp)


def test_port_sweep_matches_jax(sweeps):
    jax_recs, port_recs = _records(sweeps / "jax"), _records(sweeps / "port")
    assert set(jax_recs) == set(port_recs) and len(jax_recs) == 6
    for name, jrec in jax_recs.items():
        prec = port_recs[name]
        assert {k: v for k, v in jrec.items() if k not in ("wall", "results")} == {
            k: v for k, v in prec.items() if k not in ("wall", "results")}
        assert set(jrec["results"]) == set(prec["results"])
        for algo, jres in jrec["results"].items():
            pres = prec["results"][algo]
            assert "error" not in jres and "error" not in pres, (name, algo, jres, pres)
            assert set(jres) == set(pres) and pres["batched"] == 2
            tol = C128_TOL if algo.endswith("@c128") else C64_TOL
            for key in KEYS:
                if key in jres:
                    np.testing.assert_allclose(pres[key], jres[key], rtol=0, atol=tol,
                                               err_msg=f"{name}/{algo}/{key}")


def test_batched_sweep_matches_serial(sweeps):
    serial, batched = _records(sweeps / "serial"), _records(sweeps / "port")
    assert set(serial) == set(batched) and serial
    for name, rec in serial.items():
        assert set(rec["results"]) == set(batched[name]["results"])
        for algo, res in rec["results"].items():
            bres = batched[name]["results"][algo]
            assert "error" not in res and "error" not in bres, (algo, res, bres)
            assert "batched" not in res
            for key in KEYS:
                if key in res:
                    np.testing.assert_allclose(res[key], bres[key], rtol=0, atol=SERIAL_TOL,
                                               err_msg=f"{name}/{algo}/{key}")


def test_resume_by_skip(sweeps, tmp_path):
    """A second run over a finished directory writes no instance file; a
    deleted one is run again, alone, and matches what it held."""
    out = tmp_path / "resume"
    shutil.copytree(sweeps / "port", out)
    before = {f.name: (f.stat().st_mtime_ns, f.read_text()) for f in out.glob("s*.json")}
    tsweep.sweep(_small_cfg(), out, batch=2, device="cpu")
    assert {f.name: (f.stat().st_mtime_ns, f.read_text()) for f in out.glob("s*.json")} == before
    victim = sorted(before)[0]
    (out / victim).unlink()
    tsweep.sweep(_small_cfg(), out, batch=2, device="cpu")
    after = {f.name: f.stat().st_mtime_ns for f in out.glob("s*.json")}
    assert set(after) == set(before)
    assert all(after[n] == before[n][0] for n in after if n != victim)
    old, new = json.loads(before[victim][1]), json.loads((out / victim).read_text())
    for algo, res in old["results"].items():
        np.testing.assert_allclose(new["results"][algo]["sdr"], res["sdr"], rtol=0,
                                   atol=SERIAL_TOL)


def _snapshot(tmp_path, name):
    """A copy of a stored JAX sweep directory (the tables are written into it)."""
    out = tmp_path / name
    out.mkdir()
    for f in (REPO / "data" / name).glob("s*.json"):
        shutil.copy(f, out)
    return out


def _both(fn_jax, fn_port, out_dir, csv_name, *args):
    """The table the JAX function writes, then the port's, from the same
    directories."""
    fn_jax(*args)
    jax_csv = (out_dir / csv_name).read_text()
    (out_dir / csv_name).unlink()
    fn_port(*args)
    return jax_csv, (out_dir / csv_name).read_text()


@pytest.mark.parametrize("which", ["jax", "port", "serial", "waspaa_full", "waspaa_demo"])
def test_aggregate_equals_jax(sweeps, tmp_path, which):
    out = sweeps / which if (sweeps / which).exists() else _snapshot(tmp_path, which)
    jax_csv, port_csv = _both(jsweep.aggregate, tsweep.aggregate, out, "summary.csv", out)
    assert port_csv == jax_csv
    assert port_csv.count("\n") > 3


@pytest.mark.parametrize("base,out", [("jax", "port"), ("serial", "port"),
                                      ("waspaa_rt04", "waspaa_rt04_wpe")])
def test_compare_equals_jax(sweeps, tmp_path, base, out):
    """compare.csv of one directory against a baseline: the JAX function
    reads a port directory (and the port a JAX one), the JSON schema being
    shared."""
    dirs = {}
    for name in (base, out):
        dirs[name] = tmp_path / name
        src = sweeps / name if (sweeps / name).exists() else REPO / "data" / name
        shutil.copytree(src, dirs[name], ignore=shutil.ignore_patterns("*.csv", "*.png", "*.md"))
    jax_csv, port_csv = _both(jsweep.compare, tsweep.compare, dirs[out], "compare.csv",
                              dirs[base], dirs[out])
    assert port_csv == jax_csv
    assert port_csv.count("\n") > 1


def test_plot_writes_the_figures(sweeps, tmp_path):
    pytest.importorskip("seaborn")
    out = tmp_path / "plot"
    shutil.copytree(sweeps / "port", out)
    tsweep.aggregate(out, plot=True)
    for name in ("sir_vs_mics.png", "sdr_improvement_vs_mics.png",
                 "sir_improvement_vs_mics.png", "runtime_vs_mics.png"):
        assert (out / name).stat().st_size > 0, name


def test_plot_needs_seaborn(sweeps, tmp_path, monkeypatch):
    out = tmp_path / "plot"
    shutil.copytree(sweeps / "port", out)
    monkeypatch.setitem(sys.modules, "seaborn", None)
    with pytest.raises(ImportError, match="seaborn"):
        tsweep.aggregate(out, plot=True)
    assert (out / "summary.csv").exists()


def _cli(*args, env=None):
    return subprocess.run(
        [sys.executable, "-c", CHILD, "overiva_tpu_torch.examples.mbss_sim", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env,
    )


def _tiny_cfg(path, algos):
    cfg = {"repeats": 1, "seed": 5, "duration": 1.0, "nfft": 256, "n_mics": [2],
           "n_srcs": [2], "algos": algos}
    path.write_text(json.dumps(cfg))
    return path


def test_cli_runs_jax_free(tmp_path):
    cfg = _tiny_cfg(tmp_path / "cfg.json", {"overiva": {"n_iter": 3}, "auxiva-iss": {"n_iter": 3}})
    out = tmp_path / "out"
    proc = _cli(str(cfg), "--out", str(out), "--device", "cpu", "--strict-timing")
    assert proc.returncode == 0, proc.stderr
    assert "device: cpu" in proc.stdout and "sweep complete: 1 new" in proc.stdout
    (rec,) = _records(out).values()
    assert set(rec["results"]) == {"overiva", "auxiva-iss"}
    assert json.loads((out / "config.json").read_text())["strict_timing"] is True
    agg = _cli("--aggregate", str(out))
    assert agg.returncode == 0, agg.stderr
    assert (out / "summary.csv").read_text().splitlines()[2].startswith("algo,n_mics,n_src")


def test_cli_without_card_or_device_raises(tmp_path):
    cfg = _tiny_cfg(tmp_path / "cfg.json", {"overiva": {"n_iter": 3}})
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = _cli(str(cfg), "--out", str(tmp_path / "out"), env=env)
    assert proc.returncode not in (0, 97), proc.stderr
    assert 'pass device="cpu"' in proc.stderr
    assert not (tmp_path / "out").exists()


def _raiser(exc):
    def run(X, **kw):
        raise exc

    return run


CUDA_FAULTS = [
    torch.AcceleratorError("CUDA error: an illegal memory access was encountered"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError("CUDA error: unspecified launch failure"),
]


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("exc", CUDA_FAULTS, ids=lambda e: type(e).__name__)
def test_cuda_error_ends_the_sweep(tmp_path, monkeypatch, batch, exc):
    """A CUDA error from a runner escapes ``sweep`` and no instance file
    is written."""
    run = _raiser(exc)
    monkeypatch.setitem(registry.ALGORITHMS, "boom",
                        registry.AlgorithmSpec("boom", run, batch=run))
    cfg = {**_small_cfg(), "repeats": 2, "n_srcs": [2],
           "algos": {"overiva": {"n_iter": 2}, "boom": {}}}
    with pytest.raises(type(exc), match="CUDA"):
        tsweep.sweep(cfg, tmp_path / "out", batch=batch, device="cpu")
    assert not list((tmp_path / "out").glob("s*.json"))


@pytest.mark.parametrize("batch", [1, 2])
def test_value_error_is_recorded(tmp_path, monkeypatch, batch):
    run = _raiser(ValueError("bad shape"))
    monkeypatch.setitem(registry.ALGORITHMS, "boom",
                        registry.AlgorithmSpec("boom", run, batch=run))
    cfg = {**_small_cfg(), "repeats": 2, "n_srcs": [2],
           "algos": {"overiva": {"n_iter": 2}, "boom": {}}}
    tsweep.sweep(cfg, tmp_path / "out", batch=batch, device="cpu")
    recs = _records(tmp_path / "out")
    assert len(recs) == 2
    for rec in recs.values():
        assert rec["results"]["boom"] == {"error": "ValueError: bad shape"}
        assert np.isfinite(rec["results"]["overiva"]["sdr"]).all()


def test_room_simulation_error_ends_the_sweep(tmp_path):
    """A room that cannot be built (here: no .wav in the source directory)
    raises out of ``sweep`` instead of leaving it waiting for the room."""
    (tmp_path / "wavs").mkdir()
    cfg = {**_small_cfg(), "repeats": 1, "n_srcs": [2], "source_dir": str(tmp_path / "wavs")}
    with pytest.raises(ValueError, match="no .wav files"):
        tsweep.sweep(cfg, tmp_path / "out", batch=1, device="cpu")


def _mean_scores(res):
    """(mean SDR, mean SIR) of a result dict; NaN where it has none."""
    def mean(key):
        v = [x for x in res.get(key, []) if np.isfinite(x)]
        return float(np.mean(v)) if v else float("nan")

    return mean("sdr"), mean("sir")


def demo_rooms(rooms):
    """The demo config's rooms of its first seed on the CPU (see the module
    docstring)."""
    from overiva_tpu import api as japi
    from overiva_tpu_torch import api as tapi

    cfg = {**jsweep.DEFAULT_CONFIG,
           **json.loads((REPO / "bench" / "waspaa_demo_config.json").read_text())}
    seed = int(np.random.SeedSequence(cfg["seed"]).generate_state(1)[0])
    nfft, hop = cfg["nfft"], cfg["nfft"] // 2
    for M, N in rooms:
        g = (seed, M, N, 0.25, 25.0)
        snap = json.loads((REPO / "data" / "waspaa_demo" / f"{jsweep.instance_key(*g)}.json")
                          .read_text())["results"]
        room = jsweep.simulate_instance(cfg, *g)
        rj = jsweep.one_instance(cfg, *g, simulated=room)
        rp = tsweep.one_instance(cfg, *g, simulated=room, device="cpu")
        print(f"room s{seed} M={M} N={N}: mean SDR / SIR (dB)")
        for algo in snap:
            (s0, i0), (s1, i1), (s2, i2) = (_mean_scores(r[algo]) for r in (snap, rj, rp))
            print(f"  {algo:16s} snapshot {s0:7.3f} / {i0:7.3f}   JAX - snapshot "
                  f"{s1 - s0:+.4f} / {i1 - i0:+.4f}   port - JAX {s2 - s1:+.4f} / {i2 - i1:+.4f}")
        if N < 2:
            continue
        ev = tsweep._InstanceEval(*room, N)
        xp = tsweep.stft_pad(room[0], nfft, hop)
        Xj, Xt = japi.stft_analysis(xp, nfft), tapi.stft_analysis(xp, nfft, device="cpu")
        sir = {}
        for wcov in ("f32", "bf16", "bf16pack"):
            kw = {"n_src": N, "n_iter": 20, "init_eig": True, "wcov": wcov}
            yj = japi.stft_synthesis(japi.overiva(Xj, **kw), nfft)[nfft - hop:][: len(room[0])]
            sir["JAX", wcov] = np.mean(ev.score_time(np.asarray(yj), 0)["sir"])
            Yt = torch.from_numpy(tapi.overiva(Xt, device="cpu", **kw))
            sir["port", wcov] = np.mean(ev.score(Yt, 0, nfft)["sir"])
        for pkg in ("JAX", "port"):
            print(f"  overiva 20 it, {pkg}: f32 SIR {sir[pkg, 'f32']:.4f}, bf16 - f32 "
                  f"{sir[pkg, 'bf16'] - sir[pkg, 'f32']:+.4f}, bf16pack - f32 "
                  f"{sir[pkg, 'bf16pack'] - sir[pkg, 'f32']:+.4f}")


if __name__ == "__main__":
    import argparse

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rooms", nargs="+", default=["2,1", "3,2", "3,3", "5,3", "8,2", "8,3"])
    demo_rooms([tuple(int(v) for v in r.split(",")) for r in p.parse_args().rooms])
