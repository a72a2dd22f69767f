"""Monte-Carlo room-simulation sweep on the port: the twin of
``bench/mbss_sim.py``, with the same flags plus ``--device`` (default
CUDA; ``--device cpu`` runs on the CPU):

    python -m overiva_tpu_torch.examples.mbss_sim bench/waspaa_demo_config.json --out DIR
    python -m overiva_tpu_torch.examples.mbss_sim CONFIG --out DIR --batch 1 --device cpu
    python -m overiva_tpu_torch.examples.mbss_sim --aggregate DIR [--compare BASEDIR] [--plot]

A JSON config names the cross product of (seed, n_mics, n_src, rt60, snr,
algo); each room instance writes one result JSON, and a sweep that is run
again skips the instances whose JSON exists. File names, the record schema
and the ``summary.csv`` / ``compare.csv`` tables are the JAX sweep's, so
a directory written by either package resumes, aggregates and pairs under
``--compare`` with the other's.

Rooms are simulated and scored (bss_eval) on the host, by the port's own
copies (``overiva_tpu_torch.sim``, ``overiva_tpu_torch.metrics``); each
algorithm runs through the port's registry on the torch device. A
same-shape group of instances is uploaded once, as one batch of samples
whose STFT is taken on the device, and each algorithm runs once over the
group (``AlgorithmSpec.run_batch``); scoring runs on a thread pool while
the next algorithm runs on the device.

An algorithm's ``ValueError``, ``TypeError`` or non-finite output is
recorded in the instance's JSON as ``{"error": ...}``, as in the JAX
sweep. A CUDA error (out of memory, a failed launch, any ``RuntimeError``
naming CUDA) ends the sweep: a poisoned CUDA context would fail every
later call, and no work moves to the CPU. The tables are computed with
NumPy (the machine with the card has no pandas), summed as pandas sums,
so that they equal the JAX sweep's.
"""

from __future__ import annotations

import argparse
import csv
import inspect
import itertools
import json
import math
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as _fwait
from pathlib import Path

import numpy as np
import torch

from overiva_tpu_torch import api, resolve_device
from overiva_tpu_torch.metrics import BssEvalReferences
from overiva_tpu_torch.oracle import stft_pad
from overiva_tpu_torch.registry import applicable, get_algorithm
from overiva_tpu_torch.sim import (
    ShoeBox,
    circular_mic_array,
    load_wav_sources,
    semi_circle_layout,
    speech_like,
)
from overiva_tpu_torch.utils.profiling import device_sync

DEFAULT_CONFIG = {
    "repeats": 3,
    "seed": 12345,
    "fs": 16000,
    "duration": 5.0,
    "nfft": 4096,
    "room_dim": [8.0, 9.0, 3.0],
    "rt60": [0.25],
    "snr": [25.0],
    "n_mics": [2, 3, 5, 8],
    "n_srcs": [1, 2, 3],
    "algos": {
        "auxiva": {"n_iter": 20},
        "auxiva-gauss": {"n_iter": 20},
        "auxiva-iss": {"n_iter": 20},
        "overiva": {"n_iter": 20},
        "overiva-gauss": {"n_iter": 20},
        "overiva-iss": {"n_iter": 20},
        "overiva-ip2": {"n_iter": 10},
        "auxiva_pca": {"n_iter": 20},
        "ilrma": {"n_iter": 30, "n_components": 2},
        "ogive": {"n_iter": 2000, "step_size": 0.05, "tol": 1e-3},
    },
}

# markers of a CUDA failure in a RuntimeError's message (lower case)
_CUDA_MARKERS = ("cuda", "launch failure", "cublas", "cusolver", "cufft")


def _algo_key(name: str) -> str:
    """Registry name for a sweep-config key: ``"tip-gauss@taps3"`` resolves
    the algorithm ``tip-gauss`` while keeping the full key as the result
    column — matched-arm A/B sweeps of one algorithm under different
    kwargs in a single config."""
    return name.split("@", 1)[0]


def _reraise_if_device_fault(e: Exception):
    """Let a CUDA error escape the per-algorithm and per-lane capture: the
    context it leaves fails every later call, so it ends the sweep instead
    of becoming a column of ``"error"`` entries."""
    if isinstance(e, (torch.cuda.OutOfMemoryError, torch.AcceleratorError)):
        raise e
    if isinstance(e, RuntimeError) and any(m in str(e).lower() for m in _CUDA_MARKERS):
        raise e


def _upload(x, device):
    """Host samples as a float32 tensor on ``device``, in one copy; the
    STFT is then taken there and every result stays there."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)


def run_algo(name: str, X, n_src: int, params: dict, device=None):
    if not applicable(_algo_key(name), n_src, X.shape[2]):
        return None
    return get_algorithm(_algo_key(name))(X, n_src=n_src, device=device, **params)


def simulate_instance(cfg: dict, seed: int, n_mics: int, n_src: int, rt60: float, snr: float):
    """Host-side: build + simulate one room. Returns (mix, premix)."""
    fs = cfg["fs"]
    n = int(cfg["duration"] * fs)
    rng = np.random.default_rng(seed)

    room = ShoeBox(cfg["room_dim"], fs=fs, rt60=rt60, seed=seed)
    center = np.asarray(cfg["room_dim"]) / 2
    # sources on an arc AROUND the mic array: equidistant, random orientation
    src_pos = semi_circle_layout(
        [center[0], center[1], 1.5], np.pi / 2, 2.5, n_src,
        rot=rng.uniform(-np.pi, np.pi),
    )
    # clamp inside the room
    src_pos = np.clip(src_pos, 0.3, np.asarray(cfg["room_dim"]) - 0.3)
    # real speech when the config points at a wav directory; synthetic otherwise
    if cfg.get("source_dir"):
        signals = load_wav_sources(cfg["source_dir"], n_src, n, fs, seed=seed)
    else:
        signals = np.stack(
            [speech_like(n, fs, seed=seed * 1009 + k) for k in range(n_src)]
        )
    for k in range(n_src):
        room.add_source(src_pos[k], signals[k])
    room.add_mic_array(
        circular_mic_array([center[0], center[1], 1.5], 0.05, n_mics)
    )
    premix, noise = room.simulate(return_premix=True, snr=snr)
    mix = (premix.sum(axis=0) + noise).T
    # fixed length (exactly `duration` seconds): the raw convolution length
    # varies with each room's RIR tail, which would give every instance its
    # own STFT shape; one shape per (n_mics, n_src) cell is what lets a
    # cell's instances run as one batch
    return mix[:n], premix[:, :, :n]


class _InstanceEval:
    """Per-instance evaluation context: shared reference-side Gram
    factorizations (BssEvalReferences) across every algorithm of the
    instance; single-output algorithms score against estimate-dependent
    (target, rest) pairs, cached per target."""

    def __init__(self, mix, premix, n_src):
        self.mix = mix
        self.n_src = n_src
        self.refs = premix[:, 0, : mix.shape[0]]
        self.ev = BssEvalReferences(self.refs) if n_src > 1 else None
        self.pair_evs = {}
        # score_time runs on the scoring thread pool; the pair cache is the
        # only mutated state (evaluate() is read-only)
        self._pair_lock = threading.Lock()
        if n_src > 1:
            self.sdr_mix, self.sir_mix, _, _ = self.ev.evaluate(
                np.tile(mix[:, 0], (n_src, 1))
            )
        else:
            self.sdr_mix = np.array([0.0])
            self.sir_mix = np.array([0.0])

    def score(self, Y, runtime, nfft):
        """Separated STFT (a tensor on any device) -> result dict."""
        hop = nfft // 2
        y = api.stft_synthesis(Y, nfft)[nfft - hop :][: self.mix.shape[0]]
        return self.score_time(y.cpu().numpy(), runtime)

    def score_time(self, y, runtime):
        """Separated time-domain signals (n_samples, n_out) -> result dict."""
        mix, refs, n_src = self.mix, self.refs, self.n_src
        if y.shape[1] == n_src and n_src > 1:
            # reference-ordered rows (mir_eval convention), so the mix
            # scores (also reference-ordered) align without perm indexing
            sdr, sir, sar, perm = self.ev.evaluate(y.T)
            return {
                "runtime": runtime,
                "sdr": sdr.tolist(),
                "sir": sir.tolist(),
                "sdr_improvement": (sdr - self.sdr_mix).tolist(),
                "sir_improvement": (sir - self.sir_mix).tolist(),
            }
        # single output (ogive / five or n_src == 1)
        best = max(
            range(refs.shape[0]),
            key=lambda j: abs(np.dot(refs[j], y[:, 0])),
        )
        est = (
            np.stack([y[:, 0], mix[:, 0] - y[:, 0]])
            if refs.shape[0] > 1
            else y.T[:1]
        )
        with self._pair_lock:
            if best not in self.pair_evs:
                pair = (
                    np.stack([refs[best], refs.sum(0) - refs[best]])
                    if refs.shape[0] > 1
                    else refs[:1]
                )
                self.pair_evs[best] = BssEvalReferences(pair)
        sdr, sir, _, _ = self.pair_evs[best].evaluate(
            est, compute_permutation=False
        )
        return {
            "runtime": runtime,
            "sdr": [float(sdr[0])],
            # N=1 instances have no interference: SIR is +inf and
            # meaningless — such rows are scored by SDR only
            "sir": [float(sir[0])] if np.isfinite(sir[0]) else [],
        }


def one_instance(cfg, seed, n_mics, n_src, rt60, snr, simulated=None, device=None):
    """Run every applicable algorithm on one (possibly pre-simulated) room,
    on ``device`` (CUDA unless given)."""
    dev = resolve_device(device)
    nfft = cfg["nfft"]
    hop = nfft // 2
    mix, premix = simulated or simulate_instance(cfg, seed, n_mics, n_src, rt60, snr)

    X = api.stft_analysis(_upload(stft_pad(mix, nfft, hop), dev), nfft)
    if cfg.get("wpe"):  # optional dereverb front (see api.wpe)
        X = api.wpe(X, device=dev, **cfg["wpe"])
    ev = _InstanceEval(mix, premix, n_src)

    results = {}
    for name, params in cfg["algos"].items():
        try:
            t0 = time.perf_counter()
            Y = run_algo(name, X, n_src, params, device=dev)
            if Y is None:
                continue
            device_sync(Y)  # the runtime of the execution, not of the dispatch
            runtime = time.perf_counter() - t0
            results[name] = ev.score(Y, runtime, nfft)
        except Exception as e:  # a failed algo shouldn't kill the instance
            _reraise_if_device_fault(e)
            results[name] = {"error": f"{type(e).__name__}: {e}"}
    return results


def _batch_params(spec, params, B):
    """Adapt per-instance params for a batched call: seed-consuming
    families take an explicit per-element ``seeds`` list so every element
    reproduces its single-instance run exactly."""
    params = dict(params)
    if "seeds" in inspect.signature(spec.batch).parameters:
        if "seeds" not in params:
            params["seeds"] = [params.pop("seed", 0)] * B
    return params


def batch_instances(cfg, group, simulated, device=None):
    """Run every applicable algorithm on a same-shape instance group, one
    ``run_batch`` call per algorithm on ``device`` (CUDA unless given).
    Per-element results equal one_instance's to rounding (the registry's
    batch contract); the reported runtime is the batch wall divided by the
    group size.

    group: list of (seed, n_mics, n_src, rt60, snr) sharing (n_mics,
    n_src); simulated: matching list of (mix, premix). Returns one results
    dict per instance."""
    dev = resolve_device(device)
    nfft = cfg["nfft"]
    hop = nfft // 2
    B = len(group)
    n_src, n_mics = group[0][2], group[0][1]
    # one upload of the real mixture batch (half the bytes of the complex
    # STFT), the STFT on the device, and it stays there for every algorithm
    xb = np.stack([stft_pad(m, nfft, hop) for m, _ in simulated])
    Xd = api.stft_analysis_batch(_upload(xb, dev), nfft)
    if cfg.get("wpe"):  # optional dereverb front (see api.wpe)
        Xd = api.wpe_batch(Xd, device=dev, **cfg["wpe"])
    evs = [
        _InstanceEval(mix, premix, n_src) for mix, premix in simulated
    ]
    n_samp = simulated[0][0].shape[0]

    results = [dict() for _ in range(B)]
    # Host bss_eval scoring runs on a thread pool so that it overlaps the
    # next algorithm's device work (NumPy FFT/BLAS release the GIL); the
    # device work stays on this thread. Overlapped scoring inflates the
    # reported runtime on a host short of cores: cfg["strict_timing"]
    # drains pending scores before every timed run.
    strict = bool(cfg.get("strict_timing"))
    futures = {}
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        for name, params in cfg["algos"].items():
            if not applicable(_algo_key(name), n_src, n_mics):
                continue
            spec = get_algorithm(_algo_key(name))
            if strict and futures:
                _fwait(list(futures.values()))
            try:
                t0 = time.perf_counter()
                Yb = spec.run_batch(
                    Xd, n_src=n_src, device=dev,
                    **_batch_params(spec, params, B),
                )
                device_sync(Yb)  # the runtime of the execution, not of the dispatch
                runtime = (time.perf_counter() - t0) / B
            except Exception as e:  # a failed dispatch marks the whole group
                _reraise_if_device_fault(e)
                for b in range(B):
                    results[b][name] = {"error": f"{type(e).__name__}: {e}"}
                continue
            # one batch iSTFT on the device and one copy to the host; on a
            # batch-synthesis failure, synthesise lane by lane so that one
            # bad lane cannot void the other B-1
            lanes = [None] * B
            lane_err = {}
            try:
                yb = api.stft_synthesis_batch(Yb, nfft)
                lanes = list(yb[:, nfft - hop :][:, :n_samp].cpu().numpy())
            except Exception as e:
                _reraise_if_device_fault(e)
                for b in range(B):
                    try:
                        y1 = api.stft_synthesis(Yb[b], nfft)
                        lanes[b] = y1[nfft - hop :][:n_samp].cpu().numpy()
                    except Exception as e1:
                        _reraise_if_device_fault(e1)
                        lane_err[b] = f"{type(e1).__name__}: {e1}"
            for b in range(B):  # score per element: one bad lane must not
                if b in lane_err:  # void the other B-1
                    results[b][name] = {"error": lane_err[b]}
                    continue
                if not np.all(np.isfinite(lanes[b])):
                    results[b][name] = {
                        "error": "FloatingPointError: "
                        "non-finite separation output"
                    }
                    continue
                futures[(b, name)] = pool.submit(
                    evs[b].score_time, lanes[b], runtime
                )
        for (b, name), fut in futures.items():
            try:
                res = fut.result()
                res["batched"] = B
                results[b][name] = res
            except Exception as e:
                results[b][name] = {"error": f"{type(e).__name__}: {e}"}
    return results


def instance_key(seed, n_mics, n_src, rt60, snr):
    return f"s{seed}_m{n_mics}_n{n_src}_rt{rt60}_snr{snr}"


def sweep(cfg: dict, out_dir: Path, prefetch: int = 2, batch: int | None = None,
          device=None):
    """Run the sweep on ``device`` (CUDA unless given). Room simulation
    runs on a producer thread, ahead of the device work.

    Same-shape instances (same n_mics, n_src; T and F are sweep-constant)
    are grouped into chunks of up to ``batch`` (config key "batch",
    default 8) and separated by one ``run_batch`` call per algorithm and
    chunk. Per-instance JSONs and resume-by-skip are unchanged; ``batch=1``
    runs one instance at a time (:func:`one_instance`)."""
    dev = resolve_device(device)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "config.json").write_text(json.dumps(cfg, indent=2))
    base = np.random.SeedSequence(cfg["seed"]).generate_state(cfg["repeats"])
    grid = [
        g
        for g in itertools.product(
            base.tolist(), cfg["n_mics"], cfg["n_srcs"], cfg["rt60"], cfg["snr"]
        )
        if g[2] <= g[1]  # n_src <= n_mics
    ]
    todo = [
        g for g in grid if not (out_dir / f"{instance_key(*g)}.json").exists()
    ]
    skipped = len(grid) - len(todo)
    cap = int(batch if batch is not None else cfg.get("batch", 8))

    # group by algorithm-relevant shape (n_mics, n_src), preserve order
    by_shape: dict[tuple, list] = {}
    for g in todo:
        by_shape.setdefault((g[1], g[2]), []).append(g)
    chunks = [
        grp[i : i + cap]
        for grp in by_shape.values()
        for i in range(0, len(grp), cap)
    ]
    order = [g for chunk in chunks for g in chunk]  # producer order

    q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1) + cap - 1)
    stop = threading.Event()

    def producer():
        try:
            for g in order:
                if stop.is_set():
                    return
                q.put(simulate_instance(cfg, *g))
        except Exception as e:  # handed to the consumer, which raises it
            q.put(e)

    worker = threading.Thread(target=producer, daemon=True)
    worker.start()

    def next_room():
        item = q.get()
        if isinstance(item, Exception):
            raise item
        return item

    done = 0
    try:
        for chunk in chunks:
            simulated = [next_room() for _ in chunk]
            n_real = len(chunk)
            run_chunk, run_sim = chunk, simulated
            # pad a partial chunk up to the cap when its cell already runs
            # the cap-sized batch: one batch shape per (n_mics, n_src) cell
            grp_len = len(by_shape[(chunk[0][1], chunk[0][2])])
            if n_real < cap and grp_len > cap:
                idx = [i % n_real for i in range(cap - n_real)]
                run_chunk = chunk + [chunk[i] for i in idx]
                run_sim = simulated + [simulated[i] for i in idx]
            t0 = time.perf_counter()
            if len(run_chunk) == 1:
                all_results = [one_instance(cfg, *chunk[0], simulated=simulated[0], device=dev)]
            else:
                all_results = batch_instances(cfg, run_chunk, run_sim, device=dev)[:n_real]
            wall = (time.perf_counter() - t0) / n_real
            for g, results in zip(chunk, all_results):
                seed, n_mics, n_src, rt60, snr = g
                key = instance_key(*g)
                record = {
                    "seed": seed, "n_mics": n_mics, "n_src": n_src,
                    "rt60": rt60, "snr": snr,
                    "wall": wall, "results": results,
                }
                (out_dir / f"{key}.json").write_text(json.dumps(record))
                done += 1
                print(
                    f"[{done}/{len(todo)}] {key}  ({wall:.1f}s/inst, "
                    f"batch {len(chunk)})",
                    flush=True,
                )
    finally:
        stop.set()
        while worker.is_alive():  # free a put blocked on the full queue
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
    print(f"sweep complete: {done} new, {skipped} skipped (resumed)")


def _load_rows(out_dir: Path):
    rows = []
    for f in sorted(out_dir.glob("s*.json")):
        rec = json.loads(f.read_text())
        for algo, res in rec["results"].items():
            if "error" in res:
                continue
            sir = np.asarray(res.get("sir", []), dtype=float)
            sir = sir[np.isfinite(sir)]  # N=1 rows carry no SIR (see above)

            def _mean(key):
                v = np.asarray(res.get(key, []), dtype=float)
                v = v[np.isfinite(v)]
                return float(np.mean(v)) if v.size else float("nan")

            rows.append(
                {
                    "key": instance_key(
                        rec["seed"], rec["n_mics"], rec["n_src"],
                        rec["rt60"], rec["snr"],
                    ),
                    "algo": algo, "n_mics": rec["n_mics"], "n_src": rec["n_src"],
                    "rt60": rec["rt60"], "snr": rec["snr"],
                    "sdr": float(np.mean(res["sdr"])),
                    "sir": float(np.mean(sir)) if sir.size else float("nan"),
                    "sdr_improvement": _mean("sdr_improvement"),
                    "sir_improvement": _mean("sir_improvement"),
                    "runtime": res["runtime"],
                }
            )
    return rows


# ------------------------------------------------------------ the tables
# pandas' groupby statistics, so that the tables equal the JAX sweep's:
# the mean a compensated (Kahan) sum over the non-NaN values, the sample
# standard deviation Welford's update, groups in sorted key order

def _mean(values):
    total = comp = 0.0
    n = 0
    for v in values:
        if math.isnan(v):
            continue
        n += 1
        y = v - comp
        t = total + y
        comp = t - total - y
        if math.isnan(comp):  # an infinite value
            comp = 0.0
        total = t
    return total / n if n else math.nan


def _std(values):
    n, mean, m2 = 0, 0.0, 0.0
    for v in values:
        if math.isnan(v):
            continue
        n += 1
        old = mean
        mean += (v - old) / n
        m2 += (v - mean) * (v - old)
    return math.sqrt(m2 / (n - 1)) if n > 1 else math.nan


def _cells(rows):
    """Rows grouped by (algo, n_mics, n_src), in sorted key order."""
    groups: dict[tuple, list] = {}
    for r in rows:
        groups.setdefault((r["algo"], r["n_mics"], r["n_src"]), []).append(r)
    return dict(sorted(groups.items()))


def paired_table(base_rows, rows):
    """The paired deltas of ``rows`` against ``base_rows`` (instances and
    algorithms present in both) per (algo, n_mics, n_src): {cell: [d_sir,
    d_sir_std, d_sdr, sir_base, sir, n]}, rounded to 0.01 dB."""
    base = {(r["key"], r["algo"]): r for r in base_rows}
    pairs = []
    for r in rows:
        b = base.get((r["key"], r["algo"]))
        if b is not None:
            pairs.append({
                "algo": r["algo"], "n_mics": r["n_mics"], "n_src": r["n_src"],
                "d_sir": r["sir"] - b["sir"], "d_sdr": r["sdr"] - b["sdr"],
                "sir": r["sir"], "sir_base": b["sir"],
            })
    table = {}
    for cell, grp in _cells(pairs).items():
        col = {k: [p[k] for p in grp] for k in ("d_sir", "d_sdr", "sir_base", "sir")}
        stats = [_mean(col["d_sir"]), _std(col["d_sir"]), _mean(col["d_sdr"]),
                 _mean(col["sir_base"]), _mean(col["sir"])]
        table[cell] = [float(v) for v in np.round(stats, 2)] + [len(grp)]
    return table


def _fmt(v):
    """A cell as pandas' ``to_csv`` writes it: NaN empty, floats shortest."""
    if isinstance(v, float):
        return "" if math.isnan(v) else repr(v)
    return str(v)


def _write_table(path: Path, header_rows, table):
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerows(header_rows)
        for cell, vals in table.items():
            w.writerow([_fmt(v) for v in (*cell, *vals)])


def _print_table(header, table):
    print("  ".join(f"{h:>10}" for h in header))
    for cell, vals in table.items():
        print("  ".join(f"{_fmt(v) or 'NaN':>10}" for v in (*cell, *vals)))


_COMPARE_COLUMNS = ["d_sir", "d_sir_std", "d_sdr", "sir_base", "sir", "n"]
_METRICS = ["sdr", "sir", "runtime"]


def compare(base_dir: Path, out_dir: Path):
    """Paired per-instance comparison of two sweeps (same config except
    the treatment, e.g. a ``"wpe"`` key, or the other package): mean
    SIR/SDR deltas per (algo, cell) over instances present in BOTH dirs.
    The pairing (same seed = same room/sources) cancels the between-room
    variance that dominates unpaired comparisons. Writes ``compare.csv``
    to out_dir."""
    table = paired_table(_load_rows(base_dir), _load_rows(out_dir))
    if not table:
        print("no paired instances found")
        return
    print(f"paired deltas: {out_dir} vs baseline {base_dir}")
    _print_table(["algo", "n_mics", "n_src", *_COMPARE_COLUMNS], table)
    _write_table(out_dir / "compare.csv",
                 [["algo", "n_mics", "n_src", *_COMPARE_COLUMNS]], table)
    print(f"written to {out_dir/'compare.csv'}")


def _plot(rows, out_dir: Path):
    """The sweep's figures (raw SIR, the SDR/SIR improvement distributions,
    runtime) with matplotlib and seaborn, imported here."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("--plot needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    try:
        import seaborn as sns
    except ImportError as e:
        raise ImportError("--plot needs seaborn, which is not installed") from e

    figures = [
        ("sir", "box", "sir_vs_mics.png"),
        ("sdr_improvement", "box", "sdr_improvement_vs_mics.png"),
        ("sir_improvement", "box", "sir_improvement_vs_mics.png"),
        ("runtime", "point", "runtime_vs_mics.png"),
    ]
    for metric, kind, fname in figures:
        sub = [r for r in rows if not math.isnan(r[metric])]
        if not sub:
            continue
        data = {k: [r[k] for r in sub] for k in ("n_mics", "n_src", "algo", metric)}
        g = sns.catplot(
            data=data, x="n_mics", y=metric, hue="algo", col="n_src",
            kind=kind, sharey=False,
        )
        if metric == "runtime":
            g.set(yscale="log")
        g.savefig(out_dir / fname, dpi=120)
        print(f"plot written to {out_dir/fname}")


def aggregate(out_dir: Path, plot: bool = False):
    rows = _load_rows(out_dir)
    if not rows:
        print("no results found")
        return
    table = {}
    for cell, grp in _cells(rows).items():
        stats = []
        for m in _METRICS:
            col = [r[m] for r in grp]
            stats += [_mean(col), _std(col)]
        table[cell] = [float(v) for v in np.round(stats, 2)]
    _print_table(["algo", "n_mics", "n_src",
                  *(f"{m}_{s}" for m in _METRICS for s in ("mean", "std"))], table)
    _write_table(out_dir / "summary.csv", [
        ["", "", "", *(m for m in _METRICS for _ in range(2))],
        ["", "", "", *(["mean", "std"] * len(_METRICS))],
        ["algo", "n_mics", "n_src", *([""] * 2 * len(_METRICS))],
    ], table)
    if plot:
        _plot(rows, out_dir)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config", nargs="?", default=None)
    p.add_argument("--out", type=str, default="data/sweep")
    p.add_argument("--aggregate", type=str, default=None, metavar="DIR")
    p.add_argument(
        "--compare", type=str, default=None, metavar="BASEDIR",
        help="with --aggregate DIR: paired per-instance SIR/SDR deltas of "
        "DIR vs this baseline sweep (matched-arm A/B, e.g. a wpe key)",
    )
    p.add_argument("--plot", action="store_true")
    p.add_argument(
        "--batch", type=int, default=None,
        help="max same-shape instances per batched run "
        "(default: config key 'batch' or 8; 1 = one-at-a-time)",
    )
    p.add_argument(
        "--strict-timing", action="store_true",
        help="drain pending scoring threads before each timed run: "
        "runtime fidelity over sweep wall time (scoring otherwise "
        "overlaps the next algorithm's window and can inflate its "
        "reported runtime on a host short of cores)",
    )
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: CUDA; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)

    if args.aggregate:
        if args.compare:
            compare(Path(args.compare), Path(args.aggregate))
        else:
            aggregate(Path(args.aggregate), plot=args.plot)
        return
    dev = resolve_device(args.device)
    cfg = dict(DEFAULT_CONFIG)
    if args.config:
        cfg.update(json.loads(Path(args.config).read_text()))
    if args.strict_timing:
        cfg["strict_timing"] = True
    print(f"device: {dev}", flush=True)
    sweep(cfg, Path(args.out), batch=args.batch, device=dev)


if __name__ == "__main__":
    main()
