"""One-shot separation demo on the port: build a room, simulate, separate,
evaluate.

The port's twin of ``examples/oneshot.py``, with the same flags plus
``--device`` (default CUDA; ``--device cpu`` runs on the CPU):

    python -m overiva_tpu_torch.examples.oneshot -a overiva -m 5 -s 2 --rt60 0.25 --n_iter 20
    python -m overiva_tpu_torch.examples.oneshot -a auxiva-iss -m 2 -s 2 --device cpu

``-a`` takes every name of the port's registry. ``--monitor``,
``--spectrogram`` and ``--report`` need matplotlib, imported only when
they are given.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from overiva_tpu_torch import api, resolve_device
from overiva_tpu_torch.metrics import bss_eval_sources
from overiva_tpu_torch.oracle import stft_pad
from overiva_tpu_torch.registry import ALGORITHMS, get_algorithm
from overiva_tpu_torch.sim import (
    ShoeBox,
    circular_mic_array,
    semi_circle_layout,
    speech_like,
)

ALGOS = sorted(ALGORITHMS)


def separate(algo: str, X, n_src: int, n_iter: int, callback=None, device=None):
    spec = get_algorithm(algo)
    kw = {"callback": callback, "device": device}
    if algo.startswith("ogive"):
        # gradient method: needs many cheap steps, not the IP-scale count
        kw.update(n_iter=max(n_iter, 1000), step_size=0.05)
    else:
        kw.update(n_iter=n_iter)
    return spec(X, n_src=n_src, **kw)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-a", "--algo", choices=ALGOS, default="overiva")
    p.add_argument("-m", "--mics", type=int, default=5)
    p.add_argument("-s", "--srcs", type=int, default=2)
    p.add_argument("--rt60", type=float, default=0.25)
    p.add_argument("--snr", type=float, default=25.0, help="mic-noise SNR dB")
    p.add_argument("--nfft", type=int, default=4096)
    p.add_argument("--n_iter", type=int, default=20)
    p.add_argument("--duration", type=float, default=5.0, help="seconds")
    p.add_argument("--fs", type=int, default=16000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save", type=str, default=None, help="dir for output wavs")
    p.add_argument(
        "--source-dir", type=str, default=None,
        help="directory of .wav files to use as sources (real speech); "
        "synthetic speech-like signals are generated when omitted",
    )
    p.add_argument(
        "--wpe", type=int, default=0, metavar="TAPS",
        help="WPE dereverberation front with this many taps (0 = off); "
        "delay 3, 2 iterations (api.wpe)",
    )
    p.add_argument(
        "--monitor", type=str, default=None, metavar="PNG",
        help="record per-iteration SDR/SIR via the callback and plot to PNG",
    )
    p.add_argument(
        "--spectrogram", type=str, default=None, metavar="PNG",
        help="mixture + separated-output spectrogram panel (the reference "
        "example.py figure)",
    )
    p.add_argument(
        "--report", type=str, default=None, metavar="DIR",
        help="write an HTML listening report (audio players for mix + "
        "separated outputs, metrics table, figures) — the headless "
        "stand-in for the reference's PlaySoundGUI audition loop",
    )
    p.add_argument(
        "--device", default=None,
        help="torch device to run on (default: CUDA; 'cpu' runs on the CPU)",
    )
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if args.report:
        rep = Path(args.report)
        rep.mkdir(parents=True, exist_ok=True)
        args.save = args.save or str(rep)
        args.monitor = args.monitor or str(rep / "convergence.png")
        args.spectrogram = args.spectrogram or str(rep / "spectrogram.png")

    rng = np.random.default_rng(args.seed)
    n = int(args.duration * args.fs)
    n_out = 1 if args.algo.startswith("ogive") else args.srcs

    # room: ~WASPAA'19 setup — sources on an arc AROUND the mic array
    # (equidistant: centering the arc away from the array makes per-source
    # levels wildly unequal)
    room_dim = [8.0, 9.0, 3.0]
    room = ShoeBox(room_dim, fs=args.fs, rt60=args.rt60, seed=args.seed)
    src_pos = semi_circle_layout([4.0, 4.0, 1.5], np.pi / 2, 2.5, args.srcs,
                                 rot=np.pi / 2)
    if args.source_dir:
        from overiva_tpu_torch.sim import load_wav_sources

        signals = load_wav_sources(
            args.source_dir, args.srcs, n, args.fs, seed=args.seed
        )
    else:
        signals = np.stack(
            [speech_like(n, args.fs, seed=args.seed * 97 + k)
             for k in range(args.srcs)]
        )
    for k in range(args.srcs):
        room.add_source(src_pos[k], signals[k])
    room.add_mic_array(circular_mic_array([4.0, 4.0, 1.5], 0.05, args.mics))

    premix, noise = room.simulate(return_premix=True, snr=args.snr)
    mix = (premix.sum(axis=0) + noise).T  # (n_samples, M)

    hop = args.nfft // 2
    print(f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    X = api.stft_analysis(stft_pad(mix, args.nfft, hop), args.nfft, device=dev)
    print(f"mixture {mix.shape} -> STFT {X.shape}")
    if args.wpe:
        X = api.wpe(X, taps=args.wpe, delay=3, n_iter=2, device=dev)
        print(f"WPE front applied ({args.wpe} taps)")

    recorder = None
    if args.monitor:
        from overiva_tpu_torch.utils.profiling import ConvergenceRecorder

        recorder = ConvergenceRecorder(
            premix[:, 0, : mix.shape[0]], args.nfft, n_samples=mix.shape[0]
        )

    t0 = time.perf_counter()
    Y = separate(args.algo, X, args.srcs, args.n_iter, callback=recorder, device=dev)
    dt = time.perf_counter() - t0  # NumPy out: the copy waited for the card
    y = api.stft_synthesis(Y, args.nfft, device=dev)
    start = args.nfft - hop
    y = y[start : start + mix.shape[0]]

    refs = premix[:, 0, : mix.shape[0]]
    metric_rows = []  # (label, SDR, SIR, mix SDR, mix SIR) for the report
    if n_out == args.srcs:
        sdr, sir, sar, perm = bss_eval_sources(refs, y.T)
        sdr0, sir0, _, _ = bss_eval_sources(
            refs, np.tile(mix[:, 0], (args.srcs, 1))
        )
        print(f"\n{args.algo}: {dt:.2f}s")
        for j in range(args.srcs):
            # mir_eval convention: row j scores reference j vs estimate perm[j]
            print(
                f"  src {j} <- out {perm[j]}: SDR {sdr[j]:6.2f} dB "
                f"(mix {sdr0[j]:6.2f})  SIR {sir[j]:6.2f} dB "
                f"(mix {sir0[j]:6.2f})"
            )
            metric_rows.append(
                (f"src {j} &larr; out {perm[j]}", sdr[j], sir[j],
                 sdr0[j], sir0[j])
            )
    else:
        best = max(range(args.srcs), key=lambda j: abs(np.dot(refs[j], y[:, 0])))
        pair = np.stack([refs[best], refs.sum(0) - refs[best]])
        est = np.stack([y[:, 0], mix[:, 0] - y[:, 0]])
        sdr, sir, _, _ = bss_eval_sources(pair, est, compute_permutation=False)
        print(f"\n{args.algo}: {dt:.2f}s  extracted src {best}: "
              f"SDR {sdr[0]:.2f} dB  SIR {sir[0]:.2f} dB")
        metric_rows.append(
            (f"extracted src {best}", sdr[0], sir[0], float("nan"),
             float("nan"))
        )

    if recorder is not None and recorder.sdr:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(1, 2, figsize=(9, 3.5), sharex=True)
        sdr_c = np.asarray(recorder.sdr)
        sir_c = np.asarray(recorder.sir)
        for k in range(sdr_c.shape[1]):
            ax[0].plot(sdr_c[:, k], marker="o", label=f"src {k}")
            ax[1].plot(sir_c[:, k], marker="o", label=f"src {k}")
        ax[0].set_title("SDR (dB)")
        ax[1].set_title("SIR (dB)")
        ax[0].set_xlabel("callback #")
        ax[1].set_xlabel("callback #")
        ax[0].legend()
        fig.tight_layout()
        fig.savefig(args.monitor, dpi=120)
        print(f"convergence plot -> {args.monitor}")

    if args.spectrogram:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        def db(S):
            return 20.0 * np.log10(np.abs(S).T + 1e-7)

        panels = [("mixture (mic 0)", X[:, :, 0])] + [
            (f"output {k}", Y[:, :, k]) for k in range(n_out)
        ]
        fig, axes = plt.subplots(
            1, len(panels), figsize=(4 * len(panels), 3.6), sharey=True
        )
        axes = np.atleast_1d(axes)
        vmax = db(X[:, :, 0]).max()
        for ax, (title, S) in zip(axes, panels):
            ax.imshow(
                db(S), origin="lower", aspect="auto", cmap="inferno",
                vmax=vmax, vmin=vmax - 70,
                extent=(0, args.duration, 0, args.fs / 2000.0),
            )
            ax.set_title(title)
            ax.set_xlabel("time (s)")
        axes[0].set_ylabel("frequency (kHz)")
        fig.tight_layout()
        fig.savefig(args.spectrogram, dpi=120)
        print(f"spectrogram panel -> {args.spectrogram}")

    if args.save:
        from scipy.io import wavfile

        out = Path(args.save)
        out.mkdir(parents=True, exist_ok=True)
        norm = np.max(np.abs(y)) + 1e-9
        wavfile.write(out / "mix.wav", args.fs,
                      (mix[:, 0] / (np.max(np.abs(mix)) + 1e-9) * 0.9 * 32767).astype(np.int16))
        for k in range(n_out):
            wavfile.write(out / f"sep_{k}.wav", args.fs,
                          (y[:, k] / norm * 0.9 * 32767).astype(np.int16))
        print(f"wavs written to {out}/")

    if args.report:
        rep = Path(args.report)
        rows = "\n".join(
            f"<tr><td>{label}</td><td>{s:.2f}</td><td>{si:.2f}</td>"
            f"<td>{s0:.2f}</td><td>{si0:.2f}</td></tr>"
            for label, s, si, s0, si0 in metric_rows
        )
        players = "\n".join(
            f"<p><b>output {k}</b><br>"
            f"<audio controls src='sep_{k}.wav'></audio></p>"
            for k in range(n_out)
        )
        figures = "".join(
            f"<img src='{Path(p).name}' style='max-width:100%'>"
            for p in (args.spectrogram, args.monitor)
            if p and Path(p).exists()
        )
        html = f"""<!doctype html>
<html><head><meta charset="utf-8"><title>overiva_tpu_torch listening report</title>
<style>body{{font-family:sans-serif;max-width:60em;margin:2em auto}}
table{{border-collapse:collapse}}td,th{{border:1px solid #999;padding:4px 10px}}
</style></head><body>
<h1>Listening report — {args.algo}</h1>
<p>{args.mics} mics, {args.srcs} sources, RT60 {args.rt60} s, SNR
{args.snr} dB, nfft {args.nfft}, {args.n_iter} iterations, seed
{args.seed}, device {dev}; separation wall time {dt:.2f} s.</p>
<h2>Audition</h2>
<p><b>mixture (mic 0)</b><br><audio controls src='mix.wav'></audio></p>
{players}
<h2>Metrics (bss_eval, dB)</h2>
<table><tr><th>pair</th><th>SDR</th><th>SIR</th><th>mix SDR</th>
<th>mix SIR</th></tr>
{rows}</table>
<h2>Figures</h2>
{figures}
</body></html>
"""
        (rep / "index.html").write_text(html)
        print(f"listening report -> {rep/'index.html'}")


if __name__ == "__main__":
    main()
