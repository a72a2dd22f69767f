"""Serving demo on the port: variable-length clips on the frame-bucket grid.

The port's twin of ``examples/serving.py``, with the same flags plus
``--device`` (default CUDA; ``--device cpu`` runs on the CPU). Simulates a
room scene, cuts clips of several lengths from it, and serves them
through one ``overiva_tpu_torch.serving.Separator``. A handful of buckets
covers every clip length, and the separation is the unpadded pipeline's,
exactly.

    python -m overiva_tpu_torch.examples.serving --algo overiva --mics 5 --srcs 2
    python -m overiva_tpu_torch.examples.serving --warmup --pcm16 --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from overiva_tpu_torch import resolve_device
from overiva_tpu_torch.metrics import bss_eval_sources
from overiva_tpu_torch.serving import SERVABLE, Separator
from overiva_tpu_torch.sim import ShoeBox, circular_mic_array, semi_circle_layout, speech_like


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--algo", default="overiva", choices=SERVABLE)
    p.add_argument("--mics", "-m", type=int, default=5)
    p.add_argument("--srcs", "-s", type=int, default=2)
    p.add_argument("--nfft", type=int, default=2048)
    p.add_argument("--n-iter", type=int, default=20)
    p.add_argument("--fs", type=int, default=16000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--lengths", type=float, nargs="+", default=[6.0, 3.5, 5.7, 2.2, 5.5],
        help="clip lengths in seconds (cut from one simulated scene)",
    )
    p.add_argument(
        "--warmup", action="store_true",
        help="run every bucket up to the longest clip once first",
    )
    p.add_argument(
        "--pcm16", action="store_true",
        help="serve int16 PCM both ways: clips go up as int16 (scaled "
        "1/32768 on the device, bit-identical to the float path) and the "
        "separated samples come back quantized to int16 PCM on the "
        "device; half the host-device bytes each direction",
    )
    p.add_argument(
        "--device", default=None,
        help="torch device to run on (default: CUDA; 'cpu' runs on the CPU)",
    )
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    # one simulated scene; clips are cut from its head
    dur = max(args.lengths)
    n = int(dur * args.fs)
    M, N = args.mics, args.srcs
    room = ShoeBox([7.0, 5.0, 3.0], fs=args.fs, rt60=0.2, seed=args.seed)
    src_pos = semi_circle_layout([3.5, 3.5, 1.5], np.pi / 2, 1.8, N)
    for k in range(N):
        room.add_source(src_pos[k], speech_like(n, args.fs, seed=args.seed * 31 + k))
    room.add_mic_array(circular_mic_array([3.5, 2.2, 1.5], 0.04, M))
    premix, noise = room.simulate(return_premix=True, snr=25.0)
    mix = (premix.sum(axis=0) + noise).T[:n]
    refs = premix[:, 0, :n]  # source images at mic 0

    spec_n_src = None if N == M else N
    sep = Separator(
        args.algo, n_src=spec_n_src, nfft=args.nfft, n_iter=args.n_iter,
        out_dtype=np.int16 if args.pcm16 else None, device=dev,
    )
    print(f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    if args.pcm16:
        peak = np.abs(mix).max()
        mix = np.clip(np.round(mix / peak * 24000), -32768, 32767
                      ).astype(np.int16)

    if args.warmup:
        t0 = time.perf_counter()
        touched = sep.warmup(
            n_chan=M, n_samples=n,
            dtype=np.int16 if args.pcm16 else None,
        )
        print(f"warmup: {touched} buckets run in {time.perf_counter() - t0:.1f} s")

    for secs in args.lengths:
        n_c = int(secs * args.fs)
        t0 = time.perf_counter()
        y = sep.separate(mix[:n_c])  # NumPy out: the copy waited for the card
        dt = time.perf_counter() - t0
        if args.pcm16:
            y = y.astype(np.float64) / 32768.0
        sdr, sir, _, _ = bss_eval_sources(refs[:, :n_c], y.T[: refs.shape[0]])
        bucket = sep._bucket(sep._t_real_of(n_c))
        print(
            f"clip {secs:4.1f} s -> bucket {bucket:4d} frames, "
            f"{dt:6.2f} s wall, SIR {np.mean(sir):6.2f} dB"
        )

    hits = dict(sep.stats["bucket_hits"])
    print(
        f"served {sep.stats['clips']} clips over {sep.n_buckets()} buckets "
        f"(bucket -> clips: { {k[0]: v for k, v in sorted(hits.items())} }); "
        f"padding overhead "
        f"{sep.stats['frames_padded'] / max(sep.stats['frames_real'], 1):.1%}"
    )


if __name__ == "__main__":
    main()
