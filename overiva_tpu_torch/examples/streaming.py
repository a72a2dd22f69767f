"""Streaming separation demo: time-domain blocks in, separated blocks out.

The port's twin of ``examples/streaming.py``, with the same flags plus
``--device``. Drives ``OnlineAuxIVAISS`` (or ``OnlineTISS``, or the
``OnlineWPE`` cascade) through a realtime-style loop: the STFT of the
mixture is on the device, blocks of frames are separated with O(block)
latency and overlap-added back to the time domain on the host. With
``--fused`` it drives the serving tier's ``StreamingSeparator`` instead:
raw sample blocks in and out, framing and overlap-add on the device, and
a per-block latency report. Separation quality is printed over time so
that the online convergence is visible.

    python -m overiva_tpu_torch.examples.streaming --mics 2 --block 16 --duration 8
    python -m overiva_tpu_torch.examples.streaming --fused --tiss 4 --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from overiva_tpu_torch import api, resolve_device
from overiva_tpu_torch.metrics import bss_eval_sources
from overiva_tpu_torch.oracle import hann, stft_pad, synthesis_window
from overiva_tpu_torch.sim import ShoeBox, circular_mic_array, semi_circle_layout, speech_like


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mics", type=int, default=2)
    p.add_argument("--duration", type=float, default=8.0)
    p.add_argument("--nfft", type=int, default=1024)
    p.add_argument("--block", type=int, default=16, help="STFT frames per block")
    p.add_argument("--forget", type=float, default=0.99)
    p.add_argument("--fs", type=int, default=16000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--wpe", type=int, default=0, metavar="TAPS",
        help="streaming WPE dereverberation front with this many taps "
        "(0 = off; api.OnlineWPE, delay 2). Measured negative as a "
        "cascade in the JAX package; prefer --tiss",
    )
    p.add_argument(
        "--tiss", type=int, default=0, metavar="TAPS",
        help="streaming joint dereverberation + separation with this many "
        "taps (0 = off; api.OnlineTISS, delay 2; replaces the separator, "
        "no cascade)",
    )
    p.add_argument(
        "--fused", action="store_true", dest="sample_blocks",
        help="drive the serving tier's StreamingSeparator instead of the "
        "STFT-domain class: raw sample blocks in and out, framing and "
        "overlap-add on the device; reports per-block latency",
    )
    p.add_argument(
        "--device", default=None,
        help="torch device to run on (default: CUDA; 'cpu' runs on the CPU)",
    )
    args = p.parse_args(argv)
    if args.wpe and args.tiss:
        p.error("--wpe and --tiss are alternatives (cascade vs joint)")
    if args.sample_blocks and args.wpe:
        p.error("--fused streams online-iss/online-tiss (no WPE cascade)")
    dev = resolve_device(args.device)

    n = int(args.duration * args.fs)
    M = args.mics
    room = ShoeBox([7.0, 5.0, 3.0], fs=args.fs, rt60=0.2, seed=args.seed)
    src_pos = semi_circle_layout([3.5, 3.5, 1.5], np.pi / 2, 1.8, M)
    for k in range(M):
        room.add_source(src_pos[k], speech_like(n, args.fs, seed=args.seed * 31 + k))
    room.add_mic_array(circular_mic_array([3.5, 2.2, 1.5], 0.04, M))
    premix, noise = room.simulate(return_premix=True, snr=25.0)
    mix = (premix.sum(axis=0) + noise).T[:n]

    hop = args.nfft // 2
    refs = premix[:, 0, :n]
    print(f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))

    if args.sample_blocks:
        return _run_fused(args, mix, refs, hop, dev)

    X = api.stft_analysis(torch.from_numpy(stft_pad(mix, args.nfft, hop)).to(dev), args.nfft)
    F = X.shape[1]
    if args.tiss:
        sep = api.OnlineTISS(F, M, taps=args.tiss, delay=2, forget=args.forget, n_pass=2,
                             device=dev)
    else:
        sep = api.OnlineAuxIVAISS(F, M, forget=args.forget, n_pass=2, device=dev)
    drv = api.OnlineWPE(F, M, taps=args.wpe, delay=2, device=dev) if args.wpe else None

    T = X.shape[0]
    B = args.block
    win_s = synthesis_window(hann(args.nfft), hop)
    y_ola = np.zeros(((T - 1) * hop + args.nfft, M))
    t_proc = 0.0
    print(f"streaming {T} frames in blocks of {B} "
          f"({B * hop / args.fs * 1000:.0f} ms hop-equivalent latency)")
    for i, start in enumerate(range(0, T - B + 1, B)):
        t0 = time.perf_counter()
        X_blk = X[start : start + B]
        if drv is not None:
            X_blk = drv.process(X_blk)
        Y_blk = sep.process(X_blk).cpu().numpy()  # the copy waits for the card
        t_proc += time.perf_counter() - t0
        # overlap-add this block back to the time domain
        frames = np.fft.irfft(Y_blk, n=args.nfft, axis=1) * win_s[None, :, None]
        for j in range(B):
            s = (start + j) * hop
            y_ola[s : s + args.nfft] += frames[j]
        if i % 8 == 7:
            done_samples = min((start + B) * hop, n)
            seg = slice(max(0, done_samples - 2 * args.fs), done_samples)
            est = y_ola[args.nfft - hop :][:n][seg]
            try:
                sdr, sir, _, _ = bss_eval_sources(refs[:, seg], est.T)
                print(f"  block {i+1:3d}: last-2s SIR {np.round(sir, 1)} dB")
            except ValueError:
                pass

    audio_s = T * hop / args.fs
    print(f"\nprocessed {audio_s:.1f}s of audio in {t_proc:.2f}s "
          f"({audio_s / t_proc:.1f}x realtime)")


def _run_fused(args, mix, refs, hop, dev):
    """Serving-tier streaming: raw sample blocks through
    serving.StreamingSeparator, with a per-block latency report."""
    from overiva_tpu_torch.serving import StreamingSeparator

    M = args.mics
    algo = "online-tiss" if args.tiss else "online-iss"
    kw = dict(taps=args.tiss, delay=2) if args.tiss else {}
    sep = StreamingSeparator(
        algo, n_chan=M, nfft=args.nfft, block_frames=args.block,
        forget=args.forget, n_pass=2, device=dev, **kw,
    )
    bs = sep.block_samples
    n = mix.shape[0]
    n_blocks = n // bs
    delay = args.nfft - hop
    y = np.zeros((n_blocks * bs, M))
    lat = []
    print(f"fused stream: {algo}, {n_blocks} blocks of {bs} samples "
          f"({bs / args.fs * 1000:.0f} ms audio each)")
    for i in range(n_blocks):
        blk = mix[i * bs : (i + 1) * bs]
        t0 = time.perf_counter()
        out = sep.process(blk)  # NumPy out: the host has the samples
        lat.append(time.perf_counter() - t0)
        # emitted samples are delayed by nfft - hop (the overlap-add hold
        # back): block i carries input samples [i*bs - delay, i*bs - delay
        # + bs). Store them aligned with the input, so that the scoring
        # compares like with like.
        start = i * bs - delay
        lo = max(start, 0)
        y[lo : start + bs] = out[lo - start :]
        if i % 8 == 7:
            done = (i + 1) * bs - delay
            seg = slice(max(0, done - 2 * args.fs), max(1, done))
            try:
                _, sir, _, _ = bss_eval_sources(refs[:, seg], y[seg].T)
                print(f"  block {i+1:3d}: {lat[-1]*1e3:6.1f} ms  "
                      f"last-2s SIR {np.round(sir, 1)} dB")
            except ValueError:
                pass
    y[n_blocks * bs - delay :] = sep.flush()
    warm = np.asarray(lat[2:] or lat)
    audio_s = n_blocks * bs / args.fs
    print(f"\nprocessed {audio_s:.1f}s in {sum(lat):.2f}s "
          f"({audio_s / sum(lat):.1f}x realtime); warm per-block "
          f"median {np.median(warm)*1e3:.1f} ms / p95 "
          f"{np.percentile(warm, 95)*1e3:.1f} ms vs the block's "
          f"{bs / args.fs * 1000:.0f} ms of audio")


if __name__ == "__main__":
    main()
