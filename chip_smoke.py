"""Smoke run of the PyTorch port on one CUDA card: builds the kernels,
checks them, drives every family at full width and checks the results.

    python3 chip_smoke.py [--seed N]

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device: a CUDA card is required; prints its name and power limit
   (``nvidia-smi``) and checks that TF32 is off;
2. build: compiles ``overiva_tpu_torch/csrc/*.cu`` with nvcc (sm_90a);
3. kernel: ``wcov_packed`` against its plain PyTorch version on the card, at
   the main path's shapes and on ragged shapes of both routes (the
   tensor-core warp kernel for M <= 8, the block kernel for M > 8), with the
   times of the whole call and of the launch alone, the time of one library
   call that computes the same product (complex64 ``torch.matmul``) and the
   card's least time for the work (``bound_ms``);
3b. fused: ``update_rows`` (the fused per-bin IP update) against its plain
   version at the headline and ragged shapes (F=129, not a multiple of the
   warp kernel's bins per block), on knife-edge bins, and at the shapes the
   benchmark's cells give it (one clip, phi (56, 3), F=2049; a folded group
   of 8 rooms, phi (56, 8, 3), F=8 x 2049, blocks straddling two rooms), with
   the kernel, plain and eager-epoch times and the bound;
3c. entry: ``overiva_tpu_torch.entry.entry()`` (one ``_epoch`` at T=128,
   F=513, M=8, N=3, the twin of ``__graft_entry__.entry``) on the card,
   its W against the same function on the CPU (``ENTRY_TOL``), both
   kernels' counters at 0, and the median of 20 queued calls beside the
   card's name and power limit;
3d. taps: ``tap_steps`` (one T-ISS epoch's tap-steering steps in one
   launch) against its plain version and the plain version at complex128,
   at the ``tiss_batch`` cell's shapes (T=192, 8 folded rooms of 513 bins,
   M=8, MK=40, Z read in place from the augmented input) and at ragged
   ones, with the kernel's and the plain version's times and the bound;
4. trajectory: OverIVA in complex128 on the card against the float64 NumPy
   oracle at full width (M=8, N=3, nfft 4096, T=128), 10 iterations;
5. main path: stft_analysis -> overiva (wcov="f32" and "bf16pack", complex64,
   30 iterations) -> stft_synthesis, with launch counts (``update_rows``
   once an epoch of the f32 run, ``wcov_packed`` of the bf16pack run),
   bss_eval SDR/SIR gates against the oracle, and times;
5b. fused run: 30 epochs of ``_fused_epoch`` (demix -> phi, then the
   fused kernel) on phase 5's STFT, with the launch count, the same
   SDR/SIR gate against the oracle, and its time beside phase 5's;
6. requests: three mixtures of different lengths through
   ``separate(algo="ip")``;
7. families: on phase 5's mixture, OverIVA-ISS, OverIVA-IP2, FIVE and
   OGIVE in complex128 on the card against the float64 oracles element by
   element (the JAX package's tolerances), in complex64 through iSTFT and
   bss_eval (ISS and OGIVE gated at 0.1 dB, IP2 and FIVE printed: their
   complex64 floors are the reference's own), ``wcov_packed`` in the loops
   of OverIVA-IP2 (K = 3) and AuxIVA-IP2 (K = 8), one launch an epoch,
   within 0.3 dB mean SIR of the f32 run (OverIVA-IP2) or of the plain
   bf16 tier (AuxIVA-IP2, f32 printed), OGIVE's early exit at
   complex128 (at a tolerance read off the c128 trajectory of its
   criterion, so that it stops inside the run: the oracle stops before the
   last callback chunk, the port at the oracle's epoch and after as many
   callback chunks; the default complex64 run's epochs and host reads of
   ``done`` are printed), each family's time
   with its device ops an epoch and busy share (torch.profiler), and
   ``separate(algo="iss"|"ip2")`` at three lengths;
8. tf-families: on phase 5's mixture, ILRMA, FastMNMF2, FastMNMF1 and
   SparseAuxIVA in complex128 on the card against the float64 oracles
   (ILRMA element by element at the JAX package's tolerance, the others at
   10x the port's CPU figure on this mixture cut in F), in complex64
   through iSTFT and bss_eval (FastMNMF2/1 at 12 epochs gated at 0.1 dB;
   ILRMA at 8, FastMNMF2 at 30 and SparseAuxIVA at 20 printed, the last
   beside the oracle's own complex64 run: at 8 outputs the complex64
   floor of the reference is dB-sized there), FastMNMF2/1 in complex64 on
   ``examples/parity_check.py``'s seed-7 scene printed beside the JAX
   function's spread over rotations of its whitening start (a complex64
   floor of the reference), every
   run's ``wcov_packed`` at 0 and ``update_rows`` at its complex64 f32
   OverIVA-IP epochs (SparseAuxIVA's 20 + 3), ``wcov_packed`` in both IP phases of
   SparseAuxIVA's bf16pack tier (20 + 3 launches, within 0.3 dB mean SIR of
   f32), each family's time with its device ops an epoch and busy share,
   SparseAuxIVA's three phases apart, and ``separate(algo="fastmnmf2")``
   at three lengths;
9. joint: a reverberant room (``make_reverb_mixture``, 0.4 s RT60) at the
   headline widths, T=512. WPE, T-ISS, T-IP and ILRMA-T in complex128 on
   the card against the float64 oracles element by element (nfft 1024,
   128 frames, the JAX package's tolerances) and the ``tiss-df`` /
   ``tip-df`` registry names within 1e-6; in complex64 through iSTFT and
   bss_eval against the oracle at ``examples/parity_check.py``'s joint
   settings (gated at 0.1 dB); times at T=512 (WPE, WPE -> OverIVA,
   T-ISS, T-IP at f32 and bf16, ILRMA-T); the 30 registry names through
   ``__call__`` and ``run_batch`` on the card; ``separate(algo="tiss"|
   "tip"|"ilrma_t")`` and ``separate(wpe=True)`` at three lengths; both
   kernels' counters zeroed before each joint run and read after:
   ``wcov_packed`` at 0, ``update_rows`` at the run's complex64 f32
   OverIVA-IP epochs (a fixed count: WPE -> OverIVA, ``REGISTRY_IP``);
10. streaming: rooms from the port's simulation copy
   (``overiva_tpu_torch.sim``, ``examples/streaming.py``'s room and
   ``examples/parity_check.py``'s); ``OnlineAuxIVAISS`` in complex128 on
   the card against the f64 ``online_iss_run`` element by element (rtol
   1e-8, atol 1e-10) and in complex64 through iSTFT and bss_eval
   (parity_check's stream row, gated at 0.1 dB); ``OnlineTISS`` (solve,
   steer, taps=0) and ``OnlineWPE`` in complex128 on the card against the
   CPU (printed); ``StreamingSeparator`` (online-iss, online-tiss) against
   the STFT-domain class plus offline synthesis; ``warmup()`` mid-stream
   and save -> restore bit for bit; three tensor-in blocks under
   ``torch.cuda.set_sync_debug_mode("error")``; the warm per-block latency
   (median, p95), real-time factor, device ops and busy share a block at
   ``bench.py``'s streaming setting (M=4, nfft 512, hop 256, 16-frame
   blocks of 256 ms, n_pass 2; online-iss also at M=8); both kernels'
   counters at 0 over the phase;
11. serving: the clip-serving tier at the headline widths (M=8, N=3, nfft
   4096, 30 iterations, complex64) on clips of 64 / 128 / 256 real frames
   (buckets 72 / 152 / 304, so every clip pads; the 128-frame clip is
   phase 5's): ``Separator("overiva")`` f32 and ``wcov="bf16pack"``,
   NumPy float in and out, with ``wcov_packed`` at 30 launches a bf16pack
   clip (90 for a bf16pack ``separate_batch`` of three, clip by clip) and 0
   under f32, ``update_rows`` at 30 an f32 clip and 0 under bf16pack (over
   the phase: printed); SDR/SIR within 0.1 dB of the f64 oracle
   at each length (the oracle in worker processes while the card works;
   bf16pack within 0.3 dB mean SIR of f32); int16 PCM in equal to float /
   32768 and int16 out equal to the host's quantization, bit for bit;
   complex128 (5 iterations) element-wise within rtol 1e-6 of the unpadded
   pipeline on the card; ``separate_batch`` of 8 clips in 3 buckets
   against per-clip (complex64 printed, complex128 gated at 1e-9);
   ``warmup()`` to 256 frames; the 17 SERVABLE names at a 3-mic STFT; the
   oneshot (``-m 8 -s 3 --nfft 4096 --duration 8``) and ``parity_check
   --quick`` CLI twins in process (PASS required); then the request
   latency (median and p95 of 10 after a warm call) of the f32, bf16pack
   and int16 tiers beside phase 6's ``api.separate``, with device ops and
   busy share a request (f32 at each length, the other tiers at 128
   frames), and ``separate_batch``'s wall;
12. parallel: the multi-device tier (``overiva_tpu_torch/parallel/``) on
   the one card. NCCL refuses two ranks on one device, so 4 gloo ranks
   share cuda:0 (collectives staged through the host): the dry run's 17
   families at its tiny shape on meshes (2, 2) and (1, 4) in complex128,
   each within 1e-6 of the single-device run on the card, every rank the
   same, each rank's collectives equal to the count of its JAX epochs;
   ``sharded_overiva`` at the headline on (1, 4), complex64, within 0.1 dB
   of phase 5's ``api.overiva``, its best-of-3 wall beside api.overiva's
   (overhead on one shared card, not scaling); the dry run's 5 scaled
   scenes (simulated rooms, F=2049, 20 iterations) of both lengths
   (``dryrun.SCALED_SCENES``: the JAX dry run's 48 frames, and 128) under
   the dry run's gate (``dryrun.scaled_verdict``): every seed's complex128
   pair within 0.02 dB, every complex64 delta within 0.1 dB or a
   certified flip and within ``dryrun.CONTROL_K`` times the control's,
   the single-device run on its bins reversed (complex64's own spread on
   the scene, which reaches 0.1 dB at both lengths), printed beside it,
   the JAX dry run's rule of at most one flip printed; ``Separator(mesh=(4,
   1))`` at 64 / 128 / 256 frames against meshless (complex128 within
   1e-7; complex64 f32 and bf16pack printed) with ``wcov_packed`` at 30
   launches for each clip a rank runs; ``sharded_overiva`` on one NCCL
   rank (a 1 x 1 mesh); then two NCCL ranks on cuda:0, whose refusal is
   printed. Each rank's launches of both kernels over the phase are
   counted and gated (``wcov_packed`` 90 on each gloo rank, 0 on the NCCL
   rank; ``update_rows`` 90 on each gloo rank, the complex64 f32 Separator
   batch's, 0 on the NCCL rank).
13. sweep: the Monte-Carlo sweep twin (``python -m
   overiva_tpu_torch.examples.mbss_sim``) on ``bench/waspaa_demo_config.json``
   (nfft 2048, 4 s rooms, M in {2, 3, 5, 8}, N in {1, 2, 3}, nine algorithms)
   plus ``overiva@bf16pack`` and ``overiva@bf16`` arms (20 it, init_eig), at
   batch 1, on the first of the config's three seeds (11 instances), resuming
   past the other two's records copied from the TPU snapshot
   ``data/waspaa_demo/``: no error entry, every score finite, the copied
   records untouched, ``wcov_packed`` once an epoch of each bf16pack run
   (phase 5's count) and ``update_rows`` once an epoch of each complex64
   f32 IP arm that ran (``SWEEP_IP_ARMS``), the bf16pack arm within 0.3
   dB mean SIR of f32 ``overiva`` or of the plain bf16 arm in each cell;
   printed: the paired dSDR / dSIR per (algo, cell) against the snapshot,
   the wall per instance and the card's busy share over one instance (M=8,
   N=3); then ``tests/test_torch_sweep.py``'s small config at
   batch 3 against batch 1 on the card, within 2e-4 dB.
14. bench: the bench twin (``python -m overiva_tpu_torch.examples.bench``,
   the port's ``bench.py``) in process: ``bench.run`` at its full shape
   with one timed run a row, its JSON on a ``[bench]`` line; every one of
   ``bench.py``'s 35 keys present and finite, no ``bench_errors`` and no
   ``bench_truncated_at``, ``wcov_packed`` launched 2 x (1 + 1) x 30 times
   (the two bf16pack rows, warm-up and timed run) and ``update_rows``
   once an epoch of the complex64 f32 and f32x3 IP rows
   (``bench_ip_epochs``).

Each phase ends with a ``[time]`` line, its wall in seconds.

The second-to-last line is a JSON object of the kernels, the last line
``{"ok": true, "device": {...}}``. The float64 oracle and bss_eval are the
port's own copies of the repository's NumPy references
(``overiva_tpu_torch.oracle``, ``overiva_tpu_torch.metrics``): the script
imports only ``overiva_tpu_torch``, torch, numpy and scipy, and checks at
its end that neither JAX nor the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

NFFT, HOP = 4096, 2048
M, N = 8, 3  # the headline configuration: 8 mics, 3 sources
# H100 SXM peaks (NVIDIA's data sheet, dense): HBM bytes/s, f32 FLOP/s
# outside the tensor cores, bf16 tensor-core FLOP/s
HBM_BYTES_S, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12
KERNEL_TOL = 1e-5  # max|kernel - plain| / max|V|: f32 summation order only
# max|kernel - plain| / max|W| of the fused update: f32 sums in another
# order, amplified by the condition of W V at M = 8
FUSED_TOL = 1e-4


def log(msg):
    print(msg, flush=True)


# ----------------------------------------------------------------- inputs

def make_sources(rng, n_src, n_samples):
    """Gated Laplacian sources with distinct on/off patterns and colour."""
    src = rng.laplace(size=(n_src, n_samples))
    block = max(n_samples // 32, 1)
    n_blocks = -(-n_samples // block)
    kernel = np.hanning(129)
    kernel /= kernel.sum()
    for k in range(n_src):
        gates = np.where(rng.random(n_blocks) < 0.45, 1.0, 0.05)
        env = np.convolve(np.repeat(gates, block)[:n_samples], kernel, mode="same")
        src[k] *= env
        b = np.array([1.0, 0.5 * (-1) ** k, 0.2 * (k + 1) / n_src])
        src[k] = np.convolve(src[k], b, mode="same")
    return src / np.std(src, axis=1, keepdims=True)


def make_mixture(rng, n_src, n_mics, n_samples, n_taps=8, snr_db=30.0):
    """Random-FIR convolutive mixture with a dominant direct path and white
    noise. Returns (mix (n, M), images (n_src, n, M))."""
    src = make_sources(rng, n_src, n_samples)
    H = rng.standard_normal((n_mics, n_src, n_taps))
    H[:, :, 0] += 2.0 * np.sign(H[:, :, 0])
    images = np.zeros((n_src, n_samples, n_mics))
    for m in range(n_mics):
        for k in range(n_src):
            images[k, :, m] = np.convolve(src[k], H[m, k])[:n_samples]
    mix = images.sum(axis=0)
    noise = rng.standard_normal(mix.shape)
    noise *= np.linalg.norm(mix) / np.linalg.norm(noise) * 10 ** (-snr_db / 20)
    return mix + noise, images


def samples_for_frames(n_frames):
    """Signal length whose padded STFT has exactly ``n_frames`` frames."""
    return (n_frames - 1) * HOP


# ----------------------------------------------------------------- bounds

def bound(n_bytes, flops, peak_flops):
    """(ms, what sets it): the least time the card could take for work that
    moves ``n_bytes`` (each input read once, each output written once) and
    does ``flops`` at ``peak_flops``."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def wcov_bound(K, F, m, T):
    """bf16 planes in, phi in, complex64 V out; 8 flops per weighted product
    (exact in f32 for bf16 operands, so the bf16 tensor-core rate)."""
    n_bytes = 2 * F * m * T * 2 + T * K * 4 + 2 * K * F * m * m * 4
    flops = 8 * K * F * m * m * T + 2 * K * F * m * T
    return bound(n_bytes, flops, BF16_FLOPS)


def update_rows_bound(m, n, F, T, n_mix=1):
    """X, phi (of ``n_mix`` folded mixtures), Cx, W in and W out, all in f32. The covariances are Hermitian
    and share x x^H: per bin and frame, each upper-triangle product once
    (6 flops off the diagonal, 3 on it), then one real-weighted multiply-add
    per source (4 flops off the diagonal, 2 on it). Per bin and source, at 8
    flops per complex multiply-add: W V_k, the Gaussian elimination and back
    substitution of the m x (m+1) tableau, the quadratic form, the tmp row
    and the N x m OC elimination."""
    n_bytes = T * F * m * 8 + T * n_mix * n * 4 + 3 * F * m * m * 8
    off = m * (m - 1) // 2
    cov = F * T * (off * (6 + 4 * n) + m * (3 + 2 * n))
    gauss = (m**3 - m) // 3 + m * (m - 1) // 2
    solves = n * F * 8 * (m**3 + gauss + m * m + m * m + n * n * m)
    return bound(n_bytes, cov + solves, F32_FLOPS)


def tap_steps_bound(T, BF, B, m, MK):
    """Z read once, Y read and written once, phi read, P's tap block
    written (``benchmark/roofline_taps.py``'s bytes); 22 flops per (t, bin,
    output, step): phi z, the two sums, the update."""
    n_bytes = 8 * T * BF * MK + 2 * 8 * T * BF * m + 4 * T * B * m + 8 * BF * m * MK
    return bound(n_bytes, 22 * T * BF * m * MK, F32_FLOPS)


# ----------------------------------------------------------------- timing

def cuda_ms(fn, repeats=20, warmup=3, queued=False):
    """Mean time of ``fn`` in ms, from CUDA events over ``repeats`` calls.
    With ``queued`` the calls wait behind a device-side sleep twice as long
    as the host takes to enqueue them, so that the events read the device's
    time alone and not the host's launch rate. That suits a call of a few
    launches; an eager chain of hundreds would fill the launch queue, and
    its time is the host's anyway."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if queued:
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        # cycles: at a clock of at most 2 GHz this waits at least that long
        torch.cuda._sleep(int(2e9 * (2 * repeats * host_s + 1e-3)))
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def queued_call_ms(fn, repeats=20):
    """Each of ``repeats`` calls of ``fn`` timed alone by CUDA events, the
    call queued behind a device-side sleep twice as long as the host takes
    to enqueue it, so that its events read the device's time: the times in
    ms, and the synchronised host walls of as many calls in ms."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = []
    for _ in range(repeats):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(int(2e9 * (2 * host_s + 1e-3)))
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return [a.elapsed_time(b) for a, b in events], walls


def best_wall_s(fn, repeats=3):
    """Best synchronised wall time of ``fn`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


# ----------------------------------------------------------------- phases

def card_and_limit():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def phase_device():
    from overiva_tpu_torch import resolve_device

    dev = resolve_device("cuda")
    log(f"[device] {card_and_limit()}")
    log(
        f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}"
    )
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is on: the f32 path must be full float32")
    return dev


def phase_build():
    from overiva_tpu_torch import _build

    t0 = time.perf_counter()
    lib = _build.build_library()
    _build.library()
    seconds = time.perf_counter() - t0
    with open(f"{lib}.log") as f:
        ptxas = _build.ptxas_summary(f.read())
    log(f"[build] {lib.name} in {seconds:.2f} s; " + " | ".join(ptxas))


def wcov_route(m):
    return "tensor cores, a warp per bin" if m <= 8 else "CUDA cores, a block per (bin, source)"


def phase_kernel(dev, seed):
    from overiva_tpu_torch.ops.wcov_packed import (
        _launch, pack_planes, wcov_packed, wcov_packed_reference,
    )

    rng = np.random.default_rng(seed)
    result = {}
    for K, F, m, T, timed in [
        (N, 2049, M, 128, True), (N, 2049, M, 512, True), (2, 129, 5, 77, False),
        (8, 129, 8, 77, False), (2, 129, 12, 77, False),
        # AuxIVA-IP2's shape at the headline: K = M = 8, 16-byte loads
        (M, 2049, M, 128, False),
        # SparseAuxIVA's selected bins at the headline: 513, not a multiple
        # of the kernel's 8 bins a block
        (M, 513, M, 128, False),
        # a long clip: the tensor-core sums stay within tolerance over T
        (N, 129, M, 4096, False),
    ]:
        X = rng.standard_normal((T, F, m)) + 1j * rng.standard_normal((T, F, m))
        X = torch.from_numpy(X.astype(np.complex64)).to(dev)
        phi = torch.from_numpy((rng.random((T, K)) + 0.1).astype(np.float32)).to(dev)
        xpack = pack_planes(X)
        V = wcov_packed(xpack, phi, T)
        vr, vi = wcov_packed_reference(*xpack, phi)
        V_plain = torch.complex(vr, vi) / T
        torch.cuda.synchronize()
        if V.dtype != torch.complex64 or V.shape != (K, F, m, m):
            raise AssertionError(f"wcov_packed gave {V.dtype} {tuple(V.shape)}")
        err = (V - V_plain).abs().max().item()
        scale = V_plain.abs().max().item()
        line = (
            f"[kernel] K={K} F={F} M={m} T={T} ({wcov_route(m)}): max|dV| {err:.3e} = "
            f"{err / scale:.2e} max|V| (tol {KERNEL_TOL:g})"
        )
        if not err <= KERNEL_TOL * scale:
            raise AssertionError(line)
        if timed:
            # the whole call, and the launch alone (the kernel writes V / T
            # itself, so the two differ only on the host)
            ms = cuda_ms(lambda: wcov_packed(xpack, phi, T), queued=True)
            launch_ms = cuda_ms(lambda: _launch(*xpack, phi, T), queued=True)
            plain_ms = cuda_ms(lambda: torch.complex(*wcov_packed_reference(*xpack, phi)) / T)
            # the library yardstick: one complex64 matmul of the prepared
            # weighted operand (K, F, M, T) by X^H (F, T, M); the port never
            # calls it
            Xw = (X.permute(1, 2, 0)[None] * phi.t()[:, None, None, :]).contiguous()
            XH = X.permute(1, 0, 2).conj().resolve_conj().contiguous()
            library_ms = cuda_ms(lambda: torch.matmul(Xw, XH), queued=True)
            bound_ms, bound_by = wcov_bound(K, F, m, T)
            line += (
                f"; whole call {ms:.4f} ms, launch alone {launch_ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, library matmul {library_ms:.4f} ms, bound "
                f"{bound_ms * 1e3:.2f} us ({bound_by}) = {100 * bound_ms / ms:.1f} % of "
                f"the call, {100 * bound_ms / launch_ms:.1f} % of the launch (20 runs)"
            )
            if (K, F, m, T) == (N, 2049, M, 128):
                result = {
                    "max_abs_err": err, "ms": ms, "launch_ms": launch_ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms, "m_route": wcov_route(m),
                }
        log(line)
    return result


def _decisions(W_new, W_old, n):
    """Per-bin guard decisions read off an update: which target rows were
    kept (quad_form's mask, or a dead IP solve), and where the OC solve
    was dead (J = 0)."""
    keep = (W_new[:, :n] == W_old[:, :n]).all(dim=-1)
    zero = (W_new[:, n:, :n] == 0).flatten(1).all(dim=1)
    return keep, zero


def phase_fused_kernel(dev, seed):
    from overiva_tpu_torch.models import overiva as core
    from overiva_tpu_torch.ops.update_rows import update_rows, update_rows_reference

    rng = np.random.default_rng(seed + 2)
    result = {"at_cells": {}}
    cases = [  # (M, N, F, T, folded mixtures, kind)
        (M, N, 2049, 128, 1, "timed"), (M, N, 2049, 512, 1, "timed"),
        (2, 2, 129, 77, 1, ""), (5, 2, 129, 77, 1, ""), (8, 8, 129, 77, 1, ""),
        (7, 4, 129, 100, 1, ""), (M, N, 129, 77, 1, "knife"),
        # the benchmark's cells: a 56-frame serve clip, a group of 8 rooms
        (M, N, 2049, 56, 1, "cell"), (M, N, 8 * 2049, 56, 8, "cell"),
    ]
    for m, n, F, T, B, kind in cases:
        X = rng.standard_normal((T, F, m)) + 1j * rng.standard_normal((T, F, m))
        if kind == "knife":  # 4 silent bins, 4 rank-1 bins
            X[:, :4] = 0
            X[:, 4:8] = rng.standard_normal((T, 4, 1)) * rng.standard_normal((1, 4, m))
        X = torch.from_numpy(X.astype(np.complex64)).to(dev)
        phi = rng.random((T, B, n) if B > 1 else (T, n)) + 0.1
        phi = torch.from_numpy(phi.astype(np.float32)).to(dev)
        W, Cx = core.prepare(X, n, False)
        W, Cx = W.contiguous(), Cx.contiguous()
        W_k = update_rows(phi, X, Cx, W, n)
        W_p = update_rows_reference(phi, X, Cx, W, n)
        torch.cuda.synchronize()
        err = (W_k - W_p).abs().max().item()
        scale = W_p.abs().max().item()
        line = (
            f"[fused] update_rows M={m} N={n} F={F} T={T}{f' B={B}' if B > 1 else ''}"
            f"{' knife-edge' if kind == 'knife' else ''}: "
            f"max|dW| {err:.3e} = {err / scale:.2e} max|W|"
        )
        if kind == "knife":
            keep_k, zero_k = _decisions(W_k, W, n)
            keep_p, zero_p = _decisions(W_p, W, n)
            same = bool(torch.equal(keep_k, keep_p) and torch.equal(zero_k, zero_p))
            finite = bool(torch.isfinite(W_k).all())
            line += (
                f"; kept rows {int(keep_k.sum())} (plain {int(keep_p.sum())}), "
                f"zero OC bins {int(zero_k.sum())} (plain {int(zero_p.sum())}), "
                f"same decisions {same}, finite {finite}"
            )
            if not (same and finite):
                raise AssertionError(line)
        elif not err <= FUSED_TOL * scale:
            raise AssertionError(line + f" (tol {FUSED_TOL:g})")
        else:
            line += f" (tol {FUSED_TOL:g})"
        if kind in ("timed", "cell"):
            ms = cuda_ms(lambda: update_rows(phi, X, Cx, W, n), queued=True)
            plain_ms = cuda_ms(lambda: update_rows_reference(phi, X, Cx, W, n))
            bound_ms, bound_by = update_rows_bound(m, n, F, T, B)
            line += (
                f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bound_ms * 1e3:.2f} us ({bound_by}) = {100 * bound_ms / ms:.1f} % "
                "of the kernel, no single library call"
            )
            if T == 128:
                eager_ms = cuda_ms(lambda: core._epoch(X, W, Cx, n, "laplace"))
                fused_ms = cuda_ms(lambda: core._fused_epoch(X, W, Cx, n, "laplace"))
                line += (
                    f", eager _epoch {eager_ms:.4f} ms, _fused_epoch {fused_ms:.4f} ms"
                )
                result |= {
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                    "eager_epoch_ms": eager_ms, "fused_epoch_ms": fused_ms,
                }
            if kind == "cell":
                result["at_cells"][f"F{F}_T{T}_B{B}"] = {
                    "max_abs_err": err, "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by}
            line += " (20 runs)"
        log(line)
    return result


# max|kernel - complex128| / max|complex128| of the tap steps' P and Y: f32
# sums over T in another order, carried through MK sequential steps
TAPS_TOL = 1e-5


def phase_tap_kernel(dev, seed):
    from overiva_tpu_torch.ops.tap_steps import tap_steps, tap_steps_reference

    rng = np.random.default_rng(seed + 3)
    result = {}
    for T, B, F, m, MK, timed in [
        (192, 8, 513, 8, 40, True),  # the tiss_batch cell
        (37, 1, 129, 8, 40, False), (100, 3, 65, 5, 16, False), (77, 1, 129, 3, 15, False),
        (256, 1, 129, 2, 10, False),
    ]:
        BF = B * F

        def cplx(*shape):
            z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            return torch.from_numpy(z.astype(np.complex64)).to(dev)

        Xt, P, Y = cplx(T, BF, m + MK), cplx(BF, m, m + MK), cplx(T, BF, m)
        phi = torch.from_numpy((rng.random((T, B, m)) + 0.1).astype(np.float32)).to(dev)
        Z = Xt[:, :, m:]  # read in place
        P_k, Y_k = tap_steps(P, Y, Z, phi, B)
        P_p, Y_p = tap_steps_reference(P, Y, Z, phi, B)
        P_d, Y_d = tap_steps_reference(P.to(torch.complex128), Y.to(torch.complex128),
                                       Z.to(torch.complex128), phi.double(), B)
        torch.cuda.synchronize()
        errs = [((a.to(torch.complex128) - b).abs().max() / b.abs().max()).item()
                for a, b in ((P_k, P_d), (Y_k, Y_d), (P_p, P_d), (Y_p, Y_d))]
        line = (
            f"[taps] tap_steps T={T} B={B} F={F} M={m} MK={MK}: vs complex128 max|dP| "
            f"{errs[0]:.2e}, max|dY| {errs[1]:.2e} (plain complex64 {errs[2]:.2e}, "
            f"{errs[3]:.2e}; tol {TAPS_TOL:g})"
        )
        if not max(errs[:2]) <= TAPS_TOL:
            raise AssertionError(line)
        if timed:
            ms = cuda_ms(lambda: tap_steps(P, Y, Z, phi, B), queued=True)
            plain_ms = cuda_ms(lambda: tap_steps_reference(P, Y, Z, phi, B))
            bound_ms, bound_by = tap_steps_bound(T, BF, B, m, MK)
            line += (
                f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bound_ms * 1e3:.2f} us ({bound_by}) = {100 * bound_ms / ms:.1f} % of "
                "the kernel, no single library call (20 runs)"
            )
            result = {"max_rel_err": max(errs[:2]), "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        log(line)
    return result


# max|card - CPU| / max|CPU| of entry()'s W (complex64): the CPU's figure
# against the JAX entry is 4.2e-07, each within 4.8e-07 of complex128
ENTRY_TOL = 2e-6


def phase_entry(dev):
    """``overiva_tpu_torch.entry.entry()`` on the card: one ``_epoch`` at
    T=128, F=513, M=8, N=3 (complex64), its W against the same ``fn`` on
    the CPU within ENTRY_TOL, both kernels' counters at 0 over the call,
    and the median of 20 queued calls with the card's name and power
    limit. Returns the launches of (wcov_packed, update_rows)."""
    from overiva_tpu_torch.entry import entry
    from overiva_tpu_torch.ops.update_rows import update_rows
    from overiva_tpu_torch.ops.wcov_packed import wcov_packed

    fn, args = entry()
    if any(a.device.type != "cuda" or a.dtype != torch.complex64 for a in args):
        raise AssertionError("entry() did not give complex64 tensors on the card")
    wcov_packed.launches = update_rows.launches = 0
    W = fn(*args)
    torch.cuda.synchronize()
    launches = (wcov_packed.launches, update_rows.launches)
    fn_cpu, args_cpu = entry(device="cpu")
    W_cpu = fn_cpu(*args_cpu)
    err = float((W.cpu() - W_cpu).abs().max() / W_cpu.abs().max())
    ms, walls = queued_call_ms(lambda: fn(*args))
    line = (f"[entry] entry(): one _epoch (T=128, F=513, M=8, N=3, laplace, c64) on the card, "
            f"W {tuple(W.shape)}: max|card - CPU| / max|CPU| {err:.2e} (tol {ENTRY_TOL:g}); "
            f"launches of wcov_packed {launches[0]}, of update_rows {launches[1]} (want 0, 0); "
            f"20 queued calls: median {np.median(ms):.3f} ms (min {min(ms):.3f}, max "
            f"{max(ms):.3f}), synchronised host wall median {np.median(walls):.3f} ms; "
            f"{card_and_limit()}")
    if not bool(torch.isfinite(W).all()) or err > ENTRY_TOL or launches != (0, 0):
        raise AssertionError(line)
    log(line)
    return launches


def rel_err(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def phase_trajectory(dev, X):
    from overiva_tpu_torch import oracle
    from overiva_tpu_torch import api

    t0 = time.perf_counter()
    Y = api.overiva(
        torch.from_numpy(X).to(dev), n_src=N, n_iter=10,
        dtype=torch.complex128, device=dev,
    ).cpu().numpy()
    t_port = time.perf_counter() - t0
    t0 = time.perf_counter()
    Yo = oracle.overiva(X, n_src=N, n_iter=10)
    t_oracle = time.perf_counter() - t0
    err = rel_err(Y, Yo)
    line = (
        f"[trajectory] c128 port vs f64 oracle, 10 it, X {X.shape}: "
        f"|dY|/|Y| {err:.3e} (tol 1e-6), max|dY| {np.abs(Y - Yo).max():.3e}; "
        f"port {t_port:.2f} s, oracle {t_oracle:.2f} s"
    )
    if not err < 1e-6:
        raise AssertionError(line)
    log(line)


def score(y, images, n):
    from overiva_tpu_torch.metrics import bss_eval_sources

    sdr, sir, _, _ = bss_eval_sources(images[:, :, 0], np.asarray(y)[:n].T)
    return sdr, sir


def phase_main_path(dev, mix, images, X64):
    from overiva_tpu_torch import oracle
    from overiva_tpu_torch import api
    from overiva_tpu_torch.ops.update_rows import update_rows
    from overiva_tpu_torch.ops.wcov_packed import wcov_packed

    n = mix.shape[0]
    start = NFFT - HOP
    x = torch.from_numpy(oracle.stft_pad(mix, NFFT, HOP)).to(dev)

    # --- the main path, once, with the kernels' launch counts
    wcov_packed.launches = 0
    update_rows.launches = 0
    X = api.stft_analysis(x, NFFT, device=dev)
    Y32 = api.overiva(X, n_src=N, n_iter=30, device=dev)
    torch.cuda.synchronize()
    f32_launches = wcov_packed.launches, update_rows.launches
    Ypk = api.overiva(X, n_src=N, n_iter=30, wcov="bf16pack", device=dev)
    y32 = api.stft_synthesis(Y32, NFFT, device=dev)[start : start + n]
    ypk = api.stft_synthesis(Ypk, NFFT, device=dev)[start : start + n]
    torch.cuda.synchronize()
    launches = wcov_packed.launches
    log(
        f"[main] launches of (wcov_packed, update_rows): f32 run {f32_launches} (want (0, "
        f"30): the f32 epochs run the fused kernel), f32 + bf16pack runs ({launches}, "
        f"{update_rows.launches}) (want (30, 30))"
    )
    if f32_launches != (0, 30) or launches != 30 or update_rows.launches != 30:
        raise AssertionError("the main path did not go through the kernels as expected")
    for name, t in [("X", X), ("Y f32", Y32), ("Y bf16pack", Ypk),
                    ("y f32", y32), ("y bf16pack", ypk)]:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite {name}")
    if X.shape != (128, NFFT // 2 + 1, M) or y32.shape != (n, N) or ypk.shape != (n, N):
        raise AssertionError(f"shapes X {X.shape}, y {y32.shape}, {ypk.shape}")

    # --- quality: port c64 against the f64 oracle, bf16pack against f32
    Yo = oracle.overiva(X64, n_src=N, n_iter=30)
    yo = oracle.synthesis(Yo, NFFT, HOP)[start : start + n]
    sdr_o, sir_o = score(yo, images, n)
    sdr_32, sir_32 = score(y32.cpu().numpy(), images, n)
    sdr_pk, sir_pk = score(ypk.cpu().numpy(), images, n)
    d_sdr = np.abs(sdr_32 - sdr_o).max()
    d_sir = np.abs(sir_32 - sir_o).max()
    d_pk = abs(sir_pk.mean() - sir_32.mean())
    log(
        f"[main] SDR oracle {np.round(sdr_o, 3)} f32 {np.round(sdr_32, 3)} "
        f"bf16pack {np.round(sdr_pk, 3)}; SIR oracle {np.round(sir_o, 3)} "
        f"f32 {np.round(sir_32, 3)} bf16pack {np.round(sir_pk, 3)}"
    )
    log(
        f"[main] f32 vs oracle: max|dSDR| {d_sdr:.4f} dB, max|dSIR| "
        f"{d_sir:.4f} dB (tol 0.1); bf16pack vs f32 mean SIR {d_pk:.4f} dB (tol 0.3)"
    )
    if not (d_sdr < 0.1 and d_sir < 0.1 and d_pk < 0.3):
        raise AssertionError("separation quality gate failed")

    # --- speed: 30-iteration overiva calls on the device-resident STFT
    eager_s = {}
    for wcov in ("f32", "bf16pack"):
        t = best_wall_s(lambda: api.overiva(X, n_src=N, n_iter=30, wcov=wcov, device=dev))
        eager_s[wcov] = t
        log(
            f"[main] overiva wcov={wcov} 30 it (T=128, F=2049, M=8, N=3, c64): "
            f"{t * 1e3:.2f} ms best of 3 = {30 / t:.1f} it/s"
        )
    return {"launches": launches, "sdr_o": sdr_o, "sir_o": sir_o, "sdr_32": sdr_32,
            "sir_32": sir_32, "eager_s": eager_s["f32"]}


def phase_fused_run(dev, mix, images, main):
    """30 epochs through the fused kernel, prepared as api.overiva prepares
    them, on phase 5's mixture; quality against phase 5's oracle scores."""
    from overiva_tpu_torch import oracle
    from overiva_tpu_torch import api
    from overiva_tpu_torch.models import overiva as core
    from overiva_tpu_torch.ops.projection import apply_projection_back
    from overiva_tpu_torch.ops.update_rows import update_rows

    n = mix.shape[0]
    start = NFFT - HOP
    x = torch.from_numpy(oracle.stft_pad(mix, NFFT, HOP)).to(dev)
    X = api.stft_analysis(x, NFFT, device=dev).contiguous()

    def fused_overiva(n_iter=30):
        W_hat, Cx = core.prepare(X, N, False)
        W_hat, Cx = W_hat.contiguous(), Cx.contiguous()
        for _ in range(n_iter):
            W_hat = core._fused_epoch(X, W_hat, Cx, N, "laplace")
        return apply_projection_back(core.demix(X, W_hat[:, :N, :]), X[:, :, 0])

    update_rows.launches = 0
    Y = fused_overiva()
    y = api.stft_synthesis(Y, NFFT, device=dev)[start : start + n]
    torch.cuda.synchronize()
    launches = update_rows.launches
    log(f"[fused] launches of update_rows in the 30-iteration run: {launches} (want 30)")
    if launches != 30:
        raise AssertionError("the fused path did not go through update_rows as expected")
    if not (bool(torch.isfinite(Y).all()) and bool(torch.isfinite(y).all())):
        raise AssertionError("non-finite output of the fused run")
    if Y.shape != (128, NFFT // 2 + 1, N) or y.shape != (n, N):
        raise AssertionError(f"shapes Y {Y.shape}, y {y.shape}")
    sdr, sir = score(y.cpu().numpy(), images, n)
    d_sdr = np.abs(sdr - main["sdr_o"]).max()
    d_sir = np.abs(sir - main["sir_o"]).max()
    log(
        f"[fused] SDR {np.round(sdr, 3)} SIR {np.round(sir, 3)}; vs oracle: "
        f"max|dSDR| {d_sdr:.4f} dB, max|dSIR| {d_sir:.4f} dB (tol 0.1)"
    )
    if not (d_sdr < 0.1 and d_sir < 0.1):
        raise AssertionError("fused run: separation quality gate failed")
    t = best_wall_s(fused_overiva)
    log(
        f"[fused] 30 x _fused_epoch (T=128, F=2049, M=8, N=3, c64): {t * 1e3:.2f} ms "
        f"best of 3 = {30 / t:.1f} it/s; eager overiva f32 {main['eager_s'] * 1e3:.2f} ms"
    )
    # what holds the run back: the host's enqueue time against the synced
    # wall, and the device's busy time (profiler) in one more run
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused_overiva()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _, busy = device_profile(fused_overiva)
    log(
        f"[fused] host enqueue {enqueue * 1e3:.2f} ms of a {wall * 1e3:.2f} ms synced run "
        f"({100 * enqueue / wall:.1f} %); device busy (profiler) "
        + (f"{busy:.2f} ms" if busy > 0 else "not measured (no device time in the trace)")
    )
    return launches


def score_one(y, images, mix):
    """One extracted output, scored as examples/parity_check.py scores it:
    against the source it matches best, the rest of the mixture as the
    interference."""
    from overiva_tpu_torch.metrics import bss_eval_sources

    y = np.asarray(y)[:, 0]
    refs = images[:, :, 0]
    best = max(range(refs.shape[0]), key=lambda j: abs(np.dot(refs[j], y)))
    pair = np.stack([refs[best], refs.sum(0) - refs[best]])
    est = np.stack([y, mix[:, 0] - y])
    sdr, sir, _, _ = bss_eval_sources(pair, est, compute_permutation=False)
    return sdr[:1], sir[:1]


def score_picked(y, images):
    """A determined run's outputs outnumber the sources: each reference is
    scored against the output that correlates best with it (normalised)."""
    from overiva_tpu_torch.metrics import bss_eval_sources

    refs, y = images[:, :, 0], np.asarray(y)
    corr = np.abs(refs @ y) / np.outer(np.linalg.norm(refs, axis=1), np.linalg.norm(y, axis=0))
    sdr, sir, _, _ = bss_eval_sources(refs, y[:, corr.argmax(axis=1)].T)
    return sdr, sir


def ogive_exit_tol(X, cap, every):
    """(update, step size, tolerance, epoch): settings at which OGIVE stops
    at an epoch after the first callback chunk and before the last, read
    off the c128 trajectory of its criterion, crit_t = step * max_f
    ||step_f|| / ||w_f||: the move of w (demix update) or of a (mix
    update) over ||w_t||. The run stops at the first t with crit_t < tol,
    so a tolerance between a new low of crit and the low before it stops
    exactly there; the widest such gap is taken, so that rounding cannot
    move the stop. The settings of OGIVE_SETTINGS are tried in turn; if
    none makes a new low after the first chunk, the first one's stop at
    its first epoch is returned."""
    from overiva_tpu_torch import api
    from overiva_tpu_torch.models import ogive as ogive_mod

    found = []
    for update, step in OGIVE_SETTINGS:
        w, a, use_mix, Cx, Cx_inv, epoch, done, mu, tolt = api._ogive_start(X, step, 0.0, False, 1)
        crit = []
        for _ in range(cap - every):
            w_new, a_new, use_mix, epoch, done = ogive_mod._epoch(
                X, w, a, use_mix, Cx, Cx_inv, epoch, done, mu, tolt, "laplace", update, 10, 1)
            if update == "switching":  # each bin's own update
                moved = torch.where(use_mix[:, None], a_new - a, w_new - w)
            else:
                moved = a_new - a if update == "mix" else w_new - w
            crit.append(torch.amax(torch.linalg.vector_norm(moved, dim=1)
                                   / torch.linalg.vector_norm(w_new, dim=1)))
            w, a = w_new, a_new
        crit = torch.stack(crit).cpu().numpy()
        stops = [(1, np.inf, 2.0 * crit[0])]  # (epoch, gap, tolerance)
        low = crit[0]
        for t in range(2, len(crit) + 1):
            if crit[t - 1] < low:
                stops.append((t, low / crit[t - 1], float(np.sqrt(low * crit[t - 1]))))
                low = crit[t - 1]
        t, _, tol = max(stops, key=lambda s: (s[0] > every, s[1]))
        found.append((update, step, tol, t))
        if t > every:
            break
    return max(found, key=lambda f: f[3] > every)  # the first with a late stop


def device_profile(fn):
    """(device ops, device-busy ms) of one synchronised call of ``fn`` under
    torch.profiler, tracing the card's activity only: with the CPU traced
    too, long runs read the same counts and busy times, but reading the
    trace takes longer and a short run can lose its device events."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.count for e in evs), sum(e.self_device_time_total for e in evs) / 1e3


# phase 7's c128 rows: (entry point, arguments, rtol, atol), the JAX
# package's own tolerances against the f64 oracle (tests/test_overiva_iss.py,
# tests/test_ip2.py, tests/test_five.py, tests/test_jax_parity.py)
FAMILY_C128 = [
    ("overiva_iss", {"n_src": N, "n_iter": 10}, 1e-6, 1e-8),
    ("overiva_ip2", {"n_src": N, "n_iter": 5}, 1e-6, 1e-8),
    ("five", {"n_iter": 5}, 1e-4, 1e-6),
    ("ogive", {"n_iter": 60, "step_size": 0.05, "tol": 0.0}, 1e-5, 1e-7),
]
# OGIVE's early-exit gate: epochs at most, the callback cadence, and the
# (update, step size) settings tried in turn for a stop inside the run
OGIVE_CAP, OGIVE_EVERY = 500, 50
OGIVE_SETTINGS = (("demix", 0.1), ("demix", 0.05), ("mix", 0.1), ("switching", 0.1))


def phase_families(dev, mix, images, X64, main):
    """The ISS, IP2, FIVE and OGIVE families on phase 5's mixture: c128
    trajectories and c64 quality against the f64 oracle copies, the packed
    kernel inside IP2's loop, OGIVE's early exit, and times."""
    from overiva_tpu_torch import api, oracle
    from overiva_tpu_torch.models import ogive as ogive_mod
    from overiva_tpu_torch.ops.update_rows import update_rows
    from overiva_tpu_torch.ops.wcov_packed import wcov_packed

    n = mix.shape[0]
    start = NFFT - HOP
    X128 = torch.from_numpy(X64).to(dev)

    # --- c128 on the card against the f64 oracle, element-wise
    for name, kw, rtol, atol in FAMILY_C128:
        t0 = time.perf_counter()
        Y = getattr(api, name)(X128, dtype=torch.complex128, **kw).cpu().numpy()
        t_port = time.perf_counter() - t0
        t0 = time.perf_counter()
        Yo = getattr(oracle, name)(X64, **kw)
        t_oracle = time.perf_counter() - t0
        outside = int(np.sum(np.abs(Y - Yo) > atol + rtol * np.abs(Yo)))
        line = (
            f"[families] c128 {name} {kw} vs f64 oracle: max|dY| "
            f"{np.abs(Y - Yo).max():.3e} = {np.abs(Y - Yo).max() / np.abs(Yo).max():.2e} "
            f"max|Y|, {outside} of {Y.size} elements outside rtol {rtol:g} atol {atol:g}; "
            f"port {t_port:.2f} s, oracle {t_oracle:.2f} s"
        )
        if Y.shape != Yo.shape or outside:
            raise AssertionError(line)
        log(line)

    # --- c64 quality through iSTFT and bss_eval
    x = torch.from_numpy(oracle.stft_pad(mix, NFFT, HOP)).to(dev)
    X = api.stft_analysis(x, NFFT, device=dev)

    def synth(Y):
        return api.stft_synthesis(Y, NFFT, device=dev)[start : start + n].cpu().numpy()

    def oracle_synth(Y):
        return oracle.synthesis(Y, NFFT, HOP)[start : start + n]

    quality = {}
    for name, kw, one, gated in [
        ("overiva_iss", {"n_src": N, "n_iter": 30}, False, True),
        ("ogive", {"n_iter": 60, "step_size": 0.05, "tol": 0.0}, True, True),
        ("overiva_ip2", {"n_src": N, "n_iter": 10}, False, False),
        ("five", {"n_iter": 10}, True, False),
    ]:
        y = synth(getattr(api, name)(X, **kw))
        yo = oracle_synth(getattr(oracle, name)(X64, **kw))
        if not np.isfinite(y).all():
            raise AssertionError(f"non-finite {name} output")
        sdr, sir = score_one(y, images, mix) if one else score(y, images, n)
        sdr_o, sir_o = score_one(yo, images, mix) if one else score(yo, images, n)
        d_sdr, d_sir = np.abs(sdr - sdr_o).max(), np.abs(sir - sir_o).max()
        quality[name] = (sdr, sir)
        line = (
            f"[families] c64 {name} {kw}: SDR {np.round(sdr, 3)} SIR {np.round(sir, 3)}, "
            f"oracle SDR {np.round(sdr_o, 3)} SIR {np.round(sir_o, 3)}; max|dSDR| "
            f"{d_sdr:.4f} dB, max|dSIR| {d_sir:.4f} dB "
            + ("(tol 0.1)" if gated else "(printed only: a c64 floor of the reference, PARITY.md)")
        )
        if gated and not (d_sdr < 0.1 and d_sir < 0.1):
            raise AssertionError(line)
        log(line)

    # --- the packed kernel in IP2's loop: one launch an epoch, K = n_src,
    # then K = M = 8 for AuxIVA-IP2; each count zeroed just before its run
    def counted(fn):
        wcov_packed.launches = 0
        update_rows.launches = 0
        Y = fn()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(Y).all()):
            raise AssertionError("non-finite IP2 output")
        return Y, wcov_packed.launches, update_rows.launches

    X8 = X[:, :, :8]
    runs = {
        "overiva_ip2_f32": lambda: api.overiva_ip2(X, n_src=N, n_iter=10, device=dev),
        "overiva_ip2_bf16pack": lambda: api.overiva_ip2(
            X, n_src=N, n_iter=10, wcov="bf16pack", device=dev),
        "auxiva_ip2_f32": lambda: api.auxiva_ip2(X8, n_iter=5, device=dev),
        "auxiva_ip2_bf16": lambda: api.auxiva_ip2(X8, n_iter=5, wcov="bf16", device=dev),
        "auxiva_ip2_bf16pack": lambda: api.auxiva_ip2(X8, n_iter=5, wcov="bf16pack", device=dev),
    }
    want = {"overiva_ip2_f32": 0, "overiva_ip2_bf16pack": 10, "auxiva_ip2_f32": 0,
            "auxiva_ip2_bf16": 0, "auxiva_ip2_bf16pack": 5}
    outs, ip2_launches = {}, {}
    for name, fn in runs.items():
        outs[name], ip2_launches[name], fused = counted(fn)
        line = (
            f"[families] {name}: launches of wcov_packed {ip2_launches[name]} "
            f"(want {want[name]}), of update_rows {fused} (want 0)"
        )
        if (ip2_launches[name], fused) != (want[name], 0):
            raise AssertionError(line)
        log(line)
    # bf16pack within 0.3 dB mean SIR (the JAX package's bf16 gate) of f32
    # for OverIVA-IP2; for AuxIVA-IP2, whose 8 outputs at ~35 dB SIR sit
    # below the bf16 tier's own floor, of the plain bf16 tier (the same
    # numerics without the kernel), with f32 printed beside it
    sirs = {
        name: (score(synth(Y), images, n) if name.startswith("overiva")
               else score_picked(synth(Y), images))[1]
        for name, Y in outs.items()
    }
    for prefix, base, n_it in [("overiva_ip2", "f32", 10), ("auxiva_ip2", "bf16", 5)]:
        sir_pk = sirs[f"{prefix}_bf16pack"]
        others = [t for t in ("f32", "bf16") if f"{prefix}_{t}" in sirs]
        d = {t: abs(sir_pk.mean() - sirs[f"{prefix}_{t}"].mean()) for t in others}
        line = (
            f"[families] {prefix} {n_it} it SIR bf16pack {np.round(sir_pk, 3)}, "
            + ", ".join(f"{t} {np.round(sirs[f'{prefix}_{t}'], 3)}" for t in others)
            + "; mean SIR of bf16pack differs from "
            + ", ".join(f"{t} by {d[t]:.4f} dB" for t in others)
            + f" (tol 0.3 against {base})"
        )
        if not d[base] < 0.3:
            raise AssertionError(line)
        log(line)

    # --- OGIVE's early exit at c128, at a tolerance where it stops inside
    # the run: the oracle must stop before the last callback chunk, and the
    # port at the oracle's epoch (ogive_batch's count) and after as many
    # callback chunks (the JAX package's gate)
    update, step, tol, e_aim = ogive_exit_tol(X128, OGIVE_CAP, OGIVE_EVERY)
    kw = {"n_iter": OGIVE_CAP, "step_size": step, "tol": tol, "update": update}
    epochs_o = []  # a callback every epoch counts the oracle's epochs
    Yo = oracle.ogive(X64, callback=lambda Y: epochs_o.append(1), callback_every=1, **kw)
    if len(epochs_o) > OGIVE_CAP - OGIVE_EVERY:
        raise AssertionError(
            f"the oracle's OGIVE runs past {OGIVE_CAP - OGIVE_EVERY} epochs at {kw} "
            f"(aimed at epoch {e_aim}): no early exit to check"
        )
    chunks_t = []
    api.ogive(X128, callback=lambda Y: chunks_t.append(1), callback_every=OGIVE_EVERY,
              dtype=torch.complex128, **kw)
    Yb, epochs_t = api.ogive_batch(X128[None], return_epochs=True, dtype=torch.complex128, **kw)
    chunks_o = -(-len(epochs_o) // OGIVE_EVERY)
    d_y = np.abs(Yb[0].cpu().numpy() - Yo).max() / np.abs(Yo).max()
    line = (
        f"[families] ogive c128 n_iter={OGIVE_CAP} update {update!r} step {step:g} "
        f"tol={tol:.6g} (aimed at epoch {e_aim}): "
        f"the oracle stops after "
        f"{len(epochs_o)} epochs, the port after {int(epochs_t[0])}; callback chunks "
        f"(callback_every={OGIVE_EVERY}) {len(chunks_t)}, oracle {chunks_o} (cap "
        f"{OGIVE_CAP // OGIVE_EVERY}); max|dY| / max|Y| at the stop {d_y:.2e} (printed)"
    )
    if int(epochs_t[0]) != len(epochs_o) or len(chunks_t) != chunks_o:
        raise AssertionError(line)
    log(line)
    # the default complex64 run: its epochs and host reads of done
    ogive_mod.ogive_iterations.done_reads = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Yog, epochs = api.ogive_batch(X[None], return_epochs=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(
        f"[families] ogive c64 defaults (n_iter=4000, step 0.1, tol 1e-3): "
        f"{int(epochs[0])} epochs, {ogive_mod.ogive_iterations.done_reads} host reads of "
        f"done (chunks of {ogive_mod.CHUNK}), {wall * 1e3:.2f} ms wall, finite "
        f"{bool(torch.isfinite(Yog).all())} (information only)"
    )

    # --- times, device ops per epoch and device-busy share
    runs = [
        ("overiva_iss", 30, lambda k: api.overiva_iss(X, n_src=N, n_iter=k)),
        ("overiva_ip2", 10, lambda k: api.overiva_ip2(X, n_src=N, n_iter=k)),
        ("overiva_ip2 bf16pack", 10,
         lambda k: api.overiva_ip2(X, n_src=N, n_iter=k, wcov="bf16pack")),
        ("five", 10, lambda k: api.five(X, n_iter=k)),
        ("ogive (tol 0)", 200, lambda k: api.ogive(X, n_iter=k, tol=0.0)),
    ]
    times = {}
    for name, k, fn in runs:
        t = best_wall_s(lambda: fn(k))
        ops_k, busy = device_profile(lambda: fn(k))
        ops_0, _ = device_profile(lambda: fn(0))
        times[name] = t
        log(
            f"[families] {name} {k} it (T={X.shape[0]}, F={X.shape[1]}, M={M}, c64): "
            f"{t * 1e3:.2f} ms best of 3 "
            f"= {k / t:.1f} it/s, {t * 1e3 / k:.3f} ms an epoch; device ops an epoch "
            f"{(ops_k - ops_0) / k:.1f}; device busy (profiler) {busy:.2f} ms = "
            f"{100 * busy / (t * 1e3):.1f} % of the best wall; api.overiva 30 it "
            f"{main['eager_s'] * 1e3:.2f} ms"
        )
    return ip2_launches


# phase 8's c128 rows: (entry point, arguments, names of the outputs, gate).
# ILRMA is held element-wise at the JAX package's tolerance (rtol, atol;
# tests/test_ilrma.py). The others are held at max|port - oracle| /
# max|oracle| of each output, 10x the largest such figure the port
# measured on the CPU on this mixture cut to nfft 1024
# (tests/test_torch_tf_headline.py::MEASURED). With 3 talkers in 8 mics
# the solves are ill-conditioned: FastMNMF's Q (whitened on a near-
# degenerate noise subspace) and SparseAuxIVA's W (the inverse of the
# reconstructed mixing) carry the largest errors.
TF_C128 = [
    ("ilrma", {"n_iter": 8}, "YW", (1e-6, 1e-9)),
    ("fastmnmf2", {"n_src": N, "n_iter": 5}, "YQgWH", 2.88e-10),
    ("fastmnmf", {"n_src": N, "n_iter": 5}, "YQgWH", 2.88e-10),
    ("sparseauxiva", {"lasso_iter": 50}, "YW", 2.01e-8),
]


def at_epochs(fn, epochs):
    """{epochs: outputs} of one run of ``fn`` to the last count; an earlier
    count is the snapshot a callback takes every epochs[0]."""
    snaps = []
    cb = snaps.append if len(epochs) > 1 else None
    out = {epochs[-1]: fn(n_iter=epochs[-1], callback=cb, callback_every=epochs[0])}
    return out | {e: snaps[e // epochs[0]] for e in epochs[:-1]}


def oracle_job(name, X, epochs=(), **kw):
    """One f64 oracle run, in a worker process: (outputs, seconds). With
    ``epochs``, {epochs: Y} of one run (:func:`at_epochs`). main() submits
    phase 8's runs when the script starts, so that they overlap phases
    4-7 on the host's other cores."""
    from overiva_tpu_torch import oracle

    fn = getattr(oracle, name)
    t0 = time.perf_counter()
    out = at_epochs(lambda **k: fn(X, **kw, **k), epochs) if epochs else fn(X, **kw)
    return out, time.perf_counter() - t0


# The JAX package's FastMNMF2/1 on parity_check's seed-7 scene in complex64,
# from the complex64 whitening start with its noise eigenspace turned by
# each of five seeded unitaries: |dSDR| and |dSIR| (dB) against the f64
# oracle, least and most over the rotations (`python
# tests/test_torch_fastmnmf_rotation.py`, on the CPU; ROADMAP "Known
# complex64 floors")
FASTMNMF_JAX_ROTATION_SPREAD = {
    "fastmnmf2": ((0.0429, 0.9743), (0.1356, 2.4744)),
    "fastmnmf": ((0.0591, 0.8895), (0.1309, 2.3716)),
}


def fastmnmf_seed7(dev, oracle_jobs):
    """Prints seed 7's complex64 FastMNMF2/1 deltas on the card against the
    f64 oracle (parity_check's row) beside the JAX function's spread over
    rotations of its start: a complex64 floor of the reference, printed."""
    from overiva_tpu_torch import api
    from overiva_tpu_torch.examples import fastmnmf_stages
    from overiva_tpu_torch.parallel import dryrun

    mix, premix, _ = oracle_jobs["seed 7", "scene"].result()
    ref = oracle_jobs["seed 7", "oracle"].result()
    for name, (sdr_range, sir_range) in FASTMNMF_JAX_ROTATION_SPREAD.items():
        got = fastmnmf_stages.run_pipeline(
            lambda X: getattr(api, name)(X, n_src=fastmnmf_stages.N_SRC,
                                         n_iter=fastmnmf_stages.N_ITER,
                                         seed=fastmnmf_stages.NMF_SEED, device=dev),
            mix, premix, fastmnmf_stages.NFFT)
        d_sdr, d_sir = dryrun.delta(got, ref[name])
        log(f"[tf-families] c64 {name} on parity_check's seed 7 (M=5, N=2, nfft 1024, "
            f"{fastmnmf_stages.N_ITER} it) on the card: |dSDR| {d_sdr:.4f}, |dSIR| {d_sir:.4f} dB "
            f"against the f64 oracle; the JAX function from 5 rotations of its complex64 "
            f"start's noise eigenspace (CPU): |dSDR| {sdr_range[0]:.4f}-{sdr_range[1]:.4f}, "
            f"|dSIR| {sir_range[0]:.4f}-{sir_range[1]:.4f} (printed: a complex64 floor of the "
            f"reference; the c128 rows above are the gate)")


# phase 8's c64 rows: name, arguments, outputs scored by correlation,
# epochs gated, printed. SparseAuxIVA is printed: at 8 outputs its complex64
# runs sit up to a few dB SIR from the f64 oracle, the oracle's own complex64
# run included (printed beside it), while its c128 row holds
TF_C64 = [
    ("ilrma", {}, True, (), (8,)),
    ("fastmnmf2", {"n_src": N}, False, (12,), (30,)),
    ("fastmnmf", {"n_src": N}, False, (12,), ()),
    ("sparseauxiva", {}, True, (), (20,)),
]
# the full-band IP epochs that api.sparseauxiva runs after its n_iter (polish_iter)
SPARSE_POLISH = 3


def submit_tf_oracles(pool, X64):
    """Phase 8's f64 oracle runs on ``pool``: {("c128", name): the c128
    row's run with its filters, ("c64", name): the c64 row's {epochs: Y}
    where the c128 run does not give it, ("c64 input", "sparseauxiva"):
    the oracle on the complex64-rounded STFT, ("seed 7", "scene") and
    ("seed 7", "oracle"): parity_check's seed-7 scene and its FastMNMF2/1
    oracle scores}."""
    jobs = {("c128", name): pool.submit(oracle_job, name, X64, return_filters=True, **kw)
            for name, kw, _, _ in TF_C128}
    c128_epochs = {name: kw.get("n_iter") for name, kw, _, _ in TF_C128}
    for name, kw, _, gated, printed in TF_C64:
        epochs = tuple(sorted(gated + printed))
        if epochs != (c128_epochs[name],):
            jobs["c64", name] = pool.submit(oracle_job, name, X64, epochs, **kw)
    jobs["c64 input", "sparseauxiva"] = pool.submit(oracle_job, "sparseauxiva",
                                                    X64.astype(np.complex64))
    from overiva_tpu_torch.examples import fastmnmf_stages

    jobs["seed 7", "scene"] = pool.submit(fastmnmf_stages.parity_scene, 7)
    jobs["seed 7", "oracle"] = pool.submit(fastmnmf_stages.oracle_scores, 7)
    return jobs


def _flat_outputs(out):
    """(Y, W) or (Y, (Q, g, W, H)) -> a flat tuple of NumPy arrays."""
    Y, rest = out
    rest = rest if isinstance(rest, tuple) else (rest,)
    return tuple(np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a) for a in (Y, *rest))


def phase_tf_families(dev, mix, images, X64, main, oracle_jobs):
    """ILRMA, FastMNMF2/1 and SparseAuxIVA on phase 5's mixture: c128
    against the f64 oracle copies, c64 quality through iSTFT and bss_eval,
    ``wcov_packed`` in both IP phases of SparseAuxIVA's bf16pack tier, the
    counters of every other run at 0, and times. The oracle runs are
    ``oracle_jobs`` (:func:`submit_tf_oracles`). Returns SparseAuxIVA's
    bf16pack launches."""
    from overiva_tpu_torch import api, oracle
    from overiva_tpu_torch.models import sparseauxiva as sparse_mod
    from overiva_tpu_torch.models.family import run_family
    from overiva_tpu_torch.ops.update_rows import update_rows
    from overiva_tpu_torch.ops.wcov_packed import wcov_packed
    from overiva_tpu_torch.oracle.sparseauxiva import _resolve_n_bins

    n = mix.shape[0]
    start = NFFT - HOP
    X128 = torch.from_numpy(X64).to(dev)

    # --- c128 on the card against the f64 oracle; the oracle's outputs are
    # kept for the c64 rows at the same epoch count
    oracle_y = {}
    for name, kw, names, gate in TF_C128:
        t0 = time.perf_counter()
        got = _flat_outputs(getattr(api, name)(X128, dtype=torch.complex128,
                                               return_filters=True, **kw))
        t_port = time.perf_counter() - t0
        want, t_oracle = oracle_jobs["c128", name].result()
        want = _flat_outputs(want)
        oracle_y[name, kw.get("n_iter")] = want[0]
        parts, bad = [], []
        for q, a, b in zip(names, got, want):
            d = np.abs(a - b)
            rel = d.max() / np.abs(b).max()
            if isinstance(gate, tuple):
                rtol, atol = gate
                outside = int(np.sum(d > atol + rtol * np.abs(b)))
                parts.append(f"{q} {rel:.2e} ({outside} of {b.size} outside)")
                ok = outside == 0
            else:
                parts.append(f"{q} {rel:.2e}")
                ok = rel <= gate
            if a.shape != b.shape or not ok:
                # where it misses: the (bin, ...) index of the largest error
                bad.append(f"{q} worst at {np.unravel_index(d.argmax(), d.shape)}")
        tol = (f"rtol {gate[0]:g} atol {gate[1]:g} element-wise" if isinstance(gate, tuple)
               else f"gate {gate:g}")
        line = (
            f"[tf-families] c128 {name} {kw} vs f64 oracle: max|d| / max|oracle| "
            + ", ".join(parts) + f" ({tol}); port {t_port:.2f} s, oracle {t_oracle:.2f} s "
            "(a worker process)"
        )
        if bad:
            raise AssertionError(line + "; " + "; ".join(bad))
        log(line)
    fastmnmf_seed7(dev, oracle_jobs)

    # --- c64 quality through iSTFT and bss_eval, each run's counters read
    x = torch.from_numpy(oracle.stft_pad(mix, NFFT, HOP)).to(dev)
    X = api.stft_analysis(x, NFFT, device=dev)

    def synth(Y):
        return api.stft_synthesis(Y, NFFT, device=dev)[start : start + n].cpu().numpy()

    def oracle_synth(Y):
        return oracle.synthesis(Y, NFFT, HOP)[start : start + n]

    def counted(fn):
        """(outputs of fn, its launches of wcov_packed and update_rows);
        the outputs are a tensor or a dict of them, each checked finite."""
        wcov_packed.launches = 0
        update_rows.launches = 0
        out = fn()
        torch.cuda.synchronize()
        for Y in out.values() if isinstance(out, dict) else (out,):
            if not bool(torch.isfinite(Y).all()):
                raise AssertionError("non-finite output")
        return out, wcov_packed.launches, update_rows.launches

    sirs = {}
    for name, kw, picked, gated, printed in TF_C64:
        epochs = sorted(gated + printed)
        outs, n_pk, n_fused = counted(lambda: at_epochs(
            lambda **k: getattr(api, name)(X, device=dev, **kw, **k), epochs))
        # SparseAuxIVA's IP epochs (its n_iter, then the polish) take the fused update
        n_ip = epochs[-1] + SPARSE_POLISH if name == "sparseauxiva" else 0
        if all((name, e) in oracle_y for e in epochs):
            outs_o = {e: oracle_y[name, e] for e in epochs}
        else:
            outs_o = oracle_jobs["c64", name].result()[0]
        scorer = score_picked if picked else (lambda y, im: score(y, im, n))
        for e in epochs:
            (sdr, sir), (sdr_o, sir_o) = scorer(synth(outs[e]), images), scorer(
                oracle_synth(outs_o[e]), images)
            d_sdr, d_sir = np.abs(sdr - sdr_o).max(), np.abs(sir - sir_o).max()
            sirs[name, e] = sir
            line = (
                f"[tf-families] c64 {name} {kw} {e} it: SDR {np.round(sdr, 3)} SIR "
                f"{np.round(sir, 3)}, oracle SDR {np.round(sdr_o, 3)} SIR {np.round(sir_o, 3)}; "
                f"max|dSDR| {d_sdr:.4f} dB, max|dSIR| {d_sir:.4f} dB "
                + ("(tol 0.1)" if e in gated else "(printed)")
                + f"; launches of wcov_packed {n_pk}, of update_rows {n_fused} (want 0, "
                f"{n_ip}: the IP epochs)"
            )
            if (e in gated and not (d_sdr < 0.1 and d_sir < 0.1)) or (n_pk, n_fused) != (
                    0, n_ip):
                raise AssertionError(line)
            log(line)
        if name == "sparseauxiva":  # the oracle's own complex64 run
            sdr_32, sir_32 = scorer(oracle_synth(
                oracle_jobs["c64 input", "sparseauxiva"].result()[0]), images)
            log(
                f"[tf-families] c64 sparseauxiva: the oracle on the complex64 input "
                f"SDR {np.round(sdr_32, 3)} SIR {np.round(sir_32, 3)}; max|dSDR| "
                f"{np.abs(sdr_32 - sdr_o).max():.4f} dB, max|dSIR| "
                f"{np.abs(sir_32 - sir_o).max():.4f} dB from its float64 run (printed)"
            )

    # --- the packed kernel in both IP phases of SparseAuxIVA: 20 epochs on
    # ceil(F/4) = 513 selected bins, then 3 polish epochs on all 2049
    sp_runs = {wcov: counted(lambda: api.sparseauxiva(X, wcov=wcov, device=dev))
               for wcov in ("bf16pack", "bf16")}
    sp_launches = sp_runs["bf16pack"][1]
    sp_sir = {w: score_picked(synth(r[0]), images)[1] for w, r in sp_runs.items()}
    d = {w: abs(sp_sir["bf16pack"].mean() - s.mean()) for w, s in
         (("f32", sirs["sparseauxiva", 20]), ("bf16", sp_sir["bf16"]))}
    line = (
        f"[tf-families] sparseauxiva bf16pack: launches of wcov_packed {sp_launches} (want 23), "
        f"plain bf16 {sp_runs['bf16'][1]} (want 0); SIR bf16pack {np.round(sp_sir['bf16pack'], 3)}, "
        f"bf16 {np.round(sp_sir['bf16'], 3)}, f32 {np.round(sirs['sparseauxiva', 20], 3)}; mean SIR "
        f"of bf16pack differs from f32 by {d['f32']:.4f} dB (tol 0.3), from plain bf16 by "
        f"{d['bf16']:.4f} dB"
    )
    if (sp_launches != 23 or sp_runs["bf16"][1] != 0 or not d["f32"] < 0.3
            or any(r[2] for r in sp_runs.values())):
        raise AssertionError(line)
    log(line)

    # --- times, device ops an epoch and device-busy share
    runs = [
        ("ilrma", 10, lambda k: api.ilrma(X, n_iter=k)),
        ("fastmnmf2", 10, lambda k: api.fastmnmf2(X, n_src=N, n_iter=k)),
        ("fastmnmf", 10, lambda k: api.fastmnmf(X, n_src=N, n_iter=k)),
    ]
    for name, k, fn in runs:
        t = best_wall_s(lambda: fn(k))
        ops_k, busy = device_profile(lambda: fn(k))
        ops_0, _ = device_profile(lambda: fn(0))
        log(
            f"[tf-families] {name} {k} it (T={X.shape[0]}, F={X.shape[1]}, M={M}, c64): "
            f"{t * 1e3:.2f} ms best of 3 = {k / t:.1f} it/s, {t * 1e3 / k:.3f} ms an epoch; "
            f"device ops an epoch {(ops_k - ops_0) / k:.1f}; device busy (profiler) "
            f"{busy:.2f} ms = {100 * busy / (t * 1e3):.1f} % of the best wall; api.overiva "
            f"30 it {main['eager_s'] * 1e3:.2f} ms"
        )
    # SparseAuxIVA's three phases apart, at its defaults
    F = X.shape[1]
    S = sparse_mod.select_bins(X[None], _resolve_n_bins(None, F, M))
    Xs = X[:, torch.as_tensor(S[0], device=dev), :]
    _, Ws = run_family(Xs, M, 20, "laplace", "ip")
    nfft, n_causal, n_acausal = 2 * (F - 1), NFFT // 4, NFFT // 16
    W_full = sparse_mod.sparse_reconstruct(Ws[None], S, F, nfft, n_causal, n_acausal, 300, 0.05)[0]
    phases = [
        ("subset IP", 20, lambda k: run_family(Xs, M, k, "laplace", "ip")),
        ("reconstruction (FISTA)", 300, lambda k: sparse_mod.sparse_reconstruct(
            Ws[None], S, F, nfft, n_causal, n_acausal, k, 0.05)),
        ("polish IP", 3, lambda k: run_family(X, M, k, "laplace", "ip", W0=W_full)),
    ]
    total = best_wall_s(lambda: api.sparseauxiva(X))
    for name, k, fn in phases:
        t = best_wall_s(lambda: fn(k))
        ops_k, busy = device_profile(lambda: fn(k))
        ops_0, _ = device_profile(lambda: fn(0))
        log(
            f"[tf-families] sparseauxiva {name}, {k} steps (k={Xs.shape[1]} of F={F} bins, "
            f"M={M}, c64): {t * 1e3:.2f} ms best of 3 = {t * 1e3 / k:.3f} ms a step; device "
            f"ops a step {(ops_k - ops_0) / k:.1f}; device busy (profiler) {busy:.2f} ms = "
            f"{100 * busy / (t * 1e3):.1f} % of the best wall; whole sparseauxiva "
            f"{total * 1e3:.2f} ms"
        )
    return sp_launches


# phase 9: the joint dereverberation family. The room: every response a
# direct path plus a tail that decays by 60 dB in JOINT_RT60 seconds at
# JOINT_FS, so the delayed taps have work.
JOINT_FS, JOINT_RT60 = 16000, 0.4
JOINT_T = 512  # frames of the timed runs (bench.py's joint rows)
# the c128 rows: nfft 1024, 128 frames of the same room, a few epochs, so
# that the f64 oracle's CPU time stays near a minute (T-IP's 48-dim
# covariances dominate it)
C128_NFFT, C128_T = 1024, 128
# the registry names whose epochs are complex64 OverIVA-IP epochs of the f32
# tier, each one update_rows launch: {name: epochs beyond its n_iter}
REGISTRY_IP = {"auxiva": 0, "auxiva-gauss": 0, "auxiva_pca": 0, "overiva": 0,
               "overiva-gauss": 0, "sparseauxiva": SPARSE_POLISH}
JOINT_C128 = [
    ("wpe", {"taps": 5, "delay": 2, "n_iter": 2}),
    ("tiss", {"n_src": N, "taps": 5, "delay": 2, "n_iter": 4}),
    ("tip", {"n_src": N, "taps": 5, "delay": 2, "n_iter": 2, "warm_iter": 2}),
    ("ilrma_t", {"taps": 5, "delay": 2, "n_iter": 4}),
]
# the c64 quality rows: examples/parity_check.py's joint rows (PARITY.md,
# gated at 0.1 dB) on a 4 s clip of the same room at nfft 1024: 5 mics
# (ILRMA-T, determined: 3), the room's 3 talkers
QUALITY_NFFT, QUALITY_SAMPLES, QUALITY_M = 1024, 64000, 5


def make_reverb_mixture(rng, n_src, n_mics, n_samples, snr_db=30.0):
    """Convolutive mixture in a reverberant room: each response is
    make_mixture's 8-tap early part (a dominant direct path) and an
    exponentially decaying noise tail of JOINT_RT60 seconds (60 dB), with
    half the early part's energy. Returns (mix (n, M), images (n_src, n,
    M))."""
    from scipy.signal import fftconvolve

    src = make_sources(rng, n_src, n_samples)
    L = int(JOINT_RT60 * JOINT_FS)
    t = np.arange(L)
    H = rng.standard_normal((n_mics, n_src, L)) * np.exp(-np.log(1e3) * t / L)
    H[:, :, :8] = rng.standard_normal((n_mics, n_src, 8))
    H[:, :, 0] += 2.0 * np.sign(H[:, :, 0])
    early = np.sum(H[:, :, :8] ** 2, axis=2, keepdims=True)
    tail = np.sum(H[:, :, 8:] ** 2, axis=2, keepdims=True)
    H[:, :, 8:] *= np.sqrt(0.5 * early / tail)
    images = np.stack([
        fftconvolve(src[k][None, :], H[:, k, :], axes=1)[:, :n_samples].T
        for k in range(n_src)
    ])
    mix = images.sum(axis=0)
    noise = rng.standard_normal(mix.shape)
    noise *= np.linalg.norm(mix) / np.linalg.norm(noise) * 10 ** (-snr_db / 20)
    return mix + noise, images


def phase_joint(dev, seed, main):
    """WPE, T-ISS, T-IP and ILRMA-T in a reverberant room: c128 against the
    f64 oracle copies element by element (and the -df registry names), c64
    quality through iSTFT and bss_eval against the f64 oracle (PARITY.md's
    joint rows), times at the headline (T=512), the 30 registry names on
    the card, and on every joint run ``wcov_packed`` at 0 and ``update_rows``
    at the run's complex64 f32 OverIVA-IP epochs, a fixed count. Returns
    the launches of (wcov_packed, update_rows) over the joint runs."""
    from overiva_tpu_torch import api, oracle
    from overiva_tpu_torch.ops.update_rows import update_rows
    from overiva_tpu_torch.ops.wcov_packed import wcov_packed
    from overiva_tpu_torch.registry import ALGORITHMS, applicable

    t_mark = [time.perf_counter()]

    def mark(tag):
        now = time.perf_counter()
        log(f"[time] joint: {tag} {now - t_mark[0]:.1f} s")
        t_mark[0] = now

    rng = np.random.default_rng(seed + 9)
    mix, images = make_reverb_mixture(rng, N, M, samples_for_frames(JOINT_T))
    mark("the room's mixture")
    totals = [0, 0]

    def counted(fn, ip_epochs=0):
        """fn() with both counters zeroed just before and read just after:
        a joint run launches no ``wcov_packed``, and ``update_rows`` once for
        each of its ``ip_epochs`` complex64 OverIVA-IP epochs of the f32 tier
        (WPE -> OverIVA, the IP registry names)."""
        wcov_packed.launches = 0
        update_rows.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = (wcov_packed.launches, update_rows.launches)
        totals[0] += got[0]
        totals[1] += got[1]
        if got != (0, ip_epochs):
            raise AssertionError(f"a joint run launched (wcov_packed, update_rows) {got}, "
                                 f"want (0, {ip_epochs})")
        for Y in out if isinstance(out, tuple) else (out,) if out is not None else ():
            if not bool(torch.isfinite(torch.as_tensor(Y)).all()):
                raise AssertionError("non-finite joint output")
        return out

    # --- c128 on the card against the f64 oracle, element-wise, on the
    # complex64-rounded STFT, which the -df rows share
    hop = C128_NFFT // 2
    n1 = (C128_T - 1) * hop
    X1 = oracle.analysis(oracle.stft_pad(mix[:n1], C128_NFFT, hop), C128_NFFT, hop)
    X1 = X1.astype(np.complex64).astype(np.complex128)
    X1_dev = torch.from_numpy(X1).to(dev)
    oracle_out = {}
    for name, kw in JOINT_C128:
        filt = {} if name == "wpe" else {"return_filters": True}
        t0 = time.perf_counter()
        got = counted(lambda: getattr(api, name)(X1_dev, dtype=torch.complex128, **kw, **filt))
        t_port = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = getattr(oracle, name)(X1, **kw, **filt)
        t_oracle = time.perf_counter() - t0
        got, want = (got, want) if filt else ((got,), (want,))
        oracle_out[name] = want[0]
        parts, bad = [], False
        for q, a, b in zip("YP", got, want):
            a = a.cpu().numpy()
            d = np.abs(a - b)
            if name == "wpe":  # tests/test_wpe.py: 1e-8 of the largest output
                outside = int(np.sum(d > 1e-8 * np.abs(b).max()))
            else:
                outside = int(np.sum(d > 1e-8 + 1e-6 * np.abs(b)))
            parts.append(f"{q} {d.max() / np.abs(b).max():.2e} ({outside} of {b.size} outside)")
            bad |= a.shape != b.shape or outside > 0
        line = (
            f"[joint] c128 {name} {kw} (X {X1.shape}) vs f64 oracle: max|d| / max|oracle| "
            + ", ".join(parts)
            + (" (atol 1e-8 max|Y|)" if name == "wpe" else " (rtol 1e-6, atol 1e-8)")
            + f"; port {t_port:.2f} s, oracle {t_oracle:.2f} s"
        )
        if bad:
            raise AssertionError(line)
        log(line)
    # the certification names: complex128 on the complex64 input, complex64
    # out, within 1e-6 of the same oracle runs
    for name in ("tiss-df", "tip-df"):
        kw = dict(JOINT_C128[1 if name == "tiss-df" else 2][1])
        Y = counted(lambda: ALGORITHMS[name](X1_dev.to(torch.complex64), **kw))
        Yo = oracle_out[name[:-3]]
        d = np.abs(Y.cpu().numpy() - Yo).max() / np.abs(Yo).max()
        line = (f"[joint] {name} {kw}: complex64 out {Y.dtype == torch.complex64}, "
                f"max|d| / max|oracle| {d:.2e} (tol 1e-6)")
        if not (d < 1e-6 and Y.dtype == torch.complex64):
            raise AssertionError(line)
        log(line)

    mark("c128 rows")

    # --- c64 quality through iSTFT and bss_eval against the f64 oracle
    hop = QUALITY_NFFT // 2
    nq = QUALITY_SAMPLES
    Xq = oracle.analysis(oracle.stft_pad(mix[:nq], QUALITY_NFFT, hop), QUALITY_NFFT, hop)
    Xq5, Xq3 = Xq[:, :, :QUALITY_M], Xq[:, :, :N]
    Xq5_dev = torch.from_numpy(Xq5.astype(np.complex64)).to(dev)
    Xq3_dev = torch.from_numpy(Xq3.astype(np.complex64)).to(dev)
    q_images = images[:, :nq]
    rows = [  # (name, run, its IP epochs)
        ("tiss", lambda a, X5, X3: a.tiss(X5, n_src=N, taps=3, delay=2, n_iter=15), 0),
        ("tip", lambda a, X5, X3: a.tip(X5, n_src=N, taps=3, delay=2, n_iter=5, warm_iter=5),
         0),
        ("ilrma_t", lambda a, X5, X3: a.ilrma_t(X3, taps=3, delay=2, n_iter=15, seed=5), 0),
        ("wpe+overiva", lambda a, X5, X3: a.overiva(a.wpe(X5, taps=3, delay=2, n_iter=2),
                                                   n_src=N, n_iter=15), 15),
    ]

    def quality(Y):
        y = oracle.synthesis(np.asarray(Y), QUALITY_NFFT, hop)[QUALITY_NFFT - hop:][:nq]
        return score(y, q_images, nq)

    for name, run, ip_epochs in rows:
        Y = counted(lambda: run(api, Xq5_dev, Xq3_dev), ip_epochs).cpu().numpy()
        sdr, sir = quality(Y)
        sdr_o, sir_o = quality(run(oracle, Xq5, Xq3))
        d_sdr, d_sir = np.abs(sdr - sdr_o).max(), np.abs(sir - sir_o).max()
        line = (
            f"[joint] c64 {name} (X {Xq5.shape if name != 'ilrma_t' else Xq3.shape}): SDR "
            f"{np.round(sdr, 3)} SIR {np.round(sir, 3)}, oracle SDR {np.round(sdr_o, 3)} SIR "
            f"{np.round(sir_o, 3)}; max|dSDR| {d_sdr:.4f} dB, max|dSIR| {d_sir:.4f} dB (tol 0.1)"
        )
        if not (d_sdr < 0.1 and d_sir < 0.1):
            # the reference's own complex64 run, for the record, then fail
            sdr_32, sir_32 = quality(run(oracle, Xq5.astype(np.complex64),
                                         Xq3.astype(np.complex64)))
            log(line + f"; the oracle on the complex64 input: SDR {np.round(sdr_32, 3)} SIR "
                f"{np.round(sir_32, 3)}")
            raise AssertionError(line)
        log(line)

    mark("c64 quality rows")

    # --- times at the headline: device-resident STFT, T=512
    x = torch.from_numpy(oracle.stft_pad(mix, NFFT, HOP)).to(dev)
    X = api.stft_analysis(x, NFFT, device=dev)
    if X.shape != (JOINT_T, NFFT // 2 + 1, M):
        raise AssertionError(f"joint STFT shape {tuple(X.shape)}")
    runs = [  # (name, epochs, run, whether its epochs are OverIVA-IP ones)
        ("wpe (taps 5, delay 2)", 2, lambda k: api.wpe(X, taps=5, delay=2, n_iter=k), False),
        ("wpe 2 it -> overiva", 30,
         lambda k: api.overiva(api.wpe(X, taps=5, delay=2, n_iter=2), n_src=N, n_iter=k), True),
        ("tiss", 30, lambda k: api.tiss(X, n_src=N, n_iter=k), False),
        ("tip f32, after 10 T-ISS epochs", 10, lambda k: api.tip(X, n_src=N, n_iter=k), False),
        ("tip bf16, after 10 T-ISS epochs", 10,
         lambda k: api.tip(X, n_src=N, n_iter=k, wcov="bf16"), False),
        ("ilrma_t", 30, lambda k: api.ilrma_t(X, n_iter=k), False),
    ]
    for name, k, fn, ip in runs:
        Y = counted(lambda: fn(k), k if ip else 0)
        if Y.shape[:2] != X.shape[:2]:
            raise AssertionError(f"{name}: output shape {tuple(Y.shape)}")
        t = best_wall_s(lambda: fn(k))
        ops_k, busy = device_profile(lambda: fn(k))
        ops_0, _ = device_profile(lambda: fn(0))
        log(
            f"[joint] {name} {k} it (T={X.shape[0]}, F={X.shape[1]}, M={M}, N={N}, c64): "
            f"{t * 1e3:.2f} ms best of 3 = {t * 1e3 / k:.3f} ms an epoch; device ops an epoch "
            f"{(ops_k - ops_0) / k:.1f} (a run of 0 epochs: {ops_0}); device busy (profiler) "
            f"{busy:.2f} ms = {100 * busy / (t * 1e3):.1f} % of the best wall; api.overiva "
            f"30 it (T=128) {main['eager_s'] * 1e3:.2f} ms"
        )

    mark("timed runs")

    # --- the 30 registry names on the card: __call__ and run_batch
    rng_r = np.random.default_rng(seed + 10)
    mix_r = make_mixture(rng_r, 3, 3, 16000)[0]
    Xr = api.stft_analysis(torch.from_numpy(mix_r).to(dev), 256, device=dev)
    T, F, _ = Xr.shape
    t0 = time.perf_counter()
    for name, spec in sorted(ALGORITHMS.items()):
        n_src = next(n for n in (1, 2, 3) if applicable(name, n, 3))
        kw = {"n_iter": min(spec.defaults.get("n_iter", 3), 40 if spec.single_output else 3)}
        kw |= {"warm_iter": 2} if "warm_iter" in spec.defaults else {}
        kw |= {"lasso_iter": 20} if name == "sparseauxiva" else {}
        # an IP name's epochs, in one folded run for run_batch too
        ip_epochs = kw["n_iter"] + REGISTRY_IP[name] if name in REGISTRY_IP else 0
        Y = counted(lambda: spec(Xr, n_src=n_src, **kw), ip_epochs)
        Yb = counted(lambda: spec.run_batch(torch.stack([Xr, Xr.flip(0)]), n_src=n_src, **kw),
                     ip_epochs)
        if (Y.shape != (T, F, n_src) or Yb.shape != (2, T, F, n_src)
                or Y.device.type != dev.type or Yb.device.type != dev.type):
            raise AssertionError(f"registry {name}: {tuple(Y.shape)}, {tuple(Yb.shape)}")
    log(
        f"[joint] registry: all {len(ALGORITHMS)} names ran __call__ and run_batch on the card "
        f"(X {tuple(Xr.shape)}, c64, outputs on cuda, finite; no wcov_packed launch, "
        f"update_rows once an IP epoch of {sorted(REGISTRY_IP)}) in "
        f"{time.perf_counter() - t0:.2f} s"
    )

    mark("registry")

    # --- requests, samples in and out
    for algo, n_iter, opts in [("tiss", 30, {}), ("tip", 10, {}), ("ilrma_t", 30, {}),
                               ("ip", 30, {"wpe": True})]:
        # the requests check their own outputs; counted reads the launches: a
        # warm-up and three clips, each n_iter IP epochs under algo="ip"
        counted(lambda: phase_requests(dev, seed, algo, n_iter, "joint", **opts) and None,
                4 * n_iter if algo == "ip" else 0)
    mark("requests")
    return tuple(totals)


def phase_requests(dev, seed, algo="ip", n_iter=30, tag="requests", **opts):
    """``separate(algo=...)`` on three clips of 64, 128 and 256 frames,
    after one warm-up call; ``opts`` go to ``separate`` as they are.
    Returns {frames: ms}."""
    from overiva_tpu_torch import api

    rng = np.random.default_rng(seed + 1)
    clips = [make_mixture(rng, N, M, samples_for_frames(f))[0] for f in (64, 128, 256)]
    api.separate(clips[0], n_src=N, n_iter=n_iter, algo=algo, device=dev, **opts)  # warm-up
    times = {}
    for frames, clip in zip((64, 128, 256), clips):
        t0 = time.perf_counter()
        y = api.separate(clip, n_src=N, n_iter=n_iter, algo=algo, device=dev, **opts)
        ms = (time.perf_counter() - t0) * 1e3
        if y.shape != (clip.shape[0], N) or not np.isfinite(y).all():
            raise AssertionError(f"bad separate output {y.shape}")
        log(
            f"[{tag}] separate(algo={algo!r}, {n_iter} it"
            + "".join(f", {k}={v!r}" for k, v in opts.items())
            + f") {clip.shape[0]} samples x "
            f"{M} mics ({clip.shape[0] // HOP + 1} frames): {ms:.1f} ms, "
            "numpy in and out"
        )
        times[frames] = ms
    return times


# phase 10: streaming. The timed rows take bench.py:376-408's setting:
# 16 kHz, nfft 512, hop 256, 16-frame blocks (4096 samples = 256 ms of
# audio), n_pass 2, M=4 (and one online-iss row at the headline's M=8).
STREAM_FS, STREAM_NFFT, STREAM_HOP, STREAM_BF, STREAM_M = 16000, 512, 256, 16, 4
STREAM_TIMED, STREAM_WARM = 60, 2  # timed blocks (median and p95), untimed first
STREAM_PROFILED = 10  # blocks under torch.profiler for ops and busy time


def stream_room(seed, n_mics, n_samples):
    """examples/streaming.py's room (7 x 5 x 3 m, RT60 0.2 s, one
    speech-like talker per mic on a semicircle, a 4 cm circular array,
    25 dB SNR), built with the port's sim copy. Returns (mix (n, M),
    mic-0 images (n_src, n))."""
    from overiva_tpu_torch.sim import ShoeBox, circular_mic_array, semi_circle_layout, speech_like

    room = ShoeBox([7.0, 5.0, 3.0], fs=STREAM_FS, rt60=0.2, seed=seed)
    src_pos = semi_circle_layout([3.5, 3.5, 1.5], np.pi / 2, 1.8, n_mics)
    for k in range(n_mics):
        room.add_source(src_pos[k], speech_like(n_samples, STREAM_FS, seed=seed * 31 + k))
    room.add_mic_array(circular_mic_array([3.5, 2.2, 1.5], 0.04, n_mics))
    premix, noise = room.simulate(return_premix=True, snr=25.0)
    return (premix.sum(axis=0) + noise).T[:n_samples], premix[:, 0, :n_samples]


def parity_room(seed=7):
    """examples/parity_check.py's mixture (build_mixture, seed 7): two
    talkers, five mics, 4 s, RT60 0.22 s, 25 dB SNR, with the port's sim
    copy. Returns (mix (64000, 5), premix)."""
    from overiva_tpu_torch.sim import ShoeBox, circular_mic_array, semi_circle_layout, speech_like

    fs, n = 16000, 64000
    room = ShoeBox([7.0, 6.0, 3.0], fs=fs, rt60=0.22, seed=seed)
    for k, pos in enumerate(semi_circle_layout([3.5, 3.0, 1.5], np.pi / 2, 2.2, 2,
                                               rot=np.pi / 2)):
        room.add_source(pos, speech_like(n, fs, seed=seed * 13 + k))
    room.add_mic_array(circular_mic_array([3.5, 3.0, 1.5], 0.05, 5))
    premix, noise = room.simulate(return_premix=True, snr=25.0)
    return (premix.sum(axis=0) + noise).T[:n], premix


def stream_blocks(sep, X, B):
    """Run the STFT-domain class ``sep`` over X (T, F, M) in blocks of B
    frames (the last one partial); the outputs concatenated."""
    return torch.cat([torch.as_tensor(sep.process(X[s : s + B]))
                      for s in range(0, X.shape[0], B)])


def phase_streaming(dev, seed):
    """The streaming family: OnlineAuxIVAISS against the f64 oracle at
    complex128 (element-wise) and through bss_eval at complex64
    (examples/parity_check.py's stream row), OnlineTISS and OnlineWPE on
    the card against the CPU at complex128, StreamingSeparator against the
    STFT-domain class plus offline synthesis, warmup and save/restore
    mid-stream, three tensor-in blocks under the CUDA sync check, and the
    per-block latency, real-time factor, device ops and busy share at
    bench.py's streaming setting. Both kernel counters stay at 0 over the
    whole phase; returns (wcov_packed, update_rows) launches."""
    import tempfile

    from overiva_tpu_torch import api, oracle
    from overiva_tpu_torch.metrics import bss_eval_sources
    from overiva_tpu_torch.ops.update_rows import update_rows
    from overiva_tpu_torch.ops.wcov_packed import wcov_packed
    from overiva_tpu_torch.serving import StreamingSeparator

    t_mark = [time.perf_counter()]

    def mark(tag):
        now = time.perf_counter()
        log(f"[time] streaming: {tag} {now - t_mark[0]:.1f} s")
        t_mark[0] = now

    wcov_packed.launches = 0
    update_rows.launches = 0
    c128 = torch.complex128
    nfft, hop, B, M = STREAM_NFFT, STREAM_HOP, STREAM_BF, STREAM_M
    bs = B * hop
    n_blocks = STREAM_WARM + STREAM_TIMED
    mix4, refs4 = stream_room(seed, M, n_blocks * bs)
    mix8, _ = stream_room(seed, 8, n_blocks * bs)
    mark("the rooms (port sim copy)")

    def stft(mix):
        return oracle.analysis(oracle.stft_pad(mix, nfft, hop), nfft, hop)

    # --- c128 on the card against the f64 oracle, element by element
    X4 = stft(mix4[: 40 * bs])
    X4 = X4[: (X4.shape[0] // B) * B]
    F = X4.shape[1]
    opts = dict(forget=0.97, n_pass=2, pb_forget=0.9995)
    sep = api.OnlineAuxIVAISS(F, M, dtype=c128, device=dev, **opts)
    got = stream_blocks(sep, torch.from_numpy(X4).to(dev), B).cpu().numpy()
    want = oracle.online_iss_run(X4, B, **opts)
    d = np.abs(got - want)
    outside = int(np.sum(d > 1e-10 + 1e-8 * np.abs(want)))
    line = (f"[stream] c128 OnlineAuxIVAISS {opts} (X {X4.shape}, blocks of {B}) vs f64 "
            f"oracle online_iss_run: max|d| / max|oracle| {d.max() / np.abs(want).max():.2e}, "
            f"{outside} of {d.size} outside rtol 1e-8, atol 1e-10")
    if outside or got.shape != want.shape:
        raise AssertionError(line)
    log(line)

    # --- c64 quality: examples/parity_check.py's "online-iss M=N=2
    # (stream)" row, gated at 0.1 dB SDR/SIR against the f64 oracle
    pmix, premix = parity_room()
    qn = 1024
    Xq = oracle.analysis(oracle.stft_pad(pmix, qn, qn // 2), qn, qn // 2)[:, :, :2]

    def quality(Y):
        y = oracle.synthesis(np.asarray(Y), qn, qn // 2)[qn - qn // 2 :][: pmix.shape[0]]
        sdr, sir, _, _ = bss_eval_sources(premix[:, 0, : pmix.shape[0]], y.T)
        return sdr, sir

    sep = api.OnlineAuxIVAISS(Xq.shape[1], 2, forget=0.985, n_pass=2, device=dev)
    Yq = stream_blocks(sep, torch.from_numpy(Xq.astype(np.complex64)).to(dev), 25)
    sdr, sir = quality(Yq.cpu().numpy())
    sdr_o, sir_o = quality(oracle.online_iss_run(Xq, 25, forget=0.985, n_pass=2))
    d_sdr, d_sir = np.abs(sdr - sdr_o).max(), np.abs(sir - sir_o).max()
    line = (f"[stream] c64 online-iss M=N=2 (stream) (X {Xq.shape}, blocks of 25, forget "
            f"0.985, n_pass 2): SDR {np.round(sdr, 3)} SIR {np.round(sir, 3)}, oracle SDR "
            f"{np.round(sdr_o, 3)} SIR {np.round(sir_o, 3)}; max|dSDR| {d_sdr:.4f} dB, "
            f"max|dSIR| {d_sir:.4f} dB (tol 0.1)")
    if not (d_sdr < 0.1 and d_sir < 0.1):
        raise AssertionError(line)
    log(line)
    mark("c128 and c64 gates")

    # --- c128 rows, printed: the card against the port's own CPU run,
    # and OnlineTISS at taps=0 against OnlineAuxIVAISS on the card
    X4s = X4[: 12 * B]
    rows = [
        ("OnlineTISS solve (taps 4, delay 2)", api.OnlineTISS,
         dict(taps=4, delay=2, forget=0.97, n_pass=2)),
        ("OnlineTISS steer (taps 4, delay 2)", api.OnlineTISS,
         dict(taps=4, delay=2, forget=0.97, n_pass=2, tap_update="steer")),
        ("OnlineWPE (taps 8, delay 2)", api.OnlineWPE, dict(taps=8, delay=2)),
    ]
    for name, cls, kw in rows:
        on_card = stream_blocks(cls(F, M, dtype=c128, device=dev, **kw),
                                torch.from_numpy(X4s).to(dev), B).cpu().numpy()
        on_cpu = stream_blocks(cls(F, M, dtype=c128, device="cpu", **kw),
                               torch.from_numpy(X4s), B).numpy()
        d = np.abs(on_card - on_cpu).max() / np.abs(on_cpu).max()
        log(f"[stream] c128 {name} (X {X4s.shape}): card vs CPU max|d| / max|CPU| {d:.2e}")
    tiss0 = api.OnlineTISS(F, M, taps=0, forget=0.97, n_pass=2, dtype=c128, device=dev)
    iss = api.OnlineAuxIVAISS(F, M, forget=0.97, n_pass=2, dtype=c128, device=dev)
    Xs = torch.from_numpy(X4s).to(dev)
    d = (stream_blocks(tiss0, Xs, B) - stream_blocks(iss, Xs, B)).abs().max().item()
    log(f"[stream] c128 OnlineTISS taps=0 vs OnlineAuxIVAISS on the card: max|d| {d:.2e}")

    # --- StreamingSeparator against the STFT-domain class + offline
    # synthesis of the same frames (tests/test_serving.py's tolerance)
    n_s = 12 * bs
    xs = mix4[:n_s]
    xp = np.concatenate([np.zeros((nfft - hop, M)), xs])
    Xo = api.stft_analysis(torch.from_numpy(xp).to(dev), nfft, hop, dtype=c128)
    for algo, cls, kw in [("online-iss", api.OnlineAuxIVAISS, {}),
                          ("online-tiss", api.OnlineTISS, dict(taps=4, delay=2))]:
        ss = StreamingSeparator(algo, n_chan=M, nfft=nfft, hop=hop, block_frames=B,
                                forget=0.97, n_pass=2, dtype=c128, device=dev, **kw)
        y_stream = np.concatenate([ss.process(xs[i * bs : (i + 1) * bs])
                                   for i in range(n_s // bs)] + [ss.flush()])
        ref = cls(F, M, forget=0.97, n_pass=2, dtype=c128, device=dev, **kw)
        y_ref = api.stft_synthesis(stream_blocks(ref, Xo, B), nfft, hop, dtype=c128)
        y_ref = y_ref.cpu().numpy()
        scale = np.abs(y_ref).max()
        d = np.abs(y_stream - y_ref)
        outside = int(np.sum(d > 1e-10 * scale + 1e-8 * np.abs(y_ref)))
        line = (f"[stream] c128 StreamingSeparator {algo} vs {cls.__name__} + offline "
                f"synthesis ({n_s} samples x {M} mics): max|d| / max|y| {d.max() / scale:.2e}, "
                f"{outside} outside rtol 1e-8, atol 1e-10 max|y|")
        if outside or y_stream.shape != y_ref.shape:
            raise AssertionError(line)
        log(line)

    # --- warmup mid-stream and save -> restore -> the next block, at c64
    xb = [mix4[i * bs : (i + 1) * bs] for i in range(5)]
    ref = StreamingSeparator("online-tiss", n_chan=M, nfft=nfft, block_frames=B, n_pass=2,
                             device=dev)
    want = [ref.process(b) for b in xb]
    sep = StreamingSeparator("online-tiss", n_chan=M, nfft=nfft, block_frames=B, n_pass=2,
                             device=dev)
    got = [sep.process(b) for b in xb[:2]]
    sep.warmup()
    got += [sep.process(b) for b in xb[2:4]]
    with tempfile.TemporaryDirectory() as tmp:
        path = sep.save(f"{tmp}/stream.npz", note="mid-stream")
        new = StreamingSeparator("online-tiss", n_chan=M, nfft=nfft, block_frames=B,
                                 n_pass=2, device=dev)
        meta = new.restore(path)
    after = new.process(xb[4])
    same_warm = all(np.array_equal(a, b) for a, b in zip(got, want[:4]))
    same_restore = np.array_equal(after, want[4]) and meta["note"] == "mid-stream"
    line = (f"[stream] StreamingSeparator online-tiss c64 on the card: warmup() after block 2 "
            f"changes no later block: {same_warm}; save -> restore into a new instance -> "
            f"block 5 identical: {same_restore}")
    if not (same_warm and same_restore):
        raise AssertionError(line)
    log(line)

    # --- no host sync: three tensor-in blocks on the card
    X4d = torch.from_numpy(X4.astype(np.complex64)).to(dev)
    for name, sep in [("OnlineAuxIVAISS", api.OnlineAuxIVAISS(F, M, n_pass=2, device=dev)),
                      ("OnlineTISS", api.OnlineTISS(F, M, taps=4, delay=2, n_pass=2,
                                                    device=dev))]:
        sep.process(X4d[:B])  # first call: set-up outside the check
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(1, 4):
                sep.process(X4d[i * B : (i + 1) * B])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        log(f"[stream] {name}: three tensor-in blocks ran under "
            "torch.cuda.set_sync_debug_mode('error'): no host sync")
    mark("c128 rows, streamed vs offline, warmup, checkpoint, sync")

    # --- timed rows: warm per-block latency over STREAM_TIMED blocks, every
    # row timed before any is profiled (a profiler session can leave
    # tracing costs behind on the host)
    rows = []

    def timed_row(name, process, blocks, m):
        for blk in blocks[:STREAM_WARM]:
            process(blk)
        torch.cuda.synchronize()
        lat = []
        for blk in blocks[STREAM_WARM:]:
            t0 = time.perf_counter()
            process(blk)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        rows.append((name, process, blocks, m, np.asarray(lat) * 1e3))

    for name, m, mix, kw in [
        ("StreamingSeparator online-iss, NumPy in and out", M, mix4, {}),
        ("StreamingSeparator online-tiss (taps 4, delay 2), NumPy in and out", M, mix4,
         dict(taps=4, delay=2)),
        ("StreamingSeparator online-iss, NumPy in and out", 8, mix8, {}),
    ]:
        algo = "online-tiss" if kw else "online-iss"
        ss = StreamingSeparator(algo, n_chan=m, nfft=nfft, hop=hop, block_frames=B,
                                n_pass=2, device=dev, **kw)
        ss.warmup()
        blocks = [np.ascontiguousarray(mix[i * bs : (i + 1) * bs], dtype=np.float32)
                  for i in range(n_blocks)]
        timed_row(name, ss.process, blocks, m)
    Xt = api.stft_analysis(torch.from_numpy(oracle.stft_pad(mix4, nfft, hop)).to(dev), nfft,
                           hop, device=dev)
    blocks = [Xt[i * B : (i + 1) * B] for i in range(n_blocks)]
    for name, sep in [
        ("OnlineAuxIVAISS, tensor in and out", api.OnlineAuxIVAISS(F, M, n_pass=2, device=dev)),
        ("OnlineTISS (taps 4, delay 2), tensor in and out",
         api.OnlineTISS(F, M, taps=4, delay=2, n_pass=2, device=dev)),
        ("OnlineWPE (taps 8, delay 2), tensor in and out",
         api.OnlineWPE(F, M, taps=8, delay=2, device=dev)),
    ]:
        timed_row(name, sep.process, blocks, M)
    audio_ms = bs / STREAM_FS * 1e3
    for name, process, blocks, m, lat in rows:
        ops, busy = device_profile(
            lambda: [process(b) for b in blocks[STREAM_WARM : STREAM_WARM + STREAM_PROFILED]])
        med, p95 = float(np.median(lat)), float(np.percentile(lat, 95))
        log(
            f"[stream] {name} (M={m}, F={nfft // 2 + 1}, {B}-frame blocks of {bs} samples = "
            f"{audio_ms:.0f} ms, n_pass 2, c64): median {med:.3f} ms, p95 {p95:.3f} ms over "
            f"{len(lat)} warm blocks; real-time factor {audio_ms / med:.1f}; device ops a block "
            f"{ops / STREAM_PROFILED:.1f}; device busy {busy / STREAM_PROFILED:.3f} ms a block "
            f"= {100 * busy / STREAM_PROFILED / med:.1f} % of the median wall"
        )
    mark("timed rows")

    torch.cuda.synchronize()
    got = (wcov_packed.launches, update_rows.launches)
    line = f"[stream] kernel launches over the streaming phase (wcov_packed, update_rows): {got}"
    if got != (0, 0):
        raise AssertionError(line + " (want (0, 0))")
    log(line)
    return got

# phase 11: the clip-serving tier. Clips of 64 / 128 / 256 real frames at
# the headline widths land in buckets 72 / 152 / 304 of the default grid,
# so every clip pads; the 128-frame clip is phase 5's mixture.
SERVE_FRAMES = (64, 128, 256)
SERVE_TIMED = 10  # timed requests a length and tier (median and p95), after one warm call


def oracle_scores(mix, images, nfft, hop):
    """(SDR, SIR) of the f64 oracle's 30-iteration OverIVA on ``mix``, as
    phase 5 scores it; phase 11 runs it in a worker process while the card
    works."""
    from overiva_tpu_torch import oracle

    X = oracle.analysis(oracle.stft_pad(mix, nfft, hop), nfft, hop)
    y = oracle.synthesis(oracle.overiva(X, n_src=N, n_iter=30), nfft, hop)
    n = mix.shape[0]
    return score(y[nfft - hop : nfft - hop + n], images, n)


def to_pcm16(x):
    """int16 PCM of a float clip, its peak at 20000."""
    return np.clip(np.round(x / np.abs(x).max() * 20000), -32768, 32767).astype(np.int16)


def pcm16_host(y):
    """The host's int16 quantization of float samples (a wav writer's):
    round half to even at 32768, saturating."""
    return np.clip(np.round(y * y.dtype.type(32768.0)), -32768.0, 32767.0).astype(np.int16)


def serve_clips(seed):
    """Phase 11's 64- and 256-frame clips, {frames: (mix, images)}, from
    phase 5's generator (the 128-frame clip is phase 5's mixture)."""
    rng = np.random.default_rng(seed + 11)
    return {f: make_mixture(rng, N, M, samples_for_frames(f)) for f in (64, 256)}


def phase_serving(dev, clips, oracle_futures, main, requests_ms):
    """The clip-serving tier at the headline widths: Separator("overiva")
    f32 and bf16pack, NumPy float and int16 PCM in and out, at 64 / 128 /
    256 real frames (``clips``: {frames: (mix, images)}); exactness at
    complex128 against the unpadded pipeline on the card, the int16 tiers
    bit for bit, the launch counts, separate_batch against per-clip,
    warmup, every SERVABLE name at a 3-mic STFT, the oneshot and
    parity_check CLI twins, quality against the f64 oracle (its 64- and
    256-frame runs are ``oracle_futures``, computed in worker processes
    since the script started; phase 5 scored the 128-frame one), then the
    request latency (median and p95) with device ops and busy share.
    Returns the wcov_packed launches [f32 clip, bf16pack clip, bf16pack
    group of three] and update_rows' over the phase (30 an f32 clip, gated
    where the clips are counted)."""
    import contextlib
    import io

    from overiva_tpu_torch import api, oracle
    from overiva_tpu_torch.examples import oneshot, parity_check
    from overiva_tpu_torch.ops.update_rows import update_rows
    from overiva_tpu_torch.ops.wcov_packed import wcov_packed
    from overiva_tpu_torch.registry import get_algorithm
    from overiva_tpu_torch.serving import SERVABLE, Separator

    t_mark = [time.perf_counter()]

    def mark(tag):
        now = time.perf_counter()
        log(f"[time] serving: {tag} {now - t_mark[0]:.1f} s")
        t_mark[0] = now

    update_rows.launches = 0
    kw = dict(n_src=N, nfft=NFFT, n_iter=30, device=dev)
    sep = {"f32": Separator("overiva", **kw),
           "bf16pack": Separator("overiva", wcov="bf16pack", **kw)}
    pcm = {name: Separator("overiva", out_dtype=np.int16, **kw,
                           **({"wcov": "bf16pack"} if name == "bf16pack" else {}))
           for name in sep}
    sep["f32"].separate(clips[64][0])  # the first call's set-up (FFT plans, allocator)

    # --- launches and outputs: NumPy float in and out at each length
    ys, counts = {}, {}
    for f in SERVE_FRAMES:
        x = clips[f][0]
        for name, s in sep.items():
            wcov_packed.launches = 0
            fused0 = update_rows.launches
            y = s.separate(x)
            counts[name, f] = wcov_packed.launches
            fused = update_rows.launches - fused0
            # bf16pack runs the packed kernel, f32 the fused update, once an epoch
            want = (30, 0) if name == "bf16pack" else (0, 30)
            if (wcov_packed.launches, fused) != want:
                raise AssertionError(
                    f"{name} at {f} frames: (wcov_packed, update_rows) "
                    f"{(wcov_packed.launches, fused)} (want {want})")
            if y.shape != (x.shape[0], N) or y.dtype != np.float32 or not np.isfinite(y).all():
                raise AssertionError(f"bad output {y.shape} {y.dtype} at {f} frames")
            ys[name, f] = y
    # a bf16pack separate_batch of three clips, two of them in bucket 72
    wcov_packed.launches = 0
    fused0 = update_rows.launches
    outs = sep["bf16pack"].separate_batch(
        [clips[64][0], clips[64][0][: samples_for_frames(60)], clips[128][0]])
    serve_launches = [counts["f32", 128], counts["bf16pack", 128], wcov_packed.launches]
    if serve_launches[2] != 90 or update_rows.launches != fused0:
        raise AssertionError(f"bf16pack group of 3: {serve_launches[2]} launches (want 90)")
    for f, o in ((64, outs[0]), (128, outs[2])):
        if not np.array_equal(o, ys["bf16pack", f]):
            raise AssertionError(f"bf16pack group differs from per-clip at {f} frames")
    log(f"[serving] launches of wcov_packed a clip: f32 {serve_launches[0]}, bf16pack "
        f"{serve_launches[1]}; a bf16pack separate_batch of 3 clips (two in bucket 72) "
        f"{serve_launches[2]}, clip by clip, equal to per-clip bit for bit; update_rows 30 "
        f"an f32 clip, 0 under bf16pack; buckets {[sep['f32']._bucket(f) for f in SERVE_FRAMES]}")
    mark("launches")

    # --- int16 PCM in and out: bit for bit against float / 32768 and the host's quantization
    x16 = to_pcm16(clips[128][0])
    x16f = x16.astype(np.float32) / np.float32(32768)
    for name, s in sep.items():
        y_f = s.separate(x16f)
        if not np.array_equal(s.separate(x16), y_f):
            raise AssertionError(f"{name}: int16 in differs from float / 32768")
        y_i = pcm[name].separate(x16)
        if y_i.dtype != np.int16 or not np.array_equal(y_i, pcm16_host(y_f)):
            raise AssertionError(f"{name}: int16 out differs from the host quantization")
    log("[serving] int16 PCM: int16 in equals float / 32768 bit for bit, int16 out equals "
        "the host quantization (array_equal), f32 and bf16pack, 128 frames")
    mark("int16")

    # --- exactness: complex128, 5 iterations, against the unpadded pipeline on the card
    c128 = np.complex128
    s128 = Separator("overiva", n_src=N, nfft=NFFT, n_iter=5, dtype=c128, device=dev)
    worst = 0.0
    for f in SERVE_FRAMES:
        x = clips[f][0]
        X = api.stft_analysis(oracle.stft_pad(x, NFFT, HOP), NFFT, dtype=c128, device=dev)
        Y = api.overiva(X, n_src=N, n_iter=5, dtype=c128, device=dev)
        want = api.stft_synthesis(Y, NFFT, dtype=c128, device=dev)[NFFT - HOP :][: x.shape[0]]
        got = s128.separate(x)
        scale = np.abs(want).max()
        err = np.abs(got - want) - 1e-6 * np.abs(want)
        worst = max(worst, float(np.abs(got - want).max() / scale))
        if (err > 1e-8 * scale).any():
            raise AssertionError(f"c128 Separator vs unpadded at {f} frames: "
                                 f"{int((err > 1e-8 * scale).sum())} elements outside")
    log(f"[serving] c128 5 it, Separator vs the unpadded pipeline on the card: max|d| / max|y| "
        f"{worst:.2e} (rtol 1e-6, atol 1e-8 of max|y|, element-wise), at 64 / 128 / 256 frames")
    mark("c128 exactness")

    # --- separate_batch: 8 clips in 3 buckets against per-clip
    def cut(f, frames):
        return clips[f][0][: samples_for_frames(frames)]

    batch = [clips[64][0], cut(64, 60), clips[128][0], cut(256, 140), cut(128, 125),
             clips[256][0], cut(256, 250), cut(256, 245)]
    per_clip = [ys["f32", 64], None, ys["f32", 128], None, None, ys["f32", 256], None, None]
    per_clip = [p if p is not None else sep["f32"].separate(c) for p, c in zip(per_clip, batch)]
    s_b = Separator("overiva", **kw)
    outs = s_b.separate_batch(batch)
    d64 = max(float(np.abs(o - p).max() / np.abs(p).max()) for o, p in zip(outs, per_clip))
    s_b128 = Separator("overiva", n_src=N, nfft=NFFT, n_iter=5, dtype=c128, device=dev)
    d128 = max(float(np.abs(o - s128.separate(c)).max() / np.abs(o).max())
               for o, c in zip(s_b128.separate_batch(batch), batch))
    log(f"[serving] separate_batch of 8 clips in {s_b.n_buckets()} buckets "
        f"{sorted(b for b, _ in s_b.stats['bucket_hits'])}: c64 30 it max|batch - per-clip| / "
        f"max|y| {d64:.2e} (printed); c128 5 it {d128:.2e} (gate 1e-9)")
    if s_b.n_buckets() < 2 or d128 > 1e-9:
        raise AssertionError("separate_batch differs from per-clip")
    mark("batch")

    # --- warmup up to 256 frames
    s_w = Separator("overiva", **kw)
    t0 = time.perf_counter()
    touched = s_w.warmup(M, samples_for_frames(256))
    torch.cuda.synchronize()
    log(f"[serving] warmup to 256 frames: {touched} buckets "
        f"{sorted(b for b, _ in s_w.stats['bucket_hits'])} in {time.perf_counter() - t0:.2f} s")
    mark("warmup")

    # --- the registry-size loop: every SERVABLE name at a 3-mic STFT
    x3 = clips[128][0][: (124 - 1) * 128, :3]  # 124 frames at nfft 256
    for name in SERVABLE:
        spec = get_algorithm(name)
        n_src = None if spec.determined or spec.single_output else 2
        s = Separator(name, n_src=n_src, nfft=256, n_iter=5, device=dev)
        y = s.separate(x3)
        n_out = 1 if spec.single_output else (n_src or 3)
        if y.shape != (x3.shape[0], n_out) or not np.isfinite(y).all():
            raise AssertionError(f"{name}: output {y.shape}")
    log(f"[serving] the {len(SERVABLE)} SERVABLE names at a 3-mic STFT "
        f"({x3.shape[0]} samples, nfft 256: {s._t_real_of(x3.shape[0])} frames, bucket "
        f"{s._bucket(s._t_real_of(x3.shape[0]))}), 5 it: finite, shaped")
    mark("registry")

    # --- the CLI twins, in process
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        oneshot.main(["-a", "overiva", "-m", "8", "-s", "3", "--nfft", "4096",
                      "--duration", "8", "--device", str(dev)])
    out = buf.getvalue()
    if "SDR" not in out:
        raise AssertionError(f"oneshot printed no SDR:\n{out}")
    for line in out.strip().splitlines()[-4:]:
        log(f"[serving] oneshot: {line.strip()}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = parity_check.main(["--quick", "--device", str(dev)])
    out = buf.getvalue()
    for line in out.strip().splitlines():
        log(f"[serving] parity_check --quick: {line}")
    if rc != 0 or "PASS" not in out:
        raise AssertionError("parity_check --quick did not pass")
    mark("CLI twins")

    # --- quality: each length against the f64 oracle (bf16pack against f32)
    scores = {128: (main["sdr_o"], main["sir_o"])}
    scores.update({f: fut.result() for f, fut in oracle_futures.items()})
    for f in SERVE_FRAMES:
        sdr_o, sir_o = scores[f]
        n = clips[f][0].shape[0]
        sdr32, sir32 = score(ys["f32", f], clips[f][1], n)
        _, sirpk = score(ys["bf16pack", f], clips[f][1], n)
        d_sdr, d_sir = np.abs(sdr32 - sdr_o).max(), np.abs(sir32 - sir_o).max()
        d_pk = abs(sirpk.mean() - sir32.mean())
        log(f"[serving] {f} frames (bucket {sep['f32']._bucket(f)}): SDR oracle "
            f"{np.round(sdr_o, 3)} f32 {np.round(sdr32, 3)}; SIR oracle {np.round(sir_o, 3)} "
            f"f32 {np.round(sir32, 3)} bf16pack {np.round(sirpk, 3)}; max|dSDR| {d_sdr:.4f}, "
            f"max|dSIR| {d_sir:.4f} dB (tol 0.1); bf16pack vs f32 mean SIR {d_pk:.4f} dB (tol 0.3)")
        if not (d_sdr < 0.1 and d_sir < 0.1 and d_pk < 0.3):
            raise AssertionError(f"serving quality gate failed at {f} frames")
    mark("quality (waiting for the oracle's worker processes)")

    # --- request latency: median and p95 of SERVE_TIMED after one warm call
    tiers = [("f32", sep["f32"], lambda f: clips[f][0]),
             ("bf16pack", sep["bf16pack"], lambda f: clips[f][0]),
             ("int16 in and out, f32", pcm["f32"], lambda f: to_pcm16(clips[f][0]))]
    for tier, s, clip_of in tiers:
        for f in SERVE_FRAMES:
            x = clip_of(f)
            s.separate(x)
            lat = []
            for _ in range(SERVE_TIMED):
                t0 = time.perf_counter()
                s.separate(x)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
            med, p95 = float(np.median(lat)), float(np.percentile(lat, 95))
            line = (f"[serving] Separator overiva {tier}, {f} frames (bucket {s._bucket(f)}), "
                    f"{x.shape[0]} samples x {M} mics, 30 it, NumPy in and out: median "
                    f"{med:.1f} ms, p95 {p95:.1f} ms of {SERVE_TIMED}; api.separate (phase 6) "
                    f"{requests_ms[f]:.1f} ms")
            # a request's ~27,000 device ops take the profiler ~9 s to read:
            # profiled at every length under f32, at 128 frames otherwise
            if tier == "f32" or f == 128:
                ops, busy = device_profile(lambda: s.separate(x))
                line += (f"; device ops a request {ops}, device busy {busy:.2f} ms = "
                         f"{100 * busy / med:.1f} % of the median")
            log(line)
    lat = []
    for _ in range(3):
        t0 = time.perf_counter()
        s_b.separate_batch(batch)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    log(f"[serving] separate_batch of the 8 clips (3 buckets), f32 30 it: median "
        f"{np.median(lat):.1f} ms of 3 (per clip {np.median(lat) / 8:.1f} ms; not profiled: "
        f"~80,000 device ops)")
    mark("timed requests")

    torch.cuda.synchronize()
    log(f"[serving] launches of update_rows over the phase: {update_rows.launches} (the f32 "
        f"complex64 IP runs', once an epoch; gated clip by clip above)")
    return serve_launches, update_rows.launches


# phase 12: the parallel tier on the one card. NCCL refuses two ranks on
# one device, so PAR_RANKS gloo ranks share cuda:0 (their collectives
# staged through the host), and one NCCL rank runs a 1 x 1 mesh.
PAR_RANKS = 4
# Separator(mesh=(4, 1)) tiers: complex128 gated against meshless, the
# complex64 tiers printed (and bf16pack's launches gated)
PAR_SERVE_TIERS = (("c128 f32", {"dtype": np.complex128, "n_iter": 5}),
                   ("c64 f32", {"dtype": np.complex64, "n_iter": 30}),
                   ("c64 bf16pack", {"dtype": np.complex64, "n_iter": 30, "wcov": "bf16pack"}))


def counted_rank(fn, *args):
    """On a rank: fn(*args) and the launches of both kernels on that rank
    over it, their counts set to 0 just before."""
    from overiva_tpu_torch.ops.update_rows import update_rows
    from overiva_tpu_torch.ops.wcov_packed import wcov_packed

    wcov_packed.launches = update_rows.launches = 0
    out = fn(*args)
    return out, {"wcov_packed": wcov_packed.launches, "update_rows": update_rows.launches}


def parallel_rank(tiny, X_head, scaled, clips, device_type="cuda", nfft=NFFT):
    """On each of phase 12's gloo ranks (all on cuda:0): the dry run's
    tiny-shape families on meshes (2, 2) and (1, 4); ``sharded_overiva`` at
    the headline (X_head on the card) on (1, 4), best of 3 after a warm
    call, with its collectives; the scaled gate's runs (``scaled``: [(X,
    dtype)]); ``Separator(mesh=(4, 1))`` over ``clips`` in each of
    PAR_SERVE_TIERS with the kernels' launches in each; the JAX modules
    loaded. Run under :func:`counted_rank`, which counts the launches over
    all of it."""
    import torch.distributed as dist

    from overiva_tpu_torch.parallel import dryrun, sharded
    from overiva_tpu_torch.parallel.collectives import counts
    from overiva_tpu_torch.parallel.mesh import make_mesh

    out = {"families": dryrun.rank_families([(2, 2), (1, 4)], tiny, device_type)}
    mesh = make_mesh(1, dist.get_world_size(), device_type=device_type, backend="gloo")
    Xh = torch.from_numpy(X_head[None]).to(mesh.device_type)

    def sync():
        if Xh.is_cuda:
            torch.cuda.synchronize()

    sharded.sharded_overiva(mesh, Xh, n_src=N, n_iter=30)
    best = float("inf")
    for _ in range(3):
        dist.barrier()
        sync()
        before = counts["psum"]
        t0 = time.perf_counter()
        Y = sharded.sharded_overiva(mesh, Xh, n_src=N, n_iter=30)
        sync()
        best = min(best, time.perf_counter() - t0)
    out["headline"] = (Y[0].cpu().numpy(), best, counts["psum"] - before)
    out["scaled"] = dryrun.rank_scaled(scaled, device_type)
    out["serving"] = {tier: dryrun.rank_serving(dist.get_world_size(), device_type, clips,
                                                n_src=N, nfft=nfft, **kw)
                      for tier, kw in PAR_SERVE_TIERS}
    out["jax_modules"] = dryrun.jax_modules()
    return out


def phase_parallel(dev, mix, images, main, serving, scene_futures, pool):
    """The parallel tier: PAR_RANKS gloo ranks on cuda:0 (``parallel_rank``)
    held to the single-device runs on the card: the 17 families at the dry
    run's tiny shape (complex128, 1e-6; ``dryrun.verify_families``: every
    rank the same, each rank's collectives the JAX epochs' count);
    ``sharded_overiva`` at the headline within 0.1 dB of phase 5's
    single-device run, timed beside ``api.overiva``; the 5 scaled scenes
    of each length in ``dryrun.SCALED_SCENES`` (``dryrun.scaled_verdict``,
    the dry run's CLI's gate: c64 within 0.1 dB or a flip with its
    complex128 pair within 0.02 dB, every c64 delta within
    ``dryrun.CONTROL_K`` times the control's, ``dryrun.control_run`` on
    the card; the scenes are
    ``scene_futures`` {(frames, seed): scene}, simulated in worker
    processes since the script started, and bss_eval runs there too);
    Separator(mesh) against meshless with the kernels' launches; then, side
    by side, ``sharded_overiva`` on one NCCL rank and NCCL's refusal of two
    ranks on one card. Returns the launches of (wcov_packed, update_rows)
    on each rank over the phase: the gloo ranks', then the NCCL rank's."""
    from overiva_tpu_torch import api, oracle
    from overiva_tpu_torch.parallel import dryrun
    from overiva_tpu_torch.parallel.launch import launch
    from overiva_tpu_torch.serving import Separator

    log(f"[parallel] {PAR_RANKS} gloo ranks share cuda:0 (NCCL refuses two ranks on one card): "
        "their times are the overhead of sharding on one shared card, not scaling")
    n = mix.shape[0]
    start = NFFT - HOP
    X_head = api.stft_analysis(torch.from_numpy(oracle.stft_pad(mix, NFFT, HOP)).to(dev), NFFT,
                               device=dev)
    single_s = best_wall_s(lambda: api.overiva(X_head, n_src=N, n_iter=30, device=dev))
    seeds = dryrun.SCALED_SEEDS
    scenes = {k: f.result() for k, f in scene_futures.items()}  # (frames, seed) -> scene
    keys = [(f, s, dt) for f in dryrun.SCALED_SCENES for dt in (np.complex64, np.complex128)
            for s in seeds]

    def scored(f, s, Y):
        return pool.submit(dryrun.scene_scores, Y, *scenes[f, s][1:])

    ref_scores = {(f, s, dt): scored(f, s, api.overiva(scenes[f, s][0].astype(dt), n_src=3,
                                                       n_iter=dryrun.SCALED_ITER, dtype=dt,
                                                       device=dev))
                  for f, s, dt in keys}
    control = {(f, s): scored(f, s, dryrun.control_run(scenes[f, s][0], dryrun.SCALED_ITER, dev))
               for f, s in scenes}

    tiny = dryrun.tiny_batch(2, 2)
    clips = [serving[f][0] for f in SERVE_FRAMES]
    runs = [(scenes[f, s][0], dt) for f, s, dt in keys]
    t0 = time.perf_counter()
    outs, rank_launches = zip(*launch(counted_rank, PAR_RANKS,
                                      (parallel_rank, tiny, X_head.cpu().numpy(), runs, clips,
                                       dev.type, NFFT),
                                      device_type=dev.type, backend="gloo", timeout=400))
    log(f"[parallel] the {PAR_RANKS} gloo ranks' work, spawn included: "
        f"{time.perf_counter() - t0:.1f} s")
    r0 = outs[0]
    if any(o["jax_modules"] for o in outs):
        raise AssertionError(f"a rank loaded JAX: {[o['jax_modules'] for o in outs]}")
    Ys = dict(zip(keys, r0["scaled"]))
    sh_scores = {k: scored(*k[:2], Ys[k]) for k in keys}
    Y_head, head_s, head_calls = r0["headline"]
    y_head = api.stft_synthesis(Y_head, NFFT, device=dev)[start : start + n]
    head_score = pool.submit(score, y_head, images, n)

    # --- the tiny-shape families, complex128, against the card's single-device runs
    def families(outs, shapes, tag):
        for name, row in dryrun.verify_families(outs, shapes, tiny, dev).items():
            per_epoch, epochs, extra = dryrun.JAX_COLLECTIVES[name]
            log(f"[parallel] {tag} {name}: sharded == single-device on the card ("
                + ", ".join(f"{shape}: {worst:.2g}x tol" for shape, worst in row)
                + f"); collectives a rank {per_epoch} an epoch x {epochs}"
                + (f" + {extra}" if extra else "") + " (the JAX epochs')")

    families([o["families"] for o in outs], [(2, 2), (1, 4)], f"gloo x{PAR_RANKS}")

    # --- Separator(mesh=(4, 1)) against meshless on the card
    for tier, kw in PAR_SERVE_TIERS:
        ref = Separator("overiva", n_src=N, nfft=NFFT, device=dev, **kw).separate_batch(clips)
        ys = r0["serving"][tier][0]
        rel = max(float(np.abs(y - r).max() / np.abs(r).max()) for y, r in zip(ys, ref))
        got = [o["serving"][tier][2] for o in outs]
        # each rank runs one lane of each bucket group: one clip a group, bf16pack
        # through the packed kernel, complex64 f32 through the fused update (on the
        # CPU of a rehearsal the wrappers run their plain versions and count nothing)
        on_card = 30 * len(clips) if dev.type == "cuda" else 0
        want = on_card if "bf16pack" in tier else 0
        want_fused = on_card if tier == "c64 f32" else 0
        if any(g != {"wcov_packed": want, "update_rows": want_fused} for g in got):
            raise AssertionError(f"Separator mesh {tier}: launches {got}, want {want}, "
                                 f"{want_fused} a rank")
        if "c128" in tier and rel > 1e-7:
            raise AssertionError(f"Separator mesh {tier}: {rel:.3e} from meshless (tol 1e-7)")
        log(f"[parallel] Separator(mesh=({PAR_RANKS}, 1)) {tier}, {kw['n_iter']} it, frames "
            f"{SERVE_FRAMES}: max|mesh - meshless| / max|meshless| {rel:.3e}"
            + (" (tol 1e-7)" if "c128" in tier else " (printed)")
            + f"; launches a rank: wcov_packed {[g['wcov_packed'] for g in got]} "
            f"(want {want}), update_rows {[g['update_rows'] for g in got]} (want {want_fused})")

    # --- side by side: sharded_overiva on one NCCL rank (a 1 x 1 mesh), and two NCCL
    # ranks on cuda:0, whose refusal is printed, not gated (a CPU rehearsal of the
    # phase has no NCCL and skips both)
    if dev.type == "cuda":
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as threads:
            nccl = threads.submit(launch, counted_rank, 1,
                                  (dryrun.rank_families, [(1, 1)], tiny, "cuda", ("overiva",)),
                                  device_type="cuda", timeout=300)
            two = threads.submit(launch, dryrun.rank_families, 2,
                                 ([(1, 2)], dryrun.tiny_batch(1, 2), "cuda", ("overiva",)),
                                 device_type="cuda", timeout=60)
            [(nccl_out, nccl_launches)] = nccl.result()
            families([nccl_out], [(1, 1)], "nccl x1")
            rank_launches += (nccl_launches,)
            try:
                two.result()
                log("[parallel] NCCL ran two ranks on one card")
            except Exception as e:  # the expected outcome
                text = str(e) or type(e).__name__
                first = next((ln for ln in text.splitlines() if "uplicate" in ln),
                             text.splitlines()[-1])
                log(f"[parallel] NCCL refuses two ranks on cuda:0: {type(e).__name__}: "
                    f"{first.strip()[:300]}")
        log(f"[parallel] the NCCL launches, spawn included: {time.perf_counter() - t0:.1f} s")

    # --- the kernels over the phase, each rank's counts set to 0 when it started: only
    # the bf16pack Separator batch reaches the packed kernel, and only the complex64
    # f32 one the fused update (the sharded families run the eager epoch)
    par_launches = tuple([g[k] for g in rank_launches] for k in ("wcov_packed", "update_rows"))
    want = ([30 * len(clips) if dev.type == "cuda" else 0] * PAR_RANKS
            + [0] * (len(rank_launches) - PAR_RANKS))
    log(f"[parallel] launches over the phase, each rank (gloo, then NCCL): wcov_packed "
        f"{par_launches[0]} (want {want}), update_rows {par_launches[1]} (want {want})")
    if par_launches != (want, want):
        raise AssertionError("the parallel phase's kernel launches are off")

    # --- quality: the headline and the scaled gate
    sdr, sir = head_score.result()
    d_head = dryrun.delta((sdr, sir), (main["sdr_32"], main["sir_32"]))
    log(f"[parallel] sharded_overiva (1, {PAR_RANKS}) at the headline (M=8, N=3, F=2049, T=128, "
        f"c64, 30 it) vs phase 5's api.overiva: |dSDR| {d_head[0]:.4f}, |dSIR| {d_head[1]:.4f} dB "
        f"(tol 0.1); collectives {head_calls} = {head_calls / 30:g} an epoch (JAX: 1)")
    if max(d_head) > 0.1 or head_calls != 30:
        raise AssertionError("sharded headline gate failed")
    log(f"[parallel] headline wall, best of 3: sharded_overiva on {PAR_RANKS} gloo ranks sharing "
        f"the card {head_s * 1e3:.1f} ms (rank 0), api.overiva {single_s * 1e3:.1f} ms")
    d = {k: dryrun.delta(sh_scores[k].result(), ref_scores[k].result()) for k in keys}
    for f in dryrun.SCALED_SCENES:
        ctrl = {s: dryrun.delta(control[f, s].result(), ref_scores[f, s, np.complex64].result())
                for s in seeds}
        lines, _ = dryrun.scaled_verdict({s: d[f, s, np.complex64] for s in seeds},
                                         {s: d[f, s, np.complex128] for s in seeds}, ctrl)
        log(f"[parallel] scaled scenes T={f}, sharded_overiva (1, {PAR_RANKS}) vs api.overiva, "
            f"F=2049 M=8 N=3 {dryrun.SCALED_ITER} it: {'; '.join(lines)}; gated: every c128 pair "
            f"within {dryrun.C128_TOL} dB, every c64 delta within {dryrun.C64_TOL} dB or a "
            f"certified flip, and within {dryrun.CONTROL_K:g} x the control (api.overiva c64 on "
            f"the bins reversed)")
    return par_launches


# phase 13: the Monte-Carlo sweep twin on the paper's demo config, plus a bf16pack arm
# (the one sweep arm that reaches a kernel: the batch forms take no wcov, so batch=1)
# and the plain bf16 arm it is also held to.
# One seed of the TPU snapshot's three runs; the other two are copied in first, so
# the sweep resumes past them.
SWEEP_CONFIG = "bench/waspaa_demo_config.json"
SWEEP_SNAPSHOT = "data/waspaa_demo"
SWEEP_SEED = 981238343  # the first seed that SeedSequence(777) draws
SWEEP_BF16 = {"n_iter": 20, "init_eig": True, "wcov": "bf16pack"}
# the demo config's arms that run complex64 OverIVA-IP epochs of the f32 tier
SWEEP_IP_ARMS = ("auxiva", "overiva", "overiva-gauss", "auxiva_pca")
SWEEP_SERIAL_TOL = 2e-4  # batched vs serial, dB (tests/test_sweep_batch.py)
SWEEP_BF16_TOL = 0.3  # bf16pack vs f32 (or bf16) mean SIR, dB (tests/test_bf16.py)
SWEEP_KEYS = ("sdr", "sir", "sdr_improvement", "sir_improvement")


def sweep_small_cfg(defaults):
    """tests/test_torch_sweep.py's small config (3 seeds, 2 cells)."""
    cfg = {**defaults, "repeats": 3, "duration": 1.5, "nfft": 256, "n_mics": [2],
           "n_srcs": [1, 2], "seed": 777}
    cfg["algos"] = {"overiva": {"n_iter": 6}, "ilrma": {"n_iter": 4, "n_components": 2},
                    "five": {"n_iter": 4},
                    "overiva@c128": {"n_iter": 6, "dtype": "complex128"}}
    return cfg


def quiet_sweep(sweep, *args, **kw):
    """``sweep`` with its progress lines logged under [sweep]."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sweep(*args, **kw)
    for line in buf.getvalue().splitlines():
        log(f"[sweep] {line}")


def sweep_records(out):
    return {f.name: json.loads(f.read_text()) for f in sorted(out.glob("s*.json"))}


def phase_sweep(dev, main):
    """The sweep twin (``overiva_tpu_torch/examples/mbss_sim.py``): the demo config
    (``SWEEP_CONFIG``) with bf16pack and bf16 arms at batch=1 on one seed, resuming
    past the snapshot's other two; the small config batched (3) against serial (1);
    gates: no error entry, every score finite, the copied records untouched,
    ``wcov_packed`` once an epoch of each bf16pack run (the epoch count read off phase
    5), ``update_rows`` once an epoch of each complex64 f32 IP arm that ran
    (``SWEEP_IP_ARMS``), the bf16pack arm within ``SWEEP_BF16_TOL`` mean SIR of
    the f32 ``overiva`` column or of the plain bf16 arm (no kernel) in each cell;
    printed: the paired deltas against the TPU snapshot, the wall per instance, the
    card's busy share over one instance. Returns (wcov_packed, update_rows) launches
    of the demo sweep."""
    import shutil
    import tempfile
    from pathlib import Path

    from overiva_tpu_torch.examples import mbss_sim
    from overiva_tpu_torch.ops.update_rows import update_rows
    from overiva_tpu_torch.ops.wcov_packed import wcov_packed

    repo = Path(__file__).resolve().parent
    cfg = {**mbss_sim.DEFAULT_CONFIG, **json.loads((repo / SWEEP_CONFIG).read_text())}
    cfg["algos"] = {**cfg["algos"], "overiva@bf16pack": SWEEP_BF16,
                    "overiva@bf16": {**SWEEP_BF16, "wcov": "bf16"}}
    snapshot = repo / SWEEP_SNAPSHOT
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "demo"
        out.mkdir()
        for f in snapshot.glob("s*.json"):
            if not f.name.startswith(f"s{SWEEP_SEED}_"):
                shutil.copy(f, out)
        copied = {f.name: f.stat().st_mtime_ns for f in out.glob("s*.json")}

        # --- the demo config, once, with the kernels' launch counts
        wcov_packed.launches = 0
        update_rows.launches = 0
        t0 = time.perf_counter()
        quiet_sweep(mbss_sim.sweep, cfg, out, batch=1, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (wcov_packed.launches, update_rows.launches)
        recs = sweep_records(out)
        new = {n: r for n, r in recs.items() if n not in copied}
        if ({n: recs[n] for n in copied}
                != {n: json.loads((snapshot / n).read_text()) for n in copied}
                or any(f.stat().st_mtime_ns != copied[f.name]
                       for f in out.glob("s*.json") if f.name in copied)):
            raise AssertionError("the sweep rewrote a record it should have skipped")
        if len(new) != 11 or any(not n.startswith(f"s{SWEEP_SEED}_") for n in new):
            raise AssertionError(f"the sweep ran {sorted(new)}, want the 11 of seed {SWEEP_SEED}")
        bad = [(n, a) for n, r in new.items() for a, res in r["results"].items()
               if "error" in res or not all(np.isfinite(res[k]).all() for k in SWEEP_KEYS
                                            if k in res)]
        n_bf16 = sum("overiva@bf16pack" in r["results"] for r in new.values())
        want = main["launches"] // 30 * SWEEP_BF16["n_iter"] * n_bf16  # phase 5: 30 it
        # the complex64 f32 IP arms that ran, n_iter epochs each
        n_ip = [a for r in new.values() for a in SWEEP_IP_ARMS if a in r["results"]]
        want_ip = sum(cfg["algos"][a]["n_iter"] for a in n_ip)
        log(f"[sweep] demo config ({SWEEP_CONFIG} + the bf16pack and bf16 arms, batch 1): "
            f"{len(new)} instances of seed {SWEEP_SEED} run, {len(copied)} resumed from "
            f"{SWEEP_SNAPSHOT}; "
            f"error or non-finite entries {bad} (want none); launches of wcov_packed "
            f"{launches[0]} (want {want}: {main['launches']} over phase 5's 30 epochs x "
            f"{SWEEP_BF16['n_iter']} x {n_bf16} bf16pack runs), of update_rows {launches[1]} "
            f"(want {want_ip}: the n_iter of {len(n_ip)} runs of {', '.join(SWEEP_IP_ARMS)})")
        if bad:
            raise AssertionError("the demo sweep recorded errors or non-finite scores")
        if launches != (want, want_ip):
            raise AssertionError("the sweep's kernel launches are off")

        # --- bf16pack against f32, paired, per cell (mean SIR; N=1 cells have none):
        # within SWEEP_BF16_TOL of f32, or of the plain bf16 tier (no kernel) in the same
        # run, which on a poorly separated room loses more than that to f32 itself, in
        # the JAX package too (phase 7's rule for AuxIVA-IP2)
        rows = [r for r in mbss_sim._load_rows(out) if r["key"].startswith(f"s{SWEEP_SEED}_")]
        by = {(r["algo"], r["n_mics"], r["n_src"]): r for r in rows}
        cells = sorted((m, n) for (a, m, n) in by if a == "overiva")

        def d(arm, ref, m, n, key="sir"):
            return by[arm, m, n][key] - by[ref, m, n][key]

        d_pk = {c: (d("overiva@bf16pack", "overiva", *c), d("overiva@bf16", "overiva", *c),
                    d("overiva@bf16pack", "overiva@bf16", *c)) for c in cells if c[1] > 1}
        log("[sweep] mean SIR (dB) per (M, N), bf16pack - f32 / bf16 - f32 / bf16pack - bf16: "
            + ", ".join(f"{c} {a:+.4f} / {b:+.4f} / {e:+.4f}" for c, (a, b, e) in d_pk.items())
            + f" (tol {SWEEP_BF16_TOL} on the first or the last); N=1 cells, SDR bf16pack - "
            "f32 (printed): " + ", ".join(f"{c} {d('overiva@bf16pack', 'overiva', *c, 'sdr'):+.4f}"
                                         for c in cells if c[1] == 1))
        if not d_pk or any(min(abs(a), abs(e)) > SWEEP_BF16_TOL for a, _, e in d_pk.values()):
            raise AssertionError("the bf16pack arm is off both the f32 and the bf16 columns")

        # --- printed: the paired deltas against the TPU snapshot
        table = mbss_sim.paired_table(mbss_sim._load_rows(snapshot), rows)
        log(f"[sweep] paired deltas vs {SWEEP_SNAPSHOT} (a TPU v5e snapshot of 2026-08-17, older "
            "than the room simulation and bss_eval of today: the JAX package on the CPU reads "
            f"up to ~1 dB SDR / ~2 dB SIR from it), seed {SWEEP_SEED}, dSDR / dSIR dB per "
            "(M, N), printed:")
        for algo in sorted({a for a, _, _ in table}):
            cells = [(m, n, v) for (a, m, n), v in table.items() if a == algo]
            log(f"[sweep]   {algo}: " + ", ".join(
                f"({m},{n}) {v[2]:+.2f} / {'' if np.isnan(v[0]) else f'{v[0]:+.2f}'}"
                for m, n, v in cells))
        walls = [r["wall"] for r in new.values()]
        log(f"[sweep] wall {wall:.1f} s for {len(new)} instances: {wall / len(new):.2f} s an "
            f"instance, {len(new) / wall:.3f} instances/s (per-instance walls "
            f"{min(walls):.2f}-{max(walls):.2f} s), {card_and_limit()}")

        # --- printed: the card's busy share over one instance (the largest cell)
        g = (SWEEP_SEED, 8, 3, 0.25, 25.0)
        room = mbss_sim.simulate_instance(cfg, *g)
        ops, busy_ms = device_profile(
            lambda: mbss_sim.one_instance(cfg, *g, simulated=room, device=dev))
        inst_wall = recs[f"{mbss_sim.instance_key(*g)}.json"]["wall"]
        log(f"[sweep] one instance (M=8, N=3, its 6 arms): {ops} device ops, busy "
            f"{busy_ms:.1f} ms of its {inst_wall * 1e3:.1f} ms sweep wall = "
            f"{100 * busy_ms / (inst_wall * 1e3):.1f} %")

        # --- the small config, batched against serial, on the card
        small = sweep_small_cfg(mbss_sim.DEFAULT_CONFIG)
        for b in (1, 3):
            quiet_sweep(mbss_sim.sweep, small, Path(tmp) / f"small{b}", batch=b, device=dev)
        serial, batched = (sweep_records(Path(tmp) / f"small{b}") for b in (1, 3))
        worst, errors = 0.0, []
        for name, rec in serial.items():
            for algo, res in rec["results"].items():
                bres = batched[name]["results"][algo]
                if "error" in res or "error" in bres:
                    errors.append((name, algo))
                    continue
                for k in SWEEP_KEYS:
                    if res.get(k):
                        worst = max(worst, float(np.abs(np.subtract(res[k], bres[k])).max()))
        log(f"[sweep] small config on the card, batch 3 vs batch 1 ({len(serial)} instances): "
            f"max |d| {worst:.2e} dB (tol {SWEEP_SERIAL_TOL}), errors {errors} (want none)")
        if set(serial) != set(batched) or len(serial) != 6 or errors or worst > SWEEP_SERIAL_TOL:
            raise AssertionError("the batched sweep is off the serial one")
    return launches


# phase 14: the bench twin, every row at full width, one timed run each after its
# warm-up (the CLI keeps bench.py's repeats)
BENCH_REPEATS = 1


def bench_ip_epochs(n_iter, repeats):
    """The complex64 OverIVA-IP epochs of the f32 and f32x3 tiers in one run
    of the bench twin at ``n_iter`` epochs a row, each row run once to warm up
    and ``repeats`` times: the headline, the f32x3 row, T512 and its f32x3 row
    and the 16-mixture fold (n_iter each), the marginal row (n_iter + 200), the
    roofline row (n_iter + 100), and the serving rows' four Separator calls
    (float and int16, one clip and a batch of 8 of one bucket, n_iter each)."""
    return (1 + repeats) * (5 * n_iter + (n_iter + 200) + (n_iter + 100) + 4 * n_iter)


def phase_bench(dev):
    """The bench twin (``overiva_tpu_torch/examples/bench.py``) at its full shape
    with ``BENCH_REPEATS`` timed runs a row; its JSON printed; gates: every key of
    ``bench.EXTRA_KEYS`` present and finite, no row error, no truncation,
    ``wcov_packed`` launched by the two bf16pack rows alone (warm-up and timed
    runs, 30 epochs each) and ``update_rows`` once an epoch of the complex64 f32
    and f32x3 IP rows (:func:`bench_ip_epochs`). Returns (wcov_packed,
    update_rows) launches."""
    from overiva_tpu_torch.examples import bench
    from overiva_tpu_torch.ops.update_rows import update_rows
    from overiva_tpu_torch.ops.wcov_packed import wcov_packed

    wcov_packed.launches = 0
    update_rows.launches = 0
    out = bench.run(dev, bench.FULL, repeats=BENCH_REPEATS)
    torch.cuda.synchronize()
    launches = (wcov_packed.launches, update_rows.launches)
    log(f"[bench] {json.dumps(out)}")
    extra = out["extra"]
    missing = [k for k in bench.EXTRA_KEYS if k not in extra]
    bad = [k for k in bench.EXTRA_KEYS if k in extra and not np.isfinite(extra[k])]
    want = 2 * (1 + BENCH_REPEATS) * bench.FULL.n_iter
    want_ip = bench_ip_epochs(bench.FULL.n_iter, BENCH_REPEATS)
    log(f"[bench] headline {out['value']} it/s (vs_baseline {out['vs_baseline']}) on "
        f"{extra['device']}; missing keys {missing}, non-finite {bad}, bench_errors "
        f"{extra.get('bench_errors')}, bench_truncated_at {extra.get('bench_truncated_at')} "
        f"(want none); launches of wcov_packed {launches[0]} (want {want}: 2 bf16pack rows x "
        f"{1 + BENCH_REPEATS} runs x {bench.FULL.n_iter} epochs), of update_rows "
        f"{launches[1]} (want {want_ip}: the f32 and f32x3 IP rows, once an epoch)")
    if (missing or bad or not np.isfinite(out["value"]) or "bench_errors" in extra
            or "bench_truncated_at" in extra):
        raise AssertionError("the bench twin's line is incomplete")
    if launches != (want, want_ip):
        raise AssertionError("the bench twin's kernel launches are off")
    return launches


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    seed = parser.parse_args().seed
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from overiva_tpu_torch import oracle

    phase_t0 = [time.perf_counter()]

    def timed(tag, fn, *args, **kw):
        """fn(*args, **kw), then its wall on a [time] line."""
        out = fn(*args, **kw)
        now = time.perf_counter()
        log(f"[time] {tag} {now - phase_t0[0]:.1f} s")
        phase_t0[0] = now
        return out

    dev = timed("device", phase_device)
    timed("build", phase_build)
    kernel = timed("kernel", phase_kernel, dev, seed)
    fused = timed("fused kernel", phase_fused_kernel, dev, seed)
    entry_launches = timed("entry", phase_entry, dev)
    taps = timed("tap kernel", phase_tap_kernel, dev, seed)

    rng = np.random.default_rng(seed)
    mix, images = make_mixture(rng, N, M, samples_for_frames(128))
    X64 = oracle.analysis(oracle.stft_pad(mix, NFFT, HOP), NFFT, HOP)
    # the f64 oracle runs of phases 8 and 11 go to three of the host's
    # cores from here on (after the kernels are timed), in worker processes
    # that import no JAX either, while phases 4-7 drive the card
    pool = ProcessPoolExecutor(3, mp_context=multiprocessing.get_context("spawn"))
    try:
        oracle_jobs = submit_tf_oracles(pool, X64)
        serving = serve_clips(seed)
        serve_oracles = {f: pool.submit(oracle_scores, *clip, NFFT, HOP)
                         for f, clip in serving.items()}
        serving[128] = (mix, images)
        from overiva_tpu_torch.parallel.dryrun import SCALED_SCENES, SCALED_SEEDS, scaled_mixture

        scenes = {(f, s): pool.submit(scaled_mixture, s, n_samples=n_samples)
                  for f, n_samples in SCALED_SCENES.items() for s in SCALED_SEEDS}
        phases(dev, seed, timed, kernel, fused, taps, mix, images, X64, oracle_jobs, serving,
               serve_oracles, scenes, pool, entry_launches)
    finally:
        pool.shutdown(cancel_futures=True)
    log(f"[done] chip_smoke.py wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


def phases(dev, seed, timed, kernel, fused, taps, mix, images, X64, oracle_jobs, serving,
           serve_oracles, scenes, pool, entry_launches):
    """Phases 4-14 and the kernels line (``kernel``, ``fused``, ``taps``:
    phases 3, 3b and 3d's entries; ``entry_launches``: phase 3c's), on phase 5's mixture
    ``mix`` (its STFT ``X64``);
    ``oracle_jobs``: phase 8's oracle runs; ``serving`` and
    ``serve_oracles``: phase 11's clips and their oracle scores;
    ``scenes``: phase 12's simulated rooms, in the worker ``pool``."""
    timed("trajectory", phase_trajectory, dev, X64)
    main_path = timed("main path", phase_main_path, dev, mix, images, X64)
    fused_launches = timed("fused run", phase_fused_run, dev, mix, images, main_path)
    requests_ms = timed("requests", phase_requests, dev, seed)
    ip2_launches = timed("families", phase_families, dev, mix, images, X64, main_path)
    timed("requests iss", phase_requests, dev, seed, "iss", 30, "families")
    timed("requests ip2", phase_requests, dev, seed, "ip2", 10, "families")
    sparse_launches = timed("tf-families", phase_tf_families, dev, mix, images, X64, main_path,
                            oracle_jobs)
    timed("requests fastmnmf2", phase_requests, dev, seed, "fastmnmf2", 30, "tf-families")
    joint_launches = timed("joint", phase_joint, dev, seed, main_path)
    stream_launches = timed("streaming", phase_streaming, dev, seed)
    serve_launches = timed("serving", phase_serving, dev, serving, serve_oracles, main_path,
                           requests_ms)
    par_launches = timed("parallel", phase_parallel, dev, mix, images, main_path, serving,
                         scenes, pool)
    sweep_launches = timed("sweep", phase_sweep, dev, main_path)
    bench_launches = timed("bench", phase_bench, dev)

    loaded = sorted(
        m for m in sys.modules
        if m in ("jax", "overiva_tpu") or m.startswith(("jax.", "overiva_tpu."))
    )
    if loaded:
        raise AssertionError(f"JAX or the JAX package was imported: {loaded}")
    print(json.dumps({"kernels": [{
        "name": "wcov_packed",
        "route": "cuda",
        "source": "overiva_tpu_torch/csrc/wcov_packed.cu",
        "replaces": "overiva_tpu/ops/pallas_wcov.py:103",
        "launches": main_path["launches"],
        **kernel,
        "entry_launches": entry_launches[0],
        "ip2_launches": ip2_launches,
        "sparse_launches": sparse_launches,
        "joint_launches": joint_launches[0],
        "stream_launches": stream_launches[0],
        "serve_launches": serve_launches[0],
        "parallel_launches": par_launches[0],
        "sweep_launches": sweep_launches[0],
        "bench_launches": bench_launches[0],
    }, {
        "name": "update_rows",
        "route": "cuda",
        "source": "overiva_tpu_torch/csrc/update_rows.cu",
        "replaces": "overiva_tpu/ops/pallas_epoch.py:248",
        "launches": fused_launches,
        **fused,
        "entry_launches": entry_launches[1],
        "joint_launches": joint_launches[1],
        "stream_launches": stream_launches[1],
        "serve_launches": serve_launches[1],
        "parallel_launches": par_launches[1],
        "sweep_launches": sweep_launches[1],
        "bench_launches": bench_launches[1],
    }, {
        "name": "tap_steps",
        "route": "cuda",
        "source": "overiva_tpu_torch/csrc/tap_steps.cu",
        "replaces": None,
        **taps,
    }]}))


if __name__ == "__main__":
    main()
