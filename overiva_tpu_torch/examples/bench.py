"""Throughput bench of the port: the twin of the repository's ``bench.py``,
row for row, on a CUDA card (``--device cpu`` runs it on the CPU):

    python -m overiva_tpu_torch.examples.bench [--device cuda|cpu]

Headline (``bench.py``'s name and protocol): OverIVA-IP iterations a second
at M=8 mics, N=3 sources, F=2049 bins (a 4096-point STFT), T=128 frames,
Laplace model, complex64: 30 epochs of
``models/overiva.py::overiva_iterations`` from a prepared W_hat on an X
already on the device, the best of 3 runs after one warm-up run, each run
closed by ``utils/profiling.py::device_sync``.

Prints ONE JSON line with ``bench.py``'s schema: ``metric``, ``value``,
``unit``, ``vs_baseline`` (value / 100, the target in ``BASELINE.json``)
and ``extra``, which holds ``bench.py``'s 35 rows under its names
(:data:`EXTRA_KEYS`), each on inputs drawn from the same seeds in the same
order, bit for bit, plus ``device``: the card's name and power limit as
``nvidia-smi`` reads them, or ``"cpu"``. A row that raises is listed in
``extra["bench_errors"]`` and the line is printed all the same; a CUDA
error ends the run, since the context it leaves would fail every later
row. Once ``OVERIVA_BENCH_BUDGET_S`` seconds (default 2400) have passed,
the rows left are skipped and ``extra["bench_truncated_at"]`` names the
first of them. Progress goes to stderr.

Where the rows run otherwise than in ``bench.py``:

- ``overiva_df15_M5_F513_ms`` runs complex128 on the complex64-rounded
  input, the port's ``acc="f32x2"``;
- ``overiva_batch16_it_s_per_mix`` folds the bins of its 16 mixtures into
  one run (``n_mix``), as ``api.overiva_batch`` does;
- ``epoch_hbm_frac`` divides by the card's memory rate;
- OGIVE reads its ``done`` flag on the host once every 32 epochs
  (``models/ogive.py``), which the wall includes.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from overiva_tpu_torch import resolve_device
from overiva_tpu_torch.examples.mbss_sim import _reraise_if_device_fault
from overiva_tpu_torch.models.auxiva_iss import auxiva_iss_iterations
from overiva_tpu_torch.models.auxiva_pca import pca
from overiva_tpu_torch.models.fastmnmf2 import fastmnmf2_iterations, unit_power, whiten_q
from overiva_tpu_torch.models.five import five_init, five_iterations, five_whiten
from overiva_tpu_torch.models.ilrma import ilrma_iterations
from overiva_tpu_torch.models.ogive import ogive_init, ogive_iterations
from overiva_tpu_torch.models.overiva import fold_mixtures, overiva_iterations, prepare
from overiva_tpu_torch.models.overiva_ip2 import overiva_ip2_iterations
from overiva_tpu_torch.models.tip import tip_iterations
from overiva_tpu_torch.models.tiss import augment_taps, augmented_eye, tiss_iterations
from overiva_tpu_torch.ops.wpe import wpe
from overiva_tpu_torch.serving import Separator, StreamingSeparator
from overiva_tpu_torch.utils.profiling import device_sync

__all__ = ["EXTRA_KEYS", "FULL", "TINY", "Shape", "main", "run"]

# the rows of bench.py's "extra", in its order
EXTRA_KEYS = (
    "overiva_marginal_it_s", "overiva_bf16_it_s", "overiva_bf16pack_it_s",
    "overiva_f32x3_it_s", "overiva_T512_it_s", "overiva_T512_bf16_it_s",
    "overiva_T512_f32x3_it_s", "overiva_T512_bf16pack_it_s",
    "overiva_T512_marginal_ms", "epoch_hbm_frac", "overiva_df15_M5_F513_ms",
    "overiva_batch16_it_s_per_mix", "serving_warm_clip8s_ms", "serving_rt_factor",
    "serving_warm_clip8s_pcm16_ms", "serving_batch8_ms_per_clip",
    "serving_batch8_pcm16_ms_per_clip", "online_iss_block16_ms",
    "online_iss_rt_factor", "online_tiss_block16_ms", "online_tiss_rt_factor",
    "ogive_wall_to_converge_ms", "ogive_iters_done", "ogive_it_s",
    "wpe_T512_taps5_ms", "tiss_T512_taps5_it_s", "tip_T512_taps5_ms",
    "tip_T512_taps5_bf16_ms", "overiva_ip2_it_s", "auxiva_iss_it_s",
    "overiva_iss_it_s", "pca_iss_it_s", "fastmnmf2_it_s", "ilrma_it_s",
    "five_run10_ms",
)

BASELINE_IT_S = 100.0  # BASELINE.json's target
# the card's memory rate for epoch_hbm_frac: an H100 SXM's HBM3, 3350 GB/s
HBM_GB_S = 3350.0
BATCH = 16  # mixtures of overiva_batch16_it_s_per_mix
FS = 16000  # sample rate of the serving clip and the streaming blocks
TAPS, DELAY = 5, 2  # the joint rows' dereverberation taps


class Shape(NamedTuple):
    """The sizes ``bench.py`` hard-codes (:data:`FULL`)."""

    F: int  # bins of the mixtures of the IP, joint and family rows
    M: int
    N: int
    T: int  # frames of the headline
    T_long: int  # frames of the T512 and joint rows
    nfft: int  # the serving rows' STFT (F = nfft // 2 + 1 at FULL)
    hop: int
    clip_s: float  # seconds of the serving clip
    stream_chan: int  # the streaming rows: channels, STFT size, frames a block
    stream_nfft: int
    stream_frames: int
    df: tuple  # (T, F, M, N) of the complex128 certification row
    n_iter: int  # epochs of the it/s rows
    ogive_epochs: int  # OGIVE's cap (its default)


FULL = Shape(F=2049, M=8, N=3, T=128, T_long=512, nfft=4096, hop=2048, clip_s=8.0,
             stream_chan=4, stream_nfft=512, stream_frames=16, df=(128, 513, 5, 2),
             n_iter=30, ogive_epochs=4000)
# a small shape for the tests
TINY = Shape(F=17, M=4, N=2, T=16, T_long=24, nfft=32, hop=16, clip_s=0.125,
             stream_chan=2, stream_nfft=32, stream_frames=4, df=(16, 9, 3, 2), n_iter=3,
             ogive_epochs=64)


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _make_mix(rng, T, F, M):
    re = rng.standard_normal((T, F, M)).astype(np.float32)
    im = rng.standard_normal((T, F, M)).astype(np.float32)
    # speech-like temporal gating so activations are realistic
    gate = np.where(rng.random(T) < 0.5, 1.0, 0.1).astype(np.float32)
    return re * gate[:, None, None], im * gate[:, None, None]


def mixture(re, im, device):
    """re + 1j im as one complex64 tensor on ``device`` (JAX's ``r + 1j * i``
    of float32 planes, bit for bit)."""
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)


def batch_draws(rng, T, F, M):
    """The planes of ``overiva_batch16_it_s_per_mix``, in ``bench.py``'s
    draw order: the real planes from :data:`BATCH` draws of a mixture, the
    imaginary planes from as many further draws."""
    re = np.stack([_make_mix(rng, T, F, M)[0] for _ in range(BATCH)])
    im = np.stack([_make_mix(rng, T, F, M)[1] for _ in range(BATCH)])
    return re, im


def tiss_start(X):
    """(X with ``TAPS`` delayed copies, the identity-started P) of the
    joint rows."""
    Xt = augment_taps(X, TAPS, DELAY)
    return Xt, augmented_eye(Xt, X.shape[2])


def _real(a, X):
    """A float32 NumPy array as a batch of one in X's real dtype, on X's
    device."""
    return torch.from_numpy(a)[None].to(X.device, X.real.dtype)


def fastmnmf2_start(X):
    """(Xu, Q, g, W, H) of the FastMNMF2 row on X (T, F, M), each with a
    batch axis of one: X at unit power, the whitening Q, and g, W, H (M
    slots, L=2) from ``default_rng(1)``."""
    T, F, M = X.shape
    Xu, _ = unit_power(X[None])
    rngf = np.random.default_rng(1)
    g0 = np.full((M, M), 1e-2, np.float32)
    g0[np.arange(M), np.arange(M)] = 1.0
    g0 /= g0.sum(axis=1, keepdims=True)
    Wn = (rngf.random((M, F, 2)) + 0.1).astype(np.float32)
    Hn = (rngf.random((M, 2, T)) + 0.1).astype(np.float32)
    return Xu, whiten_q(Xu), _real(g0, X), _real(Wn, X), _real(Hn, X)


def ilrma_start(X):
    """(B0, H0) of the ILRMA row on X (T, F, M): K=2 NMF components a source
    from ``default_rng(2)``, each with a batch axis of one."""
    T, F, M = X.shape
    rngl = np.random.default_rng(2)
    B0 = (rngl.random((M, F, 2)) + 0.1).astype(np.float32)
    H0 = (rngl.random((M, 2, T)) + 0.1).astype(np.float32)
    return _real(B0, X), _real(H0, X)


def _eye(n, F, X):
    return torch.eye(n, dtype=X.dtype, device=X.device).repeat(F, 1, 1)


def _check_finite(x, what="demixing filters"):
    ok = torch.isfinite(x).all() if isinstance(x, torch.Tensor) else np.isfinite(x).all()
    if not bool(ok):
        raise FloatingPointError(f"benchmark produced non-finite {what}")


def _card(dev):
    """The card's name and power limit as nvidia-smi reads them; "cpu" on
    the CPU."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


class _Budget(Exception):
    pass


class _Rows:
    """``bench.py``'s guard of each extra row: a row that raises is listed
    in ``errors`` and the rows after it still run, but a CUDA error escapes;
    once ``budget_s`` has passed since ``t0``, entering a row raises
    :class:`_Budget`, which ends the extras."""

    def __init__(self, t0, budget_s):
        self.t0, self.budget_s, self.errors = t0, budget_s, []

    @contextlib.contextmanager
    def __call__(self, name):
        if time.perf_counter() - self.t0 > self.budget_s:
            raise _Budget(name)
        t0 = time.perf_counter()
        try:
            yield
        except Exception as e:
            _reraise_if_device_fault(e)
            self.errors.append(f"{name}: {type(e).__name__}: {e}"[:160])
        _log(f"[bench] {name}: {time.perf_counter() - t0:.1f} s")


def run(device=None, shape=FULL, repeats=None):
    """Run every row of ``bench.py`` on ``device`` (see
    :func:`overiva_tpu_torch.resolve_device`: CUDA unless asked otherwise)
    at ``shape``; returns the dict that :func:`main` prints.

    ``repeats``: the timed runs of every row after its warm-up; None keeps
    ``bench.py``'s counts (3, and 2 for the marginal and certification
    rows, 6 and 3 for the serving rows, 10 for the streaming blocks)."""
    dev = resolve_device(device)
    t_start = time.perf_counter()
    budget_s = float(os.environ.get("OVERIVA_BENCH_BUDGET_S", "2400"))
    S = shape
    F, M, N, n_iter = S.F, S.M, S.N, S.n_iter

    def reps(n):
        return n if repeats is None else int(repeats)

    def best_of(n, call):
        """Best wall of ``call()``, which returns once its work is done, over
        ``reps(n)`` runs, and its last output."""
        best = math.inf
        for _ in range(reps(n)):
            t0 = time.perf_counter()
            out = call()
            best = min(best, time.perf_counter() - t0)
        return best, out

    def timed(thunk, n=3):
        """A warm-up run of ``thunk`` (first-use set-up, the CUDA extension's
        build included), then :func:`best_of` its runs, each closed by
        ``device_sync`` on its (first) output."""
        def call():
            out = thunk()
            device_sync(out[0] if isinstance(out, tuple) else out)
            return out

        call()
        return best_of(n, call)

    rng = np.random.default_rng(0)
    extra = {"device": _card(dev)}

    # ---- headline: OverIVA-IP, T=128, 30 iters incl dispatch ----
    X = mixture(*_make_mix(rng, S.T, F, M), dev)
    W_hat, Cx = prepare(X, N, False)
    t30, W = timed(lambda: overiva_iterations(X, W_hat, Cx, N, n_iter, "laplace"))
    _check_finite(W)
    value = n_iter / t30
    _log(f"[bench] headline: {value:.2f} it/s on {extra['device']}")

    row = _Rows(t_start, budget_s)

    def extra_rows():
        with row("overiva_marginal_it_s"):
            # marginal rate: the fixed cost of a call cancelled
            t230, W = timed(
                lambda: overiva_iterations(X, W_hat, Cx, N, n_iter + 200, "laplace"), 2)
            _check_finite(W)
            extra["overiva_marginal_it_s"] = round(200 / (t230 - t30), 1)

        for tier in ("bf16", "bf16pack", "f32x3"):
            with row(f"overiva_{tier}_it_s"):
                t, W = timed(lambda: overiva_iterations(X, W_hat, Cx, N, n_iter, "laplace",
                                                        wcov=tier))
                _check_finite(W)
                extra[f"overiva_{tier}_it_s"] = round(n_iter / t, 1)

        with row("overiva_T512"):
            # ---- realistic frame count T=512 ----
            X5 = mixture(*_make_mix(rng, S.T_long, F, M), dev)
            W_hat5, Cx5 = prepare(X5, N, False)
            t5, W = timed(lambda: overiva_iterations(X5, W_hat5, Cx5, N, n_iter, "laplace"))
            _check_finite(W)
            extra["overiva_T512_it_s"] = round(n_iter / t5, 1)
            for tier in ("bf16", "f32x3", "bf16pack"):
                t, W = timed(lambda: overiva_iterations(X5, W_hat5, Cx5, N, n_iter,
                                                        "laplace", wcov=tier))
                _check_finite(W)
                extra[f"overiva_T512_{tier}_it_s"] = round(n_iter / t, 1)

        with row("epoch_roofline"):
            # ---- memory roofline: the marginal T=512 epoch against one X
            # read (T*F*M complex64) plus the V writes (N*F*M^2 complex64),
            # at an H100 SXM's 3350 GB/s ----
            t130, W = timed(
                lambda: overiva_iterations(X5, W_hat5, Cx5, N, n_iter + 100, "laplace"), 2)
            _check_finite(W)
            marg = (t130 - t5) / 100.0  # s/iter, the call's fixed cost cancelled
            bytes_ideal = S.T_long * F * M * 8 + N * F * M * M * 8
            gbps = bytes_ideal / marg / 1e9
            extra["overiva_T512_marginal_ms"] = round(marg * 1e3, 3)
            extra["epoch_hbm_frac"] = round(gbps / HBM_GB_S, 4)

        with row("overiva_df"):
            # ---- certification tier (acc="f32x2"): complex128 on the
            # complex64-rounded input, 15 gauss epochs ----
            T_df, F_df, M_df, N_df = S.df
            Xd = mixture(*_make_mix(rng, T_df, F_df, M_df), dev).to(torch.complex128)
            Wd, Cxd = prepare(Xd, N_df, False)
            t_df, W = timed(lambda: overiva_iterations(Xd, Wd, Cxd, N_df, 15, "gauss"), 2)
            _check_finite(W)
            extra["overiva_df15_M5_F513_ms"] = round(t_df * 1e3, 1)

        with row("overiva_batch16"):
            # ---- 16 mixtures in one run, their bins folded (api.overiva_batch) ----
            Xb = fold_mixtures(mixture(*batch_draws(rng, S.T, F, M), dev))
            W_hatb, Cxb = prepare(Xb, N, False)
            t_b, Wb = timed(lambda: overiva_iterations(Xb, W_hatb, Cxb, N, n_iter, "laplace",
                                                       n_mix=BATCH))
            _check_finite(Wb)
            extra["overiva_batch16_it_s_per_mix"] = round(BATCH * n_iter / t_b, 1)

        with row("serving_clip"):
            # ---- clip serving (serving.Separator): NumPy waveform in,
            # separated waveform out, at the headline configuration ----
            sep = Separator("overiva", n_src=N, nfft=S.nfft, hop=S.hop, n_iter=n_iter,
                            device=dev)
            rngs = np.random.default_rng(3)
            n_clip = int(S.clip_s * FS)
            clip = rngs.standard_normal((n_clip, M)).astype(np.float32)
            gate = np.repeat(np.where(rngs.random(n_clip // 160 + 1) < 0.5, 1.0, 0.1),
                             160)[:n_clip]
            clip *= gate[:, None].astype(np.float32)
            sep.separate(clip)  # warm-up
            best, y_s = best_of(6, lambda: sep.separate(clip))
            _check_finite(y_s, "separated samples")
            extra["serving_warm_clip8s_ms"] = round(best * 1e3, 1)
            extra["serving_rt_factor"] = round(S.clip_s / best, 1)

            # int16 PCM in and out
            clip_i = np.clip(np.round(clip * 8192), -32768, 32767).astype(np.int16)
            sep_pcm = Separator("overiva", n_src=N, nfft=S.nfft, hop=S.hop, n_iter=n_iter,
                                out_dtype=np.int16, device=dev)
            sep_pcm.separate(clip_i)
            best_i, y_i = best_of(6, lambda: sep_pcm.separate(clip_i))
            if y_i.dtype != np.int16 or not np.abs(y_i).max() > 0:
                raise AssertionError("the int16 tier returned no int16 samples")
            extra["serving_warm_clip8s_pcm16_ms"] = round(best_i * 1e3, 1)

            # 8 clips of one bucket in one call (separate_batch)
            clips = [clip[: n_clip - i * S.hop] for i in range(8)]
            sep.separate_batch(clips)
            t_sb, outs = best_of(3, lambda: sep.separate_batch(clips))
            for o in outs:
                _check_finite(o, "separated samples")
            extra["serving_batch8_ms_per_clip"] = round(t_sb / 8 * 1e3, 1)

            clips_i = [np.clip(np.round(c * 8192), -32768, 32767).astype(np.int16)
                       for c in clips]
            sep_pcm.separate_batch(clips_i)
            t_sbi, outs_i = best_of(3, lambda: sep_pcm.separate_batch(clips_i))
            if any(o.dtype != np.int16 for o in outs_i):
                raise AssertionError("the int16 batch returned no int16 samples")
            extra["serving_batch8_pcm16_ms_per_clip"] = round(t_sbi / 8 * 1e3, 1)

        with row("streaming"):
            # ---- streaming (serving.StreamingSeparator): warm latency of one
            # block of 16 frames (256 ms at nfft 512) at M=4 ----
            rngb = np.random.default_rng(5)
            for name, algo, kw in (("online_iss", "online-iss", {}),
                                   ("online_tiss", "online-tiss", {"taps": 4, "delay": 2})):
                seps = StreamingSeparator(algo, n_chan=S.stream_chan, nfft=S.stream_nfft,
                                          hop=S.stream_nfft // 2,
                                          block_frames=S.stream_frames, n_pass=2,
                                          device=dev, **kw)
                blk = rngb.standard_normal((seps.block_samples, S.stream_chan)).astype(
                    np.float32)
                seps.process(blk)  # warm-up
                best_blk, out_b = best_of(10, lambda: seps.process(blk))
                _check_finite(out_b, "separated samples")
                extra[f"{name}_block16_ms"] = round(best_blk * 1e3, 2)
                extra[f"{name}_rt_factor"] = round((seps.block_samples / FS) / best_blk, 1)

        with row("ogive"):
            # ---- OGIVE at its defaults: up to 4000 epochs, tol 1e-3, "demix",
            # step 0.1; the wall includes reading the epoch count ----
            w0g, a0g, Cxg, Cxg_inv = ogive_init(X, False)
            use_mix0 = torch.zeros(F, dtype=torch.bool, device=dev)
            mu_g = torch.tensor(0.1, dtype=X.real.dtype, device=dev)
            tol_g = torch.tensor(1e-3, dtype=X.real.dtype, device=dev)
            ep0 = torch.zeros(1, dtype=torch.int32, device=dev)
            done0 = torch.zeros(1, dtype=torch.bool, device=dev)

            def run_ogive():
                w, _, _, ep, _ = ogive_iterations(
                    X, w0g, a0g, use_mix0, Cxg, Cxg_inv, ep0, done0, mu_g, tol_g,
                    S.ogive_epochs, "laplace", "demix", 10,
                )
                return w, int(ep[0])  # the host read closes the run

            run_ogive()  # warm-up
            best_g, (w_g, iters_g) = best_of(3, run_ogive)
            _check_finite(w_g)
            extra["ogive_wall_to_converge_ms"] = round(best_g * 1e3, 1)
            extra["ogive_iters_done"] = iters_g
            extra["ogive_it_s"] = round(max(iters_g, 1) / best_g, 1)

        with row("wpe_T512"):
            # ---- WPE: 2 iterations at T=512, 5 taps ----
            t_wpe, Yw = timed(lambda: wpe(X5, taps=TAPS, delay=DELAY, n_iter=2,
                                          diag_load=1e-5))
            _check_finite(Yw)
            extra["wpe_T512_taps5_ms"] = round(t_wpe * 1e3, 1)

        with row("tiss_T512"):
            # ---- T-ISS, joint dereverberation + separation, M=8 -> N=3 ----
            Xt5, Pt0 = tiss_start(X5)
            t_tiss, (Pt, _) = timed(
                lambda: tiss_iterations(Xt5, Pt0, n_iter, "laplace", M, n_src=N))
            _check_finite(Pt)
            extra["tiss_T512_taps5_it_s"] = round(n_iter / t_tiss, 1)

        with row("tip_T512"):
            # ---- T-IP: 10 warm T-ISS epochs, then 10 T-IP epochs ----
            def tip_prog(wcov):
                P1, _ = tiss_iterations(Xt5, Pt0, 10, "laplace", M, n_src=N)
                return tip_iterations(Xt5, P1, 10, "laplace", M, n_src=N, wcov=wcov)

            t_tip, Pt2 = timed(lambda: tip_prog("f32"))
            _check_finite(Pt2)
            extra["tip_T512_taps5_ms"] = round(t_tip * 1e3, 1)
            t_tipb, Pt2b = timed(lambda: tip_prog("bf16"))
            _check_finite(Pt2b)
            extra["tip_T512_taps5_bf16_ms"] = round(t_tipb * 1e3, 1)

        with row("overiva_ip2"):
            t_ip2, W = timed(
                lambda: overiva_ip2_iterations(X, W_hat, Cx, N, n_iter, "laplace"))
            _check_finite(W)
            extra["overiva_ip2_it_s"] = round(n_iter / t_ip2, 1)

        with row("auxiva_iss"):
            # ---- AuxIVA-ISS, determined M=N=8 ----
            Weye = _eye(M, F, X)
            t_iss, (Wi, _) = timed(lambda: auxiva_iss_iterations(X, Weye, n_iter, "laplace"))
            _check_finite(Wi)
            extra["auxiva_iss_it_s"] = round(n_iter / t_iss, 1)

        with row("overiva_iss"):
            t_oiss, (Wo, _) = timed(
                lambda: auxiva_iss_iterations(X, Weye, n_iter, "laplace", n_src=N))
            _check_finite(Wo)
            extra["overiva_iss_it_s"] = round(n_iter / t_oiss, 1)

        with row("pca_iss"):
            # ---- PCA to N=3, then ISS; the PCA inside the timed call ----
            WeyeN = _eye(N, F, X)
            t_pca, (Wr, _) = timed(
                lambda: auxiva_iss_iterations(pca(X, N), WeyeN, n_iter, "laplace"))
            _check_finite(Wr)
            extra["pca_iss_it_s"] = round(n_iter / t_pca, 1)

        with row("fastmnmf2"):
            # ---- FastMNMF2, M=8 slots, L=2 ----
            Xu, Qw, g, Wn, Hn = fastmnmf2_start(X)
            t_fm, (Qf, _, _, _) = timed(lambda: fastmnmf2_iterations(Xu, Qw, g, Wn, Hn, n_iter))
            _check_finite(Qf)
            extra["fastmnmf2_it_s"] = round(n_iter / t_fm, 1)

        with row("ilrma"):
            # ---- ILRMA, determined M=N=8, K=2 ----
            B0, H0 = ilrma_start(X)
            t_il, (Wl, _, _) = timed(
                lambda: ilrma_iterations(X[None], Weye[None], B0, H0, n_iter))
            _check_finite(Wl)
            extra["ilrma_it_s"] = round(n_iter / t_il, 1)

        with row("five"):
            # ---- FIVE: the whitening and 10 epochs in the timed call ----
            def five_prog():
                Xw, _ = five_whiten(X)
                return five_iterations(Xw, five_init(Xw), 10, "laplace")

            t_fv, wf = timed(five_prog)
            _check_finite(wf)
            extra["five_run10_ms"] = round(t_fv * 1e3, 1)

    try:
        extra_rows()
    except _Budget as b:
        extra["bench_truncated_at"] = str(b)
    if row.errors:
        extra["bench_errors"] = row.errors
    _log(f"[bench] done in {time.perf_counter() - t_start:.1f} s")
    return {
        "metric": "overiva_iters_per_sec_M8_N3_F2049",
        "value": round(value, 2),
        "unit": "iter/s",
        "vs_baseline": round(value / BASELINE_IT_S, 3),
        "extra": extra,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: CUDA; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)
    print(json.dumps(run(args.device)))


if __name__ == "__main__":
    main()
