"""Dry run of the multi-device tier, the twin of
``__graft_entry__.py::dryrun_multichip``:

    python -m overiva_tpu_torch.parallel.dryrun --ranks 8 --device cpu
    python -m overiva_tpu_torch.parallel.dryrun --ranks 4 --device cuda --backend gloo
    python -m overiva_tpu_torch.parallel.dryrun --ranks 4 --device cuda --backend gloo \
        --scaled-only --frames 48 --seeds 16 17 18 19 20

spawns ``--ranks`` ranks (``parallel/launch.py``) on a ('mix', 'bins')
mesh (n_mix = 2 for an even count, the rest on 'bins', as the JAX dry run
picks) and checks, on ``--device``:

1. all seventeen sharded families at the JAX dry run's tiny shape (B =
   n_mix, T=16, F = 4 n_bins + 1, so the bins are padded, M=4, N=2,
   complex128), each held element-wise to the port's single-device
   ``api.*`` at ``1e-6 max(|Y_ref|max, 1) + 1e-8`` (``online_iss`` to the
   port's oracle copy ``oracle.online_iss_run``), every rank's output the
   same, and each family's collectives on each rank equal to the number
   of ``psum``/``pmax`` calls its JAX epochs make (:data:`JAX_COLLECTIVES`);
2. ``serving.Separator(mesh=...)`` on a (ranks, 1) mesh against the
   meshless Separator, clip by clip, within 1e-7;
3. the scaled quality gate at the flagship widths: simulated rooms
   (``overiva_tpu_torch.sim``), nfft 4096 (F=2049), M=8, N=3, 20
   iterations, ``sharded_overiva`` on a (1, ranks) mesh against the
   single-device ``api.overiva`` through iSTFT and bss_eval, seeds 11-15
   (``--seeds``) of one of two scenes (``--frames``, :data:`SCALED_SCENES`:
   the JAX dry run's 6 s scene, T=48, the default, and a 16.3 s one with
   the headline's 128 frames; :func:`scaled_verdict`): in complex64
   |dSDR| and |dSIR| <= 0.1 dB, or the seed is a basin flip, which must
   pass the same comparison in complex128 at 0.02 dB; seed 11 always runs
   complex128 too; every complex64 delta is also held to ``CONTROL_K``
   times the control's, the single-device run against itself on its bins
   reversed, printed beside it with their ratio.

Every rank is a spawned process that imports the port and nothing of JAX.
The references run in this process, on the same device.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from . import sharded
from .collectives import counts
from .launch import launch
from .mesh import make_mesh

__all__ = [
    "CONTROL_K", "HELD_OUT_SEEDS", "JAX_COLLECTIVES", "SCALED_SCENES", "check_family",
    "control_ratio", "control_run", "delta", "expected_collectives", "family_kwargs",
    "family_reference", "jax_modules", "main", "rank_checks", "rank_families",
    "rank_refusals", "rank_scaled", "rank_serving", "scaled_gate", "scaled_mixture",
    "scaled_verdict", "scene_scores", "tiny_batch", "tiny_checks", "verify_families",
]

M, N = 4, 2  # the tiny shape's mics and sources
SERVE_CLIPS = (3600, 2000, 3900, 3650, 2100)  # samples, 3 mics (the JAX dry run's)
SCALED_SEEDS, SCALED_ITER = (11, 12, 13, 14, 15), 20  # the scaled gate's scenes and epochs
HELD_OUT_SEEDS = (16, 17, 18, 19, 20)  # seeds that did not set CONTROL_K
# frames of a scaled scene at nfft 4096 -> samples at 16 kHz: the JAX dry
# run's 6 s scene, and one with the headline's frames
SCALED_SCENES = {48: 96000, 128: 260096}
C64_TOL, C128_TOL = 0.1, 0.02  # dB, the JAX dry run's
# A complex64 delta may reach CONTROL_K times the control's on its seed
# and metric. On the 48-frame scene complex64's own spread reaches the
# 0.1 dB threshold: api.overiva against itself on its bins reversed moves
# 0.03-1.07 dB on an H100, and sharded_overiva on (1, 4) reads up to 3.36
# times that (seed 15's SIR), so 4. With 128 frames the control still
# reaches 0.31 dB on an H100 (0.79 dB in the JAX package on the CPU).
CONTROL_K = 4.0

# name -> (sharded function, its keyword arguments at the tiny shape)
FAMILIES = {
    "overiva": ("sharded_overiva", dict(n_src=N, n_iter=2)),
    "auxiva_iss": ("sharded_auxiva_iss", dict(n_iter=2)),
    "overiva_iss": ("sharded_overiva_iss", dict(n_src=N, n_iter=2)),
    "auxiva_pca": ("sharded_auxiva_pca", dict(n_src=N, n_iter=2)),
    "overiva_ip2": ("sharded_overiva_ip2", dict(n_src=N, n_iter=2)),
    "fastmnmf2": ("sharded_fastmnmf2", dict(n_src=N, n_iter=2, seed=3)),
    "fastmnmf1": ("sharded_fastmnmf2", dict(n_src=N, n_iter=2, seed=3, tie_g=False)),
    "ilrma": ("sharded_ilrma", dict(n_iter=2, seed=5)),
    "five": ("sharded_five", dict(n_iter=3)),
    "sparseauxiva": ("sharded_sparseauxiva", dict(n_iter=2, lasso_iter=20, polish_iter=1)),
    "ogive": ("sharded_ogive", dict(n_iter=5, step_size=0.05, tol=1e-4)),
    "wpe": ("sharded_wpe", dict(taps=2, delay=1, n_iter=2)),
    "tiss": ("sharded_tiss", dict(n_src=N, taps=2, delay=1, n_iter=2)),
    "ilrma_t": ("sharded_ilrma_t", dict(taps=2, delay=1, n_iter=2, seed=7)),
    "tip": ("sharded_tip", dict(n_src=N, taps=2, delay=1, n_iter=2, warm_iter=2)),
    "online_iss": ("sharded_online_iss", dict(block=4, forget=0.97, n_pass=2)),
    "online_tiss": ("sharded_online_tiss", dict(block=4, taps=2, delay=1, forget=0.97,
                                                n_pass=2)),
}

# name -> (psum/pmax calls a JAX epoch makes, epochs at the tiny shape,
# calls outside the epochs). Read off the JAX epochs: one power psum
# (overiva.py:128, auxiva_iss.py:44, overiva_ip2.py:136, five.py:56,
# tiss.py via auxiva_iss, tip.py:95), OGIVE's psum and pmax
# (ogive.py:136, :171), ILRMA's num/den/rescale psums per source
# (ilrma.py:83-84, :112), ILRMA-T's num/den per source and one
# renormalization (ilrma_t.py:73-74, :125), FastMNMF's H, tied-g and nu
# psums (fastmnmf2.py:139-150, :201) and the output pick
# (parallel/sharded.py:864), one psum a pass of the online steps
# (online_iss.py:93, online_tiss.py:143). The streams' "epochs" are
# passes: T/block blocks of n_pass.
JAX_COLLECTIVES = {
    "overiva": (1, 2, 0), "auxiva_iss": (1, 2, 0), "overiva_iss": (1, 2, 0),
    "auxiva_pca": (1, 2, 0), "overiva_ip2": (1, 2, 0), "fastmnmf2": (5, 2, 1),
    "fastmnmf1": (3, 2, 1), "ilrma": (3 * M, 2, 0), "five": (1, 3, 0),
    "sparseauxiva": (1, 3, 0), "ogive": (2, 5, 0), "wpe": (0, 2, 0), "tiss": (1, 2, 0),
    "ilrma_t": (2 * M + 1, 2, 0), "tip": (1, 4, 0), "online_iss": (1, 8, 0),
    "online_tiss": (1, 8, 0),
}


def expected_collectives(name: str, n_local: int) -> int:
    """The psum/pmax calls of one run of ``name`` at the tiny shape on a
    rank holding ``n_local`` mixtures: the epochs of all of them at once,
    the streams one after the other."""
    per_epoch, epochs, extra = JAX_COLLECTIVES[name]
    total = per_epoch * epochs + extra
    return total * n_local if name.startswith("online") else total


def tiny_batch(n_mix: int, n_bins: int, seed: int = 1):
    """The JAX dry run's batch: (n_mix, 16, 4 n_bins + 1, M) complex128."""
    rng = np.random.default_rng(seed)
    shape = (n_mix, 16, 4 * n_bins + 1, M)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def family_kwargs(name: str, F: int) -> dict:
    """The keyword arguments of ``name`` at the tiny shape with F bins:
    :data:`FAMILIES`'s, and SparseAuxIVA's k = F // 2 selected bins (its
    default, max(M^2, F/4), needs F > 4 M^2)."""
    kw = dict(FAMILIES[name][1])
    if name == "sparseauxiva":
        kw["n_bins"] = F // 2
    return kw


def rank_families(shapes, X, device_type, names=tuple(FAMILIES)):
    """On every rank: each family of ``names`` on each mesh of ``shapes``
    ((n_mix, n_bins) pairs) over the batch X. Returns {(shape, name):
    (output, psum/pmax calls on this rank)}."""
    out = {}
    for shape in shapes:
        mesh = make_mesh(*shape, device_type=device_type, backend=dist.get_backend())
        for name in names:
            before = counts["psum"] + counts["pmax"]
            Y = getattr(sharded, FAMILIES[name][0])(mesh, X, **family_kwargs(name, X.shape[2]))
            out[shape, name] = (Y, counts["psum"] + counts["pmax"] - before)
    return out


def jax_modules():
    """The modules of JAX or of the JAX package loaded in this process."""
    return sorted(m for m in sys.modules
                  if m in ("jax", "overiva_tpu") or m.startswith(("jax.", "overiva_tpu.")))


def rank_refusals(device_type):
    """On every rank: the ValueError messages of a batch the 'mix' axis does
    not divide and of SparseAuxIVA's bad selections, on a (world, 1) mesh
    and a (1, world) mesh."""
    n = dist.get_world_size()
    X = tiny_batch(1, 1)
    out = {}
    cases = (
        ("batch", (n, 1), "sharded_overiva", dict(n_src=N)),
        ("all bins", (1, n), "sharded_sparseauxiva", dict(S=np.arange(X.shape[2]))),
        ("unsorted S", (1, n), "sharded_sparseauxiva", dict(S=np.array([3, 1, 2]))),
        ("S rows", (1, n), "sharded_sparseauxiva", dict(S=np.zeros((2, 3), int))),
    )
    for label, shape, fn, kw in cases:
        mesh = make_mesh(*shape, device_type=device_type, backend=dist.get_backend())
        try:
            getattr(sharded, fn)(mesh, X, **kw)
            out[label] = None
        except ValueError as e:
            out[label] = str(e)
    return out


def rank_checks(shapes, X, device_type, serve_lanes):
    """On every rank: :func:`rank_families` over ``shapes``,
    :func:`rank_serving` on a (``serve_lanes``, 1) mesh (float and int16
    PCM out), :func:`rank_refusals` and the JAX modules loaded in the rank
    (none)."""
    return dict(families=rank_families(shapes, X, device_type),
                serving=rank_serving(serve_lanes, device_type),
                serving_pcm=rank_serving(serve_lanes, device_type, out_dtype=np.int16),
                refusals=rank_refusals(device_type), jax_modules=jax_modules())


def family_reference(name: str, x, b: int, device):
    """The single-device run of ``name`` on mixture ``b`` of the tiny batch
    (x: (T, F, M) complex128), at the keyword arguments of
    :data:`FAMILIES` (per-element seeds ``seed + b``)."""
    from .. import api, oracle

    kw = dict(family_kwargs(name, x.shape[1]), dtype=np.complex128, device=device)
    if "seed" in kw:
        kw["seed"] += b
    if name == "fastmnmf1":
        kw.pop("tie_g")
        return api.fastmnmf(x, **kw)
    if name == "online_iss":
        return oracle.online_iss_run(x, 4, forget=0.97, n_pass=2)
    if name == "online_tiss":
        sep = api.OnlineTISS(x.shape[1], x.shape[2], taps=2, delay=1, forget=0.97, n_pass=2,
                             dtype=np.complex128, device=device)
        return np.concatenate([sep.process(x[t:t + 4]) for t in range(0, x.shape[0], 4)])
    return getattr(api, name)(x, **kw)


def check_family(Y, X, name, device, tol=1e-6):
    """Y (B, T, F, K) against the single-device runs of each mixture of X;
    returns the worst error over its tolerance (<= 1 passes)."""
    worst = 0.0
    for b in range(X.shape[0]):
        ref = np.asarray(family_reference(name, X[b], b, device))
        ref = ref.reshape(Y.shape[1:])
        err = np.abs(np.asarray(Y[b]) - ref).max()
        worst = max(worst, err / (tol * max(np.abs(ref).max(), 1.0) + 1e-8))
    return worst


def verify_families(outs, shapes, X, device):
    """Each rank's :func:`rank_families` output (``outs``, one per rank)
    over the meshes ``shapes``: every rank the same array, each rank's
    collectives the JAX epochs' count, the output within tolerance of the
    single-device runs on ``device`` (:func:`check_family`). Raises
    AssertionError; returns {name: [(shape, worst error over tolerance)]}
    for the families the ranks ran."""
    rows = {}
    for name in FAMILIES:
        for shape in shapes:
            if (shape, name) not in outs[0]:
                continue
            Y = outs[0][shape, name][0]
            if any(not np.array_equal(o[shape, name][0], Y) for o in outs[1:]):
                raise AssertionError(f"{name} {shape}: the ranks disagree")
            got = [o[shape, name][1] for o in outs]
            want = expected_collectives(name, X.shape[0] // shape[0])
            if got != [want] * len(outs):
                raise AssertionError(f"{name} {shape}: collectives {got} on the ranks, "
                                     f"the JAX epochs make {want}")
            worst = check_family(Y, X, name, device)
            if worst > 1.0:
                raise AssertionError(f"{name} {shape}: sharded != single-device "
                                     f"({worst:.3g}x the tolerance)")
            rows.setdefault(name, []).append((shape, worst))
    return rows


def rank_serving(n_lanes, device_type, clips=None, **sep_kw):
    """On every rank: ``Separator(mesh=(n_lanes, 1), **sep_kw)`` (default:
    the JAX dry run's "overiva", n_src=2, nfft 128, complex128, 3
    iterations) over the clips (default: its five 3-mic clips). Returns
    (outputs, bucket groups, {kernel: launches on this rank in the batch})."""
    from ..ops.update_rows import update_rows
    from ..ops.wcov_packed import wcov_packed
    from ..serving import Separator

    mesh = make_mesh(n_lanes, 1, device_type=device_type, backend=dist.get_backend())
    kw = {"algo": "overiva", "n_src": 2, "nfft": 128, "dtype": np.complex128, "n_iter": 3,
          **sep_kw}
    device = torch.cuda.current_device() if device_type == "cuda" else "cpu"
    sep = Separator(mesh=mesh, device=device, **kw)
    before = wcov_packed.launches, update_rows.launches
    outs = sep.separate_batch(serve_clips() if clips is None else clips)
    launches = dict(wcov_packed=wcov_packed.launches - before[0],
                    update_rows=update_rows.launches - before[1])
    return outs, sep.n_buckets(), launches


def serve_clips(seed: int = 2):
    """The JAX dry run's five serving clips (n, 3) float64."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, 3)) for n in SERVE_CLIPS]


def scaled_mixture(seed: int, nfft: int = 4096, fs: int = 16000, n_samples: int = 96000):
    """The JAX dry run's flagship scene: a 7 x 6 x 3 m room (RT60 0.25 s),
    three speech-like sources on a semicircle, an 8-mic circular array,
    25 dB SNR. Returns (X (T, F, 8) complex64, mix, premix)."""
    from .. import oracle
    from ..sim import ShoeBox, circular_mic_array, semi_circle_layout, speech_like

    room = ShoeBox([7.0, 6.0, 3.0], fs=fs, rt60=0.25, seed=seed)
    for k, pos in enumerate(semi_circle_layout([3.5, 3.0, 1.5], np.pi / 2, 2.2, 3,
                                               rot=np.pi / 2)):
        room.add_source(pos, speech_like(n_samples, fs, seed=seed * 13 + k))
    room.add_mic_array(circular_mic_array([3.5, 3.0, 1.5], 0.05, 8))
    premix, noise = room.simulate(return_premix=True, snr=25.0)
    mix = (premix.sum(axis=0) + noise).T[:n_samples]
    hop = nfft // 2
    X = oracle.analysis(oracle.stft_pad(mix, nfft, hop), nfft, hop).astype(np.complex64)
    return X, mix, premix


def rank_scaled(Xs, device_type, n_iter=SCALED_ITER):
    """On every rank: ``sharded_overiva`` (N=3) of each (X, dtype) of Xs on
    a (1, ranks) mesh; returns the outputs."""
    mesh = make_mesh(1, dist.get_world_size(), device_type=device_type,
                     backend=dist.get_backend())
    return [sharded.sharded_overiva(mesh, X[None].astype(dt), n_src=3, n_iter=n_iter)[0]
            for X, dt in Xs]


def scene_scores(Y, mix, premix):
    """(SDR, SIR) of one separation Y (T, F, 3) of a scaled scene, through
    iSTFT (nfft 2 (F - 1), hop nfft / 2) and bss_eval against the mic-0
    images."""
    from .. import oracle
    from ..metrics import bss_eval_sources

    nfft = 2 * (Y.shape[1] - 1)
    hop = nfft // 2
    y = oracle.synthesis(np.asarray(Y, np.complex128), nfft, hop)[nfft - hop:][: mix.shape[0]]
    sdr, sir, _, _ = bss_eval_sources(premix[:, 0, : mix.shape[0]], y.T)
    return sdr, sir


def delta(a, b):
    """max |dSDR|, max |dSIR| (dB) between two (SDR, SIR) scores."""
    return float(np.max(np.abs(a[0] - b[0]))), float(np.max(np.abs(a[1] - b[1])))


def control_run(X, n_iter=SCALED_ITER, device=None):
    """The scaled gate's control: ``api.overiva`` (N=3) of X (T, F, M) on
    its bins in reverse order, put back in order. The same math as the
    single-device run with another rounding, so its distance from that
    run is complex64's own spread on the scene."""
    from .. import api

    Y = api.overiva(np.ascontiguousarray(X[:, ::-1]), n_src=3, n_iter=n_iter, dtype=X.dtype,
                    device=device)
    return Y[:, ::-1]


def control_ratio(d, c):
    """The largest ratio of a complex64 delta to the control's on the same
    metric (inf where the control reads 0 and the delta does not)."""
    return max(x / y if y > 0 else (np.inf if x > 0 else 0.0) for x, y in zip(d, c))


def scaled_verdict(d64: dict, d128: dict, control: dict, k: float = CONTROL_K):
    """The scaled gate on the sharded-vs-single deltas {seed: (|dSDR|,
    |dSIR|)} in dB: ``d64`` of every seed in complex64, ``d128`` of the
    first seed and of every seed above C64_TOL in complex64, ``control``
    the complex64 control's delta (:func:`control_run`) of every seed.

    1. every complex128 pair within C128_TOL: above it the code differs;
    2. a seed above C64_TOL in complex64 is a basin flip of the chaotic
       complex64 trajectory only if it has a complex128 pair;
    3. every complex64 delta within max(C64_TOL, k x the control's on the
       same seed and metric): sharding moves the result no more than
       another order of the same sums does, give or take k.

    The JAX dry run's last clause, at most one flip
    (``__graft_entry__.py:392-425``), is reported and not gated: on both
    scenes its 0.1 dB sits inside the control's spread. Raises
    AssertionError naming the clause; returns (the lines to print, the
    flipped seeds)."""
    flips = [s for s, d in d64.items() if max(d) > C64_TOL]
    lines = [f"seed {s}: c64 |dSDR| {d[0]:.4f}, |dSIR| {d[1]:.4f} (control "
             f"{control[s][0]:.4f}/{control[s][1]:.4f}, ratio {control_ratio(d, control[s]):.2f})"
             + (f"; c128 {d128[s][0]:.4f}/{d128[s][1]:.4f}" if s in d128 else "")
             + (" [basin flip]" if s in flips else "") for s, d in d64.items()]
    lines.append(f"the JAX rule of at most one c64 flip {'met' if len(flips) <= 1 else 'NOT met'}"
                 f" ({len(flips)}; reported, not gated)")
    text = "; ".join(lines)
    bad = [s for s, d in d128.items() if max(d) > C128_TOL]
    if bad:
        raise AssertionError(f"scaled c128 gate over {C128_TOL} dB on seeds {bad}: an "
                             f"implementation error, not chaos ({text})")
    missing = [s for s in flips if s not in d128]
    if missing:
        raise AssertionError(f"seeds {missing} flipped in complex64 with no complex128 check")
    over = [s for s, d in d64.items()
            if any(x > max(C64_TOL, k * c) for x, c in zip(d, control[s]))]
    if over:
        raise AssertionError(f"c64 deltas over max({C64_TOL} dB, {k:g} x the control) on seeds "
                             f"{over} ({text})")
    return lines, flips


def scaled_gate(n_ranks, device, launch_kw, seeds=SCALED_SEEDS, n_iter=SCALED_ITER,
                frames=48):
    """The scaled gate (module docstring, 3.; :func:`scaled_verdict`) on the
    ``frames`` scene's ``seeds``, on ``n_ranks`` new ranks; the references,
    the control and bss_eval in this process. Returns the lines it prints;
    raises if it fails."""
    from .. import api

    scenes = {s: scaled_mixture(s, n_samples=SCALED_SCENES[frames]) for s in seeds}

    def sharded_runs(runs):
        return launch(rank_scaled, n_ranks, ([(scenes[s][0], dt) for s, dt in runs],
                                             device.type, n_iter), **launch_kw)[0]

    refs = {}

    def d(s, Y, dt):
        X, mix, premix = scenes[s]
        if (s, dt) not in refs:
            ref = api.overiva(X.astype(dt), n_src=3, n_iter=n_iter, dtype=dt, device=device)
            refs[s, dt] = scene_scores(ref, mix, premix)
        return delta(scene_scores(Y, mix, premix), refs[s, dt])

    Ys = sharded_runs([(s, np.complex64) for s in seeds] + [(seeds[0], np.complex128)])
    d64 = {s: d(s, Y, np.complex64) for s, Y in zip(seeds, Ys)}
    d128 = {seeds[0]: d(seeds[0], Ys[-1], np.complex128)}
    control = {s: d(s, control_run(scenes[s][0], n_iter, device), np.complex64) for s in seeds}
    flips = [s for s in seeds[1:] if max(d64[s]) > C64_TOL]
    for s, Y in zip(flips, sharded_runs([(s, np.complex128) for s in flips]) if flips else []):
        d128[s] = d(s, Y, np.complex128)
    return scaled_verdict(d64, d128, control)[0]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ranks", type=int, default=8)
    parser.add_argument("--device", choices=("cpu", "cuda"), required=True)
    parser.add_argument("--backend", default=None,
                        help="gloo or nccl (default: nccl on cuda, gloo on cpu)")
    parser.add_argument("--frames", type=int, choices=sorted(SCALED_SCENES), default=48,
                        help="the scaled scene: 48 frames (the JAX dry run's) or 128")
    parser.add_argument("--seeds", type=int, nargs="+", default=list(SCALED_SEEDS),
                        help=f"the scaled scenes' seeds (held-out: {HELD_OUT_SEEDS})")
    parser.add_argument("--scaled-only", action="store_true",
                        help="run only the scaled gate")
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    n = args.ranks
    n_mix = 2 if n % 2 == 0 and n > 1 else 1
    shape = (n_mix, n // n_mix)
    device = torch.device(args.device)
    launch_kw = dict(device_type=args.device, backend=args.backend)

    if not args.scaled_only:
        tiny_checks(n, shape, device, launch_kw)
    t1 = time.perf_counter()
    lines = scaled_gate(n, device, launch_kw, tuple(args.seeds), frames=args.frames)
    print(f"dryrun ok: scaled overiva F=2049 M=8 N=3 T={args.frames} n_iter={SCALED_ITER} "
          f"({'; '.join(lines)}; gate {C64_TOL} dB or a c128-certified flip, within "
          f"{CONTROL_K:g} x the control; {time.perf_counter() - t1:.0f} s)")
    print(f"dryrun: all checks passed on {n} ranks ({args.device}) in "
          f"{time.perf_counter() - t0:.0f} s")


def tiny_checks(n, shape, device, launch_kw):
    """Checks 1 and 2 of the module docstring on ``n`` new ranks."""
    X = tiny_batch(*shape)
    outs = launch(rank_families, n, ([shape], X, device.type), **launch_kw)
    for name, [(_, worst)] in verify_families(outs, [shape], X, device).items():
        print(f"dryrun ok: {name} (sharded == single-device, {worst:.2g}x tol; "
              f"{outs[0][shape, name][1]} collectives a rank)", flush=True)

    from ..serving import Separator

    outs, n_buckets, _ = launch(rank_serving, n, (n, device.type), **launch_kw)[0]
    sep = Separator("overiva", n_src=2, nfft=128, dtype=np.complex128, n_iter=3, device=device)
    for i, (o, r) in enumerate(zip(outs, sep.separate_batch(serve_clips()))):
        err = np.abs(o - r).max()
        if o.shape != r.shape or err > 1e-7 * max(np.abs(r).max(), 1.0) + 1e-10:
            raise AssertionError(f"serving mesh clip {i}: sharded != meshless ({err:.3e})")
    print(f"dryrun ok: serving Separator over the mesh ({len(outs)} clips, {n_buckets} "
          "bucket groups, the batch axis on 'mix' == meshless)", flush=True)


if __name__ == "__main__":
    main()
