"""FastMNMF in complex64 on the card against the CPU, stage by stage, and
the whitening start's rotation control.

    python -m overiva_tpu_torch.examples.fastmnmf_stages [--seed 7] [--device cuda]
    python -m overiva_tpu_torch.examples.fastmnmf_stages --rotate [--tau 0.5] [--device cuda]

On ``examples/parity_check.py``'s scene (``build_mixture(seed)``, nfft
1024, M=5, n_src=2, 12 epochs, NMF seed 5), for FastMNMF2 (tied g) and
FastMNMF1 (untied g):

1. *free runs*: the whole run on ``--device`` and on the CPU, and the
   relative difference of Q, g, W and H after the start and after each
   epoch;
2. *stage by stage*: each stage of the start and of every epoch run on
   ``--device`` from the CPU run's own inputs to that stage, and the
   relative difference of its output from the CPU's: how far one stage
   alone moves the card away (in units of complex64's epsilon, 2^-23);
3. *hybrids*: the card's run with one stage taken from the CPU run (the
   start), scored like the free runs through iSTFT and bss_eval against
   the float64 oracle: the |dSDR| / |dSIR| that parity_check reports.

The stages are those of ``models/fastmnmf2.py``: ``unit_power`` and the
whitening ``eigh`` with ``align_eigvec_phase`` (the start), then per epoch
the NMF basis W, the activations H, the spatial weights g, the 1/D weights
and their covariances, the Q rows (``gauss_solve``, ``clamp_pow2``,
``quad_form``), the normalisation, and the Wiener images. The split is
``_epoch``'s own stage helpers, held bit for bit against ``_epoch`` on
the CPU before they are used.

``--rotate`` runs the control that tells a complex64 floor of the
reference from a fault of the port's start. The start ``whiten_q`` is
computed on the CPU (LAPACK) in complex64. Each bin's rows of the
near-degenerate noise eigenspace (:func:`noise_sets`: from the smallest
eigenvalue up, each next one whose relative gap to its neighbour,
(lam_k - lam_{k-1}) / lam_k, is below ``--tau``, at most M - n_src rows)
are turned by a seeded random unitary (:func:`rotate_noise`; Q stays a
whitening of the covariance). From each of :data:`ROT_SEEDS`' starts, and
from the unrotated one, the port's ``fastmnmf2_iterations`` runs on
``--device`` and is scored like parity_check against the float64 oracle.
Two more starts are scored beside them: the exact eigenvectors (the
complex128 ``eigh`` of the same complex64 covariance, rounded to
complex64), a start that differs from LAPACK's by complex64's rounding
alone, and the start ``whiten_q`` computes on ``--device`` itself, with
the share of its rows that are not the CPU's rows up to a phase. The JAX
package's half of the control (the same starts through
``overiva_tpu/models/fastmnmf2.py::fastmnmf2_iterations``) lives in
``tests/test_torch_fastmnmf_rotation.py``, which imports both packages.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from overiva_tpu_torch import api, oracle, resolve_device
from overiva_tpu_torch.examples.parity_check import build_mixture, run_pipeline
from overiva_tpu_torch.models import fastmnmf2 as mn
from overiva_tpu_torch.parallel.dryrun import delta

NFFT, N_SRC, N_ITER, NMF_SEED = 1024, 2, 12, 5
EPS32 = 2.0**-23
ROT_SEEDS = (1, 2, 3, 4, 5)  # the rotations of the control
GAP_TAU = 0.5  # relative eigenvalue gap under which a neighbour joins the noise set


def _rel(a, b):
    a, b = a.detach().cpu().to(torch.complex128), b.detach().cpu().to(torch.complex128)
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-300))


def split_epoch(X, state, dev, rec=None):
    """One epoch of ``models/fastmnmf2.py::_epoch``, its stage helpers one
    by one on ``dev``; with ``rec`` (the CPU run's stage outputs), each
    stage starts from the CPU's inputs and its output is recorded to be
    held against the CPU's."""
    def on(*ts):
        return [t.to(dev) for t in ts]

    Q, g, W, H = state
    out = {}
    Xd = X.to(dev)
    y = mn._diag_power(Xd, Q.to(dev))[1]
    out["W basis"] = mn._update_W(y, *on(g, W, H))
    W1 = rec["W basis"] if rec else out["W basis"].cpu()
    out["H activations"] = mn._update_H(y, *on(g, W1, H))
    H1 = rec["H activations"] if rec else out["H activations"].cpu()
    out["g weights"] = mn._update_g(y, *on(g, W1, H1))
    g1 = rec["g weights"] if rec else out["g weights"].cpu()
    out["1/D covariances"] = torch.stack(mn._q_covariances(Xd, *on(g1, W1, H1)))
    V1 = rec["1/D covariances"] if rec else out["1/D covariances"].cpu()
    out["Q rows"] = mn._q_rows(*on(Q, V1))
    Q1 = rec["Q rows"] if rec else out["Q rows"].cpu()
    out["normalisation"] = torch.cat([t.reshape(-1).to(torch.complex128)
                                      for t in mn._normalise(*on(Q1, g1, W1, H1))])
    new = mn._normalise(*[t.cpu() for t in (Q1, g1, W1, H1)])
    return {k: v.cpu() for k, v in out.items()}, new


def start(X, dev, tie_g):
    """(unit-power X, its scale, (Q, g, W, H)) of api.fastmnmf's start on ``dev``."""
    _, N = api._mnmf_slots(N_SRC, "auto", X.shape[2], "whiten")
    return api._mnmf_start(X.to(dev)[None], N, 2, [NMF_SEED], "whiten", tie_g)


def images(Xu, scale, state, dev):
    Y = mn.fastmnmf2_wiener(Xu.to(dev), *[t.to(dev) for t in state], 0) * scale.to(dev)
    return mn.pick_loudest(Y, N_SRC)[0].cpu().numpy()


def parity_scene(seed=7):
    """(mix, premix, X64) of parity_check's scene: its STFT in float64."""
    mix, premix = build_mixture(seed)
    hop = NFFT // 2
    return mix, premix, oracle.analysis(oracle.stft_pad(mix, NFFT, hop), NFFT, hop)


def oracle_scores(seed=7, scene=None, names=("fastmnmf2", "fastmnmf")):
    """{name: (SDR, SIR)} of the float64 oracle on parity_check's scene
    (``scene``: :func:`parity_scene`'s, else built), N_ITER epochs, NMF seed
    NMF_SEED, as parity_check scores it."""
    mix, premix, _ = scene or parity_scene(seed)
    return {name: run_pipeline(lambda X: getattr(oracle, name)(X, n_src=N_SRC, n_iter=N_ITER,
                                                                 seed=NMF_SEED), mix, premix, NFFT)
            for name in names}


def scored(Y, scene, ref):
    """(max |dSDR|, max |dSIR|) in dB of the images Y (T, F, N_SRC) of
    ``scene``, through parity_check's iSTFT and bss_eval, against the
    scores ``ref``."""
    return delta(run_pipeline(lambda _: Y, *scene[:2], NFFT), ref)


def describe(dev):
    return f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else "")


def noise_sets(ew, n_noise: int, tau: float = GAP_TAU):
    """(F,) rows of each bin's near-degenerate noise set. ``ew`` (F, M)
    ascending eigenvalues: the smallest, then each next one while its
    relative gap to the one below, (lam_k - lam_{k-1}) / lam_k, is under
    ``tau``, at most ``n_noise`` rows."""
    ew = np.asarray(ew, np.float64)
    close = (ew[:, 1:n_noise] - ew[:, : n_noise - 1]) < tau * ew[:, 1:n_noise]
    return 1 + np.cumprod(close, axis=1).sum(axis=1)


def haar_unitary(rng, k: int):
    """A (k, k) unitary drawn from the Haar measure."""
    Z = (rng.standard_normal((k, k)) + 1j * rng.standard_normal((k, k))) / np.sqrt(2.0)
    q, r = np.linalg.qr(Z)
    d = np.diag(r)
    return q * (d / np.abs(d))


def rotate_noise(Q, sizes, seed: int):
    """Q (F, M, M) with each bin's first ``sizes[f]`` rows (``whiten_q``'s
    rows of the smallest eigenvalues) turned by a Haar unitary of
    ``default_rng(seed)``: still a whitening of the covariance."""
    rng = np.random.default_rng(seed)
    Q = np.array(Q)
    for f, k in enumerate(sizes):
        U = haar_unitary(rng, int(k))
        if k > 1:
            Q[f, :k] = (U @ Q[f, :k].astype(np.complex128)).astype(Q.dtype)
    return Q


def exact_start(Xu):
    """``whiten_q`` of Xu (1, T, F, M) from the complex128 ``eigh`` of its
    complex64 covariance, rounded to complex64: the exact eigenvectors."""
    from overiva_tpu_torch.ops.covariance import covariance
    from overiva_tpu_torch.ops.linalg import align_eigvec_phase, mat_h

    ew, E = torch.linalg.eigh(covariance(Xu[0]).to(torch.complex128))
    E = align_eigvec_phase(E)
    Q = mat_h(E / torch.sqrt(torch.clamp_min(ew, 1e-12))[:, None, :])
    return Q.to(Xu.dtype).resolve_conj()[None]


def rotation_starts(X, tie_g, seeds=ROT_SEEDS, tau=GAP_TAU):
    """The control's starts on the CPU, from X (T, F, M) complex: (Xu
    (1, T, F, M), its scale, {label: (Q, g, W, H)}, the noise sets' sizes).
    Labels: "unrotated", "rotation <seed>" and "exact eigh"."""
    from overiva_tpu_torch.ops.covariance import covariance

    Xu, scale, state = start(X, torch.device("cpu"), tie_g)
    Q, rest = state[0].resolve_conj(), state[1:]
    ew = torch.linalg.eigvalsh(covariance(Xu[0])).numpy()
    sizes = noise_sets(ew, X.shape[2] - N_SRC, tau)
    starts = {"unrotated": (Q, *rest)}
    for s in seeds:
        starts[f"rotation {s}"] = (torch.from_numpy(rotate_noise(Q[0].numpy(), sizes, s))[None],
                                   *rest)
    starts["exact eigh"] = (exact_start(Xu), *rest)
    return Xu, scale, starts, sizes


def run_from(Xu, scale, state, dev, n_iter=N_ITER):
    """The port's images (T, F, N_SRC) of ``n_iter`` epochs from ``state``
    on ``dev``: ``fastmnmf2_iterations``, the Wiener images, the loudest."""
    st = mn.fastmnmf2_iterations(Xu.to(dev), *[t.to(dev) for t in state], n_iter)
    return images(Xu, scale, st, dev)


def row_cosines(Qa, Qb):
    """|<a_r, b_r>| / (|a_r| |b_r|) of every row pair of two (..., M, M)
    starts: 1 where a row is the other's up to a phase."""
    a = Qa.detach().cpu().to(torch.complex128)
    b = Qb.detach().cpu().to(torch.complex128)
    num = (a * b.conj()).sum(-1).abs()
    return (num / (a.norm(dim=-1) * b.norm(dim=-1))).numpy()


def rotate_main(args, dev):
    """The rotation control (module docstring) on ``dev``; prints each
    start's |dSDR| / |dSIR| against the float64 oracle and each variant's
    spread over the rotations."""
    scene = parity_scene(args.seed)
    X = torch.from_numpy(scene[2].astype(np.complex64))
    ref = oracle_scores(args.seed, scene)
    print(describe(dev))
    print(f"scene: parity_check seed {args.seed}, X {tuple(X.shape)} complex64, {N_ITER} epochs, "
          f"NMF seed {NMF_SEED}; noise sets: relative gap < {args.tau}, at most "
          f"{X.shape[2] - N_SRC} rows; rotations {ROT_SEEDS}")
    for tie_g, name in ((True, "fastmnmf2"), (False, "fastmnmf")):
        Xu, scale, starts, sizes = rotation_starts(X, tie_g, ROT_SEEDS, args.tau)
        if tie_g:
            print("noise set rows, bins with 1/2/3...: "
                  + "/".join(str(int(np.sum(sizes == k))) for k in range(1, sizes.max() + 1))
                  + f" of {sizes.size}")
        got = {}
        for label, st in starts.items():
            got[label] = scored(run_from(Xu, scale, st, dev), scene, ref[name])
            print(f"  [{name}] {label:12s} |dSDR| {got[label][0]:.4f}  |dSIR| "
                  f"{got[label][1]:.4f} dB against the f64 oracle", flush=True)
        rot = np.array([got[f"rotation {s}"] for s in ROT_SEEDS])
        print(f"  [{name}] spread over the {len(ROT_SEEDS)} rotations: |dSDR| "
              f"{rot[:, 0].min():.4f}-{rot[:, 0].max():.4f}, |dSIR| {rot[:, 1].min():.4f}-"
              f"{rot[:, 1].max():.4f} dB")
        Xu_d, scale_d, st_d = start(X, dev, tie_g)
        cos = row_cosines(st_d[0], starts["unrotated"][0])
        own = scored(images(Xu_d, scale_d, mn.fastmnmf2_iterations(Xu_d, *st_d, N_ITER), dev),
                     scene, ref[name])
        print(f"  [{name}] {dev.type} start: {np.mean(cos < 0.999) * 100:.1f} % of its rows turned "
              f"from the CPU's (|cos| < 0.999), {np.mean(cos < 0.9) * 100:.1f} % by more than "
              f"|cos| 0.9; its run |dSDR| {own[0]:.4f}  |dSIR| {own[1]:.4f} dB", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default=None)
    p.add_argument("--rotate", action="store_true",
                   help="run the whitening start's rotation control")
    p.add_argument("--tau", type=float, default=GAP_TAU,
                   help="relative eigenvalue gap of the noise sets (--rotate)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if args.rotate:
        return rotate_main(args, dev)
    cpu = torch.device("cpu")
    scene = parity_scene(args.seed)
    X = torch.from_numpy(scene[2].astype(np.complex64))
    scores = oracle_scores(args.seed, scene)
    print(describe(dev))
    print(f"scene: parity_check seed {args.seed}, X {tuple(X.shape)} complex64, "
          f"{N_ITER} epochs; differences relative to max|CPU|, in units of 2^-23")

    for tie_g, name in ((True, "fastmnmf2"), (False, "fastmnmf")):
        # the split is the epoch, bit for bit, on the CPU
        Xu_c, s_c, st_c = start(X, cpu, tie_g)
        ref = mn._epoch(Xu_c, *st_c)
        _, got = split_epoch(Xu_c, st_c, cpu)
        assert all(torch.equal(a, b) for a, b in zip(ref, got)), "split != _epoch"

        Xu_d, s_d, st_d = start(X, dev, tie_g)
        print(f"\n[{name}] start: Xu {_rel(Xu_d, Xu_c) / EPS32:.1f}, "
              f"Q (eigh + phase) {_rel(st_d[0], st_c[0]) / EPS32:.1f}")
        free_c, free_d, hyb = st_c, st_d, tuple(t.to(dev) for t in st_c)
        worst = {}
        for ep in range(N_ITER):
            rec, new_c = split_epoch(Xu_c, free_c, cpu)
            forced, _ = split_epoch(Xu_c, free_c, dev, rec)
            for k in rec:
                worst[k] = max(worst.get(k, 0.0), _rel(forced[k], rec[k]) / EPS32)
            free_c = new_c
            free_d = mn._epoch(Xu_d, *free_d)
            hyb = mn._epoch(Xu_c.to(dev), *hyb)
            print(f"  epoch {ep + 1:2d} free-run Q {_rel(free_d[0], free_c[0]) / EPS32:10.1f}"
                  f"  g {_rel(free_d[1], free_c[1]) / EPS32:10.1f}"
                  f"  W {_rel(free_d[2], free_c[2]) / EPS32:10.1f}"
                  f"  H {_rel(free_d[3], free_c[3]) / EPS32:10.1f}", flush=True)
        print("  one stage on the card from the CPU's inputs, worst over the epochs:")
        for k, v in worst.items():
            print(f"    {k:18s} {v:10.1f}")

        for label, Y in (("CPU", images(Xu_c, s_c, free_c, cpu)),
                         ("card", images(Xu_d, s_d, free_d, dev)),
                         ("card, CPU start", images(Xu_c, s_c, hyb, dev))):
            d_sdr, d_sir = scored(Y, scene, scores[name])
            print(f"  {label:16s} |dSDR| {d_sdr:.4f}  |dSIR| {d_sir:.4f} dB against the f64 oracle")


if __name__ == "__main__":
    main()
