"""FastMNMF in complex64 on the card against the CPU, stage by stage.

    python -m overiva_tpu_torch.examples.fastmnmf_stages [--seed 7] [--device cuda]

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
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from overiva_tpu_torch import api, oracle, resolve_device
from overiva_tpu_torch.examples.parity_check import build_mixture, run_pipeline
from overiva_tpu_torch.models import fastmnmf2 as mn

NFFT, N_SRC, N_ITER, NMF_SEED = 1024, 2, 12, 5
EPS32 = 2.0**-23


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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cpu = torch.device("cpu")
    mix, premix = build_mixture(args.seed)
    hop = NFFT // 2
    X64 = oracle.analysis(oracle.stft_pad(mix, NFFT, hop), NFFT, hop)
    X = torch.from_numpy(X64.astype(np.complex64))
    print(f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
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

        def score(Y):
            sdr, sir = run_pipeline(lambda _: Y, mix, premix, NFFT)
            return sdr, sir

        ref_o = getattr(oracle, name)(X64, n_src=N_SRC, n_iter=N_ITER, seed=NMF_SEED)
        sdr_o, sir_o = score(ref_o)
        for label, Y in (("CPU", images(Xu_c, s_c, free_c, cpu)),
                         ("card", images(Xu_d, s_d, free_d, dev)),
                         ("card, CPU start", images(Xu_c, s_c, hyb, dev))):
            sdr, sir = score(Y)
            print(f"  {label:16s} |dSDR| {np.max(np.abs(sdr - sdr_o)):.4f}  "
                  f"|dSIR| {np.max(np.abs(sir - sir_o)):.4f} dB against the f64 oracle")


if __name__ == "__main__":
    main()
