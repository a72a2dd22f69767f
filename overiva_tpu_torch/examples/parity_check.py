"""Parity check of the port: this machine's device vs the NumPy oracle.

The port's twin of ``examples/parity_check.py``, with the same cases,
flags, room and 0.1 dB gate, plus ``--device`` (default CUDA; ``--device
cpu`` runs on the CPU). Runs the full pipeline (simulate -> STFT ->
separate -> iSTFT -> bss_eval) twice per algorithm: once through the
port (complex64 on the device), once through the float64 NumPy oracle
(the port's own copies, ``overiva_tpu_torch.oracle``), and reports the
SDR/SIR deltas against the gate.

    python -m overiva_tpu_torch.examples.parity_check [--quick] [--seeds N]

``--seeds N`` runs every case over N seeds (seed 7, the historical worst
case, plus N-1 more) and reports the per-case worst delta.

The "df" rows are the certification tier ``acc="f32x2"``, which on this
hardware runs complex128 on the complex64-rounded input. The plain-c64
gauss, FIVE and IP2 rows carry an intrinsic complex64 floor (whole-epoch
rounding chaos, PARITY.md); they are printed, marked "(c64 floor)", and
excluded from the gate. The exit code is 0 only when the worst gated
delta is under 0.1 dB.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import overiva_tpu_torch.oracle as oracle
from overiva_tpu_torch import api, resolve_device
from overiva_tpu_torch.metrics import bss_eval_sources
from overiva_tpu_torch.sim import ShoeBox, circular_mic_array, semi_circle_layout, speech_like


def _online_iss_oracle(X, block=25):
    return oracle.online_iss_run(X[:, :, :2], block, forget=0.985, n_pass=2)


def _online_iss_port(X, device, block=25):
    Xc = X[:, :, :2]
    sep = api.OnlineAuxIVAISS(n_freq=Xc.shape[1], n_chan=2, forget=0.985, n_pass=2,
                              device=device)
    outs = [sep.process(Xc[s : s + block]) for s in range(0, Xc.shape[0], block)]
    return np.concatenate(outs, axis=0)


def run_pipeline(separate, mix, premix, nfft):
    hop = nfft // 2
    X = oracle.analysis(oracle.stft_pad(mix, nfft, hop), nfft, hop)
    Y = separate(X)
    y = oracle.synthesis(Y, nfft, hop)[nfft - hop :][: mix.shape[0]]
    refs = premix[:, 0, : mix.shape[0]]
    if Y.shape[2] == refs.shape[0]:
        sdr, sir, _, _ = bss_eval_sources(refs, y.T)
        return sdr, sir
    best = max(range(refs.shape[0]), key=lambda j: abs(np.dot(refs[j], y[:, 0])))
    pair = np.stack([refs[best], refs.sum(0) - refs[best]])
    est = np.stack([y[:, 0], mix[:, 0] - y[:, 0]])
    sdr, sir, _, _ = bss_eval_sources(pair, est, compute_permutation=False)
    return sdr[:1], sir[:1]


def build_mixture(seed):
    fs, n = 16000, 64000
    room = ShoeBox([7.0, 6.0, 3.0], fs=fs, rt60=0.22, seed=seed)
    for k, pos in enumerate(semi_circle_layout([3.5, 3.0, 1.5], np.pi / 2, 2.2, 2, rot=np.pi / 2)):
        room.add_source(pos, speech_like(n, fs, seed=seed * 13 + k))
    room.add_mic_array(circular_mic_array([3.5, 3.0, 1.5], 0.05, 5))
    premix, noise = room.simulate(return_premix=True, snr=25.0)
    mix = (premix.sum(axis=0) + noise).T[:n]
    return mix, premix


def cases_for(dev, quick=False):
    """(name, oracle_fn, port_fn[, gated]) of every case; ungated rows are
    informational (the plain-c64 floor, PARITY.md)."""
    d = {"device": dev}
    cases = [
        ("overiva M=5,N=2", lambda X: oracle.overiva(X, n_src=2, n_iter=15),
         lambda X: api.overiva(X, n_src=2, n_iter=15, **d)),
        ("auxiva M=N=2", lambda X: oracle.auxiva(X[:, :, :2], n_iter=15),
         lambda X: api.auxiva(X[:, :, :2], n_iter=15, **d)),
    ]
    if quick:
        return cases
    return cases + [
        ("overiva-gauss (c64 floor)",
         lambda X: oracle.overiva(X, n_src=2, n_iter=15, model="gauss"),
         lambda X: api.overiva(X, n_src=2, n_iter=15, model="gauss", **d),
         False),
        ("overiva-gauss df",
         lambda X: oracle.overiva(X, n_src=2, n_iter=15, model="gauss"),
         lambda X: api.overiva(X, n_src=2, n_iter=15, model="gauss", acc="f32x2", **d)),
        ("auxiva-gauss df",
         lambda X: oracle.auxiva(X[:, :, :2], n_iter=15, model="gauss"),
         lambda X: api.auxiva(X[:, :, :2], n_iter=15, model="gauss", acc="f32x2", **d)),
        ("auxiva_pca", lambda X: oracle.auxiva_pca(X, n_src=2, n_iter=15),
         lambda X: api.auxiva_pca(X, n_src=2, n_iter=15, **d)),
        ("auxiva_iss M=N=2", lambda X: oracle.auxiva_iss(X[:, :, :2], n_iter=15),
         lambda X: api.auxiva_iss(X[:, :, :2], n_iter=15, **d)),
        ("ogive N=1", lambda X: oracle.ogive(X, n_iter=60, step_size=0.05, tol=0),
         lambda X: api.ogive(X, n_iter=60, step_size=0.05, tol=0, **d)),
        ("fastmnmf2 N=2", lambda X: oracle.fastmnmf2(X, n_src=2, n_iter=12, seed=5),
         lambda X: api.fastmnmf2(X, n_src=2, n_iter=12, seed=5, **d)),
        ("fastmnmf N=2", lambda X: oracle.fastmnmf(X, n_src=2, n_iter=12, seed=5),
         lambda X: api.fastmnmf(X, n_src=2, n_iter=12, seed=5, **d)),
        ("sparseauxiva M=N=2",
         lambda X: oracle.sparseauxiva(X[:, :, :2], n_iter=15),
         lambda X: api.sparseauxiva(X[:, :, :2], n_iter=15, **d)),
        ("tiss M=5,N=2",
         lambda X: oracle.tiss(X, n_src=2, taps=3, delay=2, n_iter=15),
         lambda X: api.tiss(X, n_src=2, taps=3, delay=2, n_iter=15, **d)),
        ("tip M=5,N=2",
         lambda X: oracle.tip(X, n_src=2, taps=3, delay=2, n_iter=5, warm_iter=5),
         lambda X: api.tip(X, n_src=2, taps=3, delay=2, n_iter=5, warm_iter=5, **d)),
        ("tiss df M=5,N=2",
         lambda X: oracle.tiss(X, n_src=2, taps=3, delay=2, n_iter=15),
         lambda X: api.tiss(X, n_src=2, taps=3, delay=2, n_iter=15, acc="f32x2", **d)),
        ("tip df M=5,N=2",
         lambda X: oracle.tip(X, n_src=2, taps=3, delay=2, n_iter=5, warm_iter=5),
         lambda X: api.tip(X, n_src=2, taps=3, delay=2, n_iter=5, warm_iter=5,
                           acc="f32x2", **d)),
        ("ilrma_t M=N=2",
         lambda X: oracle.ilrma_t(X[:, :, :2], taps=3, delay=2, n_iter=15, seed=5),
         lambda X: api.ilrma_t(X[:, :, :2], taps=3, delay=2, n_iter=15, seed=5, **d)),
        # FIVE and IP2 carry an intrinsic complex64 floor like the gauss
        # family (the IP2 GEVD's 2x2 eigenvector branch and FIVE's whitened
        # power ordering are discontinuous in rounding; PARITY.md round 5)
        ("five N=1 (c64 floor)", lambda X: oracle.five(X, n_iter=10),
         lambda X: api.five(X, n_iter=10, **d), False),
        ("ilrma M=N=2",
         lambda X: oracle.ilrma(X[:, :, :2], n_iter=15, seed=5),
         lambda X: api.ilrma(X[:, :, :2], n_iter=15, seed=5, **d)),
        ("overiva-iss M=5,N=2",
         lambda X: oracle.overiva_iss(X, n_src=2, n_iter=15),
         lambda X: api.overiva_iss(X, n_src=2, n_iter=15, **d)),
        ("overiva-ip2 (c64 floor)",
         lambda X: oracle.overiva_ip2(X, n_src=2, n_iter=8),
         lambda X: api.overiva_ip2(X, n_src=2, n_iter=8, **d), False),
        # wpe certified end to end through the cascade it fronts
        ("wpe+overiva M=5,N=2",
         lambda X: oracle.overiva(oracle.wpe(X, taps=3, delay=2, n_iter=2), n_src=2,
                                  n_iter=15),
         lambda X: api.overiva(api.wpe(X, taps=3, delay=2, n_iter=2, **d), n_src=2,
                               n_iter=15, **d)),
        ("online-iss M=N=2 (stream)", _online_iss_oracle,
         lambda X: _online_iss_port(X, dev)),
    ]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true", help="2 algorithms only")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--seeds", type=int, default=1,
                   help="number of seeds (seed 7 first, then 0,1,2,...)")
    p.add_argument("--cases", type=str, default="",
                   help="comma-separated substring filter on case names")
    p.add_argument(
        "--device", default=None,
        help="torch device to run on (default: CUDA; 'cpu' runs on the CPU)",
    )
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.seeds > 1:
        first = args.seed  # 7 (the historical worst case) unless overridden
        seeds = [first] + [s for s in range(args.seeds * 2) if s != first]
        seeds = seeds[: args.seeds]
    else:
        seeds = [args.seed]

    cases = cases_for(dev, args.quick)
    if args.cases:
        keys = [k.strip() for k in args.cases.split(",") if k.strip()]
        cases = [c for c in cases if any(k in c[0] for k in keys)]

    mixtures = {s: build_mixture(s) for s in seeds}

    hdr = f"{'algorithm':26s} {'|dSDR| dB':>10s} {'|dSIR| dB':>10s}"
    print(f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    print(f"seeds: {seeds}")
    print(f"{hdr}  gate 0.1 dB (worst over seeds)")
    worst = 0.0
    for case in cases:
        name, f_oracle, f_port = case[0], case[1], case[2]
        gated = case[3] if len(case) > 3 else True
        dsdr = dsir = 0.0
        for s in seeds:
            mix, premix = mixtures[s]
            sdr_o, sir_o = run_pipeline(f_oracle, mix, premix, 1024)
            sdr_p, sir_p = run_pipeline(f_port, mix, premix, 1024)
            dsdr = max(dsdr, float(np.max(np.abs(sdr_p - sdr_o))))
            dsir = max(dsir, float(np.max(np.abs(sir_p - sir_o))))
        if gated:
            worst = max(worst, dsdr, dsir)
            flag = "OK" if max(dsdr, dsir) < 0.1 else "FAIL"
        else:
            flag = "(info only)"
        print(f"{name:26s} {dsdr:10.4f} {dsir:10.4f}  {flag}", flush=True)
    print(f"\nworst gated delta: {worst:.4f} dB -> "
          f"{'PASS' if worst < 0.1 else 'FAIL'}")
    return 0 if worst < 0.1 else 1


if __name__ == "__main__":
    raise SystemExit(main())
