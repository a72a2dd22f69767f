"""FastMNMF's whitening-start rotation control: the JAX package and the port
from the same rotated starts.

``overiva_tpu_torch/examples/fastmnmf_stages.py --rotate`` builds the
starts: the complex64 ``whiten_q`` start of a mixture, with each bin's
rows of the near-degenerate noise eigenspace turned by a seeded random
unitary (still a whitening). This file runs the JAX package's
``fastmnmf2_iterations`` (tied and untied g) from the same starts, which
the port may not import.

The tier-1 case runs it at a small size in complex128, where rounding
plays no part: every rotation moves the JAX package's Wiener images (the
result depends on which basis of the noise eigenspace it starts from),
and the port from the same start lands on the JAX package's images, so
both spread alike.

    python tests/test_torch_fastmnmf_rotation.py [--tau 0.5]

runs the control at full size on the CPU: parity_check's seed-7 scene
(nfft 1024, M=5, n_src=2, 12 epochs, NMF seed 5), complex64, each start
through the JAX function and the port, scored through iSTFT and bss_eval
against the float64 oracle as parity_check scores it.
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest
import torch

from overiva_tpu_torch.examples import fastmnmf_stages as stages

SMALL_ITER = 4  # epochs of the small case
SMALL_SPREAD = 0.05  # least relative move of the JAX images (CPU: 0.107-0.163)
SMALL_MATCH = 1e-9  # port vs JAX images from the same start, complex128


def jax_images(Xu, scale, state, n_iter, n_out=stages.N_SRC):
    """The JAX package's images (T, F, n_out) of ``n_iter`` epochs from the
    port's start tensors (batch axis 1)."""
    import jax.numpy as jnp

    from overiva_tpu.models import fastmnmf2 as jmn

    args = [jnp.asarray(t[0].resolve_conj().numpy()) for t in (Xu, *state)]
    st = jmn.fastmnmf2_iterations(*args, n_iter)
    Y = np.asarray(jmn.fastmnmf2_wiener(args[0], *st, 0)) * float(scale.reshape(()))
    en = np.sum(np.abs(Y) ** 2, axis=(0, 1))
    return Y[:, :, np.sort(np.argsort(-en, kind="stable")[:n_out])]


def small_mixture(seed=7, T=64, F=8, M=5, n_src=2):
    """Two Laplacian sources in M mics plus a white noise floor 30 dB down,
    per bin: (T, F, M) complex128. The M - n_src smallest eigenvalues of
    each bin are the noise floor's, close together."""
    rng = np.random.default_rng(seed)
    S = rng.laplace(size=(T, F, n_src)) * np.exp(2j * np.pi * rng.random((T, F, n_src)))
    A = rng.standard_normal((F, M, n_src)) + 1j * rng.standard_normal((F, M, n_src))
    noise = (rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))) * 10 ** (-1.5)
    return np.einsum("fmn,tfn->tfm", A, S) + noise


@pytest.mark.parametrize("tie_g", [True, False], ids=["fastmnmf2", "fastmnmf1"])
def test_rotation_moves_reference_and_port_alike(tie_g):
    X = torch.from_numpy(small_mixture())
    Xu, scale, starts, sizes = stages.rotation_starts(X, tie_g)
    assert sizes.max() == X.shape[2] - stages.N_SRC  # the noise sets are rotated
    cpu = torch.device("cpu")
    ref_j = ref_p = None
    for label, st in starts.items():
        if label == "exact eigh":
            continue
        Yj = jax_images(Xu, scale, st, SMALL_ITER)
        Yp = stages.run_from(Xu, scale, st, cpu, SMALL_ITER)
        norm = np.abs(Yj).max()
        assert np.abs(Yp - Yj).max() <= SMALL_MATCH * norm, label
        if label == "unrotated":
            ref_j, ref_p = Yj, Yp
            continue
        moved_j = np.abs(Yj - ref_j).max() / norm
        moved_p = np.abs(Yp - ref_p).max() / norm
        assert moved_j > SMALL_SPREAD, (label, moved_j)
        assert abs(moved_p - moved_j) <= 2 * SMALL_MATCH, (label, moved_p, moved_j)


def test_rotation_keeps_a_whitening():
    """A rotated start still whitens the covariance: Q C Q^H = I."""
    from overiva_tpu_torch.ops.covariance import covariance

    X = torch.from_numpy(small_mixture())
    Xu, _, starts, _ = stages.rotation_starts(X, True)
    C = covariance(Xu[0])
    for label, st in starts.items():
        Q = st[0][0]
        eye = torch.eye(Q.shape[-1], dtype=Q.dtype).expand_as(Q)
        assert float((Q @ C @ Q.mH - eye).abs().max()) < 1e-8, label


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tau", type=float, default=stages.GAP_TAU)
    args = p.parse_args(argv)
    scene = stages.parity_scene(7)
    X = torch.from_numpy(scene[2].astype(np.complex64))
    ref = stages.oracle_scores(7, scene)
    cpu = torch.device("cpu")
    print(f"scene: parity_check seed 7, X {tuple(X.shape)} complex64, {stages.N_ITER} epochs, "
          f"noise sets at relative gap < {args.tau}, rotations {stages.ROT_SEEDS}; |dSDR| / "
          "|dSIR| dB against the f64 oracle")
    for tie_g, name in ((True, "fastmnmf2"), (False, "fastmnmf")):
        Xu, scale, starts, sizes = stages.rotation_starts(X, tie_g, tau=args.tau)
        rows = {}
        for label, st in starts.items():
            got = [stages.scored(Y, scene, ref[name])
                   for Y in (jax_images(Xu, scale, st, stages.N_ITER),
                             stages.run_from(Xu, scale, st, cpu))]
            rows[label] = got
            print(f"  [{name}] {label:12s} JAX {got[0][0]:.4f} / {got[0][1]:.4f}   port "
                  f"{got[1][0]:.4f} / {got[1][1]:.4f}", flush=True)
        for i, who in enumerate(("JAX", "port")):
            rot = np.array([rows[f"rotation {s}"][i] for s in stages.ROT_SEEDS])
            print(f"  [{name}] {who} spread over the rotations: |dSDR| {rot[:, 0].min():.4f}-"
                  f"{rot[:, 0].max():.4f}, |dSIR| {rot[:, 1].min():.4f}-{rot[:, 1].max():.4f}")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    main()
