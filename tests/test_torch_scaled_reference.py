"""The JAX tier's own complex64 spread on the dry run's scaled scenes.

``overiva_tpu_torch/parallel/dryrun.py`` gates ``sharded_overiva`` against
``api.overiva`` on simulated rooms at F=2049, M=8, N=3, 20 iterations, and
prints beside each delta a control: ``api.overiva`` on its bins reversed.
This file holds the port's control to the JAX package's at a small size
(tier-1), and, run as a script, measures the JAX package's half of the
gate on the CPU: the JAX ``sharded_overiva`` on a (1, devices) mesh of
virtual CPU devices against the JAX ``api.overiva``, and the JAX control,
scored as the port's gate scores them:

    python tests/test_torch_scaled_reference.py [--frames 128] [--devices 4] [--seeds 11 12 ...]

With ``--trajectory`` it follows the first seed's complex64 outputs
instead, after 1, 2, 5, 10 and 20 iterations: max|sharded - single| and
max|control - single| over max|single|, for the port (``--devices`` gloo
ranks on the CPU) and for the JAX tier, and the port's single-device run
against the JAX package's. Whether sharding rounds like a reordering of
the same sums shows there, before chaos has grown it to dB.
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":  # before JAX is imported: the virtual CPU devices
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest

from overiva_tpu_torch.parallel import dryrun


def jax_control(X, n_iter=dryrun.SCALED_ITER):
    """The JAX package's twin of ``dryrun.control_run``."""
    from overiva_tpu import api

    return api.overiva(np.ascontiguousarray(X[:, ::-1]), n_src=3, n_iter=n_iter,
                       dtype=X.dtype)[:, ::-1]


@pytest.mark.parametrize("dtype", [np.complex128])
def test_control_matches_jax(dtype):
    """The port's control is the JAX package's: ``api.overiva`` on the
    bins reversed, put back in order (complex128, rtol 1e-9)."""
    rng = np.random.default_rng(4)
    X = (rng.standard_normal((24, 17, 4)) + 1j * rng.standard_normal((24, 17, 4))).astype(dtype)
    got = dryrun.control_run(X, n_iter=3, device="cpu")
    want = jax_control(X, n_iter=3)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12 * np.abs(want).max())


def trajectory(X, mesh, n_ranks, iters=(1, 2, 5, 10, 20)):
    """Prints the --trajectory lines (module docstring) for X (T, F, 8)."""
    import jax.numpy as jnp

    from overiva_tpu import api as japi
    from overiva_tpu.parallel.sharded import sharded_overiva
    from overiva_tpu_torch import api
    from overiva_tpu_torch.parallel.launch import launch

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    for k in iters:
        single = api.overiva(X, n_src=3, n_iter=k, device="cpu")
        sharded = launch(dryrun.rank_scaled, n_ranks, ([(X, X.dtype)], "cpu", k),
                         device_type="cpu")[0][0]
        j_single = japi.overiva(X, n_src=3, n_iter=k)
        j_sharded = np.asarray(sharded_overiva(mesh, jnp.asarray(X[None]), n_src=3,
                                               n_iter=k))[0]
        print(f"{k:2d} it: port sharded {rel(sharded, single):.2e}, control "
              f"{rel(dryrun.control_run(X, k, 'cpu'), single):.2e}; JAX sharded "
              f"{rel(j_sharded, j_single):.2e}, control {rel(jax_control(X, k), j_single):.2e}; "
              f"port vs JAX single-device {rel(single, j_single):.2e}", flush=True)


def main(argv=None):
    import argparse
    import time

    import jax
    import jax.numpy as jnp

    from overiva_tpu import api
    from overiva_tpu.parallel.mesh import make_mesh
    from overiva_tpu.parallel.sharded import sharded_overiva

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, choices=sorted(dryrun.SCALED_SCENES), default=128)
    p.add_argument("--devices", type=int, default=4)
    p.add_argument("--seeds", type=int, nargs="+", default=list(dryrun.SCALED_SEEDS))
    p.add_argument("--trajectory", action="store_true")
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    mesh = make_mesh(1, args.devices, devices=jax.devices()[: args.devices])
    n_samples = dryrun.SCALED_SCENES[args.frames]
    if args.trajectory:
        return trajectory(dryrun.scaled_mixture(args.seeds[0], n_samples=n_samples)[0], mesh,
                          args.devices)
    t0 = time.perf_counter()
    d64, d128, control = {}, {}, {}
    for s in args.seeds:
        X, mix, premix = dryrun.scaled_mixture(s, n_samples=n_samples)
        ref = {}

        def delta(Y, dt):
            if dt not in ref:
                ref[dt] = dryrun.scene_scores(
                    api.overiva(X.astype(dt), n_src=3, n_iter=dryrun.SCALED_ITER, dtype=dt),
                    mix, premix)
            return dryrun.delta(dryrun.scene_scores(Y, mix, premix), ref[dt])

        def shard(dt):
            return np.asarray(sharded_overiva(mesh, jnp.asarray(X[None].astype(dt)), n_src=3,
                                              n_iter=dryrun.SCALED_ITER))[0]

        d64[s] = delta(shard(np.complex64), np.complex64)
        control[s] = delta(jax_control(X), np.complex64)
        if s == args.seeds[0] or max(d64[s]) > dryrun.C64_TOL:
            d128[s] = delta(shard(np.complex128), np.complex128)
        print(f"seed {s}: c64 {d64[s][0]:.4f} / {d64[s][1]:.4f}, control {control[s][0]:.4f} / "
              f"{control[s][1]:.4f}" + (f", c128 {d128[s][0]:.4f} / {d128[s][1]:.4f}"
                                          if s in d128 else ""), flush=True)
    try:
        lines, _ = dryrun.scaled_verdict(d64, d128, control)
        verdict = f"passes the port's gate; {lines[-1]}"
    except AssertionError as e:
        verdict = f"fails the port's gate: {str(e).split(' (')[0]}"
    print(f"the JAX tier, T={args.frames}, (1, {args.devices}) CPU mesh: {verdict}; "
          f"{time.perf_counter() - t0:.0f} s")


if __name__ == "__main__":
    sys.exit(main())
