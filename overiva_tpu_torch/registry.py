"""Algorithm registry: name -> runner, the 30 names of ``overiva_tpu.registry``
bound to the port's own functions, with the same flags and defaults.

    from overiva_tpu_torch.registry import get_algorithm, ALGORITHMS
    Y = get_algorithm("overiva-gauss")(X, n_src=2, n_iter=20, device="cpu")

``device`` is the torch device, passed through to every runner (batch
runners included): a call on the CPU never reaches CUDA, and a call on
the card never falls back to the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from . import api

__all__ = ["AlgorithmSpec", "ALGORITHMS", "get_algorithm", "applicable"]


@dataclass(frozen=True)
class AlgorithmSpec:
    """One separation algorithm variant.

    determined: requires n_src == n_chan. single_output: always extracts one
    source. min_src: smallest supported n_src (IP2 needs pairs).
    defaults: the reference's default kwargs. batch: the same algorithm
    over a (B, T, F, M) stack; element b's result matches ``run`` on X[b].
    frames: the runners take ``frames``, the real frame count of an input
    whose first frames are zero padding (each element's, as a sequence,
    for ``batch``): an NMF model's sums over frames need it, where the
    IP/ISS families' statistics carry a factor that is zero on a zero
    frame (``serving.py``).
    """

    name: str
    run: Callable
    determined: bool = False
    single_output: bool = False
    min_src: int = 1
    defaults: dict = field(default_factory=dict)
    batch: Callable | None = None
    frames: bool = False

    def __call__(self, X, n_src=None, **kw):
        params = {**self.defaults, **kw}
        if self.single_output:
            return self.run(X, **params)
        return self.run(X, n_src=n_src, **params)

    def run_batch(self, X_batch, n_src=None, **kw):
        """Batched dispatch with the same defaults; raises if no batch path."""
        if self.batch is None:
            raise ValueError(f"{self.name} has no batched implementation")
        params = {**self.defaults, **kw}
        if self.single_output:
            return self.batch(X_batch, **params)
        return self.batch(X_batch, n_src=n_src, **params)


def _gauss(fn):
    def run(X, **kw):
        kw.setdefault("model", "gauss")
        return fn(X, **kw)

    return run


def _df(fn):
    """The certification tier (acc="f32x2": complex128 on the
    complex64-rounded input) with the gauss model."""

    def run(X, **kw):
        kw.setdefault("model", "gauss")
        kw.setdefault("acc", "f32x2")
        return fn(X, **kw)

    return run


def _per_element(fn, X_batch, **kw):
    """``fn`` on each element of a batch, stacked: the batch contract of
    the certification tier, a tool and not a throughput path."""
    outs = [fn(Xb, **kw) for Xb in X_batch]
    return torch.stack(outs) if isinstance(X_batch, torch.Tensor) else np.stack(outs)


def _df_batch(fn):
    def run_batch(X_batch, **kw):
        kw.setdefault("model", "gauss")
        kw.setdefault("acc", "f32x2")
        return _per_element(fn, X_batch, **kw)

    return run_batch


def _dfj(fn):
    """The joint family's certification tier: acc="f32x2" without forcing a
    model (T-IP's thin certification margin is a laplace-path effect)."""

    def run(X, **kw):
        kw.setdefault("acc", "f32x2")
        return fn(X, **kw)

    return run


def _dfj_batch(fn):
    def run_batch(X_batch, **kw):
        kw.setdefault("acc", "f32x2")
        return _per_element(fn, X_batch, **kw)

    return run_batch


_TAPS = {"taps": 5, "delay": 2}
_OGIVE = {"n_iter": 4000, "step_size": 0.1, "tol": 1e-3}

ALGORITHMS: dict[str, AlgorithmSpec] = {
    s.name: s
    for s in [
        AlgorithmSpec("auxiva", api.auxiva, determined=True,
                      defaults={"n_iter": 20}, batch=api.overiva_batch),
        AlgorithmSpec("auxiva-gauss", _gauss(api.auxiva), determined=True,
                      defaults={"n_iter": 20}, batch=_gauss(api.overiva_batch)),
        AlgorithmSpec("auxiva-iss", api.auxiva_iss, determined=True,
                      defaults={"n_iter": 20}, batch=api.auxiva_iss_batch),
        AlgorithmSpec("auxiva-iss-gauss", _gauss(api.auxiva_iss), determined=True,
                      defaults={"n_iter": 20}, batch=_gauss(api.auxiva_iss_batch)),
        AlgorithmSpec("overiva", api.overiva, defaults={"n_iter": 20},
                      batch=api.overiva_batch),
        AlgorithmSpec("overiva-gauss", _gauss(api.overiva), defaults={"n_iter": 20},
                      batch=_gauss(api.overiva_batch)),
        AlgorithmSpec("overiva-gauss-df", _df(api.overiva), defaults={"n_iter": 20},
                      batch=_df_batch(api.overiva)),
        AlgorithmSpec("auxiva-gauss-df", _df(api.auxiva), determined=True,
                      defaults={"n_iter": 20}, batch=_df_batch(api.auxiva)),
        AlgorithmSpec("overiva-iss", api.overiva_iss, defaults={"n_iter": 20},
                      batch=api.auxiva_iss_batch),
        AlgorithmSpec("overiva-iss-gauss", _gauss(api.overiva_iss), defaults={"n_iter": 20},
                      batch=_gauss(api.auxiva_iss_batch)),
        AlgorithmSpec("tiss", api.tiss, defaults={"n_iter": 20, **_TAPS},
                      batch=api.tiss_batch),
        AlgorithmSpec("tiss-gauss", _gauss(api.tiss), defaults={"n_iter": 20, **_TAPS},
                      batch=_gauss(api.tiss_batch)),
        AlgorithmSpec("tip", api.tip, defaults={"n_iter": 10, "warm_iter": 10, **_TAPS},
                      batch=api.tip_batch),
        AlgorithmSpec("tip-gauss", _gauss(api.tip),
                      defaults={"n_iter": 10, "warm_iter": 10, **_TAPS},
                      batch=_gauss(api.tip_batch)),
        AlgorithmSpec("tiss-df", _dfj(api.tiss), defaults={"n_iter": 20, **_TAPS},
                      batch=_dfj_batch(api.tiss)),
        AlgorithmSpec("tip-df", _dfj(api.tip),
                      defaults={"n_iter": 10, "warm_iter": 10, **_TAPS},
                      batch=_dfj_batch(api.tip)),
        AlgorithmSpec("overiva-ip2", api.overiva_ip2, min_src=2, defaults={"n_iter": 10},
                      batch=api.overiva_ip2_batch),
        AlgorithmSpec("overiva-ip2-gauss", _gauss(api.overiva_ip2), min_src=2,
                      defaults={"n_iter": 10}, batch=_gauss(api.overiva_ip2_batch)),
        AlgorithmSpec("auxiva_pca", api.auxiva_pca, defaults={"n_iter": 20},
                      batch=api.auxiva_pca_batch),
        AlgorithmSpec("auxiva_pca-iss", api.auxiva_pca,
                      defaults={"n_iter": 20, "inner": "iss"}, batch=api.auxiva_pca_batch),
        AlgorithmSpec("auxiva_pca-ip2", api.auxiva_pca, min_src=2,
                      defaults={"n_iter": 10, "inner": "ip2"}, batch=api.auxiva_pca_batch),
        AlgorithmSpec("sparseauxiva", api.sparseauxiva, determined=True,
                      defaults={"n_iter": 20}, batch=api.sparseauxiva_batch),
        AlgorithmSpec("ilrma", api.ilrma, determined=True,
                      defaults={"n_iter": 30, "n_components": 2}, batch=api.ilrma_batch),
        AlgorithmSpec("ilrma-t", api.ilrma_t, determined=True,
                      defaults={"n_iter": 30, "n_components": 2, **_TAPS},
                      batch=api.ilrma_t_batch, frames=True),
        AlgorithmSpec("fastmnmf", api.fastmnmf, defaults={"n_iter": 30, "n_components": 2},
                      batch=api.fastmnmf_batch),
        AlgorithmSpec("fastmnmf2", api.fastmnmf2, defaults={"n_iter": 30, "n_components": 2},
                      batch=api.fastmnmf2_batch),
        AlgorithmSpec("five", api.five, single_output=True, defaults={"n_iter": 10},
                      batch=api.five_batch),
        AlgorithmSpec("ogive", api.ogive, single_output=True,
                      defaults={**_OGIVE, "update": "demix"}, batch=api.ogive_batch),
        AlgorithmSpec("ogive-mix", api.ogive, single_output=True,
                      defaults={**_OGIVE, "update": "mix"}, batch=api.ogive_batch),
        AlgorithmSpec("ogive-switching", api.ogive, single_output=True,
                      defaults={**_OGIVE, "update": "switching"}, batch=api.ogive_batch),
    ]
}


def get_algorithm(name: str) -> AlgorithmSpec:
    try:
        return ALGORITHMS[name]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {name!r}; available: {sorted(ALGORITHMS)}"
        ) from None


def applicable(name: str, n_src: int, n_chan: int) -> bool:
    """Whether this algorithm applies to an (n_src, n_chan) configuration."""
    spec = get_algorithm(name)
    if spec.single_output:
        return n_src == 1
    if spec.determined:
        return n_src == n_chan and n_src >= spec.min_src
    return spec.min_src <= n_src <= n_chan
