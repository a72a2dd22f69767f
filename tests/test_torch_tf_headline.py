"""PyTorch port: ILRMA, FastMNMF2/1 and SparseAuxIVA on the headline's
mixture (``chip_smoke.py``'s generator: M=8 mics, N=3 talkers, T=128
frames), cut to nfft 1024 (F=513), against the f64 oracle copies and the
JAX package at complex128.

With 3 talkers in 8 mics, five of the eight modeled dimensions hold only
noise, and the per-bin solves are much worse conditioned than at the
other files' M <= 3. FastMNMF's whitening start takes the eigenvectors
of a five-fold near-degenerate noise subspace, and SparseAuxIVA inverts
the reconstructed mixing of those noise outputs. The port is held to the
oracle at 3x what it measured here (MAX_REL), and to the JAX package
alike for FastMNMF2 (JAX runs one family, to keep the file short);
``chip_smoke.py`` phase 8 gates its full-width rows at 10x the measured
figure (MEASURED).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from overiva_tpu import api as japi
from overiva_tpu_torch import api as tapi
from overiva_tpu_torch import oracle as toracle

REPO = Path(__file__).resolve().parents[1]
# max|port - oracle| / max|oracle| over a family's outputs, measured on
# this mixture, and the bound the tests hold (ILRMA: element-wise instead,
# at the JAX package's rtol 1e-6 / atol 1e-9)
MEASURED = {"fastmnmf2": 2.88e-11, "fastmnmf": 2.88e-11, "sparseauxiva": 2.01e-9}
MAX_REL = {name: 3 * v for name, v in MEASURED.items()}
JAX_CHECKED = ("fastmnmf2",)


@pytest.fixture(scope="module")
def X8():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    rng = np.random.default_rng(0)
    mix, _ = chip_smoke.make_mixture(rng, 3, 8, 127 * 512)
    return toracle.analysis(toracle.stft_pad(mix, 1024, 512), 1024, 512), chip_smoke.TF_C128


def _outputs(out):
    Y, rest = out
    return (Y, *(rest if isinstance(rest, tuple) else (rest,)))


@pytest.mark.parametrize("name", ["ilrma", "fastmnmf2", "fastmnmf", "sparseauxiva"])
def test_headline_mixture_matches_oracle_and_jax(X8, name):
    X, rows = X8
    assert X.shape == (128, 513, 8)
    kw = next(kw for n, kw, _, _ in rows if n == name)  # chip_smoke's arguments
    got = _outputs(getattr(tapi, name)(X, return_filters=True, dtype=np.complex128,
                                       device="cpu", **kw))
    want = _outputs(getattr(toracle, name)(X, return_filters=True, **kw))
    refs = [want]
    if name in JAX_CHECKED:
        refs.append(_outputs(getattr(japi, name)(X, return_filters=True, dtype=np.complex128,
                                                 **kw)))
    for ref in refs:
        for a, o, b in zip(got, want, ref):
            a, o, b = (np.asarray(v) for v in (a, o, b))
            if name == "ilrma":
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
            else:
                assert np.abs(a - b).max() <= MAX_REL[name] * np.abs(o).max()
