"""PyTorch port: the serving tier's clip half, ``Separator`` on its
frame-bucket grid, against the JAX package on the CPU.

Gates:
- the grid (``bucket_frames``) and the tables (``SERVABLE``,
  ``_FUSED_BRANCH``, ``_BRANCH_KW``) equal the JAX package's;
- one case per fused branch, complex128, against the JAX ``Separator``
  at rtol 1e-9, atol 1e-12 of the largest sample, with the same ``stats``;
  ``wcov="bf16pack"`` at complex64 against the JAX package's
  interpret-mode Pallas kernel (tolerance below);
- padding invariance of all 17 SERVABLE names against the port's own
  unpadded pipeline (the JAX package's gates, tests/test_serving.py:
  rtol 1e-6, atol 1e-8 of the largest sample), also at a quarter hop;
- ``separate_batch`` equals per-clip (rtol 1e-9; a bf16pack group
  exactly), the int16 tiers bit for bit, the registry-runner fallback,
  the refusals, ``warmup``'s bucket count and ``stats`` against JAX.
"""

import numpy as np
import pytest
import torch

from overiva_tpu import serving as jserving
from overiva_tpu_torch import api as tapi
from overiva_tpu_torch import serving as tserving
from overiva_tpu_torch.oracle import stft_pad
from overiva_tpu_torch.registry import get_algorithm
from overiva_tpu_torch.serving import SERVABLE, Separator, bucket_frames

from helpers import make_mixture

NFFT, HOP = 128, 64
C128 = np.complex128
# bf16pack against the JAX package's interpret-mode kernel: both round the
# same two operands to bf16 (the phi weight and the weighted product x phi),
# each within one bf16 unit roundoff (2^-8) of the same value, and sum in
# f32 in another order; the outputs are held within the two roundings,
# 2 * 2^-8 of the largest sample
BF16PACK_TOL = 2 * 2.0**-8


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_after_module():
    """Free this module's JAX Separator executables when it finishes (see
    tests/test_serving.py: retained serving executables made a later
    module's XLA CPU compile segfault)."""
    yield
    import jax

    jax.clear_caches()


@pytest.fixture(scope="module")
def mixture():
    rng = np.random.default_rng(7)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=3, n_samples=4000)
    return mix


def _sep(algo, **kw):
    return Separator(algo, nfft=NFFT, hop=HOP, device="cpu", **kw)


def _n_src_for(spec):
    return None if spec.determined or spec.single_output else 2


def _close(got, want, rtol, atol_rel):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * np.abs(want).max())


def _unpadded(spec, x, n_src, hop=HOP, **kw):
    """The reference clip pipeline in the port: stft_pad -> analysis ->
    the registry runner -> synthesis, trimmed to the input span."""
    X = tapi.stft_analysis(stft_pad(x, NFFT, hop), NFFT, hop, dtype=C128, device="cpu")
    Y = spec(X, n_src=n_src, dtype=C128, device="cpu", **kw)
    if Y.ndim == 2:
        Y = Y[:, :, None]
    y = tapi.stft_synthesis(Y, NFFT, hop, dtype=C128, device="cpu")
    front = NFFT - hop
    return y[front : front + x.shape[0]]


@pytest.mark.parametrize("grid", [(32, 1.25, 8), (16, 1.5, 4), (40, 1.1, 16)])
def test_bucket_frames_match_jax(grid):
    for t in range(1, 401):
        assert bucket_frames(t, *grid) == jserving.bucket_frames(t, *grid), t
    with pytest.raises(ValueError):
        bucket_frames(0)


def test_tables_match_jax():
    assert SERVABLE == jserving.SERVABLE
    assert tserving._FUSED_BRANCH == jserving._FUSED_BRANCH
    assert Separator._BRANCH_KW == jserving.Separator._BRANCH_KW


FUSED_CASES = [
    ("overiva", 2, {}),
    ("overiva-ip2", 2, {}),
    ("auxiva-iss", None, {}),
    ("auxiva_pca", 2, {}),
    ("auxiva_pca-iss", 2, {}),
    ("five", None, {}),
    ("tiss", 2, {"taps": 2, "delay": 1}),
    ("tip", 2, {"taps": 2, "delay": 1, "warm_iter": 2}),
]


@pytest.mark.parametrize("algo,n_src,kw", FUSED_CASES, ids=[c[0] for c in FUSED_CASES])
def test_port_matches_jax(mixture, algo, n_src, kw):
    """One fused branch at complex128 against the JAX Separator, and the
    same bookkeeping."""
    args = dict(n_src=n_src, nfft=NFFT, hop=HOP, n_iter=4, dtype=C128, **kw)
    jsep = jserving.Separator(algo, **args)
    sep = Separator(algo, device="cpu", **args)
    assert sep.fused and sep._fused == jsep._fused
    _close(sep.separate(mixture), jsep.separate(mixture), 1e-9, 1e-12)
    assert sep.stats == jsep.stats and sep.stats["frames_padded"] > 0


def test_bf16pack_matches_jax_interpret(mixture):
    args = dict(n_src=2, nfft=NFFT, hop=HOP, n_iter=4, wcov="bf16pack")
    want = jserving.Separator("overiva", **args).separate(mixture)
    got = Separator("overiva", device="cpu", **args).separate(mixture)
    assert got.dtype == np.float32
    _close(got, want, 0, BF16PACK_TOL)


@pytest.mark.parametrize("algo", SERVABLE)
def test_padding_invariance(algo, mixture):
    spec = get_algorithm(algo)
    n_src = _n_src_for(spec)
    sep = _sep(algo, n_src=n_src, n_iter=6, dtype=C128)
    assert sep.fused
    got = sep.separate(mixture)
    # the bucket must actually pad, or the test proves nothing
    assert sep.stats["frames_padded"] > 0
    _close(got, _unpadded(spec, mixture, n_src, n_iter=6), 1e-6, 1e-8)


@pytest.mark.parametrize("algo", ["overiva", "tiss"])
def test_padding_invariance_quarter_hop(algo, mixture):
    """The invariance argument is hop-independent (the pad is t_pad * hop
    samples, tap delays count frames)."""
    hop = NFFT // 4
    kw = {"n_iter": 4}
    if algo == "tiss":
        kw.update(taps=2, delay=1)
    sep = Separator(algo, n_src=2, nfft=NFFT, hop=hop, dtype=C128, device="cpu", **kw)
    got = sep.separate(mixture)
    assert sep.stats["frames_padded"] > 0
    _close(got, _unpadded(get_algorithm(algo), mixture, 2, hop=hop, **kw), 1e-6, 1e-8)


def test_separate_batch_matches_per_clip(mixture):
    """A group of two (3600 and 3900 samples share a bucket) and a group
    of one; tensors in give tensors out."""
    sep = _sep("overiva", n_src=2, dtype=C128, n_iter=4)
    clips = [mixture[:3600], mixture[:2000], torch.from_numpy(mixture[:3900])]
    outs = sep.separate_batch(clips)
    assert sep.n_buckets() == 2 and sep.stats["clips"] == 3
    assert isinstance(outs[2], torch.Tensor)
    ref = _sep("overiva", n_src=2, dtype=C128, n_iter=4)
    for c, o in zip(clips, outs):
        assert o.shape == (c.shape[0], 2)
        _close(np.asarray(o), np.asarray(ref.separate(c)), 1e-9, 1e-12)


def test_separate_batch_single_output(mixture):
    sep = _sep("five", dtype=C128, n_iter=3)
    outs = sep.separate_batch([mixture[:3600], mixture[:3900]])
    assert [o.shape for o in outs] == [(3600, 1), (3900, 1)]
    ref = _sep("five", dtype=C128, n_iter=3)
    _close(outs[0], ref.separate(mixture[:3600]), 1e-9, 1e-12)
    assert _sep("five", dtype=C128, n_iter=3).separate(mixture[:, 0]).shape == (4000, 1)


def test_separate_batch_bf16pack_runs_per_clip(mixture):
    """The batch forms have no wcov tier: a bf16pack group runs clip by
    clip, so it equals the per-clip results exactly."""
    kw = dict(n_src=2, n_iter=3, wcov="bf16pack")
    sep = _sep("overiva", **kw)
    clips = [mixture[:3600], mixture[:3900]]
    outs = sep.separate_batch(clips)
    assert sep.n_buckets() == 1 and sep.stats["clips"] == 2
    ref = _sep("overiva", **kw)
    for c, o in zip(clips, outs):
        np.testing.assert_array_equal(o, ref.separate(c))


def _pcm(mixture):
    x_f = mixture[: 5 * NFFT]
    return np.clip(np.round(x_f / np.abs(x_f).max() * 20000), -32768, 32767).astype(np.int16)


def test_int16_input_tier_exact(mixture):
    """int16 PCM input is bit-identical to x.astype(rd) / 32768 (the
    widening cast and the 2^-15 scale are exact); all-int16 and mixed
    groups match the per-clip path."""
    sep = _sep("overiva", n_src=2, n_iter=4, dtype=C128)
    x_i = _pcm(mixture)
    np.testing.assert_array_equal(sep.separate(x_i), sep.separate(x_i.astype(np.float64) / 32768))
    np.testing.assert_array_equal(sep.separate(torch.from_numpy(x_i)).numpy(),
                                  sep.separate(x_i))
    clips = [x_i, x_i[: x_i.shape[0] - HOP]]
    for c, o in zip(clips, sep.separate_batch(clips)):
        np.testing.assert_allclose(o, sep.separate(c), rtol=1e-9, atol=0)
    mixed = [x_i, x_i[: x_i.shape[0] - HOP].astype(np.float64) / 32768]
    for c, o in zip(mixed, sep.separate_batch(mixed)):
        np.testing.assert_allclose(o, sep.separate(c), rtol=1e-9, atol=0)


def test_int16_output_tier(mixture):
    """out_dtype=np.int16 quantizes on the device exactly as a host wav
    writer would (round half to even at 32768, saturating), on the fused,
    batched and registry-runner paths."""
    x = mixture[: 5 * NFFT]
    kw = dict(n_src=2, n_iter=4, dtype=C128)
    for extra in ({}, {"chunk_frames": 16}):
        y_f = _sep("overiva", **kw, **extra).separate(x)
        sep_i = _sep("overiva", out_dtype=np.int16, **kw, **extra)
        y_i = sep_i.separate(x)
        assert y_i.dtype == np.int16 and sep_i.fused == (not extra)
        want = np.clip(np.round(y_f * 32768.0), -32768.0, 32767.0).astype(np.int16)
        np.testing.assert_array_equal(y_i, want)
    outs = _sep("overiva", out_dtype=np.int16, **kw).separate_batch([x, x[:-HOP]])
    np.testing.assert_array_equal(outs[0], want)
    # saturation: a loud clip clamps instead of wrapping
    loud = _sep("overiva", out_dtype=np.int16, **kw).separate(x * 40.0)
    assert loud.max() == 32767 or loud.min() == -32768
    with pytest.raises(ValueError, match="out_dtype"):
        _sep("overiva", out_dtype=np.float16, **kw)


def test_kwargs_outside_the_fused_surface_use_the_registry_runner(mixture):
    sep = _sep("overiva", n_src=2, n_iter=4, dtype=C128, chunk_frames=16)
    assert not sep.fused
    got = sep.separate(mixture)
    want = _unpadded(get_algorithm("overiva"), mixture, 2, n_iter=4, chunk_frames=16)
    _close(got, want, 1e-6, 1e-8)


def test_refusals(mixture):
    with pytest.raises(ValueError, match="not verified padding-invariant"):
        _sep("ilrma")
    with pytest.raises(ValueError, match="proj_back"):
        _sep("overiva", proj_back=False)
    with pytest.raises(ValueError, match="bf16pack"):
        _sep("tip", n_src=2, wcov="bf16pack")
    with pytest.raises(ValueError, match="ROADMAP item 17"):
        _sep("overiva", n_src=2, mesh=object())
    with pytest.raises(ValueError, match="one source"):
        _sep("five", n_src=2)
    with pytest.raises(ValueError, match="n_samples, n_chan"):
        _sep("overiva", n_src=2).separate(np.zeros((2, 3, 4)))


def test_allow_unverified_smoke(mixture):
    """An NMF family still runs on the bucket path when explicitly allowed,
    through the registry runner, single clips and groups."""
    sep = _sep("ilrma", dtype=C128, n_iter=3, allow_unverified=True)
    assert not sep.fused
    y = sep.separate(mixture)
    assert y.shape == (mixture.shape[0], 3) and np.isfinite(y).all()
    outs = sep.separate_batch([mixture[:3600], _pcm(mixture)])
    assert [o.shape for o in outs] == [(3600, 3), (5 * NFFT, 3)]
    assert all(np.isfinite(o).all() for o in outs)


def test_warmup_and_stats_match_jax(mixture, monkeypatch):
    """warmup touches the JAX Separator's buckets (the clip lengths it
    walks are the grid's, so the JAX side's separations are stubbed to
    its own bookkeeping), and a clip after it lands in a seen bucket."""
    def count_only(self, x):
        _, t_real, _, t_pad, _ = self._prep_clip(np.asarray(x))
        self._count(t_real, t_pad, x.shape[1])

    monkeypatch.setattr(jserving.Separator, "separate", count_only)
    for n_samples, kw in ((4000, {}), (9000, {"bucket_ratio": 1.5, "min_frames": 16})):
        jsep = jserving.Separator("auxiva", nfft=NFFT, hop=HOP, n_iter=1, **kw)
        sep = _sep("auxiva", n_iter=1, dtype=C128, **kw)
        touched = sep.warmup(n_chan=3, n_samples=n_samples, dtype=np.int16)
        assert touched == jsep.warmup(n_chan=3, n_samples=n_samples) == sep.n_buckets() >= 2
        assert sep.stats == jsep.stats
    for n in range(1, 3000, 37):
        assert sep._t_real_of(n) == jsep._t_real_of(n)
        assert sep._prep_clip(n) == jsep._prep_clip(np.zeros((n, 1)))[1:]
    before = sep.n_buckets()
    sep.separate(mixture)
    assert sep.n_buckets() == before
