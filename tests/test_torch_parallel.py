"""The port's multi-device tier (``overiva_tpu_torch/parallel/``) on a
4-rank gloo group on the CPU.

One module fixture spawns the four ranks once (``parallel/launch.py``): on
meshes (2, 2) and (1, 4) every sharded family runs at the dry run's tiny
shape (B=2, T=16, F=9, so the bins are padded, M=4, N=2, complex128), then
``Separator(mesh=...)`` on (4, 1) and the refusals. Each family's output
is held to the JAX package's ``overiva_tpu.parallel.sharded`` on a (2, 2)
mesh of the conftest's virtual CPU devices and to the port's single-device
``api`` run, both at ``1e-6 max(|Y_ref|max, 1) + 1e-8``; every rank must
return the same array, make the JAX epochs' count of collectives, and
load nothing of JAX.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overiva_tpu.parallel import sharded as jsharded
from overiva_tpu.parallel.mesh import make_mesh as jax_mesh
from overiva_tpu_torch.parallel import collectives, dryrun, sharded
from overiva_tpu_torch.parallel.launch import launch
from overiva_tpu_torch.parallel.mesh import make_mesh
from overiva_tpu_torch.serving import Separator

SHAPES = [(2, 2), (1, 4)]
NAMES = list(dryrun.FAMILIES)
CPU = torch.device("cpu")
X = dryrun.tiny_batch(2, 2)  # (2, 16, 9, 4) complex128


@pytest.fixture(scope="module")
def ranks():
    """What each of the four ranks returned (``dryrun.rank_checks``)."""
    return launch(dryrun.rank_checks, 4, (SHAPES, X, "cpu", 4), device_type="cpu",
                  timeout=300)


def _close(Y, ref, what):
    Y, ref = np.asarray(Y), np.asarray(ref)
    assert Y.shape == ref.shape, (what, Y.shape, ref.shape)
    err = np.abs(Y - ref).max()
    tol = 1e-6 * max(np.abs(ref).max(), 1.0) + 1e-8
    assert err <= tol, f"{what}: max |err| {err:.3e} > {tol:.3e}"


def _jax_sharded(name):
    """The JAX package's sharded run of ``name`` on a (2, 2) mesh."""
    fn, kw = dryrun.FAMILIES[name]
    mesh = jax_mesh(2, 2, devices=jax.devices()[:4])
    return np.asarray(getattr(jsharded, fn)(mesh, jnp.asarray(X),
                                            **dryrun.family_kwargs(name, X.shape[2])))


@pytest.mark.parametrize("name", NAMES)
def test_family_matches_jax_sharded(ranks, name):
    _close(ranks[0]["families"][(2, 2), name][0], _jax_sharded(name), name)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_family_matches_single_device(ranks, name, shape):
    Y = ranks[0]["families"][shape, name][0]
    assert dryrun.check_family(Y, X, name, CPU) <= 1.0


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_every_rank_returns_the_same(ranks, name, shape):
    Y = ranks[0]["families"][shape, name][0]
    assert isinstance(Y, np.ndarray) and Y.shape[:3] == X.shape[:3]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["families"][shape, name][0], Y)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_collectives_equal_the_jax_epochs(ranks, name, shape):
    want = dryrun.expected_collectives(name, X.shape[0] // shape[0])
    assert [r["families"][shape, name][1] for r in ranks] == [want] * 4


def test_serving_mesh_matches_meshless(ranks):
    outs, n_buckets, launches = ranks[0]["serving"]
    assert launches == dict(wcov_packed=0, update_rows=0)
    sep = Separator("overiva", n_src=2, nfft=128, dtype=np.complex128, n_iter=3, device="cpu")
    refs = sep.separate_batch(dryrun.serve_clips())
    assert n_buckets == sep.n_buckets() == 2
    for i, (o, r) in enumerate(zip(outs, refs)):
        assert o.shape == r.shape
        err = np.abs(o - r).max()
        assert err <= 1e-7 * max(np.abs(r).max(), 1.0) + 1e-10, (i, err)
    for r in ranks[1:]:
        for a, b in zip(r["serving"][0], outs):
            np.testing.assert_array_equal(a, b)


def test_serving_mesh_int16_out_equals_meshless(ranks):
    """int16 PCM out crosses the ranks as int32 (gloo has no int16 sum)."""
    sep = Separator("overiva", n_src=2, nfft=128, dtype=np.complex128, n_iter=3, device="cpu",
                    out_dtype=np.int16)
    for r in ranks:
        outs = r["serving_pcm"][0]
        for o, ref in zip(outs, sep.separate_batch(dryrun.serve_clips())):
            assert o.dtype == np.int16
            np.testing.assert_array_equal(o, ref)


@pytest.mark.parametrize("label, match", [
    ("batch", "not divisible by mix axis"),
    ("all bins", "all bins"),
    ("unsorted S", "increasing"),
    ("S rows", r"\(k,\) or \(B, k\)"),
])
def test_sharded_refusals(ranks, label, match):
    import re

    for r in ranks:
        assert r["refusals"][label] is not None and re.search(match, r["refusals"][label])


def test_ranks_load_no_jax(ranks):
    assert [r["jax_modules"] for r in ranks] == [[]] * 4


def test_no_card_raises_before_any_rank():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device_type"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device_type"):
        launch(dryrun.rank_families, 2, (), device_type="cuda")
    with pytest.raises(ValueError, match="device_type"):
        make_mesh(device_type="tpu")


def test_pad_bins_round_trip():
    for F, n in ((9, 2), (9, 4), (2049, 4), (8, 4), (1, 3)):
        F_pad, mask = sharded.pad_bins(F, n)
        assert F_pad % n == 0 and F <= F_pad < F + n
        assert mask.dtype == np.float32 and mask.sum() == F and mask[:F].all()


def test_group_none_is_not_a_collective():
    before = dict(collectives.counts)
    x = torch.arange(4.0)
    assert collectives.psum(x, None) is x and collectives.pmax(x, None) is x
    assert dict(collectives.counts) == before


D64 = {11: (0.03, 0.05), 12: (0.05, 0.11), 13: (1.1, 3.6)}
CONTROL = {11: (0.04, 0.08), 12: (0.04, 0.08), 13: (0.6, 1.07)}


@pytest.mark.parametrize("case, d64, d128, match", [
    ("passes", D64, {11: (0.0, 0.0), 12: (0.0, 0.0), 13: (0.0, 0.0)}, None),
    ("c128 pair off", D64, {11: (0.0, 0.03), 12: (0.0, 0.0), 13: (0.0, 0.0)},
     "implementation error"),
    ("flip unchecked", D64, {11: (0.0, 0.0), 13: (0.0, 0.0)}, "no complex128 check"),
    ("c64 past the control", {**D64, 13: (1.1, 4.5)},
     {11: (0.0, 0.0), 12: (0.0, 0.0), 13: (0.0, 0.0)}, "the control"),
])
def test_scaled_verdict(case, d64, d128, match):
    """The scaled gate's one verdict, shared by the dry run's CLI and
    chip_smoke.py: complex128 pairs within 0.02 dB, flips certified, every
    complex64 delta within max(0.1 dB, CONTROL_K x the control's)."""
    if match is None:
        lines, flips = dryrun.scaled_verdict(d64, d128, CONTROL)
        assert flips == [12, 13] and "NOT met (2" in lines[-1]
        assert "control 0.6000/1.0700, ratio 3.36" in lines[2]  # 3.6 / 1.07
    else:
        with pytest.raises(AssertionError, match=match):
            dryrun.scaled_verdict(d64, d128, CONTROL)


@pytest.mark.parametrize("d, c, want", [
    ((0.1, 0.3), (0.05, 0.3), 2.0), ((0.0, 0.2), (0.0, 0.1), 2.0),
    ((0.01, 0.0), (0.0, 0.0), np.inf), ((0.0, 0.0), (0.0, 0.0), 0.0),
])
def test_control_ratio(d, c, want):
    assert dryrun.control_ratio(d, c) == want


def test_scaled_scenes_have_their_frames():
    """Each scaled scene's sample count gives its frame count at nfft 4096."""
    from overiva_tpu_torch import oracle
    from overiva_tpu_torch.ops.stft import n_frames_of

    for frames, n_samples in dryrun.SCALED_SCENES.items():
        padded = oracle.stft_pad(np.zeros((n_samples, 1)), 4096, 2048).shape[0]
        assert n_frames_of(padded, 4096, 2048) == frames
    assert not set(dryrun.HELD_OUT_SEEDS) & set(dryrun.SCALED_SEEDS)


@pytest.mark.parametrize("fault, match", [("output", "disagree"), ("count", "collectives")])
def test_verify_families_refuses(fault, match):
    """``dryrun.verify_families`` fails on ranks that disagree or make
    another count of collectives than the JAX epochs, before any
    reference run."""
    Y = np.zeros((2, 16, 9, 2))
    want = dryrun.expected_collectives("overiva", 1)
    outs = [{((2, 2), "overiva"): (Y, want)} for _ in range(4)]
    outs[3] = {((2, 2), "overiva"): (Y + (fault == "output"), want + (fault == "count"))}
    with pytest.raises(AssertionError, match=match):
        dryrun.verify_families(outs, [(2, 2)], X, CPU)


@pytest.mark.parametrize("tie_g", [True, False])
def test_fastmnmf_start_on_a_shard_is_the_full_start_sliced(tie_g):
    """A bin shard's FastMNMF start whitens its own bins alone and equals
    the whole start sliced to them (the scale stays the whole mixture's)."""
    from overiva_tpu_torch.api import _mnmf_start

    Xb = torch.from_numpy(X)
    idx = torch.tensor([4, 5, 6, 7, 8, 8])  # the last shard of 2, padded

    def local(t):
        return t.index_select(2, idx)

    full = _mnmf_start(Xb, 3, 2, [3, 4], "whiten", tie_g)
    part = _mnmf_start(Xb, 3, 2, [3, 4], "whiten", tie_g, local=local)
    assert torch.equal(part[1], full[1])
    torch.testing.assert_close(part[0], local(full[0]), rtol=0, atol=0)
    torch.testing.assert_close(part[2][0], full[2][0].index_select(1, idx), rtol=1e-12,
                               atol=1e-12)
    g, W, H = full[2][1:]
    for a, b in zip(part[2][1:], (g if tie_g else local(g), local(W), H)):
        assert torch.equal(a, b)
