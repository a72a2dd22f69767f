"""PyTorch port: the bench twin (``overiva_tpu_torch/examples/bench.py``)
against the repository's ``bench.py`` (imported by path) on the CPU: the
mixture draw bit for bit, the 35 keys of ``extra`` (an AST walk of
``bench.py``), a run at the twin's small shape with every value finite and
the draws in ``bench.py``'s order, the inputs of the headline, batch16,
T-ISS, FastMNMF2 and ILRMA rows bit for bit and their one-call outputs at
complex128 against the same lines of ``bench.py`` rebuilt with JAX, the
per-row guard, the time budget, and the CLI without a card.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from overiva_tpu.api import _prepare
from overiva_tpu.models import fastmnmf2 as jmnmf
from overiva_tpu.models.ilrma import ilrma_iterations as j_ilrma_iterations
from overiva_tpu.models.overiva import overiva_iterations as j_overiva_iterations
from overiva_tpu.models.tiss import augment_taps as j_augment_taps
from overiva_tpu.models.tiss import tiss_iterations as j_tiss_iterations
from overiva_tpu_torch.examples import bench as tb
from overiva_tpu_torch.ops.wcov_packed import wcov_packed

from test_torch_cli import CHILD

REPO = Path(__file__).resolve().parents[1]
S = tb.TINY
C128 = torch.complex128
# complex128 runs against the JAX package: tests/test_torch_overiva.py's
# tolerance for a run of epochs
RTOL, ATOL = 1e-6, 1e-8


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", REPO / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jbench = _jax_bench()


def _jx(re, im):
    """bench.py's ``jax.jit(lambda r, i: r + 1j * i)(re, im)``."""
    return jax.jit(lambda r, i: r + 1j * i)(re, im)


def _np(t):
    return t.resolve_conj().numpy()


def _close(got, want):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _bench_draws():
    """bench.py's draws from ``default_rng(0)`` at the twin's small shape:
    the headline, T512, certification and batch16 planes, in order."""
    rng = np.random.default_rng(0)
    head = jbench._make_mix(rng, S.T, S.F, S.M)
    long = jbench._make_mix(rng, S.T_long, S.F, S.M)
    df = jbench._make_mix(rng, *S.df[:3])
    reb = np.stack([jbench._make_mix(rng, S.T, S.F, S.M)[0] for _ in range(16)])
    imb = np.stack([jbench._make_mix(rng, S.T, S.F, S.M)[1] for _ in range(16)])
    return head, long, df, (reb, imb)


@pytest.fixture(scope="module")
def recorded():
    """One run of the twin at its small shape on the CPU, with the
    arguments of each call of the row functions and of the mixture draw
    recorded, and ``wcov_packed``'s launches over it."""
    calls = defaultdict(list)

    def recorder(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            calls[name].append((args, kw, out))
            return out

        return call

    with pytest.MonkeyPatch.context() as mp:
        for name in ("_make_mix", "overiva_iterations", "tiss_iterations",
                     "fastmnmf2_iterations", "ilrma_iterations"):
            mp.setattr(tb, name, recorder(name, getattr(tb, name)))
        wcov_packed.launches = 0
        out = tb.run("cpu", S, repeats=1)
        launches = wcov_packed.launches
    return out, calls, launches


def _bench_py_keys():
    """The keys bench.py writes into ``extra``: its ``extra[...] = ``
    targets, the f-string ones expanded over the two streaming rows, less
    the two bookkeeping keys."""
    keys = set()
    for node in ast.walk(ast.parse((REPO / "bench.py").read_text())):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if not (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                    and t.value.id == "extra"):
                continue
            if isinstance(t.slice, ast.Constant):
                keys.add(t.slice.value)
            else:
                assert isinstance(t.slice, ast.JoinedStr)
                tail = "".join(v.value for v in t.slice.values if isinstance(v, ast.Constant))
                keys |= {f"{name}{tail}" for name in ("online_iss", "online_tiss")}
    return keys - {"bench_errors", "bench_truncated_at"}


@pytest.mark.parametrize("seed,T,F,M", [(0, 128, 2049, 8), (3, 16, 17, 4), (7, 5, 9, 3)])
def test_make_mix_bit_for_bit(seed, T, F, M):
    got = tb._make_mix(np.random.default_rng(seed), T, F, M)
    want = jbench._make_mix(np.random.default_rng(seed), T, F, M)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and np.array_equal(g, w)


def test_extra_keys_are_bench_py_keys():
    keys = _bench_py_keys()
    assert len(keys) == 35 and set(tb.EXTRA_KEYS) == keys
    assert len(tb.EXTRA_KEYS) == 35


def test_tiny_run_has_every_key_finite(recorded):
    out, _, launches = recorded
    json.dumps(out)
    assert out["metric"] == "overiva_iters_per_sec_M8_N3_F2049" and out["unit"] == "iter/s"
    # both are rounded from the same unrounded rate, to 2 and 3 decimals
    assert out["value"] > 0 and out["vs_baseline"] == pytest.approx(out["value"] / 100.0,
                                                                     abs=6e-4)
    extra = out["extra"]
    assert set(extra) == set(tb.EXTRA_KEYS) | {"device"}, set(extra) ^ set(tb.EXTRA_KEYS)
    assert extra["device"] == "cpu"
    assert all(np.isfinite(extra[k]) for k in tb.EXTRA_KEYS)
    assert 1 <= extra["ogive_iters_done"] <= S.ogive_epochs
    assert launches == 0  # the CPU takes wcov_packed's plain version


def test_draws_in_bench_py_order(recorded):
    _, calls, _ = recorded
    shapes = [args[1:] for args, _, _ in calls["_make_mix"]]
    assert shapes == [(S.T, S.F, S.M), (S.T_long, S.F, S.M), S.df[:3],
                      *[(S.T, S.F, S.M)] * 32]
    want = _bench_draws()
    got = [out for _, _, out in calls["_make_mix"]]
    for g, w in zip(got[:3], want[:3]):
        assert all(np.array_equal(a, b) for a, b in zip(g, w))


def test_headline_matches_bench_lines(recorded):
    _, calls, _ = recorded
    (X, W_hat, Cx, n_src, n_iter, model), kw, _ = calls["overiva_iterations"][0]
    assert (n_src, n_iter, model, kw) == (S.N, S.n_iter, "laplace", {})
    Xj = _jx(*_bench_draws()[0])
    assert X.dtype == torch.complex64 and np.array_equal(X.numpy(), np.asarray(Xj))

    X2 = X.to(C128)
    W2, Cx2 = tb.prepare(X2, S.N, False)
    Xj2 = jnp.asarray(Xj, jnp.complex128)
    Wj, Cxj = _prepare(Xj2, Xj2[:0], S.N, False, True, False)
    _close(Cx2, Cxj)
    _close(W2, Wj)
    _close(tb.overiva_iterations(X2, W2, Cx2, S.N, S.n_iter, "laplace"),
           j_overiva_iterations(Xj2, Wj, Cxj, S.N, S.n_iter, "laplace"))


def test_batch16_matches_bench_lines(recorded):
    _, calls, _ = recorded
    (Xf, _, _, n_src, n_iter, model), kw, _ = next(
        c for c in calls["overiva_iterations"] if c[1].get("n_mix") == 16)
    assert (n_src, n_iter, model) == (S.N, S.n_iter, "laplace")
    Xb = _jx(*_bench_draws()[3])  # (16, T, F, M)
    folded = np.asarray(Xb).transpose(1, 0, 2, 3).reshape(S.T, 16 * S.F, S.M)
    assert Xf.dtype == torch.complex64 and np.array_equal(Xf.numpy(), folded)

    Xf2 = Xf.to(C128)
    W2, Cx2 = tb.prepare(Xf2, S.N, False)
    W2 = tb.overiva_iterations(Xf2, W2, Cx2, S.N, S.n_iter, "laplace", n_mix=16)
    Xb2 = jnp.asarray(Xb, jnp.complex128)
    prep_b = jax.jit(
        lambda xb: jax.vmap(lambda x: _prepare(x, x[:0], S.N, False, True, False))(xb))
    run_b = jax.jit(lambda xb, wb, cb: jax.vmap(
        lambda x, w, c: j_overiva_iterations(x, w, c, S.N, S.n_iter, "laplace"))(xb, wb, cb))
    Wj = run_b(Xb2, *prep_b(Xb2))
    _close(W2.reshape(16, S.F, S.M, S.M), Wj)


def test_tiss_start_matches_bench_lines(recorded):
    _, calls, _ = recorded
    (Xt5, Pt0, n_iter, model, n_chan), kw, _ = calls["tiss_iterations"][0]
    assert (n_iter, model, n_chan, kw) == (S.n_iter, "laplace", S.M, {"n_src": S.N})
    X5 = _jx(*_bench_draws()[1])
    Xtj = jax.jit(lambda x: j_augment_taps(x, 5, 2))(X5)
    Pj = jax.jit(
        lambda xt: jnp.zeros((S.F, S.M, xt.shape[2]), xt.dtype)
        .at[:, :, :S.M].set(jnp.eye(S.M, dtype=xt.dtype))
    )(Xtj)
    assert np.array_equal(Xt5.numpy(), np.asarray(Xtj))
    assert Pt0.dtype == torch.complex64 and np.array_equal(Pt0.numpy(), np.asarray(Pj))

    Xt2, P2 = tb.tiss_start(tb.mixture(*_bench_draws()[1], "cpu").to(C128))
    Xtj2, Pj2 = (jnp.asarray(a, jnp.complex128) for a in (Xtj, Pj))
    P2, _ = tb.tiss_iterations(Xt2, P2, S.n_iter, "laplace", S.M, n_src=S.N)
    Pj2, _ = j_tiss_iterations(Xtj2, Pj2, S.n_iter, "laplace", S.M, n_src=S.N)
    _close(P2, Pj2)


def _bench_mnmf_lines(X, M, F):
    """bench.py's FastMNMF2 lines (its 128 frames are X's)."""
    rngf = np.random.default_rng(1)
    g0 = np.full((M, M), 1e-2, np.float32)
    g0[np.arange(M), np.arange(M)] = 1.0
    g0 /= g0.sum(axis=1, keepdims=True)
    Wn = (rngf.random((M, F, 2)) + 0.1).astype(np.float32)
    Hn = (rngf.random((M, 2, X.shape[0])) + 0.1).astype(np.float32)
    return g0, Wn, Hn


def test_fastmnmf2_start_matches_bench_lines(recorded):
    _, calls, _ = recorded
    (Xu, Qw, g, W, H, n_iter), kw, _ = calls["fastmnmf2_iterations"][0]
    assert (n_iter, kw) == (S.n_iter, {})
    Xj = _jx(*_bench_draws()[0])
    for got, want in zip((g, W, H), _bench_mnmf_lines(Xj, S.M, S.F)):
        assert got.dtype == torch.float32 and np.array_equal(got[0].numpy(), want)

    Xu2, Q2, g2, W2, H2 = tb.fastmnmf2_start(tb.mixture(*_bench_draws()[0], "cpu").to(C128))
    Xuj, _ = jax.jit(jmnmf.unit_power)(jnp.asarray(Xj, jnp.complex128))
    Qj = jax.jit(jmnmf.whiten_q)(Xuj)
    _close(Xu2[0], Xuj)
    _close(Q2[0], Qj)
    gj, Wj, Hj = (jnp.asarray(a, jnp.float64) for a in _bench_mnmf_lines(Xj, S.M, S.F))
    Q2 = tb.fastmnmf2_iterations(Xu2, Q2, g2, W2, H2, S.n_iter)[0]
    _close(Q2[0], jmnmf.fastmnmf2_iterations(Xuj, Qj, gj, Wj, Hj, S.n_iter)[0])


def test_ilrma_start_matches_bench_lines(recorded):
    _, calls, _ = recorded
    (X, Weye, B0, H0, n_iter), kw, _ = calls["ilrma_iterations"][0]
    assert (n_iter, kw) == (S.n_iter, {})
    rngl = np.random.default_rng(2)
    B0j = (rngl.random((S.M, S.F, 2)) + 0.1).astype(np.float32)
    H0j = (rngl.random((S.M, 2, S.T)) + 0.1).astype(np.float32)
    assert np.array_equal(B0[0].numpy(), B0j) and np.array_equal(H0[0].numpy(), H0j)
    Xj = _jx(*_bench_draws()[0])
    assert np.array_equal(X[0].numpy(), np.asarray(Xj))
    assert np.array_equal(Weye[0].numpy(), np.broadcast_to(np.eye(S.M), (S.F, S.M, S.M)))

    X2 = X.to(C128)
    B2, H2 = tb.ilrma_start(X2[0])
    W2 = tb.ilrma_iterations(X2, Weye.to(C128), B2, H2, S.n_iter)[0]
    Xj2 = jnp.asarray(Xj, jnp.complex128)
    Wej = jnp.broadcast_to(jnp.eye(S.M, dtype=Xj2.dtype), (S.F, S.M, S.M))
    Wj = j_ilrma_iterations(Xj2, Wej, jnp.asarray(B0j, jnp.float64),
                            jnp.asarray(H0j, jnp.float64), S.n_iter)[0]
    _close(W2[0], Wj)


def _raiser(exc):
    def call(*args, **kw):
        raise exc

    return call


def test_failing_row_is_listed_and_the_rest_run(monkeypatch):
    monkeypatch.setattr(tb, "fold_mixtures", _raiser(ValueError("bad shape")))
    extra = tb.run("cpu", S, repeats=1)["extra"]
    assert extra["bench_errors"] == ["overiva_batch16: ValueError: bad shape"]
    assert set(extra) == set(tb.EXTRA_KEYS) - {"overiva_batch16_it_s_per_mix"} | {
        "device", "bench_errors"}


@pytest.mark.parametrize("exc", [
    torch.AcceleratorError("CUDA error: an illegal memory access was encountered"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError("CUDA error: unspecified launch failure"),
], ids=lambda e: type(e).__name__)
def test_cuda_error_ends_the_run(monkeypatch, exc):
    monkeypatch.setattr(tb, "fold_mixtures", _raiser(exc))
    with pytest.raises(type(exc), match="CUDA"):
        tb.run("cpu", S, repeats=1)


def test_budget_skips_the_extras(monkeypatch):
    monkeypatch.setenv("OVERIVA_BENCH_BUDGET_S", "0")
    out = tb.run("cpu", S, repeats=1)
    assert out["value"] > 0
    assert out["extra"] == {"device": "cpu", "bench_truncated_at": "overiva_marginal_it_s"}


def test_cli_without_card_or_device_raises():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, "overiva_tpu_torch.examples.bench"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode not in (0, 97), proc.stderr
    assert "RuntimeError" in proc.stderr and 'pass device="cpu"' in proc.stderr
    assert proc.stdout == ""
