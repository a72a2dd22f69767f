"""PyTorch port: its own copies of the NumPy references, and its import
boundary.

The port keeps copies of the NumPy-only functions it needs
(``overiva_tpu_torch/oracle/``, ``overiva_tpu_torch/metrics/``,
``overiva_tpu_torch/utils/checkpoint.py``, and ``csrc/rir.cpp``, a byte
copy of ``native/rir.cpp``; the simulation copies are held in
``tests/test_torch_sim.py``) so that it imports nothing of the JAX
package. Each copy is held bit for bit
(``np.array_equal``) against its twin in ``overiva_tpu.oracle`` /
``overiva_tpu.metrics`` on seeded inputs, and no module of the port, nor
``chip_smoke.py``, imports ``overiva_tpu``.
"""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest

import overiva_tpu.metrics as jmetrics
import overiva_tpu.oracle as joracle
import overiva_tpu.oracle.models as jmodels
import overiva_tpu_torch.metrics as tmetrics
import overiva_tpu_torch.oracle as toracle

# the modules themselves: the packages export functions of the same names
jfastmnmf2 = importlib.import_module("overiva_tpu.oracle.fastmnmf2")
jsparse = importlib.import_module("overiva_tpu.oracle.sparseauxiva")
tfastmnmf2 = importlib.import_module("overiva_tpu_torch.oracle.fastmnmf2")
tsparse = importlib.import_module("overiva_tpu_torch.oracle.sparseauxiva")
# each copied entry point's twin (the JAX package's oracle package does not
# export ilrma)
JTWINS = {
    "auxiva": joracle.auxiva,
    "ilrma": importlib.import_module("overiva_tpu.oracle.ilrma").ilrma,
    "fastmnmf": joracle.fastmnmf,
    "fastmnmf2": joracle.fastmnmf2,
    "sparseauxiva": joracle.sparseauxiva,
    "tiss": joracle.tiss,
    "tip": joracle.tip,
    "ilrma_t": importlib.import_module("overiva_tpu.oracle.ilrma_t").ilrma_t,
    "wpe": importlib.import_module("overiva_tpu.oracle.wpe").wpe,
}

from helpers import make_mixture

REPO = Path(__file__).resolve().parents[1]


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert np.array_equal(a, b), (a, b)


@pytest.mark.parametrize("nfft,hop", [(512, 256), (256, 64)])
def test_stft_round_trip_bit_for_bit(nfft, hop):
    rng = np.random.default_rng(nfft + hop)
    x = rng.standard_normal((5000, 3))
    _equal(toracle.hann(nfft), joracle.hann(nfft))
    _equal(toracle.synthesis_window(toracle.hann(nfft), hop),
           joracle.synthesis_window(joracle.hann(nfft), hop))
    xp = toracle.stft_pad(x, nfft, hop)
    _equal(xp, joracle.stft_pad(x, nfft, hop))
    X = toracle.analysis(xp, nfft, hop)
    _equal(X, joracle.analysis(xp, nfft, hop))
    _equal(toracle.analysis(xp[:, 0], nfft, hop), joracle.analysis(xp[:, 0], nfft, hop))
    y = toracle.synthesis(X, nfft, hop)
    _equal(y, joracle.synthesis(X, nfft, hop))
    np.testing.assert_allclose(y[nfft - hop :][: x.shape[0]], x, atol=1e-10)
    with pytest.raises(ValueError, match="multiple of hop"):
        toracle.synthesis_window(toracle.hann(nfft), 3 * hop // 2 + 1)


@pytest.mark.parametrize("model", ["laplace", "gauss"])
def test_activations_and_projection_bit_for_bit(model):
    rng = np.random.default_rng(12)
    Y = rng.standard_normal((30, 9, 2)) + 1j * rng.standard_normal((30, 9, 2))
    Y[:, :, 1] *= 1e-9  # a quiet source: the relative floor bites
    _equal(toracle.activations(Y, model), joracle.activations(Y, model))
    ref = rng.standard_normal((30, 9)) + 1j * rng.standard_normal((30, 9))
    Y[:, 4, 1] = 0.0  # a silent (bin, source): z = 1 there
    _equal(toracle.projection_back(Y, ref), joracle.projection_back(Y, ref))
    _equal(toracle.apply_projection_back(Y, ref), joracle.apply_projection_back(Y, ref))
    E = rng.standard_normal((9, 4, 2)) + 1j * rng.standard_normal((9, 4, 2))
    _equal(toracle.align_eigvec_phase(E), jmodels.align_eigvec_phase(E))
    with pytest.raises(ValueError, match="source model"):
        toracle.activations(Y, "bogus")


@pytest.mark.parametrize(
    "kw", [{}, {"init_eig": True, "model": "gauss"}, {"proj_back": False}]
)
def test_overiva_oracle_bit_for_bit(kw):
    """5 float64 OverIVA iterations at M=4, N=2, with the filters."""
    rng = np.random.default_rng(4)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=4, n_samples=8000)
    X = joracle.analysis(joracle.stft_pad(mix, 256, 128), 256, 128)
    got = toracle.overiva(X, n_src=2, n_iter=5, return_filters=True, **kw)
    want = joracle.overiva(X, n_src=2, n_iter=5, return_filters=True, **kw)
    _equal(got, want)
    snaps_t, snaps_j = [], []
    toracle.overiva(X, n_src=2, n_iter=3, callback=snaps_t.append, callback_every=2)
    joracle.overiva(X, n_src=2, n_iter=3, callback=snaps_j.append, callback_every=2)
    _equal(tuple(snaps_t), tuple(snaps_j))


@pytest.fixture(scope="module")
def X4():
    rng = np.random.default_rng(5)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=4, n_samples=6000)
    return joracle.analysis(joracle.stft_pad(mix, 128, 64), 128, 64)


@pytest.mark.parametrize(
    "name,kw",
    [
        ("auxiva_iss", {"n_iter": 4, "model": "gauss"}),
        ("overiva_iss", {"n_src": 2, "n_iter": 4}),
        ("overiva_iss", {"n_src": 2, "n_iter": 3, "w0_rows": True}),
        ("overiva_ip2", {"n_src": 2, "n_iter": 3, "init_eig": True}),
        ("auxiva_ip2", {"n_iter": 3, "proj_back": False}),
        ("five", {"n_iter": 3}),
        ("ogive", {"n_iter": 40, "step_size": 0.05, "tol": 1e-4}),
        ("ogive", {"n_iter": 40, "update": "mix", "init_eig": True, "tol": 0.0}),
        ("ogive", {"n_iter": 40, "update": "switching", "switch_every": 3, "tol": 0.0}),
    ],
)
def test_family_oracles_bit_for_bit(X4, name, kw):
    """The ISS, IP2, FIVE and OGIVE oracles, with their filters and their
    callback snapshots."""
    kw = dict(kw)
    if kw.pop("w0_rows", False):
        rng = np.random.default_rng(8)
        F, M = X4.shape[1:]
        kw["W0"] = np.eye(M)[None, :2] + 0.1 * rng.standard_normal((F, 2, M))
    got = getattr(toracle, name)(X4, return_filters=True, **kw)
    want = getattr(joracle, name)(X4, return_filters=True, **kw)
    _equal(got, want)
    snaps_t, snaps_j = [], []
    every = 10 if name.startswith("ogive") else 2
    getattr(toracle, name)(X4, callback=snaps_t.append, callback_every=every, **kw)
    getattr(joracle, name)(X4, callback=snaps_j.append, callback_every=every, **kw)
    assert len(snaps_t) == len(snaps_j) >= 2
    _equal(tuple(snaps_t), tuple(snaps_j))


@pytest.mark.parametrize(
    "name,kw",
    [
        ("auxiva", {"n_iter": 4, "model": "gauss"}),
        ("ilrma", {"n_iter": 4, "seed": 3, "n_components": 3}),
        ("fastmnmf2", {"n_src": 2, "n_iter": 3, "seed": 5}),
        ("fastmnmf", {"n_src": 2, "n_iter": 3, "seed": 5, "n_q_sweeps": 2, "init": "eye"}),
        ("sparseauxiva", {"n_iter": 4, "lasso_iter": 30}),
        ("sparseauxiva", {"n_iter": 4, "n_bins": 20, "polish_iter": 0, "lasso_iter": 30,
                          "filter_taps": 16, "acausal_taps": 4}),
    ],
)
def test_tf_family_oracles_bit_for_bit(X4, name, kw):
    """The AuxIVA, ILRMA, FastMNMF1/2 and SparseAuxIVA oracles, with their
    filters (FastMNMF: the model (Q, g, W, H)) and callback snapshots."""
    X = X4[:, :, :2] if name == "sparseauxiva" else X4
    got = getattr(toracle, name)(X, return_filters=True, **kw)
    want = JTWINS[name](X, return_filters=True, **kw)
    _equal(got, want)
    snaps_t, snaps_j = [], []
    getattr(toracle, name)(X, callback=snaps_t.append, callback_every=2, **kw)
    JTWINS[name](X, callback=snaps_j.append, callback_every=2, **kw)
    assert len(snaps_t) == len(snaps_j) >= 2
    _equal(tuple(snaps_t), tuple(snaps_j))
    if name.startswith("fastmnmf"):
        _equal(toracle.fastmnmf2_loglik(X, *got[1]), jfastmnmf2.fastmnmf2_loglik(X, *got[1]))
        _equal(tfastmnmf2._wiener(X, got[1][0], got[1][1], got[1][2] @ got[1][3], 1),
               jfastmnmf2._wiener(X, got[1][0], got[1][1], got[1][2] @ got[1][3], 1))


@pytest.mark.parametrize(
    "name,kw",
    [
        ("tiss", {"n_src": 2, "taps": 2, "delay": 1, "n_iter": 4}),
        ("tiss", {"taps": 0, "n_iter": 3, "model": "gauss"}),
        ("tip", {"n_src": 2, "taps": 2, "delay": 1, "n_iter": 3, "warm_iter": 2}),
        ("tip", {"taps": 1, "delay": 2, "n_iter": 3, "warm_iter": 0, "proj_back": False}),
        ("ilrma_t", {"taps": 2, "delay": 1, "n_iter": 4, "seed": 2}),
    ],
)
def test_joint_oracles_bit_for_bit(X4, name, kw):
    """The T-ISS, T-IP and ILRMA-T oracles, with their filters, callback
    snapshots and the three W0 forms; ILRMA-T with its NMF model and
    likelihood."""
    X = X4[:, :, :2] if name == "ilrma_t" else X4
    got = getattr(toracle, name)(X, return_filters=True, **kw)
    want = JTWINS[name](X, return_filters=True, **kw)
    _equal(got, want)
    snaps_t, snaps_j = [], []
    getattr(toracle, name)(X, callback=snaps_t.append, callback_every=2, **kw)
    JTWINS[name](X, callback=snaps_j.append, callback_every=2, **kw)
    assert len(snaps_t) == len(snaps_j) >= 2
    _equal(tuple(snaps_t), tuple(snaps_j))
    P = got[1]
    N = kw.get("n_src", X.shape[2])
    for W0 in (P, P[:, :, : X.shape[2]], P[:, :N, : X.shape[2]]):
        if name == "ilrma_t" and W0.shape[1] != X.shape[2]:
            continue  # determined: no target-row form
        _equal(getattr(toracle, name)(X, W0=W0, **kw), JTWINS[name](X, W0=W0, **kw))
    if name == "ilrma_t":
        got = toracle.ilrma_t(X, return_filters=True, return_nmf=True, **kw)
        _equal(got, JTWINS[name](X, return_filters=True, return_nmf=True, **kw))
        jll = importlib.import_module("overiva_tpu.oracle.ilrma_t").ilrma_t_loglik
        tll = importlib.import_module("overiva_tpu_torch.oracle.ilrma_t").ilrma_t_loglik
        _equal(tll(X, got[1], *got[2], 2, 1), jll(X, got[1], *got[2], 2, 1))


@pytest.mark.parametrize("taps,delay", [(3, 1), (4, 2)])
def test_wpe_oracle_bit_for_bit(X4, taps, delay):
    jw = importlib.import_module("overiva_tpu.oracle.wpe")
    _equal(toracle.delayed_taps(X4, taps, delay), jw.delayed_taps(X4, taps, delay))
    _equal(toracle.delayed_taps(X4[:3], taps, delay), jw.delayed_taps(X4[:3], taps, delay))
    _equal(toracle.wpe(X4, taps, delay, n_iter=2), JTWINS["wpe"](X4, taps, delay, n_iter=2))


def test_sparse_helpers_bit_for_bit(X4):
    for k in (8, 16, 40):
        _equal(tsparse.select_bins(X4, k), jsparse.select_bins(X4, k))
    for n_bins in (None, 0.5, 12):
        _equal(tsparse._resolve_n_bins(n_bins, 65, 3), jsparse._resolve_n_bins(n_bins, 65, 3))
    rng = np.random.default_rng(9)
    B = rng.standard_normal((3, 20)) + 1j * rng.standard_normal((3, 20))
    S = np.sort(rng.choice(65, 20, replace=False))
    support = np.r_[np.arange(30), np.arange(128 - 6, 128)]
    _equal(tsparse.sparir(B, S, 128, support, 0.05, 40), jsparse.sparir(B, S, 128, support, 0.05, 40))


def test_bss_eval_sources_bit_for_bit():
    """A 3-source case, with and without the permutation search."""
    rng = np.random.default_rng(6)
    refs = rng.standard_normal((3, 4000))
    mixing = np.eye(3) + 0.3 * rng.standard_normal((3, 3))
    ests = (mixing @ refs)[[2, 0, 1]] + 0.05 * rng.standard_normal((3, 4000))
    got = tmetrics.bss_eval_sources(refs, ests)
    _equal(got, jmetrics.bss_eval_sources(refs, ests))
    assert list(got[3]) == [1, 2, 0]  # the permutation is found
    _equal(tmetrics.bss_eval_sources(refs, ests, compute_permutation=False, filter_length=64),
           jmetrics.bss_eval_sources(refs, ests, compute_permutation=False, filter_length=64))
    ev_t = tmetrics.BssEvalReferences(refs, 128)
    ev_j = jmetrics.BssEvalReferences(refs, 128)
    _equal(ev_t.evaluate(ests), ev_j.evaluate(ests))
    with pytest.raises(ValueError, match="non-silent"):
        tmetrics.bss_eval_sources(np.zeros((2, 100)), np.ones((2, 100)))


@pytest.mark.parametrize(
    "kw", [{"block": 16, "forget": 0.97, "n_pass": 2, "pb_forget": 0.9995},
           {"block": 7, "model": "gauss"}],
)
def test_online_iss_oracle_bit_for_bit(X4, kw):
    """The stream's oracle, with a final partial block."""
    jonline = importlib.import_module("overiva_tpu.oracle.online_iss")
    X = X4[:-3, :, :2]
    _equal(toracle.online_iss_run(X, **kw), jonline.online_iss_run(X, **kw))


def test_checkpoint_copy_bit_for_bit(tmp_path):
    """The same npz layout: each package's files load in the other."""
    jck = importlib.import_module("overiva_tpu.utils.checkpoint")
    tck = importlib.import_module("overiva_tpu_torch.utils.checkpoint")
    rng = np.random.default_rng(13)
    W = rng.standard_normal((5, 2, 3)) + 1j * rng.standard_normal((5, 2, 3))
    state = {"W": W, "den": rng.random((2, 5, 2)), "t_eff": np.float64(3.5)}
    for save, load in ((tck, jck), (jck, tck), (tck, tck)):
        p = save.save_filters(tmp_path / f"f_{save.__name__}", W, n_iter=3)
        _equal(load.load_filters(p)[0], W)
        assert load.load_filters(p)[1] == {"n_iter": 3}
        p = save.save_state(tmp_path / f"s_{save.__name__}.npz", state, cls="x")
        got, meta = load.load_state(p)
        assert set(got) == set(state) and meta == {"cls": "x"}
        for k in state:
            _equal(got[k], state[k])
    with pytest.raises(ValueError, match="may not contain"):
        tck.save_state(tmp_path / "bad", {"a__b": W})


@pytest.mark.parametrize("kw", [{"n_src": 2, "n_iter": 4}, {"n_src": 3, "n_iter": 3, "model": "gauss",
                                                        "proj_back": False},
                                {"n_iter": 2}])
def test_auxiva_pca_oracle_bit_for_bit(X4, kw):
    """PCA + AuxIVA with its filters and callback snapshots, and the PCA
    reduction with its basis."""
    jpca = importlib.import_module("overiva_tpu.oracle.auxiva_pca")
    _equal(toracle.auxiva_pca(X4, return_filters=True, **kw),
           jpca.auxiva_pca(X4, return_filters=True, **kw))
    snaps_t, snaps_j = [], []
    toracle.auxiva_pca(X4, callback=snaps_t.append, callback_every=1, **kw)
    jpca.auxiva_pca(X4, callback=snaps_j.append, callback_every=1, **kw)
    _equal(tuple(snaps_t), tuple(snaps_j))
    _equal(toracle.pca(X4, 2, return_basis=True), jpca.pca(X4, 2, return_basis=True))


def test_audio_copy_writes_the_same_wavs(tmp_path):
    """save_wavs writes the same bytes (normalized and not); the module is
    a byte copy, and AudioPlayer lists the files without a player."""
    jaudio = importlib.import_module("overiva_tpu.utils.audio")
    taudio = importlib.import_module("overiva_tpu_torch.utils.audio")
    assert ((REPO / "overiva_tpu_torch" / "utils" / "audio.py").read_bytes()
            == (REPO / "overiva_tpu" / "utils" / "audio.py").read_bytes())
    rng = np.random.default_rng(14)
    sigs = {"mono": rng.standard_normal(3000), "stereo": 0.3 * rng.standard_normal((2000, 2))}
    for normalize in (True, False):
        got = taudio.save_wavs(tmp_path / f"t{normalize}", 16000, sigs, normalize=normalize)
        want = jaudio.save_wavs(tmp_path / f"j{normalize}", 16000, sigs, normalize=normalize)
        assert [p.name for p in got] == [p.name for p in want] == ["mono.wav", "stereo.wav"]
        for a, b in zip(got, want):
            assert a.read_bytes() == b.read_bytes()
    player = taudio.AudioPlayer(got)
    player.player = None
    assert player.play(0) is False


def test_convergence_recorder_copy_bit_for_bit(X4):
    """The port's ConvergenceRecorder scores the same SDR/SIR as the JAX
    package's, from NumPy snapshots and from tensor ones."""
    import torch

    jprof = importlib.import_module("overiva_tpu.utils.profiling")
    tprof = importlib.import_module("overiva_tpu_torch.utils.profiling")
    rng = np.random.default_rng(15)
    n = (X4.shape[0] - 2) * 64
    refs = rng.standard_normal((2, n))
    Y = toracle.overiva(X4, n_src=2, n_iter=3)
    jrec = jprof.ConvergenceRecorder(refs, 128, n_samples=n, filter_length=32)
    trec = tprof.ConvergenceRecorder(refs, 128, n_samples=n, filter_length=32)
    jrec(Y)
    trec(Y)
    trec(torch.from_numpy(Y))
    _equal((trec.sdr[0], trec.sir[0]), (jrec.sdr[0], jrec.sir[0]))
    _equal((trec.sdr[1], trec.sir[1]), (jrec.sdr[0], jrec.sir[0]))


def test_rir_source_copy_is_byte_identical():
    assert ((REPO / "overiva_tpu_torch" / "csrc" / "rir.cpp").read_bytes()
            == (REPO / "native" / "rir.cpp").read_bytes())


def _port_sources():
    files = sorted((REPO / "overiva_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py"]
    return files


def _imported_modules(path):
    """Every module name an import statement of ``path`` names, with
    relative imports resolved against the file's package."""
    rel = path.relative_to(REPO).with_suffix("")
    package = list(rel.parts[:-1])
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[: len(package) - node.level + 1]
                stem = ".".join(base + ([node.module] if node.module else []))
            else:
                stem = node.module
            names.append(stem)
            names += [f"{stem}.{alias.name}" for alias in node.names]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


def test_port_never_imports_the_jax_package():
    files = _port_sources()
    for name in ("overiva", "auxiva_iss", "overiva_iss", "overiva_ip2", "five", "ogive",
                 "auxiva", "ilrma", "fastmnmf2", "sparseauxiva", "wpe", "tiss", "tip",
                 "ilrma_t", "online_iss"):
        assert REPO / "overiva_tpu_torch" / "oracle" / f"{name}.py" in files
    for rel in ("sim/room.py", "sim/_native.py", "utils/checkpoint.py", "serving.py",
                "examples/streaming.py", "examples/oneshot.py", "examples/serving.py",
                "examples/parity_check.py", "utils/audio.py", "utils/profiling.py",
                "oracle/auxiva_pca.py"):
        assert REPO / "overiva_tpu_torch" / rel in files
    offenders = {}
    for path in files:
        bad = [
            name for name in _imported_modules(path)
            if name == "overiva_tpu" or name.startswith("overiva_tpu.")
            or name == "jax" or name.startswith("jax.")
        ]
        if bad:
            offenders[str(path.relative_to(REPO))] = bad
    assert not offenders, offenders
