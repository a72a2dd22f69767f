"""NumPy oracle SparseAuxIVA (AuxIVA on a sparse bin subset + LASSO
reconstruction of the remaining bins' demixing): the port's copy of
``overiva_tpu/oracle/sparseauxiva.py``, the float64 reference that
``chip_smoke.py`` holds the port to.

Extension completing the ``pyroomacoustics.bss`` family surface the
reference draws its baselines from (SURVEY.md §2.1/§2.5 internalize
``auxiva``/``ilrma``; pyroomacoustics also ships ``sparseauxiva``):

    J. Jansky, Z. Koldovsky, N. Ono, "A computationally cheaper method
    for blind speech separation based on AuxIVA and incomplete demixing
    transform", IWAENC 2016.

Idea: the expensive IP updates run only on a selected subset S of bins;
the remaining bins are filled by exploiting that the RELATIVE transfer
functions (RTFs) of the estimated mixing system are short/sparse
time-domain filters. Design decisions here, each locked by A/B
measurement on seeded convolutive mixtures (tests/test_sparseauxiva.py
carries the gates):

- **Bin selection is stratified by frequency** (highest-power bin per
  band), NOT global top power: clustered low-frequency samples are
  maximally coherent for time-domain recovery and reconstruction fails
  (held-out filter error ~1.0 vs ~0.4 rel); equispaced bins alias.
- **Reconstruct the mixing side, not the demixing rows**: per source i,
  A(f) = W(f)^-1 columns normalized to mic 0 (r_i(f) = a_i(f)/a_i0(f),
  so r_i0 = 1 everywhere — kills the per-bin scale ambiguity with no
  projection-back step). RTFs are near-FIR; demixing rows are matrix
  inverses (rational, long) and reconstruct measurably worse. The
  demixing at reconstructed bins is then inv(A_rec) per bin, whose
  output is directly the source image at mic 0 (minimal distortion).
- **Support restriction**: the LASSO searches only `filter_taps`
  causal + `acausal_taps` wrap-around taps (direct path + early
  reflections + small negative-delay allowance). At k = F/4 selected
  bins this alone moves SIR from ~5 to ~20 dB on the gate mixture.
- **Optional polish** (`polish_iter` full-band IP epochs warm-started
  from the reconstruction): 2-3 polish epochs reach full-AuxIVA quality
  at a fraction of full cost (k=F/4 + 3 polish: within ~1.5 dB of
  20 full epochs; k=F/2 + 3: identical to it).

FISTA on the partial-DFT LASSO: A g = [DFT_nfft g](S), and because g
spans the full circle the rows of A are orthogonal (A A^H = nfft I), so
the step size is exactly 1/nfft.
"""

from __future__ import annotations

import numpy as np

from .auxiva import auxiva
from .projection import projection_back

__all__ = ["sparseauxiva", "select_bins", "sparir"]


def select_bins(X: np.ndarray, n_bins: int) -> np.ndarray:
    """Stratified selection: split the spectrum into ``n_bins`` bands and
    take the highest-mean-power bin of each (sorted, unique)."""
    F = X.shape[1]
    power = np.sum(np.abs(X) ** 2, axis=(0, 2))
    edges = np.linspace(0, F, min(n_bins, F) + 1).astype(int)
    return np.array(sorted(
        a + int(np.argmax(power[a:b]))
        for a, b in zip(edges[:-1], edges[1:]) if b > a
    ))


def sparir(
    B: np.ndarray,
    S: np.ndarray,
    nfft: int,
    support: np.ndarray,
    lam_ratio: float = 0.05,
    n_iter: int = 300,
):
    """Batched FISTA for the support-restricted partial-DFT LASSO.

    B: (..., k) complex measurements at rfft-grid bins ``S``;
    ``support``: tap indices the filters may use. Returns g
    (..., len(support)) real. lam = lam_ratio * ||A^H b||_inf per filter.
    """
    S = np.asarray(S)
    E = np.exp(-2j * np.pi * np.outer(support, S) / nfft)  # (|sup|, k)

    def A(g):
        return g.astype(complex) @ E

    def AH(r):
        return np.real(r @ np.conj(E).T)

    lam = lam_ratio * np.max(np.abs(AH(B)), axis=-1, keepdims=True)
    step = 1.0 / nfft  # A A^H = nfft I on the full circle; subset is <=

    g = np.zeros(B.shape[:-1] + (len(support),))
    v, t = g, 1.0
    for _ in range(n_iter):
        u = v - step * AH(A(v) - B)
        g_new = np.sign(u) * np.maximum(np.abs(u) - step * lam, 0.0)
        t_new = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t * t))
        v = g_new + ((t - 1.0) / t_new) * (g_new - g)
        g, t = g_new, t_new
    return g


def _resolve_n_bins(n_bins, F: int, M: int) -> int:
    """None -> max(M^2, F/4); float in (0, 1] -> fraction of F; int -> count."""
    if n_bins is None:
        return max(M * M, int(np.ceil(0.25 * F)))
    if isinstance(n_bins, float):
        if not 0.0 < n_bins <= 1.0:
            raise ValueError("fractional n_bins must be in (0, 1]")
        return max(M * M, int(np.ceil(n_bins * F)))
    return int(n_bins)


def sparseauxiva(
    X: np.ndarray,
    S: np.ndarray | None = None,
    n_bins=None,
    n_src: int | None = None,
    n_iter: int = 20,
    proj_back: bool = True,
    W0: np.ndarray | None = None,
    model: str = "laplace",
    lasso_iter: int = 300,
    lasso_lam: float = 0.05,
    filter_taps: int | None = None,
    acausal_taps: int | None = None,
    polish_iter: int = 3,
    return_filters: bool = False,
    callback=None,
    callback_every: int = 10,
):
    """X: (n_frames, n_freq, n_chan) complex. S: sorted bin indices for
    the IP updates; or give ``n_bins`` (count, or fraction of F) and let
    the stratified selector pick them (default F/4). Regime guidance,
    measured (data/waspaa_sparseauxiva/RESULTS.md): F/4 suffices when
    the relative filters are short vs nfft (mild reverb / large nfft);
    on reverberant WASPAA rooms (RT60 0.25 s, nfft 4096) use
    ``n_bins=0.5`` — with 3-5 polish epochs it MATCHES or beats 20
    full-band epochs at ~35 % less IP work, while F/4 falls several dB
    short there. Determined (n_src == n_chan) like the underlying
    AuxIVA. Returns Y
    (n_frames, n_freq, n_src) [, W (n_freq, n_src, n_chan): measured IP
    rows at S (minimal-distortion-scaled), inv(A_rec) rows elsewhere,
    polished full-band if ``polish_iter`` > 0].

    ``filter_taps``/``acausal_taps``: RTF support (defaults nfft//4 and
    nfft//16). ``polish_iter``: full-band IP epochs warm-started from the
    reconstruction (default 3 — measured on the gate mixture: p0 18.8/3.8 dB SIR, p2 21.9/20.6, p3 29.2/28.4 vs 32.1/29.4 for 20 full-band epochs at ~2.5x the IP cost; 0 = pure IWAENC-style reconstruction).
    ``callback`` receives full-band (T, F, N) snapshots whose
    non-selected bins are zero during the sparse phase.
    """
    X = np.asarray(X)
    T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if N != M:
        raise ValueError("sparseauxiva is determined: n_src must equal n_chan")
    nfft = 2 * (F - 1)
    if S is None:
        S = select_bins(X, _resolve_n_bins(n_bins, F, M))
    S = np.asarray(S)
    if S.ndim != 1 or S.size == 0 or S[-1] >= F or S[0] < 0:
        raise ValueError("S must be a non-empty 1-D array of bin indices < F")
    if np.any(np.diff(S) <= 0):
        raise ValueError("S must be strictly increasing (sorted, unique)")
    n_causal = nfft // 4 if filter_taps is None else int(filter_taps)
    n_acausal = nfft // 16 if acausal_taps is None else int(acausal_taps)

    Xs = X[:, S, :]

    cb = None
    if callback is not None:
        def cb(Ys):  # scatter the S-bin snapshot into a full-band canvas
            full = np.zeros((T, F, N), dtype=X.dtype)
            full[:, S, :] = Ys
            callback(full)

    Ws0 = W0[S] if W0 is not None else None
    _, Ws = auxiva(
        Xs, n_src=N, n_iter=n_iter, proj_back=False, W0=Ws0, model=model,
        return_filters=True, callback=cb, callback_every=callback_every,
    )

    if S.size == F:  # nothing to reconstruct: exact AuxIVA degeneration
        W = Ws
    else:
        # mixing-side RTFs on the measured bins: columns of W^-1 scaled
        # to unit response at mic 0
        A_s = np.linalg.inv(Ws)  # (k, M, N)
        R_s = A_s / A_s[:, :1, :]
        support = np.r_[np.arange(n_causal), np.arange(nfft - n_acausal, nfft)]
        B = np.transpose(R_s[:, 1:, :], (2, 1, 0)).reshape(N * (M - 1), S.size)
        g = sparir(B, S, nfft, support, lam_ratio=lasso_lam, n_iter=lasso_iter)
        g_full = np.zeros((N * (M - 1), nfft))
        g_full[:, support] = g
        R_rec = np.fft.rfft(g_full, axis=-1).reshape(N, M - 1, F)
        A_rec = np.ones((F, M, N), dtype=X.dtype)
        A_rec[:, 1:, :] = np.transpose(R_rec, (2, 1, 0))
        A_rec[S] = R_s  # keep the measured bins verbatim
        W = np.linalg.inv(A_rec).astype(X.dtype)

    if polish_iter > 0 and S.size < F:
        _, W = auxiva(
            X, n_src=N, n_iter=int(polish_iter), proj_back=False, W0=W,
            model=model, return_filters=True,
        )

    Y = np.einsum("fnm,tfm->tfn", W, X)
    if proj_back:
        z = projection_back(Y, X[:, :, 0])
        Y = Y * np.conj(z)[None, :, :]
    if return_filters:
        return Y, W
    return Y
