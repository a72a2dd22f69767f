"""NumPy oracle FastMNMF1/2 (full-rank spatial model, jointly diagonalized):
the port's copy of ``overiva_tpu/oracle/fastmnmf2.py``, the float64 reference
that ``chip_smoke.py`` holds the port to.

Extension beyond the reference repo (which tops out at ILRMA's rank-1
spatial model — SURVEY.md §2.1): FastMNMF models each source with a
FULL-RANK spatial covariance G_kf = Q_f^{-1} diag(g_kf) Q_f^{-H} whose
diagonalizer Q_f is shared by all sources. Two published variants differ
only in the tying of the diagonal spatial weights:

- **FastMNMF1** (``fastmnmf``): g_kf ∈ R^M is free per frequency
  (K. Sekiguchi, A. A. Nugraha, Y. Bando, K. Yoshii, "Fast multichannel
  source separation based on jointly diagonalizable spatial covariance
  matrices", EUSIPCO 2019).
- **FastMNMF2** (``fastmnmf2``): g_k shared across frequency — fewer
  parameters, inherently permutation-aligned, usually equal or better:

    K. Sekiguchi, Y. Bando, A. A. Nugraha, K. Yoshii, T. Kawahara,
    "Fast multichannel nonnegative matrix factorization with
    directivity-aware jointly-diagonalizable spatial covariance matrices
    for blind source separation", IEEE/ACM TASLP 28, 2020 (FastMNMF2).

Both share one core here (``tie_g`` switch): every update below is
identical except the einsum index ``nm``/``nfm`` on g and which axes the
g statistics are reduced over.

Per epoch: IS-NMF multiplicative updates of the rank-L source PSDs
(lam[k,f,t] = sum_l W[k,f,l] H[k,l,t]), a multiplicative update of g, and
AuxIVA-style iterative-projection updates of the diagonalizer rows with
per-(t,f,m) weights 1/D (D = sum_k lam_k g_k — the modeled power in the
diagonalized domain). Every update is an MM step on the exact likelihood,
so the negative log-likelihood is monotone non-increasing — the
correctness anchor (tests/test_fastmnmf2.py checks it epoch by epoch, and
the update equations were locked in against that property).

Separation is the multichannel Wiener filter evaluated at the reference
microphone, so outputs are source images at mic 0 (same scaling
convention that projection back gives the IVA family).
"""

from __future__ import annotations

import numpy as np

__all__ = ["fastmnmf", "fastmnmf2", "fastmnmf2_loglik"]

_EPS = 1e-10
# Floor on the spatial weights g (rows sum to 1 over M entries, so 1e-4 is
# ~40 dB below uniform): without it, long runs sharpen g toward one-hot
# rows, the diagonalized-domain weights 1/D span an unbounded dynamic
# range, and the Q-row IP solves blow up -- NaN in complex64 AND float64
# on a WASPAA M=8 instance at ~100 epochs. With the floor, c64 == c128 to
# 0.05 dB at 100 epochs on that instance (and 30-epoch quality improves
# slightly). Strict MM monotonicity holds while the floor is inactive;
# when it binds it is a stability projection, same spirit as the IVA
# family's relative activation floor (PARITY.md row 13).
_G_FLOOR = 1e-4
# Floor on the modeled diagonalized power D (distinct from the lam/_EPS
# floor): the IS weights go as y/D^2; D >= 1e-7 caps them at ~1e14 so
# float32 statistic sums cannot overflow (the JAX twin runs a pure-f32
# pipeline; NumPy silently promoted D/S1/S2 to float64 and masked the
# overflow that NaN'd 60+-epoch f32 runs on WASPAA M=8 instances).
# With unit-power input scaling this is -70 dB — inactive except on
# silent slots.
_D_FLOOR = 1e-7


def _denom_g(lam, g):
    """D[t,f,m] = sum_n lam[n,f,t] g[n,(f,)m] — tied (N,M) or untied (N,F,M)."""
    sub = "nft,nm->tfm" if g.ndim == 2 else "nft,nfm->tfm"
    return np.maximum(np.einsum(sub, lam, g), _D_FLOOR)


def _loglik(y, D, Q):
    """Exact log-likelihood (constants dropped): (T,F,M) y=|Qx|^2, D model."""
    T = y.shape[0]
    _, logabsdet = np.linalg.slogdet(Q)
    return float(
        -np.sum(y / D) - np.sum(np.log(D)) + 2.0 * T * np.sum(logabsdet)
    )


def fastmnmf2_loglik(X, Q, g, W, H):
    """Public likelihood helper (tests): parameters as in :func:`fastmnmf2`.

    Applies the same unit-mean-power input normalization as the optimizer
    (``return_filters`` parameters fit the normalized input), so this is
    the exact objective the MM updates are monotone on.
    """
    X = np.asarray(X)
    X = X / (float(np.sqrt(np.mean(np.abs(X) ** 2))) or 1.0)
    Qx = np.einsum("fmn,tfn->tfm", Q, X)
    y = np.abs(Qx) ** 2
    lam = np.maximum(np.einsum("nfl,nlt->nft", W, H), _EPS)
    return _loglik(y, _denom_g(lam, g), Q)


def _fastmnmf_core(
    X: np.ndarray,
    n_src: int | None = None,
    n_iter: int = 30,
    n_components: int = 2,
    mic_index: int = 0,
    init: str = "whiten",
    n_noise="auto",
    seed: int = 0,
    return_filters: bool = False,
    callback=None,
    callback_every: int = 10,
    tie_g: bool = True,
    n_q_sweeps: int = 1,
):
    """X: (n_frames, n_freq, n_chan) complex. Returns Y (n_frames, n_freq,
    n_src) source images at ``mic_index`` [, (Q, g, W, H) of the FULL
    model incl. noise slots if ``return_filters``].

    ``tie_g=True`` is FastMNMF2 (g shared across frequency, shape (N, M));
    ``tie_g=False`` is FastMNMF1 (free per-frequency g, shape (N, F, M)).

    ``n_q_sweeps``: IP sweeps over the Q rows per epoch. The row
    covariances V_m depend only on the (epoch-fixed) weights 1/D, so
    extra sweeps optimize the same MM surrogate further at marginal cost
    — likelihood monotonicity is preserved.

    Unlike the determined IVA family, n_src is free (sources are modeled,
    not extracted by inversion); n_src <= n_chan is the sensible regime.

    ``n_noise`` extra model slots absorb the diffuse noise floor and
    fill the diagonalized space. The default "auto" fills to n_chan total
    slots (n_noise = n_chan - n_src): with fewer slots than channels the
    optimizer has unmodeled diagonalized channels and routinely lands in
    non-separating optima (measured at M=4, N=2: one noise slot fails on
    2/3 random mixtures at ~1 dB SIR; M slots separate every tested
    mixture at ~40 dB). The ``n_src`` highest-energy images are returned
    (noise images carry ~25 dB less energy, so selection is unambiguous).

    ``init="whiten"`` starts Q at the per-bin whitening basis
    Lam^{-1/2} E^H of the input covariance (deterministic eigh phases, as
    in the PCA path); ``init="eye"`` starts at identity.
    """
    X = np.asarray(X)
    T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if not 1 <= N:
        raise ValueError("need n_src >= 1")
    if n_noise == "auto":
        n_noise = M - N if N < M else 0
    N_out, N = N, N + int(n_noise)
    L = int(n_components)
    rng = np.random.default_rng(seed)

    # Normalize to unit mean power: the 1e-10 floors on lam/D are absolute,
    # so with arbitrary input scale the floored y/D^2 terms can overflow
    # float32 and the per-epoch Q<->W scale exchange ratchets (diagnosed on
    # a WASPAA M=8 instance: |Qx|^2 overflow -> NaN after ~60 epochs in
    # c64 while f64 converged). Unit input scale makes the floors
    # effectively relative; outputs are rescaled back (exact linearity).
    x_scale = float(np.sqrt(np.mean(np.abs(X) ** 2))) or 1.0
    X = X / x_scale

    if init == "whiten":
        from .models import align_eigvec_phase

        Cx = np.einsum("tfm,tfn->fmn", X, np.conj(X)) / T
        ew, E = np.linalg.eigh(Cx)
        E = align_eigvec_phase(E)
        Q = (
            E / np.sqrt(np.maximum(ew, 1e-12))[:, None, :]
        ).conj().transpose(0, 2, 1)
        Q = np.ascontiguousarray(Q.astype(X.dtype))
    elif init == "eye":
        Q = np.tile(np.eye(M, dtype=X.dtype), (F, 1, 1))  # (F, M, M)
    else:
        raise ValueError(f"init must be 'whiten' or 'eye', got {init!r}")
    g = np.full((N, M), 1e-2)
    for n in range(N):
        g[n, n % M] = 1.0
    g /= g.sum(axis=1, keepdims=True)
    if not tie_g:  # FastMNMF1: free per-frequency spatial weights
        g = np.tile(g[:, None, :], (1, F, 1))  # (N, F, M)
    W = rng.random((N, F, L)) + 0.1  # PSD basis
    H = rng.random((N, L, T)) + 0.1  # PSD activations

    XX = None  # x x^H, built lazily inside the Q update (O(F M^2 T) memory)

    def model(Q):
        Qx = np.einsum("fmn,tfn->tfm", Q, X)
        y = np.abs(Qx) ** 2  # (T, F, M)
        return Qx, y

    g_sub = "nm" if tie_g else "nfm"

    def psd():
        lam = np.maximum(np.einsum("nfl,nlt->nft", W, H), _EPS)  # (N, F, T)
        return lam

    def denom(lam):
        return _denom_g(lam, g)  # (T, F, M)

    def outputs(Qx, Q, g):
        Yall = _wiener(Qx, Q, g, psd(), mic_index)
        if N_out < N:
            en = np.sum(np.abs(Yall) ** 2, axis=(0, 1))
            Yall = Yall[:, :, np.sort(np.argsort(en)[::-1][:N_out])]
        return Yall * x_scale  # undo the unit-power input normalization

    Qx, y = model(Q)
    for epoch in range(n_iter):
        if callback is not None and epoch % callback_every == 0:
            callback(outputs(Qx, Q, g))

        # ---- NMF basis W ----
        lam = psd()
        D = denom(lam)
        S1 = np.einsum(f"tfm,{g_sub}->nft", y / D**2, g)  # sum_m g y / D^2
        S2 = np.einsum(f"tfm,{g_sub}->nft", 1.0 / D, g)  # sum_m g / D
        num = np.einsum("nft,nlt->nfl", S1, H)
        den = np.einsum("nft,nlt->nfl", S2, H)
        W = np.maximum(W * np.sqrt(num / np.maximum(den, _EPS)), _EPS)

        # ---- NMF activations H ----
        lam = psd()
        D = denom(lam)
        S1 = np.einsum(f"tfm,{g_sub}->nft", y / D**2, g)
        S2 = np.einsum(f"tfm,{g_sub}->nft", 1.0 / D, g)
        num = np.einsum("nft,nfl->nlt", S1, W)
        den = np.einsum("nft,nfl->nlt", S2, W)
        H = np.maximum(H * np.sqrt(num / np.maximum(den, _EPS)), _EPS)

        # ---- spatial weights g (FastMNMF1: per-frequency, no f-reduce) ----
        lam = psd()
        D = denom(lam)
        num = np.einsum(f"nft,tfm->{g_sub}", lam, y / D**2)
        den = np.einsum(f"nft,tfm->{g_sub}", lam, 1.0 / D)
        g = np.maximum(g * np.sqrt(num / np.maximum(den, _EPS)), _G_FLOOR)

        # ---- diagonalizer Q: IP row updates with weights 1/D. V_m depends
        # only on D (fixed this epoch), so extra sweeps reuse them ----
        lam = psd()
        D = denom(lam)
        if XX is None:
            XX = np.einsum("tfm,tfn->tfmn", X, np.conj(X))  # (T, F, M, M)
        Vs = [
            np.einsum("tf,tfab->fab", 1.0 / D[:, :, m], XX) / T
            for m in range(M)
        ]
        for _ in range(n_q_sweeps):
            for m in range(M):
                V = Vs[m]
                QV = Q @ V
                rhs = np.tile(np.eye(M, dtype=X.dtype)[m][:, None], (F, 1, 1))
                q = np.linalg.solve(QV, rhs)[:, :, 0]
                nrm = np.real(np.einsum("fa,fab,fb->f", np.conj(q), V, q))
                q = q / np.sqrt(np.maximum(nrm, _EPS))[:, None]
                Q[:, m, :] = np.conj(q)
        Qx, y = model(Q)

        # ---- normalization (pure reparametrization; likelihood-invariant,
        # keeps the three scale ambiguities Q<->W, g<->W, W<->H pinned) ----
        phi = np.real(np.einsum("fmn,fmn->f", Q, np.conj(Q))) / M
        Q /= np.sqrt(phi)[:, None, None]
        W /= phi[None, :, None]
        y /= phi[None, :, None]
        Qx /= np.sqrt(phi)[None, :, None]
        mu = g.sum(axis=-1, keepdims=True)  # (N, 1) tied / (N, F, 1) untied
        g /= mu
        W *= mu if g.ndim == 3 else mu[:, :, None]  # broadcast over (N, F, L)
        nu = W.sum(axis=1, keepdims=True)  # (N, 1, L)
        W /= np.maximum(nu, _EPS)
        H *= np.maximum(nu, _EPS).transpose(0, 2, 1)

    Y = outputs(Qx, Q, g)
    if return_filters:
        return Y, (Q, g, W, H)  # parameters fit the unit-power-scaled input
    return Y


def fastmnmf2(X, **kwargs):
    """FastMNMF2 (Sekiguchi et al. 2020): g shared across frequency.

    See :func:`_fastmnmf_core` for parameters; returned g is (N, M).
    """
    return _fastmnmf_core(X, tie_g=True, **kwargs)


def fastmnmf(X, **kwargs):
    """FastMNMF1 (Sekiguchi et al., EUSIPCO 2019): per-frequency g.

    See :func:`_fastmnmf_core` for parameters; returned g is (N, F, M).
    More flexible than FastMNMF2 but the extra per-frequency freedom
    loses the implicit permutation alignment that tying provides —
    FastMNMF2 is the usually-better default; this variant completes the
    published family (pyroomacoustics ships both as ``fastmnmf`` /
    ``fastmnmf2``).
    """
    return _fastmnmf_core(X, tie_g=False, **kwargs)


def _wiener(Qx, Q, g, lam, mic_index: int):
    """Multichannel Wiener estimate of each source image at one mic.

    x_hat[n] = Q^{-1} diag(lam_n g_n / D) Q x, evaluated at row
    ``mic_index`` of Q^{-1}.
    """
    T, F, M = Qx.shape
    N = lam.shape[0]
    D = _denom_g(lam, g)
    Qinv_row = np.linalg.inv(Q)[:, mic_index, :]  # (F, M)
    out = np.empty((T, F, N), dtype=Qx.dtype)
    for n in range(N):
        gn = g[n][None, None, :] if g.ndim == 2 else g[n][None, :, :]
        gain = lam[n].T[:, :, None] * gn / D  # (T, F, M)
        out[:, :, n] = np.einsum("fm,tfm->tf", Qinv_row, gain * Qx)
    return out
