"""BSS Eval source-separation metrics (SDR / SIR / SAR), NumPy: the port's
copy of ``bss_eval_sources`` from ``overiva_tpu/metrics/bss_eval.py``, so
that the port imports nothing of the JAX package.

In-repo implementation of the ``bss_eval_sources`` criteria the reference
pipeline gets from ``mir_eval.separation`` (SURVEY.md §5.5; the environment
ships no mir_eval). Implemented from the published definitions:

    E. Vincent, R. Gribonval, C. Fevotte, "Performance measurement in blind
    audio source separation", IEEE TASLP 14(4), 2006 (BSS Eval v3).

Each estimated source is decomposed against time-invariant ``filter_length``-
tap filtered versions of the true sources:

    s_filt   = P_{ref_j}(est)            target with allowed distortion
    e_interf = P_{all refs}(est) - s_filt
    e_artif  = est - P_{all refs}(est)

    SDR = 10 log10 ||s_filt||^2 / ||e_interf + e_artif||^2
    SIR = 10 log10 ||s_filt||^2 / ||e_interf||^2
    SAR = 10 log10 ||s_filt + e_interf||^2 / ||e_artif||^2

where P_S is the least-squares projection onto the span of the 0..flen-1
sample delays of the signals in S. The best permutation of estimates to
references is chosen by maximizing mean SIR (mir_eval convention).

Implementation notes (exact identities, not approximations):

Because every criterion is an ENERGY of sums of orthogonal-projection
residuals, no time-domain projection signal is ever materialized. With
``c = G^{-1} D`` the projection coefficients (G the Gram of delayed refs,
D the est-vs-delayed-ref cross-correlations), and using
``<est, P(est)> = ||P(est)||^2 = D @ c`` plus ``<P_all, P_j> = <est, P_j>``
(P_j lies inside the span P_all projects onto):

    ||s_filt||^2            = E_j   := D[j] @ c_j
    ||e_interf||^2          = E_all - E_j,   E_all := D @ c_all
    ||e_interf + e_artif||^2 = ||est||^2 - E_j
    ||e_artif||^2           = ||est||^2 - E_all
    ||s_filt + e_interf||^2 = E_all

This removes all O(nsrc^2) full-length FFT convolutions from the metric.

The reference-side work (Gram assembly + Cholesky factorizations) is
reusable across many estimate sets via :class:`BssEvalReferences`.
"""

from __future__ import annotations

import itertools

import numpy as np
from scipy.linalg import cho_factor, cho_solve, toeplitz

__all__ = ["BssEvalReferences", "bss_eval_sources"]


class BssEvalReferences:
    """Factored reference-side state: score many estimate sets cheaply.

    Builds the (nsrc*flen, nsrc*flen) Gram matrix of 0..flen-1 sample
    delays of the references and Cholesky-factors it (plus the per-reference
    diagonal blocks) ONCE; :meth:`evaluate` then costs one FFT
    cross-correlation and a few triangular solves per estimate set.
    """

    def __init__(self, reference_sources: np.ndarray, filter_length: int = 512):
        refs = np.atleast_2d(np.asarray(reference_sources, dtype=np.float64))
        if np.any(np.sum(np.abs(refs), axis=1) == 0):
            raise ValueError("reference sources must be non-silent")
        nsrc, nsampl = refs.shape
        self.refs = refs
        self.flen = flen = int(filter_length)
        n = nsampl + flen - 1
        self.nfft = 1 << (n - 1).bit_length()
        self.sf = np.fft.rfft(refs, n=self.nfft, axis=1)

        G = np.empty((nsrc, flen, nsrc, flen))
        for i in range(nsrc):
            for j in range(i, nsrc):
                # corr_ij[tau] = sum_t s_i[t] s_j[t - tau], tau in (-flen, flen)
                ssf = np.fft.irfft(self.sf[i] * np.conj(self.sf[j]), n=self.nfft)
                # rows: delay of s_i, cols: delay of s_j -> Toeplitz
                block = toeplitz(
                    np.hstack((ssf[:1], ssf[-1 : -flen : -1])), ssf[:flen]
                )
                G[i, :, j, :] = block
                if i != j:
                    G[j, :, i, :] = block.T
        self.G = G.reshape(nsrc * flen, nsrc * flen)
        # the Gram is PSD; Cholesky both factors once and is ~2x an LU.
        try:
            self._cho = cho_factor(self.G)
        except np.linalg.LinAlgError:
            self._cho = None
        self._cho_jj = []
        for j in range(nsrc):
            Gjj = self.G[j * flen : (j + 1) * flen, j * flen : (j + 1) * flen]
            try:
                self._cho_jj.append(cho_factor(Gjj))
            except np.linalg.LinAlgError:
                self._cho_jj.append(None)

    def cross_corr(self, ests: np.ndarray) -> np.ndarray:
        """D[k, i, tau] = sum_t est_k[t] s_i[t - tau], tau = 0..flen-1."""
        ef = np.fft.rfft(ests, n=self.nfft, axis=1)
        cc = np.fft.irfft(
            ef[:, None, :] * np.conj(self.sf)[None, :, :], n=self.nfft, axis=2
        )
        return cc[:, :, : self.flen]

    def _solve(self, cho, G, D):
        if cho is not None:
            return cho_solve(cho, D)
        try:
            return np.linalg.solve(G, D)
        except np.linalg.LinAlgError:
            return np.linalg.lstsq(G, D, rcond=None)[0]

    def evaluate(self, estimated_sources: np.ndarray, compute_permutation=True):
        """SDR/SIR/SAR of estimates vs these references (mir_eval semantics).

        estimated_sources: (nsrc, nsampl) with the same shape as the
        references. Returns (sdr, sir, sar, perm) ordered by REFERENCE
        source: sdr[j] scores reference j against estimate perm[j], with the
        permutation maximizing mean SIR.
        """
        ests = np.atleast_2d(np.asarray(estimated_sources, dtype=np.float64))
        if ests.shape != self.refs.shape:
            raise ValueError(
                f"shape mismatch: references {self.refs.shape} "
                f"vs estimates {ests.shape}"
            )
        nsrc, flen = self.refs.shape[0], self.flen

        D = self.cross_corr(ests)  # (nest, nsrc, flen)
        e2 = np.sum(ests**2, axis=1)  # (nest,)
        # projection energies onto ALL delayed refs: E_all = D @ c_all
        Dflat = D.reshape(nsrc, nsrc * flen)
        c_all = self._solve(self._cho, self.G, Dflat.T)  # (nsrc*flen, nest)
        E_all = np.maximum(np.einsum("kn,nk->k", Dflat, c_all), 0.0)
        # per-target energies: E[k, j] = D[k, j] @ Gjj^{-1} D[k, j]
        E_tgt = np.empty((nsrc, nsrc))
        for j in range(nsrc):
            Gjj = self.G[j * flen : (j + 1) * flen, j * flen : (j + 1) * flen]
            c_j = self._solve(self._cho_jj[j], Gjj, D[:, j, :].T)  # (flen, nest)
            E_tgt[:, j] = np.maximum(np.einsum("kt,tk->k", D[:, j, :], c_j), 0.0)

        sdr_m = _db(E_tgt, e2[:, None] - E_tgt)
        sir_m = _db(E_tgt, E_all[:, None] - E_tgt)
        sar_m = np.broadcast_to(
            _db(E_all[:, None], (e2 - E_all)[:, None]), (nsrc, nsrc)
        )

        if not compute_permutation:
            idx = np.arange(nsrc)
            return sdr_m[idx, idx], sir_m[idx, idx], sar_m[idx, idx], idx

        # perm maps reference j -> estimate perm[j] (mir_eval convention).
        # Selection clips to +-300 dB so exact-zero residuals (SIR = +inf,
        # possible now that energies are exact quadratic forms) don't make
        # every permutation containing one perfect match tie at mean = inf;
        # reported values stay unclipped.
        sel = np.clip(sir_m, -300.0, 300.0)
        best, best_perm = -np.inf, None
        for perm in itertools.permutations(range(nsrc)):
            mean_sir = np.mean(sel[perm, np.arange(nsrc)])
            if mean_sir > best:
                best, best_perm = mean_sir, perm
        perm = np.asarray(best_perm)
        idx = np.arange(nsrc)
        return sdr_m[perm, idx], sir_m[perm, idx], sar_m[perm, idx], perm


def _db(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """10 log10(num/den) with 0-denominator -> +inf, 0-numerator -> -inf.

    Denominators are energy differences computed by exact quadratic-form
    identities; rounding can leave them a hair negative when the true
    residual is zero, so anything <= 0 counts as a zero denominator.

    A zero NUMERATOR wins over a zero denominator: an estimate carrying no
    target energy at all (e.g. an all-zero signal, where num = den = 0)
    scores -inf, not the +inf of the perfect-match branch.
    """
    shape = np.broadcast_shapes(np.shape(num), np.shape(den))
    num = np.broadcast_to(np.asarray(num, dtype=np.float64), shape)
    den = np.broadcast_to(np.asarray(den, dtype=np.float64), shape)
    out = np.full(shape, np.inf)
    out[num <= 0] = -np.inf
    ok = (den > 0) & (num > 0)
    with np.errstate(divide="ignore"):
        out[ok] = 10.0 * np.log10(num[ok] / den[ok])
    return out


def bss_eval_sources(
    reference_sources: np.ndarray,
    estimated_sources: np.ndarray,
    compute_permutation: bool = True,
    filter_length: int = 512,
):
    """SDR/SIR/SAR of estimated vs reference sources with permutation search.

    reference_sources, estimated_sources: (nsrc, nsampl) float arrays (the
    estimate count must equal the reference count, as in mir_eval).

    Returns (sdr, sir, sar, perm) — each (nsrc,) arrays ordered by REFERENCE
    source (mir_eval semantics): sdr[j] scores reference j against estimate
    perm[j], and the permutation maximizes mean SIR.

    For scoring many estimate sets against the same references, build one
    :class:`BssEvalReferences` and call ``.evaluate`` — the expensive Gram
    factorization is reference-side only.
    """
    ev = BssEvalReferences(reference_sources, filter_length)
    return ev.evaluate(estimated_sources, compute_permutation)
