"""NumPy oracle OGIVE (orthogonally-constrained gradient IVE, n_src = 1): the
port's copy of ``overiva_tpu/oracle/ogive.py``, the float64 reference that
``chip_smoke.py`` holds the port to.

Reference behavior: the reference repo's ``ive.py`` (SURVEY.md §2.3.4;
Koldovsky & Tichavsky's OGIVE family, "Gradient algorithms for complex
non-Gaussian independent component/vector extraction", IEEE TASLP 2019).

Single-source extraction model per frequency: x = a s + background, with the
demixing vector w giving s_hat = w^H x, and the orthogonal-constraint (OC)
coupling between the mixing and demixing vectors

    a = Cx w / (w^H Cx w),      w = Cx^{-1} a / (a^H Cx^{-1} a)

(which implies w^H a == 1). Three update modes:

- ``demix``:      gradient step on w, then a from OC
- ``mix``:        gradient step on a, then w from OC
- ``switching``:  per-frequency choice between the two, refreshed every
  ``switch_every`` epochs (criterion reconstructed, flagged VERIFY in
  SURVEY.md §7.4: use the mixing-vector update where the MPDR source-power
  estimate sigma_s^2 = 1/(a^H Cx^{-1} a) exceeds the mean channel power
  tr(Cx)/M, i.e. where the target dominates).

Behavioral contract (SURVEY.md §2.3.4): thousands of cheap iterations, early
exit on ``max_f ||step|| / ||w|| < tol``, ``step_size`` hyperparameter.
"""

from __future__ import annotations

import numpy as np

from .models import activations, align_eigvec_phase
from .projection import projection_back

__all__ = ["ogive"]


def _oc_a_from_w(w: np.ndarray, Cx: np.ndarray) -> np.ndarray:
    v = np.einsum("fmn,fn->fm", Cx, w)
    lam = np.real(np.einsum("fm,fm->f", np.conj(w), v))
    return v / lam[:, None]


def _oc_w_from_a(a: np.ndarray, Cx_inv: np.ndarray) -> np.ndarray:
    v = np.einsum("fmn,fn->fm", Cx_inv, a)
    lam = np.real(np.einsum("fm,fm->f", np.conj(a), v))
    return v / lam[:, None]


def ogive(
    X: np.ndarray,
    n_iter: int = 4000,
    step_size: float = 0.1,
    tol: float = 1e-3,
    update: str = "demix",
    proj_back: bool = True,
    model: str = "laplace",
    init_eig: bool = False,
    return_filters: bool = False,
    callback=None,
    callback_every: int = 100,
    switch_every: int = 10,
):
    """Extract one source from an (n_frames, n_freq, n_chan) mixture STFT.

    Returns Y (n_frames, n_freq, 1) [, w (n_freq, n_chan)].
    """
    if update not in ("demix", "mix", "switching"):
        raise ValueError(f"unknown update mode {update!r}")
    X = np.asarray(X)
    T, F, M = X.shape

    Cx = np.einsum("tfm,tfn->fmn", X, np.conj(X)) / T
    Cx_inv = np.linalg.inv(Cx)

    if init_eig:
        eigval, eigvec = np.linalg.eigh(Cx)
        top = align_eigvec_phase(eigvec[:, :, -1:])  # deterministic phase
        w = np.conj(top[:, :, 0])  # principal component, demix convention
    else:
        w = np.zeros((F, M), dtype=X.dtype)
        w[:, 0] = 1.0
    a = _oc_a_from_w(w, Cx)

    if update == "switching":
        # per-frequency mask: True -> use the 'mix' update
        sigma_s2 = 1.0 / np.real(np.einsum("fm,fmn,fn->f", np.conj(a), Cx_inv, a))
        mean_pow = np.real(np.trace(Cx, axis1=1, axis2=2)) / M
        use_mix = sigma_s2 > mean_pow

    for epoch in range(n_iter):
        if update == "switching" and epoch % switch_every == 0:
            sigma_s2 = 1.0 / np.real(np.einsum("fm,fmn,fn->f", np.conj(a), Cx_inv, a))
            mean_pow = np.real(np.trace(Cx, axis1=1, axis2=2)) / M
            use_mix = sigma_s2 > mean_pow

        y = np.einsum("fm,tfm->tf", np.conj(w), X)  # (T, F)
        r, phi = activations(y[:, :, None], model)  # (T, 1)

        # xi[f] = E[ phi * conj(y) * x ],  nu[f] = E[ phi |y|^2 ]
        wy = phi[:, 0][:, None] * np.conj(y)  # (T, F)
        xi = np.einsum("tf,tfm->fm", wy, X) / T
        nu = np.maximum(np.real(np.einsum("tf,tf->f", wy, y)) / T, 1e-30)

        # Shared orthogonally-constrained residual: zero iff xi == nu * a,
        # i.e. the quasi-ML mixing estimate agrees with the OC mixing vector.
        resid = a - xi / nu[:, None]
        if update in ("demix", "switching"):
            delta_w = resid
        if update in ("mix", "switching"):
            # Same residual mapped through the natural metric of a-space
            # (Cx^{-1}); empirically stable at source fixed points where the
            # unmapped residual is not (see tests/test_oracle_algos.py).
            delta_a = np.einsum("fmn,fn->fm", Cx_inv, resid)

        if update == "demix":
            w = w + step_size * delta_w
            a = _oc_a_from_w(w, Cx)
            step_norm = np.linalg.norm(delta_w, axis=1)
        elif update == "mix":
            a = a + step_size * delta_a
            w = _oc_w_from_a(a, Cx_inv)
            step_norm = np.linalg.norm(delta_a, axis=1)
        else:  # switching
            w_new = w + step_size * delta_w
            a_from_w = _oc_a_from_w(w_new, Cx)
            a_new = a + step_size * delta_a
            w_from_a = _oc_w_from_a(a_new, Cx_inv)
            w = np.where(use_mix[:, None], w_from_a, w_new)
            a = np.where(use_mix[:, None], a_new, a_from_w)
            step_norm = np.where(
                use_mix,
                np.linalg.norm(delta_a, axis=1),
                np.linalg.norm(delta_w, axis=1),
            )

        if callback is not None and epoch % callback_every == 0:
            Yc = np.einsum("fm,tfm->tf", np.conj(w), X)[:, :, None]
            z = projection_back(Yc, X[:, :, 0])
            callback(Yc * np.conj(z)[None, :, :])

        rel = np.max(step_norm / np.maximum(np.linalg.norm(w, axis=1), 1e-30))
        if step_size * rel < tol:
            break

    Y = np.einsum("fm,tfm->tf", np.conj(w), X)[:, :, None]
    if proj_back:
        z = projection_back(Y, X[:, :, 0])
        Y = Y * np.conj(z)[None, :, :]
    if return_filters:
        return Y, w
    return Y
