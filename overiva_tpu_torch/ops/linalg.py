"""Batched small complex linear algebra for the IP update, F-major.

Counterpart of ``overiva_tpu/ops/linalg.py`` together with the guard math
of ``overiva_tpu/ops/fminor.py`` (dead-bin thresholds, ``clamp_pow2``,
the ``quad_form`` keep-row mask). The bin-minor layout of ``fminor`` is a
TPU register-tiling workaround and is not carried over: every tensor here
is ``(F, m, n)`` with the bin batch leading.
"""

from __future__ import annotations

import torch

__all__ = [
    "EIGH_BATCH", "align_eigvec_phase", "clamp_pow2", "eigh", "eigh_chunks", "gauss_solve",
    "mat_h", "matvec", "quad_form", "small_inv",
]


def mat_h(A):
    """Batched Hermitian transpose: (..., m, n) -> (..., n, m)."""
    return A.transpose(-1, -2).conj()


def matvec(A, x):
    """Batched matrix-vector: (..., m, n) @ (..., n) -> (..., m)."""
    return torch.einsum("...mn,...n->...m", A, x)


def _real_dtype(x):
    return x.real.dtype if x.is_complex() else x.dtype


def _dead(den, ref):
    """(guarded denominator, ok mask) for the dead-bin convention.

    A pivot or determinant at or below ``sqrt(tiny) * ref`` (tiny of the
    real dtype: ~1e-19 relative in f32, far smaller in f64) is an
    essentially exact zero: the solve writes ZEROS for that bin instead of
    dividing by it, which would make ~1e37 rows that overflow f32
    downstream. ``ref`` is the size of what the denominator divides. The
    threshold sits far below legitimate ill-conditioning, which keeps its
    (low-accuracy) solutions.
    """
    thr = torch.finfo(_real_dtype(den)).tiny ** 0.5 * ref
    ok = den.abs() > thr
    return torch.where(ok, den, torch.ones_like(den)), ok


def clamp_pow2(A, threshold_exp: float = 20.0):
    """Exact power-of-2 down-scaling of huge bins of an F-major tensor.

    Near-dead bins can make a solve output huge enough to overflow a
    later f32 quadratic form into NaN. The call sites are scale-invariant,
    so bins with max|.| > 2**threshold_exp are divided by a power of two,
    an exact operation; healthy bins are left bit-unchanged.
    """
    mag = torch.amax(A.abs(), dim=tuple(range(1, A.ndim)), keepdim=True)
    exp = torch.ceil(torch.log2(torch.clamp_min(mag, 1.0)))
    exp = torch.clamp_max(exp, 120.0)  # keep the scale itself finite in f32
    scale = torch.exp2(torch.where(exp > threshold_exp, exp, torch.zeros_like(exp)))
    return A / scale


def quad_form(w, V):
    """Guarded Hermitian quadratic form ``w^H V w`` per bin.

    w: (F, m), V: (F, m, m). Returns ``(s, good)``: s (F,) is the real
    form, and good (F,) marks bins where s carries significant bits
    (s > 4 eps times the sum of its terms' magnitudes). On knife-edge bins
    the form cancels to rounding noise, possibly <= 0; the caller keeps
    the previous row there instead of normalizing by noise.
    """
    tr = (w.conj()[:, :, None] * V * w[:, None, :]).real  # (F, m, m)
    s = tr.sum(dim=(1, 2))
    ref = tr.abs().sum(dim=(1, 2))
    good = s > 4.0 * torch.finfo(s.dtype).eps * ref
    return s, good


def _adj2_solve(A, B):
    s = torch.amax(A.abs(), dim=(1, 2))
    det, ok = _dead(A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0], s * s)
    adj = torch.stack(
        [
            torch.stack([A[:, 1, 1], -A[:, 0, 1]], dim=1),
            torch.stack([-A[:, 1, 0], A[:, 0, 0]], dim=1),
        ],
        dim=1,
    )
    inv = adj / det[:, None, None]
    inv = torch.where(ok[:, None, None], inv, torch.zeros_like(inv))
    return inv @ B


def _adj3_solve(A, B):
    a, b, c = A[:, 0, 0], A[:, 0, 1], A[:, 0, 2]
    d, e, f = A[:, 1, 0], A[:, 1, 1], A[:, 1, 2]
    g, h, i = A[:, 2, 0], A[:, 2, 1], A[:, 2, 2]
    cof = torch.stack(
        [
            e * i - f * h, c * h - b * i, b * f - c * e,
            f * g - d * i, a * i - c * g, c * d - a * f,
            d * h - e * g, b * g - a * h, a * e - b * d,
        ],
        dim=1,
    )  # (F, 9): the adjugate, row-major
    # ref = max|cofactor| * scale: the size of what det divides (NOT
    # scale^3 — det << max|A|^3 is healthy for near-rank-1 matrices)
    ref = torch.amax(cof.abs(), dim=1) * torch.amax(A.abs(), dim=(1, 2))
    det, ok = _dead(a * cof[:, 0] + b * cof[:, 3] + c * cof[:, 6], ref)
    inv = cof.reshape(-1, 3, 3) / det[:, None, None]
    inv = torch.where(ok[:, None, None], inv, torch.zeros_like(inv))
    return inv @ B


def gauss_solve(A, B):
    """Batched solve A X = B. A: (F, m, m), B: (F, m, k) -> (F, m, k).

    m <= 3: closed-form adjugate inverses. Otherwise Gauss-Jordan with
    partial pivoting on |.|; among equal magnitudes the first row wins
    (``torch.argmax`` returns the first maximum, like ``jnp.argmax``), so
    trajectories follow the JAX package to rounding. A pivot that is
    ``_dead`` zeroes its row: singular bins give zeros, never NaN.
    """
    F, m, _ = A.shape
    if m == 1:
        den, ok = _dead(A[:, :, 0:1], A[:, :, 0:1].abs())
        X = B / den
        return torch.where(ok, X, torch.zeros_like(X))
    if m == 2:
        return _adj2_solve(A, B)
    if m == 3:
        return _adj3_solve(A, B)
    Ab = torch.cat([A, B], dim=2)  # (F, m, m+k)
    width = Ab.shape[2]
    scale0 = torch.amax(A.abs(), dim=(1, 2))  # dead-pivot reference
    avail = torch.ones((F, m), dtype=torch.bool, device=A.device)
    rows = torch.arange(m, device=A.device)
    perm = []  # perm[i]: tableau row that holds solution row i
    for i in range(m):
        mag = torch.where(avail, Ab[:, :, i].abs(), -1.0)
        p = torch.argmax(mag, dim=1)  # (F,)
        sel = rows[None, :] == p[:, None]  # (F, m) one-hot
        piv = torch.gather(Ab, 1, p[:, None, None].expand(F, 1, width))[:, 0]
        den, ok = _dead(piv[:, i], scale0)
        piv = torch.where(ok[:, None], piv / den[:, None], torch.zeros_like(piv))
        factor = torch.where(sel, torch.zeros_like(Ab[:, :, i]), Ab[:, :, i])
        Ab = Ab - factor[:, :, None] * piv[:, None, :]
        Ab = torch.where(sel[:, :, None], piv[:, None, :], Ab)
        avail = avail & ~sel
        perm.append(p)
    idx = torch.stack(perm, dim=1)[:, :, None].expand(F, m, width - m)
    return torch.gather(Ab[:, :, m:], 1, idx)


def small_inv(A):
    """Batched small-matrix inverse: :func:`gauss_solve` against I."""
    F, m, _ = A.shape
    eye = torch.eye(m, dtype=A.dtype, device=A.device).expand(F, m, m)
    return gauss_solve(A, eye)


# cuSOLVER refuses one batched eigh of ~30,000 8 x 8 matrices
# (CUSOLVER_STATUS_INVALID_VALUE; 28,000 pass): 16 folded rooms of 2,049 bins
EIGH_BATCH = 24_576


def eigh_chunks(n: int) -> int:
    """How many calls :func:`eigh` makes for a batch of ``n`` matrices."""
    return max(1, -(-n // EIGH_BATCH))


def eigh(A):
    """Batched Hermitian eigendecomposition, eigenvalues ascending.

    A batch of more than :data:`EIGH_BATCH` matrices runs as the fewest
    equal chunks of at most that many (:func:`eigh_chunks`), concatenated:
    each matrix is decomposed on its own, so the results are those of one
    call."""
    n = A[..., 0, 0].numel()
    k = eigh_chunks(n)
    if k == 1:
        return torch.linalg.eigh(A)
    parts = [torch.linalg.eigh(c) for c in A.reshape(n, *A.shape[-2:]).tensor_split(k)]
    w = torch.cat([p[0] for p in parts]).reshape(A.shape[:-1])
    return w, torch.cat([p[1] for p in parts]).reshape(A.shape)


def align_eigvec_phase(E):
    """Deterministic eigenvector phase: largest-|.| component real-positive.

    E: (F, M, K), columns are eigenvectors. The oracle's convention
    (``oracle.models.align_eigvec_phase``), so eig-initialized runs are
    comparable across backends.
    """
    idx = torch.argmax(E.abs(), dim=1)  # (F, K)
    anchor = torch.gather(E, 1, idx[:, None, :])[:, 0, :]
    phase = anchor / torch.clamp_min(anchor.abs(), 1e-30)
    return E * phase.conj()[:, None, :]
