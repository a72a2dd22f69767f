"""Online (streaming) WPE on tensors: block-wise recursive updates.

Counterpart of ``overiva_tpu/models/online_wpe.py``. STFT frames arrive
in blocks; the tap-correlation statistics are exponentially forgotten and
the prediction filter is re-solved once per block, so the dereverberator
tracks the room with O(block) latency.

State per stream (all on the device):
  G      (F, MK, M)  prediction filter (MK = n_chan * taps)
  R      (F, MK, MK) EW tap correlation  sum_t Xd Xd^H / lam
  P      (F, MK, M)  EW cross-correlation sum_t Xd X^H / lam
  hist   (taps+delay-1, F, M) trailing input frames (zeros before the stream)
  t_eff  ()          effective frame count (real)

Per block: (1) dereverberate the block with the current filter to
estimate the PSD weights lam, (2) discount R/P by ``forget`` per frame
(``forget**B`` per block) and add the block's weighted statistics, (3)
re-solve G with the batch path's trace-relative diagonal load
(``ops/wpe.py``'s :func:`delayed_taps` and ``ops/linalg.py``'s
:func:`gauss_solve`), (4) emit the block dereverberated by the updated
filter. A step returns new tensors and never writes into its input state.
"""

from __future__ import annotations

import torch

from ..ops.linalg import gauss_solve
from ..ops.wpe import delayed_taps

__all__ = ["online_wpe_init", "online_wpe_step"]

_EPS = 1e-10


def online_wpe_init(F: int, M: int, taps: int, delay: int, dtype=torch.complex64,
                    device=None):
    """The zero state of a stream of (F, M) frames."""
    MK = M * taps
    return {
        "G": torch.zeros((F, MK, M), dtype=dtype, device=device),
        "R": torch.zeros((F, MK, MK), dtype=dtype, device=device),
        "P": torch.zeros((F, MK, M), dtype=dtype, device=device),
        "hist": torch.zeros((taps + delay - 1, F, M), dtype=dtype, device=device),
        "t_eff": torch.zeros((), dtype=dtype.to_real(), device=device),
    }


def online_wpe_step(X_blk, state, forget, taps: int, delay: int, diag_load: float = 1e-5):
    """Process one STFT block X_blk (B, F, M) complex; ``forget`` is a 0-d
    real tensor on the block's device (per frame: effective memory
    1/(1-forget) frames). Returns (Y_blk dereverberated, new state)."""
    B, F, M = X_blk.shape
    MK = M * taps
    L = taps + delay - 1
    lam_f = forget.to(X_blk.real.dtype)

    Xc = torch.cat([state["hist"], X_blk], dim=0)  # (L+B, F, M)
    Xd = delayed_taps(Xc, taps, delay)[L:]  # (B, F, MK)

    # (1) PSD weights from the current filter's dereverberated estimate
    Y0 = X_blk - torch.einsum("fam,bfa->bfm", state["G"].conj(), Xd)
    lam = torch.mean(Y0.abs() ** 2, dim=2)  # (B, F)
    lam = torch.maximum(lam, _EPS * torch.clamp_min(torch.mean(lam), 1e-30))
    Xw = Xd / lam[:, :, None]

    # (2) exponentially forgotten statistics (block-wise discount)
    decay = lam_f ** B
    R = decay * state["R"] + torch.einsum("bfa,bfc->fac", Xw, Xd.conj())
    P = decay * state["P"] + torch.einsum("bfa,bfm->fam", Xw, X_blk.conj())
    t_eff = decay * state["t_eff"] + B

    # (3) re-solve the filter (trace-relative Tikhonov, as the batch path)
    tr = torch.diagonal(R, dim1=-2, dim2=-1).real.sum(dim=-1) / MK
    load = diag_load * torch.clamp_min(tr, 1e-30)
    eye = torch.eye(MK, dtype=X_blk.dtype, device=X_blk.device)
    G = gauss_solve(R + load[:, None, None] * eye, P)

    # (4) emit with the updated filter
    Y = X_blk - torch.einsum("fam,bfa->bfm", G.conj(), Xd)
    # guard: x[-0:] would be the whole tensor
    hist = Xc[-L:] if L > 0 else state["hist"]
    return Y, {"G": G, "R": R, "P": P, "hist": hist, "t_eff": t_eff}
