"""What the clip entries share: the output sample and its check."""

from __future__ import annotations

import importlib

import numpy as np

from .check import rel_err_cols, worst
from .reference.arith import F64
from .reference.stft import stft_pad


def reference(cfg: dict):
    """The reference module that a configuration names."""
    return importlib.import_module(f"benchmark.reference.{cfg['reference']}")


def real_frames(n_samples: int, args: dict) -> int:
    """STFT frames of an ``n_samples`` clip, before the bucket's padding."""
    nfft = int(args["nfft"])
    hop = int(args.get("hop") or nfft // 2)
    return (stft_pad(np.empty(n_samples), nfft, hop).shape[0] - nfft) // hop + 1


class Kept:
    """Every output, in the window, of a sample of the pool's clips drawn
    from the seed; compared with the reference once the window has
    closed."""

    def __init__(self, clips: dict):
        self.clips = clips  # pool key -> input clip
        self.outputs = {key: [] for key in clips}

    def keep(self, key, y) -> None:
        if key in self.outputs:
            # a copy: a batch's outputs are views of one download
            self.outputs[key].append(np.array(y))

    def check(self, cfg: dict, control=None) -> dict:
        """``{"rel_err": worst relative gap}`` of the kept outputs against
        the float64 reference, or with ``control`` (an Arith) of the
        reference computed in that arithmetic in the program's place."""
        ref = reference(cfg)
        errs = []
        for key, x in self.clips.items():
            outs = self.outputs[key]
            if control is None and not outs:
                continue
            yr = ref.separate_clip(x, cfg["args"], F64)
            if control is not None:
                outs = [ref.separate_clip(x, cfg["args"], control)]
            errs += [rel_err_cols(y, yr) for y in outs]
        return {"rel_err": worst(errs)}
