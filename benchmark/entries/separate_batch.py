"""A closed loop of ``Separator.separate_batch`` over groups of clips.

The pool holds ``pool_groups`` groups of ``group`` clips of ``clip_s``
seconds each, every clip a room of the configuration's scene, cycled in
order; each item is one group,
NumPy in and NumPy out. The check keeps every output of one clip in each
of ``check.sample`` equal stretches of the group (so that both halves of a
group are always looked at), each in a group drawn from the seed.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.clips import Kept, real_frames
from benchmark.traffic.generate import mixtures


class Driver:
    def __init__(self, system, cfg, traffic, rng):
        self.sep, self.cfg, self.traffic = system, cfg, traffic
        g, n_groups = int(traffic["group"]), int(traffic["pool_groups"])
        n = int(round(float(traffic["clip_s"]) * cfg["fs"]))
        clips = mixtures(rng, [n] * (g * n_groups), cfg)
        self.pool = [clips[i * g : (i + 1) * g] for i in range(n_groups)]
        sample = {}
        for stretch in np.array_split(np.arange(g), int(traffic["check"]["sample"])):
            gi, pos = int(rng.integers(n_groups)), int(rng.choice(stretch))
            sample[(gi, pos)] = self.pool[gi][pos]
        self.kept = Kept(sample)
        self.audio_s = g * n / cfg["fs"]
        self.frames = [real_frames(n, cfg["args"])] * g

    def warmup(self):
        for _ in range(int(self.traffic.get("warmup", 1))):
            self.sep.separate_batch(self.pool[0])

    def counters(self) -> dict:
        return {k: self.sep.stats[k] for k in ("clips", "frames_real", "frames_padded")}

    def item(self, i: int) -> dict:
        gi = i % len(self.pool)
        t0 = time.perf_counter()
        outs = self.sep.separate_batch(self.pool[gi])
        t1 = time.perf_counter()
        for pos, y in enumerate(outs):
            self.kept.keep((gi, pos), y)
        return {"t0": t0, "t1": t1, "audio_s": self.audio_s, "frames": self.frames}

    def release(self):
        self.sep = None

    def check(self, control=None) -> dict:
        return self.kept.check(self.cfg, control)
