"""One caller in a closed loop of ``Separator.separate``.

The pool holds ``pool`` clips, each a room of the configuration's
scene, whose lengths are log-uniform over ``clip_s`` seconds (one length
where both ends agree), the same lengths for every seed, in an order
drawn from the seed and cycled; each item is one request, NumPy in and
NumPy out. Set-up runs each bucket of the pool ``warmup`` times. The check
keeps every output of the longest clip and of ``check.sample - 1`` others
drawn from the seed.
"""

from __future__ import annotations

import time

from benchmark.clips import Kept, real_frames
from benchmark.traffic.generate import clip_lengths, mixtures


class Driver:
    def __init__(self, system, cfg, traffic, rng):
        self.sep, self.cfg, self.traffic = system, cfg, traffic
        fs = cfg["fs"]
        lo, hi = traffic["clip_s"]
        lengths = clip_lengths(int(traffic["pool"]), lo, hi, fs)
        lengths = [lengths[j] for j in rng.permutation(len(lengths))]
        self.pool = mixtures(rng, lengths, cfg)
        longest = max(range(len(lengths)), key=lengths.__getitem__)
        others = [j for j in rng.permutation(len(lengths)) if j != longest]
        picked = [longest] + others[: int(traffic["check"]["sample"]) - 1]
        self.kept = Kept({int(j): self.pool[j] for j in picked})
        self.audio_s = [n / fs for n in lengths]
        self.frames = [real_frames(n, cfg["args"]) for n in lengths]

    def warmup(self):
        from overiva_tpu_torch.serving import bucket_frames

        sep, seen = self.sep, set()
        for j, frames in enumerate(self.frames):
            bucket = bucket_frames(frames, sep.min_frames, sep.bucket_ratio, sep.bucket_multiple)
            if bucket not in seen:
                seen.add(bucket)
                for _ in range(int(self.traffic.get("warmup", 1))):
                    self.sep.separate(self.pool[j])

    def counters(self) -> dict:
        return {k: self.sep.stats[k] for k in ("clips", "frames_real", "frames_padded")}

    def item(self, i: int) -> dict:
        j = i % len(self.pool)
        t0 = time.perf_counter()
        y = self.sep.separate(self.pool[j])
        t1 = time.perf_counter()
        self.kept.keep(j, y)
        return {"t0": t0, "t1": t1, "audio_s": self.audio_s[j], "frames": [self.frames[j]]}

    def release(self):
        self.sep = None

    def check(self, control=None) -> dict:
        return self.kept.check(self.cfg, control)
