"""Audio audition helpers — the reference's ``routines.PlaySoundGUI`` analog.

The reference ships a tkinter GUI to audition separated sources
(SURVEY.md §2.1). This environment is headless, so the equivalent here is
file-based: normalize + write wavs, and an interactive console player that
shells out to a system audio player when one exists (documented no-op
otherwise).
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["save_wavs", "AudioPlayer"]


def save_wavs(out_dir, fs: int, signals: dict, normalize: bool = True):
    """Write named signals to ``out_dir`` as 16-bit wavs.

    signals: {"name": (n_samples,) or (n_samples, n_chan) float array}.
    Returns the list of written paths.
    """
    from scipy.io import wavfile

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for name, sig in signals.items():
        sig = np.asarray(sig, dtype=np.float64)
        if normalize:
            peak = np.max(np.abs(sig)) + 1e-12
            sig = sig / peak * 0.9
        data = (sig * 32767).astype(np.int16)
        path = out / f"{name}.wav"
        wavfile.write(path, int(fs), data)
        paths.append(path)
    return paths


class AudioPlayer:
    """Console audition loop over a set of wav files.

    ``play(i)`` shells out to the first available system player
    (aplay/paplay/afplay/ffplay); ``interactive()`` loops over
    number-to-play prompts like the reference's GUI buttons.
    """

    PLAYERS = ("aplay", "paplay", "afplay", "ffplay")

    def __init__(self, paths):
        self.paths = [Path(p) for p in paths]
        self.player = next((p for p in self.PLAYERS if shutil.which(p)), None)

    def play(self, index: int) -> bool:
        if self.player is None:
            print("no system audio player found; files on disk:")
            for p in self.paths:
                print(f"  {p}")
            return False
        cmd = [self.player, str(self.paths[index])]
        if self.player == "ffplay":
            cmd[1:1] = ["-nodisp", "-autoexit", "-loglevel", "quiet"]
        subprocess.run(cmd, check=False)
        return True

    def interactive(self):  # pragma: no cover - needs a terminal + audio out
        while True:
            for i, p in enumerate(self.paths):
                print(f"  [{i}] {p.name}")
            choice = input("play # (q to quit): ").strip()
            if choice.lower() in ("q", "quit", ""):
                return
            try:
                self.play(int(choice))
            except (ValueError, IndexError):
                print("?")
