"""Simulation of the inputs: shoebox image-source rooms, layouts, sources.

The port's copy of ``overiva_tpu/sim/`` (the same exports), so that the
port's examples build their rooms without importing the JAX package.
Host NumPy code: it makes the mixtures, the card sees only the result.
``tests/test_torch_sim.py`` holds it bit for bit against its twin.
"""

from .layouts import circular_mic_array, grid_layout, random_layout, semi_circle_layout
from .room import ShoeBox, inverse_sabine, shoebox_rir
from .sources import load_wav_sources, mix_premix, scale_to_snr, speech_like

__all__ = [
    "ShoeBox",
    "circular_mic_array",
    "grid_layout",
    "inverse_sabine",
    "mix_premix",
    "random_layout",
    "scale_to_snr",
    "semi_circle_layout",
    "shoebox_rir",
    "load_wav_sources",
    "speech_like",
]
