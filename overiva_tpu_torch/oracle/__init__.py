"""The float64 NumPy references that the port and ``chip_smoke.py`` use.

Copies of the functions of ``overiva_tpu/oracle/`` that the port needs, with
the same names, so that the port imports nothing of the JAX package:
the STFT (``analysis``, ``synthesis``, ``stft_pad``, ``hann``,
``synthesis_window``), the OverIVA oracle with its activations and
projection back. ``tests/test_torch_oracle_copy.py`` holds each one bit for
bit against its twin.
"""

from .models import EPS, activations, align_eigvec_phase
from .overiva import overiva
from .projection import apply_projection_back, projection_back
from .stft import analysis, hann, stft_pad, synthesis, synthesis_window

__all__ = [
    "EPS",
    "activations",
    "align_eigvec_phase",
    "analysis",
    "apply_projection_back",
    "hann",
    "overiva",
    "projection_back",
    "stft_pad",
    "synthesis",
    "synthesis_window",
]
