"""The float64 NumPy references that the port and ``chip_smoke.py`` use.

Copies of the functions of ``overiva_tpu/oracle/`` that the port needs, with
the same names, so that the port imports nothing of the JAX package:
the STFT (``analysis``, ``synthesis``, ``stft_pad``, ``hann``,
``synthesis_window``), the OverIVA, AuxIVA, AuxIVA-ISS, OverIVA-ISS, IP2,
FIVE, OGIVE, ILRMA, FastMNMF1/2 and SparseAuxIVA oracles with their
activations and projection back, WPE (``delayed_taps``, ``wpe``) and the
joint dereverberation oracles T-ISS, T-IP and ILRMA-T (the SparseAuxIVA
helpers ``select_bins``, ``sparir`` and ``_resolve_n_bins``, the FastMNMF
``_wiener`` and ``ilrma_t_loglik`` live in their modules). ``tests/test_torch_oracle_copy.py`` holds each one bit for
bit against its twin.
"""

from .auxiva import auxiva
from .auxiva_iss import auxiva_iss
from .fastmnmf2 import fastmnmf, fastmnmf2, fastmnmf2_loglik
from .five import five
from .ilrma import ilrma
from .ilrma_t import ilrma_t
from .models import EPS, activations, align_eigvec_phase
from .ogive import ogive
from .overiva import overiva
from .overiva_ip2 import auxiva_ip2, overiva_ip2
from .overiva_iss import overiva_iss
from .projection import apply_projection_back, projection_back
from .sparseauxiva import sparseauxiva
from .stft import analysis, hann, stft_pad, synthesis, synthesis_window
from .tip import tip
from .tiss import tiss
from .wpe import delayed_taps, wpe

__all__ = [
    "EPS",
    "activations",
    "align_eigvec_phase",
    "analysis",
    "apply_projection_back",
    "auxiva",
    "auxiva_ip2",
    "auxiva_iss",
    "delayed_taps",
    "fastmnmf",
    "fastmnmf2",
    "fastmnmf2_loglik",
    "five",
    "hann",
    "ilrma",
    "ilrma_t",
    "ogive",
    "overiva",
    "overiva_ip2",
    "overiva_iss",
    "projection_back",
    "sparseauxiva",
    "stft_pad",
    "synthesis",
    "synthesis_window",
    "tip",
    "tiss",
    "wpe",
]
