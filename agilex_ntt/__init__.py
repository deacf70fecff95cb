"""A batched negacyclic NTT / RNS / FHE library in JAX for NVIDIA GPUs.

Built from scratch in JAX/Pallas with the capabilities of joekurina/Agilex-NTT
(an Intel DPC++/SYCL FPGA forward-NTT derived from HEXL-FPGA); see SURVEY.md
at the repository root for the component-by-component mapping.
"""

import os as _os

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    # persistent XLA compilation cache at a fixed path inside the checkout
    # (the path is part of the cache key, so it must not move); a
    # JAX_COMPILATION_CACHE_DIR in the environment is used as it is
    import jax as _jax

    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache",
        ),
    )

from .api import CyclicRing, Ring, RNSRing, WideRing
from .config import NTTConfig, REFERENCE_SIZES
from .params import NTTParams, find_primes, find_psi, make_params

__version__ = "0.1.0"

__all__ = [
    "Ring",
    "RNSRing",
    "CyclicRing",
    "WideRing",
    "NTTConfig",
    "NTTParams",
    "REFERENCE_SIZES",
    "find_primes",
    "find_psi",
    "make_params",
]
