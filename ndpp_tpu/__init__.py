"""ndpp-tpu: a nuclear-data preprocessor on JAX, run on an NVIDIA H100.

Re-implements the capabilities of NDPP (reference: ndpp/ndpp, a Fortran
nuclear-data preprocessor; see SURVEY.md for the full blueprint and
SURVEY.md section 0 for reference availability): it ingests continuous-energy
ACE nuclear data on the host, and computes on the device — vectorized over
(incident energy x outgoing group x Legendre order) — the group-wise P0..PN
scattering transfer moments, free-gas thermal scattering moments with
up-scatter, and group-collapsed fission chi spectra, writing group-wise
moment libraries (HDF5/ASCII) for downstream multi-group transport codes.

Precision: the 1e-8 relative accuracy target (BASELINE.json:5) requires
float64; we enable JAX x64 mode at import unless NDPP_TPU_NO_X64 is set.

Compile cache: where JAX_COMPILATION_CACHE_DIR is set, JAX keeps its
persistent cache there and nothing here overrides it. Otherwise the cache
is one fixed directory in the checkout, <repo>/.jax_cache (git-ignored).
"""

import os as _os
from pathlib import Path as _Path

import jax as _jax

if not _os.environ.get("NDPP_TPU_NO_X64"):
    _jax.config.update("jax_enable_x64", True)

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir", str(_Path(__file__).resolve().parent.parent / ".jax_cache")
    )
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from ndpp_tpu.version import __version__  # noqa: E402,F401
