"""x265amod_tpu: an HEVC encoder in JAX (device analysis, transforms and
loop filters) with a C++ host CABAC.

A new implementation with the capabilities of the reference
DJATOM/x265-aMod encoder (see SURVEY.md).
"""

import os

import jax

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir(environ=os.environ) -> str | None:
    """Directory this package points JAX's persistent compile cache at:
    none when JAX_COMPILATION_CACHE_DIR is set (JAX reads it itself),
    else ``<checkout>/.jax_cache``.  Encoder programs are large, and the
    cache saves recompiling them in every process."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(_CHECKOUT, ".jax_cache")


_cache_dir = compile_cache_dir()
if _cache_dir is not None and jax.config.jax_compilation_cache_dir is None:
    jax.config.update("jax_compilation_cache_dir", _cache_dir)

__version__ = "0.1.0"
