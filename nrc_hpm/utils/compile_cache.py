"""Persistent XLA compilation cache.

The reference compiles GLSL at startup by shelling out to glslc
(src/Shader.cpp:18-40) and pays it on every run; our XLA programs are far
bigger (the whole NRC frame is one program).  JAX's persistent compilation
cache makes every compile after the first process-lifetime cheap.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and this
module sets nothing.  Otherwise the cache lives at the fixed
``<repo>/output/xla_cache``.  Set NRC_NO_COMPILE_CACHE=1 to disable.
"""

from __future__ import annotations

import os

_DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "output", "xla_cache")


def enable_compilation_cache() -> str | None:
    """Returns the persistent compilation cache directory in use, pointing
    JAX at <repo>/output/xla_cache unless JAX_COMPILATION_CACHE_DIR is set.
    Safe to call multiple times."""
    if os.environ.get("NRC_NO_COMPILE_CACHE"):
        return None
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = _DEFAULT_DIR
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    # cache everything that takes >=1s to compile (the default threshold);
    # tiny programs recompile faster than they (de)serialize
    return path
