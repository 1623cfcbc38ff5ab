"""Trace configuration.

The reference configures via two class attributes and constructor args
(pyrayt/_pyrayt.py:190-196, SURVEY.md section 5.6); this package threads
one frozen dataclass through the engine instead.  It is hashable so it can
key the jit cache.

Also here: where the scripts that drive the GPU (chip_smoke.py, bench.py)
keep JAX's persistent compile cache.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

__all__ = ["TraceConfig", "compile_cache_dir", "enable_compile_cache"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``
    (a fixed path: the cache key includes it, so a moving one never hits)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO_ROOT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`;
    returns the directory."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    #: maximum bounce count before a ray is terminated (_pyrayt.py:242)
    generation_limit: int = 10
    #: epsilon push-off from the intersected surface (_pyrayt.py:190)
    ray_offset: float = 1e-6
    #: intensity kill threshold (_pyrayt.py:196)
    intensity_threshold: float = 0.1
    #: the reference's threshold test is inert (quirk Q1, _pyrayt.py:415-419);
    #: False reproduces shipped behavior, True implements the intended one
    apply_intensity_threshold: bool = False
    #: refractive index of the world / surrounding medium (_pyrayt.py:245)
    world_index: float = 1.0
    #: True -> fixed-trip-count generation loop (lax.scan): reverse-mode
    #: differentiable, no early exit.  False -> lax.while_loop with
    #: all-rays-dead early exit (forward-only, fastest).
    fixed_loop: bool = False
    #: fused GPU kernel dispatch for forward traces via trace_rays():
    #: None = auto (the kernel for supported f32 scenes on the GPU), True =
    #: force (raises where the kernel cannot run), False = the XLA engine.
    use_fused: Optional[bool] = None
    #: rematerialize the generation step under reverse-mode AD (scan driver
    #: only): saves just the inter-generation ray carry and recomputes the
    #: step's intermediates in the backward pass — trades ~1 extra forward
    #: step for not keeping every intersection/CSG intermediate in device
    #: memory.  No effect on forward-only traces.
    remat: bool = False
