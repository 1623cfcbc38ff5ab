"""Multi-device execution: ray-axis sharding over device meshes.

The reference is single-process, single-thread NumPy (SURVEY.md §2.3) —
this package is the build's first-class replacement.  Rays never interact
during a trace (no ray-ray terms anywhere in the reference trace loop,
pyrayt/_pyrayt.py:370-452), so the ray batch is the data/context-parallel
axis of this domain: shard it over every chip, replicate the (tiny) scene,
and the only cross-device communication is the psum of scalar metrics and
parameter gradients.
"""

from pyrayt_tpu.parallel.distributed import initialize_distributed, is_distributed
from pyrayt_tpu.parallel.mesh import (
    RAY_AXES,
    default_mesh,
    pad_rayset,
    rayset_sharding,
    shard_rayset,
)
from pyrayt_tpu.parallel.surfaces import (
    build_surface_sharded_nearest_hit,
    build_wide_sharded_trace_fn,
    pad_leaf_tables,
)
from pyrayt_tpu.parallel.trace import (
    build_sharded_trace_fn,
    build_train_step,
    sharded_trace,
)

__all__ = [
    "RAY_AXES",
    "default_mesh",
    "initialize_distributed",
    "is_distributed",
    "pad_rayset",
    "rayset_sharding",
    "shard_rayset",
    "build_sharded_trace_fn",
    "build_surface_sharded_nearest_hit",
    "build_train_step",
    "build_wide_sharded_trace_fn",
    "pad_leaf_tables",
    "sharded_trace",
]
