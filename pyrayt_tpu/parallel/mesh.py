"""Device meshes and RaySet shardings.

Design (SURVEY.md §2.3, §5.7): a 2-D ``('hosts', 'rays')`` mesh where both
axes shard the ray batch — 'hosts' maps to the processes of a multi-host
job and 'rays' to the devices within a host.  Collectives (metric /
gradient psums) reduce over both axes; because the scene is replicated there
is no weight-shard traffic at all, so the hierarchical reduction stays on
the fast in-host links first and crosses hosts once with O(#params)
scalars.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pyrayt_tpu.tracer.rayset import RaySet

__all__ = [
    "RAY_AXES",
    "default_mesh",
    "rayset_sharding",
    "shard_rayset",
    "pad_rayset",
]

# mesh axis names: both shard the ray batch (hierarchical DP)
RAY_AXES: Tuple[str, str] = ("hosts", "rays")


def default_mesh(
    n_devices: Optional[int] = None,
    n_hosts: Optional[int] = None,
    devices=None,
) -> Mesh:
    """A ``('hosts', 'rays')`` mesh over the first ``n_devices`` devices.

    ``n_hosts`` defaults to ``jax.process_count()`` so a single-host run gets
    a (1, D) mesh and a multi-host run automatically maps the leading axis
    onto the DCN dimension of ``jax.devices()``'s host-major ordering.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    if n_hosts is None:
        n_hosts = jax.process_count() if len(devices) == len(jax.devices()) else 1
    if len(devices) % n_hosts:
        raise ValueError(f"{len(devices)} devices not divisible by {n_hosts} hosts")
    grid = np.asarray(devices).reshape(n_hosts, len(devices) // n_hosts)
    return Mesh(grid, RAY_AXES)


def rayset_sharding(mesh: Mesh) -> RaySet:
    """A RaySet-shaped pytree of NamedShardings: ray axis split over the
    whole mesh, leading (coordinate) axes replicated."""
    vec = NamedSharding(mesh, P(None, RAY_AXES))  # (4, n) arrays
    scalar = NamedSharding(mesh, P(RAY_AXES))  # (n,) arrays
    return RaySet(
        positions=vec,
        directions=vec,
        generation=scalar,
        intensity=scalar,
        wavelength=scalar,
        index=scalar,
        id=scalar,
    )


def shard_rayset(rays: RaySet, mesh: Mesh) -> RaySet:
    """Place a RaySet on the mesh with the ray axis sharded."""
    return jax.device_put(rays, rayset_sharding(mesh))


def pad_rayset(rays: RaySet, multiple: int) -> Tuple[RaySet, int]:
    """Pad the ray axis up to a multiple of ``multiple`` with dead rays.

    Padding rays have zero direction, so the engine marks them absorbed on
    generation 0 and they never appear in the results frame (masked, not
    compacted — XLA static shapes).  Returns ``(padded, n_valid)``.
    """
    n = rays.n_rays
    n_pad = (-n) % multiple
    if n_pad == 0:
        return rays, n

    def pad(x):
        widths = [(0, 0)] * (x.ndim - 1) + [(0, n_pad)]
        return jnp.pad(x, widths)

    padded = RaySet(
        positions=pad(rays.positions).at[3, n:].set(1.0),
        directions=pad(rays.directions),
        generation=pad(rays.generation),
        intensity=pad(rays.intensity),
        wavelength=pad(rays.wavelength),
        index=pad(rays.index),
        id=pad(rays.id),
    )
    return padded, n
