"""Ray storage.

The reference packs rays + metadata in one ``(13, n)`` ndarray subclass
(pyrayt/_pyrayt.py:13-144).  Here it is a typed pytree of SoA arrays with
the ray axis *last*, which jit / vmap / shard naturally.  Field names and
defaults match the reference (wavelength 0.633 um, index 1, intensity 100,
ids = arange).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["RaySet", "concatenate"]

METADATA_FIELDS = ("generation", "intensity", "wavelength", "index", "id")


def pytree_dataclass(cls):
    """A frozen dataclass registered as a pytree whose every field is a
    child, with a ``.replace(**changes)`` copy method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    names = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=names, meta_fields=[])


@pytree_dataclass
class RaySet:
    """A bundle of rays: homogeneous positions/directions plus metadata.

    All arrays share the trailing ray axis ``n``; ``positions`` and
    ``directions`` are ``(4, n)`` homogeneous coordinates (w = 1 / 0).
    """

    positions: jnp.ndarray  # (4, n)
    directions: jnp.ndarray  # (4, n)
    generation: jnp.ndarray  # (n,)
    intensity: jnp.ndarray  # (n,)
    wavelength: jnp.ndarray  # (n,)
    index: jnp.ndarray  # (n,)
    id: jnp.ndarray  # (n,)

    fields = METADATA_FIELDS

    @classmethod
    def create(cls, n_rays: int, wavelength=0.633, intensity=100.0, index=1.0):
        """A fresh set at the origin with reference-default metadata."""
        positions = jnp.zeros((4, n_rays)).at[3].set(1.0)
        directions = jnp.zeros((4, n_rays))
        return cls(
            positions=positions,
            directions=directions,
            generation=jnp.zeros(n_rays),
            intensity=jnp.full(n_rays, float(intensity)),
            wavelength=jnp.full(n_rays, float(wavelength)),
            index=jnp.full(n_rays, float(index)),
            id=jnp.arange(n_rays, dtype=jnp.result_type(float)),
        )

    @property
    def n_rays(self) -> int:
        return self.positions.shape[-1]

    @property
    def rays(self) -> jnp.ndarray:
        """(2, 4, n) stacked view matching the reference layout."""
        return jnp.stack((self.positions, self.directions))

    @property
    def metadata(self) -> jnp.ndarray:
        """(5, n) metadata block in reference field order."""
        return jnp.stack(
            (self.generation, self.intensity, self.wavelength, self.index, self.id)
        )

    def with_rays(self, rays) -> "RaySet":
        rays = jnp.asarray(rays)
        return self.replace(positions=rays[0], directions=rays[1])

    def to_numpy(self) -> np.ndarray:
        """(13, n) packed array bit-matching the reference RaySet layout."""
        return np.concatenate(
            (np.asarray(self.rays).reshape(8, -1), np.asarray(self.metadata))
        )


def concatenate(ray_sets) -> RaySet:
    """Concatenate ray sets along the ray axis (source hstack parity)."""
    ray_sets = list(ray_sets)
    first = ray_sets[0]
    return RaySet(
        **{
            name: jnp.concatenate([getattr(r, name) for r in ray_sets], axis=-1)
            for name in (
                "positions",
                "directions",
                "generation",
                "intensity",
                "wavelength",
                "index",
                "id",
            )
        }
    )
