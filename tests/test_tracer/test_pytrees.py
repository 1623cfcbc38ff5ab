"""RaySet and TraceResult are registered pytree dataclasses (no flax):
every field is a child, ``.replace`` copies, and jit / vmap / tree_map
see through them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyrayt_tpu.tracer.engine import TraceResult
from pyrayt_tpu.tracer.rayset import RaySet


def test_rayset_flattens_to_its_seven_arrays():
    rays = RaySet.create(5)
    leaves, treedef = jax.tree_util.tree_flatten(rays)
    assert len(leaves) == 7
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(back, RaySet)
    np.testing.assert_array_equal(np.asarray(back.positions), np.asarray(rays.positions))
    assert RaySet.fields == ("generation", "intensity", "wavelength", "index", "id")


def test_replace_copies_and_fields_are_frozen():
    rays = RaySet.create(3)
    moved = rays.replace(intensity=jnp.zeros(3))
    assert float(jnp.sum(rays.intensity)) == 300.0
    assert float(jnp.sum(moved.intensity)) == 0.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        rays.intensity = jnp.zeros(3)


def test_jit_and_vmap_see_through_the_dataclasses():
    rays = RaySet.create(4)

    @jax.jit
    def shift(r):
        return r.replace(positions=r.positions + 1.0)

    out = shift(rays)
    assert isinstance(out, RaySet)
    np.testing.assert_allclose(np.asarray(out.positions[3]), 2.0)

    result = TraceResult(
        records=jnp.ones((2, 15, 4)),
        record_mask=jnp.ones((2, 4), bool),
        final_rays=rays,
        generations_run=jnp.asarray(2),
    )
    total = jax.vmap(lambda r: jnp.sum(r.records), in_axes=(TraceResult(
        records=0, record_mask=None, final_rays=None, generations_run=None,
    ),))(result)
    np.testing.assert_allclose(np.asarray(total), 60.0)
    assert len(jax.tree_util.tree_leaves(result)) == 3 + 7
