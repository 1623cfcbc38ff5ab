"""Surface-axis (TP) sharding: the sharded nearest-hit fold must equal the
replicated one on the 8-virtual-device CPU mesh (SURVEY.md §2.3 TP row).

Distances compare at 1-ulp-scale rtol, not bit-exact: XLA contracts the
transform FMAs differently for different leaf-axis extents, so the same
math compiled for a 2-leaf shard vs a 16-leaf replica differs in the last
bit.  Leaf identities must still be exactly equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from pyrayt_tpu.core import primitives as prim
from pyrayt_tpu.parallel.surfaces import (
    build_surface_sharded_nearest_hit,
    pad_leaf_tables,
    replicated_nearest_hit,
)


def _sphere_grid(n_side, spacing=3.0, radius=1.0):
    """A synthetic n_side^2 grid of unit spheres in the YZ plane at x=5."""
    ys, zs = np.meshgrid(
        (np.arange(n_side) - (n_side - 1) / 2) * spacing,
        (np.arange(n_side) - (n_side - 1) / 2) * spacing,
    )
    centers = np.stack(
        [np.full(ys.size, 5.0), ys.ravel(), zs.ravel()], axis=1
    )
    world = np.tile(np.eye(4), (len(centers), 1, 1))
    world[:, :3, 3] = centers
    params = np.zeros((len(centers), 8))
    params[:, 0] = radius
    return jnp.asarray(world), jnp.asarray(params)


def _ray_fan(n):
    """n rays from the origin fanned across the sphere grid."""
    rng = np.random.default_rng(0)
    directions = rng.normal(size=(3, n))
    directions[0] = np.abs(directions[0]) + 1.0  # forward into the grid
    directions /= np.linalg.norm(directions, axis=0)
    rays = np.zeros((2, 4, n))
    rays[0, 3] = 1.0
    rays[1, :3] = directions
    return jnp.asarray(rays)


@pytest.fixture()
def surface_mesh():
    devices = np.asarray(jax.devices()[:8])
    return Mesh(devices, ("surfaces",))


class TestSurfaceShardedNearestHit:
    def test_matches_replicated_fold(self, surface_mesh):
        world, params = _sphere_grid(4)  # 16 leaves over 8 devices
        rays = _ray_fan(512)
        fn = build_surface_sharded_nearest_hit(prim.SPHERE, surface_mesh)
        dist_s, leaf_s = fn(world, params, rays)
        dist_r, leaf_r = replicated_nearest_hit(prim.SPHERE, world, params, rays)
        np.testing.assert_allclose(
            np.asarray(dist_s), np.asarray(dist_r), rtol=1e-12
        )
        np.testing.assert_array_equal(np.asarray(leaf_s), np.asarray(leaf_r))
        # the fan hits several distinct leaves and misses with -1
        hit_ids = set(np.asarray(leaf_s).tolist())
        assert len(hit_ids - {-1}) > 4
        assert (np.asarray(dist_s)[np.asarray(leaf_s) >= 0] > 0).all()

    def test_padding_leaves_never_win(self, surface_mesh):
        world, params = _sphere_grid(3)  # 9 leaves -> pads to 16
        world_p, params_p, s_real = pad_leaf_tables(world, params, 8)
        assert world_p.shape[0] == 16 and s_real == 9
        rays = _ray_fan(256)
        fn = build_surface_sharded_nearest_hit(prim.SPHERE, surface_mesh)
        dist_s, leaf_s = fn(world_p, params_p, rays)
        assert int(np.asarray(leaf_s).max()) < 9
        dist_r, leaf_r = replicated_nearest_hit(prim.SPHERE, world, params, rays)
        np.testing.assert_allclose(
            np.asarray(dist_s), np.asarray(dist_r), rtol=1e-12
        )
        np.testing.assert_array_equal(np.asarray(leaf_s), np.asarray(leaf_r))

    def test_tie_breaks_to_smallest_leaf_index(self, surface_mesh):
        # two identical coincident spheres on different shards: the
        # replicated fold's first-wins rule must survive the collectives
        world = jnp.tile(jnp.eye(4)[None], (8, 1, 1)).at[:, 0, 3].set(5.0)
        params = jnp.zeros((8, 8)).at[:, 0].set(1.0)
        rays = jnp.zeros((2, 4, 4)).at[0, 3].set(1.0).at[1, 0].set(1.0)
        fn = build_surface_sharded_nearest_hit(prim.SPHERE, surface_mesh)
        dist, leaf = fn(world, params, rays)
        np.testing.assert_allclose(np.asarray(dist), 4.0)
        np.testing.assert_array_equal(np.asarray(leaf), 0)
