"""Optional surface-axis (tensor-parallel) sharding of the nearest-hit pass.

SURVEY.md §2.3's TP row: ray tracing has no weight matrices, but when a
scene's *leaf count* is huge (lens arrays, microlens grids: thousands of
single-primitive surfaces) the (n_rays x n_leaves) intersection sweep and
the scene tables can outgrow one device's memory if replicated.  This
module shards the LEAF axis over a mesh axis: each device intersects every
ray against its own leaf subset, folds a *local* nearest positive hit, and
one min-reduce combines (hit distance, hit leaf) across the axis — the
associative min-merge of the reference's running-minimum loop
(/root/reference/pyrayt/_pyrayt.py:384-386) is exactly a reducible op.

Scope: homogeneous scenes — every leaf is one primitive type and a plain
surface (no CSG; a CSG tree is a static program over *its own* leaves, so
trees must be co-located and are better served by ray-axis DP; measured in
docs/design_notes.md, replication wins for every realistic optical scene).
Tie-breaking matches the replicated engine: the smallest global leaf index
wins equal distances.

Ray metadata never moves: only the scene tables are sharded, rays stay
replicated along this axis (or sharded along the usual ray axes of the
same mesh for 2-D ray x surface layouts).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pyrayt_tpu.core import primitives as prim
from pyrayt_tpu.core.operations import TRANSFORM_PRECISION, affine_inverse

__all__ = [
    "pad_leaf_tables",
    "build_surface_sharded_nearest_hit",
    "build_wide_sharded_trace_fn",
]


def pad_leaf_tables(world, prim_params, multiple: int):
    """Pad (S, 4, 4) world transforms + (S, P) primitive params so S divides
    ``multiple``.  Padding leaves are identity transforms translated to
    x = 1e30 with zeroed primitive params — no representable ray reaches
    them, so they never win the min-fold."""
    world = jnp.asarray(world)
    prim_params = jnp.asarray(prim_params)
    s = world.shape[0]
    s_pad = -(-s // multiple) * multiple
    if s_pad == s:
        return world, prim_params, s
    pad = jnp.eye(4, dtype=world.dtype).at[0, 3].set(1e30)
    world = jnp.concatenate(
        (world, jnp.tile(pad[None], (s_pad - s, 1, 1))), axis=0
    )
    prim_params = jnp.concatenate(
        (
            prim_params,
            jnp.zeros((s_pad - s, prim_params.shape[1]), prim_params.dtype),
        ),
        axis=0,
    )
    return world, prim_params, s


def _local_nearest(type_code, world, prim_params, rays, leaf_offset):
    """Nearest positive hit over this shard's leaves.

    ``world``: (S_local, 4, 4); ``prim_params``: (S_local, P);
    ``rays``: (2, 4, n).  Returns ((n,) distance, (n,) global leaf index,
    -1 where nothing hit).
    """
    obj_tx = affine_inverse(world)
    local = jnp.einsum(
        "sij,rjn->srin", obj_tx, rays, precision=TRANSFORM_PRECISION
    )
    hits = jax.vmap(lambda r, p: prim.leaf_intersect(type_code, r, p))(
        local, prim_params
    )  # (S_local, 2, n)
    cand = jnp.where(hits > 0, hits, jnp.inf)
    cand = jnp.min(cand, axis=1)  # (S_local, n) per-leaf nearest positive
    dist = jnp.min(cand, axis=0)
    local_leaf = jnp.argmin(cand, axis=0)  # first (smallest index) wins ties
    leaf = jnp.where(
        jnp.isinf(dist), jnp.int32(-1), (local_leaf + leaf_offset).astype(jnp.int32)
    )
    return dist, leaf


def build_surface_sharded_nearest_hit(
    type_code: int, mesh: Mesh, axis_name: str = "surfaces"
):
    """Build ``fn(world (S,4,4), prim_params (S,P), rays (2,4,n)) ->
    (hit_distances (n,), hit_leaf (n,))`` with the leaf axis sharded over
    ``mesh[axis_name]``.

    S must be divisible by the axis size (use :func:`pad_leaf_tables`).
    The cross-shard combine is two collectives: a pmin of distances and a
    pmin of the winning leaf index (losers contribute INT32_MAX), so ties
    resolve to the smallest global leaf index — the replicated engine's
    fold order.
    """
    axis_size = mesh.shape[axis_name]

    def local_fn(world, prim_params, rays):
        s_local = world.shape[0]
        shard = jax.lax.axis_index(axis_name)
        dist, leaf = _local_nearest(
            type_code, world, prim_params, rays, shard * s_local
        )
        g_dist = jax.lax.pmin(dist, axis_name)
        winner = dist == g_dist
        cand = jnp.where(winner & (leaf >= 0), leaf, jnp.int32(2**31 - 1))
        g_leaf = jax.lax.pmin(cand, axis_name)
        g_leaf = jnp.where(jnp.isinf(g_dist), jnp.int32(-1), g_leaf)
        return g_dist, g_leaf

    mapped = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P()),
        out_specs=(P(), P()),
    )
    return jax.jit(mapped)


def replicated_nearest_hit(type_code: int, world, prim_params, rays):
    """Single-device reference implementation of the same fold (used by the
    equality tests and the replication-vs-sharding measurement)."""
    return _local_nearest(type_code, jnp.asarray(world), jnp.asarray(prim_params), rays, 0)


# ---------------------------------------------------------------------------
# Full surface-sharded trace (round 4: closes SURVEY §2.3's TP row)
#
# The isolated nearest-hit fold above proved the collective; this builds a
# complete *trace* — normals, materials, records, generation loop — with
# the tree axis of every wide group (tracer/engine._wide_plan: lens arrays,
# microlens grids) sharded over a mesh axis.  Scene TABLES stay replicated
# (measured 94 KB at 1000 leaves — replication is free, design notes); what
# shards is the (trees x rays) intersection sweep, the term whose working
# set actually grows with scene size.  Each device folds the nearest hit
# over its tree chunk plus the (replicated) non-grouped components, two
# pmins combine (distance, then winning leaf id — ties resolve to the
# smallest global leaf index), and the rest of the generation step runs
# replicated from the combined winner via the engine's gather-based
# wide INTERACT.  Reference counterpart: the same arbitrary-component loop
# at /root/reference/pyrayt/_pyrayt.py:377-392, single-threaded.
# ---------------------------------------------------------------------------


def build_wide_sharded_trace_fn(
    scene, config, mesh: Mesh, axis_name: str = "surfaces"
):
    """``fn(params, rays: RaySet) -> TraceResult`` with every wide tree
    group sharded over ``mesh[axis_name]``; rays and results replicated
    along that axis.

    Requires the scene to contain at least one batchable group
    (engine._wide_plan) and every group's tree count to divide the axis
    size.  Equality vs the replicated engine is asserted in
    tests/test_parallel/test_wide_sharded_trace.py.
    """
    from pyrayt_tpu.tracer import engine as eng
    from pyrayt_tpu.tracer.rayset import RaySet

    spec, materials = scene.spec, scene.materials
    _, groups = eng._wide_plan(spec)
    if not groups:
        raise ValueError(
            "scene has no batchable tree group (need >= "
            f"{eng._WIDE_GROUP_MIN} same-shape components); use ray-axis DP"
        )
    n_shards = mesh.shape[axis_name]
    for _, _, slot_matrix in groups:
        if len(slot_matrix) % n_shards:
            raise ValueError(
                f"group of {len(slot_matrix)} trees not divisible by "
                f"axis '{axis_name}' of size {n_shards}"
            )

    def local_slots(gi, slot_matrix):
        sm = jnp.asarray(np.asarray(slot_matrix))
        t_local = sm.shape[0] // n_shards
        base = lax.axis_index(axis_name) * t_local
        zero = jnp.zeros((), base.dtype)
        return lax.dynamic_slice(sm, (base, zero), (t_local, sm.shape[1]))

    def sharded_nearest(params, rays):
        dist, leaf, obj_tx = eng.scene_nearest_hit(
            spec, params, rays, group_slots_fn=local_slots
        )
        # all_gather + min instead of pmin: pmin has no differentiation
        # rule, and the trace must stay reverse-mode composable (the min
        # subgradient routes the distance cotangent to the winning shard,
        # exactly the replicated fold's semantics).  Cost: axis_size x n
        # per generation between devices.
        g_dist = jnp.min(lax.all_gather(dist, axis_name), axis=0)
        winner = (dist == g_dist) & (leaf >= 0)
        cand = jnp.where(winner, leaf, jnp.int32(2**31 - 1))
        g_leaf = jnp.min(lax.all_gather(cand, axis_name), axis=0)
        g_leaf = jnp.where(jnp.isinf(g_dist), jnp.int32(-1), g_leaf)
        return g_dist, g_leaf, obj_tx

    trace = eng._build_trace_fn(spec, materials, config, nearest_fn=sharded_nearest)

    replicated = P()
    params_specs = jax.tree_util.tree_map(lambda _: replicated, scene.params)
    rays_specs = RaySet(
        positions=replicated,
        directions=replicated,
        generation=replicated,
        intensity=replicated,
        wavelength=replicated,
        index=replicated,
        id=replicated,
    )
    result_specs = eng.TraceResult(
        records=replicated,
        record_mask=replicated,
        final_rays=rays_specs,
        generations_run=replicated,
    )
    mapped = jax.shard_map(
        trace,
        mesh=mesh,
        in_specs=(params_specs, rays_specs),
        out_specs=result_specs,
        check_vma=False,  # pmin makes the varying fold invariant again
    )
    return jax.jit(mapped)
