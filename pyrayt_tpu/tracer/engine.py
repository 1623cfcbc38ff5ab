"""The jitted trace engine.

Replacement for the reference's RayTracer state machine
(pyrayt/_pyrayt.py:329-456).  The INITIALIZE -> (PROPAGATE -> INTERACT)* ->
FINISH loop becomes one jitted program over fixed-size SoA arrays:

* PROPAGATE: every leaf surface is intersected against every ray in one
  batched pass (rays are the last axis); static CSG trees combine leaf
  intervals; an unrolled min-merge picks the nearest positive hit
  (parity: _pyrayt.py:370-392).
* INTERACT: branch-free masked physics — normals are computed per leaf
  under that leaf's hit mask, materials applied per material slot under
  dispatch masks (the reference's per-surface Python loop at
  _pyrayt.py:401-410 becomes where-composition).
* RECORD: instead of appending to a DataFrame, each generation scatters a
  ``(15, n)`` row block into a preallocated ``(G, 15, n)`` on-device
  buffer; dead rays are masked, never compacted (XLA static shapes).

Two loop drivers share the same generation step:
``lax.while_loop`` (early exit when all rays die — the fast forward path)
and ``lax.scan`` (fixed trip count — reverse-mode differentiable).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from pyrayt_tpu import materials as matl
from pyrayt_tpu.config import TraceConfig
from pyrayt_tpu.core import primitives as prim
from pyrayt_tpu.core.csg import csg_combine_with_ids
from pyrayt_tpu.core.intervals import (
    eval_tree_intervals,
    tree_supports_intervals,
)
from pyrayt_tpu.core.operations import (
    _norm_rows,
    _sum_rows,
    affine_inverse,
    reflect,
    refract,
    safe_normalize,
)
from pyrayt_tpu.scene.compile import LEAF, OP_BY_NAME, CompiledScene, SceneSpec
from pyrayt_tpu.tracer.rayset import RaySet, pytree_dataclass

__all__ = ["TraceResult", "trace_rays", "build_trace_fn", "N_RECORD_COLS"]

# record columns: generation, intensity, wavelength, index, id, surface,
#                 x0, y0, z0, x1, y1, z1, x_tilt, y_tilt, z_tilt
N_RECORD_COLS = 15


@pytree_dataclass
class TraceResult:
    records: jnp.ndarray  # (G, 15, n)
    record_mask: jnp.ndarray  # (G, n) bool
    final_rays: RaySet
    generations_run: jnp.ndarray  # scalar int


# ---------------------------------------------------------------------------
# PROPAGATE: nearest-hit search over the flattened scene
# ---------------------------------------------------------------------------


def _local_xyz_rays(m, rays):
    """Object-space (2, 3, n) xyz rays via unrolled scalar FMAs.

    ``m`` is one (4, 4) affine object transform (last row 0,0,0,1 — true
    for every transform the builders produce).  Unrolling beats an einsum
    here twice over: a K=4 contraction gains nothing from a matrix unit,
    and at full f32 precision XLA may split the einsum into multi-pass
    products, while FMAs stay single-pass exact and fuse into the
    intersectors.
    """
    p, v = rays[0], rays[1]
    lo = jnp.stack(
        [m[i, 0] * p[0] + m[i, 1] * p[1] + m[i, 2] * p[2] + m[i, 3] * p[3]
         for i in range(3)]
    )
    ld = jnp.stack(
        [m[i, 0] * v[0] + m[i, 1] * v[1] + m[i, 2] * v[2] for i in range(3)]
    )
    return jnp.stack((lo, ld))


# ---------------------------------------------------------------------------
# Wide scenes: batched same-shape CSG trees (lens / microlens arrays)
#
# Both engines unroll Python loops per leaf; that is the right call for the
# reference's realistic systems (<= ~15 leaves) but collapses for arrays of
# hundreds of identical lenslets — compile time and program size grow with
# the leaf count while the math is embarrassingly uniform.  The wide path
# groups top-level trees by *shape signature* (same CSG structure, primitive
# types, materials, normal scales — only transforms/parameters differ),
# stacks each group's tables along a new tree axis T, and evaluates the
# interval CSG once on (T, n) arrays: compile cost is per-GROUP, runtime is
# one batched sweep.  INTERACT switches from per-leaf masked accumulation to
# per-ray gathers from the (small, replicated) scene tables.
#
# Reference counterpart: the arbitrary-component-list loop at
# /root/reference/pyrayt/_pyrayt.py:377-392, which degrades gracefully to
# any component count (in Python time).  Tie-break deviation: within a
# group the nearest-hit reduce picks the lowest tree index (== lowest leaf
# slot, components are flattened in order), but a group folds into the
# global minimum at its FIRST member's position, so exact cross-component
# distance ties (measure zero) may resolve differently from the unrolled
# engine.
# ---------------------------------------------------------------------------

_WIDE_GROUP_MIN = 8  # trees of one signature before batching pays


def _tree_slots(tree):
    if tree[0] == LEAF:
        return (tree[1],)
    return _tree_slots(tree[1]) + _tree_slots(tree[2])


def _tree_template(tree):
    """The tree with leaf slots replaced by in-order positions 0..L-1."""

    def rec(t, c):
        if t[0] == LEAF:
            j = c[0]
            c[0] += 1
            return (LEAF, j)
        return (t[0], rec(t[1], c), rec(t[2], c))

    return rec(tree, [0])


def _tree_sig(spec: SceneSpec, tree):
    """Shape signature: trees with equal signatures share CSG structure and
    primitive types -> batchable.  Materials, normal scales, public ids,
    transforms and parameter values may all differ per tree: the engine's
    INTERACT resolves them by gathered per-leaf table, and the fused wide
    kernel reads them from a runtime per-slot meta table — so a
    HETEROGENEOUS group (a zoom lens of distinct elements, mixed glasses)
    batches exactly like a microlens array (round-5 extension; signatures
    included mat_slot/normal_scale through round 4)."""
    if tree[0] == LEAF:
        s = tree[1]
        return (LEAF, spec.leaf_types[s])
    return (tree[0], _tree_sig(spec, tree[1]), _tree_sig(spec, tree[2]))


@lru_cache(maxsize=256)
def _wide_plan(spec: SceneSpec):
    """Static fold plan: ``(order, groups)``.

    ``groups[i] = (template, types_pos, slot_matrix)`` — a batchable set of
    identically-shaped interval-supporting trees; ``order`` interleaves
    ``("group", i)`` (at the first member's component position) with
    ``("single", tree_index)`` entries for everything else.
    """
    by_sig = {}
    for ti, tree in enumerate(spec.trees):
        if tree_supports_intervals(tree):
            by_sig.setdefault(_tree_sig(spec, tree), []).append(ti)

    groups = []
    first_of_group = {}
    grouped = set()
    for sig, tis in by_sig.items():
        if len(tis) >= _WIDE_GROUP_MIN:
            first = spec.trees[tis[0]]
            template = _tree_template(first)
            types_pos = tuple(spec.leaf_types[s] for s in _tree_slots(first))
            slot_matrix = tuple(_tree_slots(spec.trees[t]) for t in tis)
            first_of_group[tis[0]] = len(groups)
            groups.append((template, types_pos, slot_matrix))
            grouped.update(tis)

    order = []
    for ti in range(len(spec.trees)):
        if ti in grouped:
            if ti in first_of_group:
                order.append(("group", first_of_group[ti]))
        else:
            order.append(("single", ti))
    return tuple(order), tuple(groups)


def _local_xyz_rays_batched(m, rays):
    """(T, 4, 4) object transforms x (2, 4, n) rays -> (2, 3, T, n) local
    rays, as broadcast FMAs (full f32 precision — see _local_xyz_rays)."""
    p, v = rays[0], rays[1]
    lo = jnp.stack(
        [
            m[:, i, 0, None] * p[0] + m[:, i, 1, None] * p[1]
            + m[:, i, 2, None] * p[2] + m[:, i, 3, None] * p[3]
            for i in range(3)
        ]
    )
    ld = jnp.stack(
        [
            m[:, i, 0, None] * v[0] + m[:, i, 1, None] * v[1]
            + m[:, i, 2, None] * v[2]
            for i in range(3)
        ]
    )
    return jnp.stack((lo, ld))


def _leaf_intersect_batched(type_code, local, pr):
    """prim.leaf_intersect over a (T,)-batched leaf table: ``local`` is
    (2, 3, T, n), ``pr`` is (T, P); params broadcast as (T, 1) columns."""

    def col(i):
        return pr[:, i, None]

    if type_code == prim.SPHERE:
        return prim.sphere_intersect(local, col(0))
    if type_code == prim.PARABOLOID:
        return prim.paraboloid_intersect(local, col(0), col(1))
    if type_code == prim.PLANE:
        return prim.plane_intersect(local, col(0), col(1))
    if type_code == prim.CUBE:
        spans = jnp.stack(
            [jnp.stack([col(2 * a), col(2 * a + 1)]) for a in range(3)]
        )  # (3, 2, T, 1) — cube_intersect reads spans[axis, lo/hi]
        return prim.cube_intersect(local, spans)
    if type_code == prim.CYLINDER:
        return prim.cylinder_intersect(local, col(0), col(1), col(2))
    raise ValueError(f"unknown primitive type code {type_code}")


def _wide_group_candidates(template, types_pos, slots, params, obj_tx, rays):
    """Per-tree nearest positive hit for one batched group.

    ``slots``: (T, L) global leaf-slot indices (array).  Returns
    ``(dist (T, n), leaf (T, n) int32)`` with -1 where a tree hits nothing.
    Shared by the replicated engine and the surface-sharded trace
    (pyrayt_tpu/parallel/surfaces.py), which passes its local shard of the
    slot matrix.
    """
    T, L = slots.shape
    n = rays.shape[-1]
    dtype = rays.dtype

    leaf_intervals = []
    for j in range(L):
        sj = slots[:, j]
        m = obj_tx[sj]  # (T, 4, 4) table gather
        pr = params["prim"][sj]  # (T, P)
        local = _local_xyz_rays_batched(m, rays)
        pair = _leaf_intersect_batched(types_pos[j], local, pr)
        lo = jnp.minimum(pair[0], pair[1])
        hi = jnp.maximum(pair[0], pair[1])
        ids = sj.astype(jnp.int32)[:, None]  # broadcasts against (T, n)
        leaf_intervals.append((lo, hi, ids, ids))

    dist = jnp.full((T, n), jnp.inf, dtype)
    leaf = jnp.full((T, n), -1, jnp.int32)
    for lo, hi, lo_id, hi_id in eval_tree_intervals(template, leaf_intervals):
        for cand, ids in ((lo, lo_id), (hi, hi_id)):
            cand = jnp.where(cand > 0, cand, jnp.inf)
            new_min = cand < dist
            dist = jnp.where(new_min, cand, dist)
            leaf = jnp.where(new_min, ids, leaf)
    return dist, leaf


def _reduce_tree_axis(dist, leaf):
    """Reduce (T, n) per-tree candidates to the per-ray nearest: min over
    the tree axis; ties pick the lowest tree index (= lowest leaf slot)."""
    dmin = jnp.min(dist, axis=0)
    win = jnp.argmin(dist, axis=0)
    lmin = jnp.take_along_axis(leaf, win[None], axis=0)[0]
    return dmin, jnp.where(jnp.isinf(dmin), jnp.int32(-1), lmin)


def _eval_tree(tree, leaf_hits):
    """Evaluate a static CSG tree -> sorted (hits, leaf-index ids)."""
    if tree[0] == LEAF:
        slot = tree[1]
        pair = leaf_hits[slot]  # (2, n) entry/exit roots
        hits = jnp.stack(
            (jnp.minimum(pair[0], pair[1]), jnp.maximum(pair[0], pair[1]))
        )
        ids = jnp.full(hits.shape, slot, dtype=jnp.int32)
        return hits, ids
    op_name, l_tree, r_tree = tree
    l_hits, l_ids = _eval_tree(l_tree, leaf_hits)
    r_hits, r_ids = _eval_tree(r_tree, leaf_hits)
    return csg_combine_with_ids(l_hits, l_ids, r_hits, r_ids, OP_BY_NAME[op_name])


def scene_nearest_hit(spec: SceneSpec, params, rays, group_slots_fn=None):
    """Nearest positive hit over all components.

    Returns ``(hit_distances (n,), hit_leaf (n,) int32, obj_tx (S,4,4))``
    with ``hit_leaf = -1`` for rays that hit nothing
    (parity: _pyrayt.py:370-392).

    Factory-shaped CSG trees evaluate via closed-form interval arithmetic
    (core.intervals; also reverse-mode differentiable); general trees use
    the comparator-network combiner.  Either way the nearest positive hit
    is an unrolled min-fold over the static, tiny event axis — no
    argmin/gather (SURVEY §7.4).  Wide groups (see
    _wide_plan) fold as one batched (trees x rays) sweep instead.

    ``group_slots_fn(group_index, slot_matrix) -> (T', L) array`` optionally
    restricts each wide group to a subset of its trees — the surface-
    sharded trace (pyrayt_tpu/parallel/surfaces.py) passes each device's
    chunk and pmin-combines the partial folds.
    """
    n = rays.shape[-1]
    order, groups = _wide_plan(spec)
    obj_tx = affine_inverse(params["world"])  # (S, 4, 4)

    hit_distances = jnp.full(n, jnp.inf, dtype=rays.dtype)
    hit_leaf = jnp.full(n, -1, dtype=jnp.int32)

    def fold(cand, ids):
        nonlocal hit_distances, hit_leaf
        cand = jnp.where(cand > 0, cand, jnp.inf)
        new_min = cand < hit_distances
        hit_distances = jnp.where(new_min, cand, hit_distances)
        hit_leaf = jnp.where(new_min, ids, hit_leaf)

    sorted_cache = {}

    def slot_sorted(s):
        if s not in sorted_cache:
            pair = prim.leaf_intersect(
                spec.leaf_types[s], _local_xyz_rays(obj_tx[s], rays), params["prim"][s]
            )
            sorted_cache[s] = jnp.stack(
                (jnp.minimum(pair[0], pair[1]), jnp.maximum(pair[0], pair[1]))
            )
        return sorted_cache[s]

    for kind, idx in order:
        if kind == "group":
            template, types_pos, slot_matrix = groups[idx]
            if group_slots_fn is not None:
                slots = group_slots_fn(idx, slot_matrix)
            else:
                slots = jnp.asarray(np.asarray(slot_matrix))
            d, l = _wide_group_candidates(
                template, types_pos, slots, params, obj_tx, rays
            )
            fold(*_reduce_tree_axis(d, l))
            continue
        tree = spec.trees[idx]
        hits = {s: slot_sorted(s) for s in _tree_slots(tree)}
        if tree_supports_intervals(tree):
            intervals = {
                s: (h[0], h[1], jnp.full(n, s, jnp.int32), jnp.full(n, s, jnp.int32))
                for s, h in hits.items()
            }
            for lo, hi, lo_id, hi_id in eval_tree_intervals(tree, intervals):
                fold(lo, lo_id)
                fold(hi, hi_id)
        else:
            shape_hits, shape_ids = _eval_tree(tree, hits)
            for row in range(shape_hits.shape[0]):
                fold(shape_hits[row], shape_ids[row])
    return hit_distances, hit_leaf, obj_tx


# ---------------------------------------------------------------------------
# INTERACT: normals + masked material physics
# ---------------------------------------------------------------------------


class _ColView:
    """`pr[s, i] -> column array` adapter so prim.leaf_normal_raw3 reads
    per-ray gathered parameter rows exactly like scalar table reads."""

    def __init__(self, rows):
        self._rows = rows  # (n, P)

    def __getitem__(self, idx):
        _, i = idx
        return self._rows[:, i]


def _leaf_needs_normal(spec: SceneSpec, s: int) -> bool:
    slot = spec.leaf_mat_slot[s]
    return not (spec.mat_packed[slot] and spec.mat_kinds[slot] == matl.KIND_ABSORB)


def _gathered_leaf_table(spec: SceneSpec, params, obj_tx):
    """One packed (S, 16+P+5) per-leaf table for the wide-scene INTERACT.

    The object transform (16), primitive params (P), and the static
    per-leaf scalars (type code, needs-normal, normal scale, material slot,
    public id) pack into ONE table gathered ONCE per generation instead of
    ~27 per-column gathers: one pass over the ray axis instead of many.
    Static columns ride as floats (all exactly representable).
    """
    S = spec.n_leaves
    dtype = obj_tx.dtype
    static_cols = np.stack(
        [
            np.asarray(spec.leaf_types, np.float64),
            np.asarray([_leaf_needs_normal(spec, s) for s in range(S)], np.float64),
            np.asarray(spec.leaf_normal_scale, np.float64),
            np.asarray(spec.leaf_mat_slot, np.float64),
            np.asarray(spec.leaf_ids, np.float64),
        ],
        axis=1,
    )
    return jnp.concatenate(
        (
            obj_tx.reshape(S, 16),
            params["prim"].astype(dtype),
            jnp.asarray(static_cols, dtype),
        ),
        axis=1,
    )


def _world_normals_gathered(spec: SceneSpec, params, obj_tx, hit_leaf, hit_points,
                            leaf_rows=None):
    """Per-ray world normals via ONE packed-table gather (wide INTERACT).

    The per-leaf masked accumulation of :func:`_world_normals` costs one
    dense pass over all rays PER LEAF — right for tens of leaves, hopeless
    for a 256-lenslet array.  Here each ray gathers its hit leaf's row of
    the packed table (:func:`_gathered_leaf_table`) and normals run as one
    dense pass per primitive TYPE present — O(#types) passes regardless of
    leaf count.
    """
    S = spec.n_leaves
    dtype = hit_points.dtype
    P = params["prim"].shape[1]
    if leaf_rows is None:
        idx = jnp.clip(hit_leaf, 0, S - 1)
        leaf_rows = _gathered_leaf_table(spec, params, obj_tx)[idx]
    m16 = leaf_rows[:, :16]
    pr = leaf_rows[:, 16:16 + P]
    types_of = leaf_rows[:, 16 + P]
    needs = leaf_rows[:, 16 + P + 1] > 0.5
    scale = leaf_rows[:, 16 + P + 2]

    def c(k):
        return m16[:, k]

    hp = hit_points
    # object-space hit point: affine rows of the gathered transform
    lp = [
        c(4 * i + 0) * hp[0] + c(4 * i + 1) * hp[1]
        + c(4 * i + 2) * hp[2] + c(4 * i + 3) * hp[3]
        for i in range(3)
    ]

    view = _ColView(pr)
    valid = (hit_leaf >= 0) & needs
    n3 = [jnp.zeros_like(hp[0]) for _ in range(3)]
    live_types = sorted(
        {spec.leaf_types[s] for s in range(S) if _leaf_needs_normal(spec, s)}
    )
    for t in live_types:
        mask = valid & (types_of == t)
        ln3 = prim.leaf_normal_raw3(t, lp, view, 0)
        # inverse-transpose: world_i = sum_j m[j][i] * ln_j
        wn3 = [
            c(0 + i) * ln3[0] + c(4 + i) * ln3[1] + c(8 + i) * ln3[2]
            for i in range(3)
        ]
        n3 = [jnp.where(mask, w, old) for w, old in zip(wn3, n3)]

    wn = jnp.stack(n3)
    sq = _sum_rows(wn * wn)
    zero = sq == 0
    wn = jnp.where(zero, wn, wn / jnp.sqrt(jnp.where(zero, 1.0, sq)))
    wn = wn * scale
    return jnp.concatenate((wn, jnp.zeros_like(wn[:1])), axis=0)


def _world_normals(spec: SceneSpec, params, obj_tx, hit_leaf, hit_points):
    """Per-ray world normals of each ray's hit leaf, masked-accumulated.

    Gather-free: for each leaf (small static count) compute normals for all
    rays and select by the hit mask — dense elementwise work instead of (n,4,4)
    gathers (parity: world_objects.py:401-418 inverse-transpose transform).
    Leaves whose material is the absorber are skipped entirely: the
    absorber zeroes ray directions without reading a normal.
    """
    normals = jnp.zeros_like(hit_points)
    for s, type_code in enumerate(spec.leaf_types):
        if spec.mat_kinds[spec.leaf_mat_slot[s]] == matl.KIND_ABSORB and spec.mat_packed[
            spec.leaf_mat_slot[s]
        ]:
            continue
        mask = hit_leaf == s
        m = obj_tx[s]
        # unrolled FMAs (see _local_xyz_rays); affine: last row (0,0,0,1)
        local_points = jnp.stack(
            [
                m[0, 0] * hit_points[0] + m[0, 1] * hit_points[1]
                + m[0, 2] * hit_points[2] + m[0, 3] * hit_points[3],
                m[1, 0] * hit_points[0] + m[1, 1] * hit_points[1]
                + m[1, 2] * hit_points[2] + m[1, 3] * hit_points[3],
                m[2, 0] * hit_points[0] + m[2, 1] * hit_points[1]
                + m[2, 2] * hit_points[2] + m[2, 3] * hit_points[3],
                hit_points[3],
            ]
        )
        local_normals = prim.leaf_normal(type_code, local_points, params["prim"][s])
        # inverse-transpose (w dropped): world_i = sum_j m[j][i] ln_j
        world = jnp.stack(
            [
                m[0, i] * local_normals[0]
                + m[1, i] * local_normals[1]
                + m[2, i] * local_normals[2]
                for i in range(3)
            ]
            + [jnp.zeros_like(local_normals[0])]
        )
        # clamp the sqrt *argument* so reverse-mode stays NaN-free at
        # zero-length normals (see core.operations.safe_normalize)
        sq = _sum_rows(world * world)
        zero = sq == 0
        world = jnp.where(zero, world, world / jnp.sqrt(jnp.where(zero, 1.0, sq)))
        world = world * spec.leaf_normal_scale[s]
        normals = jnp.where(mask, world, normals)
    return normals


def _apply_materials(
    spec: SceneSpec,
    materials,
    params,
    config: TraceConfig,
    ray_slot,
    no_hit,
    directions,
    normals,
    wavelength,
    index,
    intensity,
):
    """Masked material dispatch (parity: _pyrayt.py:401-410, materials.py)."""
    new_dir = jnp.where(no_hit, 0.0, directions)
    new_index = index
    new_intensity = intensity
    for slot, material in enumerate(materials):
        mask = (ray_slot == slot) & ~no_hit
        kind = spec.mat_kinds[slot]
        if spec.mat_packed[slot] and kind == matl.KIND_ABSORB:
            d2 = jnp.zeros_like(directions)
            i2, t2 = index, intensity
        elif spec.mat_packed[slot] and kind == matl.KIND_MIRROR:
            d2 = reflect(directions, normals)
            i2, t2 = index, intensity
        elif spec.mat_packed[slot] and kind == matl.KIND_GLASS:
            n2 = matl.index_from_coeffs(params["glass"][slot], wavelength)
            d2, i2 = refract(
                directions, normals, index, n2, n_global=config.world_index
            )
            t2 = intensity
        else:
            d2, i2, t2 = material.pure_trace(
                directions, normals, wavelength, index, intensity
            )
        new_dir = jnp.where(mask, d2, new_dir)
        new_index = jnp.where(mask, i2, new_index)
        new_intensity = jnp.where(mask, t2, new_intensity)
    return new_dir, new_index, new_intensity


# ---------------------------------------------------------------------------
# one generation step
# ---------------------------------------------------------------------------


def _generation_step(spec, materials, config, params, state, nearest_fn=None):
    """One PROPAGATE + INTERACT + RECORD step on masked SoA state.

    ``state`` is ``(rays: RaySet, alive: (n,) bool)``; returns the new
    state plus the (15, n) record block and its row mask.  ``nearest_fn``
    overrides the PROPAGATE nearest-hit search (the surface-sharded trace
    in pyrayt_tpu/parallel/surfaces.py injects its collective fold here).
    """
    rays_state, alive = state
    p_old = rays_state.positions
    v_old = rays_state.directions
    rays = jnp.stack((p_old, v_old))
    wide = bool(_wide_plan(spec)[1])

    # named scopes label the HLO for XProf / jax.profiler traces
    with jax.named_scope("propagate"):
        hit_distances, hit_leaf, obj_tx = (
            nearest_fn(params, rays)
            if nearest_fn is not None
            else scene_nearest_hit(spec, params, rays)
        )
        no_hit = hit_leaf < 0

        # advance to the hit point (no-hit rays stay put; _pyrayt.py:404-407)
        t_safe = jnp.where(no_hit, 0.0, hit_distances)
        p_hit = p_old + t_safe * v_old

    with jax.named_scope("normals"):
        if wide:
            # ONE packed-table gather feeds normals, material dispatch and
            # the record's public surface id
            idx = jnp.clip(hit_leaf, 0, spec.n_leaves - 1)
            leaf_rows = _gathered_leaf_table(spec, params, obj_tx)[idx]
            normals = _world_normals_gathered(
                spec, params, obj_tx, hit_leaf, p_hit, leaf_rows=leaf_rows
            )
        else:
            leaf_rows = None
            normals = _world_normals(spec, params, obj_tx, hit_leaf, p_hit)

    # leaf -> material-slot table lookup: a where-fold for small scenes
    # (static tiny table); the packed-gather column for wide ones (a
    # 256-leaf where-fold is 256 dense passes)
    with jax.named_scope("interact"):
        if wide:
            P = params["prim"].shape[1]
            ray_slot = jnp.where(no_hit, 0.0, leaf_rows[:, 16 + P + 3])
        else:
            ray_slot = jnp.zeros_like(hit_leaf)
            for s, slot in enumerate(spec.leaf_mat_slot):
                ray_slot = jnp.where(hit_leaf == s, slot, ray_slot)
        new_dir, new_index, new_intensity = _apply_materials(
            spec,
            materials,
            params,
            config,
            ray_slot,
            no_hit,
            v_old,
            normals,
            rays_state.wavelength,
            rays_state.index,
            rays_state.intensity,
        )

    # death rules (parity incl. quirk Q1: the intensity test is opt-in)
    absorbed = jnp.isclose(_norm_rows(v_old), 0)
    dead = absorbed | no_hit
    if config.apply_intensity_threshold:
        dead = dead | (rays_state.intensity < config.intensity_threshold)
    living = alive & ~dead

    # record block: old metadata + hit surface + segment endpoints + tilts
    # (parity: _RayTraceDataframe.insert, _pyrayt.py:168-186)
    if wide:
        P = params["prim"].shape[1]
        public_id = jnp.where(
            no_hit, 0.0, leaf_rows[:, 16 + P + 4].astype(rays.dtype)
        )
    else:
        public_id = jnp.zeros(hit_leaf.shape, dtype=rays.dtype)
        for s, leaf_id in enumerate(spec.leaf_ids):
            public_id = jnp.where(
                hit_leaf == s, jnp.asarray(leaf_id, rays.dtype), public_id
            )
    tilt = safe_normalize(v_old[:3], axis=0)
    record = jnp.concatenate(
        (
            rays_state.metadata,
            public_id[None],
            p_old[:3],
            p_hit[:3],
            tilt,
        )
    )

    # state update: epsilon push-off, generation bump (_pyrayt.py:439-452)
    new_positions = p_hit + config.ray_offset * new_dir
    next_rays = rays_state.replace(
        positions=jnp.where(living, new_positions, p_hit),
        directions=new_dir,
        generation=jnp.where(living, rays_state.generation + 1, rays_state.generation),
        index=new_index,
        intensity=new_intensity,
    )
    return (next_rays, living), record, living


# ---------------------------------------------------------------------------
# loop drivers
# ---------------------------------------------------------------------------


@lru_cache(maxsize=64)
def build_trace_fn(spec: SceneSpec, materials, config: TraceConfig):
    """Build (and cache) the jitted trace function for a static scene shape.

    Returned callable: ``fn(params, initial_rays: RaySet) -> TraceResult``.
    Re-traces with different parameter *values* reuse the compilation.
    """
    return _build_trace_fn(spec, materials, config)


def _build_trace_fn(
    spec: SceneSpec, materials, config: TraceConfig, nearest_fn=None
):
    """Uncached builder; ``nearest_fn(params, rays)`` optionally replaces
    the PROPAGATE search (see pyrayt_tpu/parallel/surfaces.py)."""
    generations = config.generation_limit

    def step(params, carry):
        return _generation_step(
            spec, materials, config, params, carry, nearest_fn=nearest_fn
        )

    if config.remat:
        # save only the (13+1)-row inter-generation carry; recompute the
        # step's intermediates (per-leaf hits, CSG intervals, normals) in
        # the backward pass instead of keeping them in device memory
        step = jax.checkpoint(step)

    if config.fixed_loop:

        def trace(params, initial_rays: RaySet) -> TraceResult:
            n = initial_rays.n_rays
            alive0 = jnp.ones(n, dtype=bool)

            def scan_body(carry, _):
                new_carry, record, mask = step(params, carry)
                return new_carry, (record, mask)

            (final_rays, alive), (records, masks) = lax.scan(
                scan_body, (initial_rays, alive0), None, length=generations
            )
            gen_run = jnp.sum(jnp.any(masks, axis=1))
            return TraceResult(
                records=records,
                record_mask=masks,
                final_rays=final_rays,
                generations_run=gen_run,
            )

    else:

        def trace(params, initial_rays: RaySet) -> TraceResult:
            n = initial_rays.n_rays
            dtype = initial_rays.positions.dtype
            records0 = jnp.zeros((generations, N_RECORD_COLS, n), dtype=dtype)
            masks0 = jnp.zeros((generations, n), dtype=bool)
            alive0 = jnp.ones(n, dtype=bool)

            def cond(carry):
                g, (_, alive), _, _ = carry
                return (g < generations) & jnp.any(alive)

            def body(carry):
                g, ray_carry, records, masks = carry
                new_carry, record, mask = step(params, ray_carry)
                records = lax.dynamic_update_slice_in_dim(
                    records, record[None], g, axis=0
                )
                masks = lax.dynamic_update_slice_in_dim(masks, mask[None], g, axis=0)
                return g + 1, new_carry, records, masks

            g, (final_rays, _), records, masks = lax.while_loop(
                cond, body, (jnp.asarray(0), (initial_rays, alive0), records0, masks0)
            )
            # one definition of generations_run across every dispatch path
            # (scan / while / fused): the number of generations that recorded
            # at least one living ray.  The raw iteration count ``g`` counts
            # the trailing all-dead pass too, so it is NOT used here.
            return TraceResult(
                records=records,
                record_mask=masks,
                final_rays=final_rays,
                generations_run=jnp.sum(jnp.any(masks, axis=1)),
            )

    return jax.jit(trace)


def trace_rays(
    scene: CompiledScene, initial_rays: RaySet, config: TraceConfig
) -> TraceResult:
    """Trace an initial RaySet through a compiled scene (forward only).

    On the GPU, f32 traces of scenes the fused kernel supports (packed
    materials, interval CSG trees, at most 32 leaves) run that kernel
    (pyrayt_tpu/ops/fused_trace.py); everything else -- other backends,
    custom Python materials, wide scenes, or ``config.use_fused=False`` --
    runs the XLA engine.  The backend check happens here at call time,
    never baked into a cache.  Gradient users compose with
    :func:`build_trace_fn`, which is always differentiable.
    """
    from pyrayt_tpu.ops import fused_trace as ft

    itemsize = jnp.dtype(initial_rays.positions.dtype).itemsize
    if ft.pick_fused(scene.spec, config, itemsize):
        fn = ft.build_fused_trace_fn(scene.spec, scene.materials, config)
    else:
        fn = build_trace_fn(scene.spec, scene.materials, config)
    return fn(scene.params, initial_rays)
