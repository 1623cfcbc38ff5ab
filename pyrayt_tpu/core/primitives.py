"""Batched ray/primitive intersection kernels.

Functional JAX ports of the five surface primitives in the reference
(tinygfx/g3d/primitives.py:220-741).  Each intersector maps a ray bundle
``rays: (2, 4, n)`` (row 0 homogeneous origins, row 1 homogeneous
directions, both in *object* space) to a ``(2, n)`` array of entry/exit hit
parameters ``t``; each normal function maps object-space points ``(4, n)``
to unit object-space normals ``(4, n)``.

The +/-inf hit conventions are reproduced exactly — they are load-bearing
for the CSG interval engine (see pyrayt_tpu.core.csg).  Two deliberate
deviations from the reference, both in the "impossible ray" regime:

* a degenerate ray (zero direction, i.e. an absorbed ray kept alive by the
  masked formulation) yields ``(+inf, +inf)`` instead of NaN;
* every guarded division/sqrt is NaN-free in both the forward and backward
  pass so ``jax.grad`` through an entire trace stays finite.

All functions are jit/vmap/grad-safe and shape-polymorphic in ``n``.
"""

from __future__ import annotations

import jax.numpy as jnp

from pyrayt_tpu.core.operations import (
    _norm_rows,
    binomial_root,
    element_wise_dot,
    safe_sqrt,
)

__all__ = [
    "SPHERE",
    "PARABOLOID",
    "PLANE",
    "CUBE",
    "CYLINDER",
    "PARAM_WIDTH",
    "sphere_intersect",
    "sphere_normal",
    "paraboloid_intersect",
    "paraboloid_normal",
    "plane_intersect",
    "plane_normal",
    "cube_intersect",
    "cube_normal",
    "cylinder_intersect",
    "cylinder_normal",
    "leaf_intersect",
    "leaf_normal",
    "leaf_normal_raw3",
]

# primitive type codes used by the flattened scene representation
SPHERE = 0
PARABOLOID = 1
PLANE = 2
CUBE = 3
CYLINDER = 4

# width of the packed per-leaf parameter vector (see ``pack_params`` users):
#   SPHERE     [radius, 0, 0, 0, 0, 0]
#   PARABOLOID [focus, height, 0, 0, 0, 0]
#   PLANE      [width, length, 0, 0, 0, 0]
#   CUBE       [x_min, x_max, y_min, y_max, z_min, z_max]
#   CYLINDER   [radius, h_min, h_max, capped, 0, 0]
PARAM_WIDTH = 6



def _sort2(a, b):
    """(2, n) ascending pair — jnp.sort(axis=0) lowers to a variadic sort;
    a minimum/maximum pair is plain elementwise work that fuses."""
    return jnp.stack((jnp.minimum(a, b), jnp.maximum(a, b)))

def _origins_directions(rays):
    # rays may be (2, 4, ...) homogeneous or (2, 3, ...) plain-xyz (the
    # fused kernel strips the constant w rows); both index identically
    rays = jnp.asarray(rays)
    return rays[0, :3], rays[1, :3]


def _slab_clip(primary_hits, lo_hit, hi_hit):
    """Clip a sorted ``(2, n)`` interval against a second sorted interval.

    Implements the max-of-mins / min-of-maxes merge used by the reference's
    Paraboloid and Cylinder cap clipping (tinygfx/g3d/primitives.py:392-398,
    705-711): both hits become ``+inf`` when the intervals do not overlap.
    """
    entry = jnp.maximum(primary_hits[0], lo_hit)
    exit_ = jnp.minimum(primary_hits[1], hi_hit)
    hits = jnp.stack((entry, exit_))
    return jnp.where(hits[0] <= hits[1], hits, jnp.inf)


# ---------------------------------------------------------------------------
# Sphere  (reference: tinygfx/g3d/primitives.py:241-296)
# ---------------------------------------------------------------------------


def sphere_intersect(rays, radius):
    origins, directions = _origins_directions(rays)
    a = element_wise_dot(directions, directions, axis=0)
    b = 2 * element_wise_dot(directions, origins, axis=0)
    c = element_wise_dot(origins, origins, axis=0) - radius**2

    disc = b**2 - 4 * a * c
    root = safe_sqrt(disc)
    degenerate = jnp.isclose(a, 0)  # zero-direction (dead) rays never hit
    hits = jnp.stack(((-b + root), (-b - root))) / (2 * a + degenerate)
    return jnp.where((disc >= 0) & ~degenerate, hits, jnp.inf)


def _zero_w(points):
    """Zero the homogeneous w row without a scatter (Pallas-lowerable)."""
    return jnp.concatenate((points[:3], jnp.zeros_like(points[:1])), axis=0)


def sphere_normal(points, radius):
    del radius  # the sphere normal is radial regardless of radius
    points = jnp.asarray(points)
    normals = _zero_w(points)
    norm = _norm_rows(normals)
    return normals / jnp.where(norm == 0, 1.0, norm)


# ---------------------------------------------------------------------------
# Paraboloid  (reference: tinygfx/g3d/primitives.py:320-419)
# ---------------------------------------------------------------------------


def paraboloid_intersect(rays, focus, height):
    origins, directions = _origins_directions(rays)
    origins_xy, directions_xy = origins[:2], directions[:2]

    a = element_wise_dot(directions_xy, directions_xy, axis=0)
    b = 2 * element_wise_dot(origins_xy, directions_xy, axis=0) - 4 * focus * directions[2]
    c = element_wise_dot(origins_xy, origins_xy, axis=0) - 4 * focus * origins[2]

    disc = b**2 - 4 * a * c
    linear_cases = jnp.isclose(a, 0)
    root = safe_sqrt(disc)
    parabola_hits = jnp.stack(((-b + root), (-b - root))) / (2 * a + linear_cases)
    parabola_hits = jnp.where(disc >= 0, parabola_hits, jnp.inf)

    # linear case: one real hit plus a signed infinity by travel direction
    linear_hits = jnp.stack(
        (
            -c / (b + jnp.isclose(b, 0)),
            jnp.where(directions[2] >= 0, jnp.inf, -jnp.inf),
        )
    )
    parabola_hits = jnp.where(linear_cases, linear_hits, parabola_hits)
    parabola_hits = _sort2(parabola_hits[0], parabola_hits[1])

    # clip against the z in [0, height] slab (cap planes)
    parallel = jnp.isclose(directions[2], 0)
    inside = (origins[2] >= 0) & (origins[2] <= height)
    denominator = directions[2] + parallel
    lo = -origins[2] / denominator
    hi = (height - origins[2]) / denominator
    slab = _sort2(lo, hi)
    slab_lo = jnp.where(parallel, jnp.where(inside, -jnp.inf, jnp.inf), slab[0])
    slab_hi = jnp.where(parallel, jnp.inf, slab[1])

    return _slab_clip(parabola_hits, slab_lo, slab_hi)


def paraboloid_normal(points, focus, height):
    points = jnp.asarray(points)
    zeros = jnp.zeros_like(points[0])
    normals = jnp.stack((points[0], points[1], zeros - 2 * focus, zeros))
    cap = jnp.isclose(points[2], height)
    cap_normal = jnp.stack((zeros, zeros, zeros + 1.0, zeros))
    normals = jnp.where(cap, cap_normal, normals)
    norm = _norm_rows(normals)
    return normals / jnp.where(norm == 0, 1.0, norm)


# ---------------------------------------------------------------------------
# Plane  (finite patch of z=0; reference: tinygfx/g3d/primitives.py:436-498)
# ---------------------------------------------------------------------------


def plane_intersect(rays, width, length):
    origins, directions = _origins_directions(rays)

    lo_bounds = []
    hi_bounds = []
    for axis, dim in ((0, width), (1, length)):
        is_zero = jnp.isclose(directions[axis], 0)
        skew_hit = jnp.where(jnp.abs(origins[axis]) <= dim / 2, -jnp.inf, jnp.inf)
        hit_1 = -(origins[axis] - dim / 2) / (directions[axis] + is_zero)
        hit_2 = -(origins[axis] + dim / 2) / (directions[axis] + is_zero)
        pair = _sort2(
            jnp.where(is_zero, skew_hit, hit_1),
            jnp.where(is_zero, jnp.inf, hit_2),
        )
        lo_bounds.append(pair[0])
        hi_bounds.append(pair[1])

    max_of_min = jnp.maximum(lo_bounds[0], lo_bounds[1])
    min_of_max = jnp.minimum(hi_bounds[0], hi_bounds[1])

    skew_ray = jnp.isclose(directions[2], 0)
    plane_hits = -origins[2] / (directions[2] + skew_ray)
    plane_hits = jnp.where(skew_ray, jnp.inf, plane_hits)
    in_bounds = (plane_hits >= max_of_min) & (plane_hits <= min_of_max)
    plane_hits = jnp.where(in_bounds, plane_hits, jnp.inf)
    # duplicated so CSG sees an even hit count (zero-volume solid)
    return jnp.stack((plane_hits, plane_hits))


def plane_normal(points, width, length):
    del width, length
    points = jnp.asarray(points)
    zeros = jnp.zeros_like(points[0])
    return jnp.stack((zeros, zeros, zeros + 1.0, zeros))


# ---------------------------------------------------------------------------
# Cube / axis-aligned box  (reference: tinygfx/g3d/primitives.py:516-602)
# ---------------------------------------------------------------------------


def cube_intersect(rays, axis_spans):
    """``axis_spans`` is a ``(3, 2)`` array of per-axis (min, max)."""
    origins, directions = _origins_directions(rays)
    axis_spans = jnp.asarray(axis_spans)

    mins = []
    maxes = []
    for axis in range(3):
        is_zero = jnp.isclose(directions[axis], 0)
        inside = (origins[axis] >= axis_spans[axis, 0]) & (
            origins[axis] <= axis_spans[axis, 1]
        )
        skew_min = jnp.where(inside, -jnp.inf, jnp.inf)
        hit_lo = -(origins[axis] - axis_spans[axis, 0]) / (directions[axis] + is_zero)
        hit_hi = -(origins[axis] - axis_spans[axis, 1]) / (directions[axis] + is_zero)
        pair = _sort2(
            jnp.where(is_zero, skew_min, hit_lo),
            jnp.where(is_zero, jnp.inf, hit_hi),
        )
        mins.append(pair[0])
        maxes.append(pair[1])

    entry = jnp.maximum(jnp.maximum(mins[0], mins[1]), mins[2])
    exit_ = jnp.minimum(jnp.minimum(maxes[0], maxes[1]), maxes[2])
    hits = jnp.stack((entry, exit_))
    # NOTE: strict <, matching the reference — a corner graze is a miss
    return jnp.where(hits[0] < hits[1], hits, jnp.inf)


def cube_normal(points, axis_spans):
    points = jnp.asarray(points)
    axis_spans = jnp.asarray(axis_spans)
    padded = jnp.concatenate((axis_spans, jnp.zeros((1, 2), axis_spans.dtype)))
    # broadcast the per-axis face coordinates over any trailing ray shape
    # (points may be (4, n) or (4, R, 128) in the fused kernel)
    trailing = (1,) * (points.ndim - 1)
    negative = jnp.isclose(points, padded[:, 0].reshape((4,) + trailing))
    positive = jnp.isclose(points, padded[:, 1].reshape((4,) + trailing))
    normals = jnp.where(negative, -1.0, 0.0)
    normals = jnp.where(positive, 1.0, normals)
    normals = _zero_w(normals)
    norm = _norm_rows(normals)
    return normals / jnp.where(norm == 0, 1.0, norm)


# ---------------------------------------------------------------------------
# Cylinder  (reference: tinygfx/g3d/primitives.py:650-741)
# ---------------------------------------------------------------------------


def cylinder_intersect(rays, radius, h_min, h_max):
    origins, directions = _origins_directions(rays)
    origins_2d, directions_2d = origins[:-1], directions[:-1]

    a = element_wise_dot(directions_2d, directions_2d, axis=0)
    b = 2 * element_wise_dot(directions_2d, origins_2d, axis=0)
    c = element_wise_dot(origins_2d, origins_2d, axis=0) - radius**2

    roots = binomial_root(a, b, c)
    sidewall = _sort2(roots[0], roots[1])

    parallel = jnp.isclose(directions[2], 0)
    inside = (origins[2] >= h_min) & (origins[2] <= h_max)
    denominator = directions[2] + parallel
    lo = (h_min - origins[2]) / denominator
    hi = (h_max - origins[2]) / denominator
    slab = _sort2(lo, hi)
    slab_lo = jnp.where(parallel, jnp.where(inside, -jnp.inf, jnp.inf), slab[0])
    slab_hi = jnp.where(parallel, jnp.inf, slab[1])

    return _slab_clip(sidewall, slab_lo, slab_hi)


def cylinder_normal(points, radius, h_min, h_max, capped=True):
    del radius
    points = jnp.asarray(points)
    zeros = jnp.zeros_like(points[0])
    normals = jnp.stack((points[0], points[1], zeros, zeros))
    if capped is not False:
        # ``capped`` may be a traced 0/1 float from the packed param vector
        capped_f = jnp.asarray(capped, dtype=points.dtype)
        z = points[2]
        lo_cap = jnp.isclose(z, h_min) & (capped_f != 0)
        hi_cap = jnp.isclose(z, h_max) & (capped_f != 0)
        down = jnp.stack((zeros, zeros, zeros - 1.0, zeros))
        up = jnp.stack((zeros, zeros, zeros + 1.0, zeros))
        normals = jnp.where(lo_cap, down, normals)
        normals = jnp.where(hi_cap, up, normals)
    norm = _norm_rows(normals)
    return normals / jnp.where(norm == 0, 1.0, norm)


# ---------------------------------------------------------------------------
# Packed-parameter dispatch used by the flattened scene representation
# ---------------------------------------------------------------------------


def leaf_intersect(type_code: int, rays, params):
    """Intersect using a static type code and a packed ``(PARAM_WIDTH,)`` vector."""
    if type_code == SPHERE:
        return sphere_intersect(rays, params[0])
    if type_code == PARABOLOID:
        return paraboloid_intersect(rays, params[0], params[1])
    if type_code == PLANE:
        return plane_intersect(rays, params[0], params[1])
    if type_code == CUBE:
        return cube_intersect(rays, params[:6].reshape(3, 2))
    if type_code == CYLINDER:
        return cylinder_intersect(rays, params[0], params[1], params[2])
    raise ValueError(f"unknown primitive type code {type_code}")


def leaf_normal_raw3(type_code, pts3, pr, s):
    """Unnormalized object-space normal as xyz rows.

    ``pts3`` is a sequence of three (broadcast-compatible) coordinate
    arrays; ``pr`` is anything supporting ``pr[s, i]`` scalar-or-array
    reads — a scalar table in the fused GPU kernel
    (ops/fused_trace.py), or a per-ray column view in the engine's
    gather-based wide-scene path (tracer/engine.py).

    Callers renormalize after the world (inverse-transpose) transform, and
    ``normalize(A @ normalize(n)) == normalize(A @ n)``, so the
    per-primitive normalization of the ``*_normal`` functions above is
    redundant work here.  Directions match ``leaf_normal``.
    """
    x, y, z = pts3
    zeros = jnp.zeros_like(x)
    ones = zeros + 1.0
    if type_code == SPHERE:
        return [x, y, z]
    if type_code == PARABOLOID:
        focus, height = pr[s, 0], pr[s, 1]
        cap = jnp.isclose(z, height)
        return [
            jnp.where(cap, 0.0, x),
            jnp.where(cap, 0.0, y),
            jnp.where(cap, 1.0, zeros - 2 * focus),
        ]
    if type_code == PLANE:
        return [zeros, zeros, ones]
    if type_code == CUBE:
        out = []
        for a, c in enumerate((x, y, z)):
            neg = jnp.isclose(c, pr[s, 2 * a])
            pos = jnp.isclose(c, pr[s, 2 * a + 1])
            out.append(jnp.where(pos, 1.0, jnp.where(neg, -1.0, 0.0)))
        return out
    if type_code == CYLINDER:
        capped = pr[s, 3] != 0
        lo_cap = jnp.isclose(z, pr[s, 1]) & capped
        hi_cap = jnp.isclose(z, pr[s, 2]) & capped
        cap = lo_cap | hi_cap
        return [
            jnp.where(cap, 0.0, x),
            jnp.where(cap, 0.0, y),
            jnp.where(hi_cap, 1.0, jnp.where(lo_cap, -1.0, 0.0)),
        ]
    raise ValueError(f"unknown primitive type code {type_code}")


def leaf_normal(type_code: int, points, params):
    """Object-space normal using a static type code and packed params."""
    if type_code == SPHERE:
        return sphere_normal(points, params[0])
    if type_code == PARABOLOID:
        return paraboloid_normal(points, params[0], params[1])
    if type_code == PLANE:
        return plane_normal(points, params[0], params[1])
    if type_code == CUBE:
        return cube_normal(points, params[:6].reshape(3, 2))
    if type_code == CYLINDER:
        return cylinder_normal(points, params[0], params[1], params[2], params[3])
    raise ValueError(f"unknown primitive type code {type_code}")
