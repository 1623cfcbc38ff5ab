"""Fused forward trace kernel for NVIDIA GPUs (Pallas, Triton route).

The XLA engine (pyrayt_tpu/tracer/engine.py) runs the generation loop as a
``lax.while_loop`` whose body is many fused kernels: every generation
writes the ray state to device memory and reads it back, and the loop
predicate returns to the host each iteration.  This module compiles the
whole trace -- every PROPAGATE + INTERACT + RECORD generation -- into one
kernel launch blocked over the ray axis:

* each program loads one block of rays (one ray per lane of a 1-D
  power-of-two block) and keeps its state in registers across every
  generation;
* scene tables (object transforms, primitive parameters, glass rows) are
  small global arrays read as scalars; they stay in L1/L2;
* an in-kernel ``lax.while_loop`` exits as soon as every ray of the block
  is dead, and the generations it skipped are zero-filled afterwards;
* the only device-memory writes are the mandatory outputs: the
  ``(G, 15, n)`` records, the ``(G, n)`` living masks and the final state,
  each stored one ``(BLOCK,)`` row at a time.

Triton tensors must have power-of-two sizes, so nothing here stacks rows
into ``(3, BLOCK)`` or ``(13, BLOCK)`` arrays: positions, directions and
normals travel as Python lists of ``(BLOCK,)`` rows, and the primitive
intersectors below are row-form twins of :mod:`pyrayt_tpu.core.primitives`.

Scope: forward only, f32 on the GPU, scenes whose materials are all packed
(absorber / mirror / glass) and whose CSG trees take the closed-form
interval path (core/intervals.py).  Everything else -- gradients, union
trees, custom materials, wide scenes -- runs the XLA engine.  Parity with
``engine._generation_step`` is tested in interpret mode on the CPU
(tests/test_ops/test_fused_trace.py).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from pyrayt_tpu import materials as matl
from pyrayt_tpu.config import TraceConfig
from pyrayt_tpu.core import primitives as prim
from pyrayt_tpu.core.intervals import (
    eval_tree_intervals,
    tree_supports_intervals,
)
from pyrayt_tpu.core.operations import affine_inverse
from pyrayt_tpu.scene.compile import SceneSpec
from pyrayt_tpu.tracer.engine import N_RECORD_COLS, TraceResult

__all__ = [
    "supports_fused",
    "pick_fused",
    "build_fused_trace_fn",
    "BLOCK",
    "NUM_WARPS",
]

_PACKED_KINDS = (matl.KIND_ABSORB, matl.KIND_MIRROR, matl.KIND_GLASS)

#: rays per program (one per lane) and warps per program
BLOCK = 256
NUM_WARPS = 8

# the kernel unrolls the scene per leaf; wide scenes (lenslet arrays) run
# the XLA engine's batched groups instead (engine._wide_plan)
_MAX_LEAVES = 32

_INF = float("inf")


def supports_fused(spec: SceneSpec) -> bool:
    """True when the kernel covers the scene: at most ``_MAX_LEAVES``
    leaves, every material packed, every CSG tree on the interval path."""
    return (
        0 < spec.n_leaves <= _MAX_LEAVES
        and all(spec.mat_packed)
        and all(k in _PACKED_KINDS for k in spec.mat_kinds)
        and all(tree_supports_intervals(t) for t in spec.trees)
    )


def pick_fused(spec: SceneSpec, config: TraceConfig, itemsize: int = 4) -> bool:
    """THE kernel-vs-XLA dispatch rule for forward traces.

    The kernel runs when the default backend is the GPU (checked at call
    time, never cached), the rays are f32 and the scene is supported;
    ``config.use_fused`` False forces the XLA engine, True demands the
    kernel and raises where it cannot run.
    """
    use = config.use_fused
    if use is False:
        return False
    on_platform = jax.default_backend() == "gpu"
    feasible = supports_fused(spec) and itemsize == 4
    if use is True and not (feasible and on_platform):
        raise ValueError(
            "use_fused=True, but the fused kernel needs an f32 trace on the "
            f"GPU (backend: {jax.default_backend()}) and a scene of packed "
            "materials and interval CSG trees"
        )
    return feasible and on_platform


# ---------------------------------------------------------------------------
# row-form math: every value is a (BLOCK,) row or a scalar
# ---------------------------------------------------------------------------


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _safe_sqrt(x):
    positive = x > 0
    return jnp.where(positive, jnp.sqrt(jnp.where(positive, x, 1.0)), 0.0)


def _normalize(v):
    sq = _dot(v, v)
    zero = sq == 0
    norm = jnp.sqrt(jnp.where(zero, 1.0, sq))
    return [jnp.where(zero, c, c / norm) for c in v]


def _sorted(a, b):
    return jnp.minimum(a, b), jnp.maximum(a, b)


def _slab(o, d, lo_h, hi_h):
    """The z-slab clip interval of paraboloid and cylinder."""
    parallel = jnp.isclose(d, 0)
    inside = (o >= lo_h) & (o <= hi_h)
    den = d + parallel
    s0, s1 = _sorted((lo_h - o) / den, (hi_h - o) / den)
    slab_lo = jnp.where(parallel, jnp.where(inside, -_INF, _INF), s0)
    slab_hi = jnp.where(parallel, _INF, s1)
    return slab_lo, slab_hi


def _clip(p0, p1, lo, hi):
    entry = jnp.maximum(p0, lo)
    exit_ = jnp.minimum(p1, hi)
    ok = entry <= exit_
    return jnp.where(ok, entry, _INF), jnp.where(ok, exit_, _INF)


def _sphere(o, d, radius):
    a = _dot(d, d)
    b = 2 * _dot(d, o)
    c = _dot(o, o) - radius**2
    disc = b**2 - 4 * a * c
    root = _safe_sqrt(disc)
    degenerate = jnp.isclose(a, 0)
    den = 2 * a + degenerate
    ok = (disc >= 0) & ~degenerate
    h0 = jnp.where(ok, (-b + root) / den, _INF)
    h1 = jnp.where(ok, (-b - root) / den, _INF)
    return _sorted(h0, h1)


def _paraboloid(o, d, focus, height):
    a = d[0] * d[0] + d[1] * d[1]
    b = 2 * (o[0] * d[0] + o[1] * d[1]) - 4 * focus * d[2]
    c = o[0] * o[0] + o[1] * o[1] - 4 * focus * o[2]
    disc = b**2 - 4 * a * c
    linear = jnp.isclose(a, 0)
    root = _safe_sqrt(disc)
    den = 2 * a + linear
    h0 = jnp.where(disc >= 0, (-b + root) / den, _INF)
    h1 = jnp.where(disc >= 0, (-b - root) / den, _INF)
    h0 = jnp.where(linear, -c / (b + jnp.isclose(b, 0)), h0)
    h1 = jnp.where(linear, jnp.where(d[2] >= 0, _INF, -_INF), h1)
    p0, p1 = _sorted(h0, h1)
    return _clip(p0, p1, *_slab(o[2], d[2], 0.0, height))


def _plane(o, d, width, length):
    lo_b, hi_b = [], []
    for axis, dim in ((0, width), (1, length)):
        is_zero = jnp.isclose(d[axis], 0)
        skew = jnp.where(jnp.abs(o[axis]) <= dim / 2, -_INF, _INF)
        h1 = -(o[axis] - dim / 2) / (d[axis] + is_zero)
        h2 = -(o[axis] + dim / 2) / (d[axis] + is_zero)
        lo, hi = _sorted(jnp.where(is_zero, skew, h1), jnp.where(is_zero, _INF, h2))
        lo_b.append(lo)
        hi_b.append(hi)
    skew_ray = jnp.isclose(d[2], 0)
    hit = jnp.where(skew_ray, _INF, -o[2] / (d[2] + skew_ray))
    inb = (hit >= jnp.maximum(lo_b[0], lo_b[1])) & (hit <= jnp.minimum(hi_b[0], hi_b[1]))
    hit = jnp.where(inb, hit, _INF)
    return hit, hit


def _cube(o, d, spans):
    mins, maxes = [], []
    for axis in range(3):
        s_lo, s_hi = spans[axis]
        is_zero = jnp.isclose(d[axis], 0)
        inside = (o[axis] >= s_lo) & (o[axis] <= s_hi)
        skew = jnp.where(inside, -_INF, _INF)
        h_lo = -(o[axis] - s_lo) / (d[axis] + is_zero)
        h_hi = -(o[axis] - s_hi) / (d[axis] + is_zero)
        lo, hi = _sorted(jnp.where(is_zero, skew, h_lo), jnp.where(is_zero, _INF, h_hi))
        mins.append(lo)
        maxes.append(hi)
    entry = jnp.maximum(jnp.maximum(mins[0], mins[1]), mins[2])
    exit_ = jnp.minimum(jnp.minimum(maxes[0], maxes[1]), maxes[2])
    ok = entry < exit_  # strict, as the reference: a corner graze misses
    return jnp.where(ok, entry, _INF), jnp.where(ok, exit_, _INF)


def _binomial_roots(a, b, c):
    """Row form of operations.binomial_root (same edge conventions)."""
    disc = b**2 - 4 * a * c
    linear = jnp.isclose(a, 0)
    root = _safe_sqrt(disc)
    den = 2 * a + linear
    p0 = jnp.where(disc >= 0, (-b + root) / den, _INF)
    p1 = jnp.where(disc >= 0, (-b - root) / den, _INF)
    b_zero = jnp.isclose(b, 0)
    live_linear = linear & ~b_zero
    linear_root = -c / jnp.where(live_linear, b, 1.0)
    p0 = jnp.where(linear, linear_root, p0)
    p1 = jnp.where(linear, linear_root, p1)
    c_only = linear & b_zero
    p0 = jnp.where(c_only, jnp.where(c <= 0, -_INF, _INF), p0)
    p1 = jnp.where(c_only, _INF, p1)
    return p0, p1


def _cylinder(o, d, radius, h_min, h_max):
    a = d[0] * d[0] + d[1] * d[1]
    b = 2 * (d[0] * o[0] + d[1] * o[1])
    c = o[0] * o[0] + o[1] * o[1] - radius**2
    p0, p1 = _sorted(*_binomial_roots(a, b, c))
    return _clip(p0, p1, *_slab(o[2], d[2], h_min, h_max))


def _leaf_interval(type_code, o, d, pr, s):
    """Sorted (entry, exit) of leaf ``s``; parameters read as scalars."""
    if type_code == prim.SPHERE:
        return _sphere(o, d, pr[s, 0])
    if type_code == prim.PARABOLOID:
        return _paraboloid(o, d, pr[s, 0], pr[s, 1])
    if type_code == prim.PLANE:
        return _plane(o, d, pr[s, 0], pr[s, 1])
    if type_code == prim.CUBE:
        spans = [(pr[s, 2 * a], pr[s, 2 * a + 1]) for a in range(3)]
        return _cube(o, d, spans)
    if type_code == prim.CYLINDER:
        return _cylinder(o, d, pr[s, 0], pr[s, 1], pr[s, 2])
    raise ValueError(f"unknown primitive type code {type_code}")


def _reflect(v, n):
    k = 2 * _dot(v, n)
    return [vi - k * ni for vi, ni in zip(v, n)]


def _refract(v, n, n1, n2, n_global):
    """Row form of operations.refract: Snell with enter/exit and TIR."""
    v = _normalize(v)
    cp = _dot(v, n)
    exiting = cp > 0
    n2_local = jnp.where(exiting, n_global, n2)
    n = [jnp.where(exiting, -c, c) for c in n]
    r = n1 / n2_local
    c1 = jnp.where(exiting, cp, -cp)
    radicand = 1 - r**2 * (1 - c1**2)
    c2 = _safe_sqrt(radicand)
    through = radicand > 0
    out = [
        jnp.where(through, r * vi + (r * c1 - c2) * ni, vi + 2 * c1 * ni)
        for vi, ni in zip(v, n)
    ]
    return _normalize(out), jnp.where(through, n2_local, n1)


def _glass_index(gr, slot, wavelength):
    """matl.index_from_coeffs on a table row read as scalars."""
    wl2 = wavelength * wavelength
    n2 = gr[slot, 0]
    for i in range(3):
        n2 = n2 + gr[slot, 1 + i] * wl2 / (wl2 - gr[slot, 4 + i])
    return jnp.sqrt(n2)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _affine(tx, s, x, w):
    """Rows of ``M[s] @ (x, w)`` for an affine (S, 16) transform table."""
    return [
        tx[s, 4 * i] * x[0] + tx[s, 4 * i + 1] * x[1] + tx[s, 4 * i + 2] * x[2]
        + (tx[s, 4 * i + 3] if w else 0.0)
        for i in range(3)
    ]


def _make_step(spec: SceneSpec, config: TraceConfig):
    """One generation on a block of rays (parity: engine._generation_step)."""
    needs_normal = tuple(
        spec.mat_kinds[slot] != matl.KIND_ABSORB for slot in spec.leaf_mat_slot
    )

    def step(tx, pr, gr, carry):
        p, v, gen, inten, wav, ridx, rid, alive = carry
        zeros = jnp.zeros_like(gen)

        # PROPAGATE: per-leaf intervals, interval CSG, nearest positive hit
        intervals = []
        for s, t in enumerate(spec.leaf_types):
            lo, hi = _leaf_interval(t, _affine(tx, s, p, 1), _affine(tx, s, v, 0), pr, s)
            ids = jnp.full(gen.shape, s, jnp.int32)
            intervals.append((lo, hi, ids, ids))
        best = jnp.full(gen.shape, _INF, gen.dtype)
        leaf = jnp.full(gen.shape, -1, jnp.int32)
        for tree in spec.trees:
            for lo, hi, lo_id, hi_id in eval_tree_intervals(tree, intervals):
                for cand, ids in ((lo, lo_id), (hi, hi_id)):
                    cand = jnp.where(cand > 0, cand, _INF)
                    closer = cand < best
                    best = jnp.where(closer, cand, best)
                    leaf = jnp.where(closer, ids, leaf)
        no_hit = leaf < 0
        t_hit = jnp.where(no_hit, 0.0, best)
        p_hit = [pi + t_hit * vi for pi, vi in zip(p, v)]

        # world normals of the hit leaf, masked-accumulated per leaf
        normal = [zeros, zeros, zeros]
        for s, t in enumerate(spec.leaf_types):
            if not needs_normal[s]:
                continue
            local = _affine(tx, s, p_hit, 1)
            ln = prim.leaf_normal_raw3(t, local, pr, s)
            # inverse-transpose: world_i = sum_j M[j][i] * ln_j
            wn = _normalize(
                [tx[s, i] * ln[0] + tx[s, 4 + i] * ln[1] + tx[s, 8 + i] * ln[2]
                 for i in range(3)]
            )
            scale = spec.leaf_normal_scale[s]
            normal = [jnp.where(leaf == s, c * scale, old) for c, old in zip(wn, normal)]

        # INTERACT: masked branch-free material physics per material slot
        new_dir = [jnp.where(no_hit, 0.0, c) for c in v]
        new_index, public_id = ridx, zeros
        for s, leaf_id in enumerate(spec.leaf_ids):
            public_id = jnp.where(leaf == s, float(leaf_id), public_id)
        for slot, kind in enumerate(spec.mat_kinds):
            hit_slot = [s for s, m in enumerate(spec.leaf_mat_slot) if m == slot]
            if not hit_slot:
                continue
            mask = leaf == hit_slot[0]
            for s in hit_slot[1:]:
                mask = mask | (leaf == s)
            if kind == matl.KIND_ABSORB:
                d2, i2 = [zeros, zeros, zeros], ridx
            elif kind == matl.KIND_MIRROR:
                d2, i2 = _reflect(v, normal), ridx
            else:
                n2 = _glass_index(gr, slot, wav)
                d2, i2 = _refract(v, normal, ridx, n2, config.world_index)
            new_dir = [jnp.where(mask, a, b) for a, b in zip(d2, new_dir)]
            new_index = jnp.where(mask, i2, new_index)

        # death rules (the intensity test is opt-in, as in the engine)
        dead = jnp.isclose(jnp.sqrt(_dot(v, v)), 0) | no_hit
        if config.apply_intensity_threshold:
            dead = dead | (inten < config.intensity_threshold)
        living = (alive > 0) & ~dead

        record = [gen, inten, wav, ridx, rid, public_id, *p, *p_hit, *_normalize(v)]
        new_p = [
            jnp.where(living, h + config.ray_offset * d, h)
            for h, d in zip(p_hit, new_dir)
        ]
        new_gen = jnp.where(living, gen + 1, gen)
        # a ray absorbed this generation (zero new direction) can never
        # record again: dropping it from the loop's alive set now lets the
        # block exit one generation earlier with identical outputs
        absorbed_now = _dot(new_dir, new_dir) == 0
        alive_next = (living & ~absorbed_now).astype(jnp.int32)
        new_carry = (new_p, new_dir, new_gen, inten, wav, new_index, rid, alive_next)
        return new_carry, record, living

    return step


def _make_kernel(spec: SceneSpec, config: TraceConfig):
    generations = config.generation_limit
    step = _make_step(spec, config)

    def kernel(state_ref, tx_ref, pr_ref, gr_ref, rec_ref, mask_ref, out_ref):
        row = [state_ref[i, :] for i in range(13)]
        carry0 = (
            row[0:3], row[4:7], row[8], row[9], row[10], row[11], row[12],
            jnp.ones(row[8].shape, jnp.int32),
        )

        def cond(c):
            g, carry = c
            return (g < generations) & (jnp.max(carry[-1]) > 0)

        def body(c):
            g, carry = c
            carry, record, living = step(tx_ref, pr_ref, gr_ref, carry)
            for k in range(N_RECORD_COLS):
                rec_ref[g, k, :] = record[k].astype(rec_ref.dtype)
            mask_ref[g, :] = living.astype(mask_ref.dtype)
            return g + 1, carry

        g_end, final = lax.while_loop(cond, body, (jnp.int32(0), carry0))

        # generations the early exit skipped record nothing
        zero = jnp.zeros(row[0].shape, rec_ref.dtype)
        zero_mask = jnp.zeros(row[0].shape, mask_ref.dtype)

        def clear(g, _):
            for k in range(N_RECORD_COLS):
                rec_ref[g, k, :] = zero
            mask_ref[g, :] = zero_mask
            return _

        lax.fori_loop(g_end, generations, clear, 0)

        p, v, gen, inten, wav, ridx, rid, _ = final
        rows = [*p, zero + 1, *v, zero, gen, inten, wav, ridx, rid]
        for i, r in enumerate(rows):
            out_ref[i, :] = r.astype(out_ref.dtype)

    return kernel


@lru_cache(maxsize=64)
def build_fused_trace_fn(
    spec: SceneSpec,
    materials,
    config: TraceConfig,
    interpret: bool = False,
    block: int = BLOCK,
    num_warps: int = NUM_WARPS,
):
    """Build the kernel trace: ``fn(params, rays) -> TraceResult``.

    Same contract as engine.build_trace_fn (records / record_mask /
    final_rays / generations_run), forward-only.  ``materials`` is accepted
    for signature parity; packed kinds compile from the glass table.
    ``interpret=True`` runs the Pallas interpreter, which is how the tests
    check the kernel on a CPU.  ``block`` (a power of two) and
    ``num_warps`` are the launch shape.
    """
    if not supports_fused(spec):
        raise ValueError(
            "scene has non-packed materials, union CSG trees or more than "
            f"{_MAX_LEAVES} leaves; use the XLA engine"
        )
    if block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")
    generations = config.generation_limit
    kernel = _make_kernel(spec, config)

    @jax.jit
    def trace(params, initial_rays):
        n = initial_rays.n_rays
        dtype = initial_rays.positions.dtype
        n_pad = -(-n // block) * block
        state = jnp.concatenate(
            (initial_rays.positions, initial_rays.directions, initial_rays.metadata)
        ).astype(dtype)
        if n_pad != n:
            # padding rays have zero direction: they die in generation 0
            state = jnp.pad(state, ((0, 0), (0, n_pad - n)))

        tx = affine_inverse(params["world"]).reshape(spec.n_leaves, 16).astype(dtype)
        pr = params["prim"].astype(dtype)
        gr = params["glass"].astype(dtype)
        if gr.shape[0] == 0:
            gr = jnp.zeros((1, matl.N_GLASS_COEFFS), dtype)

        def table(x):
            return pl.BlockSpec(x.shape, lambda i: (0, 0))

        records, masks, final = pl.pallas_call(
            kernel,
            grid=(n_pad // block,),
            in_specs=[
                pl.BlockSpec((13, block), lambda i: (0, i)),
                table(tx), table(pr), table(gr),
            ],
            out_specs=[
                pl.BlockSpec((generations, N_RECORD_COLS, block), lambda i: (0, 0, i)),
                pl.BlockSpec((generations, block), lambda i: (0, i)),
                pl.BlockSpec((13, block), lambda i: (0, i)),
            ],
            out_shape=[
                jax.ShapeDtypeStruct((generations, N_RECORD_COLS, n_pad), dtype),
                jax.ShapeDtypeStruct((generations, n_pad), jnp.int8),
                jax.ShapeDtypeStruct((13, n_pad), dtype),
            ],
            compiler_params=pl_triton.CompilerParams(num_warps=num_warps, num_stages=1),
            backend="triton",
            interpret=interpret,
            name="fused_trace",
        )(state, tx, pr, gr)

        if n_pad != n:
            records, masks, final = records[..., :n], masks[:, :n], final[:, :n]
        masks = masks != 0
        final_rays = initial_rays.replace(
            positions=final[0:4],
            directions=final[4:8],
            generation=final[8],
            intensity=final[9],
            wavelength=final[10],
            index=final[11],
            id=final[12],
        )
        return TraceResult(
            records=records,
            record_mask=masks,
            final_rays=final_rays,
            generations_run=jnp.sum(jnp.any(masks, axis=1)),
        )

    return trace
