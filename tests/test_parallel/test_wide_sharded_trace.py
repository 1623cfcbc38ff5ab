"""Full surface-sharded trace equality (the SURVEY §2.3 TP row).

A 4x4 microlens array's tree axis shards over 8 virtual devices; the full
trace (normals, materials, records, generation loop) must equal the
replicated engine bit-for-bit (the fold is exact min-comparisons — no FP
accumulation differs between the chunked and monolithic reduces).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import pyrayt_tpu as pyrayt
from pyrayt_tpu import components as comp
from pyrayt_tpu.config import TraceConfig
from pyrayt_tpu.parallel import build_wide_sharded_trace_fn
from pyrayt_tpu.scene.compile import compile_scene
from pyrayt_tpu.tracer import engine


def _scene(n=4):
    lenslets = comp.microlens_array(2.0, 0.25, n, n, 1.0)
    focus = pyrayt.lensmakers_equation(2.0, np.inf, 1.5, 0.25)
    detector = comp.baffle((2.0 * n, 2.0 * n)).move_x(focus)
    return compile_scene(lenslets + [detector])


def _rays(n_rays=512, span=4.2):
    src = comp.GridOfRays(span, span).move_x(-1.0)
    rays = src.generate_rays(n_rays)
    return rays.replace(id=jnp.arange(n_rays, dtype=rays.positions.dtype))


def _mesh(n=8):
    devices = np.asarray(jax.devices()[:n])
    return Mesh(devices, ("surfaces",))


def test_sharded_trace_equals_replicated():
    scene = _scene(4)  # 16 lenslet trees / 8 devices = 2 per device
    config = TraceConfig(generation_limit=4, fixed_loop=True)
    rays = _rays()

    replicated = engine.build_trace_fn(scene.spec, scene.materials, config)(
        scene.params, rays
    )
    sharded_fn = build_wide_sharded_trace_fn(scene, config, _mesh())
    sharded = sharded_fn(scene.params, rays)

    np.testing.assert_array_equal(
        np.asarray(sharded.record_mask), np.asarray(replicated.record_mask)
    )
    np.testing.assert_array_equal(
        np.asarray(sharded.records), np.asarray(replicated.records)
    )
    np.testing.assert_array_equal(
        np.asarray(sharded.final_rays.positions),
        np.asarray(replicated.final_rays.positions),
    )
    assert int(sharded.generations_run) == int(replicated.generations_run)
    assert int(jnp.sum(replicated.record_mask)) > 100  # real work happened


def test_sharded_trace_differentiable():
    """The sharded trace composes with jax.grad (pmin has a subgradient;
    the tree-chunk fold transposes cleanly)."""
    scene = _scene(4)
    config = TraceConfig(generation_limit=3, fixed_loop=True)
    rays = _rays(128, 3.0)
    fn = build_wide_sharded_trace_fn(scene, config, _mesh())

    def loss(params):
        result = fn(params, rays)
        m = result.record_mask
        y = result.records[:, 10, :]
        return jnp.sum(jnp.where(m, y, 0.0) ** 2)

    grads = jax.grad(loss)(scene.params)
    flat = jax.tree_util.tree_leaves(grads)
    assert all(np.all(np.isfinite(np.asarray(g))) for g in flat)
    assert any(np.any(np.asarray(g) != 0) for g in flat)


def test_sharded_trace_rejects_indivisible_groups():
    scene = _scene(3)  # 9 trees, not divisible by 8
    with pytest.raises(ValueError, match="not divisible"):
        build_wide_sharded_trace_fn(
            scene, TraceConfig(generation_limit=3, fixed_loop=True), _mesh()
        )


def test_sharded_trace_rejects_narrow_scenes():
    lens = comp.biconvex_lens(2.0, 2.0, 0.25, aperture=1.0)
    detector = comp.baffle((1.0, 1.0)).move_x(1.0)
    scene = compile_scene([lens, detector])
    with pytest.raises(ValueError, match="batchable"):
        build_wide_sharded_trace_fn(
            scene, TraceConfig(generation_limit=3, fixed_loop=True), _mesh()
        )
