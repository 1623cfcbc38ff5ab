"""Multi-device sharding tests (tier 2 of SURVEY.md §4): run on the 8
virtual CPU devices from conftest and assert shard-vs-replicated equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pyrayt_tpu as prt
from pyrayt_tpu import components as comp
from pyrayt_tpu import materials as matl
from pyrayt_tpu.config import TraceConfig
from pyrayt_tpu.parallel import (
    build_train_step,
    default_mesh,
    pad_rayset,
    shard_rayset,
    sharded_trace,
)
from pyrayt_tpu.scene.compile import compile_scene
from pyrayt_tpu.tracer import engine


@pytest.fixture()
def system():
    lens = comp.thick_lens(
        r1=1.0, r2=-1.0, thickness=0.25, aperture=0.5, material=matl.glass["BK7"]
    )
    detector = comp.baffle((1.0, 1.0)).move_x(1.0)
    source = comp.ConeOfRays(cone_angle=10.0).move_x(-0.5)
    return compile_scene([lens, detector]), source


def test_eight_virtual_devices():
    assert len(jax.devices()) >= 8


def test_mesh_shapes():
    mesh = default_mesh(n_devices=8, n_hosts=2)
    assert mesh.shape == {"hosts": 2, "rays": 4}
    mesh = default_mesh(n_devices=8)
    assert mesh.size == 8


def test_pad_rayset_rays_are_born_dead(system):
    scene, source = system
    rays = source.generate_rays(10)
    padded, n_valid = pad_rayset(rays, 8)
    assert n_valid == 10
    assert padded.n_rays == 16
    # homogeneous w stays 1 on padded positions, directions are zero (dead)
    assert np.allclose(np.asarray(padded.positions[3]), 1.0)
    assert np.allclose(np.asarray(padded.directions[:, 10:]), 0.0)

    config = TraceConfig(generation_limit=4, fixed_loop=True)
    result = engine.trace_rays(scene, padded, config)
    # no padded ray ever produces a record row
    assert not np.any(np.asarray(result.record_mask)[:, 10:])


def test_sharded_trace_matches_single_device(system):
    scene, source = system
    rays = source.generate_rays(64)
    config = TraceConfig(generation_limit=4, fixed_loop=True)

    expected = engine.trace_rays(scene, rays, config)

    mesh = default_mesh(n_devices=8, n_hosts=2)
    sharded = sharded_trace(scene, rays, config, mesh)

    np.testing.assert_allclose(
        np.asarray(sharded.records), np.asarray(expected.records), rtol=1e-12
    )
    np.testing.assert_array_equal(
        np.asarray(sharded.record_mask), np.asarray(expected.record_mask)
    )


def test_sharded_trace_pads_uneven_ray_counts(system):
    scene, source = system
    rays = source.generate_rays(13)  # not divisible by 8
    config = TraceConfig(generation_limit=3, fixed_loop=True)
    mesh = default_mesh(n_devices=8)
    result = sharded_trace(scene, rays, config, mesh)
    assert result.records.shape[-1] == 16
    assert not np.any(np.asarray(result.record_mask)[:, 13:])


def test_train_step_decreases_loss(system):
    """One distributed SGD step on lens position reduces the spot loss and
    matches the unsharded gradient."""
    scene, source = system
    mesh = default_mesh(n_devices=8, n_hosts=2)
    config = TraceConfig(generation_limit=4, fixed_loop=True)

    def rms_spot(result):
        y = result.final_rays.positions[1]
        z = result.final_rays.positions[2]
        w = jnp.any(result.record_mask, axis=0).astype(y.dtype)
        return jnp.sum(w * (y**2 + z**2)) / jnp.maximum(jnp.sum(w), 1.0)

    step = build_train_step(scene, config, mesh, rms_spot, learning_rate=1e-2)

    rays, _ = pad_rayset(source.generate_rays(64), mesh.size)
    rays = shard_rayset(rays, mesh)

    params1, loss1 = step(scene.params, rays)
    params2, loss2 = step(params1, rays)
    assert jnp.isfinite(loss1) and jnp.isfinite(loss2)
    assert float(loss2) <= float(loss1)

    # gradient parity vs the unsharded program
    cfg = TraceConfig(generation_limit=4, fixed_loop=True)
    trace = engine.build_trace_fn(scene.spec, scene.materials, cfg)
    unsharded_rays = source.generate_rays(64)

    def loss_of(params):
        return rms_spot(trace(params, unsharded_rays))

    g_expected = jax.grad(loss_of)(scene.params)
    g_sharded = jax.tree_util.tree_map(
        lambda a, b: (a - b) / 1e-2, scene.params, params1
    )
    for key in g_expected:
        np.testing.assert_allclose(
            np.asarray(g_sharded[key]),
            np.asarray(g_expected[key]),
            rtol=1e-6,
            atol=1e-9,
        )


class TestShardMappedFusedTrace:
    """The fused kernel on a device mesh: shard_map runs one kernel per
    shard (interpreted on these virtual CPU devices) and must match the
    unsharded XLA engine exactly."""

    def test_fused_shard_map_matches_engine(self):
        from pyrayt_tpu.ops import fused_trace
        from pyrayt_tpu.parallel import trace as ptrace

        lens = comp.thick_lens(
            1.0, -1.0, 0.25, aperture=0.5, material=matl.glass["BK7"]
        )
        det = comp.baffle((1.0, 1.0)).move_x(1.0)
        scene = compile_scene([lens, det])
        config = TraceConfig(generation_limit=4, fixed_loop=True)
        rays = comp.ConeOfRays(cone_angle=10.0).move_x(-0.5).generate_rays(64)

        mesh = default_mesh(n_devices=8, n_hosts=2)
        kernel = fused_trace.build_fused_trace_fn(
            scene.spec, scene.materials, config, interpret=True
        )
        fn = ptrace._shard_mapped(kernel, scene, mesh)
        padded, n_valid = pad_rayset(rays, mesh.size)
        placed = shard_rayset(padded, mesh)
        sharded = fn(scene.params, placed)
        jax.block_until_ready(sharded)

        reference = engine.build_trace_fn(scene.spec, scene.materials, config)(
            scene.params, rays
        )
        mask_s = np.asarray(sharded.record_mask)[:, :n_valid]
        mask_r = np.asarray(reference.record_mask)
        assert np.array_equal(mask_s, mask_r)
        recs_s = np.asarray(sharded.records)[:, :, :n_valid] * mask_s[:, None, :]
        recs_r = np.asarray(reference.records) * mask_r[:, None, :]
        np.testing.assert_allclose(recs_s, recs_r, rtol=1e-12, atol=1e-12)
        assert int(sharded.generations_run) == int(reference.generations_run)
