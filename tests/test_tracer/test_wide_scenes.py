"""Wide-scene (batched same-shape tree) engine path.

Lens/microlens arrays compile one batched (trees x rays) sweep per tree
signature instead of unrolling per leaf.  The batched path must produce
frames identical to the unrolled engine, stay differentiable end-to-end,
and keep the fused GPU kernel out of scenes it does not cover.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

import pyrayt_tpu as pyrayt
from pyrayt_tpu import components as comp
from pyrayt_tpu import materials as matl
from pyrayt_tpu.config import TraceConfig
from pyrayt_tpu.scene.compile import compile_scene
from pyrayt_tpu.tracer import engine
from pyrayt_tpu.tracer.frame import records_to_dataframe


def _mla_scene(n=3, pitch=1.0, r=2.0):
    lenslets = comp.microlens_array(r, 0.25, n, n, pitch)
    focus = pyrayt.lensmakers_equation(r, np.inf, 1.5, 0.25)
    detector = comp.baffle((n * pitch * 2, n * pitch * 2)).move_x(focus)
    return lenslets + [detector], detector


def _grid_rays(n_rays, span):
    src = comp.GridOfRays(span, span).move_x(-1.0)
    rays = src.generate_rays(n_rays)
    return rays.replace(id=jnp.arange(n_rays, dtype=rays.positions.dtype))


def test_plan_groups_identical_lenslets():
    comps, _ = _mla_scene(3)
    scene = compile_scene(comps)
    order, groups = engine._wide_plan(scene.spec)
    assert len(groups) == 1
    template, types_pos, slot_matrix = groups[0]
    assert len(slot_matrix) == 9  # 3x3 lenslets
    assert len(types_pos) == len(slot_matrix[0])
    # the detector stays a single; the group folds at its first member
    kinds = [k for k, _ in order]
    assert kinds.count("group") == 1 and kinds.count("single") == 1


def test_wide_trace_matches_unrolled(monkeypatch):
    comps, _ = _mla_scene(3)
    scene = compile_scene(comps)
    config = TraceConfig(generation_limit=4, fixed_loop=True)
    rays = _grid_rays(400, 3.2)

    order, groups = engine._wide_plan(scene.spec)
    assert groups, "scene must take the wide path"
    wide_fn = engine._build_trace_fn(scene.spec, scene.materials, config)
    wide = wide_fn(scene.params, rays)

    # force the unrolled path by raising the grouping threshold
    monkeypatch.setattr(engine, "_WIDE_GROUP_MIN", 10**9)
    engine._wide_plan.cache_clear()
    try:
        assert not engine._wide_plan(scene.spec)[1]
        unrolled_fn = engine._build_trace_fn(scene.spec, scene.materials, config)
        unrolled = unrolled_fn(scene.params, rays)
    finally:
        monkeypatch.undo()
        engine._wide_plan.cache_clear()

    np.testing.assert_array_equal(
        np.asarray(wide.record_mask), np.asarray(unrolled.record_mask)
    )
    w = records_to_dataframe(wide.records, wide.record_mask)
    u = records_to_dataframe(unrolled.records, unrolled.record_mask)
    assert len(w) > 0
    pd.testing.assert_frame_equal(w, u, rtol=1e-12, atol=1e-12)


def test_wide_trace_focuses_per_lenslet():
    """Physics sanity: a collimated beam through the array lands near each
    lenslet's center at the focal plane."""
    comps, detector = _mla_scene(3, pitch=1.0)
    tracer = pyrayt.RayTracer(
        comp.GridOfRays(2.4, 2.4).move_x(-1.0),
        comps,
        rays_per_source=400,
        generation_limit=4,
    )
    frame = tracer.trace()
    hits = frame[frame.surface == detector.get_id()]
    assert len(hits) > 100
    # distance to nearest lenslet center on the 1.0-pitch grid
    dy = np.abs(hits["y1"] - np.round(hits["y1"]))
    dz = np.abs(hits["z1"] - np.round(hits["z1"]))
    # focused: the median hit is well inside its 0.5 half-pitch cell
    assert np.median(np.hypot(dy, dz)) < 0.15


def test_wide_gradient_matches_finite_differences():
    from pyrayt_tpu.analysis import build_objective
    from pyrayt_tpu.analysis.metrics import rms_spot_radius
    from pyrayt_tpu.scene.objects import fresh_ids

    rays = _grid_rays(144, 3.0)
    config = TraceConfig(generation_limit=4, fixed_loop=True)

    def build(r):
        lenslets = comp.microlens_array(r, 0.25, 3, 3, 1.0)
        detector = comp.baffle((6.0, 6.0)).move_x(4.0)
        return lenslets + [detector]

    with fresh_ids():
        det_id = float(build(jnp.asarray(2.0))[-1].get_id())

    objective = build_objective(
        build, rays, lambda res: rms_spot_radius(res, det_id), config
    )
    r0 = jnp.asarray(2.0)
    value, grad = jax.value_and_grad(objective)(r0)
    assert np.isfinite(float(value)) and np.isfinite(float(grad))
    eps = 1e-5
    fd = (float(objective(r0 + eps)) - float(objective(r0 - eps))) / (2 * eps)
    assert abs(float(grad) - fd) < 1e-4 * max(1.0, abs(fd))


def test_wide_scenes_run_the_xla_engine(monkeypatch):
    from pyrayt_tpu.ops import fused_trace as ft

    comps, _ = _mla_scene(5)  # 25 lenslets x 2 leaves + detector = 51 leaves
    scene = compile_scene(comps)
    assert scene.spec.n_leaves > ft._MAX_LEAVES
    # past the kernel's leaf cap the batched XLA groups run, on every
    # platform; forcing the kernel raises
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert not ft.supports_fused(scene.spec)
    assert not ft.pick_fused(scene.spec, TraceConfig())
    with pytest.raises(ValueError, match="use_fused=True"):
        ft.pick_fused(scene.spec, TraceConfig(use_fused=True))


def test_per_lenslet_radii_gradients_match_finite_differences():
    """Freeform arrays: each lenslet's own radius gets its own cotangent."""
    from pyrayt_tpu.analysis import build_objective
    from pyrayt_tpu.analysis.metrics import rms_spot_radius
    from pyrayt_tpu.scene.objects import fresh_ids

    rays = _grid_rays(144, 3.0)
    config = TraceConfig(generation_limit=4, fixed_loop=True)

    def build(radii):
        lenslets = comp.microlens_array(radii, 0.25, 3, 3, 1.0)
        return lenslets + [comp.baffle((6.0, 6.0)).move_x(4.0)]

    r0 = jnp.linspace(1.8, 2.2, 9)
    with fresh_ids():
        det_id = float(build(r0)[-1].get_id())
    objective = build_objective(
        build, rays, lambda res: rms_spot_radius(res, det_id), config
    )
    grad = np.asarray(jax.grad(objective)(r0))
    assert grad.shape == (9,) and np.isfinite(grad).all()
    assert np.count_nonzero(grad) == 9  # every lenslet moves the spot
    eps = 1e-5
    for k in (0, 4, 8):
        step = jnp.zeros(9).at[k].set(eps)
        fd = (float(objective(r0 + step)) - float(objective(r0 - step))) / (2 * eps)
        assert abs(grad[k] - fd) < 1e-4 * max(1.0, abs(fd)), (k, grad[k], fd)
