"""RayTracer engine-knob passthrough.

The reference configures through two class attributes and setters
(/root/reference/pyrayt/_pyrayt.py:190-196, 273-327).  This package adds
engine knobs with no reference counterpart (use_fused / remat /
apply_intensity_threshold / world_index); these must be reachable from the
reference-parity RayTracer API, not only from internals.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import pyrayt_tpu as pyrayt
from pyrayt_tpu import components as comp
from pyrayt_tpu.config import TraceConfig
from pyrayt_tpu.scene.compile import compile_scene
from pyrayt_tpu.tracer.rayset import RaySet


class DimLine(comp.LineOfRays):
    """LineOfRays with a configurable (low) starting intensity."""

    def __init__(self, intensity, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._intensity = intensity

    def _local_ray_generation(self, n_rays: int) -> RaySet:
        rayset = super()._local_ray_generation(n_rays)
        return rayset.replace(
            intensity=jnp.full(n_rays, self._intensity, rayset.intensity.dtype)
        )


def _scene():
    detector = comp.baffle((1.0, 1.0)).move_x(1.0)
    return detector


def test_config_kwarg_passes_engine_knobs_through():
    tracer = pyrayt.RayTracer(
        comp.LineOfRays(),
        [_scene()],
        rays_per_source=4,
        generation_limit=3,
        config=TraceConfig(
            use_fused=False, remat=True, apply_intensity_threshold=True
        ),
    )
    cfg = tracer.get_config()
    assert cfg.use_fused is False
    assert cfg.remat is True
    assert cfg.apply_intensity_threshold is True
    # the tracer's own state wins for its reference-parity fields
    assert cfg.generation_limit == 3
    assert cfg.intensity_threshold == pyrayt.RayTracer.ray_intensity_threshold
    assert cfg.ray_offset == pyrayt.RayTracer.ray_offset_value


def test_intensity_threshold_toggle_kills_dim_rays():
    # quirk Q1: the reference's threshold test is inert; the toggle
    # implements the intended behavior (rays dimmer than the threshold die
    # before recording)
    dim = DimLine(intensity=0.01)
    bright_frame = pyrayt.RayTracer(
        DimLine(intensity=0.01), [_scene()], rays_per_source=5, generation_limit=3
    ).trace()
    assert len(bright_frame) == 5  # inert by default (reference behavior)

    tracer = pyrayt.RayTracer(
        dim,
        [_scene()],
        rays_per_source=5,
        generation_limit=3,
        config=TraceConfig(apply_intensity_threshold=True),
    )
    assert len(tracer.trace()) == 0


def test_instance_intensity_threshold_attribute_is_honored():
    tracer = pyrayt.RayTracer(
        comp.LineOfRays(),  # default intensity 100
        [_scene()],
        rays_per_source=5,
        generation_limit=3,
        config=TraceConfig(apply_intensity_threshold=True),
    )
    tracer.ray_intensity_threshold = 50.0  # instance attr shadows the class
    assert len(tracer.trace()) == 5  # 100 >= 50: survive

    tracer.ray_intensity_threshold = 200.0
    tracer.reset()
    assert len(tracer.trace()) == 0  # 100 < 200: killed


def test_use_fused_true_matches_xla_engine():
    # the fused kernel is GPU code: forcing it on the CPU raises, and the
    # kernel (interpreted) gives the XLA engine's frame on the same backend
    from pyrayt_tpu.ops import fused_trace
    from pyrayt_tpu.tracer.frame import records_to_dataframe

    source = comp.ConeOfRays(cone_angle=6.0).move_x(-0.5)
    lens = comp.biconvex_lens(2.0, 2.0, 0.25, aperture=1.0)
    detector = comp.baffle((1.0, 1.0)).move_x(1.0)

    frame_xla = pyrayt.RayTracer(
        source, [lens, detector], rays_per_source=8, generation_limit=4,
        config=TraceConfig(use_fused=False),
    ).trace()
    forced = pyrayt.RayTracer(
        source, [lens, detector], rays_per_source=8, generation_limit=4,
        config=TraceConfig(use_fused=True),
    )
    with pytest.raises(ValueError, match="use_fused=True"):
        forced.trace()
    fn, params, rays = forced.trace_fn()
    scene = compile_scene([lens, detector])
    kernel = fused_trace.build_fused_trace_fn(
        scene.spec, scene.materials, forced.get_config(), interpret=True
    )
    result = kernel(params, rays)
    frame_fused = records_to_dataframe(result.records, result.record_mask)
    assert len(frame_xla) == len(frame_fused) > 0
    np.testing.assert_allclose(
        frame_xla.to_numpy(), frame_fused.to_numpy(), rtol=0, atol=1e-6
    )


def test_set_config_after_construction():
    tracer = pyrayt.RayTracer(
        DimLine(intensity=0.01), [_scene()], rays_per_source=5, generation_limit=3
    )
    assert len(tracer.trace()) == 5
    tracer.set_config(TraceConfig(apply_intensity_threshold=True))
    tracer.reset()
    assert len(tracer.trace()) == 0


def test_world_index_comes_from_config():
    tracer = pyrayt.RayTracer(
        comp.LineOfRays(), [_scene()], config=TraceConfig(world_index=1.33)
    )
    assert tracer.get_config().world_index == 1.33


def test_compile_cache_dir_follows_the_environment(monkeypatch, tmp_path):
    from pyrayt_tpu import config

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_defaults_to_the_repo(monkeypatch):
    import os

    import jax

    from pyrayt_tpu import config

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(config.__file__)))
    assert config.compile_cache_dir() == os.path.join(repo, ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    try:
        assert config.enable_compile_cache() == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == os.path.join(repo, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
