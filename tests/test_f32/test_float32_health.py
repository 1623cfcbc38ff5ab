"""float32 numerical-health tier.

The main suite runs float64 to match the reference's NumPy numerics; GPU
production runs float32.  These tests re-run the load-bearing numerics at
f32 — CSG tie-breaking, the 1e-6 epsilon push-off against f32 ulps at
coordinates ~1.0, full-trace sanity, and the aberration analyses — inside
``jax.enable_x64(False)``.
"""

import jax
import numpy as np
import pytest

import pyrayt_tpu as pyrayt
from pyrayt_tpu import components, materials
from pyrayt_tpu.config import TraceConfig
from pyrayt_tpu.scene.compile import compile_scene
from pyrayt_tpu.tracer import engine


@pytest.fixture()
def f32():
    with jax.enable_x64(False):
        yield


class TestTraceAtF32:
    def test_collimator_exact_row_count(self, f32):
        lens = components.biconvex_lens(2, 2, 0.25, aperture=1)
        focus = pyrayt.lensmakers_equation(2, -2, 1.5, 0.25)
        source = components.ConeOfRays(cone_angle=6).move_x(-focus)
        baffle = components.baffle((1, 1)).move_x(1)
        tracer = pyrayt.RayTracer(
            source, [lens, baffle], rays_per_source=50, generation_limit=100
        )
        frame = tracer.trace()
        assert len(frame) == 150
        gen2 = frame[frame["generation"] == 2]
        assert np.allclose(gen2["x1"], 1.0, atol=1e-5)
        # collimation quality at f32: tilts unit-x to ~1e-4
        assert np.allclose(gen2["x_tilt"], 1.0, atol=1e-4)

    def test_epsilon_pushoff_advances_bounces(self, f32):
        # two facing mirrors 1 unit apart, coordinates ~1.0: the 1e-6
        # push-off is ~8 f32 ulps — every generation must alternate
        # surfaces, never re-hit the one just left
        m1 = components.plane_mirror(0.1, aperture=4.0)
        m2 = components.plane_mirror(0.1, aperture=4.0).move_x(1.0)
        tracer = pyrayt.RayTracer(
            components.LineOfRays(1.0).move_x(0.5),
            [m1, m2],
            rays_per_source=8,
            generation_limit=8,
        )
        frame = tracer.trace()
        assert len(frame) == 8 * 8
        # per ray, consecutive generations hit different surfaces
        for _, ray in frame.groupby("id"):
            surfaces = ray.sort_values("generation")["surface"].to_numpy()
            assert (surfaces[1:] != surfaces[:-1]).all()

    def test_f32_results_close_to_f64(self, f32):
        lens = components.thick_lens(
            1.0, -1.0, 0.25, aperture=0.5, material=materials.glass["BK7"]
        )
        det = components.baffle((1.0, 1.0)).move_x(1.0)
        scene = compile_scene([lens, det])
        config = TraceConfig(generation_limit=5, fixed_loop=True)
        rays32 = components.ConeOfRays(cone_angle=10.0).move_x(-0.5).generate_rays(64)
        assert rays32.positions.dtype == np.float32
        r32 = engine.build_trace_fn(scene.spec, scene.materials, config)(
            scene.params, rays32
        )
        with jax.enable_x64(True):
            scene64 = compile_scene([lens, det])
            rays64 = (
                components.ConeOfRays(cone_angle=10.0).move_x(-0.5).generate_rays(64)
            )
            r64 = engine.build_trace_fn(scene64.spec, scene64.materials, config)(
                scene64.params, rays64
            )
        m32 = np.asarray(r32.record_mask)
        m64 = np.asarray(r64.record_mask)
        assert np.array_equal(m32, m64), "f32 changed which segments exist"
        rec32 = np.asarray(r32.records) * m32[:, None, :]
        rec64 = np.asarray(r64.records) * m64[:, None, :]
        np.testing.assert_allclose(rec32, rec64, atol=5e-5)


class TestCsgTiesAtF32:
    def test_coincident_surfaces_union(self, f32):
        # two identical cuboids unioned: every interval tie must resolve to
        # a single well-formed solid (entry then exit), not a sliver
        from pyrayt_tpu.scene import csg
        from pyrayt_tpu.scene.surfaces import Cuboid

        a = Cuboid((-1, -1, -1), (1, 1, 1), material=materials.mirror)
        b = Cuboid((-1, -1, -1), (1, 1, 1), material=materials.mirror)
        blob = csg.union(a, b)
        hits, ids = blob.intersect(np.array([[-5.0, 0, 0, 1], [1, 0, 0, 0]]))
        finite = np.asarray(hits)[np.isfinite(np.asarray(hits))]
        np.testing.assert_allclose(sorted(finite)[:2], [4.0, 6.0], atol=1e-6)


class TestAnalysesAtF32:
    def test_spherical_aberration_keeps_all_rays(self, f32):
        # regression: an f32 edge-grazing ray with an extra bounce must not
        # collapse the analysis to a single row (aberrations._imager_rays)
        from pyrayt_tpu.analysis import spherical_aberration

        lens_radius = 2 * (float(materials.glass["BK7"].index_at(0.532)) - 1) * 50.0
        lens = components.thick_lens(
            lens_radius, -lens_radius, 5.0, aperture=25.4,
            material=materials.glass["BK7"],
        )
        imager = components.baffle((25.4, 25.4)).move_x(50.0)
        table = spherical_aberration([lens, imager], -10.0, 25.4 / 4, 11)
        assert len(table) == 11
        assert float(np.ptp(table["focus"])) > 0.5  # real spherical aberration


class TestGradientsAtF32:
    def test_trace_gradients_finite_at_f32(self, f32):
        """Regression: on-axis rays give the aperture cylinder a quadratic
        linear-term b ~ 1e-33; the backward pass of binomial_root's linear
        branch underflowed b^2 and poisoned the whole world-transform
        gradient with NaN at float32 (fine at float64)."""
        import jax
        import jax.numpy as jnp

        from pyrayt_tpu.analysis import metrics
        from pyrayt_tpu.config import TraceConfig
        from pyrayt_tpu.scene.compile import compile_scene
        from pyrayt_tpu.tracer import engine

        lens = components.thick_lens(
            1.0, -1.0, 0.25, aperture=0.5, material=materials.glass["BK7"]
        )
        det = components.baffle((1.0, 1.0)).move_x(1.0)
        scene = compile_scene([lens, det])
        fn = engine.build_trace_fn(
            scene.spec, scene.materials, TraceConfig(generation_limit=6, fixed_loop=True)
        )
        rays = components.ConeOfRays(cone_angle=10.0).move_x(-0.5).generate_rays(256)
        assert rays.positions.dtype == np.float32

        def loss(params, r):
            return metrics.rms_spot_radius(fn(params, r))

        value, grads = jax.value_and_grad(loss)(scene.params, rays)
        assert np.isfinite(float(value))
        for name, leaf in grads.items():
            arr = np.asarray(leaf)
            assert np.all(np.isfinite(arr)), f"non-finite grad in {name}"
        # and the gradients are not trivially zero
        assert np.abs(np.asarray(grads["world"])).max() > 1e-8
