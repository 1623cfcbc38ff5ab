"""Trace-engine parity tests.

Re-hosts the reference's test/test_pyrayt/test_core.py micro-traces:
single mirror (10 rows ending at the mirror), two facing mirrors (exactly
generation_limit x n rows), multiple sources, scalar argument padding —
plus RaySet invariants on the pytree container.
"""

import numpy as np
import pytest

import pyrayt_tpu as pyrayt
from pyrayt_tpu import components, materials
from pyrayt_tpu.tracer.rayset import RaySet, concatenate


class TestRaySet:
    def test_defaults(self):
        rs = RaySet.create(11)
        assert rs.n_rays == 11
        assert np.allclose(np.asarray(rs.wavelength), 0.633)
        assert np.allclose(np.asarray(rs.index), 1.0)
        assert np.allclose(np.asarray(rs.intensity), 100.0)
        assert np.allclose(np.asarray(rs.generation), 0.0)
        assert np.allclose(np.asarray(rs.id), np.arange(11))
        assert np.allclose(np.asarray(rs.positions[3]), 1.0)  # homogeneous w
        assert np.allclose(np.asarray(rs.directions), 0.0)

    def test_rays_view_layout(self):
        rs = RaySet.create(5)
        rays = np.asarray(rs.rays)
        assert rays.shape == (2, 4, 5)
        packed = rs.to_numpy()
        assert packed.shape == (13, 5)
        assert np.allclose(packed[8], 0)  # generation row
        assert np.allclose(packed[10], 0.633)  # wavelength row

    def test_concatenate(self):
        a = RaySet.create(3)
        b = RaySet.create(4, wavelength=0.5)
        c = concatenate([a, b])
        assert c.n_rays == 7
        assert np.allclose(np.asarray(c.wavelength)[:3], 0.633)
        assert np.allclose(np.asarray(c.wavelength)[3:], 0.5)


from pyrayt_tpu.scene import XYPlane


@pytest.fixture()
def mirror_setup():
    # parity with test_core.py:41-42: a bare mirror-material plane at x=3
    source = components.LineOfRays(spacing=1)
    mirror = XYPlane(material=materials.mirror).rotate_y(-90).move_x(3)
    return source, mirror


class TestMicroTraces:
    def test_single_mirror_ten_rows(self, mirror_setup):
        source, mirror = mirror_setup
        tracer = pyrayt.RayTracer(source, [mirror], rays_per_source=10)
        frame = tracer.trace()
        # every ray hits the mirror once then flies off -> exactly 10 rows
        assert len(frame) == 10
        assert np.allclose(frame["x1"], 3.0)
        assert np.allclose(frame["generation"], 0.0)

    def test_two_facing_mirrors_hit_generation_limit(self):
        m1 = XYPlane(material=materials.mirror).rotate_y(-90).move_x(3)
        m2 = XYPlane(material=materials.mirror).rotate_y(90).move_x(-3)
        source = components.LineOfRays(spacing=1)
        limit = 10
        n_rays = 10
        tracer = pyrayt.RayTracer(
            source, [m1, m2], rays_per_source=n_rays, generation_limit=limit
        )
        frame = tracer.trace()
        assert len(frame) == limit * n_rays
        assert sorted(frame["generation"].unique()) == list(range(limit))

    def test_multiple_sources_unique_ids(self, mirror_setup):
        source, mirror = mirror_setup
        source2 = components.LineOfRays(spacing=1)
        tracer = pyrayt.RayTracer([source, source2], [mirror], rays_per_source=10)
        frame = tracer.trace()
        assert len(frame) == 20
        assert sorted(frame["id"].unique()) == list(range(20))

    def test_scalar_arguments_are_padded(self, mirror_setup):
        # single source / single component (not wrapped in lists)
        source, mirror = mirror_setup
        tracer = pyrayt.RayTracer(source, mirror, rays_per_source=5)
        frame = tracer.trace()
        assert len(frame) == 5

    def test_calculate_source_ids(self, mirror_setup):
        source, mirror = mirror_setup
        source2 = components.LineOfRays(spacing=1)
        tracer = pyrayt.RayTracer([source, source2], [mirror], rays_per_source=10)
        tracer.trace()
        tracer.calculate_source_ids()
        frame = tracer.get_results()
        assert set(frame["source_id"].unique()) == {0, 1}

    def test_frame_dtype_and_columns(self, mirror_setup):
        source, mirror = mirror_setup
        tracer = pyrayt.RayTracer(source, [mirror], rays_per_source=4)
        frame = tracer.trace()
        assert list(frame.columns) == [
            "generation", "intensity", "wavelength", "index", "id", "surface",
            "x0", "y0", "z0", "x1", "y1", "z1", "x_tilt", "y_tilt", "z_tilt",
        ]
        assert all(dtype == np.float32 for dtype in frame.dtypes)

    def test_surface_column_is_public_id(self, mirror_setup):
        source, mirror = mirror_setup
        tracer = pyrayt.RayTracer(source, [mirror], rays_per_source=4)
        frame = tracer.trace()
        lut_ids = {sid for sid, _ in mirror.surface_ids}
        assert set(frame["surface"].astype(int).unique()) <= lut_ids

    def test_fixed_loop_matches_while_loop(self, mirror_setup):
        source, mirror = mirror_setup
        tracer = pyrayt.RayTracer(source, [mirror], rays_per_source=10)
        frame_while = tracer.trace()
        result_fixed = tracer.trace_device(fixed_loop=True)
        from pyrayt_tpu.tracer.frame import records_to_dataframe

        frame_fixed = records_to_dataframe(
            result_fixed.records, result_fixed.record_mask
        )
        assert np.allclose(
            frame_while.to_numpy(), frame_fixed.to_numpy(), equal_nan=True
        )

    def test_absorber_records_then_kills(self):
        source = components.LineOfRays(spacing=1)
        bf = components.baffle((4, 4)).move_x(2)
        tracer = pyrayt.RayTracer(source, [bf], rays_per_source=7, generation_limit=10)
        frame = tracer.trace()
        # one row per ray: the segment ending on the absorber
        assert len(frame) == 7
        assert np.allclose(frame["x1"], 2.0)

    def test_no_hit_rays_not_recorded(self):
        source = components.LineOfRays(spacing=1)
        bf = components.baffle((4, 4)).move_x(-2)  # behind the source
        tracer = pyrayt.RayTracer(source, [bf], rays_per_source=7)
        frame = tracer.trace()
        assert len(frame) == 0


class TestPin:
    def test_pin_restores_transform(self):
        lens = components.thick_lens(10, -10, 1)
        before = np.asarray(lens.get_world_transform()).copy()
        with pyrayt.pin(lens):
            lens.move_x(100)
            assert np.allclose(np.asarray(lens.get_position())[0], 100)
        assert np.allclose(np.asarray(lens.get_world_transform()), before, atol=1e-9)

    def test_pin_multiple_objects(self):
        a = components.thick_lens(10, -10, 1)
        b = components.baffle((1, 1))
        with pyrayt.pin(a, b):
            a.move_y(3)
            b.move_z(-2)
        assert np.allclose(np.asarray(a.get_position()), [0, 0, 0, 1], atol=1e-9)
        assert np.allclose(np.asarray(b.get_position()), [0, 0, 0, 1], atol=1e-9)


class TestEngineCacheStability:
    """Rebuilding an identical scene must reuse the compiled trace
    (identity-keyed material hashing once caused silent recompiles on
    every scene rebuild)."""

    def test_rebuilt_scene_hits_compile_cache(self):
        import pyrayt_tpu.materials as matl
        from pyrayt_tpu import components
        from pyrayt_tpu.config import TraceConfig
        from pyrayt_tpu.scene.compile import compile_scene
        from pyrayt_tpu.scene.objects import fresh_ids
        from pyrayt_tpu.tracer import engine

        def build():
            with fresh_ids():
                # fresh material instances each time, equal by value
                glass = matl.SellmeierRefractor(1.0, 0.2, 1.0, 6e-3, 2e-2, 103.0)
                lens = components.thick_lens(1.0, -1.0, 0.25, aperture=0.5, material=glass)
                det = components.baffle((1.0, 1.0)).move_x(1.0)
                return compile_scene([lens, det])

        config = TraceConfig(generation_limit=3, fixed_loop=True)
        s1 = build()
        s2 = build()
        assert s1.spec == s2.spec
        assert s1.materials == s2.materials
        fn1 = engine.build_trace_fn(s1.spec, s1.materials, config)
        fn2 = engine.build_trace_fn(s2.spec, s2.materials, config)
        assert fn1 is fn2

    def test_different_glass_misses_cache(self):
        import pyrayt_tpu.materials as matl

        a = matl.SellmeierRefractor(1.0, 0.2, 1.0, 6e-3, 2e-2, 103.0)
        b = matl.SellmeierRefractor(1.1, 0.2, 1.0, 6e-3, 2e-2, 103.0)
        assert a != b and hash(a) != hash(b)
        assert a == matl.SellmeierRefractor(1.0, 0.2, 1.0, 6e-3, 2e-2, 103.0)
        assert matl.absorber == matl._AbsorbingMaterial()
        assert matl.mirror == matl._ReflectingMaterial()
        assert matl.BasicRefractor(1.5) == matl.BasicRefractor(1.5)
        assert matl.BasicRefractor(1.5) != matl.BasicRefractor(1.6)
