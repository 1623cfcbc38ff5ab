"""Component factory tests (test/test_pyrayt/test_components/test_components.py
plus structural checks on the CSG recipes)."""

import numpy as np
import pytest

from pyrayt_tpu import components, materials
from pyrayt_tpu.components import _create_aperture, _lens_full_thickness
from pyrayt_tpu.scene import CSGSurface, Cuboid, Cylinder
from pyrayt_tpu.scene.compile import compile_scene


class TestLensFullThickness:
    """Sag math parity (reference test_components.py:10-38)."""

    def test_biconvex_no_extension(self):
        # convex surfaces (r1>0, r2<0) don't extend the aperture
        total, shift = _lens_full_thickness(2.0, -2.0, 0.5, 1.0)
        assert float(total) == pytest.approx(0.5)
        assert float(shift) == pytest.approx(0.0)

    def test_biconcave_extends_both(self):
        r = 2.0
        aperture = 1.0
        sag = abs(r) - np.sqrt(r**2 - (aperture / 2) ** 2)
        total, shift = _lens_full_thickness(-r, r, 0.5, aperture)
        assert float(total) == pytest.approx(0.5 + 2 * sag)
        assert float(shift) == pytest.approx(0.0)

    def test_planar(self):
        total, shift = _lens_full_thickness(np.inf, np.inf, 0.5, 1.0)
        assert float(total) == pytest.approx(0.5)
        assert float(shift) == pytest.approx(0.0)

    def test_asymmetric_shift(self):
        r = 2.0
        aperture = 1.0
        sag = abs(r) - np.sqrt(r**2 - (aperture / 2) ** 2)
        total, shift = _lens_full_thickness(-r, np.inf, 0.5, aperture)
        assert float(total) == pytest.approx(0.5 + sag)
        assert float(shift) == pytest.approx(-sag)


class TestCreateAperture:
    def test_circular(self):
        shape = _create_aperture(2.0, 1.0)
        assert isinstance(shape, Cylinder)
        assert float(shape.get_radius()) == pytest.approx(1.0)

    def test_rectangular(self):
        shape = _create_aperture((2.0, 4.0), 1.0)
        assert isinstance(shape, Cuboid)
        spans = np.asarray(shape.axis_spans)
        assert np.allclose(spans[0], [-1, 1])
        assert np.allclose(spans[1], [-2, 2])

    def test_elliptical_returns_scaled_cylinder(self):
        # quirk Q3 in the reference returned None here; fixed in this build
        shape = _create_aperture((-2.0, -4.0), 1.0)
        assert isinstance(shape, Cylinder)

    def test_invalid_raises(self):
        with pytest.raises(TypeError):
            _create_aperture((2.0, -4.0), 1.0)


class TestLensFactories:
    def test_thick_lens_structure(self):
        lens = components.thick_lens(2.0, -2.0, 0.25)
        assert isinstance(lens, CSGSurface)
        assert len(lens.surface_ids) == 3  # aperture + 2 spheres

    def test_planar_window_single_leaf(self):
        lens = components.thick_lens(np.inf, np.inf, 0.25)
        assert len(lens.surface_ids) == 1

    def test_lens_material_propagates(self):
        lens = components.thick_lens(2.0, -2.0, 0.25, material=materials.glass["BK7"])
        scene = compile_scene([lens])
        assert all(m is materials.glass["BK7"] for m in scene.materials)

    def test_lens_axis_is_x(self):
        # the aperture cylinder's axis is rotated onto x: a y-offset ray
        # inside the aperture must still hit the lens
        lens = components.thick_lens(np.inf, np.inf, 0.25, aperture=1)
        rays = np.zeros((2, 4, 2))
        rays[0, 0] = -5
        rays[0, 1, 1] = 0.4  # offset in y
        rays[0, 3] = 1
        rays[1, 0] = 1
        hits, _ = lens.intersect(rays)
        assert np.all(np.isfinite(np.asarray(hits)[:2]))

    def test_biconvex_lens_symmetric(self):
        lens = components.biconvex_lens(2.0, 2.0, 0.25)
        assert len(lens.surface_ids) == 3

    def test_plano_convex(self):
        lens = components.plano_convex_lens(2.0, 0.25)
        assert len(lens.surface_ids) == 2


class TestMirrorFactories:
    def test_plane_mirror_is_reflective(self):
        mirror = components.plane_mirror(0.1)
        scene = compile_scene([mirror])
        assert scene.materials[0] is materials.mirror

    def test_spherical_mirror_mixed_materials(self):
        mirror = components.spherical_mirror(radius=2.0, thickness=0.1)
        scene = compile_scene([mirror])
        kinds = {m.kind for m in scene.materials}
        assert materials.KIND_ABSORB in kinds and materials.KIND_MIRROR in kinds

    def test_spherical_mirror_focuses_at_half_radius(self):
        import pyrayt_tpu as pyrayt

        radius = 4.0
        mirror = components.spherical_mirror(radius=radius, thickness=0.1, aperture=1)
        # the reflective face looks toward +x; send paraxial rays in -x and
        # catch the reflections on a baffle behind the source
        source = components.LineOfRays(spacing=0.2).rotate_z(180).move_x(5)
        catcher = components.baffle((4, 4)).move_x(6)
        tracer = pyrayt.RayTracer(source, [mirror, catcher], rays_per_source=5)
        frame = tracer.trace()
        reflected = frame[frame["generation"] == 1]
        assert len(reflected) == 5
        y0 = reflected["y0"].to_numpy()
        tx = reflected["x_tilt"].to_numpy()
        ty = reflected["y_tilt"].to_numpy()
        x0 = reflected["x0"].to_numpy()
        off_axis = np.abs(ty) > 1e-12
        t_cross = -y0[off_axis] / ty[off_axis]
        x_cross = x0[off_axis] + t_cross * tx[off_axis]
        # paraxial focus at r/2 (small spherical-aberration tolerance)
        assert np.allclose(x_cross, radius / 2, atol=0.01)

    def test_parabolic_mirror_focus_at_origin(self):
        import pyrayt_tpu as pyrayt

        focus = 1.0
        mirror = components.parabolic_mirror(focus=focus, thickness=0.1, aperture=1)
        # reflective face looks toward +x (absorbing back extends to
        # x = -(focus+thickness)); rays come from +x, reflections caught on
        # a baffle behind the source
        source = components.LineOfRays(spacing=0.5).rotate_z(180).move_x(5)
        catcher = components.baffle((4, 4)).move_x(6)
        tracer = pyrayt.RayTracer(source, [mirror, catcher], rays_per_source=7)
        frame = tracer.trace()
        reflected = frame[frame["generation"] == 1]
        assert len(reflected) == 7
        # every reflected ray passes through the origin (the focus):
        # the segment from (x0,y0) with tilt (tx,ty) crosses y=0 at x=0
        x0 = reflected["x0"].to_numpy()
        y0 = reflected["y0"].to_numpy()
        tx = reflected["x_tilt"].to_numpy()
        ty = reflected["y_tilt"].to_numpy()
        # parameter where y=0: t = -y0/ty; x there should be ~0
        off_axis = np.abs(ty) > 1e-12
        t_cross = -y0[off_axis] / ty[off_axis]
        x_cross = x0[off_axis] + t_cross * tx[off_axis]
        assert np.allclose(x_cross, 0.0, atol=1e-6)


class TestBaffleAndAperture:
    def test_baffle_absorbs(self):
        bf = components.baffle((2, 2))
        scene = compile_scene([bf])
        assert scene.materials[0] is materials.absorber

    def test_aperture_passes_center_blocks_edge(self):
        import pyrayt_tpu as pyrayt

        ap = components.aperture(size=(4, 4), aperture_size=1.0)
        bf = components.baffle((8, 8)).move_x(5)
        center = components.LineOfRays(0.0).move_x(-1)
        edge = components.LineOfRays(0.0).move_x(-1).move_y(1.5)
        tracer = pyrayt.RayTracer([center, edge], [ap, bf], rays_per_source=1)
        frame = tracer.trace()
        final_surface = frame.groupby("id")["surface"].last()
        # center ray reaches the far baffle; edge ray dies on the aperture
        assert float(final_surface.loc[0.0]) == float(bf.get_id())
        assert float(final_surface.loc[1.0]) != float(bf.get_id())


class TestPrism:
    def test_structure(self):
        prism = components.equilateral_prism(1, 1)
        assert len(prism.surface_ids) == 3

    def test_default_material_bk7(self):
        prism = components.equilateral_prism(1, 1)
        scene = compile_scene([prism])
        assert scene.materials[0] is materials.glass["BK7"]


class TestApertureSemantics:
    """aperture() opening behavior: rays through
    the central opening transmit untouched; rays hitting the rim absorb
    (reference: pyrayt/components.py:451-468)."""

    def test_opening_transmits_rim_absorbs(self):
        import pyrayt_tpu as pyrayt
        from pyrayt_tpu import components

        # aperture_size is the opening DIAMETER (reference parity: it feeds
        # _create_aperture, components.py:31-53): radius 0.5 here
        stop = components.aperture(size=(2.0, 2.0), aperture_size=1.0).move_x(1.0)
        detector = components.baffle((4.0, 4.0)).move_x(2.0)
        # 5 rays: y = -0.8, -0.4, 0, 0.4, 0.8 -> outer two hit the rim
        # (|y| > 0.5), inner three pass through the opening
        source = components.LineOfRays(1.6)
        tracer = pyrayt.RayTracer(
            source, [stop, detector], rays_per_source=5, generation_limit=5
        )
        frame = tracer.trace()

        final = frame.loc[frame.groupby("id")["generation"].idxmax()]
        by_y = final.sort_values("y0")
        x_end = by_y["x1"].to_numpy()
        # rim rays stop at the aperture plane (x = 1), opening rays reach
        # the detector (x = 2)
        np.testing.assert_allclose(x_end, [1.0, 2.0, 2.0, 2.0, 1.0], atol=1e-9)
        # transmitted rays keep their direction and never gained a segment
        # at the stop's surfaces
        inner = frame[np.abs(frame["y0"]) < 0.5]
        assert np.allclose(inner["x_tilt"], 1.0)


class TestEllipticalMirror:
    """elliptical_mirror completes the reference's commented-out factory
    (components.py:324-347).  Physics pin: a prolate-spheroid mirror
    reflects rays from one focus through the other."""

    def test_focus_to_focus(self):
        import pyrayt_tpu as pyrayt

        a, b = 2.0, 1.0  # major, minor semi-axes
        c = np.sqrt(a**2 - b**2)
        m = components.elliptical_mirror(a, b, thickness=0.2, aperture=1.2)
        # reflected rays leave the near-vertex patch steeply (-z); a plane
        # just past the second focus's x catches them
        det = components.baffle((8.0, 8.0)).move_x(1.2)
        # source at the focus (b, 0, +c), aimed at the mirror vertex
        # (origin): direction (-b, 0, -c) normalized -> rotate a narrow
        # cone onto that axis
        angle = np.degrees(np.arctan2(c, b))
        src = (
            components.ConeOfRays(cone_angle=4.0)
            .rotate_z(180)
            .rotate_y(-angle)
            .move_x(b)
            .move_z(c)
        )
        tracer = pyrayt.RayTracer(src, [m, det], rays_per_source=16,
                                  generation_limit=6)
        frame = tracer.trace()
        g1 = frame[frame["generation"] == 1]
        assert len(g1) > 8, "most rays must reflect off the ellipsoid"
        p = g1[["x0", "y0", "z0"]].to_numpy()
        d = g1[["x_tilt", "y_tilt", "z_tilt"]].to_numpy()
        other_focus = np.array([b, 0.0, -c])
        rel = other_focus - p
        t_star = (rel * d).sum(axis=1)
        closest = p + t_star[:, None] * d
        dist = np.linalg.norm(closest - other_focus, axis=1)
        assert dist.max() < 1e-6, dist.max()

    def test_major_must_dominate(self):
        with pytest.raises(ValueError, match="major_radius"):
            components.elliptical_mirror(0.5, 1.0, thickness=0.1)
