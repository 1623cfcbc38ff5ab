"""North-star parity: trace the reference's named workloads in BOTH
frameworks and assert the result DataFrames match (BASELINE.md).

Workloads (the three named in BASELINE.md):

* convex collimator — /root/reference/examples/convex_collimator.py:29-47
  and int_test_ray_plane_intersection.py:42-54 (same system)
* chromatic dispersion prism — /root/reference/examples/chromatic_dispersion.py:10-37
* condenser tutorial — /root/reference/docs/source/tutorial.rst (biconvex
  imaging system with a cone source)

Comparison contract:

* identical row count, generation-major row order aligned on
  (generation, id);
* all physical columns allclose at float32 resolution (both frames are
  float32; the traces themselves run f64 here);
* the ``surface`` column holds each framework's own global object ids, so
  values differ by construction — instead the *mapping* ours->reference
  must be a consistent bijection (same surface structure ray by ray).

Documented deviations (SURVEY.md quirks): none affect these workloads —
Q1 (inert intensity threshold) is reproduced by default, Q2 (biconvex
radius bug) does not trigger because both workloads use r1 == r2.
"""

import jax
import numpy as np
import pandas as pd
import pytest

import pyrayt_tpu
from pyrayt_tpu import components as tcomp

PHYSICAL_COLUMNS = [
    "generation",
    "intensity",
    "wavelength",
    "index",
    "id",
    "x0",
    "y0",
    "z0",
    "x1",
    "y1",
    "z1",
    "x_tilt",
    "y_tilt",
    "z_tilt",
]


def assert_frames_match(ours: pd.DataFrame, ref: pd.DataFrame, atol=1e-5):
    assert len(ours) == len(ref), f"row counts differ: {len(ours)} vs {len(ref)}"
    ours = ours.sort_values(["generation", "id"]).reset_index(drop=True)
    ref = ref.sort_values(["generation", "id"]).reset_index(drop=True)

    for col in PHYSICAL_COLUMNS:
        np.testing.assert_allclose(
            ours[col].to_numpy(dtype=np.float64),
            ref[col].to_numpy(dtype=np.float64),
            atol=atol,
            rtol=1e-5,
            err_msg=f"column {col!r} differs",
        )

    # surface ids: values are framework-local; the ray-by-ray correspondence
    # must be a bijection
    mapping = {}
    reverse = {}
    for mine, theirs in zip(ours["surface"], ref["surface"]):
        assert mapping.setdefault(mine, theirs) == theirs, (
            f"our surface {mine} maps to both {mapping[mine]} and {theirs}"
        )
        assert reverse.setdefault(theirs, mine) == mine, (
            f"reference surface {theirs} maps to both {reverse[theirs]} and {mine}"
        )


class TestConvexCollimator:
    """50-ray cone -> biconvex lens -> baffle; exactly 150 rows and
    generation-2 rays collimated onto x = 1."""

    def _ref_frame(self, reference):
        lens = reference.components.biconvex_lens(2, 2, 0.25, aperture=1)
        focus = pyrayt_tpu.lensmakers_equation(2, -2, 1.5, 0.25)
        source = reference.components.ConeOfRays(cone_angle=6).move_x(-focus)
        baffle = reference.components.baffle((1, 1)).move_x(1)
        tracer = reference.RayTracer(source, [lens, baffle])
        tracer.set_rays_per_source(50)
        tracer.set_generation_limit(100)
        return tracer.trace()

    def _our_frame(self):
        lens = tcomp.biconvex_lens(2, 2, 0.25, aperture=1)
        focus = pyrayt_tpu.lensmakers_equation(2, -2, 1.5, 0.25)
        source = tcomp.ConeOfRays(cone_angle=6).move_x(-focus)
        baffle = tcomp.baffle((1, 1)).move_x(1)
        tracer = pyrayt_tpu.RayTracer(
            source, [lens, baffle], rays_per_source=50, generation_limit=100
        )
        return tracer.trace()

    def test_frame_parity(self, reference):
        ours = self._our_frame()
        ref = self._ref_frame(reference)
        assert len(ours) == 150
        assert_frames_match(ours, ref)


class TestChromaticDispersionPrism:
    """11 single-ray monochromatic sources through a BK7 equilateral prism
    onto a tilted baffle (examples/chromatic_dispersion.py)."""

    @staticmethod
    def _build(mod_components):
        prism_size = 1
        prism = mod_components.equilateral_prism(prism_size, prism_size)
        prism.move_x(prism_size / 4)
        baffle = mod_components.baffle((1, 1)).rotate_y(90).move(1, 0, -0.5)
        sources = [
            mod_components.LineOfRays(spacing=0.1, wavelength=x)
            .move_x(-prism_size / 2)
            .rotate_y(-3)
            for x in np.linspace(0.44, 0.75, 11)
        ]
        return sources, [prism, baffle]

    def test_frame_parity(self, reference):
        sources, system = self._build(tcomp)
        ours = pyrayt_tpu.RayTracer(sources, system, rays_per_source=1).trace()

        ref_sources, ref_system = self._build(reference.components)
        tracer = reference.RayTracer(ref_sources, ref_system)
        tracer.set_rays_per_source(1)
        ref = tracer.trace()

        assert_frames_match(ours, ref)
        # physics sanity: dispersion fans the wavelengths out along the
        # tilted baffle (the final segments land at distinct x positions,
        # ordered by wavelength)
        final = ours[ours["generation"] == ours["generation"].max()]
        by_wl = final.sort_values("wavelength")["x1"].to_numpy()
        assert (np.diff(by_wl) > 0).all() or (np.diff(by_wl) < 0).all()


class TestCondenserTutorial:
    """The tutorial's condenser system: thick lens imaging a cone source
    (docs/source/tutorial.rst); exercised here with the general thick_lens
    factory on both sides."""

    @staticmethod
    def _build(mod_components, glass):
        lens = mod_components.thick_lens(
            r1=1.0, r2=-1.0, thickness=0.25, aperture=0.5, material=glass
        )
        detector = mod_components.baffle((1.0, 1.0)).move_x(1.0)
        source = mod_components.ConeOfRays(cone_angle=10.0).move_x(-0.5)
        return source, [lens, detector]

    def test_frame_parity(self, reference):
        import pyrayt.materials as ref_matl

        from pyrayt_tpu import materials as tmatl

        source, system = self._build(tcomp, tmatl.glass["BK7"])
        ours = pyrayt_tpu.RayTracer(
            source, system, rays_per_source=40, generation_limit=20
        ).trace()

        ref_source, ref_system = self._build(
            reference.components, ref_matl.glass["BK7"]
        )
        tracer = reference.RayTracer(
            ref_source, ref_system, rays_per_source=40, generation_limit=20
        )
        ref = tracer.trace()

        assert_frames_match(ours, ref)


class TestMirrorWorkloads:
    """Reference-parity for mirror systems (BASELINE config #4):
    spherical retro-focus, parabolic collimator, an
    off-axis parabola, and a 45-degree plane-mirror fold.  Match:
    /root/reference/pyrayt/components.py:245-398."""

    def _run_pair(self, reference, build, n_rays, gen_limit):
        srcs, system = build(tcomp, None)
        ours = pyrayt_tpu.RayTracer(
            srcs, system, rays_per_source=n_rays, generation_limit=gen_limit
        ).trace()
        rsrcs, rsystem = build(reference.components, None)
        ref = reference.RayTracer(
            rsrcs, rsystem, rays_per_source=n_rays, generation_limit=gen_limit
        ).trace()
        assert_frames_match(ours, ref)
        return ours

    def test_spherical_mirror_retro_focus(self, reference):
        # collimated beam traveling -X hits the concave sphere (R=2, focus
        # at x=+1), converges through the focus, lands on a baffle at x=3
        def build(mod, _):
            m = mod.spherical_mirror(radius=2.0, thickness=0.2, aperture=1.0)
            det = mod.baffle((4.0, 4.0)).move_x(3.0)
            src = mod.LineOfRays(0.6).rotate_z(180).move_x(1.5)
            return [src], [m, det]

        ours = self._run_pair(reference, build, 20, 10)
        assert set(ours["generation"].unique()) == {0.0, 1.0}
        g0 = ours[ours["generation"] == 0].sort_values("id")
        g1 = ours[ours["generation"] == 1].sort_values("id")
        # every reflected ray reaches the detector plane...
        np.testing.assert_allclose(g1["x1"], 3.0, atol=1e-5)
        # ...and crossed the optical axis on the way (focus between mirror
        # and baffle): the y sign flips mirror-side -> detector-side
        off_axis = np.abs(g0["y1"].to_numpy()) > 1e-6
        assert (
            np.sign(g1["y1"].to_numpy()[off_axis])
            == -np.sign(g0["y1"].to_numpy()[off_axis])
        ).all()

    def test_parabolic_mirror_collimator(self, reference):
        # point source at the focus (origin) -> collimated +X beam
        def build(mod, _):
            m = mod.parabolic_mirror(focus=0.5, thickness=0.1, aperture=1.0)
            det = mod.baffle((2.0, 2.0)).move_x(2.0)
            src = mod.ConeOfRays(cone_angle=20.0).rotate_z(180)
            return [src], [m, det]

        ours = self._run_pair(reference, build, 24, 10)
        g1 = ours[ours["generation"] == 1]
        assert len(g1) == 24
        np.testing.assert_allclose(g1["x_tilt"], 1.0, atol=1e-6)
        np.testing.assert_allclose(g1["x1"], 2.0, atol=1e-5)

    def test_off_axis_parabolic_focuses_through_origin(self, reference):
        # collimated beam parallel to the axis at y=+0.6 (the off-axis
        # segment) traveling -X reflects toward the focus at the origin
        def build(mod, _):
            m = mod.parabolic_mirror(
                focus=0.5, thickness=0.1, aperture=0.8, off_axis=(0.6, 0.0)
            )
            det = mod.baffle((6.0, 6.0)).move_x(2.0)
            src = mod.LineOfRays(0.3).rotate_z(180).move_x(2.0).move_y(0.6)
            return [src], [m, det]

        ours = self._run_pair(reference, build, 24, 10)
        g1 = ours[ours["generation"] == 1]
        assert len(g1) > 0
        # reflected segments pass within numerical focus of the origin:
        # distance from the origin to each segment's line is ~0
        p = g1[["x0", "y0", "z0"]].to_numpy()
        d = g1[["x_tilt", "y_tilt", "z_tilt"]].to_numpy()
        t_star = -(p * d).sum(axis=1)  # closest approach parameter
        closest = p + t_star[:, None] * d
        assert np.abs(closest).max() < 1e-4

    def test_plane_mirror_fold(self, reference):
        # 45-degree fold: +X beam reflects to -Y onto a rotated baffle
        def build(mod, _):
            m = mod.plane_mirror(0.1, aperture=2.0).rotate_z(45)
            det = mod.baffle((4.0, 4.0)).rotate_z(90).move_y(-2.0)
            src = mod.LineOfRays(0.8).move_x(-1.5)
            return [src], [m, det]

        ours = self._run_pair(reference, build, 16, 8)
        g1 = ours[ours["generation"] == 1]
        assert len(g1) == 16
        np.testing.assert_allclose(g1["y_tilt"], -1.0, atol=1e-6)
        np.testing.assert_allclose(g1["y1"], -2.0, atol=1e-5)


class TestUnionCSGCompound:
    """Reference-parity for a union CSG compound (BASELINE config #4):
    two overlapping glass spheres unioned into one solid, an aperture
    stop, and an imaging baffle.  Match:
    /root/reference/tinygfx/g3d/csg.py:182-191 (union path)."""

    def test_frame_parity(self, reference):
        import tinygfx.g3d as ref_cg
        import pyrayt.materials as ref_matl

        from pyrayt_tpu import materials as tmatl
        import pyrayt_tpu.scene.csg as tcsg
        from pyrayt_tpu.scene import Sphere as TSphere

        def build_ours():
            s1 = TSphere(1.0, material=tmatl.glass["ideal"])
            s2 = TSphere(1.0, material=tmatl.glass["ideal"]).move_x(0.8)
            blob = tcsg.union(s1, s2)
            stop = tcomp.aperture(size=(4.0, 4.0), aperture_size=1.2).move_x(2.2)
            det = tcomp.baffle((6.0, 6.0)).move_x(4.0)
            src = tcomp.LineOfRays(1.2).move_x(-2.0)
            return [src], [blob, stop, det]

        def build_ref():
            s1 = ref_cg.Sphere(1.0, material=ref_matl.glass["ideal"])
            s2 = ref_cg.Sphere(1.0, material=ref_matl.glass["ideal"]).move_x(0.8)
            blob = ref_cg.csg.union(s1, s2)
            stop = reference.components.aperture(
                size=(4.0, 4.0), aperture_size=1.2
            ).move_x(2.2)
            det = reference.components.baffle((6.0, 6.0)).move_x(4.0)
            src = reference.components.LineOfRays(1.2).move_x(-2.0)
            return [src], [blob, stop, det]

        srcs, system = build_ours()
        ours = pyrayt_tpu.RayTracer(
            srcs, system, rays_per_source=20, generation_limit=12
        ).trace()
        rsrcs, rsystem = build_ref()
        ref = reference.RayTracer(
            rsrcs, rsystem, rays_per_source=20, generation_limit=12
        ).trace()
        assert_frames_match(ours, ref)

        # physics sanity: rays refract on entry (generation 1 segments run
        # inside the glass at n=1.5) and the union presents ONE solid —
        # no ray records an interior boundary between the two spheres
        # (an entered ray's next surface is an exit, with index back to 1)
        g1 = ours[ours["generation"] == 1]
        assert (g1["index"] > 1.4).any()
        g2 = ours[ours["generation"] == 2]
        assert np.allclose(g2["index"], 1.0, atol=1e-6)


def test_frame_dtypes_and_columns(reference):
    """Column names, order, and float32 dtype match the reference frame."""
    lens = tcomp.biconvex_lens(2, 2, 0.25, aperture=1)
    baffle = tcomp.baffle((1, 1)).move_x(1)
    source = tcomp.ConeOfRays(cone_angle=6).move_x(-1.9)
    ours = pyrayt_tpu.RayTracer(source, [lens, baffle], rays_per_source=5).trace()

    ref_lens = reference.components.biconvex_lens(2, 2, 0.25, aperture=1)
    ref_baffle = reference.components.baffle((1, 1)).move_x(1)
    ref_source = reference.components.ConeOfRays(cone_angle=6).move_x(-1.9)
    tracer = reference.RayTracer(ref_source, [ref_lens, ref_baffle])
    tracer.set_rays_per_source(5)
    ref = tracer.trace()

    assert list(ours.columns) == list(ref.columns)
    assert all(ours.dtypes == np.float32)


class TestF32ReferenceParity:
    """Production-dtype parity: the collimator
    traced at float32 against the reference's float64 frame.  Row count and
    segment structure must be EXACTLY equal (f32 must not change which
    segments exist); physical columns match at f32-appropriate tolerance."""

    def test_collimator_f32_vs_reference_f64(self, reference):
        with jax.enable_x64(False):
            lens = tcomp.biconvex_lens(2, 2, 0.25, aperture=1)
            focus = pyrayt_tpu.lensmakers_equation(2, -2, 1.5, 0.25)
            source = tcomp.ConeOfRays(cone_angle=6).move_x(-focus)
            baffle = tcomp.baffle((1, 1)).move_x(1)
            ours = pyrayt_tpu.RayTracer(
                source, [lens, baffle], rays_per_source=50, generation_limit=100
            ).trace()

        ref_lens = reference.components.biconvex_lens(2, 2, 0.25, aperture=1)
        ref_source = reference.components.ConeOfRays(cone_angle=6).move_x(
            -pyrayt_tpu.lensmakers_equation(2, -2, 1.5, 0.25)
        )
        ref_baffle = reference.components.baffle((1, 1)).move_x(1)
        tracer = reference.RayTracer(ref_source, [ref_lens, ref_baffle])
        tracer.set_rays_per_source(50)
        tracer.set_generation_limit(100)
        ref = tracer.trace()

        # structure is exact: same rows, same (generation, id) pairs, and
        # the surface correspondence is the same bijection as at f64
        assert len(ours) == len(ref) == 150
        o = ours.sort_values(["generation", "id"]).reset_index(drop=True)
        r = ref.sort_values(["generation", "id"]).reset_index(drop=True)
        np.testing.assert_array_equal(
            o[["generation", "id"]].to_numpy(), r[["generation", "id"]].to_numpy()
        )
        # f32 tolerance: trig/refraction chains at coordinates ~1 keep
        # ~1e-5 absolute accuracy (measured headroom ~4x)
        assert_frames_match(ours, ref, atol=5e-5)


class TestNotebookImager:
    """The lens-design notebook's imager workload (cell 11): five
    CircleOfRays beams through a BK7 singlet and an f-stop onto an imager —
    exercises the aperture() CSG, multi-source bookkeeping, and
    calculate_source_ids against the reference."""

    LENS_DIAMETER = 25.4

    def _build(self, mod_components, glass):
        lens_radius = 2 * (float(glass.index_at(0.532)) - 1) * 50.0
        lens = mod_components.thick_lens(
            lens_radius, -lens_radius, 5.0,
            aperture=self.LENS_DIAMETER, material=glass,
        )
        stop = mod_components.aperture(
            size=(self.LENS_DIAMETER, self.LENS_DIAMETER), aperture_size=3.0
        ).move_x(25.0)
        imager = mod_components.baffle(
            (self.LENS_DIAMETER, self.LENS_DIAMETER)
        ).move_x(50.0)
        sources = [
            mod_components.CircleOfRays(x).move_x(-10)
            for x in np.linspace(0.1, 0.5, 5) * self.LENS_DIAMETER
        ]
        return sources, [lens, stop, imager], imager

    def test_frame_and_source_id_parity(self, reference):
        import pyrayt.materials as ref_matl

        from pyrayt_tpu import materials as tmatl

        sources, system, imager = self._build(tcomp, tmatl.glass["BK7"])
        tracer = pyrayt_tpu.RayTracer(
            sources, system, rays_per_source=41, generation_limit=10
        )
        ours = tracer.trace()
        tracer.calculate_source_ids()

        ref_sources, ref_system, ref_imager = self._build(
            reference.components, ref_matl.glass["BK7"]
        )
        ref_tracer = reference.RayTracer(
            ref_sources, ref_system, rays_per_source=41, generation_limit=10
        )
        ref = ref_tracer.trace()
        ref_tracer.calculate_source_ids()

        assert_frames_match(ours, ref)
        # the f-stop vignettes the outer beams: some rays end on the stop,
        # the rest reach the imager — and both frameworks agree per ray
        ours_sorted = ours.sort_values(["generation", "id"]).reset_index(drop=True)
        ref_sorted = ref.sort_values(["generation", "id"]).reset_index(drop=True)
        on_imager_ours = ours_sorted["surface"] == float(imager.get_id())
        on_imager_ref = ref_sorted["surface"] == float(ref_imager.get_id())
        assert on_imager_ours.sum() == on_imager_ref.sum() > 0
        assert (~on_imager_ours).sum() > 0  # something was vignetted
        np.testing.assert_array_equal(
            on_imager_ours.to_numpy(), on_imager_ref.to_numpy()
        )
        np.testing.assert_array_equal(
            ours_sorted["source_id"].to_numpy(), ref_sorted["source_id"].to_numpy()
        )
