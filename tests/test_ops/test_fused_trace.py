"""Parity: the fused GPU trace kernel vs the XLA engine.

On the CPU the kernel runs in the Pallas interpreter (``interpret=True``,
passed explicitly here) at f64, and the full TraceResult contract must
match engine.build_trace_fn across every primitive type, packed material,
TIR, ray counts that are not a multiple of the block, early exit and
generation-limit exhaustion.  The dispatch rule is tested with the
platform faked.  ``test_compiled_kernel_matches_xla_on_the_gpu`` is the
one case that needs the card (marker ``gpu``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pyrayt_tpu as pyrayt
import pyrayt_tpu.scene.csg as csg
from pyrayt_tpu import components as comp
from pyrayt_tpu import materials as matl
from pyrayt_tpu.config import TraceConfig
from pyrayt_tpu.ops import fused_trace
from pyrayt_tpu.scene.compile import compile_scene
from pyrayt_tpu.scene.surfaces import Sphere
from pyrayt_tpu.tracer import engine


def assert_result_parity(scene, rays, config, rtol=1e-9, atol=1e-9, block=128):
    fn_x = engine.build_trace_fn(scene.spec, scene.materials, config)
    fn_f = fused_trace.build_fused_trace_fn(
        scene.spec, scene.materials, config, interpret=True, block=block
    )
    rx = fn_x(scene.params, rays)
    rf = fn_f(scene.params, rays)

    mask_x = np.asarray(rx.record_mask)
    mask_f = np.asarray(rf.record_mask)
    assert mask_f.dtype == bool
    assert np.array_equal(mask_x, mask_f), "record masks differ"
    assert int(rx.generations_run) == int(rf.generations_run)

    recs_x = np.asarray(rx.records) * mask_x[:, None, :]
    recs_f = np.asarray(rf.records) * mask_f[:, None, :]
    np.testing.assert_allclose(recs_f, recs_x, rtol=rtol, atol=atol)

    for field in (
        "positions", "directions", "generation", "intensity", "wavelength",
        "index", "id",
    ):
        np.testing.assert_allclose(
            np.asarray(getattr(rf.final_rays, field)),
            np.asarray(getattr(rx.final_rays, field)),
            rtol=rtol,
            atol=atol,
            err_msg=f"final_rays.{field} differs",
        )
    return rx, rf


def _condenser():
    lens = comp.thick_lens(1.0, -1.0, 0.25, aperture=0.5, material=matl.glass["BK7"])
    det = comp.baffle((1.0, 1.0)).move_x(1.0)
    return compile_scene([lens, det])


def _cone_rays(n):
    return comp.ConeOfRays(cone_angle=10.0).move_x(-0.5).generate_rays(n)


class TestFlagshipParity:
    """Condenser scene: cylinder + 2 spheres (intersect/difference CSG),
    BK7 glass + absorbing baffle (plane)."""

    def test_parity_with_early_death(self):
        # rays die at generation ~3 of 6: the kernel's early-exit
        # while_loop must leave identical masks and zeroed records after
        scene = _condenser()
        rx, rf = assert_result_parity(
            scene, _cone_rays(256), TraceConfig(generation_limit=6, fixed_loop=True)
        )
        masks = np.asarray(rf.record_mask)
        assert masks[:3].any() and not masks[4:].any()
        assert not np.asarray(rf.records)[4:].any(), "skipped generations not zeroed"

    @pytest.mark.parametrize("n_rays", [1, 50, 129, 300])
    def test_unaligned_ray_count(self, n_rays):
        # ray counts off the block multiple force padding; padded rays must
        # not leak into records, masks or the final state
        assert_result_parity(
            _condenser(), _cone_rays(n_rays),
            TraceConfig(generation_limit=6, fixed_loop=True),
        )


def test_all_five_primitives_and_mirror():
    """Sphere, paraboloid, plane, cube, cylinder in one scene; mirror +
    absorber + glass materials."""
    mirror_p = comp.parabolic_mirror(focus=0.5, thickness=0.1, aperture=1.0)
    mirror_s = comp.spherical_mirror(radius=2.0, thickness=0.1, aperture=0.5).move_x(
        2.0
    )
    prism = comp.equilateral_prism(0.5, 0.5, material=matl.glass["BK7"]).move_y(1.5)
    det = comp.baffle((3.0, 3.0)).move_x(3.0)
    scene = compile_scene([mirror_p, mirror_s, prism, det])
    types = set(scene.spec.leaf_types)
    assert types == {0, 1, 2, 3, 4}, types  # all five primitive codes
    kinds = set(scene.spec.mat_kinds)
    assert kinds == {matl.KIND_ABSORB, matl.KIND_MIRROR, matl.KIND_GLASS}

    rays = comp.LineOfRays(0.4).move_x(-1.0).generate_rays(64)
    assert_result_parity(
        scene, rays, TraceConfig(generation_limit=5, fixed_loop=True)
    )


def test_union_csg_parity():
    """Union trees take the general CSG combiner, which the kernel does not
    carry: the scene is unsupported, and trace_rays gives the engine's
    result."""
    left = Sphere(1.0, material=matl.mirror)
    right = Sphere(1.0, material=matl.mirror).move_x(1.2)
    blob = csg.union(left, right)
    det = comp.baffle((6.0, 6.0)).move_x(-2.0)
    scene = compile_scene([blob, det])
    assert not fused_trace.supports_fused(scene.spec)
    rays = comp.WedgeOfRays(40.0).move_x(-3.0).generate_rays(64)
    cfg = TraceConfig(generation_limit=4, fixed_loop=True)
    got = engine.trace_rays(scene, rays, cfg)
    want = engine.build_trace_fn(scene.spec, scene.materials, cfg)(scene.params, rays)
    np.testing.assert_array_equal(np.asarray(got.records), np.asarray(want.records))
    with pytest.raises(ValueError, match="union"):
        fused_trace.build_fused_trace_fn(scene.spec, scene.materials, cfg, interpret=True)


def test_total_internal_reflection_parity():
    # rays entering a BK7 equilateral prism rotated -30 deg hit the second
    # face beyond the ~41 deg critical angle and TIR internally: the
    # generation >= 2 segments still carry the in-glass index
    prism = comp.equilateral_prism(1.0, 1.0, material=matl.glass["BK7"]).rotate_y(
        -30
    )
    det = comp.baffle((20.0, 20.0)).move_x(5.0)
    scene = compile_scene([prism, det])
    rays = comp.LineOfRays(0.3).move_x(-2.0).generate_rays(64)
    rx, _ = assert_result_parity(
        scene, rays, TraceConfig(generation_limit=8, fixed_loop=True)
    )
    recs = np.asarray(rx.records)
    mask = np.asarray(rx.record_mask)
    glassy = (recs[2:, 3, :] > 1.4) & mask[2:]
    assert glassy.any(), "no TIR bounce kept rays inside the glass"


def test_generation_limit_exhaustion():
    # two facing mirrors: rays never die; while_loop must run to the limit
    m1 = comp.plane_mirror(0.1, aperture=4.0)
    m2 = comp.plane_mirror(0.1, aperture=4.0).move_x(2.0)
    scene = compile_scene([m1, m2])
    rays = comp.LineOfRays(1.0).move_x(1.0).generate_rays(32)
    config = TraceConfig(generation_limit=5, fixed_loop=True)
    rx, rf = assert_result_parity(scene, rays, config)
    assert int(rf.generations_run) == 5
    assert np.asarray(rf.record_mask).all()


def test_generations_run_consistent_across_engines():
    """All three dispatch paths (scan, while-loop, kernel) must report the
    same generations_run: the number of generations that recorded at least
    one living ray — NOT the raw while-loop iteration count, which includes
    the trailing all-dead pass."""
    det = comp.baffle((4.0, 4.0)).move_x(1.0)
    scene = compile_scene([det])
    rays = comp.LineOfRays(1.0).move_x(-1.0).generate_rays(32)

    cfg_scan = TraceConfig(generation_limit=4, fixed_loop=True)
    cfg_while = TraceConfig(generation_limit=4, fixed_loop=False)
    r_scan = engine.build_trace_fn(scene.spec, scene.materials, cfg_scan)(
        scene.params, rays
    )
    r_while = engine.build_trace_fn(scene.spec, scene.materials, cfg_while)(
        scene.params, rays
    )
    r_fused = fused_trace.build_fused_trace_fn(
        scene.spec, scene.materials, cfg_scan, interpret=True
    )(scene.params, rays)
    assert int(r_scan.generations_run) == 1
    assert int(r_while.generations_run) == 1
    assert int(r_fused.generations_run) == 1


def test_while_loop_engine_parity():
    """assert_result_parity with the while-loop (fixed_loop=False) engine:
    masks, records, and generations_run must match the kernel."""
    assert_result_parity(
        _condenser(), _cone_rays(64), TraceConfig(generation_limit=6, fixed_loop=False)
    )


def test_notebook_imager_parity():
    """The lens-design notebook's imager: five beams, a BK7 singlet, an
    f-stop (aperture CSG) and a detector, ten generations."""
    glass = matl.glass["BK7"]
    radius = 2 * (float(glass.index_at(0.532)) - 1) * 50.0
    lens = comp.thick_lens(radius, -radius, 5.0, aperture=25.4, material=glass)
    stop = comp.aperture(size=(25.4, 25.4), aperture_size=3.0).move_x(25.0)
    det = comp.baffle((25.4, 25.4)).move_x(50.0)
    scene = compile_scene([lens, stop, det])
    from pyrayt_tpu.tracer.rayset import concatenate

    rays = concatenate(
        [comp.CircleOfRays(x).move_x(-10).generate_rays(24)
         for x in np.linspace(0.1, 0.5, 5) * 25.4]
    )
    rays = rays.replace(id=jnp.arange(rays.n_rays, dtype=rays.positions.dtype))
    assert_result_parity(scene, rays, TraceConfig(generation_limit=10))


def test_supports_fused_rejects_custom_material():
    class Weird(matl.TracableMaterial):
        kind = matl.KIND_GLASS

        def trace(self, surface, ray_set):
            return ray_set

        def pure_trace(self, directions, normals, wavelength, index, intensity):
            return directions, index, intensity

    lens = comp.thick_lens(1.0, -1.0, 0.25, aperture=0.5, material=Weird())
    scene = compile_scene([lens])
    assert not fused_trace.supports_fused(scene.spec)
    with pytest.raises(ValueError, match="non-packed"):
        fused_trace.build_fused_trace_fn(
            scene.spec, scene.materials, TraceConfig(), interpret=True
        )


@pytest.mark.parametrize("block", [128, 256, 512])
def test_block_sizes_give_identical_results(block):
    """The launch shape changes nothing in the outputs."""
    scene = _condenser()
    rays = _cone_rays(700)
    cfg = TraceConfig(generation_limit=6)
    ref = fused_trace.build_fused_trace_fn(
        scene.spec, scene.materials, cfg, interpret=True, block=128
    )(scene.params, rays)
    got = fused_trace.build_fused_trace_fn(
        scene.spec, scene.materials, cfg, interpret=True, block=block
    )(scene.params, rays)
    # the interpreter vectorizes each block size differently: last-bit
    # rounding only
    np.testing.assert_allclose(
        np.asarray(got.records), np.asarray(ref.records), rtol=1e-12, atol=1e-12
    )
    np.testing.assert_array_equal(
        np.asarray(got.record_mask), np.asarray(ref.record_mask)
    )


def test_block_must_be_a_power_of_two():
    scene = _condenser()
    assert fused_trace.BLOCK & (fused_trace.BLOCK - 1) == 0
    with pytest.raises(ValueError, match="power of two"):
        fused_trace.build_fused_trace_fn(
            scene.spec, scene.materials, TraceConfig(), interpret=True, block=96
        )


def test_f32_parity_within_the_smoke_tolerance():
    """At f32 the kernel and the engine round differently; the disagreement
    must stay inside the rule chip_smoke.py applies on the card."""
    scene = _condenser()
    with jax.enable_x64(False):
        rays = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float32), _cone_rays(512)
        )
        params = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float32)
            if jnp.issubdtype(x.dtype, jnp.floating) else x,
            scene.params,
        )
        cfg = TraceConfig(generation_limit=6)
        rx = engine.build_trace_fn(scene.spec, scene.materials, cfg)(params, rays)
        rf = fused_trace.build_fused_trace_fn(
            scene.spec, scene.materials, cfg, interpret=True
        )(params, rays)
        assert rf.records.dtype == jnp.float32
        mx, mf = np.asarray(rx.record_mask), np.asarray(rf.record_mask)
        err = np.where(
            (mx & mf)[:, None, :],
            np.abs(np.asarray(rx.records) - np.asarray(rf.records)), 0.0,
        )[:, 6:].max(axis=(0, 1))
    disagree = (mx != mf).any(axis=0) | (err > 1e-4)
    assert disagree.mean() <= 1e-3


class TestDispatch:
    """pick_fused: the kernel runs only on the GPU, for f32 traces of
    supported scenes; use_fused=True raises anywhere else."""

    def test_cpu_never_picks_the_kernel(self):
        scene = _condenser()
        assert jax.default_backend() == "cpu"
        assert not fused_trace.pick_fused(scene.spec, TraceConfig())
        assert not fused_trace.pick_fused(scene.spec, TraceConfig(use_fused=False))
        with pytest.raises(ValueError, match="use_fused=True"):
            fused_trace.pick_fused(scene.spec, TraceConfig(use_fused=True))

    def test_gpu_picks_the_kernel_for_f32_supported_scenes(self, monkeypatch):
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        scene = _condenser()
        assert fused_trace.pick_fused(scene.spec, TraceConfig(), itemsize=4)
        assert fused_trace.pick_fused(scene.spec, TraceConfig(use_fused=True))
        assert not fused_trace.pick_fused(scene.spec, TraceConfig(use_fused=False))
        # f64 rays stay on the XLA engine; forcing them raises
        assert not fused_trace.pick_fused(scene.spec, TraceConfig(), itemsize=8)
        with pytest.raises(ValueError, match="f32"):
            fused_trace.pick_fused(scene.spec, TraceConfig(use_fused=True), itemsize=8)

    def test_gpu_declines_wide_and_union_scenes(self, monkeypatch):
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        lenslets = comp.microlens_array(2.0, 0.25, 5, 5, 1.0)
        wide = compile_scene(lenslets + [comp.baffle((10.0, 10.0)).move_x(4.0)])
        assert wide.spec.n_leaves > 32
        blob = csg.union(Sphere(1.0), Sphere(1.0).move_x(1.2))
        union = compile_scene([blob])
        for scene in (wide, union):
            assert not fused_trace.pick_fused(scene.spec, TraceConfig())
            with pytest.raises(ValueError):
                fused_trace.pick_fused(scene.spec, TraceConfig(use_fused=True))

    def test_trace_rays_dispatch_respects_config(self, monkeypatch):
        """use_fused=False routes to the XLA engine; on a (faked) GPU the
        auto rule routes a supported scene to the kernel builder."""
        scene = _condenser()
        rays = _cone_rays(16)
        cfg = TraceConfig(generation_limit=3, fixed_loop=True, use_fused=False)
        r = engine.trace_rays(scene, rays, cfg)
        assert np.asarray(r.record_mask).any()

        built = []
        real_build = fused_trace.build_fused_trace_fn

        def fake_build(spec, materials, config):
            built.append(spec)
            return real_build(spec, materials, config, interpret=True)

        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setattr(fused_trace, "build_fused_trace_fn", fake_build)
        f32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), rays)
        r = engine.trace_rays(scene, f32, TraceConfig(generation_limit=3))
        assert built == [scene.spec]
        assert np.asarray(r.record_mask).any()

    def test_sharded_trace_dispatch(self, monkeypatch):
        """The sharded forward path follows the same rule."""
        from pyrayt_tpu.parallel import default_mesh
        from pyrayt_tpu.parallel.trace import build_sharded_trace_fn

        scene = _condenser()
        mesh = default_mesh(n_devices=4, n_hosts=1)
        with pytest.raises(ValueError, match="use_fused=True"):
            build_sharded_trace_fn(scene, TraceConfig(), mesh, use_fused=True)
        fn = build_sharded_trace_fn(scene, TraceConfig(generation_limit=3), mesh)
        rays = _cone_rays(32)
        out = fn(scene.params, rays)
        assert np.asarray(out.record_mask).any()


@pytest.fixture()
def gpu():
    """The GPU device, or a skip where JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run the gpu-marked tests on the card)")
    return jax.devices()[0]


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_the_gpu(gpu):
    scene = _condenser()
    with jax.enable_x64(False):
        tracer = pyrayt.RayTracer(
            comp.ConeOfRays(cone_angle=10.0).move_x(-0.5),
            [comp.thick_lens(1.0, -1.0, 0.25, aperture=0.5, material=matl.glass["BK7"]),
             comp.baffle((1.0, 1.0)).move_x(1.0)],
            rays_per_source=1 << 16, generation_limit=6,
        )
        rays = tracer._initial_rays()
        scene = compile_scene(tracer.get_system())
        cfg = tracer.get_config()
        assert fused_trace.pick_fused(scene.spec, cfg)
        rf = fused_trace.build_fused_trace_fn(scene.spec, scene.materials, cfg)(
            scene.params, rays
        )
        rx = engine.build_trace_fn(scene.spec, scene.materials, cfg)(scene.params, rays)
        mx, mf = np.asarray(rx.record_mask), np.asarray(rf.record_mask)
        err = np.where(
            (mx & mf)[:, None, :],
            np.abs(np.asarray(rx.records) - np.asarray(rf.records)), 0.0,
        )[:, 6:].max(axis=(0, 1))
    disagree = (mx != mf).any(axis=0) | (err > 1e-4)
    assert disagree.mean() <= 1e-3
