"""A zoo of scenes for the XLA engine's tests (test_zoo_*.py).

Every gradient in the package is ``jax.grad`` of the XLA scan engine, so
that path is checked on the scenes where the physics branches: a folded
mirror path, total internal reflection in a prism, a dispersive doublet at
three wavelengths, 2x2 and 4x4 lenslet arrays, and a heterogeneous wall of
distinct lenses in three glasses.  Each scene is a builder of one scalar
design parameter ``theta``; the loss is the RMS spot radius (in y and z)
on its detector.
"""

import jax
import jax.numpy as jnp
import numpy as np

from pyrayt_tpu import components as comp
from pyrayt_tpu import materials as matl
from pyrayt_tpu.analysis import build_objective
from pyrayt_tpu.analysis.metrics import rms_spot_radius
from pyrayt_tpu.config import TraceConfig
from pyrayt_tpu.scene.compile import compile_scene
from pyrayt_tpu.scene.objects import fresh_ids
from pyrayt_tpu.tracer import engine
from pyrayt_tpu.tracer.rayset import concatenate


def ids(bundle):
    return bundle.replace(id=jnp.arange(bundle.n_rays, dtype=bundle.positions.dtype))


def mirror_fold(theta):
    """A BK7 lens focusing a line beam (along z) via a 45-degree
    plane-mirror fold onto a detector below; ``theta`` moves the lens
    along the axis."""
    lens = comp.thick_lens(
        2.0, -2.0, 0.25, aperture=1.0, material=matl.glass["BK7"]
    ).move_x(theta - 1.0)
    mirror = comp.plane_mirror(0.1, aperture=2.0).rotate_z(45)
    det = comp.baffle((4.0, 4.0)).rotate_z(90).move_y(-1.5)
    return [lens, mirror, det]


def tir_prism(theta):
    """A diverging beam entering a BK7 prism whose second face reflects
    it internally; ``theta`` moves the prism along the beam."""
    prism = comp.equilateral_prism(1.0, 1.0, material=matl.glass["BK7"]).rotate_y(
        -30
    ).move_x(theta)
    det = comp.baffle((20.0, 20.0)).move_x(5.0)
    return [prism, det]


def doublet(theta):
    """A cemented BK7/SF2 doublet; ``theta`` is the crown's front radius."""
    l1 = comp.thick_lens(
        theta, -3.0, 0.4, aperture=1.0, material=matl.glass["BK7"],
        r1_sign=1, r2_sign=-1,
    )
    l2 = comp.thick_lens(
        -3.0, -8.0, 0.15, aperture=1.0, material=matl.glass["SF2"],
        r1_sign=-1, r2_sign=-1,
    ).move_x(0.3)
    det = comp.baffle((4.0, 4.0)).move_x(5.0)
    return [l1, l2, det]


def lens_array(n):
    def build(theta):
        lenslets = comp.microlens_array(theta, 0.25, n, n, 1.0)
        det = comp.baffle((2.0 * n, 2.0 * n)).move_x(4.0)
        return lenslets + [det]

    return build


def hetero_wall(theta, n_elements=8, pitch=2.6):
    """``n_elements`` distinct biconvex lenses in three glasses side by
    side (one heterogeneous wide group); ``theta`` shifts the wall."""
    glasses = [matl.glass["BK7"], matl.glass["SF5"], matl.glass["SF2"]]
    rng = np.random.default_rng(0)
    elements = []
    for i in range(n_elements):
        r1 = 3.0 + 4.0 * rng.random()
        r2 = -(3.0 + 4.0 * rng.random())
        y = (i - (n_elements - 1) / 2.0) * pitch
        elements.append(
            comp.thick_lens(
                r1, r2, 0.3 + 0.2 * rng.random(),
                aperture=1.5 + rng.random(), material=glasses[i % 3],
            ).move_y(y).move_x(theta)
        )
    span = n_elements * pitch
    return elements + [comp.baffle((span, span)).move_x(6.0)]


def rays(name):
    if name == "mirror_fold":
        return ids(comp.LineOfRays(0.6).rotate_x(90).move_x(-2.5).generate_rays(48))
    if name == "tir_prism":
        return ids(comp.ConeOfRays(cone_angle=4.0).move_x(-2.0).generate_rays(48))
    if name == "doublet":
        return ids(concatenate(
            [comp.LineOfRays(0.6, wavelength=wl).move_x(-1.0).generate_rays(24)
             for wl in (0.45, 0.55, 0.65)]
        ))
    if name in ("lens_array_2x2", "lens_array_4x4"):
        span = 0.95 * (2 if name.endswith("2x2") else 4)
        return ids(comp.GridOfRays(span, span).move_x(-1.0).generate_rays(144))
    return ids(comp.GridOfRays(8 * 2.6 * 0.95, 1.0).move_x(-1.5).generate_rays(128))


# name -> (builder, theta0, generation limit)
SCENES = {
    "mirror_fold": (mirror_fold, 0.0, 6),
    "tir_prism": (tir_prism, 0.0, 8),
    "doublet": (doublet, 3.0, 6),
    "lens_array_2x2": (lens_array(2), 2.0, 4),
    "lens_array_4x4": (lens_array(4), 2.0, 4),
    "hetero_wall": (hetero_wall, 0.0, 4),
}


def objective(name, remat=False):
    build, theta0, generations = SCENES[name]
    with fresh_ids():
        det_id = float(build(jnp.asarray(theta0))[-1].get_id())
    config = TraceConfig(generation_limit=generations, fixed_loop=True, remat=remat)
    loss = build_objective(
        build, rays(name), lambda r: rms_spot_radius(r, det_id), config
    )
    return loss, jnp.asarray(theta0)


def clear_plans():
    """The wide plan is read while a trace function is traced, so both
    caches go when the grouping threshold changes."""
    engine._wide_plan.cache_clear()
    engine.build_trace_fn.cache_clear()


def trace(name):
    """The scene's records at ``theta0`` through a freshly built trace."""
    build, theta0, generations = SCENES[name]
    with fresh_ids():
        scene = compile_scene(build(jnp.asarray(theta0)))
    config = TraceConfig(generation_limit=generations, fixed_loop=True)
    fn = engine._build_trace_fn(scene.spec, scene.materials, config)
    return scene, fn(scene.params, rays(name))


def value_and_grad(name, remat=False):
    loss, theta = objective(name, remat=remat)
    return jax.jit(jax.value_and_grad(loss))(theta)
