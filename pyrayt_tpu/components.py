"""Optical component factories and ray sources.

Parity with pyrayt/components.py:13-662: the same CSG recipes (thick_lens,
mirrors, prism, baffle/aperture) and the same Source hierarchy, built on
the scene-builder objects.  All geometry math is jnp so factories can
be called with traced parameters inside ``jax.grad`` (differentiable lens
design) — wrap rebuilds in ``pyrayt_tpu.scene.fresh_ids()``.

Reference quirks deliberately fixed (documented deviations):

* ``biconvex_lens`` positioned its left sphere with the wrong radius when
  r1 != r2 (quirk Q2, components.py:185-186) — fixed here; ``thick_lens``
  remains the general path.
* ``_create_aperture``'s elliptical branch fell through returning None
  (quirk Q3, components.py:43-50) — fixed to return the scaled cylinder.
"""

from __future__ import annotations

import abc
from functools import lru_cache, wraps
from typing import Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

import pyrayt_tpu.materials as matl
from pyrayt_tpu.core.operations import safe_sqrt, transform_rays
from pyrayt_tpu.scene import csg
from pyrayt_tpu.scene._backend import is_traced, xp_for
from pyrayt_tpu.scene.objects import WorldObject
from pyrayt_tpu.scene.surfaces import Cuboid, Cylinder, Paraboloid, Sphere, XYPlane
from pyrayt_tpu.tracer.rayset import RaySet

__all__ = [
    "thick_lens",
    "biconvex_lens",
    "plano_convex_lens",
    "plane_mirror",
    "spherical_mirror",
    "elliptical_mirror",
    "parabolic_mirror",
    "equilateral_prism",
    "baffle",
    "aperture",
    "microlens_array",
    "Source",
    "LineOfRays",
    "GridOfRays",
    "CircleOfRays",
    "ConeOfRays",
    "WedgeOfRays",
    "Lamp",
    "StaticLamp",
]


def _lens(func):
    """Inject common lens kwargs and orient the optical axis to +X
    (parity: components.py:13-28)."""

    @wraps(func)
    def wrapper_function(*args, **kwargs):
        lens_arguments = {"aperture": 1, "material": matl.glass["ideal"]}
        lens_arguments.update(kwargs)
        return func(*args, **lens_arguments).rotate_y(90).rotate_x(90)

    return wrapper_function


def _mirror(func):
    """Inject common mirror kwargs (parity: components.py:232-247)."""

    @wraps(func)
    def wrapper_function(*args, **kwargs):
        mirror_arguments = {
            "aperture": 1,
            "material": matl.mirror,
            "off_axis": (0, 0),
        }
        mirror_arguments.update(kwargs)
        return func(*args, **mirror_arguments).rotate_y(90).rotate_x(90)

    return wrapper_function


def _create_aperture(aperture: Union[float, tuple], thickness):
    """Aperture solid: circular (float), rectangular (tuple>0), or
    elliptical (tuple<0).  Parity: components.py:31-53, with quirk Q3 fixed."""
    if not hasattr(aperture, "__len__"):
        return Cylinder(
            radius=aperture / 2, min_height=-thickness / 2, max_height=thickness / 2
        )
    if aperture[0] > 0 and aperture[1] > 0:
        min_corner = (-aperture[0] / 2, -aperture[1] / 2, -thickness / 2)
        max_corner = (aperture[0] / 2, aperture[1] / 2, thickness / 2)
        return Cuboid(min_corner, max_corner)
    if aperture[0] < 0 and aperture[1] < 0:
        shape = Cylinder(
            radius=abs(aperture[0]) / 2,
            min_height=-thickness / 2,
            max_height=thickness / 2,
        )
        return shape.scale_y(aperture[1] / aperture[0])
    raise TypeError(f"Could not deduce an aperture from {aperture}")


def _surface_sign(r, override=None, name="r"):
    """Static classification of a lens surface radius: +1, -1, or 0 (planar).

    The per-surface CSG choice (intersect vs difference, reference
    components.py:104-126) is *program structure*, so it must be known when
    the scene is compiled.  Concrete radii carry their own sign; traced radii
    (differentiable lens design) must state it via ``r1_sign``/``r2_sign`` —
    the optimizer then explores magnitudes within that fixed convexity.
    """
    if override is not None:
        if override not in (1, -1, 0):
            raise ValueError(f"{name}_sign must be +1, -1, or 0, got {override!r}")
        return override
    if is_traced(r):
        raise ValueError(
            f"{name} is a traced value; its sign selects the lens's CSG "
            f"structure, which must be static under jit/grad.  Pass "
            f"{name}_sign=+1 (curving toward +Z/-X) or {name}_sign=-1."
        )
    r = float(r)
    if not np.isfinite(r):
        return 0
    return 1 if r > 0 else -1


def _lens_full_thickness(
    r1, r2, thickness, aperture, s1=None, s2=None
) -> Tuple[float, float]:
    """Sag-extended aperture thickness + center shift for a thick lens
    (parity: components.py:130-163).  ``s1``/``s2`` are the static surface
    signs from :func:`_surface_sign` (inferred when omitted); the sag math
    itself is trace-safe."""
    if s1 is None:
        s1 = _surface_sign(r1, name="r1")
    if s2 is None:
        s2 = _surface_sign(r2, name="r2")
    if not hasattr(aperture, "__len__"):
        max_height = aperture / 2
    else:
        max_height = np.linalg.norm(aperture) / 2

    def _sag(r):
        # aperture-edge sag of a spherical cap; safe_sqrt keeps the backward
        # pass finite as |r| approaches the semi-aperture
        if is_traced(r, thickness):
            return jnp.abs(r) - safe_sqrt(r * r - max_height**2)
        return abs(r) - np.sqrt(max(r * r - max_height**2, 0.0))

    left_thickness = thickness / 2
    if s1 == -1:
        left_thickness = left_thickness + _sag(r1)

    right_thickness = thickness / 2
    if s2 == 1:
        right_thickness = right_thickness + _sag(r2)

    center_shift = right_thickness - left_thickness
    total_thickness = right_thickness + left_thickness
    return total_thickness, center_shift


@_lens
def thick_lens(r1: float, r2: float, thickness: float, **kwargs):
    """Thick lens with arbitrary surface curvature (sign convention per
    radius-of-curvature optics).  Parity: components.py:73-127.

    The first surface faces -X, the second +X; the aperture is in the YZ
    plane.  Pass ``np.inf`` for a planar surface.

    Differentiable design: ``r1``/``r2``/``thickness`` may be traced values
    (e.g. inside ``jax.grad``); because each surface's sign picks the CSG
    structure, traced radii additionally need static ``r1_sign=``/
    ``r2_sign=`` (+1 or -1, 0 for planar).  Magnitudes stay differentiable.
    """
    s1 = _surface_sign(r1, kwargs.pop("r1_sign", None), "r1")
    s2 = _surface_sign(r2, kwargs.pop("r2_sign", None), "r2")
    aperture_thickness, aperture_offset = _lens_full_thickness(
        r1, r2, thickness, kwargs.get("aperture"), s1, s2
    )

    lens = _create_aperture(kwargs.get("aperture"), aperture_thickness).move_z(
        aperture_offset / 2
    )
    lens.material = kwargs.get("material")

    if s1 != 0:
        left_side = Sphere(r1, material=kwargs.get("material")).move_z(
            r1 - thickness / 2
        )
        lens = (
            csg.intersect(lens, left_side)
            if s1 > 0
            else csg.difference(lens, left_side)
        )

    if s2 != 0:
        right_side = Sphere(r2, material=kwargs.get("material")).move_z(
            r2 + thickness / 2
        )
        lens = (
            csg.intersect(lens, right_side)
            if s2 < 0
            else csg.difference(lens, right_side)
        )

    return lens


@_lens
def biconvex_lens(r1: float, r2: float, thickness: float, **kwargs):
    """Biconvex thick lens (parity: components.py:166-198, with quirk Q2
    fixed: the left surface uses r1 for both its radius and position)."""
    aperture_shape = _create_aperture(kwargs.get("aperture"), thickness)
    left_side = Sphere(r1).move_z(r1 - thickness / 2)
    right_side = Sphere(r2).move_z(-(r2 - thickness / 2))

    material = kwargs.get("material")
    aperture_shape.material = material
    left_side.material = material
    right_side.material = material

    return csg.intersect(csg.intersect(left_side, right_side), aperture_shape)


@_lens
def plano_convex_lens(r: float, thickness: float, **kwargs):
    """Plano-convex lens: planar surface faces -X, sphere faces +X
    (parity: components.py:201-229)."""
    aperture_shape = _create_aperture(kwargs.get("aperture"), thickness)
    right_side = Sphere(r).move_z(-(r - thickness / 2))

    material = kwargs.get("material")
    aperture_shape.material = material
    right_side.material = material

    return csg.intersect(right_side, aperture_shape)


@_mirror
def plane_mirror(thickness: float, **kwargs):
    """Plane mirror, every side reflective (parity: components.py:250-266)."""
    off_axis = kwargs.get("off_axis")
    mirror_shape = _create_aperture(kwargs.get("aperture"), thickness).move(
        *off_axis, 0
    )
    mirror_shape.material = kwargs.get("material")
    return mirror_shape


@_mirror
def spherical_mirror(radius: float, thickness: float, **kwargs):
    """Spherical mirror; only the spherical surface reflects, sidewalls
    absorb (parity: components.py:269-321).  Focal point at (r/2, 0, 0).

    Differentiable design: ``radius``/``thickness`` may be traced; a traced
    radius needs a static ``radius_sign=`` (+1 concave-toward--X / -1), the
    same structural-sign rule as thick_lens.
    """
    off_axis = kwargs.get("off_axis")
    material = kwargs.get("material")
    aperture_arg = kwargs.get("aperture")

    sign = _surface_sign(radius, kwargs.pop("radius_sign", None), "radius")
    if sign == 0:
        raise ValueError("spherical_mirror radius must be finite and nonzero")

    l = np.sqrt(off_axis[0] ** 2 + off_axis[1] ** 2)
    if hasattr(aperture_arg, "__len__"):
        dl = np.linalg.norm(aperture_arg) / 2
    else:
        dl = aperture_arg / 2

    if is_traced(radius, thickness):
        r_abs = jnp.abs(radius)
        aperture_front_thickness = r_abs - safe_sqrt(radius * radius - (l + dl) ** 2)
    else:
        r_abs = abs(radius)
        aperture_front_thickness = r_abs - np.sqrt(radius**2 - (l + dl) ** 2)
    total_thickness = aperture_front_thickness + thickness

    aperture_solid = _create_aperture(
        aperture_arg, thickness + aperture_front_thickness
    )
    aperture_solid.material = matl.absorber
    aperture_solid.move(*off_axis, 0)

    if sign > 0:
        mirror_surface = Sphere(radius, material=material).move_z(radius)
        aperture_solid.move_z(total_thickness / 2 - thickness)
    else:
        mirror_surface = Sphere(r_abs, material=material).move_z(radius)
        aperture_solid.move_z(thickness - total_thickness / 2)
    return csg.difference(aperture_solid, mirror_surface)


@_mirror
def elliptical_mirror(
    major_radius: float, minor_radius: float, thickness: float, **kwargs
):
    """Elliptical mirror: reflective prolate-spheroid surface on an
    absorbing aperture solid.

    The reference sketches this factory but ships it commented out
    (components.py:324-347); this completes that recipe.  Construction: a
    sphere of radius ``minor_radius`` scaled by ``major_radius /
    minor_radius`` along the major axis, vertex at the origin.  After the
    standard mirror rotations the optical axis is +X and the major axis
    lies along world Z, so the ellipsoid's center is at
    ``(minor_radius, 0, 0)`` and its two foci sit at ``(minor_radius, 0,
    +-sqrt(major_radius**2 - minor_radius**2))`` — rays emitted from one
    focus reflect through the other (pinned by
    tests/test_tracer/test_components.py).
    """
    off_axis = kwargs.get("off_axis")
    material = kwargs.get("material")
    aperture_arg = kwargs.get("aperture")
    if major_radius < minor_radius:
        raise ValueError("major_radius must be >= minor_radius")

    aperture_thickness = thickness + minor_radius
    aperture_solid = _create_aperture(aperture_arg, aperture_thickness)
    aperture_solid.material = matl.absorber
    aperture_solid.move(*off_axis, 0)
    aperture_solid.move_z(minor_radius / 2 - thickness)

    mirror_surface = Sphere(minor_radius, material=material)
    mirror_surface.scale_y(major_radius / minor_radius)
    mirror_surface.move_z(minor_radius)
    return csg.difference(aperture_solid, mirror_surface)


@_mirror
def parabolic_mirror(focus: float, thickness: float, **kwargs):
    """Parabolic mirror with its focus at the origin
    (parity: components.py:350-398)."""
    off_axis = kwargs.get("off_axis")
    material = kwargs.get("material")
    aperture_arg = kwargs.get("aperture")

    if hasattr(aperture_arg, "__len__"):
        furthest_point = np.linalg.norm(
            np.abs(np.asarray(off_axis)) + np.asarray(aperture_arg) / 2
        )
    else:
        furthest_point = np.linalg.norm(np.asarray(off_axis)) + aperture_arg

    front_thickness = 1 / (4 * focus) * furthest_point**2
    total_thickness = thickness + front_thickness

    aperture_shape = _create_aperture(aperture_arg, total_thickness).move(
        *off_axis, 0
    )
    aperture_shape.material = matl.absorber
    aperture_shape.move_z(total_thickness / 2 - thickness)

    mirror_surface = Paraboloid(
        focus, height=1.5 * front_thickness, material=material
    )
    mirror_shape = csg.difference(aperture_shape, mirror_surface)
    mirror_shape.move_z(-focus)
    return mirror_shape


def equilateral_prism(
    side_length: float,
    width: float,
    material: matl.TracableMaterial = None,
):
    """Equilateral prism: triangular faces parallel to YZ, base parallel to
    XY (parity: components.py:401-436).  Default material BK7."""
    if material is None:
        material = matl.glass["BK7"]
    cut_length = 1.1 * side_length / np.sin(60 * np.pi / 180)

    prism = csg.difference(
        csg.difference(
            Cuboid.from_sides(side_length, width, side_length, material=material),
            Cuboid.from_sides(cut_length, 1.1 * width, cut_length, material=material)
            .move(-cut_length / 2, 0, cut_length / 2)
            .rotate_y(30)
            .move(-side_length / 2, 0, -side_length / 2),
        ),
        Cuboid.from_sides(cut_length, 1.1 * width, cut_length, material=material)
        .move(cut_length / 2, 0, cut_length / 2)
        .rotate_y(-30)
        .move(side_length / 2, 0, -side_length / 2),
    ).move_z(side_length / 2 * (1 - np.sin(60 * np.pi / 180)))
    return prism


def baffle(aperture: Union[float, Tuple[float, float]]):
    """Planar baffle absorbing all intersecting rays, coplanar to YZ
    (parity: components.py:439-448)."""
    return XYPlane(aperture[0], aperture[1], material=matl.absorber).rotate_y(90)


def aperture(
    size: Union[float, Tuple[float, float]],
    aperture_size: Union[float, Tuple[float, float]],
):
    """Planar baffle with a central transmitting opening
    (parity: components.py:451-468)."""
    aperture_stop = baffle(size).rotate_y(-90)
    opening = _create_aperture(aperture_size, thickness=0.1)
    return csg.difference(aperture_stop, opening).rotate_y(90).rotate_x(-90)


def microlens_array(
    r: float,
    thickness: float,
    nx: int,
    ny: int,
    pitch: float,
    aperture: float = None,
    material=None,
):
    """``ny x nx`` grid of plano-convex lenslets in the YZ plane, optical
    axes +X, centered on the origin.  Returns the component list.

    An extra with no factory counterpart in the reference — there a
    user would loop ``plano_convex_lens(...).move_y(...).move_z(...)``
    over the arbitrary-component-list trace loop
    (/root/reference/pyrayt/_pyrayt.py:377-392).  Here every lenslet shares
    one CSG shape, so the engine's wide-scene path batches the whole array
    into a single (trees x rays) sweep (tracer/engine.py), keeping compile
    time flat in the lenslet count.

    ``r`` may be a traced value for differentiable lenslet design — either
    one shared radius (scalar) or ``ny * nx`` independent per-lenslet radii
    (a 1-D array/sequence in row-major ``(iy, ix)`` order): the freeform-
    array workload.  Per-lenslet values keep the lenslets batchable (the
    wide plan groups by CSG *shape*, not parameter values), and the
    gradient accumulates each lenslet's own cotangent
    (tests/test_tracer/test_wide_scenes.py).
    """
    if material is None:
        material = matl.glass["ideal"]
    if aperture is None:
        aperture = pitch

    def _r_of(i):
        import numpy as _np

        if _np.ndim(r) > 0:
            if len(r) != ny * nx:
                raise ValueError(
                    f"per-lenslet radii: expected {ny * nx} values, got {len(r)}"
                )
            return r[i]
        return r

    lenslets = []
    for iy in range(ny):
        for iz in range(nx):
            y = (iy - (ny - 1) / 2.0) * pitch
            z = (iz - (nx - 1) / 2.0) * pitch
            lenslets.append(
                plano_convex_lens(
                    _r_of(iy * nx + iz), thickness,
                    aperture=aperture, material=material,
                )
                .move_y(y)
                .move_z(z)
            )
    return lenslets


# ---------------------------------------------------------------------------
# Sources (parity: components.py:471-662)
# ---------------------------------------------------------------------------


class Source(WorldObject, abc.ABC):
    def __init__(self, wavelength=0.633, *args, **kwargs):
        """Base class for all sources (wavelength in microns)."""
        super().__init__(*args, **kwargs)
        self._wavelength = wavelength

    def generate_rays(self, n_rays: int) -> RaySet:
        """Generate rays, world-transformed with renormalized directions
        (parity: components.py:481-496)."""
        ray_set = self._local_ray_generation(n_rays)
        tx = jnp.asarray(self._world_coordinate_transform)
        # full-precision transform: the GPU's default f32 matmul precision
        # may be TF32, which would quantize every source position
        positions = transform_rays(tx, ray_set.positions)
        directions = transform_rays(tx, ray_set.directions)
        directions = directions / jnp.linalg.norm(directions, axis=0)
        return ray_set.replace(positions=positions, directions=directions)

    @abc.abstractmethod
    def _local_ray_generation(self, n_rays: int) -> RaySet:
        ...

    @property
    def wavelength(self):
        return self._wavelength

    @wavelength.setter
    def wavelength(self, value):
        self._wavelength = value


class LineOfRays(Source):
    def __init__(self, spacing=1, wavelength=0.633, *args, **kwargs):
        """n rays linearly spaced over ``spacing`` along local Y, all
        pointing +X (parity: components.py:511-530)."""
        super().__init__(wavelength, *args, **kwargs)
        self._spacing = spacing

    def _local_ray_generation(self, n_rays: int) -> RaySet:
        rayset = RaySet.create(n_rays, wavelength=self._wavelength)
        positions = rayset.positions
        if n_rays > 1:
            y = jnp.linspace(-self._spacing / 2, self._spacing / 2, n_rays)
            positions = positions.at[1].set(y)
        directions = rayset.directions.at[0].set(1.0)
        return rayset.replace(positions=positions, directions=directions)


class GridOfRays(Source):
    def __init__(self, width=1, height=1, wavelength=0.633, *args, **kwargs):
        """Parallel +X rays on a near-square grid spanning ``width`` (Y) x
        ``height`` (Z).  2-D analog of LineOfRays (an extra — the
        reference has no areal collimated source); rays fill the grid
        row-major, so ``n_rays`` need not be a perfect square."""
        super().__init__(wavelength, *args, **kwargs)
        self._width = width
        self._height = height

    def _local_ray_generation(self, n_rays: int) -> RaySet:
        rayset = RaySet.create(n_rays, wavelength=self._wavelength)
        k = int(np.ceil(np.sqrt(n_rays)))
        rows = int(np.ceil(n_rays / k))
        i = jnp.arange(n_rays)
        iy, iz = i // k, i % k
        y = (iy / max(rows - 1, 1) - 0.5) * self._width
        z = (iz / max(k - 1, 1) - 0.5) * self._height
        positions = rayset.positions.at[1].set(y).at[2].set(z)
        directions = rayset.directions.at[0].set(1.0)
        return rayset.replace(positions=positions, directions=directions)


class CircleOfRays(Source):
    def __init__(self, diameter=1, wavelength=0.633, *args, **kwargs):
        """Parallel +X rays uniformly placed on a circle in YZ
        (parity: components.py:533-558)."""
        super().__init__(wavelength, *args, **kwargs)
        self._diameter = diameter

    def _local_ray_generation(self, n_rays: int) -> RaySet:
        rayset = RaySet.create(n_rays, wavelength=self._wavelength)
        theta = jnp.linspace(0, 2 * jnp.pi, n_rays)
        positions = (
            rayset.positions.at[1]
            .set(self._diameter / 2 * jnp.sin(theta))
            .at[2]
            .set(self._diameter / 2 * jnp.cos(theta))
        )
        directions = rayset.directions.at[0].set(1.0)
        return rayset.replace(positions=positions, directions=directions)


class ConeOfRays(Source):
    def __init__(self, cone_angle: float, wavelength=0.633, *args, **kwargs):
        """Point source emitting a cone of rays at fixed polar angle about
        +X (parity: components.py:561-585)."""
        super().__init__(wavelength, *args, **kwargs)
        self._angle = cone_angle * np.pi / 180.0

    def _local_ray_generation(self, n_rays: int) -> RaySet:
        rayset = RaySet.create(n_rays, wavelength=self._wavelength)
        directions = rayset.directions
        if n_rays > 1:
            angles = 2 * jnp.pi * jnp.arange(0, n_rays) / n_rays
            directions = directions.at[1].set(
                jnp.sin(self._angle) * jnp.sin(angles)
            ).at[2].set(jnp.sin(self._angle) * jnp.cos(angles))
        directions = directions.at[0].set(jnp.cos(self._angle))
        return rayset.replace(directions=directions)


class WedgeOfRays(Source):
    def __init__(self, angle: float, wavelength=0.633, *args, **kwargs):
        """Point source fanning rays in the XY plane over [-angle/2, angle/2]
        (parity: components.py:588-613)."""
        super().__init__(wavelength, *args, **kwargs)
        self._angle = angle * np.pi / 180.0

    def _local_ray_generation(self, n_rays: int) -> RaySet:
        rayset = RaySet.create(n_rays, wavelength=self._wavelength)
        angles = jnp.linspace(-self._angle / 2, self._angle / 2, n_rays)
        directions = (
            rayset.directions.at[0].set(jnp.cos(angles)).at[1].set(jnp.sin(angles))
        )
        return rayset.replace(directions=directions)


class Lamp(Source):
    def __init__(
        self, width: float, length: float, max_angle: float = 90, seed=None, *args, **kwargs
    ) -> None:
        """Lambertian area source: random positions on a width x length
        rectangle, directions inverse-CDF sampled on the sphere cap,
        intensity = 100 cos(theta) (parity: components.py:616-654).

        Deviation: randomness uses JAX's counter-based PRNG with an
        explicit ``seed`` (reference uses global np.random state).
        """
        super().__init__(*args, **kwargs)
        self._max_angle = max_angle * np.pi / 180
        self._width = width
        self._length = length
        if seed is None:
            seed = np.random.randint(0, 2**31 - 1)
        self._key = jax.random.PRNGKey(seed)

    @property
    def prng_key(self):
        """The lamp's current PRNG key — save/restore it (e.g. through
        pyrayt_tpu.analysis.checkpoint) for deterministic Monte-Carlo
        replay of subsequent ``generate_rays`` calls."""
        return self._key

    @prng_key.setter
    def prng_key(self, key):
        self._key = jnp.asarray(key, dtype=jnp.uint32)

    def _next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def _local_ray_generation(self, n_rays: int) -> RaySet:
        rayset = RaySet.create(n_rays, wavelength=self._wavelength)
        key = self._next_key()
        k1, k2 = jax.random.split(key)
        uv = jax.random.uniform(k1, (2, n_rays))
        theta = jnp.arccos(1 - uv[0] * (1 - jnp.cos(self._max_angle)))
        phi = uv[1] * 2 * jnp.pi

        pos_uv = jax.random.uniform(k2, (2, n_rays))
        positions = (
            rayset.positions.at[1]
            .set(self._width * (pos_uv[0] - 0.5))
            .at[2]
            .set(self._length * (pos_uv[1] - 0.5))
        )
        directions = (
            rayset.directions.at[0]
            .set(jnp.cos(theta))
            .at[1]
            .set(jnp.sin(theta) * jnp.cos(phi))
            .at[2]
            .set(jnp.sin(theta) * jnp.sin(phi))
        )
        return rayset.replace(
            positions=positions,
            directions=directions,
            intensity=100.0 * jnp.cos(theta),
        )


class StaticLamp(Lamp):
    """A Lamp whose generated rays are cached per ``n_rays`` so repeated
    simulations see identical Monte-Carlo noise (parity: components.py:657-662)."""

    @lru_cache(10)
    def generate_rays(self, n_rays: int) -> RaySet:
        return super().generate_rays(n_rays)
