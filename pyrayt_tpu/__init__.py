"""pyrayt_tpu — a differentiable optical ray tracing framework in JAX.

A ground-up JAX/XLA re-design with the full capability surface of PyRayT
(the reference non-sequential optical ray tracer): lenses, mirrors and
prisms built by constructive solid geometry, dispersive Sellmeier glasses,
bundle sources, and a trace engine producing the same 15-column results
DataFrame — plus what the reference never had: end-to-end
differentiability (``jax.grad`` through a whole trace), single-program
batched execution on the GPU, and ray-axis sharding across device meshes.

Public namespace parity with ``pyrayt``:

    import pyrayt_tpu as pyrayt
    from pyrayt_tpu import components, materials
    tracer = pyrayt.RayTracer(sources, components_, rays_per_source=100)
    frame = tracer.trace()
"""

from pyrayt_tpu.config import TraceConfig
from pyrayt_tpu.core.homogeneous import (
    HomogeneousCoordinate,
    Point,
    Ray,
    Vector,
    bundle_of_rays,
    bundle_rays,
)
from pyrayt_tpu.tracer.rayset import RaySet
from pyrayt_tpu.tracer.tracer import RayTracer, pin
from pyrayt_tpu import components, materials, utils
from pyrayt_tpu.utils import lensmakers_equation, wavelength_to_rgb

__version__ = "0.1.0"

__all__ = [
    "RayTracer",
    "RaySet",
    "pin",
    "TraceConfig",
    "HomogeneousCoordinate",
    "Point",
    "Vector",
    "Ray",
    "bundle_of_rays",
    "bundle_rays",
    "components",
    "materials",
    "utils",
    "lensmakers_equation",
    "wavelength_to_rgb",
]
