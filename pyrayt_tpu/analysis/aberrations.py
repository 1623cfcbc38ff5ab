"""Host-side aberration analysis (reference notebook parity).

Same analyses as examples/lens_design.ipynb cells 12-21 — spherical /
chromatic aberration curves and a coma metric — packaged as library
functions (the reference ships them only as notebook cells).  These trace
on device and analyze the resulting frame with Pandas; for gradient-based
design use the on-device versions in pyrayt_tpu.analysis.metrics.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # pandas is imported where a frame is built
    import pandas as pd

__all__ = ["spherical_aberration", "chromatic_aberration", "coma"]


def _imager_rays(results: pd.DataFrame) -> pd.DataFrame:
    """Each ray's final recorded segment, restricted to the most common
    final surface (the imager).

    The notebook filters on ``generation == max(generation)`` (cell 12),
    which assumes every ray takes the same number of bounces; a single
    edge-grazing ray with one extra bounce (routine at float32) would then
    silently become the whole analysis.  Selecting per-ray final segments
    on the modal surface keeps the intent and is robust to path-length
    differences.
    """
    idx = results.groupby("id")["generation"].idxmax()
    final = results.loc[idx]
    imager_surface = final["surface"].mode().iloc[0]
    return final.loc[final["surface"] == imager_surface]


def _axis_intercept(rays: pd.DataFrame) -> np.ndarray:
    return np.asarray(
        -rays["x_tilt"] * rays["y0"] / rays["y_tilt"] + rays["x0"]
    )


def spherical_aberration(
    system, ray_origin: float, max_radius: float, sample_points: int = 11
) -> pd.DataFrame:
    """Focal length vs beam radius (lens_design.ipynb cell 12).

    Traces a line of rays offset to +y through ``system`` and computes each
    ray's x-axis intercept.  Returns columns ``radius``, ``focus``.
    """
    import pyrayt_tpu as prt
    from pyrayt_tpu import components

    source = (
        components.LineOfRays(0.9 * max_radius)
        .move_x(ray_origin)
        .move_y(max_radius / 2)
    )
    tracer = prt.RayTracer(source, system, rays_per_source=sample_points)
    results = tracer.trace()

    imager_rays = _imager_rays(results)
    intercept = _axis_intercept(imager_rays)
    radii = results.loc[
        np.logical_and(
            results["generation"] == 0, results["id"].isin(imager_rays["id"])
        )
    ]["y0"]
    import pandas as pd

    return pd.DataFrame({"radius": np.asarray(radii), "focus": intercept})


def chromatic_aberration(
    system, ray_origin: float, test_radius: float, wavelengths
) -> pd.DataFrame:
    """Focal length vs wavelength (lens_design.ipynb cell 15).

    Returns columns ``wavelength``, ``focus``.
    """
    import pyrayt_tpu as prt
    from pyrayt_tpu import components

    sources = [
        components.LineOfRays(0, wavelength=wave)
        .move_y(test_radius)
        .move_x(ray_origin)
        for wave in np.asarray(wavelengths)
    ]
    tracer = prt.RayTracer(sources, system, rays_per_source=1)
    results = tracer.trace()

    imager_rays = _imager_rays(results)
    import pandas as pd

    return pd.DataFrame(
        {
            "wavelength": np.asarray(imager_rays["wavelength"]),
            "focus": _axis_intercept(imager_rays),
        }
    )


def coma(system, ray_origin: float, max_radius: float, angle: float) -> float:
    """Mean squared tilt deviation of an off-axis fan (cell 20)."""
    import pyrayt_tpu as prt
    from pyrayt_tpu import components

    source = (
        components.LineOfRays(2 * max_radius)
        .rotate_x(90)
        .move_x(ray_origin)
        .rotate_z(angle)
    )
    tracer = prt.RayTracer(source, system, rays_per_source=11)
    results = tracer.trace()

    ray_set = _imager_rays(results)
    return float(
        np.mean(
            np.square(np.sin(ray_set["y_tilt"]) - np.sin(angle * np.pi / 180))
        )
    )
