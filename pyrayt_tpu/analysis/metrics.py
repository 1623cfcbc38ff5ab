"""On-device, differentiable trace metrics.

The reference's analysis layer is user-side Pandas filtering of the results
frame (examples/lens_design.ipynb cells 12-21; SURVEY.md §5.5).  These are
the same quantities as pure jnp functions of the on-device TraceResult, so
they compose with ``jax.grad`` / ``jit`` / sharding without a host sync —
the loss functions of the differentiable-design path.

Record rows follow the 15-column frame layout (engine.N_RECORD_COLS):
generation, intensity, wavelength, index, id, surface, x0, y0, z0,
x1, y1, z1, x_tilt, y_tilt, z_tilt.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

__all__ = [
    "RmsSpotRadius",
    "FocusError",
    "SoftFocusError",
    "COL",
    "surface_mask",
    "last_generation_mask",
    "masked_mean",
    "rms_spot_radius",
    "axis_intercepts",
    "focus_error",
    "spot_diagram_points",
    "smoothstep",
    "window_weights",
    "detector_weights",
    "weighted_mean",
    "soft_focus_error",
    "soft_rms_spot_radius",
]

COL = {
    name: i
    for i, name in enumerate(
        (
            "generation",
            "intensity",
            "wavelength",
            "index",
            "id",
            "surface",
            "x0",
            "y0",
            "z0",
            "x1",
            "y1",
            "z1",
            "x_tilt",
            "y_tilt",
            "z_tilt",
        )
    )
}


def surface_mask(result, surface_id) -> jnp.ndarray:
    """(G, n) mask of record rows that terminated on ``surface_id``."""
    return result.record_mask & (
        result.records[:, COL["surface"], :] == surface_id
    )


def last_generation_mask(result) -> jnp.ndarray:
    """(G, n) mask of each ray's final recorded segment (the notebook's
    ``generation == max(generation)`` imager filter, cell 12)."""
    mask = result.record_mask
    gen = jnp.cumsum(mask[::-1], axis=0)[::-1]
    return mask & (gen == 1)


def masked_mean(values, mask, axis=None):
    """Mean of ``values`` over ``mask`` (safe when the mask is empty)."""
    w = mask.astype(values.dtype)
    total = jnp.sum(w, axis=axis)
    return jnp.sum(values * w, axis=axis) / jnp.maximum(total, 1.0)


def spot_diagram_points(result, surface_id):
    """((G,n) y, (G,n) z, (G,n) mask) of hit points on a surface — the spot
    diagram raw data."""
    mask = surface_mask(result, surface_id)
    y = result.records[:, COL["y1"], :]
    z = result.records[:, COL["z1"], :]
    return y, z, mask


def rms_spot_radius(result, surface_id=None) -> jnp.ndarray:
    """RMS radial distance of hits from their centroid on a surface
    (or on every ray's final surface when ``surface_id`` is None)."""
    mask = (
        last_generation_mask(result)
        if surface_id is None
        else surface_mask(result, surface_id)
    )
    y = result.records[:, COL["y1"], :]
    z = result.records[:, COL["z1"], :]
    cy = masked_mean(y, mask)
    cz = masked_mean(z, mask)
    r2 = (y - cy) ** 2 + (z - cz) ** 2
    return jnp.sqrt(masked_mean(r2, mask))


def axis_intercepts(result, min_tilt: float = 1e-6, surface_id=None):
    """(values (G,n), mask (G,n)) of each final ray's x-axis intercept:
    ``x0 - x_tilt * y0 / y_tilt`` (lens_design.ipynb cell 12's focal-length
    estimator).

    Rays with ``|y_tilt| < min_tilt`` are masked out, not just exactly-zero
    ones: a near-axial ray's intercept is 0/0 noise at any precision, and
    at f32 the unfiltered division is so ill-conditioned that the MSE value
    swings by orders of magnitude with last-bit tilt differences (measured
    on the doublet example; the reference notebook ran f64 and a narrower
    fan).  ``min_tilt = 1e-6`` keeps every ray that carries real focal
    information for mm-scale optics; pass 0.0 for the raw estimator.

    ``surface_id`` restricts the estimate to rays whose segment terminates
    on that surface (the detector).  The default (None: each ray's final
    segment, the notebook's ``generation == max`` filter) admits rays that
    never reached the detector — edge-clipped or bounce-budget-exhausted
    paths whose "intercepts" are meaningless and, at f32, make the metric
    jump by orders of magnitude when a marginal ray flips in or out
    (measured on the doublet example).  Optimization objectives should
    pass the detector's id.
    """
    mask = (
        last_generation_mask(result)
        if surface_id is None
        else surface_mask(result, surface_id)
    )
    x0 = result.records[:, COL["x0"], :]
    y0 = result.records[:, COL["y0"], :]
    xt = result.records[:, COL["x_tilt"], :]
    yt = result.records[:, COL["y_tilt"], :]
    tilted = jnp.abs(yt) > min_tilt
    safe_yt = jnp.where(tilted, yt, 1.0)
    intercept = x0 - xt * y0 / safe_yt
    return jnp.where(mask & tilted, intercept, 0.0), mask & tilted


def focus_error(
    result, target_focus, min_tilt: float = 1e-6, surface_id=None
) -> jnp.ndarray:
    """Mean squared deviation of axis intercepts from a target focal plane
    (the notebook's ``doublet_performance`` objective, cell 28).  Pass the
    detector's ``surface_id`` for a vignetting-robust objective (see
    axis_intercepts)."""
    intercepts, mask = axis_intercepts(
        result, min_tilt=min_tilt, surface_id=surface_id
    )
    return masked_mean((intercepts - target_focus) ** 2, mask)


# ---------------------------------------------------------------------------
# Smooth (spike-free) objectives
#
# Trace-derived losses over hard masks have discrete spikes at f32: a
# marginal ray flipping across the detector edge (or the min_tilt cut)
# between two equally-valid compilations of the same math adds/removes a
# whole term from the mean and moves an intercept MSE by orders of
# magnitude (measured on the doublet — docs/design_notes.md).  The
# functions below replace the boolean masks with C1 weights that reach
# EXACTLY zero at the physical boundary, so the row vanishing from the
# record (the ray misses the detector entirely) is a continuous no-op on
# the loss instead of a cliff.  No reference counterpart: the notebook ran
# f64 scipy with a narrow fan and never met the cliff
# (/root/reference/examples/lens_design.ipynb cells 28-33).
# ---------------------------------------------------------------------------


def smoothstep(t):
    """C1 ramp: 0 for t<=0, t^2(3-2t) on [0,1], 1 for t>=1."""
    t = jnp.clip(t, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def window_weights(values, half_width, ramp):
    """Weight of a coordinate inside a symmetric window of half-width
    ``half_width``: 1 deep inside, smoothstep down over the last ``ramp``
    of the window, exactly 0 at (and beyond) the edge."""
    return smoothstep((half_width - jnp.abs(values)) / ramp)


def detector_weights(result, surface_id, half_widths, ramp):
    """(G, n) smooth detector weights: the hard ``surface_mask`` times a
    C1 falloff of the hit point (y1, z1) toward the detector edge.

    ``half_widths`` is the detector's (y, z) half-aperture; ``ramp`` is
    the falloff band width (same units).  Because the weight is exactly 0
    at the edge, a marginal ray leaving the detector changes the loss
    continuously — the moment its record row disappears its weight was
    already zero.
    """
    hy, hz = half_widths
    mask = surface_mask(result, surface_id)
    y = result.records[:, COL["y1"], :]
    z = result.records[:, COL["z1"], :]
    w = window_weights(y, hy, ramp) * window_weights(z, hz, ramp)
    return jnp.where(mask, w, 0.0)


def weighted_mean(values, weights, axis=None):
    """Weighted mean, safe when all weights are zero."""
    total = jnp.sum(weights, axis=axis)
    return jnp.sum(values * weights, axis=axis) / jnp.maximum(total, 1e-12)


def _soft_intercepts(result, tilt_ramp):
    """(intercepts, tilt weights): the axis_intercepts estimator with the
    hard ``min_tilt`` cut replaced by a smoothstep over
    ``[tilt_ramp[0], tilt_ramp[1]]`` of |y_tilt|.  The 1/y_tilt noise of a
    near-axial ray grows like 1/t while its weight falls smoothly to an
    exact 0 below tilt_ramp[0], so the product stays continuous."""
    t0, t1 = tilt_ramp
    x0 = result.records[:, COL["x0"], :]
    y0 = result.records[:, COL["y0"], :]
    xt = result.records[:, COL["x_tilt"], :]
    yt = result.records[:, COL["y_tilt"], :]
    w_tilt = smoothstep((jnp.abs(yt) - t0) / (t1 - t0))
    safe_yt = jnp.where(jnp.abs(yt) > t0, yt, t0)
    intercepts = x0 - xt * y0 / safe_yt
    return intercepts, w_tilt


def soft_focus_error(
    result,
    target_focus,
    surface_id,
    half_widths,
    ramp=None,
    tilt_ramp=(1e-6, 1e-5),
) -> jnp.ndarray:
    """Smooth counterpart of :func:`focus_error`: weighted MSE of axis
    intercepts from the target focal plane, with C1 vignetting weights at
    the detector edge and a C1 tilt cut.

    ``half_widths``: detector (y, z) half-aperture.  ``ramp`` defaults to
    10% of the smaller half-width.  Spike behavior measured on the doublet
    before/after in docs/design_notes.md.
    """
    hy, hz = half_widths
    if ramp is None:
        ramp = 0.1 * min(hy, hz)
    w = detector_weights(result, surface_id, (hy, hz), ramp)
    intercepts, w_tilt = _soft_intercepts(result, tilt_ramp)
    w = w * w_tilt
    return weighted_mean((intercepts - target_focus) ** 2, w)


# ---------------------------------------------------------------------------
# Loss descriptors: hashable, comparable objects that BEHAVE like the plain
# metric closures (call them on a TraceResult).  Their record cotangent is
# a closed-form function of the records plus a handful of global scalars,
# which is what a custom_vjp that never materializes the (G, 15, n)
# cotangent buffer would build on (ROADMAP).  Use them anywhere a loss_fn
# is accepted.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RmsSpotRadius:
    """``rms_spot_radius(result, surface_id)`` as a recognizable loss."""

    surface_id: float

    def __call__(self, result) -> jnp.ndarray:
        return rms_spot_radius(result, self.surface_id)


@dataclasses.dataclass(frozen=True)
class FocusError:
    """``focus_error(result, target, min_tilt, surface_id)`` as a
    recognizable loss."""

    target_focus: float
    surface_id: float
    min_tilt: float = 1e-6

    def __call__(self, result) -> jnp.ndarray:
        return focus_error(
            result,
            self.target_focus,
            min_tilt=self.min_tilt,
            surface_id=self.surface_id,
        )


@dataclasses.dataclass(frozen=True)
class SoftFocusError:
    """``soft_focus_error(result, target, surface_id, half_widths, ramp,
    tilt_ramp)`` as a recognizable loss — the spike-free objective AND the
    loss-fused backward, together.  ``ramp`` must be explicit (it is part
    of the loss definition the kernel differentiates)."""

    target_focus: float
    surface_id: float
    half_widths: tuple
    ramp: float
    tilt_ramp: tuple = (1e-6, 1e-5)

    def __call__(self, result) -> jnp.ndarray:
        return soft_focus_error(
            result,
            self.target_focus,
            self.surface_id,
            self.half_widths,
            ramp=self.ramp,
            tilt_ramp=self.tilt_ramp,
        )


def soft_rms_spot_radius(result, surface_id, half_widths, ramp=None):
    """Smooth counterpart of :func:`rms_spot_radius` on a detector:
    weighted RMS radius about the weighted centroid, C1 at the edge."""
    hy, hz = half_widths
    if ramp is None:
        ramp = 0.1 * min(hy, hz)
    w = detector_weights(result, surface_id, (hy, hz), ramp)
    y = result.records[:, COL["y1"], :]
    z = result.records[:, COL["z1"], :]
    cy = weighted_mean(y, w)
    cz = weighted_mean(z, w)
    r2 = (y - cy) ** 2 + (z - cz) ** 2
    return jnp.sqrt(weighted_mean(r2, w))
