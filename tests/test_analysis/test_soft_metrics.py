"""Smooth (spike-free) objectives.

The hard-mask metrics jump by orders of magnitude when a marginal ray
crosses the detector edge (the row enters/leaves the mean).  The soft
variants weight rays by a C1 ramp that reaches exactly zero at the edge,
so the same crossing moves the loss continuously.
"""

import jax
import jax.numpy as jnp
import numpy as np

import pyrayt_tpu as pyrayt
from pyrayt_tpu import components as comp
from pyrayt_tpu.analysis.metrics import (
    detector_weights,
    rms_spot_radius,
    smoothstep,
    soft_focus_error,
    soft_rms_spot_radius,
    surface_mask,
    weighted_mean,
    window_weights,
)


def test_smoothstep_shape():
    t = jnp.linspace(-1.0, 2.0, 301)
    s = smoothstep(t)
    assert float(s[0]) == 0.0 and float(s[-1]) == 1.0
    assert np.all(np.diff(np.asarray(s)) >= 0)  # monotone
    # C1: derivative vanishes at both ends of the ramp
    ds = jax.vmap(jax.grad(smoothstep))(jnp.asarray([0.0, 1.0, 0.5]))
    assert np.allclose(np.asarray(ds[:2]), 0.0, atol=1e-12)
    assert float(ds[2]) > 0


def test_window_weights_zero_at_edge_one_inside():
    w = window_weights(jnp.asarray([0.0, 0.3, 0.45, 0.5, 0.7]), 0.5, 0.1)
    assert float(w[0]) == 1.0 and float(w[1]) == 1.0
    assert 0.0 < float(w[2]) < 1.0
    assert float(w[3]) == 0.0 and float(w[4]) == 0.0


def _trace_wedge(angle_deg, detector):
    source = comp.WedgeOfRays(angle_deg)
    tracer = pyrayt.RayTracer(
        source, [detector], rays_per_source=9, generation_limit=2
    )
    return tracer.trace_device()


def test_soft_spot_radius_is_continuous_across_vignetting():
    """Sweep the wedge fan so the outermost rays cross the detector edge:
    the hard RMS must show a cliff; the soft RMS must not."""
    detector = comp.baffle((1.0, 1.0)).move_x(1.0)
    det_id = detector.get_id()
    # outer ray hits y = tan(a/2); edge at 0.5 -> crossing near 53.13 deg
    angles = np.linspace(52.0, 54.3, 24)
    hard, soft = [], []
    for a in angles:
        result = _trace_wedge(float(a), detector)
        hard.append(float(rms_spot_radius(result, det_id)))
        soft.append(
            float(soft_rms_spot_radius(result, det_id, (0.5, 0.5), ramp=0.05))
        )
    hard_steps = np.abs(np.diff(hard))
    soft_steps = np.abs(np.diff(soft))
    assert hard_steps.max() > 10 * np.median(hard_steps[hard_steps > 0])
    # soft metric: no step larger than a few times its typical increment
    assert soft_steps.max() < 5 * np.median(soft_steps[soft_steps > 0])
    assert soft_steps.max() < 0.2 * hard_steps.max()


def test_detector_weights_subset_of_hard_mask():
    detector = comp.baffle((1.0, 1.0)).move_x(1.0)
    result = _trace_wedge(40.0, detector)
    w = detector_weights(result, detector.get_id(), (0.5, 0.5), ramp=0.1)
    mask = surface_mask(result, detector.get_id())
    assert np.all((np.asarray(w) > 0) <= np.asarray(mask))
    assert float(jnp.max(w)) == 1.0  # axial rays fully weighted


def test_weighted_mean_empty_weights_safe():
    v = jnp.asarray([1.0, 2.0])
    assert float(weighted_mean(v, jnp.zeros(2))) == 0.0


def test_soft_focus_error_differentiable_through_trace():
    """grad of the soft objective through a full lens trace is finite."""
    from pyrayt_tpu import materials as matl
    from pyrayt_tpu.analysis import build_objective
    from pyrayt_tpu.config import TraceConfig
    from pyrayt_tpu.scene.objects import fresh_ids

    source = comp.WedgeOfRays(10.0).move_x(-1.0)
    rays = source.generate_rays(16)
    rays = rays.replace(id=jnp.arange(16, dtype=rays.positions.dtype))

    def build(theta):
        lens = comp.thick_lens(
            theta[0], -theta[1], 0.25, aperture=1.0,
            material=matl.glass["ideal"], r1_sign=1, r2_sign=-1,
        )
        det = comp.baffle((1.0, 1.0)).move_x(1.0)
        return [lens, det]

    with fresh_ids():
        det_id = float(build(jnp.asarray([2.0, 2.0]))[-1].get_id())

    objective = build_objective(
        build,
        rays,
        lambda r: soft_focus_error(r, 1.0, det_id, (0.5, 0.5)),
        TraceConfig(generation_limit=4, fixed_loop=True),
    )
    theta0 = jnp.asarray([2.0, 2.0])
    value, grads = jax.value_and_grad(objective)(theta0)
    assert np.isfinite(float(value))
    assert np.all(np.isfinite(np.asarray(grads)))
    assert np.any(np.asarray(grads) != 0)
