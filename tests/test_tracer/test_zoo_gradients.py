"""Gradients of the XLA engine on the scene zoo (tests/test_tracer/zoo.py),
at f64: against central finite differences, and with ``remat`` on
against off."""

import jax
import numpy as np
import pytest

import zoo


@pytest.mark.parametrize("name", list(zoo.SCENES))
def test_gradient_matches_central_differences(name):
    loss, theta = zoo.objective(name)
    value, grad = jax.jit(jax.value_and_grad(loss))(theta)
    assert np.isfinite(float(value)) and float(value) > 0
    eps = 1e-6
    fd = (float(loss(theta + eps)) - float(loss(theta - eps))) / (2 * eps)
    assert abs(fd) > 1e-4, "theta must move the spot for this check to bite"
    assert abs(float(grad) - fd) <= 1e-4 * abs(fd), (float(grad), fd)
