"""``TraceConfig(remat=True)`` recomputes each generation in the backward
pass instead of saving it: value and gradient must not change (scene zoo,
tests/test_tracer/zoo.py, f64)."""

import numpy as np
import pytest

import zoo


@pytest.mark.parametrize("name", list(zoo.SCENES))
def test_remat_matches_plain_gradient(name):
    v0, g0 = zoo.value_and_grad(name, remat=False)
    v1, g1 = zoo.value_and_grad(name, remat=True)
    np.testing.assert_allclose(float(v1), float(v0), rtol=1e-12)
    np.testing.assert_allclose(float(g1), float(g0), rtol=1e-9, atol=1e-12)
