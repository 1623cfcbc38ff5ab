"""A train step with rays sharded over 4 devices against the same step on
one device, on every scene of the zoo (tests/test_tracer/zoo.py, f64)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "test_tracer"))

import zoo  # noqa: E402
from pyrayt_tpu.analysis.metrics import rms_spot_radius  # noqa: E402
from pyrayt_tpu.config import TraceConfig  # noqa: E402
from pyrayt_tpu.parallel import build_train_step, default_mesh, shard_rayset  # noqa: E402
from pyrayt_tpu.scene.compile import compile_scene  # noqa: E402
from pyrayt_tpu.scene.objects import fresh_ids  # noqa: E402


@pytest.mark.parametrize("name", list(zoo.SCENES))
def test_sharded_train_step_matches_single_device(name):
    build, theta0, generations = zoo.SCENES[name]
    with fresh_ids():
        components = build(jnp.asarray(theta0))
        det_id = float(components[-1].get_id())
        scene = compile_scene(components)
    rays = zoo.rays(name)
    config = TraceConfig(generation_limit=generations)

    def loss_fn(result):
        return rms_spot_radius(result, det_id)

    out = []
    for n_devices in (1, 4):
        mesh = default_mesh(n_devices=n_devices, n_hosts=1)
        step = build_train_step(scene, config, mesh, loss_fn, learning_rate=1e-2)
        out.append(step(scene.params, shard_rayset(rays, mesh)))
    (p1, l1), (p4, l4) = out
    np.testing.assert_allclose(float(l4), float(l1), rtol=1e-12)
    for key in p1:
        np.testing.assert_allclose(
            np.asarray(p4[key]), np.asarray(p1[key]), rtol=1e-10, atol=1e-13,
            err_msg=f"params[{key!r}] update differs",
        )
    assert any(
        np.abs(np.asarray(p1[key]) - np.asarray(scene.params[key])).max() > 0
        for key in p1
    ), "the step must move some parameter"
