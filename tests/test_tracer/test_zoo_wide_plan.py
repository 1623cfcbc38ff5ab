"""The batched wide plan (engine._wide_plan) against the per-leaf unrolled
path on the scene zoo (tests/test_tracer/zoo.py, f64).

``_WIDE_GROUP_MIN`` is forced to 1 (every interval tree batches, even
alone in its shape) and to "never" (every tree unrolls); records must
agree everywhere, and gradients on the scenes whose unrolled gradient
compiles in seconds on a CPU.
"""

import numpy as np
import pytest

import zoo
from pyrayt_tpu.tracer import engine


def _with_group_min(monkeypatch, value, fn):
    monkeypatch.setattr(engine, "_WIDE_GROUP_MIN", value)
    zoo.clear_plans()
    try:
        return fn()
    finally:
        monkeypatch.undo()
        zoo.clear_plans()


@pytest.mark.parametrize("name", list(zoo.SCENES))
def test_wide_plan_matches_unrolled(name, monkeypatch):
    def run():
        scene, result = zoo.trace(name)
        return bool(engine._wide_plan(scene.spec)[1]), result

    batched, grouped = _with_group_min(monkeypatch, 1, run)
    any_group, unrolled = _with_group_min(monkeypatch, 10**9, run)
    assert batched and not any_group
    np.testing.assert_array_equal(
        np.asarray(grouped.record_mask), np.asarray(unrolled.record_mask)
    )
    mask = np.asarray(unrolled.record_mask)[:, None, :]
    assert mask.any()
    np.testing.assert_allclose(
        np.asarray(grouped.records) * mask, np.asarray(unrolled.records) * mask,
        rtol=1e-10, atol=1e-10,
    )


@pytest.mark.parametrize(
    "name", ["mirror_fold", "tir_prism", "doublet", "lens_array_2x2"]
)
def test_wide_plan_gradient_matches_unrolled(name, monkeypatch):
    v_g, g_g = _with_group_min(monkeypatch, 1, lambda: zoo.value_and_grad(name))
    v_u, g_u = _with_group_min(monkeypatch, 10**9, lambda: zoo.value_and_grad(name))
    np.testing.assert_allclose(float(v_g), float(v_u), rtol=1e-10)
    np.testing.assert_allclose(float(g_g), float(g_u), rtol=1e-8, atol=1e-12)
