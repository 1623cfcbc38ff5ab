"""Sliced dtype-tight fetch for the trace()->DataFrame host edge.

The sliced path (fetch only the live generations, float32-cast on device)
must produce a frame identical (values, dtypes, row order) to the naive
full-buffer fetch — the reference DataFrame contract at
/root/reference/pyrayt/_pyrayt.py:147-186.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd

import pyrayt_tpu as pyrayt
from pyrayt_tpu import components as comp
from pyrayt_tpu import materials as matl
from pyrayt_tpu.tracer.frame import live_generations, records_to_dataframe


def _condenser_result(n_rays=64):
    lens = comp.thick_lens(
        r1=1.0, r2=-1.0, thickness=0.25, aperture=0.5, material=matl.glass["BK7"]
    )
    detector = comp.baffle((1.0, 1.0)).move_x(1.0)
    # wide cone: a good fraction of rays miss the lens and die early, so
    # the record buffer has both dead generations and dead rows
    source = comp.ConeOfRays(cone_angle=25.0).move_x(-0.5)
    tracer = pyrayt.RayTracer(
        source, [lens, detector], rays_per_source=n_rays, generation_limit=6
    )
    tracer.trace_device()
    return tracer._result


def test_sliced_frame_identical_to_naive():
    result = _condenser_result()
    naive = records_to_dataframe(result.records, result.record_mask, compact=False)
    sliced = records_to_dataframe(result.records, result.record_mask, compact=True)
    assert len(naive) > 0
    pd.testing.assert_frame_equal(naive, sliced)


def test_live_generations_counts_dead_tail():
    result = _condenser_result()
    g = live_generations(result.record_mask)
    assert g == int(result.generations_run)
    assert g < result.record_mask.shape[0]  # the dead tail is real


def test_sliced_empty_trace():
    records = jnp.zeros((3, 15, 8))
    mask = jnp.zeros((3, 8), dtype=bool)
    frame = records_to_dataframe(records, mask, compact=True)
    assert len(frame) == 0
    assert list(frame.columns) == list(
        records_to_dataframe(records, mask, compact=False).columns
    )


def test_float64_records_fetch_as_float32():
    result = _condenser_result()
    frame = records_to_dataframe(result.records, result.record_mask, compact=True)
    assert all(dt == np.float32 for dt in frame.dtypes)


def test_rows_match_the_frame_without_pandas():
    from pyrayt_tpu.tracer.frame import records_to_rows

    result = _condenser_result()
    rows = records_to_rows(result.records, result.record_mask)
    assert rows.dtype == np.float32
    assert rows.shape == (int(np.asarray(result.record_mask).sum()), 15)
    frame = records_to_dataframe(result.records, result.record_mask)
    np.testing.assert_array_equal(rows, frame.to_numpy())


def test_package_imports_without_flax_or_pandas():
    import subprocess
    import sys

    script = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('flax', 'pandas'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import pyrayt_tpu, pyrayt_tpu.analysis, pyrayt_tpu.parallel\n"
        "from pyrayt_tpu import components\n"
        "t = pyrayt_tpu.RayTracer(components.LineOfRays(), [components.baffle((1, 1)).move_x(1)])\n"
        "r = t.trace_device()\n"
        "from pyrayt_tpu.tracer.frame import records_to_rows\n"
        "print(records_to_rows(r.records, r.record_mask).shape)\n"
    )
    import os

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=repo, capture_output=True, text=True,
        timeout=240, env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "(10, 15)" in out.stdout
