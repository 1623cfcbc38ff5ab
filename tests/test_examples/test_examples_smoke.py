"""The shipped examples must run end to end (reference parity: the
reference ships examples/ scripts).

Smoke tier: tiny step counts, no display.  The physics each example prints
is separately pinned by tests/test_parity and tests/test_analysis.
"""

import os
import sys

import pytest

EXAMPLES_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "examples",
)
sys.path.insert(0, EXAMPLES_DIR)


def test_convex_collimator(capsys):
    import convex_collimator

    convex_collimator.main(show=False)
    out = capsys.readouterr().out
    assert "traced 150 segments" in out
    assert "True" in out


def test_chromatic_dispersion(capsys):
    import chromatic_dispersion

    chromatic_dispersion.main(show=False)
    out = capsys.readouterr().out
    assert out.count("->") >= 11


def test_lens_design_smoke(capsys):
    import lens_design

    lens_design.main(steps=3, show=False)
    out = capsys.readouterr().out
    assert "doublet" in out
    assert "optimized" in out


def test_reflective_beam_expander(capsys):
    import reflective_beam_expander

    reflective_beam_expander.main(show=False)
    out = capsys.readouterr().out
    assert "beam expansion: 4.000x" in out


def test_microlens_array_smoke(capsys):
    import microlens_array

    value, grad = microlens_array.main(n=4, n_rays=1024)
    out = capsys.readouterr().out
    assert "4x4 lenslets" in out
    assert value >= 0 and abs(grad) > 0
    import numpy as np

    assert np.isfinite(value) and np.isfinite(grad)


def test_lens_design_notebook_cells(capsys):
    """The shipped notebook's code cells execute end to end (reference
    parity: examples/lens_design.ipynb)."""
    import json

    import matplotlib

    matplotlib.use("Agg")
    path = os.path.join(EXAMPLES_DIR, "lens_design.ipynb")
    with open(path) as f:
        nb = json.load(f)
    src = "\n".join(
        "".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code"
    )
    src = src.replace("STEPS = 300", "STEPS = 2")  # smoke tier
    exec(compile(src, path, "exec"), {})
    out = capsys.readouterr().out
    assert "optimized radii:" in out
    assert "chromatic aberration reduced:" in out
