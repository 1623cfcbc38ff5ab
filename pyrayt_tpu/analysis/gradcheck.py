"""Finite-difference gradient validation.

The reference has no gradients at all; FD-validated gradients are a
north-star requirement of this build (BASELINE.md).  This harness
compares ``jax.grad`` of any scalar loss over a parameter pytree against
central finite differences, leaf by leaf.
"""

from __future__ import annotations

from typing import Callable

import jax
import numpy as np

__all__ = ["finite_difference_grad", "check_gradients"]


def finite_difference_grad(fn: Callable, params, eps: float = 1e-5):
    """Central-difference gradient of scalar ``fn`` over a pytree.

    O(2 * n_params) evaluations — intended for the O(10-100) geometry /
    dispersion parameters of an optical system, not for large arrays.
    """
    flat, treedef = jax.tree_util.tree_flatten(params)
    flat = [np.asarray(leaf, dtype=np.float64) for leaf in flat]

    def eval_at(leaves):
        return float(fn(treedef.unflatten([np.asarray(l) for l in leaves])))

    grads = []
    for i, leaf in enumerate(flat):
        g = np.zeros_like(leaf)
        it = np.nditer(leaf, flags=["multi_index"])
        while not it.finished:
            idx = it.multi_index
            bumped = [l.copy() for l in flat]
            bumped[i][idx] += eps
            f_plus = eval_at(bumped)
            bumped[i][idx] -= 2 * eps
            f_minus = eval_at(bumped)
            g[idx] = (f_plus - f_minus) / (2 * eps)
            it.iternext()
        grads.append(g)
    return treedef.unflatten(grads)


def check_gradients(
    fn: Callable,
    params,
    eps: float = 1e-5,
    rtol: float = 1e-3,
    atol: float = 1e-6,
):
    """Compare ``jax.grad(fn)`` against finite differences.

    Returns ``(max_abs_err, max_rel_err)``; raises AssertionError with a
    per-leaf report when outside tolerance.
    """
    analytic = jax.grad(fn)(params)
    numeric = finite_difference_grad(fn, params, eps=eps)

    a_flat, _ = jax.tree_util.tree_flatten(analytic)
    n_flat, _ = jax.tree_util.tree_flatten(numeric)

    max_abs = 0.0
    max_rel = 0.0
    failures = []
    for i, (a, n) in enumerate(zip(a_flat, n_flat)):
        a = np.asarray(a, dtype=np.float64)
        n = np.asarray(n, dtype=np.float64)
        if not np.all(np.isfinite(a)):
            failures.append(f"leaf {i}: analytic gradient is non-finite: {a}")
            continue
        if not np.all(np.isfinite(n)):
            failures.append(f"leaf {i}: FD gradient is non-finite: {n}")
            continue
        abs_err = np.abs(a - n)
        rel_err = abs_err / np.maximum(np.abs(n), atol / rtol)
        max_abs = max(max_abs, float(abs_err.max(initial=0.0)))
        max_rel = max(max_rel, float(rel_err.max(initial=0.0)))
        bad = abs_err > atol + rtol * np.abs(n)
        if np.any(bad):
            failures.append(
                f"leaf {i}: {int(bad.sum())}/{bad.size} entries outside "
                f"tolerance (max abs {abs_err.max():.3e}, "
                f"analytic {a.ravel()[np.argmax(abs_err)]:.6e} vs "
                f"numeric {n.ravel()[np.argmax(abs_err)]:.6e})"
            )
    if failures:
        raise AssertionError("gradient check failed:\n" + "\n".join(failures))
    return max_abs, max_rel
