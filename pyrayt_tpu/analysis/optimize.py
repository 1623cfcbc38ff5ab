"""Gradient-based lens design.

Replacement for the reference's scipy.optimize loop
(examples/lens_design.ipynb cells 28-33), which re-traced the whole system
per objective evaluation with finite-difference search directions.  Here the
objective — rebuild scene from parameters -> trace -> metric — is one jitted
differentiable program, so each optimizer step costs a single
forward+backward trace and runs entirely on device.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import jax

from pyrayt_tpu.config import TraceConfig
from pyrayt_tpu.scene.compile import compile_scene
from pyrayt_tpu.scene.objects import fresh_ids
from pyrayt_tpu.tracer import engine
from pyrayt_tpu.tracer.rayset import RaySet

__all__ = ["build_objective", "optimize"]


def build_objective(
    build_fn: Callable,
    rays: RaySet,
    loss_fn: Callable,
    config: Optional[TraceConfig] = None,
) -> Callable:
    """Differentiable objective ``theta -> scalar``.

    ``build_fn(theta)`` constructs the component list from a parameter
    pytree (builders accept traced values: curvatures, thicknesses, moves);
    ``loss_fn(result)`` maps the TraceResult to a scalar (see
    pyrayt_tpu.analysis.metrics).  Scene rebuilding happens inside the
    trace, under ``fresh_ids`` so the flattened scene spec — and therefore
    the compiled program — is identical every call (no recompilation).

    Gradients differentiate the XLA scan engine (``config.remat``
    trades recomputation for memory); ``fixed_loop`` is forced on.
    """
    config = config or TraceConfig(fixed_loop=True)
    if not config.fixed_loop:
        config = TraceConfig(**{**config.__dict__, "fixed_loop": True})

    def objective(theta):
        with fresh_ids():
            components = build_fn(theta)
            scene = compile_scene(components)
        trace = engine.build_trace_fn(scene.spec, scene.materials, config)
        return loss_fn(trace(scene.params, rays))

    return objective


def optimize(
    objective: Callable,
    theta0,
    steps: int = 100,
    optimizer=None,
    learning_rate: float = 1e-2,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 10,
) -> Tuple[object, List[float]]:
    """Minimize a differentiable objective with optax (default: adam).

    With ``checkpoint_path`` set, the loop persists
    ``(theta, optimizer state, step, loss history, best iterate)`` every
    ``checkpoint_every`` steps (and at the end) via
    :mod:`pyrayt_tpu.analysis.checkpoint`, and transparently resumes from an
    existing file — a killed-and-restarted run converges to the identical
    result (the update rule is deterministic).

    Returns ``(theta_best, loss_history)`` — the BEST-seen iterate, not the
    final one: trace-derived losses can have discrete spikes (a marginal
    ray flipping across a TIR/vignetting boundary moves the loss by orders
    of magnitude at f32), so the last iterate of an otherwise-converged run
    may sit on a spike while an earlier iterate is the real optimum.
    ``history`` still records the per-step losses (``min(history)`` is the
    returned iterate's loss).
    """
    import numpy as np
    import optax

    from pyrayt_tpu.analysis.checkpoint import restore_checkpoint, save_checkpoint

    if optimizer is None:
        optimizer = optax.adam(learning_rate)
    opt_state = optimizer.init(theta0)

    theta = theta0
    best_theta = theta0
    best_loss = float("inf")
    start = 0
    history: List[float] = []
    if checkpoint_path is not None:
        template = {
            "theta": theta0,
            "best_theta": theta0,
            "best_loss": float("inf"),
            "opt_state": opt_state,
            "step": 0,
            "history": np.zeros(steps),
        }
        saved = restore_checkpoint(checkpoint_path, template)
        if saved is not None:
            theta = saved["theta"]
            best_theta = saved["best_theta"]
            best_loss = float(saved["best_loss"])
            opt_state = saved["opt_state"]
            start = int(saved["step"])
            history = list(np.asarray(saved["history"])[:start])

    @jax.jit
    def step(theta, opt_state):
        loss, grads = jax.value_and_grad(objective)(theta)
        updates, opt_state = optimizer.update(grads, opt_state, theta)
        return optax.apply_updates(theta, updates), opt_state, loss

    def _save(i):
        padded = np.zeros(steps)
        padded[: len(history)] = history
        save_checkpoint(
            checkpoint_path,
            {
                "theta": theta,
                "best_theta": best_theta,
                "best_loss": best_loss,
                "opt_state": opt_state,
                "step": i,
                "history": padded,
            },
        )

    for i in range(start, steps):
        theta_in = theta
        theta, opt_state, loss = step(theta, opt_state)
        loss = float(loss)
        history.append(loss)
        if loss < best_loss:  # loss is evaluated at theta_in, pre-update
            best_theta, best_loss = theta_in, loss
        if checkpoint_path is not None and (i + 1) % checkpoint_every == 0:
            _save(i + 1)
    if checkpoint_path is not None and start < steps:
        _save(steps)
    return (best_theta if best_loss < float("inf") else theta), history
