"""Sharded trace execution and the distributed training (optimization) step.

Two entry points:

* :func:`sharded_trace` / :func:`build_sharded_trace_fn` — the forward
  path: one jitted program whose ray-axis inputs/outputs are sharded over
  the mesh.  Because rays are independent, XLA partitions the whole trace
  with zero communication; the per-shard program is identical to the
  single-device one.

* :func:`build_train_step` — the "training step" of this domain: one
  gradient-descent update of the differentiable scene parameters (lens
  curvatures, positions, glass coefficients) against a trace-derived loss
  (e.g. RMS spot size).  Rays are sharded (DP), parameters replicated, and
  the loss/grad reductions psum over the mesh — the exact layout SURVEY.md
  §2.3 prescribes (the gradient all-reduce is O(10-100) scalars:
  latency-bound).

Pipeline/expert parallelism are deliberate non-goals (SURVEY.md §2.3): the
bounce loop is a short sequential ``lax.scan`` and material dispatch is a
branch-free masked select, so there is nothing to pipeline or route.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pyrayt_tpu.config import TraceConfig
from pyrayt_tpu.scene.compile import CompiledScene
from pyrayt_tpu.tracer import engine
from pyrayt_tpu.tracer.rayset import RaySet
from pyrayt_tpu.parallel.mesh import pad_rayset, rayset_sharding, shard_rayset

__all__ = ["build_sharded_trace_fn", "sharded_trace", "build_train_step"]


def build_sharded_trace_fn(
    scene: CompiledScene,
    config: TraceConfig,
    mesh: Mesh,
    use_fused: Optional[bool] = None,
    itemsize: int = 4,
):
    """Jit the trace with ray-axis input shardings pinned to ``mesh``.

    Returns ``fn(params, rays: RaySet) -> TraceResult`` whose record buffers
    stay sharded on device (fetch once at the end — SURVEY.md §7 stage 8).

    ``use_fused`` mirrors ``TraceConfig.use_fused``: where the dispatch rule
    (:func:`pyrayt_tpu.ops.fused_trace.pick_fused`) picks the fused GPU
    kernel, it runs under ``shard_map`` -- each shard traces its rays
    independently and only the ``generations_run`` scalar is max-reduced.
    Otherwise XLA partitions the engine from the sharding annotations.
    ``itemsize`` is the ray dtype's byte width (4 for f32, 8 for f64).
    """
    from pyrayt_tpu.ops import fused_trace as ft

    if use_fused is not None:
        config = TraceConfig(**{**config.__dict__, "use_fused": use_fused})
    if ft.pick_fused(scene.spec, config, itemsize):
        fused = ft.build_fused_trace_fn(scene.spec, scene.materials, config)
        return _shard_mapped(fused, scene, mesh)

    base = engine.build_trace_fn(scene.spec, scene.materials, config)
    replicated = NamedSharding(mesh, P())
    in_shardings = (
        jax.tree_util.tree_map(lambda _: replicated, scene.params),
        rayset_sharding(mesh),
    )
    return jax.jit(base, in_shardings=in_shardings)


def _shard_mapped(trace_fn, scene, mesh):
    """shard_map a single-device trace: per-shard traces, no collectives
    except the max of ``generations_run``."""
    axes = mesh.axis_names
    ray_spec = P(axes)
    vec_spec = P(None, axes)

    params_specs = jax.tree_util.tree_map(lambda _: P(), scene.params)
    rays_specs = RaySet(
        positions=vec_spec,
        directions=vec_spec,
        generation=ray_spec,
        intensity=ray_spec,
        wavelength=ray_spec,
        index=ray_spec,
        id=ray_spec,
    )
    result_specs = engine.TraceResult(
        records=P(None, None, axes),
        record_mask=P(None, axes),
        final_rays=rays_specs,
        generations_run=P(),
    )

    def local_trace(params, rays):
        result = trace_fn(params, rays)
        return result.replace(
            generations_run=jax.lax.pmax(result.generations_run, axes)
        )

    return jax.jit(
        jax.shard_map(
            local_trace,
            mesh=mesh,
            in_specs=(params_specs, rays_specs),
            out_specs=result_specs,
            # pallas_call outputs carry no varying-mesh-axes metadata, which
            # the replication checker requires; the out_specs are the truth
            check_vma=False,
        )
    )


def sharded_trace(
    scene: CompiledScene,
    rays: RaySet,
    config: TraceConfig,
    mesh: Optional[Mesh] = None,
) -> engine.TraceResult:
    """Trace ``rays`` with the ray axis sharded over ``mesh`` (or a default
    mesh over all devices).  Pads the ray count to the mesh size; padding
    rays are born dead and never reach the results frame."""
    from pyrayt_tpu.parallel.mesh import default_mesh

    if mesh is None:
        mesh = default_mesh()
    rays, _ = pad_rayset(rays, mesh.size)
    rays = shard_rayset(rays, mesh)
    itemsize = jnp.dtype(rays.positions.dtype).itemsize
    fn = build_sharded_trace_fn(scene, config, mesh, itemsize=itemsize)
    return fn(scene.params, rays)


def build_train_step(
    scene: CompiledScene,
    config: TraceConfig,
    mesh: Mesh,
    loss_fn: Callable[[engine.TraceResult], jnp.ndarray],
    learning_rate: float = 1e-2,
    param_filter: Optional[Callable[[dict], dict]] = None,
):
    """Build the jitted distributed optimization step.

    ``loss_fn(result) -> scalar`` consumes a TraceResult (e.g. RMS spot
    radius at a focal plane).  The returned ``step(params, rays)`` computes
    ``grad(loss ∘ trace)`` of the XLA scan engine with rays sharded over
    the mesh and applies one SGD update, returning ``(new_params, loss)``.
    All reductions (the scalar loss and every parameter gradient) are
    mesh-wide sums XLA inserts from the sharding annotations.

    ``param_filter`` masks which parameter pytree leaves receive updates
    (by zeroing gradient entries), e.g. to optimize only lens transforms.
    """
    cfg = TraceConfig(**{**config.__dict__, "fixed_loop": True})
    trace = engine.build_trace_fn(scene.spec, scene.materials, cfg)

    def loss_of(params, rays):
        return loss_fn(trace(params, rays))

    replicated = NamedSharding(mesh, P())

    def step(params, rays: RaySet):
        loss, grads = jax.value_and_grad(loss_of)(params, rays)
        if param_filter is not None:
            grads = param_filter(grads)
        new_params = jax.tree_util.tree_map(
            lambda p, g: p - learning_rate * g, params, grads
        )
        return new_params, loss

    in_shardings = (
        jax.tree_util.tree_map(lambda _: replicated, scene.params),
        rayset_sharding(mesh),
    )
    out_shardings = (
        jax.tree_util.tree_map(lambda _: replicated, scene.params),
        replicated,
    )
    return jax.jit(step, in_shardings=in_shardings, out_shardings=out_shardings)
