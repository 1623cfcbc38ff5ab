"""Smoke run of the tracer's main paths on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py               # phases a-f on one card
    python3 chip_smoke.py --four-cards  # phase g only, on four cards

Phases (each stops the run with a nonzero exit at its first failure):

a. device check: the default JAX device must be a GPU; prints the card's
   name and power limit (nvidia-smi) and the JAX version.
b. condenser forward: ``RayTracer.trace_device()`` at 2^20 rays, G=6, then
   the compact host fetch to numpy rows.
c. comparison: the fused kernel against the XLA engine on the card (2^20
   rays), and the XLA engine in f32 on the card against the XLA engine in
   f64 on the host CPU (first 2^16 rays).
d. trainer: ``optimize()`` steps of ``build_objective`` with the RMS-spot
   loss on the lens-design doublet at 2^20 rays; one gradient at 2^16 rays
   against ``jax.grad`` of the f64 CPU engine.
e. lenslet array: forward of the 16x16 microlens array (513 leaves, G=4)
   at 2^20 rays, and one ``remat=True`` gradient step at the largest
   power-of-two ray count whose compiled program fits the card.
f. the last line of standard output is one JSON object naming the device.
g. (``--four-cards``) ``parallel.build_train_step`` on a 1x4 mesh at 2^20
   condenser rays against the same step on one card.

Tolerances, and why:

* kernel vs XLA, both f32 on the card: a ray disagrees when its record
  mask differs in any generation or a recorded position or tilt differs by
  more than 1e-4; at most 0.1% of rays may disagree (a ray grazing an
  aperture edge or the critical angle can flip at f32).
* f32 card vs f64 CPU: the same rule.
* gradients, f32 card vs f64 CPU at 2^16 rays: relative error of the
  gradient vector (2-norm of the difference over 2-norm of the reference)
  at most 1e-2, and the losses agree to 1e-3 relative.
* four cards vs one: losses agree to 1e-5 relative; updated parameters to
  1e-5 relative to their largest magnitude (psum order differs).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(ROOT, "examples")

RAYS = 1 << 20
RAYS_REF = 1 << 16
POS_TILT_ATOL = 1e-4
MAX_DISAGREE = 1e-3
GRAD_RTOL = 1e-2
LOSS_RTOL = 1e-3


class SmokeFailure(RuntimeError):
    pass


def check(ok, message):
    if not ok:
        raise SmokeFailure(message)


def log(message):
    print(message, flush=True)


def block(tree):
    return jax.tree_util.tree_map(lambda x: x.block_until_ready(), tree)


def peak_bytes():
    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def bytes_limit():
    return int(jax.devices()[0].memory_stats()["bytes_limit"])


def timed(fn, *args):
    t0 = time.perf_counter()
    out = block(fn(*args))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# a. device check
# ---------------------------------------------------------------------------


def device_check(n_cards):
    devices = jax.devices()
    platform = devices[0].platform
    check(platform == "gpu", f"default JAX device is {platform!r}, not a GPU")
    check(len(devices) >= n_cards, f"need {n_cards} GPUs, JAX sees {len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"nvidia-smi: {smi}")
    log(f"jax {jax.__version__}; devices: {len(devices)} x {devices[0].device_kind}")
    from pyrayt_tpu.config import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------


def condenser():
    """Cone source -> BK7 biconvex lens -> absorbing detector."""
    from pyrayt_tpu import components as comp
    from pyrayt_tpu import materials as matl

    lens = comp.thick_lens(1.0, -1.0, 0.25, aperture=0.5, material=matl.glass["BK7"])
    detector = comp.baffle((1.0, 1.0)).move_x(1.0)
    source = comp.ConeOfRays(cone_angle=10.0).move_x(-0.5)
    return source, [lens, detector], detector


def disagreement(a, b, n=None):
    """Fraction of rays whose masks or recorded positions/tilts differ,
    and the largest position/tilt error over the agreeing rays."""
    ma, mb = np.asarray(a.record_mask)[..., :n], np.asarray(b.record_mask)[..., :n]
    ra = np.asarray(a.records, np.float64)[..., :n]
    rb = np.asarray(b.records, np.float64)[..., :n]
    both = ma & mb
    err = np.where(both[:, None, :], np.abs(ra[:, 6:15] - rb[:, 6:15]), 0.0)
    err = err.max(axis=(0, 1))
    bad = (ma != mb).any(axis=0) | (err > POS_TILT_ATOL)
    return float(bad.mean()), float(err[~bad].max(initial=0.0))


def cpu_f64(tree):
    cpu = jax.devices("cpu")[0]

    def move(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            x = x.astype(np.float64)
        return jax.device_put(x, cpu)

    return jax.tree_util.tree_map(move, tree)


# ---------------------------------------------------------------------------
# b + c. condenser forward and comparisons
# ---------------------------------------------------------------------------


def condenser_phases():
    import pyrayt_tpu as prt
    from pyrayt_tpu.config import TraceConfig
    from pyrayt_tpu.ops import fused_trace as ft
    from pyrayt_tpu.scene.compile import compile_scene
    from pyrayt_tpu.tracer import engine
    from pyrayt_tpu.tracer.frame import records_to_rows

    source, system, _ = condenser()
    tracer = prt.RayTracer(source, system, rays_per_source=RAYS, generation_limit=6)
    result, t_first = timed(tracer.trace_device)
    _, t_again = timed(tracer.trace_device)
    rows = records_to_rows(result.records, result.record_mask)
    mask_sum = int(np.asarray(result.record_mask).sum())
    check(rows.shape == (mask_sum, 15), f"fetched {rows.shape}, mask sum {mask_sum}")
    check(np.isfinite(rows).all(), "non-finite values in the fetched rows")
    check(mask_sum > RAYS, f"only {mask_sum} rows recorded for {RAYS} rays")
    log(
        f"b. condenser forward: {RAYS} rays, {int(result.generations_run)} "
        f"generations, {mask_sum} rows fetched; first call {t_first:.3f} s, "
        f"second {t_again:.4f} s; peak {peak_bytes()} B"
    )

    scene = compile_scene(system)
    rays = tracer._initial_rays()
    config = tracer.get_config()
    xla = engine.build_trace_fn(scene.spec, scene.materials, config)
    r_xla = block(xla(scene.params, rays))
    check(
        ft.pick_fused(scene.spec, config),
        "the dispatch rule did not pick the fused kernel for the condenser",
    )
    r_ker = block(ft.build_fused_trace_fn(scene.spec, scene.materials, config)(
        scene.params, rays
    ))
    frac, err = disagreement(r_ker, r_xla)
    log(
        f"c. kernel vs XLA on the card, {RAYS} rays: {frac:.2e} of rays "
        f"disagree (limit {MAX_DISAGREE}); max agreeing error {err:.2e}"
    )
    check(frac <= MAX_DISAGREE, "fused kernel disagrees with the XLA engine")

    sub = jax.tree_util.tree_map(lambda x: x[..., :RAYS_REF], rays)
    r32 = block(xla(scene.params, sub))
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        r64 = xla(cpu_f64(scene.params), cpu_f64(sub))
        frac, err = disagreement(r32, r64)
    log(
        f"c. XLA f32 on the card vs f64 on the CPU, {RAYS_REF} rays: "
        f"{frac:.2e} of rays disagree (limit {MAX_DISAGREE}); max agreeing "
        f"error {err:.2e}; peak {peak_bytes()} B"
    )
    check(frac <= MAX_DISAGREE, "f32 card trace disagrees with the f64 CPU trace")


# ---------------------------------------------------------------------------
# d. trainer
# ---------------------------------------------------------------------------


def doublet_objective(n_rays):
    sys.path.insert(0, EXAMPLES)
    import lens_design as ld

    from pyrayt_tpu.analysis import build_objective
    from pyrayt_tpu.analysis.metrics import RmsSpotRadius
    from pyrayt_tpu.config import TraceConfig
    from pyrayt_tpu.scene.objects import fresh_ids

    r0 = ld.doublet_radii_initial()
    signs = np.sign(r0)

    def build(log_mags):
        return ld.build_doublet(jnp.asarray(signs) * jnp.exp(log_mags))

    wavelengths = (0.45, 0.55, 0.6, 0.65)
    rays = ld.design_rays(n_radii=n_rays // len(wavelengths), wavelengths=wavelengths)
    theta0 = jnp.log(jnp.abs(jnp.asarray(r0)))
    with fresh_ids():
        imager_id = float(build(theta0)[-1].get_id())
    config = TraceConfig(generation_limit=8, fixed_loop=True)
    return build_objective(build, rays, RmsSpotRadius(imager_id), config), theta0


def trainer_phase():
    import optax

    from pyrayt_tpu.analysis import optimize

    objective, theta0 = doublet_objective(RAYS)
    t0 = time.perf_counter()
    _, history = optimize(objective, theta0, steps=5, optimizer=optax.adam(2e-3))
    t_steps = time.perf_counter() - t0
    check(np.isfinite(history).all(), f"non-finite loss: {history}")
    check(history[-1] < history[0], f"loss did not decrease: {history}")
    log(
        f"d. optimize: 5 steps at {RAYS} rays in {t_steps:.2f} s (compile "
        f"included); RMS spot {history[0]:.6f} -> {history[-1]:.6f} mm; "
        f"peak {peak_bytes()} B"
    )

    objective, theta0 = doublet_objective(RAYS_REF)
    loss32, g32 = block(jax.jit(jax.value_and_grad(objective))(theta0))
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        objective64, theta64 = doublet_objective(RAYS_REF)
        loss64, g64 = jax.jit(jax.value_and_grad(objective64))(theta64)
    g32, g64 = np.asarray(g32, np.float64), np.asarray(g64)
    check(np.isfinite(g32).all(), f"non-finite gradient {g32}")
    rel = float(np.linalg.norm(g32 - g64) / np.linalg.norm(g64))
    loss_rel = abs(float(loss32) - float(loss64)) / abs(float(loss64))
    log(
        f"d. gradient at {RAYS_REF} rays, f32 card vs f64 CPU: relative "
        f"error {rel:.2e} (limit {GRAD_RTOL}); loss relative error "
        f"{loss_rel:.2e} (limit {LOSS_RTOL})"
    )
    check(rel <= GRAD_RTOL, f"gradient {g32} disagrees with the f64 CPU {g64}")
    check(loss_rel <= LOSS_RTOL, f"loss {loss32} disagrees with the f64 CPU {loss64}")


# ---------------------------------------------------------------------------
# e. lenslet array
# ---------------------------------------------------------------------------


def lenslet_phase():
    sys.path.insert(0, EXAMPLES)
    import microlens_array as mla

    from pyrayt_tpu import components as comp
    from pyrayt_tpu.analysis.metrics import rms_spot_radius
    from pyrayt_tpu.config import TraceConfig
    from pyrayt_tpu.scene.compile import compile_scene
    from pyrayt_tpu.tracer import engine

    n = 16
    system, detector, _ = mla.build_system(n)
    scene = compile_scene(system)
    check(scene.spec.n_leaves == 513, f"{scene.spec.n_leaves} leaves, expected 513")
    span = n * mla.PITCH * 0.95
    source = comp.GridOfRays(span, span).move_x(-1.0)

    rays = source.generate_rays(RAYS)
    config = TraceConfig(generation_limit=4)
    result, t_first = timed(engine.trace_rays, scene, rays, config)
    _, t_again = timed(engine.trace_rays, scene, rays, config)
    on_detector = int(
        (np.asarray(result.record_mask)
         & (np.asarray(result.records[:, 5]) == detector.get_id())).sum()
    )
    check(on_detector > RAYS // 2, f"only {on_detector} of {RAYS} rays reached the detector")
    check(np.isfinite(np.asarray(result.records)).all(), "non-finite lenslet records")
    log(
        f"e. lenslet forward: {RAYS} rays, 513 leaves, {on_detector} on the "
        f"detector; first call {t_first:.3f} s, second {t_again:.4f} s; "
        f"peak {peak_bytes()} B"
    )
    del result

    grad_config = TraceConfig(generation_limit=4, fixed_loop=True, remat=True)
    fn = engine.build_trace_fn(scene.spec, scene.materials, grad_config)
    detector_id = float(detector.get_id())

    def loss(params, rays):
        return rms_spot_radius(fn(params, rays), detector_id)

    step = jax.jit(jax.value_and_grad(loss))
    limit = bytes_limit()
    n_rays = RAYS
    while True:
        rays = source.generate_rays(n_rays)
        compiled = step.lower(scene.params, rays).compile()
        mem = compiled.memory_analysis()
        need = (mem.temp_size_in_bytes + mem.argument_size_in_bytes
                + mem.output_size_in_bytes)
        log(f"e. remat gradient at {n_rays} rays needs {need} B of {limit} B")
        if need < 0.9 * limit:
            break
        check(n_rays > RAYS_REF, "no power-of-two ray count fits the card")
        n_rays //= 2
    (value, grads), t_step = timed(compiled, scene.params, rays)
    flat = np.concatenate([np.ravel(np.asarray(g)) for g in jax.tree_util.tree_leaves(grads)])
    check(np.isfinite(float(value)) and np.isfinite(flat).all(), "non-finite lenslet gradient")
    check(np.abs(flat).max() > 0, "all-zero lenslet gradient")
    log(
        f"e. lenslet remat gradient step: {n_rays} rays in {t_step:.3f} s; "
        f"RMS spot {float(value):.6f} mm; peak {peak_bytes()} B"
    )


# ---------------------------------------------------------------------------
# g. four cards
# ---------------------------------------------------------------------------


def four_card_phase():
    from pyrayt_tpu.analysis.metrics import rms_spot_radius
    from pyrayt_tpu.config import TraceConfig
    from pyrayt_tpu.parallel import build_train_step, default_mesh, shard_rayset
    from pyrayt_tpu.scene.compile import compile_scene

    source, system, detector = condenser()
    scene = compile_scene(system)
    rays = source.generate_rays(RAYS)
    config = TraceConfig(generation_limit=6)
    detector_id = float(detector.get_id())

    def loss_fn(result):
        return rms_spot_radius(result, detector_id)

    out = {}
    for cards in (1, 4):
        mesh = default_mesh(n_devices=cards, n_hosts=1)
        step = build_train_step(scene, config, mesh, loss_fn, learning_rate=1e-3)
        sharded = shard_rayset(rays, mesh)
        block(step(scene.params, sharded))
        times = []
        for _ in range(10):
            result, t = timed(step, scene.params, sharded)
            times.append(t)
        out[cards] = (result, float(np.median(times)))
        log(f"g. train step on {cards} card(s): median {out[cards][1] * 1e3:.3f} ms over 10")
    (p1, l1), t1 = out[1]
    (p4, l4), t4 = out[4]
    loss_rel = abs(float(l4) - float(l1)) / abs(float(l1))
    param_err = max(
        float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(np.asarray(a)).max(), 1e-30))
        for a, b in zip(jax.tree_util.tree_leaves(p1), jax.tree_util.tree_leaves(p4))
    )
    log(
        f"g. 4 cards vs 1: loss {float(l4):.8f} vs {float(l1):.8f} (relative "
        f"{loss_rel:.2e}); parameter error {param_err:.2e}; step "
        f"{t4 * 1e3:.3f} ms vs {t1 * 1e3:.3f} ms (speed-up {t1 / t4:.2f}x)"
    )
    check(loss_rel <= 1e-5, "four-card loss disagrees with one card")
    check(param_err <= 1e-5, "four-card parameters disagree with one card")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the four-card train-step comparison",
    )
    args = parser.parse_args()
    cards = 4 if args.four_cards else 1
    t0 = time.perf_counter()
    try:
        device_check(cards)
        if args.four_cards:
            four_card_phase()
        else:
            condenser_phases()
            trainer_phase()
            lenslet_phase()
    except SmokeFailure as failure:
        print(f"chip_smoke failed: {failure}", file=sys.stderr, flush=True)
        return 1
    dev = jax.devices()[0]
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
