"""Forward-trace benchmark on one NVIDIA GPU: fused kernel against XLA.

Times ``engine.trace_rays`` end to end (dispatch to ``block_until_ready``)
on two narrow scenes, with the fused Pallas kernel (``use_fused=True``)
and the XLA engine (``use_fused=False``) called in turns in one process:

* ``condenser`` -- cone source, BK7 biconvex lens, detector; 2^20 rays,
  generation limit 6;
* ``imager`` -- the lens-design notebook's imager: five circular beams
  through a BK7 singlet and an f-stop onto a detector; 5 x 2^18 rays,
  generation limit 10.

Each scene is warmed up (compile excluded), then timed ``--repeats`` times
per engine; the medians and spreads are printed.  ``--sweep`` also times
the kernel at several ray-block sizes and warp counts on each scene.

Run from the repository root:  python3 bench.py [--repeats 20] [--sweep]

Prints one JSON object per line; each names the device (platform,
``device_kind``, count) and the card's name and power limit from
nvidia-smi.  Exits nonzero when JAX finds no GPU: a CPU time is not a
measurement of this system.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import jax
import numpy as np


def device_stamp():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX's default device is {dev.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "nvidia_smi": smi,
        "jax": jax.__version__,
    }


def condenser():
    from pyrayt_tpu import components as comp
    from pyrayt_tpu import materials as matl

    lens = comp.thick_lens(1.0, -1.0, 0.25, aperture=0.5, material=matl.glass["BK7"])
    detector = comp.baffle((1.0, 1.0)).move_x(1.0)
    return [comp.ConeOfRays(cone_angle=10.0).move_x(-0.5)], [lens, detector], 1 << 20, 6


def imager():
    from pyrayt_tpu import components as comp
    from pyrayt_tpu import materials as matl

    diameter = 25.4
    glass = matl.glass["BK7"]
    radius = 2 * (float(glass.index_at(0.532)) - 1) * 50.0
    lens = comp.thick_lens(radius, -radius, 5.0, aperture=diameter, material=glass)
    stop = comp.aperture(size=(diameter, diameter), aperture_size=3.0).move_x(25.0)
    detector = comp.baffle((diameter, diameter)).move_x(50.0)
    sources = [
        comp.CircleOfRays(x).move_x(-10) for x in np.linspace(0.1, 0.5, 5) * diameter
    ]
    return sources, [lens, stop, detector], 1 << 18, 10


SCENES = {"condenser": condenser, "imager": imager}


def initial_rays(sources, rays_per_source):
    import jax.numpy as jnp

    from pyrayt_tpu.tracer.rayset import concatenate

    rays = concatenate([s.generate_rays(rays_per_source) for s in sources])
    return rays.replace(id=jnp.arange(rays.n_rays, dtype=rays.positions.dtype))


def time_calls(fns, repeats):
    """Warm each fn up, then call them in turns; per-fn sorted times (s)."""
    for fn in fns.values():
        jax.block_until_ready(fn())
    times = {name: [] for name in fns}
    for _ in range(repeats):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            times[name].append(time.perf_counter() - t0)
    return {name: sorted(t) for name, t in times.items()}


def summary(t):
    return {
        "median_ms": 1e3 * float(np.median(t)),
        "min_ms": 1e3 * t[0],
        "max_ms": 1e3 * t[-1],
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=20)
    parser.add_argument("--sweep", action="store_true",
                        help="also time kernel block sizes and warp counts")
    args = parser.parse_args()

    stamp = device_stamp()
    from pyrayt_tpu.config import TraceConfig, enable_compile_cache
    from pyrayt_tpu.ops import fused_trace as ft
    from pyrayt_tpu.scene.compile import compile_scene
    from pyrayt_tpu.tracer import engine

    enable_compile_cache()
    for name, make in SCENES.items():
        sources, system, per_source, generations = make()
        scene = compile_scene(system)
        rays = initial_rays(sources, per_source)
        fns = {}
        for label, use in (("kernel", True), ("xla", False)):
            cfg = TraceConfig(generation_limit=generations, use_fused=use)
            fns[label] = lambda cfg=cfg: engine.trace_rays(scene, rays, cfg)
        if args.sweep:
            cfg = TraceConfig(generation_limit=generations)
            for block in (128, 256, 512, 1024):
                for warps in (2, 4, 8):
                    fn = ft.build_fused_trace_fn(
                        scene.spec, scene.materials, cfg, block=block, num_warps=warps
                    )
                    fns[f"kernel_b{block}_w{warps}"] = (
                        lambda fn=fn: fn(scene.params, rays)
                    )
        times = time_calls(fns, args.repeats)
        ker, xla = np.median(times["kernel"]), np.median(times["xla"])
        print(json.dumps({
            "scene": name,
            "rays": rays.n_rays,
            "generation_limit": generations,
            "repeats": args.repeats,
            "times": {k: summary(v) for k, v in times.items()},
            "xla_over_kernel": float(xla / ker),
            "device": stamp,
        }), flush=True)


if __name__ == "__main__":
    main()
