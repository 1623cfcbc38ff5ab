"""Scene flattening: builder objects -> static spec + params pytree.

This is the bridge between the object-oriented builder API (reference
ergonomics) and the jitted engine.  A compiled scene is split into:

* ``SceneSpec`` — *static*, hashable structure: primitive type codes, CSG
  tree shapes, id/material wiring.  Changing it triggers recompilation.
* ``params`` — a pytree of JAX arrays (world transforms, primitive
  parameters, glass dispersion rows).  Changing values does NOT recompile;
  these are the differentiable degrees of freedom.

The reference has no analogous stage — it walks live Python objects every
generation (pyrayt/_pyrayt.py:377, 401).  Flattening once before the trace
is what lets the whole trace loop live on-device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import jax.numpy as jnp

from pyrayt_tpu import materials as matl
from pyrayt_tpu.core.csg import Operation
from pyrayt_tpu.scene.csg import CSGSurface
from pyrayt_tpu.scene.objects import Intersectable, ObjectGroup, TracerSurface

__all__ = ["SceneSpec", "CompiledScene", "compile_scene"]

# CSG tree node tags (spec trees are nested tuples, fully hashable)
LEAF = "leaf"
_OP_NAMES = {
    Operation.UNION: "union",
    Operation.INTERSECT: "intersect",
    Operation.DIFFERENCE: "difference",
}
OP_BY_NAME = {name: op for op, name in _OP_NAMES.items()}


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    """Static scene structure (hashable -> usable as a jit cache key)."""

    leaf_types: Tuple[int, ...]  # primitive type code per leaf slot
    leaf_ids: Tuple[int, ...]  # public surface id per leaf slot
    leaf_normal_scale: Tuple[int, ...]  # +1 / -1 per leaf slot
    leaf_mat_slot: Tuple[int, ...]  # material slot per leaf
    mat_kinds: Tuple[int, ...]  # KIND_* per material slot
    mat_packed: Tuple[bool, ...]  # True -> engine uses packed glass row
    trees: Tuple[Any, ...]  # per top-level component: nested tuples

    @property
    def n_leaves(self) -> int:
        return len(self.leaf_types)


@dataclasses.dataclass
class CompiledScene:
    spec: SceneSpec
    params: Dict[str, jnp.ndarray]
    materials: Tuple[matl.TracableMaterial, ...]  # one per material slot


def _flatten_components(components):
    flat = []
    for comp in components:
        if isinstance(comp, ObjectGroup):
            flat.extend(_flatten_components(comp.data))
        else:
            flat.append(comp)
    return flat


def compile_scene(components, require_materials: bool = True) -> CompiledScene:
    """Flatten a list of Intersectables into a CompiledScene.

    ``require_materials=False`` (renderer path) maps material-less surfaces
    to the absorber so geometry-only scenes still compile.
    """
    components = _flatten_components(
        components if hasattr(components, "__iter__") else (components,)
    )

    leaf_types = []
    leaf_ids = []
    leaf_normal_scale = []
    leaf_mat_slot = []
    worlds = []
    prims = []

    materials = []
    mat_slot_of = {}

    def _material_slot(material) -> int:
        if material is None:
            # material-less surfaces absorb (e.g. the subtracted opening in
            # aperture(); the reference leaves a render-only material there
            # that would crash if traced — absorbing is the intent)
            material = matl.absorber
        elif not isinstance(material, matl.TracableMaterial):
            if require_materials:
                raise TypeError(
                    f"material {material!r} is not a TracableMaterial; the "
                    "engine needs a pure_trace implementation"
                )
            material = matl.absorber
        # built-in materials hash/compare by value (materials._ValueIdentity),
        # so rebuilt-but-identical glasses share a slot — and identical
        # scenes produce identical material tuples, keeping the engine's
        # compile cache warm across rebuilds
        if material not in mat_slot_of:
            mat_slot_of[material] = len(materials)
            materials.append(material)
        return mat_slot_of[material]

    def _walk(obj):
        if isinstance(obj, CSGSurface):
            return (
                _OP_NAMES[obj.operation],
                _walk(obj.l_child),
                _walk(obj.r_child),
            )
        if isinstance(obj, TracerSurface):
            slot = len(leaf_types)
            leaf_types.append(obj.prim_type)
            leaf_ids.append(obj.get_id())
            leaf_normal_scale.append(obj._normal_scale)
            leaf_mat_slot.append(_material_slot(obj.material))
            worlds.append(obj.get_world_transform())
            prims.append(obj.prim_params)
            return (LEAF, slot)
        raise TypeError(f"cannot compile component of type {type(obj)!r}")

    trees = tuple(_walk(comp) for comp in components)

    mat_kinds = tuple(m.kind for m in materials)
    mat_packed = tuple(
        type(m)
        in (
            matl.BasicRefractor,
            matl.SellmeierRefractor,
            matl._AbsorbingMaterial,
            matl._ReflectingMaterial,
        )
        for m in materials
    )

    spec = SceneSpec(
        leaf_types=tuple(leaf_types),
        leaf_ids=tuple(leaf_ids),
        leaf_normal_scale=tuple(leaf_normal_scale),
        leaf_mat_slot=tuple(leaf_mat_slot),
        mat_kinds=mat_kinds,
        mat_packed=mat_packed,
        trees=trees,
    )
    params = {
        "world": jnp.stack(worlds) if worlds else jnp.zeros((0, 4, 4)),
        "prim": jnp.stack(prims) if prims else jnp.zeros((0, 6)),
        "glass": (
            jnp.stack([m.glass_coeffs() for m in materials])
            if materials
            else jnp.zeros((0, matl.N_GLASS_COEFFS))
        ),
    }
    return CompiledScene(spec=spec, params=params, materials=tuple(materials))
