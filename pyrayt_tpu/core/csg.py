"""Constructive solid geometry interval engine.

Re-design of the reference's parity-count CSG combiner
(tinygfx/g3d/csg.py:13-61) plus the surface-id co-sorting used by compound
surfaces (tinygfx/g3d/csg.py:118-160).  The whole CSG tree of a component is
known statically at scene-compile time, so tree evaluation unrolls into a
static chain of these ops — no recursion or dynamic control flow on device.

Algorithm (per ray column): each child contributes a sorted, even-length
list of entry/exit parameters.  Merging both lists in sorted order and
cumulative-summing +/-1 (entering/leaving a solid) yields the number of
solids containing the ray at each event.  Boundary events of the combined
solid are kept, everything else becomes ``+inf``.

Device mapping: the reference's argsort + fancy-index merge becomes a static
Batcher comparator network (pyrayt_tpu/ops/sortnet.py) that moves the
entry/exit parity signs and surface ids along as payload rows — pure
minimum/maximum/where elementwise ops, no device sorts, no gathers.  The parity
signs are known per *source row* before the merge (row i of a sorted
even-length hit list is an entry iff i is even — exactly the reference's
``order & 1`` trick at csg.py:38-48), which is what removes the argsort.

Tie semantics: the networks run in *stable* mode (lexicographic
(key, source-row) comparison), preserving the reference's merge order for
coincident events — load-bearing for unions of touching solids, where the
entry must precede the exit at the shared boundary.  The union boundary
test keeps the reference's roll-wraparound pairing (quirk Q9), valid
because inside-counts return to zero at the +/-inf sentinels.
"""

from __future__ import annotations

import enum

import jax.numpy as jnp

from pyrayt_tpu.ops.sortnet import rows, sort_rows_with_payloads, unrows

__all__ = ["Operation", "array_csg", "csg_combine_with_ids"]


class Operation(enum.Enum):
    UNION = 1
    INTERSECT = 2
    DIFFERENCE = 3


def _entry_signs(m1: int, m2: int, operation: Operation):
    """Static +/-1 entry/exit sign per merged source row (pre-merge)."""
    signs = [1 if i % 2 == 0 else -1 for i in range(m1)]
    if operation == Operation.DIFFERENCE:
        # subtracting solid: its inside counts against (csg.py:44-48)
        signs += [-1 if i % 2 == 0 else 1 for i in range(m2)]
    else:
        signs += [1 if i % 2 == 0 else -1 for i in range(m2)]
    return signs


def _merge_and_count(hit_rows, sign_rows, payload_rows, operation: Operation):
    """Network-merge event rows; return (sorted hits, inside counts, payloads)."""
    payloads = (sign_rows,) + ((payload_rows,) if payload_rows else ())
    keys, moved = sort_rows_with_payloads(hit_rows, payloads, stable=True)
    signs = moved[0]
    counts = []
    running = None
    for s in signs:
        running = s if running is None else running + s
        counts.append(running)
    if operation == Operation.DIFFERENCE:
        counts = [c + 1 for c in counts]
    return keys, counts, (moved[1] if payload_rows else None)


def _boundary_rows(counts, operation: Operation):
    m = len(counts)
    if operation == Operation.UNION:
        occupied = [c != 0 for c in counts]
        # wraparound pairing (quirk Q9): row 0 compares against the last row,
        # correct because counts return to 0 at the +/-inf sentinels
        return [occupied[i] ^ occupied[i - 1] for i in range(m)]
    is_two = [c == 2 for c in counts]
    return [is_two[i] | is_two[i - 1] for i in range(m)]


def array_csg(array1, array2, operation: Operation, sort_output: bool = True):
    """Combine two sorted even-length hit-parameter arrays with a CSG op.

    Accepts 1-D arrays or ``(m, n)`` arrays whose columns are independent
    rays.  Non-boundary events are replaced with ``+inf``.
    """
    array1 = jnp.asarray(array1)
    array2 = jnp.asarray(array2)
    squeeze = array1.ndim == 1
    a1 = array1[:, None] if squeeze else array1
    a2 = array2[:, None] if squeeze else array2

    signs = _entry_signs(a1.shape[0], a2.shape[0], operation)
    hit_rows = rows(a1) + rows(a2)
    sign_rows = [jnp.full_like(hit_rows[0], s) for s in signs]
    keys, counts, _ = _merge_and_count(hit_rows, sign_rows, None, operation)
    boundary = _boundary_rows(counts, operation)
    csg_rows = [jnp.where(b, k, jnp.inf) for b, k in zip(boundary, keys)]
    if sort_output:
        csg_rows, _ = sort_rows_with_payloads(csg_rows, stable=True)
    out = unrows(csg_rows)
    return out[:, 0] if squeeze else out


def csg_combine_with_ids(l_hits, l_ids, r_hits, r_ids, operation: Operation):
    """CSG-combine two children's (hits, surface-ids) matrices.

    Port of CSGSurface.intersect's merge path (tinygfx/g3d/csg.py:134-149)
    minus the AABB ray culling: the cull is a host-side perf optimization
    that cannot change results (any finite combined hit lies inside the
    combined AABB), and dynamic compaction is hostile to XLA static shapes.

    Returns ``(hits, ids)``, both ``(m1+m2, n)``, sorted ascending by hit
    with ``+inf`` for removed events (their ids travel with the sort).
    """
    l_hits = jnp.asarray(l_hits)
    r_hits = jnp.asarray(r_hits)

    signs = _entry_signs(l_hits.shape[0], r_hits.shape[0], operation)
    hit_rows = rows(l_hits) + rows(r_hits)
    sign_rows = [jnp.full_like(hit_rows[0], s) for s in signs]
    id_rows = rows(jnp.asarray(l_ids)) + rows(jnp.asarray(r_ids))

    keys, counts, id_rows = _merge_and_count(
        hit_rows, sign_rows, id_rows, operation
    )
    boundary = _boundary_rows(counts, operation)
    csg_rows = [jnp.where(b, k, jnp.inf) for b, k in zip(boundary, keys)]

    csg_rows, (id_rows,) = sort_rows_with_payloads(csg_rows, (id_rows,), stable=True)
    return unrows(csg_rows), unrows(id_rows)
