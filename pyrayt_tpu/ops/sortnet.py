"""Static sorting networks for tiny leading axes.

XLA's general variadic sort is a poor fit for shapes like ``(m, 1M)``:
every sort in the ray tracer is along a *static, tiny* event axis (m =
2..~16 CSG interval events), so each one is replaced by a Batcher odd-even
mergesort network of compare-exchange steps: pure ``minimum/maximum/where``
elementwise ops over the ray axis, fully fusable, no gathers.  The same
networks carry payload rows (surface ids, parity masks) through the
permutation, replacing argsort + take_along_axis.

Semantics note: a comparator network is deterministic but not stable; on
*tied* keys the payload order may differ from a stable argsort.  Tied hit
parameters mean geometrically coincident surfaces — the kept hit values are
identical either way (documented deviation, matches the reference's
unstable np quicksort behavior; see core/csg.py).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

import jax.numpy as jnp

__all__ = ["batcher_pairs", "sort_rows", "sort_rows_with_payloads", "rows", "unrows"]


@lru_cache(maxsize=None)
def batcher_pairs(n: int) -> Tuple[Tuple[int, int], ...]:
    """Comparator (i, j) pairs of a Batcher odd-even mergesort network on n
    wires; applying compare-exchange in order sorts any input."""
    pairs: List[Tuple[int, int]] = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return tuple(pairs)


def rows(x) -> List[jnp.ndarray]:
    """Split an (m, ...) array into a list of m row arrays."""
    return [x[i] for i in range(x.shape[0])]


def unrows(row_list: Sequence[jnp.ndarray]) -> jnp.ndarray:
    return jnp.stack(list(row_list), axis=0)


def sort_rows_with_payloads(keys, payloads=(), stable=False):
    """Sort row lists ascending by key, permuting payload row lists along.

    ``keys`` is a list of m same-shape arrays (one per event row);
    ``payloads`` is a tuple of such lists.  Returns (keys, payloads) as new
    lists.  m == 2 specializes to one minimum/maximum pair.

    ``stable=True`` breaks key ties by original row order (lexicographic
    (key, source-row) comparison) — required by the CSG parity semantics
    where a coincident entry/exit pair must keep entry-first order
    (tinygfx/g3d/csg.py:38-53 relies on the merge order of equal hits).
    """
    keys = list(keys)
    payloads = [list(p) for p in payloads]
    m = len(keys)
    if m <= 1:
        return keys, payloads

    ranks = None
    if stable:
        shape = jnp.shape(keys[0])
        ranks = [jnp.full(shape, i, dtype=jnp.int32) for i in range(m)]

    for i, j in batcher_pairs(m):
        ki, kj = keys[i], keys[j]
        if stable:
            ri, rj = ranks[i], ranks[j]
            swap = (kj < ki) | ((kj == ki) & (rj < ri))
            ranks[i] = jnp.where(swap, rj, ri)
            ranks[j] = jnp.where(swap, ri, rj)
        else:
            swap = kj < ki
        keys[i] = jnp.where(swap, kj, ki)
        keys[j] = jnp.where(swap, ki, kj)
        for p in payloads:
            pi, pj = p[i], p[j]
            p[i] = jnp.where(swap, pj, pi)
            p[j] = jnp.where(swap, pi, pj)
    return keys, payloads


def sort_rows(x) -> jnp.ndarray:
    """Network-sorted replacement for ``jnp.sort(x, axis=0)`` with static,
    small ``x.shape[0]``."""
    if x.shape[0] == 2:
        return jnp.stack((jnp.minimum(x[0], x[1]), jnp.maximum(x[0], x[1])))
    keys, _ = sort_rows_with_payloads(rows(x))
    return unrows(keys)
