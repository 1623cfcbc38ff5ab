"""Checkpoint / resume for optimization loops and deterministic replay.

The reference has no persistence at all — its roadmap lists "exporting
designs ... and reloading previous simulations" as future work
(/root/reference/readme.md:97); SURVEY.md section 5.4 makes it a build
requirement.  Scope here matches the domain: optimization state is a tiny
pytree (scene params, optax state, PRNG key, step counter), so checkpoints
are single ``.npz`` files written atomically — no async machinery needed
for O(kB) payloads.

* :func:`save_checkpoint` / :func:`restore_checkpoint` — generic pytree
  persistence: one numpy array per leaf, keyed by its path in the tree;
  restore takes a template with the target structure, so optax NamedTuple
  states round-trip.
* :func:`pyrayt_tpu.analysis.optimize.optimize` accepts
  ``checkpoint_path``/``checkpoint_every`` and resumes transparently.
* Monte-Carlo sources (Lamp/StaticLamp) replay deterministically from a
  saved PRNG key via their ``prng_key`` property.
"""

from __future__ import annotations

import os
import tempfile

import jax
import numpy as np

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]


def _keyed_leaves(tree):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(path), leaf) for path, leaf in leaves], treedef


def save_checkpoint(path: str, state) -> None:
    """Serialize a pytree of arrays/scalars to ``path`` atomically.

    The write goes to a temp file in the same directory followed by an
    atomic rename, so a killed process never leaves a torn checkpoint.
    """
    leaves, _ = _keyed_leaves(state)
    arrays = {key: np.asarray(leaf) for key, leaf in leaves}
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def restore_checkpoint(path: str, like):
    """Restore a pytree saved by :func:`save_checkpoint`.

    ``like`` is a template with the target structure (e.g. a freshly
    initialized ``(theta0, optimizer.init(theta0), 0)`` tuple); returns the
    same structure filled with the stored numpy values, or ``None`` when the
    file does not exist.
    """
    if not os.path.exists(path):
        return None
    leaves, treedef = _keyed_leaves(like)
    with np.load(path) as stored:
        values = [stored[key] for key, _ in leaves]
    return jax.tree_util.tree_unflatten(treedef, values)


def latest_step(path: str) -> int:
    """The ``step`` entry of a checkpointed dict, or -1 when absent."""
    if not os.path.exists(path):
        return -1
    key = jax.tree_util.keystr((jax.tree_util.DictKey("step"),))
    with np.load(path) as stored:
        return int(stored[key]) if key in stored.files else -1
