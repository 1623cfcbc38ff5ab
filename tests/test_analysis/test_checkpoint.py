"""Checkpoint / resume (SURVEY.md section 5.4).

Kill-and-resume must converge identically to an uninterrupted run, and
Monte-Carlo sources must replay deterministically from a saved PRNG key.
"""

import jax.numpy as jnp
import numpy as np
import optax

from pyrayt_tpu import components as comp
from pyrayt_tpu.analysis.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from pyrayt_tpu.analysis.optimize import optimize


def quadratic(theta):
    return (theta["a"] - 3.0) ** 2 + (theta["b"] + 1.0) ** 2


THETA0 = {"a": jnp.asarray(0.0), "b": jnp.asarray(0.0)}


class TestPytreeRoundtrip:
    def test_nested_pytree_with_optax_state(self, tmp_path):
        path = str(tmp_path / "state.ckpt")
        opt = optax.adam(1e-2)
        state = {
            "theta": THETA0,
            "opt_state": opt.init(THETA0),
            "step": 7,
            "history": np.arange(5.0),
        }
        save_checkpoint(path, state)
        template = {
            "theta": THETA0,
            "opt_state": opt.init(THETA0),
            "step": 0,
            "history": np.zeros(5),
        }
        restored = restore_checkpoint(path, template)
        assert int(restored["step"]) == 7
        np.testing.assert_array_equal(restored["history"], np.arange(5.0))
        flat_a, _ = np.asarray(restored["theta"]["a"]), None
        assert flat_a == 0.0
        assert latest_step(path) == 7

    def test_missing_file_returns_none(self, tmp_path):
        assert restore_checkpoint(str(tmp_path / "nope.ckpt"), {"x": 0}) is None
        assert latest_step(str(tmp_path / "nope.ckpt")) == -1


class TestKillAndResume:
    def test_resumed_run_matches_uninterrupted(self, tmp_path):
        path = str(tmp_path / "opt.ckpt")
        # uninterrupted 30 steps
        theta_full, hist_full = optimize(
            quadratic, THETA0, steps=30, optimizer=optax.adam(5e-2)
        )
        # interrupted: run to a mid-run checkpoint, then resume from disk
        optimize(
            quadratic,
            THETA0,
            steps=30,
            optimizer=optax.adam(5e-2),
            checkpoint_path=path,
            checkpoint_every=10,
        )
        # simulate the kill: rewind the file to the step-20 snapshot by
        # re-running only 20 steps into a fresh file
        path2 = str(tmp_path / "opt2.ckpt")
        optimize(
            quadratic,
            THETA0,
            steps=20,
            optimizer=optax.adam(5e-2),
            checkpoint_path=path2,
            checkpoint_every=10,
        )
        assert latest_step(path2) == 20
        theta_resumed, hist_resumed = optimize(
            quadratic,
            THETA0,
            steps=30,
            optimizer=optax.adam(5e-2),
            checkpoint_path=path2,
            checkpoint_every=10,
        )
        np.testing.assert_allclose(
            np.asarray(theta_resumed["a"]), np.asarray(theta_full["a"]), rtol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(theta_resumed["b"]), np.asarray(theta_full["b"]), rtol=1e-12
        )
        np.testing.assert_allclose(hist_resumed[-1], hist_full[-1], rtol=1e-12)
        assert len(hist_resumed) == 30


class TestLampReplay:
    def test_replay_from_saved_key(self, tmp_path):
        path = str(tmp_path / "lamp.ckpt")
        lamp = comp.Lamp(width=1.0, length=2.0, seed=123)
        save_checkpoint(path, {"key": lamp.prng_key})
        first = lamp.generate_rays(64)
        second = lamp.generate_rays(64)  # advances the key: different rays
        assert not np.allclose(
            np.asarray(first.positions), np.asarray(second.positions)
        )

        restored = restore_checkpoint(path, {"key": lamp.prng_key})
        lamp.prng_key = restored["key"]
        replayed = lamp.generate_rays(64)
        np.testing.assert_array_equal(
            np.asarray(replayed.positions), np.asarray(first.positions)
        )
        np.testing.assert_array_equal(
            np.asarray(replayed.directions), np.asarray(first.directions)
        )


class TestFileFormat:
    def test_checkpoint_is_a_numpy_archive_keyed_by_tree_path(self, tmp_path):
        path = str(tmp_path / "state.ckpt")
        save_checkpoint(path, {"theta": {"a": jnp.asarray(2.5)}, "step": 3})
        with np.load(path) as stored:
            assert sorted(stored.files) == ["['step']", "['theta']['a']"]
            assert float(stored["['theta']['a']"]) == 2.5
        # the atomic write leaves no temporary file behind
        assert [p.name for p in tmp_path.iterdir()] == ["state.ckpt"]
