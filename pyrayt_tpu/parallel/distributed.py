"""Multi-host bootstrap (SURVEY.md section 5.8).

The reference has no distributed backend at all (no NCCL/MPI/Gloo —
single-process NumPy).  Here it is JAX's coordinator service: every
process calls :func:`initialize_distributed` once before any backend use;
afterwards ``jax.devices()`` spans every process and the
``('hosts', 'rays')`` mesh from :func:`pyrayt_tpu.parallel.default_mesh`
maps its leading axis onto the hosts.

Trace jobs are short, so the failure policy is deliberately minimal
(SURVEY.md section 5.3): a host dropping out surfaces as a coordinator
timeout here or a collective timeout in-step; recovery is re-running the
job from the last optimization checkpoint
(pyrayt_tpu.analysis.checkpoint), not elastic resizing.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

__all__ = ["initialize_distributed", "is_distributed"]

# environment variables consulted (first hit wins), standard cluster-launcher
# spellings first
_ADDR_VARS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
_NPROC_VARS = ("JAX_NUM_PROCESSES", "NUM_PROCESSES", "WORLD_SIZE")
_PID_VARS = ("JAX_PROCESS_ID", "PROCESS_ID", "RANK")


def _env_int(names) -> Optional[int]:
    for name in names:
        value = os.environ.get(name)
        if value:
            return int(value)
    return None


def _env_str(names) -> Optional[str]:
    for name in names:
        value = os.environ.get(name)
        if value:
            return value
    return None


def is_distributed() -> bool:
    return jax.process_count() > 1


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    initialization_timeout: Optional[int] = None,
) -> bool:
    """Join (or skip) the multi-host process group.  Idempotent.

    Resolution order per argument: explicit parameter, then environment
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, plus the
    common WORLD_SIZE / RANK spellings).  Nothing is auto-detected: with no
    coordinator address and no process count the call is a no-op returning
    False, so single-process scripts can call it unconditionally.

    Returns True when running (or now joined) as part of a multi-process
    group.
    """
    if jax._src.distributed.global_state.client is not None:  # already joined
        return is_distributed()

    coordinator_address = coordinator_address or _env_str(_ADDR_VARS)
    num_processes = num_processes if num_processes is not None else _env_int(_NPROC_VARS)
    process_id = process_id if process_id is not None else _env_int(_PID_VARS)

    if coordinator_address is None and num_processes is None:
        return False  # single-process run: nothing to join

    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if initialization_timeout is not None:
        kwargs["initialization_timeout"] = initialization_timeout
    jax.distributed.initialize(**kwargs)
    return is_distributed()
