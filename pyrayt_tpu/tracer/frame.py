"""Host-edge conversion of trace records to the reference DataFrame format.

The engine's on-device ``(G, 15, n)`` record buffer + ``(G, n)`` row mask
convert into the reference's 15-column float32 Pandas frame
(pyrayt/_pyrayt.py:147-186).  Row order matches the reference exactly:
generations in order, and within a generation rays in their original
(source) order — the reference compacts dead rays but preserves relative
order, which both paths below reproduce.

Fetch strategy:

* **compact (the default)** -- fetch one scalar (the live-generation
  count), then transfer only ``records[:g_live]`` cast to float32, computed
  by a jitted slice+cast so the transferred array is a compiled function's
  output buffer.  A production ``trace()`` fetches a fresh buffer, and
  there fewer bytes is what counts.
* **compact=False** (naive) -- fetch the whole buffer and boolean-select on
  the host.  JAX caches an array's host copy after its first transfer, so
  this only pays off when the same result is read repeatedly.

:func:`records_to_rows` stops at the numpy rows; only
:func:`records_to_dataframe` needs pandas, which it imports when called.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "FRAME_COLUMNS",
    "records_to_rows",
    "records_to_dataframe",
    "live_generations",
]

FRAME_COLUMNS = (
    "generation",
    "intensity",
    "wavelength",
    "index",
    "id",
    "surface",
    "x0",
    "y0",
    "z0",
    "x1",
    "y1",
    "z1",
    "x_tilt",
    "y_tilt",
    "z_tilt",
)


def live_generations(record_mask) -> int:
    """Number of leading generations with at least one recorded ray."""
    return int(jnp.sum(jnp.any(jnp.asarray(record_mask), axis=1)))


@lru_cache(maxsize=32)
def _slice_cast_fn(g: int):
    """Jitted live-slice + f32 cast: the transferred arrays are compiled
    outputs (committed buffers), not eager-op results — worth ~1.3x on
    the fetch itself on top of the 2x byte saving (design notes)."""
    return jax.jit(
        lambda r, m: (r[:g].astype(jnp.float32), m[:g])
    )


def records_to_rows(records, record_mask, compact=None) -> np.ndarray:
    """Fetch the recorded rows to the host as a float32 ``(rows, 15)``
    array, generation-major and in ray order within a generation.

    ``compact=None`` resolves to the sliced dtype-tight fetch (fastest
    for the first fetch of a fresh trace -- the production case);
    ``False`` forces the naive full-buffer fetch (fastest only when
    re-reading a buffer whose host copy is already cached).
    """
    if compact is None:
        compact = True
    if compact:
        g = max(live_generations(record_mask), 1)
        rec_d, mask_d = _slice_cast_fn(g)(
            jnp.asarray(records), jnp.asarray(record_mask)
        )
        records = np.asarray(rec_d)
        record_mask = np.asarray(mask_d)
    else:
        records = np.asarray(records, dtype=np.float32)  # (G, 15, n)
        record_mask = np.asarray(record_mask)  # (G, n)
    # (g, 15, n) -> (g, n, 15) then boolean-select rows generation-major
    return records.transpose(0, 2, 1)[record_mask]


def records_to_dataframe(records, record_mask, compact=None):
    """Build the results ``pandas.DataFrame`` from the device buffer (see
    :func:`records_to_rows` for ``compact``)."""
    import pandas as pd

    rows = records_to_rows(records, record_mask, compact=compact)
    return pd.DataFrame(rows, columns=list(FRAME_COLUMNS), dtype="float32")
