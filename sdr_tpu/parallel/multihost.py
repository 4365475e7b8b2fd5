"""Multi-host (pod) execution support.

SURVEY.md §7.6: multi-host streams are fed by per-host file/UDP readers;
each host ingests only the time-span its local devices own, and the global
array is assembled with ``jax.make_array_from_process_local_data`` — the
replacement for the per-device STM mailboxes the reference uses inside one
process (RTLSDRStream.hs:78).  Halo exchange then rides the links within
hosts and the network across hosts through the same ``ppermute`` calls
(parallel/halo.py) — XLA routes them.

Single-process multi-device (the CI/virtual-mesh case) degenerates to
``device_put`` with a sharding, so the same code runs everywhere.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["init_distributed", "local_time_span", "global_time_sharded",
           "host_block_iterator"]


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize multi-process JAX (no-op when single-process).

    Pass the coordinator address (e.g. ``localhost:<port>``), process
    count and this process's id explicitly: nothing in a plain GPU host's
    environment provides them.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)


def local_time_span(mesh: Mesh, n_global: int, axis: str = "t"):
    """(offset, length) of the time-span this *process* must ingest for a
    [..., n_global] array sharded over ``axis``.

    The per-host file reader seeks to ``offset`` items and reads
    ``length`` — each host touches only its slice of the recording.
    """
    n_shards = mesh.shape[axis]
    if n_global % n_shards:
        raise ValueError("global length not divisible by time shards")
    chunk = n_global // n_shards
    # devices along the time axis owned by this process, in mesh order
    axis_index = list(mesh.axis_names).index(axis)
    dev_grid = np.asarray(mesh.devices)
    spans = []
    it = np.ndindex(dev_grid.shape)
    for idx in it:
        d = dev_grid[idx]
        if d.process_index == jax.process_index():
            t = idx[axis_index]
            spans.append(t)
    if not spans:
        return 0, 0
    lo, hi = min(spans), max(spans)
    if spans != list(range(lo, hi + 1)):
        # non-contiguous spans still work (reader seeks per shard) but the
        # simple (offset, length) contract doesn't; caller should map
        # per-shard instead.
        raise ValueError("process's time shards are not contiguous")
    return lo * chunk, (hi - lo + 1) * chunk


def global_time_sharded(local_data: np.ndarray, mesh: Mesh, n_global: int,
                        axis: str = "t", leading_spec: Sequence = ()):
    """Assemble the global [..., n_global] array from this process's local
    slice (every process calls with its own slice)."""
    spec = P(*list(leading_spec), axis)
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(local_data, sharding)
    shape = local_data.shape[:-1] + (n_global,)
    return jax.make_array_from_process_local_data(sharding, local_data,
                                                  global_shape=shape)


def host_block_iterator(path, mesh: Mesh, block_global: int, dtype=np.uint8,
                        axis: str = "t") -> Iterator[np.ndarray]:
    """Per-host block reader: yields this process's slice of each global
    block of a recorded stream (offset/length from local_time_span)."""
    item = np.dtype(dtype).itemsize
    data = np.memmap(path, dtype=dtype, mode="r")
    n = (len(data) // block_global) * block_global
    off, length = local_time_span(mesh, block_global, axis)
    for i in range(0, n, block_global):
        yield np.asarray(data[i + off: i + off + length])
