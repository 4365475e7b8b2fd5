"""Sharded pipeline execution over device meshes.

Replaces the reference's single-machine streaming with SPMD over a mesh:

* **time sharding** — one long recorded stream split into contiguous
  per-device chunks; every stateful operator gets its seam state from the
  left neighbor (halo exchange via ppermute, see parallel/halo.py and the
  per-op ``shard_carry`` methods).  Exactness contract: the sharded run
  produces the SAME samples as the single-device streamed run (tested on a
  virtual CPU mesh in tests/test_parallel.py).

* **channel sharding** — independent channels ([..., C, N] arrays) mapped
  over a mesh axis; ops already broadcast over leading dims so this is pure
  data parallelism with no communication (the 64-channel channelizer,
  BASELINE config #5).

Both compose on a 2-D {channel, time} mesh.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from sdr_tpu.stream.block import StreamOp
from sdr_tpu.stream.pipeline import Pipeline

__all__ = ["time_sharded_fn", "run_time_sharded", "run_time_batched",
           "run_channel_sharded",
           "run_grid_sharded"]


def time_sharded_fn(ops: Sequence[StreamOp], axis_name: str = "t",
                    initials=None, return_carries: bool = False):
    """Build the per-shard function for a chain of ops.

    Returns ``fn(local_block) -> local_out`` to be wrapped in ``shard_map``
    over ``axis_name``: each op fetches its left-boundary state collectively
    (``shard_carry``) then applies its pure block transform.

    ``initials``: per-op streaming carries entering shard 0 (a previous
    segment's final state) — consecutive segmented runs then continue the
    stream exactly.  ``return_carries``: ``fn`` returns
    ``(new_carries, local_out)`` so the caller can extract the last
    shard's state as the next segment's ``initials``.
    """
    ops = list(ops)
    for i, op in enumerate(ops):
        if not getattr(op, "time_shardable", True):
            raise ValueError(
                f"stage {i} ({op!r}) does not support time sharding "
                "(nonlinear carry). For Agc, construct it with "
                "approx_time_sharding=R to enable the documented "
                "approximate mode, or shard channels instead.")

    def fn(x):
        new = []
        for i, op in enumerate(ops):
            carry = op.shard_carry(
                x, axis_name,
                None if initials is None else initials[i])
            c2, x = op.apply(carry, x)
            new.append(c2)
        return (new, x) if return_carries else x

    return fn


def _out_spec(ops: Sequence[StreamOp], in_ndim: int, axis_name: str):
    """Output PartitionSpec: ops may add per-block dims (FftStream frames,
    Channelize channels) and relocate the stream/time axis."""
    extra = sum(getattr(op, "extra_block_dims", 0) for op in ops)
    t_axis = ops[-1].time_axis_out if ops else -1
    rank = in_ndim + extra
    names = [None] * rank
    names[rank + t_axis if t_axis < 0 else t_axis] = axis_name
    return P(*names)


def run_time_sharded(ops: Sequence[StreamOp], mesh: Mesh, x,
                     axis_name: str = "t", extra_specs=()):
    """Process a global signal [..., N] sharded along time.

    N must divide evenly by the mesh axis size, and each per-device chunk
    must satisfy the chain's divisibility constraints (checked via a
    Pipeline dry-run at trace time).
    """
    n_shards = mesh.shape[axis_name]
    n = x.shape[-1]
    if n % n_shards:
        raise ValueError(f"signal length {n} not divisible by {n_shards}")
    # static validation of per-shard rates
    Pipeline(ops, block_in=n // n_shards, in_dtype=x.dtype,
             batch_shape=x.shape[:-1])
    spec = P(*([None] * (x.ndim - 1) + [axis_name]))
    fn = time_sharded_fn(ops, axis_name)
    sharded = jax.shard_map(fn, mesh=mesh, in_specs=spec,
                            out_specs=_out_spec(ops, x.ndim, axis_name),
                            check_vma=False)
    return sharded(x)


def run_time_batched(ops: Sequence[StreamOp], x, nblocks: int,
                     axis_name: str = "b", carries=None,
                     return_carries: bool = False):
    """Single-device block-PARALLEL processing of a recorded signal.

    The same seam algebra as :func:`run_time_sharded` — FIR halos, demod
    lag, closed-form resampler phase, affine-prefix recurrences — but the
    "shards" are rows of a [nblocks, n] batch on ONE device (``vmap`` with
    an ``axis_name``, under which the halo collectives become cheap
    in-memory rotations).  This is the throughput formulation of offline
    processing: a sequential carry-chained block loop leaves the chip idle
    between dependent dispatches, whereas here every block's convs batch
    into single large device ops.  Output equals the sequential streamed run
    exactly (same warmup zeros; tested in test_parallel.py).

    ``carries`` (per-op streaming state from a previous segment) +
    ``return_carries=True`` support SEGMENTED streaming: process a live
    stream in nblocks-sized groups at batch throughput while continuing
    state exactly across group seams (tested in test_quantized.py).
    """
    n = x.shape[-1]
    if n % nblocks:
        raise ValueError(f"signal length {n} not divisible by {nblocks}")
    Pipeline(ops, block_in=n // nblocks, in_dtype=x.dtype,
             batch_shape=x.shape[:-1])
    lead = x.shape[:-1]
    xb = jnp.moveaxis(x.reshape(lead + (nblocks, n // nblocks)),
                      -2, 0)
    fn = time_sharded_fn(ops, axis_name, initials=carries,
                         return_carries=return_carries)
    t_axis = ops[-1].time_axis_out if ops else -1
    if not return_carries:
        yb = jax.vmap(fn, axis_name=axis_name)(xb)
        return Pipeline._restack(yb, lead, t_axis)
    cb, yb = jax.vmap(fn, axis_name=axis_name)(xb)
    # the LAST block's new carries are the stream state after the segment
    final = jax.tree.map(lambda l: l[-1], cb)
    # restack: [nblocks, *lead, ...per-block] -> [*lead, stream, ...]
    return final, Pipeline._restack(yb, lead, t_axis)


def run_channel_sharded(ops: Sequence[StreamOp], mesh: Mesh, x,
                        axis_name: str = "c"):
    """Process [..., C, N] with channels sharded over ``axis_name``.

    Pure data parallelism: the chain runs independently per channel chunk
    (the reference's 'multiple independent FM chains' channelizer mapped
    over the mesh instead of over OS threads).  Every channel starts from
    warmup (zero) state; to continue a stream across segments, use
    :func:`run_time_batched` per channel group or drive a
    :class:`~sdr_tpu.stream.Pipeline` with a batched leading dim instead.
    """
    spec = P(*([None] * (x.ndim - 2) + [axis_name, None]))

    def fn(xl):
        for op in ops:
            c = op.init_carry(xl.shape[-1], xl.dtype, xl.shape[:-1])
            _, xl = op.apply(c, xl)
        return xl

    sharded = jax.shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec,
                            check_vma=False)
    return sharded(x)


def run_grid_sharded(ops: Sequence[StreamOp], mesh: Mesh, x,
                     channel_axis: str = "c", time_axis: str = "t"):
    """2-D sharding: [..., C, N] with channels over ``channel_axis`` and
    time over ``time_axis`` (halo exchange on the inner time axis)."""
    spec = P(*([None] * (x.ndim - 2) + [channel_axis, time_axis]))
    out = _out_spec(ops, x.ndim, time_axis)
    out = P(*(list(out)[: x.ndim - 2] + [channel_axis]
              + list(out)[x.ndim - 1:]))
    fn = time_sharded_fn(ops, time_axis)
    sharded = jax.shard_map(fn, mesh=mesh, in_specs=spec, out_specs=out,
                            check_vma=False)
    return sharded(x)
