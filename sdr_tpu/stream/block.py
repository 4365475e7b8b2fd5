"""Streaming block-operator protocol.

The reference streams unbounded signals as pipes of sample blocks, with
each stateful operator handling the seam between adjacent blocks via a
dedicated cross-buffer code path and explicit carried state
(SDR/Filter.hs:530-727, SDR/Demod.hs:39-46, SDR/Util.hs:329-348).

Here every operator is a pure function

    apply(carry, x[..., n_in]) -> (carry', y[..., n_out])

with *static* block shapes and the carry a small pytree (filter history,
resampler phase, demod last-sample, AGC gain, ...).  Composition is
function composition inside one jit; the reference's one-buffer/cross-buffer
split collapses into overlap-save: the carry holds the trailing history
samples and each block is processed as ``concat(history, block)``.

Consequence of static shapes (documented contract): stream outputs are the
outputs of the *left-zero-padded* input stream — each FIR-family operator
prepends ``history_len`` zeros at t=0 (standard overlap-save warmup),
instead of the reference's variable-length warmup blocks.  Blockwise
processing is then *exactly* equal to one-shot processing of the
concatenated stream (tested in tests/test_stream.py), which is the property
the reference's cross-buffer functions exist to provide.
"""

from __future__ import annotations

from typing import Any

__all__ = ["StreamOp"]


class StreamOp:
    """Base class for stream operators.

    Subclasses define:
      * ``out_len(n_in)``           — static rate map (may raise if n_in
                                      incompatible, e.g. not divisible)
      * ``out_dtype(in_dtype)``     — static dtype map
      * ``init_carry(n_in, in_dtype, batch_shape)`` — initial carry pytree
      * ``apply(carry, x)``         — the pure block transform
    """

    #: per-block dims this op adds (FftStream/Channelize emit 2-D blocks)
    extra_block_dims: int = 0
    #: which output axis is the stream/time axis (-1 for sample streams;
    #: FftStream's frame axis is -2)
    time_axis_out: int = -1
    #: False for ops whose carry cannot be computed collectively (checked
    #: BEFORE tracing by the time-sharded runners, so unsupported chains
    #: fail with one actionable error instead of deep inside shard_map)
    time_shardable: bool = True

    def out_len(self, n_in: int) -> int:
        return n_in

    def out_dtype(self, in_dtype):
        return in_dtype

    def map_batch_shape(self, batch_shape: tuple) -> tuple:
        """Batch (leading) dims of this op's OUTPUT given its input's.

        Most ops preserve them; ops that emit a new per-stream axis that
        downstream ops treat as batch (Channelize's channel axis, the
        planar-IQ converters' [2] component axis) append to it, and ops
        that consume such an axis (planar FmDemod) drop it.  Pipeline uses
        this to shape every stage's carry.
        """
        return batch_shape

    def init_carry(self, n_in: int, in_dtype, batch_shape=()) -> Any:
        return ()

    def apply(self, carry, x):
        raise NotImplementedError

    def shard_carry(self, x, axis_name: str, initial=None):
        """Carry for *time-sharded* execution (inside shard_map or vmap).

        Given this shard's local input block ``x``, return the stream state
        at the shard's left boundary — for most ops a halo fetched from the
        left neighbor via ppermute (warmup fill on shard 0).  Stateless ops
        (default) need nothing.  Ops whose state is not a function of
        bounded left context must override and either compute it
        collectively or raise.

        ``initial``: stream state entering shard 0 (this op's streaming
        carry from a previous segment) — substitutes for the warmup fill,
        making segmented block-parallel runs exactly continue a stream.
        """
        if type(self).init_carry is StreamOp.init_carry:
            return ()  # stateless op
        raise NotImplementedError(
            f"{type(self).__name__} does not support time sharding")

    def __repr__(self):
        return type(self).__name__
