"""Pipeline: composition and execution of stream operators.

The reference composes operators with ``>->`` and drives them with
``runEffect`` — a pull-based loop where each operator awaits blocks
(examples/fm/fm.hs:32-41).  Here composition is function composition inside
one jitted step:

    step : (carries, in_block) -> (carries, out_block)

and the drive loop is either ``lax.scan`` over a recorded signal (whole
stream stays on device — the offline/benchmark path) or a host loop feeding
live blocks (the device-I/O path).  The pipeline's carry pytree is the
explicit, snapshottable analog of the state the reference hides inside
closures; ``checkpoint``/``restore`` give deterministic resume — the
subsystem the reference lacks (SURVEY.md §5.4).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from sdr_tpu.stream.block import StreamOp

__all__ = ["Pipeline", "pack_planar", "unpack_planar", "unalias"]


def _planarize(leaf):
    """complex64 [..., n] -> planar float32 [2, ..., n] (the layout
    ``scan`` carries complex state in)."""
    if jnp.iscomplexobj(leaf):
        return jnp.stack([jnp.real(leaf), jnp.imag(leaf)], axis=0)
    return leaf


def _unplanarize(leaf, was_complex: bool):
    if was_complex:
        return jax.lax.complex(leaf[0], leaf[1])
    return leaf


def unalias(tree):
    """Copy every leaf that repeats a buffer already seen in ``tree``.

    An op may build its initial carry from one array twice (``(z, z)``);
    donating that pytree would donate one buffer twice, which XLA
    rejects.  The copy happens only for repeats, so a pytree of distinct
    buffers passes through unchanged."""
    leaves, treedef = jax.tree.flatten(tree)
    seen = set()
    out = []
    for leaf in leaves:
        if id(leaf) in seen:
            leaf = jnp.array(leaf, copy=True)
        seen.add(id(leaf))
        out.append(leaf)
    return jax.tree.unflatten(treedef, out)


def pack_planar(tree):
    """Convert every complex leaf of a pytree to planar f32; returns
    (packed_tree, flags) where flags records which leaves were complex."""
    leaves, treedef = jax.tree.flatten(tree)
    flags = tuple(bool(jnp.iscomplexobj(l)) for l in leaves)
    packed = jax.tree.unflatten(treedef, [_planarize(l) for l in leaves])
    return packed, flags


def unpack_planar(packed, flags):
    leaves, treedef = jax.tree.flatten(packed)
    return jax.tree.unflatten(
        treedef, [_unplanarize(l, f) for l, f in zip(leaves, flags)])


class Pipeline:
    """A chain of :class:`StreamOp`, specialized to a source block size.

    ``block_in`` is the input block length (in source samples); per-op
    block lengths and dtypes are propagated statically at construction and
    validated (the divisibility discipline that replaces the reference's
    dynamic output Buffer accounting, Filter.hs:504-523).
    """

    def __init__(self, ops: Sequence[StreamOp], block_in: int,
                 in_dtype=jnp.uint8, batch_shape=()):
        self.ops = list(ops)
        self.block_in = int(block_in)
        self.in_dtype = in_dtype
        self.batch_shape = tuple(batch_shape)
        # static rate/dtype/batch-shape propagation
        self.lens = [self.block_in]
        self.dtypes = [in_dtype]
        self.bshapes = [self.batch_shape]
        for i, op in enumerate(self.ops):
            try:
                self.lens.append(op.out_len(self.lens[-1]))
            except ValueError as e:
                raise ValueError(
                    f"stage {i} ({op!r}) rejects block of {self.lens[-1]} "
                    f"samples: {e}") from None
            self.dtypes.append(op.out_dtype(self.dtypes[-1]))
            self.bshapes.append(op.map_batch_shape(self.bshapes[-1]))
        self.block_out = self.lens[-1]
        self.out_dtype = self.dtypes[-1]

    # -- state -------------------------------------------------------------

    def init(self):
        """Initial carry pytree (a list, one entry per op)."""
        return [op.init_carry(n, dt, bs)
                for op, n, dt, bs in
                zip(self.ops, self.lens, self.dtypes, self.bshapes)]

    # -- execution ---------------------------------------------------------

    def apply(self, carries, x):
        """One block through the whole chain.  Pure; jit/scan/shard-safe."""
        new_carries = []
        for op, c in zip(self.ops, carries):
            c, x = op.apply(c, x)
            new_carries.append(c)
        return new_carries, x

    def jit_step(self, donate: bool = True):
        """Jitted single-block step; carries donated to avoid copies.

        Call it as ``step(unalias(carries), x)``: a donated carry pytree
        must not hold one buffer twice (see :func:`unalias`)."""
        return jax.jit(self.apply,
                       donate_argnums=(0,) if donate else ())

    def scan(self, blocks, carries=None):
        """Run over stacked blocks [num_blocks, ..., block_in] with
        ``lax.scan`` (the whole stream resident on device).

        Returns (final_carries, out_blocks [num_blocks, ..., block_out]).

        All loop-carried buffers are kept in planar-f32 form (complex
        split into a leading [2, ...] axis).
        """
        if carries is None:
            carries = self.init()
        carries_p, cflags = pack_planar(carries)
        xs_complex = bool(jnp.iscomplexobj(blocks))
        if xs_complex:
            blocks = jnp.stack([jnp.real(blocks), jnp.imag(blocks)], axis=1)
        yflags = None

        def step(c_p, xb):
            c = unpack_planar(c_p, cflags)
            if xs_complex:
                xb = jax.lax.complex(xb[0], xb[1])
            c, y = self.apply(c, xb)
            c_p, _ = pack_planar(c)
            y_p, yf = pack_planar(y)
            nonlocal yflags
            yflags = yf
            return c_p, y_p

        final_p, ys_p = jax.lax.scan(step, carries_p, blocks)
        final = unpack_planar(final_p, cflags)
        # ys leaves: stacked [nb, ...]; complex ones carry the planar axis
        # at position 1 -> recombine
        leaves, treedef = jax.tree.flatten(ys_p)
        leaves = [jax.lax.complex(l[:, 0], l[:, 1]) if f else l
                  for l, f in zip(leaves, yflags)]
        ys = jax.tree.unflatten(treedef, leaves)
        return final, ys

    def run(self, source: Iterable[np.ndarray], carries=None):
        """Host drive loop over an iterator of blocks (live-source path).

        Yields output blocks as device arrays; the reference analog is
        ``runEffect`` pulling from an ``sdrStream`` mailbox
        (examples/fm/fm.hs:32).
        """
        # the step donates its carries: never the caller's own buffers
        carries = (self.init() if carries is None
                   else jax.tree.map(jnp.array, carries))
        step = self.jit_step()
        for blk in source:
            carries, y = step(unalias(carries), jnp.asarray(blk))
            yield y

    def run_batched(self, source: Iterable[np.ndarray],
                    parallel_blocks: int, carries=None):
        """Drive a live/iterator source in block-PARALLEL groups.

        Accumulates ``parallel_blocks`` source blocks, processes the group
        with :func:`sdr_tpu.parallel.run_time_batched` (every block's convs
        batch into single large device ops), and threads the streaming state
        exactly across group seams — output equals :meth:`run` sample for
        sample.  A short final group is processed at its own size.  This is
        the single implementation of the segmented-carry loop (apps use it
        rather than re-rolling it).
        """
        from sdr_tpu.parallel.sharded import run_time_batched
        cs = carries if carries is not None else self.init()

        def flush(buf):
            x = jnp.asarray(np.concatenate(buf))
            cs2, y = run_time_batched(self.ops, x, len(buf), carries=cs,
                                      return_carries=True)
            return cs2, np.asarray(y)

        buf = []
        for blk in source:
            buf.append(np.asarray(blk))
            if len(buf) == parallel_blocks:
                cs, y = flush(buf)
                buf = []
                yield y
        if buf:
            _, y = flush(buf)
            yield y

    def process(self, signal, carries=None, parallel_blocks: int = None):
        """Convenience: chop a recorded signal [..., N] into blocks, scan,
        and concatenate the per-block outputs back along the stream axis.

        Works for 1-D-per-block ops (output [..., M]) and frame-producing
        ops like :class:`FftStream` (output [..., frames, size], frames
        concatenated).

        ``parallel_blocks=B``: process the signal in segments of B blocks,
        each segment block-PARALLEL
        (:func:`sdr_tpu.parallel.run_time_batched`) with streaming state
        threaded exactly across segment seams — the offline-throughput
        path, bounded to B blocks of device memory per dispatch.  Requires
        every op to support time sharding; output equals the sequential
        run exactly (tests/test_quantized.py)."""
        if parallel_blocks is not None:
            from sdr_tpu.parallel.sharded import run_time_batched
            signal = jnp.asarray(signal)
            n = signal.shape[-1]
            nblocks = n // self.block_in
            if nblocks == 0:
                raise ValueError(f"signal shorter than one block "
                                 f"({self.block_in})")
            x = signal[..., : nblocks * self.block_in]
            cs = carries if carries is not None else self.init()
            outs = []
            pos = 0
            while pos < nblocks:
                g = min(parallel_blocks, nblocks - pos)
                seg = x[..., pos * self.block_in:(pos + g) * self.block_in]
                cs, y = run_time_batched(self.ops, seg, g, carries=cs,
                                         return_carries=True)
                outs.append(y)
                pos += g
            t_axis = (self.ops[-1].time_axis_out if self.ops else -1)
            return cs, jnp.concatenate(outs, axis=t_axis)
        signal = jnp.asarray(signal)
        n = signal.shape[-1]
        nblocks = n // self.block_in
        x = signal[..., : nblocks * self.block_in]
        lead = x.shape[:-1]
        blocks = jnp.moveaxis(
            x.reshape(lead + (nblocks, self.block_in)), -2, 0)
        carries, ys = self.scan(blocks, carries)
        return carries, self._restack(ys, lead, self._time_axis_out())

    def _time_axis_out(self) -> int:
        return self.ops[-1].time_axis_out if self.ops else -1

    @staticmethod
    def _restack(ys, lead, time_axis_out: int = -1):
        """[nblocks, *lead, ...per-block] -> [*lead, ...] with the block
        axis merged into the chain's stream/time axis.

        ``time_axis_out`` is the last op's ``time_axis_out`` (negative,
        relative to the per-block output): -1 for sample streams and
        Channelize ([..., C, n/C] — time innermost), -2 for FftStream
        ([..., frames, size] — the frame axis is the stream)."""
        if time_axis_out >= 0:
            raise ValueError("time_axis_out must be negative")
        t = ys.ndim + time_axis_out  # stacked position of the time axis
        out = jnp.moveaxis(ys, 0, t - 1)
        shape = (out.shape[: t - 1]
                 + (out.shape[t - 1] * out.shape[t],)
                 + out.shape[t + 1:])
        return out.reshape(shape)

    # -- checkpoint / resume ----------------------------------------------

    def checkpoint(self, carries, path: str) -> None:
        """Save the carry pytree (numpy .npz) for deterministic resume."""
        leaves, treedef = jax.tree.flatten(carries)
        np.savez(path, *[np.asarray(l) for l in leaves])

    def restore(self, path: str):
        """Load a carry pytree saved by :meth:`checkpoint`."""
        ref = self.init()
        leaves, treedef = jax.tree.flatten(ref)
        with np.load(path) as data:
            loaded = [data[k] for k in data.files]
        if len(loaded) != len(leaves):
            raise ValueError("checkpoint does not match pipeline structure")
        for i, (l, r) in enumerate(zip(loaded, leaves)):
            if tuple(l.shape) != tuple(r.shape):
                raise ValueError(
                    f"checkpoint leaf {i} has shape {tuple(l.shape)}, "
                    f"pipeline expects {tuple(r.shape)} — saved at a "
                    "different block size or from a different pipeline")
        loaded = [jnp.asarray(l, dtype=r.dtype) for l, r in
                  zip(loaded, leaves)]
        return jax.tree.unflatten(treedef, loaded)

    def __repr__(self):
        stages = " >-> ".join(
            f"{op!r}[{n_in}->{n_out}]" for op, n_in, n_out in
            zip(self.ops, self.lens[:-1], self.lens[1:]))
        return f"Pipeline({stages})"
