"""Halo exchange primitives for time-sharded streams.

The direct generalization of the reference's cross-buffer protocol
(SDR/Filter.hs:600-611, FilterInternal.hs:397-423): an operator that needs
``H`` samples of history at a block seam gets them from the *left neighbor
shard* over ICI via ``jax.lax.ppermute`` instead of from a retained
previous buffer.  Shard 0 receives zeros — identical to the streaming
runtime's zero-padded warmup, so sharded output == single-device streamed
output exactly.

All functions here must be called inside ``shard_map`` with a named mesh
axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["left_halo", "right_shift_scalar", "substitute_first",
           "exclusive_affine_prefix", "exclusive_matrix_affine_prefix"]


def _rotate_right(v, axis_name: str, fill=0):
    """Full-rotation ppermute i -> (i+1) % n, then overwrite what shard 0
    received (the wrapped message from the last shard) with ``fill``.

    A *full* permutation rather than the open chain ``i -> i+1`` so the
    same code runs under ``shard_map`` (real collective over ICI) and under
    ``vmap`` with an ``axis_name`` (single-device block-parallel execution
    — vmap's ppermute batching rule requires a bijection).
    """
    n_shards = jax.lax.axis_size(axis_name)
    filled = jnp.full_like(v, fill)
    if n_shards == 1:
        return filled
    out = jax.lax.ppermute(v, axis_name,
                           [(i, (i + 1) % n_shards) for i in range(n_shards)])
    first = jax.lax.axis_index(axis_name) == 0
    return jnp.where(first, filled, out)


def left_halo(x, h: int, axis_name: str, fill=0):
    """Return the last ``h`` samples of the left neighbor's block.

    ``x``: this shard's local block [..., n].  Result: [..., h]; ``fill``
    on shard 0 (default zeros, identical to the streaming runtime's
    zero-padded warmup; raw-byte streams use their neutral code instead,
    e.g. 0x80 for excess-128 IQ).
    """
    if h > x.shape[-1]:
        raise ValueError(
            f"halo of {h} samples exceeds the {x.shape[-1]}-sample shard: "
            "a stage's history must come from one neighbor; use fewer "
            "shards or longer blocks")
    return _rotate_right(x[..., x.shape[-1] - h:], axis_name, fill)


def right_shift_scalar(v, axis_name: str):
    """Send a per-shard value to the right neighbor (shard 0 gets zeros)."""
    return _rotate_right(v, axis_name)


def substitute_first(value, initial, axis_name: str):
    """Replace shard 0's leaves of ``value`` with ``initial`` (a pytree of
    the same structure, unsharded) — injects the stream state entering a
    segmented run so consecutive segments continue exactly."""
    if initial is None:
        return value
    first = jax.lax.axis_index(axis_name) == 0
    return jax.tree.map(
        lambda i, v: jnp.where(first, jnp.asarray(i, v.dtype), v),
        initial, value)


def exclusive_affine_prefix(a, b, axis_name: str):
    """Exclusive prefix-composition of per-shard affine maps y -> a*y + b.

    Used to time-shard first-order linear recurrences (the DC blocker)
    *exactly*: each shard locally reduces its block to one affine map
    (a_d, b_d); this returns, per shard, the composition of all maps to its
    left, i.e. the recurrence state entering the shard (identity map on
    shard 0).  Implemented with one all_gather of two scalars per shard —
    O(devices) tiny values over ICI, negligible next to the sample data.
    """
    idx = jax.lax.axis_index(axis_name)
    As = jax.lax.all_gather(a, axis_name)   # [n_shards, ...]
    Bs = jax.lax.all_gather(b, axis_name)
    n = As.shape[0]
    mask = (jnp.arange(n) < idx)
    # compose left-to-right: (A, B) := (A*a_i, B*a_i + b_i) for i < idx
    def step(carry, ab):
        A, B = carry
        ai, bi, m = ab
        ai = jnp.where(m, ai, jnp.ones_like(ai))
        bi = jnp.where(m, bi, jnp.zeros_like(bi))
        return (A * ai, B * ai + bi), None

    (A, B), _ = jax.lax.scan(step, (jnp.ones_like(a), jnp.zeros_like(b)),
                             (As, Bs, mask))
    return A, B


def exclusive_matrix_affine_prefix(M, v, axis_name: str):
    """Exclusive prefix-composition of per-shard affine maps on state
    VECTORS, ``s -> M @ s + v`` with ``M [..., p, p]`` and ``v [..., p]``
    — the order-p generalization of :func:`exclusive_affine_prefix`.

    Used to time-shard order-p linear recurrences (:class:`~sdr_tpu.stream
    .Iir` biquad cascades) *exactly*: each shard reduces its block to one
    affine map on the recurrence state; this returns, per shard, the
    composition ``(A, b)`` of all maps to its left (identity on shard 0),
    i.e. the state entering the shard is ``A @ s_initial + b``.  One
    all_gather of p*(p+1) scalars per shard — O(devices * p^2) tiny
    values over ICI, negligible next to the sample data.  This is the
    generalization of the reference's cross-block recurrence carry
    (c_sources/filter.c:152-161) to arbitrary-order IIR under sharding.
    """
    idx = jax.lax.axis_index(axis_name)
    Ms = jax.lax.all_gather(M, axis_name)   # [n_shards, ..., p, p]
    vs = jax.lax.all_gather(v, axis_name)   # [n_shards, ..., p]
    n = Ms.shape[0]
    mask = jnp.arange(n) < idx
    eye = jnp.broadcast_to(jnp.eye(M.shape[-1], dtype=M.dtype), M.shape)

    # compose left-to-right: (A, b) := (M_i @ A, M_i @ b + v_i) for i < idx
    def step(carry, item):
        A, b = carry
        Mi, vi, m = item
        Mi = jnp.where(m, Mi, eye)
        vi = jnp.where(m, vi, jnp.zeros_like(vi))
        return (jnp.matmul(Mi, A),
                jnp.einsum("...ij,...j->...i", Mi, b) + vi), None

    (A, b), _ = jax.lax.scan(step, (eye, jnp.zeros_like(v)),
                             (Ms, vs, mask))
    return A, b
