"""Sample-format conversion and scaling.

Equivalents of c_sources/convert.c and c_sources/scale.c and
their wrappers in hs_sources/SDR/Util.hs:91-255.  These are pure
elementwise ops that XLA fuses into neighbors; there is no reason for a
hand kernel (the reference needed SSE/AVX because scalar C was the
bottleneck; here the op disappears into the surrounding fusion).

Layout note: radio hardware delivers *interleaved* I/Q (convert.c:15-20
reads in[2i], in[2i+1]).  We accept the same interleaved layout with an
even trailing dimension.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "iq_u8_to_cfloat",
    "iq_u8_to_planar",
    "iq_i16_to_cfloat",
    "iq_i16_to_planar",
    "cfloat_to_iq_i16",
    "scale",
    "cplx_map",
]


def iq_u8_to_cfloat(x):
    """Interleaved unsigned-byte I/Q -> complex64, RTL-SDR format.

    Reference: ``interleavedIQUnsigned256ToFloat`` (Util.hs:91-98) /
    ``convertC`` (convert.c:15-20):  (v - 128) / 128  per component.

    Bitcasting each (I, Q) byte pair to one u16 and splitting with
    mask/shift keeps everything elementwise, with no stride-2
    deinterleave (little-endian: low byte is I).
    """
    x = jnp.asarray(x)
    u16 = jax.lax.bitcast_convert_type(
        x.reshape(x.shape[:-1] + (x.shape[-1] // 2, 2)), jnp.uint16)
    i = (u16 & jnp.uint16(0xFF)).astype(jnp.float32)
    q = (u16 >> jnp.uint16(8)).astype(jnp.float32)
    return jax.lax.complex((i - 128.0) / 128.0, (q - 128.0) / 128.0)


def iq_u8_to_planar(x):
    """Interleaved unsigned-byte I/Q -> planar float32 ``[..., 2, n]``.

    Same conversion as :func:`iq_u8_to_cfloat` but the result stays in the
    planar-complex layout (component plane axis at -2, real first) — the
    planar stream representation: complex64 is interleaved (re, im)
    pairs in memory, so handing downstream ops separate components from a
    complex array costs a stride-2 relayout of the whole block; a planar
    stream never pays it.
    """
    x = jnp.asarray(x)
    u16 = jax.lax.bitcast_convert_type(
        x.reshape(x.shape[:-1] + (x.shape[-1] // 2, 2)), jnp.uint16)
    i = (u16 & jnp.uint16(0xFF)).astype(jnp.float32)
    q = (u16 >> jnp.uint16(8)).astype(jnp.float32)
    return jnp.stack([(i - 128.0) / 128.0, (q - 128.0) / 128.0], axis=-2)


def iq_i16_to_planar(x):
    """Interleaved signed-16-bit I/Q -> planar float32 ``[..., 2, n]``
    (see :func:`iq_u8_to_planar`)."""
    x = jnp.asarray(x).astype(jnp.int16)
    i32 = jax.lax.bitcast_convert_type(
        x.reshape(x.shape[:-1] + (x.shape[-1] // 2, 2)), jnp.int32)
    i = ((i32 << jnp.int32(16)) >> jnp.int32(16)).astype(jnp.float32)
    q = (i32 >> jnp.int32(16)).astype(jnp.float32)
    return jnp.stack([i / 2048.0, q / 2048.0], axis=-2)


def iq_i16_to_cfloat(x):
    """Interleaved signed-16-bit I/Q -> complex64, BladeRF format.

    Reference: ``interleavedIQSigned2048ToFloat`` (Util.hs:141-149) /
    ``convertCBladeRF`` (convert.c:52-57):  v / 2048  per component.

    Same in-lane bitcast trick as :func:`iq_u8_to_cfloat`: each (I, Q)
    int16 pair becomes one i32; the halves are recovered with arithmetic
    shifts (sign-extending the low half via ``<< 16 >> 16``).
    """
    x = jnp.asarray(x).astype(jnp.int16)
    i32 = jax.lax.bitcast_convert_type(
        x.reshape(x.shape[:-1] + (x.shape[-1] // 2, 2)), jnp.int32)
    i = ((i32 << jnp.int32(16)) >> jnp.int32(16)).astype(jnp.float32)
    q = (i32 >> jnp.int32(16)).astype(jnp.float32)
    return jax.lax.complex(i / 2048.0, q / 2048.0)


def cfloat_to_iq_i16(x):
    """complex64 -> interleaved int16 I/Q for transmission (BladeRF).

    Reference: ``complexFloatToInterleavedIQSigned2048`` (Util.hs:191-199) /
    ``convertBladeRFTransmit`` (convert.c:87-101): scale by 2048, round,
    clamp to [-2048, 2047].

    Interleaving is the same layout trap in reverse: pack the two int16
    halves into one i32 elementwise, then bitcast down (the trailing [2]
    axis a narrowing bitcast appends is exactly the interleaved pair).
    """
    def q16(v):
        return jnp.clip(jnp.round(v * 2048.0), -2048, 2047).astype(jnp.int32)
    i, q = q16(x.real), q16(x.imag)
    packed = (q << jnp.int32(16)) | (i & jnp.int32(0xFFFF))
    pairs = jax.lax.bitcast_convert_type(packed, jnp.int16)  # [..., n, 2]
    return pairs.reshape(x.shape[:-1] + (2 * x.shape[-1],))


def scale(factor, x):
    """y = factor * x.  Reference: scale.c:15-20 / Util.hs:214-255."""
    return jnp.asarray(x) * jnp.asarray(factor, dtype=jnp.float32)


def cplx_map(f, x):
    """Apply ``f`` to the real and imaginary parts independently.

    Reference: ``cplxMap`` (Util.hs:258-261).
    """
    return jax.lax.complex(f(x.real), f(x.imag))
