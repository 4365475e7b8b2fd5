"""Demodulation.

FM: reference SDR/Demod.hs:20-46 — per-sample ``phase(x[n] * conj(x[n-1]))``
with the previous sample carried across blocks.  The reference runs this as
a sequential stream fold; here it is a pure shift-and-multiply (the
"recurrence" only reads one sample back, so it vectorizes exactly).

AM: envelope detection ``|x|`` (the reference has no dedicated AM module;
its airband config composes mixer + magnitude + audio filter — BASELINE
config #4).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = ["fm_demod", "fm_demod_planar", "am_demod", "fm_mod",
           "fast_atan2"]

# atan(z) = z * P(z^2) on [0, 1]: degree-6 Chebyshev-LSQ fit, max error
# 5.8e-7 rad — below f32 resolution of the result, 4 orders inside the
# 0.01 differential bound.  Vs jnp.arctan2's libm-style lowering this is
# plain mul/add/select, which matters at the demod's sample rate.
_ATAN_P = (0.00809729493, -0.0377517076, 0.0847596977, -0.135376751,
           0.198950258, -0.33327976, 0.999999715)


def fast_atan2(b, a):
    """Polynomial atan2(b, a) (radians, branch-matched to jnp.arctan2 for
    all quadrants; atan2(0, 0) = 0).  Max error 5.8e-7 rad."""
    b = jnp.asarray(b, dtype=jnp.float32)
    a = jnp.asarray(a, dtype=jnp.float32)
    ab, aa = jnp.abs(b), jnp.abs(a)
    hi = jnp.maximum(aa, ab)
    z = jnp.minimum(aa, ab) / jnp.where(hi == 0, jnp.float32(1), hi)
    z2 = z * z
    p = jnp.float32(_ATAN_P[0])
    for c in _ATAN_P[1:]:
        p = p * z2 + jnp.float32(c)
    r = p * z
    r = jnp.where(ab > aa, jnp.float32(np.pi / 2) - r, r)
    r = jnp.where(a < 0, jnp.float32(np.pi) - r, r)
    return jnp.where(b < 0, -r, r)


def fm_mod(x, sensitivity: float, phase=0.0, amplitude: float = 1.0):
    """FM-modulate a real signal to complex baseband (the transmit-side
    inverse of :func:`fm_demod`):

        phi[n] = phi[n-1] + sensitivity * x[n];   y[n] = A * e^{j phi[n]}

    ``sensitivity`` is radians/sample per unit input (2*pi*deviation/fs).
    The phase integral is a cumulative sum — associative, so it runs as a
    parallel scan, and the carry is the final phase (wrapped) for seamless
    blockwise/streaming modulation.  The reference has no modulator (its
    transmit support stops at sample-format conversion, Util.hs:191-211);
    this completes the chain so ``fm_demod(fm_mod(x)) == x``.

    Returns ``(y, final_phase)``.
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    phi = jnp.cumsum(sensitivity * x, axis=-1) + jnp.asarray(
        phase, dtype=jnp.float32)[..., None]
    y = amplitude * jnp.exp(1j * phi).astype(jnp.complex64)
    final = jnp.mod(phi[..., -1], 2 * np.pi)
    return y, final


def fm_demod(x, last=None):
    """FM demodulate a complex block: y[n] = angle(x[n] * conj(x[n-1])).

    ``last`` is the final sample of the previous block (the carry the
    reference threads through its pipe, Demod.hs:39-46).  Defaults to 0+0j,
    matching the reference's initial state — ``phase 0 == 0`` in Haskell and
    ``jnp.angle(0) == 0`` here, so the very first output is 0.

    Returns ``(y, new_last)``; ``new_last = x[..., -1]``.
    """
    if last is None:
        last = jnp.zeros(x.shape[:-1], dtype=x.dtype)
    # shifted views instead of a concat([last, x[:-1]]) prev buffer (a
    # full-block copy per step); see fm_demod_planar
    y_main = jnp.angle(x[..., 1:] * jnp.conj(x[..., :-1]))
    y0 = jnp.angle(x[..., 0:1] * jnp.conj(jnp.asarray(last)[..., None]))
    return jnp.concatenate([y0, y_main], axis=-1), x[..., -1]


def fm_demod_planar(x, last=None, atan2: str = "exact"):
    """:func:`fm_demod` on planar-complex input ``x[..., 2, n]`` (component
    plane axis at -2, real first).

    The planar layout is the split representation of complex streams:
    complex64 in memory is interleaved (re, im) pairs, so every op that
    consumes it as separate components pays a stride-2 lane relayout of the
    whole block; planar streams pay it nowhere.  Same math as
    angle(x * conj(prev)) expanded into atan2.

    ``atan2``: 'exact' uses jnp.arctan2; 'poly' uses :func:`fast_atan2`
    (5.8e-7 rad max error, plain arithmetic — the fast path).

    ``last``: previous block's final sample as ``[..., 2]`` (zeros
    default).  Returns ``(y[..., n], new_last[..., 2])``.
    """
    if last is None:
        last = jnp.zeros(x.shape[:-2] + (2,), dtype=x.dtype)
    last = jnp.asarray(last)
    at2 = fast_atan2 if atan2 == "poly" else jnp.arctan2
    # No ``prev`` buffer: a concat([last, x[:-1]]) input would be a full
    # planar copy of the block per step.  Main outputs read x through
    # adjacent shifted views (elementwise -> fuses); the single seam
    # output comes from the carry; the output concat is a fusion root
    # (both parts write straight into one buffer, no extra pass).
    re, im = x[..., 0, :], x[..., 1, :]
    pre, pim = re[..., :-1], im[..., :-1]
    y_main = at2(im[..., 1:] * pre - re[..., 1:] * pim,
                 re[..., 1:] * pre + im[..., 1:] * pim)
    l_re, l_im = last[..., 0:1], last[..., 1:2]
    y0 = at2(im[..., 0:1] * l_re - re[..., 0:1] * l_im,
             re[..., 0:1] * l_re + im[..., 0:1] * l_im)
    return jnp.concatenate([y0, y_main], axis=-1), x[..., :, -1]


def am_demod(x):
    """AM envelope: y[n] = |x[n]|.  Stateless."""
    return jnp.abs(x)
