"""Frequency shifting helpers.

Reference: ``halfBandUp`` / ``quarterBandUp`` (hs_sources/SDR/Util.hs:263-285)
— multiplication vectors that shift the spectrum by fs/2 and fs/4 — plus a
general complex oscillator (not in the reference but the standard
generalization used by its AM example via quarter-band shifts).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = ["half_band_up", "quarter_band_up", "mix", "oscillator",
           "oscillator_planar"]


def half_band_up(size: int, dtype=jnp.float32):
    """[1, -1, 1, -1, ...]: multiply to shift all frequencies up by fs/2.

    Reference: Util.hs:264-271.
    """
    v = np.ones(size, dtype=np.float32)
    v[1::2] = -1.0
    return jnp.asarray(v, dtype=dtype)


def quarter_band_up(size: int, dtype=jnp.complex64):
    """[1, i, -1, -i, ...]: multiply to shift all frequencies up by fs/4.

    Reference: Util.hs:273-285.
    """
    v = np.zeros(size, dtype=np.complex64)
    v[0::4] = 1
    v[1::4] = 1j
    v[2::4] = -1
    v[3::4] = -1j
    return jnp.asarray(v, dtype=dtype)


def oscillator(size: int, freq: float, phase: float = 0.0,
               dtype=jnp.complex64):
    """exp(j*(2*pi*freq*n + phase)) for n in [0, size): general mixer LO.

    ``freq`` is in cycles/sample.  Generated host-side in float64 so long
    streams don't accumulate phase error, then cast.
    """
    n = np.arange(size, dtype=np.float64)
    v = np.exp(1j * (2 * np.pi * freq * n + phase))
    return jnp.asarray(v, dtype=dtype)


def oscillator_planar(size: int, freq: float, phase: float = 0.0):
    """The planar-complex form of :func:`oscillator`: ``[2, size]`` f32
    ``(cos, sin)`` rows.  Planar chains never materialize complex64
    (DESIGN §2)."""
    n = np.arange(size, dtype=np.float64)
    ang = 2 * np.pi * freq * n + phase
    return jnp.asarray(np.stack([np.cos(ang), np.sin(ang)]).astype(
        np.float32))


def mix(x, lo):
    """Multiply a block by a local-oscillator vector (frequency shift)."""
    return x * lo
