"""Generic IIR filtering as parallel associative scans.

The reference's only IIR is the hard-coded DC blocker (filter.c:152-161).
A production SDR toolkit needs general IIR sections (audio de-emphasis,
notch filters, channel equalizers), and the parallel formulation is the
same trick ops/scans.py uses for the first-order case, generalized: a
linear recurrence of order ``p``

    y[n] = b[n] + sum_{k=1..p} a_k * y[n-k]

is an affine map on the state vector s[n] = (y[n], ..., y[n-p+1]):
s[n] = M s[n-1] + e_0 b[n], and affine-map composition is associative —
so the whole recurrence evaluates in O(log n) depth with
``lax.associative_scan`` over (matrix, vector) pairs.  Exact (no
truncation), unlike scan-free IIR approximations.

``sosfilt`` applies cascaded biquad sections (scipy ``sos`` layout) in
transposed direct-form II, each section one order-2 scan.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["linear_recurrence", "biquad", "sosfilt", "deemphasis_taps"]


def linear_recurrence(coeffs, b, y0=None):
    """Evaluate y[n] = b[n] + sum_k coeffs[k] * y[n-k-1] exactly.

    ``coeffs``: [p] feedback coefficients (a_1..a_p).  ``b``: [..., N]
    driving term.  ``y0``: [..., p] initial state (y[-1], ..., y[-p]),
    zeros by default.  Returns y [..., N].
    """
    coeffs = np.asarray(coeffs, dtype=np.float32)
    p = coeffs.shape[0]
    if p == 1:
        from sdr_tpu.ops.scans import linear_scan
        a = jnp.full_like(b, float(coeffs[0]))
        init = jnp.zeros(b.shape[:-1]) if y0 is None else y0[..., 0]
        return linear_scan(a, b, init)

    # companion matrix acting on (y[n-1], ..., y[n-p])
    M = np.zeros((p, p), dtype=np.float32)
    M[0, :] = coeffs
    M[1:, :-1] = np.eye(p - 1, dtype=np.float32)

    n = b.shape[-1]
    batch = b.shape[:-1]
    Ms = jnp.broadcast_to(jnp.asarray(M), batch + (n, p, p))
    vs = jnp.zeros(batch + (n, p)).at[..., 0].set(b)

    def combine(l, r):
        Ml, vl = l
        Mr, vr = r
        return (jnp.matmul(Mr, Ml),
                jnp.einsum("...ij,...j->...i", Mr, vl) + vr)

    # prefix pairs (A_n, c_n) with s[n] = A_n s[-1] + c_n
    As, cs = jax.lax.associative_scan(combine, (Ms, vs), axis=-3)
    if y0 is not None:
        cs = cs + jnp.einsum("...nij,...j->...ni", As, jnp.asarray(y0))
    return cs[..., 0]


def biquad(b, a, x, zi=None):
    """One second-order section: scipy-convention coefficients
    (b0,b1,b2)/(a0,a1,a2), a0 normalized to 1.  Returns y [..., N].

    Feedforward is a tiny FIR (vectorized); feedback is the order-2
    associative scan.
    """
    b = np.asarray(b, dtype=np.float32)
    a = np.asarray(a, dtype=np.float32)
    b = b / a[0]
    a = a / a[0]
    x = jnp.asarray(x, dtype=jnp.float32)
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(2, 0)])
    drive = (b[0] * xp[..., 2:] + b[1] * xp[..., 1:-1] + b[2] * xp[..., :-2])
    y0 = zi if zi is not None else None
    return linear_recurrence(np.array([-a[1], -a[2]], dtype=np.float32),
                             drive, y0)


def sosfilt(sos, x):
    """Cascade of second-order sections (scipy ``sos`` array [S, 6])."""
    sos = np.asarray(sos, dtype=np.float32)
    for s in range(sos.shape[0]):
        x = biquad(sos[s, :3], sos[s, 3:], x)
    return x


def deemphasis_taps(fs: float, tau: float = 75e-6):
    """FM broadcast de-emphasis (single-pole RC): (b, a) for biquad.

    tau = 75 us in the Americas, 50 us in Europe.
    """
    # bilinear transform of H(s) = 1 / (1 + s*tau)
    c = 2 * fs
    b0 = 1.0 / (1 + c * tau)
    a1 = (1 - c * tau) / (1 + c * tau)
    return (np.array([b0, b0, 0.0], dtype=np.float32),
            np.array([1.0, a1, 0.0], dtype=np.float32))
