"""Stateful per-sample recurrences: DC blocker and AGC.

DC blocker — reference c_sources/filter.c:152-161 (``dcBlocker``), an IIR:

    y[n] = x[n] - x[n-1] + alpha * y[n-1],  alpha = 0.997

carrying ``(lastSample, lastOutput)`` across blocks (Filter.hs:729-739).
The recurrence is *linear*, so instead of a sequential loop we evaluate it
exactly with a first-order linear associative scan
(``jax.lax.associative_scan`` over the composition of maps
``y -> a*y + b``) — O(log n) depth instead of O(n).

AGC — reference SDR/Util.hs:329-348 (``agc``/``agcPipe``):

    corrected[n] = x[n] * g[n]
    g[n+1]       = g[n] + mu * (reference - |corrected[n]|)

This recurrence LOOKS nonlinear in g (|x[n]*g| appears inside), but
``|x*g| = |x| * g`` whenever the gain is nonnegative, and then

    g[n+1] = g[n] * (1 - mu*|x[n]|) + mu*reference

is a first-order LINEAR recurrence in g — the same associative-scan form
as the DC blocker, O(log n) depth instead of a per-sample ``lax.scan``
(a million-sample sequential loop on an accelerator).  The
positive-gain premise holds in every sane operating regime: it can only
break if a single update overshoots, i.e. ``mu * |x[n]| * g[n] >
g[n] + mu*reference``, which requires ``mu*|x| > 1`` — a loop gain that
makes the true AGC unstable anyway.  ``method='linear'`` (the default)
uses this form; ``method='scan'`` keeps the literal sequential recurrence
as the oracle / pathological-regime fallback.  The linearization also
makes AGC time-shardable EXACTLY (per-shard affine maps composed by
``exclusive_affine_prefix``) — see stream.Agc.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["dc_blocker", "agc", "agc_gains", "linear_scan"]


def linear_scan(a, b, y0):
    """Exact evaluation of y[n] = a[n]*y[n-1] + b[n] with y[-1] = y0.

    Uses the associative composition (a2, b2)∘(a1, b1) = (a1*a2, a2*b1+b2)
    over the affine maps, evaluated with ``jax.lax.associative_scan``.
    Shapes: a, b: [..., N]; y0: [...].
    """
    b = jnp.asarray(b)
    a = jnp.asarray(a)
    b = b.at[..., 0].add(a[..., 0] * y0)

    def combine(l, r):
        al, bl = l
        ar, br = r
        return al * ar, bl * ar + br

    _, y = jax.lax.associative_scan(combine, (a, b), axis=-1)
    return y


def dc_blocker(x, last_sample=0.0, last_output=0.0, alpha=0.997):
    """DC blocking filter; returns (y, (new_last_sample, new_last_output)).

    Reference: filter.c:152-161.  First-order difference feeding a leaky
    integrator.  Implemented as u[n] = x[n]-x[n-1] then the linear scan
    y[n] = alpha*y[n-1] + u[n], computed exactly via associative scan.
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    last_sample = jnp.asarray(last_sample, dtype=jnp.float32)
    last_output = jnp.asarray(last_output, dtype=jnp.float32)
    prev = jnp.concatenate(
        [jnp.broadcast_to(last_sample[..., None], x.shape[:-1] + (1,)),
         x[..., :-1]], axis=-1)
    u = x - prev
    a = jnp.full_like(x, alpha)
    y = linear_scan(a, u, last_output)
    return y, (x[..., -1], y[..., -1])


def agc_affine(x, mu, reference):
    """The block's affine reduction of the (positive-gain) AGC recurrence:
    returns ``(A, B)`` with ``g_out = A * g_in + B`` — the carry algebra
    for exact time sharding (compose across shards with
    ``exclusive_affine_prefix``)."""
    mu = jnp.asarray(mu, dtype=jnp.float32)
    reference = jnp.asarray(reference, dtype=jnp.float32)
    a = 1.0 - mu * jnp.abs(x).astype(jnp.float32)
    A = jnp.prod(a, axis=-1)
    B = linear_scan(a, jnp.full_like(a, mu * reference),
                    jnp.zeros(x.shape[:-1], jnp.float32))[..., -1]
    return A, B


def agc_gains(m, mu, reference, state=1.0):
    """The linear-form AGC gain trajectory from REAL envelopes ``m``
    (= |x|): returns ``(g, final)`` with ``g[n]`` the gain applied to
    sample n and ``final`` the gain entering the next block.  All-real —
    the planar chains' form (``stream.Agc(planar=True)`` multiplies the
    (re, im) planes by ``g`` itself), split out so no complex value ever
    enters the associative scan."""
    state = jnp.asarray(state, dtype=jnp.float32)
    mu = jnp.asarray(mu, dtype=jnp.float32)
    reference = jnp.asarray(reference, dtype=jnp.float32)
    a = 1.0 - mu * m
    h = linear_scan(a, jnp.full_like(a, mu * reference), state)
    # h[n] = g[n+1]; outputs use g[n] = (state, h[:-1])
    g = jnp.concatenate(
        [jnp.broadcast_to(state[..., None], m.shape[:-1] + (1,)),
         h[..., :-1]], axis=-1)
    return g, h[..., -1]


def agc(x, mu, reference, state=1.0, method: str = "linear"):
    """Automatic gain control; returns (y, final_state).

    Reference: Util.hs:329-341.  state starts at 1 (Util.hs:348).
    Complex input; gain is real.  ``method='linear'`` (default) evaluates
    the recurrence as an associative linear scan — exact under the
    positive-gain premise (module docstring); ``'scan'`` is the literal
    sequential form (the oracle, and the choice for pathological
    ``mu*|x| > 1`` configurations).
    """
    state = jnp.asarray(state, dtype=jnp.float32)
    mu = jnp.asarray(mu, dtype=jnp.float32)
    reference = jnp.asarray(reference, dtype=jnp.float32)

    if method == "linear":
        g, final = agc_gains(jnp.abs(x).astype(jnp.float32), mu,
                             reference, state)
        return x * g.astype(x.dtype if not jnp.iscomplexobj(x)
                            else jnp.float32), final
    if method != "scan":
        raise ValueError(f"unknown agc method {method!r}")

    def step(g, s):
        corrected = s * g
        g_next = g + mu * (reference - jnp.abs(corrected))
        return g_next, corrected

    # scan over the last axis; move it to front.
    xt = jnp.moveaxis(x, -1, 0)
    final, yt = jax.lax.scan(step, jnp.broadcast_to(state, x.shape[:-1]), xt)
    return jnp.moveaxis(yt, 0, -1), final
