"""Polyphase DFT-filterbank channelizer.

Extracts C equally-spaced channels from one wideband complex stream at
1/C-th the rate each — the standard SDR analysis filterbank, and the
wideband front end for BASELINE config #5's 64-channel FM bank.  (The
reference runs independent per-channel chains and has no wideband
channelizer; this is the batched generalization: the C mixer+decimator
chains collapse into one batched branch-FIR plus one FFT across branches.)

Derivation (correlation orientation matching the rest of the framework):
channel c is "mix down by c/C, low-pass, decimate by C":

    y_c[m] = sum_j h[j] * x[mC + j] * e^{-2*pi*i*c*(mC + j)/C}
           = sum_r w^{-cr} * v[r, m],        w = e^{2*pi*i/C}
    v[r, m] = sum_p h[pC + r] * x[(m + p)C + r]

i.e. polyphase-split x into C branches, filter branch r with taps
``h[r::C]``, then an FFT across the branch axis.  One batched
FIR + one batched FFT replace C mixer/filter chains — C times less work
than the direct form.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax.numpy as jnp

from sdr_tpu.ops import design

__all__ = ["polyphase_channelize", "channelizer_taps"]


def channelizer_taps(n_channels: int, taps_per_branch: int = 8,
                     cutoff_scale: float = 1.0) -> np.ndarray:
    """Prototype low-pass for a C-channel filterbank: windowed sinc with
    cutoff 1/C (scaled), length C * taps_per_branch."""
    n = n_channels * taps_per_branch
    return design.windowed_sinc(n, cutoff_scale / n_channels,
                                design.hamming) * n_channels


def polyphase_channelize(taps, n_channels: int, x,
                         num: Optional[int] = None, method: str = "auto"):
    """[..., N] complex wideband -> [..., C, M] channel streams.

    ``taps``: prototype low-pass (length padded up to a multiple of C).
    Channel c is centered at +c/C cycles/sample (wrap for negative).
    ``num`` limits output samples per channel (default: all computable,
    M = N//C - P + 1 with P = taps per branch).

    ``method``:

    * ``'stencil'`` ('auto' everywhere) — gather-free.
      The branch-filter sum ``v[m, r] = sum_p h[pC+r] * x[(m+p)C + r]``
      reads the FREE row-major reshape ``x2[..., m, r] = x[..., mC+r]``
      as P shifted views weighted by the tap rows: a P-term fused
      elementwise stencil (one device-memory pass post-fusion), with the
      branch axis contiguous.  The C-point branch DFT then runs along
      that last axis, and
      one output-side transpose produces the [..., C, M] channel layout.
    * ``'gather'`` — the old [..., C, num, P] window-gather + einsum
      form: the gather materializes P copies of the stream; kept as the
      differential oracle / tiny-input path.
    """
    C = int(n_channels)
    taps = np.asarray(taps, dtype=np.float32)
    P = -(-taps.shape[0] // C)
    h = np.zeros(C * P, dtype=np.float32)
    h[: taps.shape[0]] = taps
    h_poly = h.reshape(P, C)                        # [P, C], h_poly[p, r]

    x = jnp.asarray(x)
    n = x.shape[-1]
    usable = (n // C) * C
    if usable < n:
        x = x[..., :usable]
    m_total = usable // C
    if num is None:
        num = m_total - P + 1
    num = int(num)
    if num < 1:
        raise ValueError("input shorter than one filterbank window")
    if method == "auto":
        method = "stencil"

    if method == "gather":
        from sdr_tpu.ops.fir import _gather_windows
        # x_poly[..., r, m] = x[..., m*C + r]
        x_poly = jnp.swapaxes(x.reshape(x.shape[:-1] + (m_total, C)),
                              -1, -2)
        starts = np.arange(num, dtype=np.int64)
        W = _gather_windows(x_poly, starts, P,
                            jnp.arange(num, dtype=jnp.int32))
        v = jnp.einsum("...cmp,cp->...cm", W, jnp.asarray(h_poly.T))
        # DFT across branches: y[..., c, m] = sum_r v[..., r, m] w^{-cr}
        return jnp.fft.fft(v, axis=-2)
    if method != "stencil":
        raise ValueError(f"unknown method {method!r}")

    # stencil: free reshape, P weighted shifted views, lane-axis DFT
    x2 = x.reshape(x.shape[:-1] + (m_total, C))     # [..., m, r] free
    hb = jnp.asarray(h_poly)                        # [P, C]
    v = x2[..., 0:num, :] * hb[0]
    for p in range(1, P):
        v = v + x2[..., p:p + num, :] * hb[p]
    from sdr_tpu.ops import fftops
    Y = fftops.fft(v, axis=-1)                      # [..., num, C]
    return jnp.swapaxes(Y, -1, -2)
