"""Spectral analysis: FFTs, windowed frames, spectrogram/waterfall.

Reference: hs_sources/SDR/FFT.hs — FFTW-backed complex (fftw', FFT.hs:44-76)
and real (fftwReal', FFT.hs:79-111) DFT pipes, plus ``fftwParallel``
(FFT.hs:118-168), a thread pool performing DFTs in a software pipeline with
in-order reassembly.

Here the pool disappears: frames are *batched* into one array and a single
``jnp.fft.fft`` (cuFFT on the GPU) transforms the batch, preserving order
by construction.  ``spectrogram`` packages the windowed-overlapping-frame
pipeline (BASELINE config #3, the waterfall).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax.numpy as jnp

from sdr_tpu.ops import design

__all__ = ["fft", "rfft", "frame", "spectrogram", "waterfall_image"]


def fft(x, axis: int = -1):
    """Complex-to-complex DFT (unnormalized forward, FFTW convention).

    Reference: fftw' (FFT.hs:44-76).  Works batched over leading dims — the
    batched form subsumes ``fftwParallel`` (FFT.hs:118-168).
    """
    return jnp.fft.fft(jnp.asarray(x), axis=axis)


def rfft(x, axis: int = -1):
    """Real-to-complex DFT, n//2+1 bins.  Reference: fftwReal' (FFT.hs:79-111)."""
    return jnp.fft.rfft(x, axis=axis)


def frame(x, size: int, hop: Optional[int] = None, window=None):
    """Slice [..., N] into overlapping frames [..., num_frames, size].

    ``hop`` defaults to ``size`` (no overlap).  ``window`` is an optional
    [size] taper (e.g. ``design.hanning(size)``) applied to every frame —
    the window re-exports of FFT.hs:6-9.
    """
    if hop is None:
        hop = size
    n = x.shape[-1]
    num = (n - size) // hop + 1
    if num < 1:
        raise ValueError("input shorter than one frame")
    if size % hop == 0:
        # gather-free: frame m = concat of k consecutive hop-rows of the
        # FREE [.., n/hop, hop] reshape — k shifted views, one fused
        # materialization instead of an index gather.
        k = size // hop
        rows = x[..., : (num + k - 1) * hop].reshape(
            x.shape[:-1] + (num + k - 1, hop))
        frames = jnp.concatenate(
            [rows[..., i: i + num, :] for i in range(k)], axis=-1)
    else:
        idx = (np.arange(num)[:, None] * hop
               + np.arange(size)[None, :]).astype(np.int32)
        frames = jnp.take(x, jnp.asarray(idx), axis=-1)
    if window is not None:
        frames = frames * jnp.asarray(window, dtype=frames.dtype)
    return frames


def spectrogram(x, size: int, hop: Optional[int] = None, window=None,
                shift: bool = True):
    """Windowed overlapping FFT magnitude frames (the waterfall pipeline).

    Returns [..., num_frames, size] power rows (|X|), DC-centered when
    ``shift``.  This is the batched formulation of the reference's
    fork -> window -> fftw -> plotWaterfall chain (examples + Plot.hs:72).
    """
    if window is None:
        window = design.hanning(size)
    F = fft(frame(x, size, hop, window))
    if shift:
        F = jnp.fft.fftshift(F, axes=-1)
    return jnp.abs(F)


def waterfall_image(rows, filename: str, db: bool = True) -> None:
    """Save a spectrogram [frames, bins] as a PNG waterfall.

    The file-output analog of the reference's live OpenGL waterfall
    (Plot.hs:72-78); rendering to an image keeps the subsystem usable
    on a headless accelerator host.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    rows = np.asarray(rows)
    if db:
        rows = 20 * np.log10(np.maximum(rows, 1e-12))
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.imshow(rows, aspect="auto", origin="lower", cmap="viridis")
    ax.set_xlabel("frequency bin")
    ax.set_ylabel("frame")
    fig.savefig(filename, dpi=100)
    plt.close(fig)
