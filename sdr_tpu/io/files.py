"""Recorded-signal file sources and sinks.

The reference streams vectors to/from Handles with cast-based zero-copy
serialization (SDR/Serialize.hs:70-83) and ingests live radios via an async
callback thread (SDR/RTLSDRStream.hs).  On an accelerator host the equivalents are:
memory-mapped block readers feeding ``jax.device_put`` (recorded IQ files in
the common SDR raw formats) and block writers, plus a WAV sink standing in
for the PulseAudio consumer (SDR/Pulse.hs — no audio device on the host).
"""

from __future__ import annotations

import wave
from typing import Iterator, Optional

import numpy as np

__all__ = [
    "iq_file_source",
    "follow_iq_file",
    "read_iq_file",
    "write_iq_file",
    "block_sink",
    "wav_sink",
    "IQ_DTYPES",
]

# raw interleaved formats used by common SDR hardware/tools
IQ_DTYPES = {
    "u8": np.uint8,      # RTL-SDR native
    "i16": np.int16,     # BladeRF native
    "f32": np.float32,   # GNU Radio float IQ
    "c64": np.complex64,
}


def read_iq_file(path, fmt: str = "u8", count: int = -1, offset: int = 0):
    """Read a whole raw IQ recording as a flat array of ``fmt`` items."""
    dtype = IQ_DTYPES[fmt]
    return np.fromfile(path, dtype=dtype, count=count, offset=offset)


def iq_file_source(path, block: int, fmt: str = "u8",
                   repeat: bool = False) -> Iterator[np.ndarray]:
    """Yield fixed-size blocks from a raw IQ file via mmap (zero host copy
    until device_put) — the recorded-file analog of ``sdrStream``
    (RTLSDRStream.hs:54-68).  Drops the trailing partial block."""
    dtype = IQ_DTYPES[fmt]
    data = np.memmap(path, dtype=dtype, mode="r")
    n = (len(data) // block) * block
    if n == 0:
        return
    while True:
        for i in range(0, n, block):
            yield np.asarray(data[i:i + block])
        if not repeat:
            return


def follow_iq_file(path, block: int, fmt: str = "u8",
                   poll: float = 0.2,
                   idle_timeout: Optional[float] = None,
                   from_end: bool = False) -> Iterator[np.ndarray]:
    """Tail a GROWING raw IQ file, yielding each complete block as it
    lands — the headless analog of following a live capture the way the
    reference's OpenGL plots follow a stream (Plot.hs:72-78).

    ``idle_timeout``: stop after this many seconds without file growth
    (None = follow forever).  ``from_end=True`` skips history and starts
    at the current end of file (tail -f semantics)."""
    import time

    dtype = IQ_DTYPES[fmt]
    item = np.dtype(dtype).itemsize
    nbytes = block * item
    with open(path, "rb") as fh:
        if from_end:
            fh.seek(0, 2)
            fh.seek(fh.tell() // nbytes * nbytes)
        idle = 0.0
        buf = b""
        while True:
            chunk = fh.read(nbytes - len(buf))
            if chunk:
                idle = 0.0
                buf += chunk
                if len(buf) == nbytes:
                    yield np.frombuffer(buf, dtype=dtype)
                    buf = b""
                continue
            if idle_timeout is not None and idle >= idle_timeout:
                return
            time.sleep(poll)
            idle += poll


def write_iq_file(path, x, fmt: Optional[str] = None) -> None:
    """Write an array as a raw IQ file (dtype taken from ``fmt`` or x)."""
    x = np.asarray(x)
    if fmt is not None:
        x = x.astype(IQ_DTYPES[fmt])
    x.tofile(path)


def block_sink(path, fmt: Optional[str] = None):
    """A consumer: call with blocks to append to a raw file.

    Returns (write, close).  The file analog of the reference's pipe
    consumers (Serialize.hs:78-83)."""
    fh = open(path, "wb")

    def write(block):
        b = np.asarray(block)
        if fmt is not None:
            b = b.astype(IQ_DTYPES[fmt])
        b.tofile(fh)

    return write, fh.close


def wav_sink(path, sample_rate: int = 48000, channels: int = 1):
    """A consumer writing 16-bit WAV — the headless stand-in for the
    reference's PulseAudio sink (Pulse.hs:18-33, 48 kHz mono float there;
    ``channels=2`` for the stereo decoder's [2, n] blocks).

    Returns (write, close); ``write`` takes float blocks in [-1, 1] —
    mono ``[n]`` or planar ``[channels, n]`` (interleaved on write).
    """
    wf = wave.open(str(path), "wb")
    wf.setnchannels(channels)
    wf.setsampwidth(2)
    wf.setframerate(sample_rate)

    def write(block):
        b = np.asarray(block, dtype=np.float64)
        if channels > 1:
            if b.ndim != 2 or b.shape[0] != channels:
                raise ValueError(f"expected [{channels}, n] block")
            b = b.T.reshape(-1)  # interleave frames
        elif b.ndim != 1:
            raise ValueError(
                "mono sink got a multi-channel block — pass channels= "
                "to wav_sink")
        pcm = np.clip(np.round(b * 32767), -32768, 32767).astype("<i2")
        wf.writeframes(pcm.tobytes())

    return write, wf.close
