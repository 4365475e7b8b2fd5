"""Live audio sink (optional) — the PulseAudio analog.

The reference plays demodulated audio in real time on a dedicated OS
thread behind a bounded-1 mailbox so pulse writes never stall the DSP
chain (hs_sources/SDR/Pulse.hs:18-33; 48 kHz mono F32).  Here the same
shape: a writer thread + bounded queue over the optional ``sounddevice``
package (PortAudio).  On a headless accelerator host the package is usually
absent — ``audio_available()`` gates it, and ``wav_sink`` (io/files.py)
is the recorded stand-in.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["audio_available", "audio_sink"]


def _import_sd():
    try:
        import sounddevice  # type: ignore
        return sounddevice
    except Exception:  # ImportError or PortAudio load failure
        return None


def audio_available() -> bool:
    """True if the optional sounddevice backend can be imported."""
    return _import_sd() is not None


def audio_sink(sample_rate: int = 48000, queue_blocks: int = 2,
               channels: int = 1):
    """Return (write, close) playing float blocks in [-1, 1] — mono
    ``[n]`` or planar ``[channels, n]`` (stereo decode output).

    Matches ``pulseAudioSink`` (Pulse.hs:18-23): playback runs on its own
    thread behind a bounded mailbox (``queue_blocks`` deep — the reference
    uses bounded-1) so a slow audio device back-pressures the producer at
    the mailbox, not inside the DSP chain.

    Raises ``RuntimeError`` if sounddevice is unavailable — callers
    should check :func:`audio_available` and fall back to ``wav_sink``.
    """
    sd = _import_sd()
    if sd is None:
        raise RuntimeError(
            "sounddevice not installed; use sdr_tpu.io.wav_sink for "
            "recorded output on headless hosts")
    q: "queue.Queue" = queue.Queue(maxsize=queue_blocks)
    stream = sd.OutputStream(samplerate=sample_rate, channels=channels,
                             dtype="float32")
    stream.start()
    done = object()

    def run():
        while True:
            blk = q.get()
            if blk is done:
                break
            stream.write(blk)
        stream.stop()
        stream.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def write(block):
        b = np.asarray(block, dtype=np.float32)
        if channels > 1:
            b = b.T                      # [channels, n] -> frames
        q.put(np.ascontiguousarray(b.reshape(-1, channels)))

    def close():
        q.put(done)
        t.join(timeout=10)

    return write, close
