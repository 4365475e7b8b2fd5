"""FM transmitter CLI: WAV audio -> FM-modulated interleaved-i16 IQ file.

The transmit-side complement of apps/fm.py (the reference's transmit
support stops at sample-format conversion, Util.hs:191-211; this completes
the chain): audio at 48 kHz is upsampled x80/3 to 1.28 MS/s in two
polyphase stages, FM-modulated with exact cumulative-phase integration,
and written in BladeRF i16 interleaved format.

    python -m sdr_tpu.apps.fm_tx --in audio.wav --out tx.iq \
        --deviation 75K
"""

from __future__ import annotations

import argparse
import sys
import wave

import numpy as np
import jax.numpy as jnp

from sdr_tpu.ops import cfloat_to_iq_i16, design
from sdr_tpu.stream import Fir, FmMod, Pipeline
from sdr_tpu.utils import parse_size


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--in", dest="inp", required=True, help="input WAV")
    ap.add_argument("--out", default="tx.iq")
    ap.add_argument("--rate", default="1280K", type=parse_size,
                    help="output IQ sample rate")
    ap.add_argument("--deviation", default="75K", type=parse_size)
    ap.add_argument("--block", default="46080", type=parse_size,
                    help="audio samples per block")
    args = ap.parse_args(argv)

    with wave.open(args.inp) as wf:
        if wf.getnchannels() != 1:
            print("mono WAV required", file=sys.stderr)
            return 1
        audio_rate = wf.getframerate()
        pcm = np.frombuffer(wf.readframes(wf.getnframes()), dtype="<i2")
    audio = (pcm / 32768.0).astype(np.float32)

    if args.rate * 3 != audio_rate * 80:
        print(f"note: chain is fixed at x80/3 ({audio_rate} -> "
              f"{audio_rate * 80 // 3})", file=sys.stderr)

    # interpolation taps: cutoff at the original band edge, gain = I
    up1 = design.windowed_sinc(31, 0.1 * 3, design.hamming) * 10 / 3
    up2 = design.windowed_sinc(51, 0.1, design.hamming) * 8
    sens = 2 * np.pi * args.deviation / (audio_rate * 80 / 3)
    pipe = Pipeline(
        [Fir.resampler(up1, 10, 3),
         Fir.resampler(up2, 8, 1),
         FmMod(float(sens), amplitude=0.9)],
        block_in=args.block, in_dtype=jnp.float32)

    n = (len(audio) // args.block) * args.block
    if n == 0:
        print("input shorter than one block", file=sys.stderr)
        return 1
    _, iq = pipe.process(audio[:n])
    raw = np.asarray(cfloat_to_iq_i16(iq))
    raw.tofile(args.out)
    print(f"wrote {len(raw) // 2} IQ samples at {audio_rate * 80 // 3} Hz "
          f"to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
