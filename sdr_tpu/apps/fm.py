"""Broadcast FM receiver CLI (the examples/fm/fm.hs app).

Recorded capture:

    python -m sdr_tpu.apps.fm --in capture.iq --out audio.wav \
        --rate 1280K --block 1310720

Live radio via an rtl_tcp server (the sdrStream analog,
RTLSDRStream.hs:54-68):

    python -m sdr_tpu.apps.fm --in rtl_tcp://radiohost:1234 \
        --freq 90.2M --rate 1280K --block 1310720

Reads RTL-SDR-format u8 interleaved IQ, writes 48 kHz WAV — mono, or
stereo L/R with --stereo (multiplex decode) — or plays live with
--audio when the optional sounddevice backend is present.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import jax.numpy as jnp

from sdr_tpu.apps.chains import fm_chain
from sdr_tpu.io import iq_file_source, wav_sink
from sdr_tpu.stream import Pipeline, rate as rate_meter
from sdr_tpu.utils import parse_size


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--in", dest="inp", required=True,
                    help="input raw u8 interleaved IQ file, or "
                         "rtl_tcp://host:port for a live radio")
    ap.add_argument("--out", default="audio.wav", help="output WAV file")
    ap.add_argument("--rate", default="1280K", type=parse_size,
                    help="input sample rate (complex S/s), e.g. 1280K")
    ap.add_argument("--freq", type=parse_size, default="90200K",
                    help="center frequency for rtl_tcp sources, e.g. 90.2M")
    ap.add_argument("--gain", type=int, default=None,
                    help="tuner gain in tenths of dB (rtl_tcp; default "
                         "hardware AGC)")
    ap.add_argument("--ppm", type=int, default=0,
                    help="frequency correction in ppm (rtl_tcp)")
    ap.add_argument("--max-blocks", type=int, default=0,
                    help="stop after N input blocks (0 = until EOF)")
    ap.add_argument("--audio", action="store_true",
                    help="play live via sounddevice instead of WAV")
    ap.add_argument("--block", default="1310720", type=parse_size,
                    help="u8 items per block (must keep chain rates integral)")
    ap.add_argument("--volume", type=float, default=0.2)
    ap.add_argument("--method", default="auto",
                    choices=["auto", "direct", "conv"])
    ap.add_argument("--front", default="fused",
                    choices=["fused", "exact", "quantized"],
                    help="front end: 'fused' convert+decimate+demod with "
                         "f32 taps (one kernel on the GPU, plain XLA "
                         "stages on the CPU); 'exact' separate f32 "
                         "stages; 'quantized' integer-matmul "
                         "convert+decimate")
    ap.add_argument("--batched", type=int, default=0, metavar="B",
                    help="process B blocks block-parallel per dispatch "
                         "(offline-throughput path; 0 = stream "
                         "sequentially)")
    ap.add_argument("--meter", action="store_true",
                    help="print throughput while running")
    ap.add_argument("--native", action="store_true",
                    help="ingest via the C++ ring-buffer loader")
    ap.add_argument("--stereo", action="store_true",
                    help="decode the stereo multiplex (L/R WAV out)")
    ap.add_argument("--deemphasis", type=float, default=None,
                    metavar="TAU",
                    help="broadcast de-emphasis time constant in seconds "
                         "(75e-6 Americas, 50e-6 Europe; default off)")
    args = ap.parse_args(argv)

    pipe = Pipeline(fm_chain(args.volume, args.method, front=args.front,
                             stereo=args.stereo, fs_in=float(args.rate),
                             deemphasis=args.deemphasis),
                    block_in=args.block, in_dtype=jnp.uint8)
    # derive the audio rate from the pipeline's own static rate
    # propagation instead of re-encoding the chain's factors here
    # (block_in counts u8 ITEMS — two per complex sample at args.rate)
    audio_rate = 2 * args.rate * pipe.block_out // pipe.block_in
    if args.audio:
        from sdr_tpu.io import audio_sink
        write, close = audio_sink(audio_rate,
                                  channels=2 if args.stereo else 1)
    else:
        write, close = wav_sink(args.out, audio_rate,
                                channels=2 if args.stereo else 1)
    radio = None
    if args.inp.startswith("rtl_tcp://"):
        from sdr_tpu.io import RtlTcpParams, rtl_tcp_source
        radio = rtl_tcp_source(
            args.inp, RtlTcpParams(args.freq, args.rate,
                                   freq_correction=args.ppm,
                                   tuner_gain=args.gain), args.block)
        source = iter(radio)
    elif args.native:
        from sdr_tpu.io import native_file_source
        source = native_file_source(args.inp, args.block)
    else:
        source = iq_file_source(args.inp, args.block)
    if args.max_blocks:
        import itertools
        source = itertools.islice(source, args.max_blocks)
    if args.batched:
        blocks = pipe.run_batched(source, args.batched)
    else:
        blocks = pipe.run(source)
    if args.meter:
        blocks = rate_meter(blocks,
                            pipe.block_out * max(1, args.batched))
    n = 0
    for y in blocks:
        y = np.asarray(y)
        write(y)
        n += y.shape[-1]
    close()
    if radio is not None:
        radio.close()
        if radio.dropped:
            print(f"radio dropped {radio.dropped} blocks", file=sys.stderr)
    dest = "audio device" if args.audio else args.out
    print(f"wrote {n} audio samples at {audio_rate} Hz to {dest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
