"""Multi-channel FM channelizer (BASELINE config #5).

Demodulates N independent FM channels simultaneously, sharding channels
across the device mesh (and optionally time within each channel).  Input:
a raw complex64 file laid out [n_channels, N] (one baseband row per tuned
channel), or synthetic if --synthetic.

    python -m sdr_tpu.apps.channelizer --channels 64 --synthetic \
        --seconds 1 --out-prefix chan
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import jax

from sdr_tpu.apps.chains import channelizer_chain
from sdr_tpu import parallel
from sdr_tpu.io import wav_sink
from sdr_tpu.utils import parse_size


def synthesize(n_channels: int, n: int, fs: float, seed: int = 0):
    """Per-channel FM baseband carrying distinct audio tones."""
    rng = np.random.default_rng(seed)
    tones = 200.0 + 150.0 * np.arange(n_channels)
    t = np.arange(n) / fs
    out = np.empty((n_channels, n), dtype=np.complex64)
    for c in range(n_channels):
        audio = np.sin(2 * np.pi * tones[c] * t)
        phase = 2 * np.pi * 75e3 * np.cumsum(audio) / fs
        out[c] = 0.9 * np.exp(1j * phase)
    return out


def stack_wideband(x):
    """Stack ``[C, n]`` channel rows onto one wideband stream of ``C*n``
    samples, channel ``c`` rotated by ``c/C`` cycles per sample."""
    C, n = x.shape
    k = np.arange(C * n)
    wide = np.zeros(C * n, dtype=np.complex64)
    for c in range(C):
        up = np.zeros(C * n, dtype=np.complex64)
        up[::C] = x[c]  # naive upsample; filterbank rejects images
        wide += up * np.exp(2j * np.pi * (c / C) * k).astype(np.complex64)
    return wide


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--in", dest="inp", help="raw c64 file: [channels, N] "
                    "rows, or one wideband stream with --wideband")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--wideband", action="store_true",
                    help="input is one wideband stream at channels*rate; "
                    "split with the polyphase DFT filterbank first")
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--rate", default="1280K", type=parse_size,
                    help="per-channel sample rate")
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--out-prefix", default=None,
                    help="write per-channel WAVs with this prefix")
    ap.add_argument("--method", default="auto")
    args = ap.parse_args(argv)

    n = int(args.rate * args.seconds) // 80 * 80
    if args.synthetic or not args.inp:
        x = synthesize(args.channels, n, args.rate)
        if args.wideband:
            x = stack_wideband(x)
    else:
        x = np.fromfile(args.inp, dtype=np.complex64)
        if not args.wideband:
            x = x[: (len(x) // args.channels // 80) * 80 * args.channels]
            x = x.reshape(args.channels, -1)

    chain = channelizer_chain(args.channels, method=args.method,
                              wideband=args.wideband)
    n_dev = len(jax.devices())
    if args.wideband:
        x = x[: (len(x) // (args.channels * 80)) * args.channels * 80]
        n_t = n_dev
        while (len(x) // args.channels) % (n_t * 80) or len(x) % n_t:
            n_t -= 1
        mesh = parallel.make_mesh((n_t,), ("t",))
        y = parallel.run_time_sharded(chain, mesh, jax.device_put(x))
        n_c = n_t
    else:
        n_c = min(n_dev, args.channels)
        while args.channels % n_c:
            n_c -= 1
        mesh = parallel.make_mesh((n_c,), ("c",))
        y = parallel.run_channel_sharded(chain, mesh, jax.device_put(x))
    y = np.asarray(y)
    audio_rate = args.rate // 8 * 3 // 10
    print(f"demodulated {y.shape[0]} channels x {y.shape[1]} samples "
          f"at {audio_rate} Hz on {n_c} devices")
    if args.out_prefix:
        for c in range(y.shape[0]):
            w, close = wav_sink(f"{args.out_prefix}{c:03d}.wav", audio_rate)
            w(y[c])
            close()
        print(f"wrote {y.shape[0]} WAV files")
    return 0


if __name__ == "__main__":
    sys.exit(main())
