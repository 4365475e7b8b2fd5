"""Canonical receive-chain constructors (the judged BASELINE configs).

The tap sets are designed in-process with the framework's own design layer
(ops/design.py) at the same band-edge specs the reference's example filters
were designed to offline in Octave (examples/fm/Coeffs.hs comments:
remez(50,[0 .08 .125 1]), remez(30,[0 .1 .3 1]), remez(63,[0 .3125 .39 1]))
— designs are regenerated, not copied.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from sdr_tpu.ops import design
from sdr_tpu.stream import (Agc, AmDemod, DcBlocker, Fir, FftStream,
                            FmDemod, IqConvertU8, Mix, Scale)

__all__ = ["fm_taps", "fm_chain", "am_chain", "waterfall_chain",
           "channelizer_chain"]


def fm_taps():
    """(rf_decim 51, audio_resamp 31, audio_filter 64) tap sets for the
    broadcast-FM chain, same specs as the reference's example."""
    rf = design.remez(51, [0, 0.08, 0.125, 1.0], [1, 0])
    ars = design.remez(31, [0, 0.1, 0.3, 1.0], [1, 0])
    afl = design.remez(64, [0, 0.3125, 0.39, 1.0], [1, 0])
    return rf, ars, afl


def fm_chain(volume: float = 0.2, method: str = "auto",
             planar: bool = False, front: str = "fused",
             front_precision: str = "s8", front_q_out: int | None = None,
             atan2: str = "poly",
             stereo: bool = False, fs_in: float = 1_280_000.0,
             deemphasis: float | None = None,
             deemphasis_mode: str = "iir"):
    """Broadcast FM receiver ops (config #1; examples/fm/fm.hs:32-41):
    u8 IQ -> decimate 8 -> FM demod -> 3/10 resample -> audio FIR -> volume.

    1.28 MS/s in, 48 kS/s mono audio out.

    ``planar=True``: the complex segment (convert -> decimate -> demod)
    runs in the planar-complex f32 layout — identical samples, no
    complex64 materialization anywhere (see IqConvertU8).

    ``front``: 'exact' keeps convert and decimate as separate f32 stages
    (with the planar/complex demod per ``planar``).  'fused' is
    :class:`~sdr_tpu.stream.U8FrontDemod`: convert + decimate + demod
    with f32 taps, one Pallas kernel on the GPU and the plain XLA stages
    on the CPU (polynomial atan2).  'quantized' fuses convert and
    decimate into integer matmuls (U8FrontEnd) followed by the planar
    demod; ``front_precision`` picks 's8' (one 8-bit band) or 's16'
    (hi/lo split taps).  For the FM chain the two are indistinguishable:
    the demod's atan2 normalizes the front's amplitude-quantization
    error — chain-level max audio difference vs the exact f32 front of
    8.6e-6 (s8) / 6e-8 (s16) on a synthetic 75 kHz-deviation broadcast
    signal (tests/test_quantized.py) — 1000x inside the reference's 0.01
    differential bound.  The raw-filter worst case (uniform(-10,10)
    white data, no demod behind it) remains ~8e-3 for s8; pick s16
    explicitly for non-FM uses of U8FrontEnd if that matters.
    ``front_q_out``: the quantized front's band geometry (outputs per
    window row; identical samples at any value, see ops/quantized.py).
    ``atan2``: 'poly' (the planar-demod default, 5.8e-7 rad absolute
    error) or 'exact'; the complex-path demod is always exact.

    ``stereo=True`` decodes the stereo multiplex (beyond the reference's
    mono example): a :class:`~sdr_tpu.stream.StereoDecode` stage after
    the demod splits L/R at the composite rate, and the existing
    resampler/audio stages batch over the [2] channel axis unchanged —
    output blocks are ``[2, n]`` at 48 kS/s.

    ``deemphasis``: RC time constant in seconds (75e-6 in the Americas,
    50e-6 in Europe) — adds the standard broadcast de-emphasis at the
    audio rate.  ``deemphasis_mode='iir'`` (default) is the true
    single-pole IIR as an :class:`~sdr_tpu.stream.Iir` stage — exact
    response, and it time-shards exactly via the matrix affine-prefix
    carry (parallel/halo.py).  ``'fir'`` substitutes the 64-tap
    truncated-impulse-response FIR (truncation error ~1e-8 at 48 kHz).
    ``None`` (default) omits the stage, matching the reference's example
    chain.
    """
    if front not in ("exact", "fused", "quantized"):
        raise ValueError(f"unknown front {front!r}")
    rf, ars, afl = fm_taps()
    back = [Fir.resampler(ars, 3, 10, method=method),
            Fir.filter(afl, method=method),
            Scale(volume)]
    if deemphasis is not None:
        from sdr_tpu.ops.iir import biquad, deemphasis_taps
        audio_fs = fs_in / 8 * 3 / 10
        b, a = deemphasis_taps(audio_fs, deemphasis)
        pos = len(back) - 1          # just before the final Scale
        if deemphasis_mode == "iir":
            from sdr_tpu.stream import Iir
            back.insert(pos, Iir(np.concatenate([b, a])))
        elif deemphasis_mode == "fir":
            impulse = np.zeros(64, dtype=np.float32)
            impulse[0] = 1.0
            h = np.asarray(biquad(b, a, impulse), dtype=np.float32)
            back.insert(pos, Fir.filter(h, method=method))
        else:
            raise ValueError(f"unknown deemphasis_mode {deemphasis_mode!r}")
    if stereo:
        from sdr_tpu.stream import StereoDecode
        back = [StereoDecode(fs=fs_in / 8), *back]
    if front == "fused":
        from sdr_tpu.stream import U8FrontDemod
        return [U8FrontDemod(rf, 8), *back]
    if front == "quantized":
        from sdr_tpu.stream import U8FrontEnd
        return [U8FrontEnd(rf, 8, precision=front_precision,
                           q_out=front_q_out),
                FmDemod(planar=True, atan2=atan2), *back]
    return [IqConvertU8(planar=planar),
            Fir.decimator(rf, 8, method=method),
            FmDemod(planar=planar, atan2=atan2 if planar else "exact"),
            *back]


def am_chain(if_freq: float = 0.25, decim: int = 16, agc_mu: float = 0.005,
             volume: float = 0.5, method: str = "auto",
             agc_approx: int | None = None, planar: bool | None = None):
    """AM/airband receiver ops (config #4): u8 IQ -> mix the carrier at
    ``if_freq`` (cycles/sample) to DC -> decimating channel filter ->
    AGC -> envelope -> DC block -> volume.

    ``planar`` (default: True unless ``agc_approx`` selects the
    sequential AGC, which is complex-form only): the whole chain runs in
    the planar-complex layout — f32 with a [2] plane axis that the FIR
    decimator batches over, a (cos, sin) LO rotation, and the AGC gain
    scanned from the all-real envelope.  complex64 is never
    materialized (DESIGN §2).

    The default AGC is the linear associative-scan form
    (:class:`~sdr_tpu.stream.Agc` ``method='linear'``): parallel and
    time-shardable exactly, so the chain runs block-parallel
    (``run_time_batched`` / ``run_time_sharded``) out of the box.
    ``agc_approx=R`` instead selects the literal sequential AGC with the
    R-sweep approximate sharding (the pathological-regime fallback)."""
    if planar is None:
        planar = agc_approx is None
    if planar and agc_approx is not None:
        raise ValueError("agc_approx (the sequential-AGC fallback) is "
                         "complex-form only; pass planar=False")
    chan = design.windowed_sinc(64, 1.0 / decim, design.hamming)
    agc = (Agc(agc_mu, 1.0, planar=planar) if agc_approx is None
           else Agc(agc_mu, 1.0, method="scan",
                    approx_time_sharding=agc_approx))
    # DC removal is the reference's dcBlocker IIR (filter.c:152-161), NOT
    # a per-block mean subtraction: the mean of the LOCAL block/shard is
    # not the stream's DC, so a mean-subtract Map breaks the
    # blockwise==one-shot contract and sharded==sequential equality (the
    # planar differential test caught the old Map form doing exactly
    # that).  DcBlocker carries (last_sample, last_output) and
    # time-shards exactly via the affine prefix.
    return [IqConvertU8(planar=planar),
            Mix(-if_freq, planar=planar),
            Fir.decimator(chan, decim, method=method),
            agc,
            AmDemod(planar=planar),
            DcBlocker(),
            Scale(volume)]


def waterfall_chain(fft_size: int = 1024, hop: int = 512,
                    planar: bool = True):
    """Spectral waterfall ops (config #3): u8 IQ -> windowed overlapping
    FFT magnitude rows (the fork->fftw->plotWaterfall chain of the
    reference).  ``planar`` (default) keeps the whole chain in planar
    f32 — complex64 never exists (see FftStream)."""
    if planar:
        return [IqConvertU8(planar=True),
                FftStream(fft_size, hop, window=design.blackman(fft_size),
                          planar=True)]
    return [IqConvertU8(),
            FftStream(fft_size, hop, window=design.blackman(fft_size))]


def channelizer_chain(n_channels: int = 64, method: str = "auto",
                      wideband: bool = False):
    """Multi-channel FM bank (config #5).

    ``wideband=False``: input [n_channels, N] complex baseband (one row
    per tuned channel), each demodulated independently — batched over the
    leading dim, shard rows over a mesh 'c' axis.

    ``wideband=True``: input is ONE wideband complex stream at
    n_channels * 1.28 MS/s; a polyphase DFT filterbank splits it into the
    per-channel basebands first (ops/channelize.py), then the same
    per-channel chain runs batched over the emitted channel axis.
    """
    from sdr_tpu.stream import Channelize
    from sdr_tpu.ops.channelize import channelizer_taps
    rf, ars, afl = fm_taps()
    per_channel = [Fir.decimator(rf, 8, method=method),
                   FmDemod(),
                   Fir.resampler(ars, 3, 10, method=method),
                   Fir.filter(afl, method=method),
                   Scale(0.2)]
    if wideband:
        return [Channelize(channelizer_taps(n_channels, 12), n_channels),
                *per_channel]
    return per_channel
