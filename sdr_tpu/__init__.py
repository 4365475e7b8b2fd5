"""sdr_tpu — a software-defined-radio signal-processing framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of
adamwalker/sdr (a Haskell + SIMD-C streaming DSP library).  The reference composes pull-based pipes of mutable
sample-block buffers with hand written SSE/AVX inner loops; sdr_tpu instead
expresses every operator as a pure block transform ``(carry, block) ->
(carry', out)`` over statically-shaped arrays, jitted and fused by XLA, with
the hot FIR/polyphase inner loops implemented as XLA convolutions and the
full-rate FM front as one Pallas GPU kernel, and with streams scaled across device
meshes via shard_map + halo exchange instead of cross-buffer functions.

Public API surface (mirrors the reference's module layout — reference
files cited per module):

- :mod:`sdr_tpu.ops`      — DSP math: FIR/decimate/resample engine, IQ
  conversion, scaling, frequency shift, FM/AM demod, AGC, DC blocker, FFT,
  filter design. (ref: SDR/Filter.hs, SDR/FilterInternal.hs, SDR/Util.hs,
  SDR/Demod.hs, SDR/FFT.hs, SDR/FilterDesign.hs, c_sources/*.c)
- :mod:`sdr_tpu.kernels`  — Pallas GPU kernels, Triton route (ref: c_sources/*.c)
- :mod:`sdr_tpu.stream`   — streaming runtime: stateful block operators,
  pipelines, rate metering (ref: pipes usage, SDR/PipeUtils.hs)
- :mod:`sdr_tpu.parallel` — mesh sharding, halo exchange, channelizer
  (ref: the cross-buffer protocol, SDR/Filter.hs:600-727)
- :mod:`sdr_tpu.io`       — file/UDP sources & sinks, serialization
  (ref: SDR/NetworkStream.hs, SDR/Serialize.hs, SDR/RTLSDRStream.hs)
- :mod:`sdr_tpu.apps`     — example receivers (ref: examples/fm/fm.hs)
"""

__version__ = "0.1.0"

from sdr_tpu.ops import (  # noqa: F401
    # conversion (SDR/Util.hs:91-211, c_sources/convert.c)
    iq_u8_to_cfloat,
    iq_i16_to_cfloat,
    cfloat_to_iq_i16,
    scale,
    # frequency shift (SDR/Util.hs:263-285)
    half_band_up,
    quarter_band_up,
    # FIR engine (SDR/FilterInternal.hs, c_sources/{filter,decimate,resample}.c)
    fir_filter,
    fir_decimate,
    fir_resample,
    FirSpec,
    # demodulation (SDR/Demod.hs)
    fm_demod,
    am_demod,
    # scans (c_sources/filter.c:152 dcBlocker, SDR/Util.hs:329-341 agc)
    dc_blocker,
    agc,
    # spectral (SDR/FFT.hs)
    fft,
    rfft,
    spectrogram,
    # design (SDR/FilterDesign.hs)
    sinc,
    hanning,
    hamming,
    blackman,
    windowed_sinc,
    srrc,
)
