"""DSP operator layer (the L2/L1/L0 math of the reference)."""

from sdr_tpu.ops.convert import (  # noqa: F401
    iq_u8_to_cfloat,
    iq_u8_to_planar,
    iq_i16_to_planar,
    iq_i16_to_cfloat,
    cfloat_to_iq_i16,
    scale,
    cplx_map,
)
from sdr_tpu.ops.shift import (  # noqa: F401
    half_band_up,
    quarter_band_up,
    oscillator,
    mix,
)
from sdr_tpu.ops.fir import (  # noqa: F401
    FirSpec,
    fir_filter,
    fir_decimate,
    fir_resample,
    resample_output_count,
    resample_end_offset,
    prepare_phase_table,
)
from sdr_tpu.ops.demod import (fm_demod, fm_demod_planar,  # noqa: F401
                               am_demod, fm_mod, fast_atan2)
from sdr_tpu.ops.scans import dc_blocker, agc, linear_scan  # noqa: F401
from sdr_tpu.ops.fftops import (  # noqa: F401
    fft,
    rfft,
    frame,
    spectrogram,
    waterfall_image,
)
from sdr_tpu.ops.design import (  # noqa: F401
    sinc,
    hanning,
    hamming,
    blackman,
    windowed_sinc,
    srrc,
    remez,
    frequency_response,
    plot_frequency,
)
from sdr_tpu.ops.channelize import (  # noqa: F401
    polyphase_channelize,
    channelizer_taps,
)
from sdr_tpu.ops.iir import (  # noqa: F401
    linear_recurrence,
    biquad,
    sosfilt,
    deemphasis_taps,
)
