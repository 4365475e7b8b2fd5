"""Streaming runtime: stateful block operators and pipelines."""

from sdr_tpu.stream.block import StreamOp  # noqa: F401
from sdr_tpu.stream.ops import (  # noqa: F401
    IqConvertU8,
    IqConvertI16,
    U8FrontEnd,
    U8FrontDemod,
    Fir,
    FmDemod,
    AmDemod,
    Agc,
    DcBlocker,
    Scale,
    Mix,
    Map,
    FftStream,
    Channelize,
    FmMod,
    Iir,
    StereoDecode,
)
from sdr_tpu.stream.pipeline import Pipeline  # noqa: F401
from sdr_tpu.stream.rate import rate, Timer  # noqa: F401
from sdr_tpu.stream.sources import (  # noqa: F401
    stream_string,
    stream_random,
    fork,
    devnull,
    print_sink,
    tone,
    noise,
    fm_mod,
)
