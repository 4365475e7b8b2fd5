"""Hand-written GPU kernels (Pallas, Triton route) where a measurement
on the card pays for them (the reference's c_sources/ layer)."""

from sdr_tpu.kernels.u8_front_demod_triton import u8_front_demod  # noqa: F401
