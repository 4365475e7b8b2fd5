"""Device family, matmul precision and kernel-variant selection.

The analog of the reference's CPUID layer (hs_sources/SDR/CPUID.hs):
there, ``featureSelect`` picks the fastest SIMD implementation the host
supports (CPUID.hs:100-104).  Here :func:`device_family` is the one place
that decides which device the program runs on ("gpu" or "cpu"; anything
else is an error), and ``best_method`` picks an FIR execution path for
that family from utils/tuning.py.
"""

from __future__ import annotations

import functools
import os

import jax

__all__ = ["device_kind", "device_family", "best_method", "feature_select",
           "fir_precision", "set_fir_precision"]

FAMILIES = ("gpu", "cpu")


# ---------------------------------------------------------------------------
# Matmul precision policy for the f32 FIR/band/conv paths.
#
# On an NVIDIA GPU, XLA may run an f32 convolution or matmul in TF32 at
# DEFAULT precision: operands keep about ten mantissa bits, so a 64-tap
# FIR over values in (-10, 10) can drift by 1e-2, the size of the
# reference's whole cross-implementation bound (tests/TestSuite.hs:
# 284-289).  XLA on the CPU multiplies in true f32, so the CPU tests
# cannot see that drift.  HIGHEST keeps f32 products and is the default;
# the FIR stages move far more bytes than they do arithmetic, so what the
# accuracy costs on the card is a measurement for the benchmark, not an
# assumption.
# ---------------------------------------------------------------------------

_PRECISION_NAMES = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}


def _precision_from_env() -> jax.lax.Precision:
    name = os.environ.get("SDR_TPU_FIR_PRECISION", "highest").lower()
    if name not in _PRECISION_NAMES:
        raise ValueError(
            f"SDR_TPU_FIR_PRECISION={name!r}: expected one of "
            f"{sorted(_PRECISION_NAMES)}")
    return _PRECISION_NAMES[name]


_fir_precision = _precision_from_env()


def fir_precision():
    """The matmul precision used by the f32 FIR execution paths."""
    return _fir_precision


def set_fir_precision(name_or_prec):
    """Set the FIR matmul precision ('default' | 'high' | 'highest' or a
    ``jax.lax.Precision``).  Returns the previous value.

    The value is read at TRACE time: it affects functions traced after
    the call, while already-jit-compiled programs keep the precision they
    were traced with — their caches are keyed on argument shapes, not on this
    global.  Call it before building/jitting a pipeline, or clear caches
    (``jax.clear_caches()``) to retrace at the new precision."""
    global _fir_precision
    prev = _fir_precision
    if isinstance(name_or_prec, str):
        name = name_or_prec.lower()
        if name not in _PRECISION_NAMES:
            raise ValueError(
                f"set_fir_precision({name_or_prec!r}): expected one of "
                f"{sorted(_PRECISION_NAMES)}")
        _fir_precision = _PRECISION_NAMES[name]
    else:
        _fir_precision = name_or_prec
    return prev


@functools.cache
def device_kind() -> str:
    return jax.devices()[0].device_kind


def device_family() -> str:
    """'gpu' or 'cpu', from ``jax.devices()[0].platform``.  Any other
    platform raises: nothing in this package is tuned for it."""
    platform = jax.devices()[0].platform
    if platform not in FAMILIES:
        raise RuntimeError(
            f"unsupported device platform {platform!r}: sdr_tpu runs on "
            f"{' or '.join(FAMILIES)}")
    return platform


def best_method(n_taps: int, factor: int = 1, num: int = 1 << 20) -> str:
    """Pick an execution path for a strided FIR of this shape on the
    attached device family (utils/tuning.py)."""
    from sdr_tpu.utils import tuning
    return tuning.best_method(device_family(), n_taps, factor, num)


def feature_select(table, default: str = "conv") -> str:
    """featureSelect analog: first available strategy from ``table``
    ([(predicate(), value), ...]) else ``default``."""
    for pred, val in table:
        if pred:
            return val
    return default
