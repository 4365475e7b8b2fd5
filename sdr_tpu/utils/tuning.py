"""FIR execution-path dispatch per device family.

The reference's dispatch layer (SDR/CPUID.hs:100-104 ``featureSelect``)
selects among SIMD variants by a *capability* predicate; here every
strategy is always available and the right choice depends on the device
family and the problem shape.

- 'gpu': one fixed path, ``conv`` (cuDNN convolution).  It won every tap
  family the chains use on an H100, by 1.6x or more over the next path
  (rates in PERF.md, Findings, PR 1).
- 'cpu': ``best_method`` log-interpolates each method's recorded rate at
  the requested tap count and returns the argmax.  A deployment can
  override the CPU table at runtime via ``SDR_TPU_TUNING_JSON=<path>``
  (same schema: ``{"cpu": {fam: {method: {taps: rate}}}}``).

Any other family is an error.
"""

from __future__ import annotations

import json
import math
import os

__all__ = ["best_method", "best_resample_method", "measured_rates"]

# the one path per family that has no measured table
FIXED = {"gpu": "conv"}

# input samples/sec by {family: {fam: {method: {key: rate}}}}.
# fam 'filter' = unit stride, keyed by tap count; 'decimate' = strided,
# keyed by TAPS PER PHASE ceil(K/f); 'resample' = rational (I > 1),
# keyed by ceil(K/I).
#
# cpu: rough orders from a test machine — the CPU is a correctness
# backend, not a target.
MEASURED = {
    "cpu": {
        "filter": {
            "conv":   {32: 2.0e8, 512: 1.0e8},
            "direct": {32: 1.0e8, 512: 2.0e7},
        },
        "decimate": {
            "conv":   {32: 2.0e8, 512: 1.0e8},
            "direct": {32: 1.0e8, 512: 2.0e7},
        },
    },
}


def measured_rates(device_family: str):
    """The active rate table for ``device_family`` ('cpu'): the
    ``SDR_TPU_TUNING_JSON`` override if set, else ``MEASURED``.  Raises
    ``ValueError`` for a family with no table."""
    path = os.environ.get("SDR_TPU_TUNING_JSON")
    if path:
        try:
            with open(path) as fh:
                loaded = json.load(fh)
            if device_family in loaded:
                return {fam: {m: {int(k): float(v) for k, v in d.items()}
                              for m, d in fams.items()}
                        for fam, fams in loaded[device_family].items()}
        except (OSError, ValueError):
            pass
    if device_family not in MEASURED:
        raise ValueError(f"no measured dispatch table for device family "
                         f"{device_family!r}; known: {sorted(MEASURED)}")
    return MEASURED[device_family]


def _rate_at(table: dict, n_taps: int) -> float:
    """Log-log interpolate/extrapolate (clamped) a {taps: rate} table."""
    pts = sorted(table.items())
    if not pts:
        return 0.0
    if n_taps <= pts[0][0]:
        return pts[0][1]
    if n_taps >= pts[-1][0]:
        return pts[-1][1]
    for (k0, r0), (k1, r1) in zip(pts, pts[1:]):
        if k0 <= n_taps <= k1:
            t = (math.log(n_taps) - math.log(k0)) / (
                math.log(k1) - math.log(k0))
            return math.exp(math.log(r0) * (1 - t) + math.log(r1) * t)
    return pts[-1][1]


def best_method(device_family: str, n_taps: int, factor: int = 1,
                num: int = 1 << 20) -> str:
    """Execution path for a strided FIR.

    The family's fixed path where it has one; small problems on the CPU
    skip to 'direct' (dispatch overhead dominates and the im2col stays
    tiny); otherwise the argmax over the measured table for the family.
    Unit stride interpolates by tap count; strided interpolates by taps
    per polyphase component ceil(K/f) — the shape variable the measured
    winner actually follows.
    """
    if device_family in FIXED:
        return FIXED[device_family]
    table = measured_rates(device_family)
    if num < 4096:
        return "direct"
    if factor == 1:
        fam, key = "filter", n_taps
    else:
        fam, key = "decimate", -(-n_taps // factor)
    return _argmax(table.get(fam, {}), key)


def _argmax(table: dict, key: int) -> str:
    best, best_rate = "conv", 0.0
    for method, rates in table.items():
        r = _rate_at(rates, key)
        if r > best_rate:
            best, best_rate = method, r
    return best


def best_resample_method(device_family: str, n_taps: int,
                         interpolation: int, decimation: int,
                         num: int = 1 << 20) -> str:
    """Execution path for a rational (I > 1) resampler: the family's
    fixed path where it has one, else the argmax over the measured
    'resample' family, keyed by taps per phase ceil(K/I).  Small problems
    on the CPU take the gather path (dispatch overhead dominates)."""
    if device_family in FIXED:
        return FIXED[device_family]
    table = measured_rates(device_family)
    if num < 4096:
        return "direct"
    return _argmax(table.get("resample", {}), -(-n_taps // interpolation))
