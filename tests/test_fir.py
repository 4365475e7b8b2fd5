"""Differential tests for the FIR engine.

Strategy mirrors the reference suite (tests/TestSuite.hs): run every
implementation variant on the same randomized inputs and assert pairwise
closeness within 0.01 absolute (real) / 0.01 magnitude (complex) — the
reference's published tolerance (TestSuite.hs:284-289).  The "variant list"
here is {numpy oracle, direct gather, XLA conv, XLA band, scipy}.
"""

import numpy as np
import pytest
import scipy.signal

from sdr_tpu.ops import fir
from oracles import filter_oracle, decimate_oracle, resample_oracle

TOL = 0.01
METHODS = ["direct", "conv"]


def rand_real(rng, n):
    return rng.uniform(-10, 10, n).astype(np.float32)


def rand_complex(rng, n):
    return (rng.uniform(-10, 10, n) + 1j * rng.uniform(-10, 10, n)).astype(
        np.complex64)


@pytest.mark.parametrize("size", [1024, 4096])
@pytest.mark.parametrize("ntaps", [32, 128, 257])
@pytest.mark.parametrize("method", METHODS)
def test_filter_real(rng, size, ntaps, method):
    x = rand_real(rng, size)
    taps = rand_real(rng, ntaps)
    num = size - ntaps + 1
    want = filter_oracle(taps, x, num)
    got = np.asarray(fir.fir_filter(taps, x, num, method=method))
    assert got.shape == (num,)
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("size", [1024])
@pytest.mark.parametrize("ntaps", [64, 129])
@pytest.mark.parametrize("method", METHODS)
def test_filter_complex(rng, size, ntaps, method):
    x = rand_complex(rng, size)
    taps = rand_real(rng, ntaps)
    num = size - ntaps + 1
    want = filter_oracle(taps, x.astype(np.complex128), num)
    got = np.asarray(fir.fir_filter(taps, x, num, method=method))
    assert np.abs(got - want).max() < TOL


def test_filter_symmetric_streaming_path(rng):
    """``symmetric=True`` is a constructor convenience (FirSpec mirrors the
    half-taps; there is NO separate symmetric kernel — docs/DESIGN.md
    records why a matmul formulation has no FLOP asymmetry to exploit, unlike
    common.h:160-260).  Cross-check it through the STREAMING path against
    the oracle run with the full mirrored taps — the reference's trick of
    feeding symmetric impls half-taps and generic impls the mirror
    (TestSuite.hs:69-83), across the actual overlap-save code."""
    from sdr_tpu.stream import Fir
    import jax.numpy as jnp
    half = rand_real(rng, 32)
    full = np.concatenate([half, half[::-1]])
    x = rand_real(rng, 4096)
    op = Fir.filter(half, symmetric=True)
    c = op.init_carry(512, jnp.float32)
    parts = []
    for i in range(0, 4096, 512):
        c, y = op.apply(c, jnp.asarray(x[i:i + 512]))
        parts.append(np.asarray(y))
    got = np.concatenate(parts)
    # streaming warmup = 63 leading zeros of history
    want = filter_oracle(full, np.concatenate([np.zeros(63, np.float32), x]),
                         4096)
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("factor", [1, 2, 3, 5, 7, 13, 23])
@pytest.mark.parametrize("method", METHODS)
def test_decimate_real(rng, factor, method):
    size, ntaps = 4096, 128
    x = rand_real(rng, size)
    taps = rand_real(rng, ntaps)
    num = (size - ntaps) // factor + 1
    want = decimate_oracle(taps, factor, x, num)
    got = np.asarray(fir.fir_decimate(taps, factor, x, num, method=method))
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("factor", [2, 8])
@pytest.mark.parametrize("method", METHODS)
def test_decimate_complex(rng, factor, method):
    size, ntaps = 2048, 64
    x = rand_complex(rng, size)
    taps = rand_real(rng, ntaps)
    num = (size - ntaps) // factor + 1
    want = decimate_oracle(taps, factor, x.astype(np.complex128), num)
    got = np.asarray(fir.fir_decimate(taps, factor, x, num, method=method))
    assert np.abs(got - want).max() < TOL


# Resampler factor pairs from the reference's distribution: interpolation
# and decimation drawn from primes with interpolation < decimation, plus
# upsampling pairs (the reference also documents the upsampling case,
# Filter.hs:640-672).
RATIOS = [(1, 2), (2, 3), (3, 7), (5, 13), (7, 23), (3, 10),
          (7, 3), (13, 5), (11, 2)]


@pytest.mark.parametrize("interp,decim", RATIOS)
def test_resample_real(rng, interp, decim):
    size, ntaps = 4096, 128
    x = rand_real(rng, size)
    taps = rand_real(rng, ntaps)
    offset = int(rng.integers(0, interp))
    num = fir.resample_output_count(size, ntaps, interp, decim, offset)
    num = min(num, (size - ntaps) // max(1, decim // interp + 1))  # stay in bounds
    want, want_off = resample_oracle(taps, interp, decim, x, offset, num)
    got, got_off = fir.fir_resample(taps, interp, decim, x, offset, num)
    got = np.asarray(got)
    assert got_off == want_off
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("interp,decim", [(3, 10), (2, 3), (7, 4)])
def test_resample_complex(rng, interp, decim):
    size, ntaps = 2048, 64
    x = rand_complex(rng, size)
    taps = rand_real(rng, ntaps)
    num = fir.resample_output_count(size, ntaps, interp, decim, 0) - 4
    want, _ = resample_oracle(taps, interp, decim, x.astype(np.complex128),
                              0, num)
    got, _ = fir.fir_resample(taps, interp, decim, x, 0, num)
    assert np.abs(np.asarray(got) - want).max() < TOL


@pytest.mark.parametrize("interp,decim", [(3, 10), (2, 3), (7, 23),
                                          (13, 5), (16, 3)])
def test_resample_band_matches_oracle(rng, interp, decim):
    """method='band_xla' (the banded-matmul formulation, ops/fir.py
    _resample_band) is differentially identical to the oracle, including
    the phase carry, random start offsets, and the ragged gather tail."""
    size, ntaps = 4096, 31
    x = rand_real(rng, size)
    taps = rand_real(rng, ntaps)
    offset = int(rng.integers(0, interp))
    start = int(rng.integers(0, 64))
    num = fir.resample_output_count(size - start, ntaps, interp, decim,
                                    offset)
    want, want_off = fir.fir_resample(taps, interp, decim, x, offset, num,
                                      method="direct", start=start)
    got, got_off = fir.fir_resample(taps, interp, decim, x, offset, num,
                                    method="band_xla", start=start)
    assert got_off == want_off
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("interp,decim,ntaps", [(3, 10, 31), (3, 10, 128),
                                                (2, 3, 64), (5, 7, 33),
                                                (7, 4, 21)])
def test_resample_band_xla_geometries(rng, interp, decim, ntaps):
    """The XLA band against the oracle across offsets and sub-row
    origins — long enough input that several main rows plus the ragged
    tail run (tap counts past one row widen the band)."""
    size = 16384
    x = rand_real(rng, size)
    taps = rand_real(rng, ntaps)
    offset = int(rng.integers(0, interp))
    start = int(rng.integers(0, 32))
    num = fir.resample_output_count(size - start, ntaps, interp, decim,
                                    offset)
    got, got_off = fir.fir_resample(taps, interp, decim, x, offset, num,
                                    method="band_xla", start=start)
    oracle, want_off = resample_oracle(taps, interp, decim, x[start:],
                                       offset, num)
    assert got_off == want_off
    np.testing.assert_allclose(np.asarray(got), oracle, atol=TOL)


def test_resample_band_complex(rng):
    """Complex input takes the planar real-batch view on the band path."""
    interp, decim, size, ntaps = 3, 10, 2048, 64
    x = rand_complex(rng, size)
    taps = rand_real(rng, ntaps)
    num = fir.resample_output_count(size, ntaps, interp, decim, 0) - 4
    want, _ = resample_oracle(taps, interp, decim, x.astype(np.complex128),
                              0, num)
    got, _ = fir.fir_resample(taps, interp, decim, x, 0, num,
                              method="band_xla")
    assert np.abs(np.asarray(got) - want).max() < TOL


def test_resample_band_streaming(rng):
    """The streaming Fir resampler with method='band_xla' streams chunked ==
    whole (the seam-split start offsets exercise the band's origin
    folding) and agrees with the conv path on the same stream."""
    import jax.numpy as jnp
    from sdr_tpu.stream import Fir
    taps = rand_real(rng, 31)
    x = rand_real(rng, 12600)
    op = Fir.resampler(taps, 3, 10, method="band_xla")
    whole_c = op.apply(op.init_carry(12600, jnp.float32), jnp.asarray(x))[1]
    parts, c = [], op.init_carry(840, jnp.float32)
    for i in range(0, 12600, 840):
        c, y = op.apply(c, jnp.asarray(x[i:i + 840]))
        parts.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(parts),
                               np.asarray(whole_c), atol=TOL)
    op2 = Fir.resampler(taps, 3, 10, method="conv")
    whole2 = op2.apply(op2.init_carry(12600, jnp.float32), jnp.asarray(x))[1]
    np.testing.assert_allclose(np.asarray(whole_c), np.asarray(whole2),
                               atol=TOL)


def test_resample_complex128_input(rng):
    """Non-complex64 input must NOT hit the interleaved-float32 view.

    Regression (ADVICE r2, high): numpy complex128 reinterpreted as 4
    floats/element returned garbage on the conv path; it now takes the
    planar real-batch path and must match the oracle like complex64 does.
    """
    interp, decim, size, ntaps = 3, 10, 2048, 64
    x128 = (rand_complex(rng, size)).astype(np.complex128)
    taps = rand_real(rng, ntaps)
    num = fir.resample_output_count(size, ntaps, interp, decim, 0) - 4
    want, _ = resample_oracle(taps, interp, decim, x128, 0, num)
    got, _ = fir.fir_resample(taps, interp, decim, x128, 0, num,
                              method="conv")
    assert np.abs(np.asarray(got) - want).max() < TOL


def test_resample_against_scipy_upfirdn(rng):
    """Cross-check the whole polyphase formulation against scipy.

    upfirdn(h, x, I, D) computes the downsampled filtered upsampled signal;
    our resampler with offset 0 matches its first outputs exactly (same
    correlation orientation after upsampling alignment: upfirdn output m is
    sum_k h[mD - kI... ] — empirically aligned below; tolerance same 0.01).
    """
    I, D, K, N = 3, 10, 31, 4096
    x = rand_real(rng, N)
    taps = rand_real(rng, K)
    num = fir.resample_output_count(N, K, I, D, 0)
    got, _ = fir.fir_resample(taps, I, D, x, 0, num)
    got = np.asarray(got)
    # scipy applies h as convolution against the upsampled signal; our
    # orientation is correlation starting at x[0]: y[m] = sum_k h[o+kI] x[i+k].
    # Equivalent scipy call: upfirdn with time-reversed taps, trimmed to the
    # overlap-complete region.
    up = scipy.signal.upfirdn(taps[::-1], x, up=I, down=D)
    # upfirdn y[m] = sum_j hrev[j] xup[m*D - j + ...]; full-mode: first K-1
    # upsampled lags are partial.  The first complete output index:
    lead = (K - 1 + D - 1) // D
    ref = up[lead:lead + num]
    n = min(len(ref), num)
    np.testing.assert_allclose(got[:n], ref[:n], atol=TOL)


def test_phase_table():
    taps = np.arange(10, dtype=np.float32)
    t = fir.prepare_phase_table(taps, 3)
    assert t.shape == (3, 4)
    np.testing.assert_array_equal(t[0], [0, 3, 6, 9])
    np.testing.assert_array_equal(t[1], [1, 4, 7, 0])
    np.testing.assert_array_equal(t[2], [2, 5, 8, 0])


def test_batched_leading_dims(rng):
    """All paths must broadcast over leading (channel) dims — the channelizer
    contract."""
    x = rng.uniform(-1, 1, (4, 3, 1024)).astype(np.float32)
    taps = rand_real(rng, 32)
    num = 1024 - 32 + 1
    for method in METHODS:
        y = np.asarray(fir.fir_filter(taps, x, num, method=method))
        assert y.shape == (4, 3, num)
        np.testing.assert_allclose(
            y[2, 1], filter_oracle(taps, x[2, 1], num), atol=TOL)


def test_start_origin_equals_slice(rng):
    """``start`` (the zero-copy input origin) must equal slicing for every
    kernel family and method."""
    x = rng.uniform(-1, 1, 4096).astype(np.float32)
    taps = rand_real(rng, 51)
    s = 37
    for method in METHODS:
        a = np.asarray(fir.fir_filter(taps, x, 256, method=method, start=s))
        b = np.asarray(fir.fir_filter(taps, x[s:], 256, method=method))
        np.testing.assert_allclose(a, b, atol=TOL)
        a = np.asarray(fir.fir_decimate(taps, 8, x, 64, method=method,
                                        start=s))
        b = np.asarray(fir.fir_decimate(taps, 8, x[s:], 64, method=method))
        np.testing.assert_allclose(a, b, atol=TOL)
    for method in ("direct", "conv"):
        a, ea = fir.fir_resample(taps, 3, 10, x, 2, 128, method=method,
                                 start=s)
        b, eb = fir.fir_resample(taps, 3, 10, x[s:], 2, 128, method=method)
        assert ea == eb
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL)


@pytest.mark.parametrize("interp,decim,ntaps", [(1, 1, 64), (1, 8, 51),
                                                (3, 10, 31), (7, 4, 93)])
def test_fir_seam_split_matches_concat(rng, interp, decim, ntaps):
    """Fir.apply's zero-copy seam split must produce the same samples as
    the naive concat(hist, block) form, for every op family and a
    nonzero resampler start phase."""
    from sdr_tpu.stream import Fir
    import jax.numpy as jnp
    taps = rand_real(rng, ntaps)
    n_in = 80 * decim  # satisfies n_in*I % D == 0 for all cases, > taps
    if interp == 1:
        op = (Fir.filter(taps) if decim == 1
              else Fir.decimator(taps, decim))
    else:
        op = Fir.resampler(taps, interp, decim, offset=2 % interp)
    x0 = jnp.asarray(rng.uniform(-1, 1, n_in).astype(np.float32))
    x1 = jnp.asarray(rng.uniform(-1, 1, n_in).astype(np.float32))
    c = op.init_carry(n_in, jnp.float32)
    H = c.shape[-1]
    c, y0 = op.apply(c, x0)
    assert op._seam_plan(H, n_in, op.out_len(n_in)) is not None or H == 0
    c2, y1 = op.apply(c, x1)
    # oracle: the plain concat form
    xext = jnp.concatenate([jnp.concatenate([op.init_carry(n_in, jnp.float32),
                                             x0], -1)[..., -H:] if H else
                            jnp.zeros((0,), jnp.float32), x1], -1)
    y_ref = op._run(xext, op.out_len(n_in), op.offset)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y_ref), atol=TOL)
    if H:
        np.testing.assert_array_equal(np.asarray(c2),
                                      np.asarray(x1[..., n_in - H:]))
