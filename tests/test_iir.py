"""Generic IIR (associative-scan) tests vs scipy."""

import numpy as np
import pytest
import scipy.signal

from sdr_tpu.ops import iir


def test_linear_recurrence_order1_matches_lfilter(rng):
    x = rng.normal(size=1024).astype(np.float32)
    y = np.asarray(iir.linear_recurrence(np.array([0.9]), x))
    want = scipy.signal.lfilter([1.0], [1.0, -0.9], x)
    np.testing.assert_allclose(y, want, atol=1e-3)


def test_linear_recurrence_order2_matches_lfilter(rng):
    x = rng.normal(size=1024).astype(np.float32)
    a1, a2 = 1.2, -0.5  # stable pair
    y = np.asarray(iir.linear_recurrence(np.array([a1, a2]), x))
    want = scipy.signal.lfilter([1.0], [1.0, -a1, -a2], x)
    np.testing.assert_allclose(y, want, atol=1e-2)


def test_linear_recurrence_initial_state(rng):
    x = rng.normal(size=64).astype(np.float32)
    y0 = np.array([2.0, -1.0], dtype=np.float32)
    got = np.asarray(iir.linear_recurrence(np.array([0.5, 0.2]), x, y0))
    # direct loop oracle
    prev = [2.0, -1.0]
    want = []
    for n in range(64):
        v = x[n] + 0.5 * prev[0] + 0.2 * prev[1]
        want.append(v)
        prev = [v, prev[0]]
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_biquad_matches_scipy(rng):
    x = rng.normal(size=2048).astype(np.float32)
    sos = scipy.signal.butter(2, 0.2, output="sos")
    b, a = sos[0, :3], sos[0, 3:]
    got = np.asarray(iir.biquad(b, a, x))
    want = scipy.signal.lfilter(b, a, x)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_sosfilt_matches_scipy(rng):
    x = rng.normal(size=2048).astype(np.float32)
    sos = scipy.signal.butter(6, 0.15, output="sos")
    got = np.asarray(iir.sosfilt(sos, x))
    want = scipy.signal.sosfilt(sos, x)
    np.testing.assert_allclose(got, want, atol=1e-2)


def test_deemphasis_rolls_off(rng):
    fs = 48000
    b, a = iir.deemphasis_taps(fs, 75e-6)
    w, h = scipy.signal.freqz(b[:2], a[:2], fs=fs)
    lo = np.abs(h[(w > 50) & (w < 200)]).mean()
    hi = np.abs(h[(w > 10000) & (w < 15000)]).mean()
    assert lo / hi > 4  # strong HF attenuation
    # and the scan path filters a signal finitely
    y = np.asarray(iir.biquad(b, a, rng.normal(size=1000).astype(np.float32)))
    assert np.isfinite(y).all()


def test_batched(rng):
    x = rng.normal(size=(4, 512)).astype(np.float32)
    y = np.asarray(iir.linear_recurrence(np.array([0.7, -0.2]), x))
    assert y.shape == (4, 512)
    y0 = np.asarray(iir.linear_recurrence(np.array([0.7, -0.2]), x[2]))
    np.testing.assert_allclose(y[2], y0, atol=1e-4)


def test_streaming_iir_blockwise_equals_whole(rng):
    import jax.numpy as jnp
    from sdr_tpu.stream import Iir
    sos = scipy.signal.butter(4, 0.2, output="sos")
    op = Iir(sos)
    x = rng.normal(size=4096).astype(np.float32)
    c0 = op.init_carry(4096, np.float32)
    _, whole = op.apply(c0, jnp.asarray(x))
    c = op.init_carry(512, np.float32)
    parts = []
    for i in range(0, 4096, 512):
        c, y = op.apply(c, jnp.asarray(x[i:i + 512]))
        parts.append(np.asarray(y))
    got = np.concatenate(parts)
    np.testing.assert_allclose(got, np.asarray(whole), atol=1e-3)
    want = scipy.signal.sosfilt(sos, x)
    np.testing.assert_allclose(got, want, atol=1e-2)
