"""Tests for conversion, scaling, shifting, demod, scans, design, FFT."""

import numpy as np
import pytest
import scipy.signal

import jax.numpy as jnp

from sdr_tpu import ops
from oracles import (fm_demod_oracle, dc_blocker_oracle, agc_oracle)

TOL = 0.01


# --- conversion (reference props: TestSuite.hs:229-259) ---

def test_iq_u8(rng):
    raw = rng.integers(0, 256, 4096).astype(np.uint8)
    got = np.asarray(ops.iq_u8_to_cfloat(raw))
    want_r = (raw[0::2].astype(np.float64) - 128) / 128
    want_i = (raw[1::2].astype(np.float64) - 128) / 128
    np.testing.assert_allclose(got.real, want_r, atol=1e-6)
    np.testing.assert_allclose(got.imag, want_i, atol=1e-6)


def test_iq_i16(rng):
    raw = rng.integers(-2048, 2048, 4096).astype(np.int16)
    got = np.asarray(ops.iq_i16_to_cfloat(raw))
    np.testing.assert_allclose(got.real, raw[0::2] / 2048, atol=1e-6)
    np.testing.assert_allclose(got.imag, raw[1::2] / 2048, atol=1e-6)


def test_iq_planar_variants(rng):
    """Planar converters == complex converters, componentwise (the planar
    [2, n] layout is the planar stream representation)."""
    raw8 = rng.integers(0, 256, 4096).astype(np.uint8)
    c = np.asarray(ops.iq_u8_to_cfloat(raw8))
    p = np.asarray(ops.iq_u8_to_planar(raw8))
    assert p.shape == (2, 2048)
    np.testing.assert_array_equal(p[0], c.real)
    np.testing.assert_array_equal(p[1], c.imag)
    # full-range i16 (sign extension through the bitcast split)
    raw16 = rng.integers(-32768, 32768, 4096).astype(np.int16)
    c16 = np.asarray(ops.iq_i16_to_cfloat(raw16))
    p16 = np.asarray(ops.iq_i16_to_planar(raw16))
    np.testing.assert_array_equal(p16[0], c16.real)
    np.testing.assert_array_equal(p16[1], c16.imag)
    np.testing.assert_allclose(c16.real, raw16[0::2] / 2048, atol=1e-6)
    # batched leading dims
    pb = np.asarray(ops.iq_u8_to_planar(raw8.reshape(4, 1024)))
    assert pb.shape == (4, 2, 512)


def test_iq_transmit_roundtrip(rng):
    x = (rng.uniform(-1, 1, 512) + 1j * rng.uniform(-1, 1, 512)).astype(
        np.complex64)
    iq = np.asarray(ops.cfloat_to_iq_i16(x))
    assert iq.dtype == np.int16
    assert iq.min() >= -2048 and iq.max() <= 2047
    back = np.asarray(ops.iq_i16_to_cfloat(iq))
    assert np.abs(back - x).max() < 1 / 2048 + 1e-6


def test_iq_transmit_clamps():
    x = np.array([10 + 10j, -10 - 10j], dtype=np.complex64)
    iq = np.asarray(ops.cfloat_to_iq_i16(x))
    np.testing.assert_array_equal(iq, [2047, 2047, -2048, -2048])


def test_scale(rng):
    x = rng.uniform(-10, 10, 1000).astype(np.float32)
    np.testing.assert_allclose(np.asarray(ops.scale(0.3, x)), 0.3 * x,
                               atol=1e-6)


# --- frequency shift (Util.hs:263-285) ---

def test_half_band_up():
    v = np.asarray(ops.half_band_up(8))
    np.testing.assert_array_equal(v, [1, -1, 1, -1, 1, -1, 1, -1])


def test_quarter_band_up():
    v = np.asarray(ops.quarter_band_up(8))
    np.testing.assert_array_equal(v, [1, 1j, -1, -1j, 1, 1j, -1, -1j])


def test_oscillator_shifts_spectrum():
    n = 1024
    tone = np.exp(2j * np.pi * 0.1 * np.arange(n)).astype(np.complex64)
    lo = np.asarray(ops.oscillator(n, 0.15))
    shifted = tone * lo
    spec = np.abs(np.fft.fft(shifted))
    assert np.argmax(spec) == round(0.25 * n)


# --- demod (Demod.hs) ---

def test_fm_demod(rng):
    x = (rng.normal(size=256) + 1j * rng.normal(size=256)).astype(np.complex64)
    want, want_last = fm_demod_oracle(x.astype(np.complex128))
    got, last = ops.fm_demod(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), want, atol=TOL)
    assert np.asarray(last) == pytest.approx(want_last, abs=1e-6)


def test_fm_demod_carry_chain(rng):
    """Blockwise demod with carry == whole-signal demod (the pipe contract,
    Demod.hs:39-46)."""
    x = (rng.normal(size=512) + 1j * rng.normal(size=512)).astype(np.complex64)
    whole, _ = ops.fm_demod(jnp.asarray(x))
    parts = []
    last = None
    for i in range(0, 512, 128):
        y, last = ops.fm_demod(jnp.asarray(x[i:i + 128]), last)
        parts.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(parts), np.asarray(whole),
                               atol=1e-6)


def test_fm_demod_recovers_tone():
    """End-to-end sanity: demodulating an FM-modulated tone returns the
    instantaneous frequency."""
    fs, f_dev = 48000.0, 5000.0
    t = np.arange(4096) / fs
    msg = np.sin(2 * np.pi * 440 * t)
    phase = 2 * np.pi * f_dev * np.cumsum(msg) / fs
    iq = np.exp(1j * phase).astype(np.complex64)
    y, _ = ops.fm_demod(jnp.asarray(iq))
    y = np.asarray(y)[1:]  # first sample uses the zero carry
    expect = 2 * np.pi * f_dev * msg[1:] / fs
    assert np.abs(y - expect).max() < 1e-2


def test_fast_atan2_all_quadrants(rng):
    """Polynomial atan2 vs jnp.arctan2: 5.8e-7 rad bound over all four
    quadrants, axes, and magnitude extremes; atan2(0, 0) = 0."""
    b = rng.uniform(-10, 10, 4096).astype(np.float32)
    a = rng.uniform(-10, 10, 4096).astype(np.float32)
    got = np.asarray(ops.fast_atan2(b, a))
    want = np.arctan2(b, a)
    np.testing.assert_allclose(got, want, atol=2e-6)
    edges_b = np.array([0, 0, 1, -1, 0, 1e-30, 1e30], np.float32)
    edges_a = np.array([1, -1, 0, 0, 0, 1e30, 1e-30], np.float32)
    got = np.asarray(ops.fast_atan2(edges_b, edges_a))
    want = np.arctan2(edges_b, edges_a)
    want[4] = 0.0  # atan2(0,0): ours defines 0 (np does too)
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_fm_demod_planar_poly_matches_exact(rng):
    x = rng.normal(size=(2, 1024)).astype(np.float32)
    ye, _ = ops.fm_demod_planar(jnp.asarray(x))
    yp, _ = ops.fm_demod_planar(jnp.asarray(x), atan2="poly")
    np.testing.assert_allclose(np.asarray(yp), np.asarray(ye), atol=2e-6)


def test_am_demod():
    x = np.array([3 + 4j, 1 + 0j], dtype=np.complex64)
    np.testing.assert_allclose(np.asarray(ops.am_demod(x)), [5, 1], atol=1e-6)


# --- scans: dc blocker + agc ---

def test_dc_blocker(rng):
    x = rng.uniform(-1, 1, 1024).astype(np.float32) + 0.5
    want, (ws, wo) = dc_blocker_oracle(x.astype(np.float64))
    got, (gs, go) = ops.dc_blocker(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), want, atol=TOL)
    assert np.asarray(gs) == pytest.approx(ws, abs=1e-5)
    assert np.asarray(go) == pytest.approx(wo, abs=TOL)


def test_dc_blocker_carry_chain(rng):
    x = rng.uniform(-1, 1, 1024).astype(np.float32)
    whole, _ = ops.dc_blocker(jnp.asarray(x))
    parts, ls, lo = [], 0.0, 0.0
    for i in range(0, 1024, 256):
        y, (ls, lo) = ops.dc_blocker(jnp.asarray(x[i:i + 256]), ls, lo)
        parts.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(parts), np.asarray(whole),
                               atol=1e-4)


def test_dc_blocker_removes_dc(rng):
    x = (rng.uniform(-0.1, 0.1, 50000) + 3.0).astype(np.float32)
    y, _ = ops.dc_blocker(jnp.asarray(x))
    assert abs(np.asarray(y)[-10000:].mean()) < 0.05


def test_agc(rng):
    x = 5.0 * (rng.normal(size=512) + 1j * rng.normal(size=512)).astype(
        np.complex64)
    want, wg = agc_oracle(x.astype(np.complex128), 0.01, 1.0)
    got, gg = ops.agc(jnp.asarray(x), 0.01, 1.0)
    np.testing.assert_allclose(np.asarray(got), want, atol=TOL)
    assert np.asarray(gg) == pytest.approx(wg, abs=TOL)


def test_agc_converges(rng):
    x = 10.0 * np.exp(1j * rng.uniform(0, 2 * np.pi, 20000)).astype(
        np.complex64)
    y, _ = ops.agc(jnp.asarray(x), 0.01, 1.0)
    assert np.abs(np.abs(np.asarray(y)[-1000:]) - 1.0).max() < 0.1


# --- design (FilterDesign.hs) ---

def test_windows_match_scipy():
    for size in [32, 65]:
        np.testing.assert_allclose(np.asarray(ops.hanning(size)),
                                   scipy.signal.windows.hann(size, sym=True),
                                   atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(ops.hamming(size)),
            scipy.signal.windows.general_hamming(size, 0.54, sym=True),
            atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(ops.blackman(size)),
            scipy.signal.windows.blackman(size, sym=True), atol=1e-5)


def test_sinc_center_value():
    s = ops.sinc(65, 0.25)
    assert s[32] == pytest.approx(0.25)
    # symmetric
    np.testing.assert_allclose(s, s[::-1], atol=1e-7)


def test_windowed_sinc_is_lowpass():
    taps = ops.windowed_sinc(129, 0.25, ops.blackman)
    f, mag = ops.frequency_response(taps)
    passband = mag[f < 0.15]
    stopband = mag[f > 0.35]
    assert passband.min() > 0.2  # response normalized by cutoff gain
    assert stopband.max() < passband.min() / 10


def test_srrc_symmetric():
    p = ops.srrc(16, 4, 0.35)
    assert len(p) == 33
    np.testing.assert_allclose(p, p[::-1], atol=1e-6)


def test_remez_design():
    taps = ops.remez(51, [0, 0.08, 0.125, 1.0], [1, 0])
    f, mag = ops.frequency_response(taps)
    assert mag[f < 0.06].min() > 0.9
    assert mag[f > 0.15].max() < 0.1


# --- FFT (FFT.hs) ---

def test_fft_matches_numpy(rng):
    x = (rng.normal(size=512) + 1j * rng.normal(size=512)).astype(np.complex64)
    np.testing.assert_allclose(np.asarray(ops.fft(x)), np.fft.fft(x),
                               rtol=1e-4, atol=1e-3)


def test_fft_accepts_sequence_and_bounds_auto(rng):
    """Regression: fft must not crash on plain sequences (np.shape, not
    .shape), and must stay accurate at a large length (2^20)."""
    seq = [1.0, 2.0, 3.0, 4.0]
    np.testing.assert_allclose(np.asarray(ops.fft(seq)), np.fft.fft(seq),
                               rtol=1e-5, atol=1e-5)
    n = 1 << 20
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    ref = np.fft.fft(x)
    got = np.asarray(ops.fft(x))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)


def test_rfft_matches_numpy(rng):
    x = rng.normal(size=512).astype(np.float32)
    np.testing.assert_allclose(np.asarray(ops.rfft(x)), np.fft.rfft(x),
                               rtol=1e-4, atol=1e-3)


def test_frame_shapes(rng):
    x = rng.normal(size=1000).astype(np.float32)
    fr = np.asarray(ops.frame(x, 128, 64))
    assert fr.shape == ((1000 - 128) // 64 + 1, 128)
    np.testing.assert_allclose(fr[3], x[192:320], atol=1e-7)


def test_spectrogram_peaks_at_tone():
    n = 8192
    tone = np.exp(2j * np.pi * 0.125 * np.arange(n)).astype(np.complex64)
    rows = np.asarray(ops.spectrogram(tone, 256, 128))
    # DC-centered: bin = 256/2 + 0.125*256 = 160
    assert (rows.argmax(axis=-1) == 160).all()


def test_fm_mod_demod_roundtrip(rng):
    x = rng.uniform(-1, 1, 2048).astype(np.float32)
    sens = 0.3
    y, final = ops.fm_mod(x, sens)
    back, _ = ops.fm_demod(y)
    np.testing.assert_allclose(np.asarray(back)[1:], sens * x[1:], atol=2e-3)


def test_fm_mod_streaming_phase_carry(rng):
    import jax.numpy as jnp
    from sdr_tpu.stream import FmMod
    x = rng.uniform(-1, 1, 2048).astype(np.float32)
    op = FmMod(0.25)
    c0 = op.init_carry(2048, np.float32)
    _, whole = op.apply(c0, jnp.asarray(x))
    c = op.init_carry(256, np.float32)
    parts = []
    for i in range(0, 2048, 256):
        c, y = op.apply(c, jnp.asarray(x[i:i + 256]))
        parts.append(np.asarray(y))
    got = np.concatenate(parts)
    np.testing.assert_allclose(got, np.asarray(whole), atol=1e-3)


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("n", [64, 256, 1024, 4000, 4096])
def test_fft_stream_matches_numpy(rng, n, planar):
    """FftStream (the waterfall stage) against numpy.fft at power-of-two
    and other lengths, planar and complex input: frames every hop samples
    behind size - hop zeros, windowed, shifted, magnitude."""
    from sdr_tpu.stream import FftStream
    hop = n // 2
    x = (rng.normal(size=4 * n) + 1j * rng.normal(size=4 * n)
         ).astype(np.complex64)
    win = ops.blackman(n)
    op = FftStream(n, hop, window=win, planar=planar)
    xin = np.stack([x.real, x.imag]) if planar else x
    carry = op.init_carry(4 * n, jnp.float32 if planar else jnp.complex64,
                          (2,) if planar else ())
    _, got = op.apply(carry, jnp.asarray(xin))
    X = np.concatenate([np.zeros(n - hop, np.complex128), x])
    idx = np.arange(4 * n // hop)[:, None] * hop + np.arange(n)[None, :]
    want = np.abs(np.fft.fftshift(np.fft.fft(X[idx] * win), axes=-1))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * want.max())
