"""The fused front kernel (kernels/u8_front_demod_triton.py) in the
Pallas interpreter against the plain XLA stages it replaces:
IqConvertU8(planar) -> fir_decimate -> fm_demod_planar(poly).

The kernel sums f32 products in another order than XLA, so outputs
agree to f32 rounding of the decimated samples; the demod angle of a
near-zero sample amplifies that rounding, hence 1e-5 rad on random
bytes (on a real FM signal the difference is far smaller).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from sdr_tpu.kernels import u8_front_demod
from sdr_tpu.kernels import u8_front_demod_triton as triton_front
from sdr_tpu.ops import convert, demod, fir

TOL = 1e-5
SMALL = dict(PHASES=2, ROWS=32)        # 64-output tiles keep tests quick


@pytest.fixture
def small_tiles(monkeypatch):
    for name, value in SMALL.items():
        monkeypatch.setattr(triton_front, name, value)


def _plain(taps, factor, raw, last_iq, num, byte_off=0):
    x = convert.iq_u8_to_planar(jnp.asarray(raw)[..., byte_off:])
    iq = fir.fir_decimate(taps, factor, x, num, method="direct")
    return np.asarray(demod.fm_demod_planar(iq, jnp.asarray(last_iq),
                                            atan2="poly")[0])


def _case(rng, K, f, nbytes, lead=()):
    taps = rng.uniform(-1, 1, K).astype(np.float32)
    raw = rng.integers(0, 256, lead + (nbytes,)).astype(np.uint8)
    liq = rng.uniform(-1, 1, lead + (2,)).astype(np.float32)
    return taps, raw, liq


@pytest.mark.parametrize("K,f", [(51, 8), (33, 4), (17, 2), (72, 8)])
@pytest.mark.parametrize("num_kind", ["below_tile", "tile_multiple",
                                      "off_tile"])
def test_kernel_matches_plain_front(rng, small_tiles, K, f, num_kind):
    tile = SMALL["PHASES"] * SMALL["ROWS"]
    num = {"below_tile": tile - 23, "tile_multiple": 3 * tile,
           "off_tile": 3 * tile + 5}[num_kind]
    taps, raw, liq = _case(rng, K, f, 2 * (num * f + K))
    got = np.asarray(u8_front_demod(taps, f, jnp.asarray(raw), liq, num,
                                    interpret=True))
    assert got.shape == (num,)
    np.testing.assert_allclose(got, _plain(taps, f, raw, liq, num),
                               atol=TOL)


@pytest.mark.parametrize("byte_off", [2, 10, 86])
def test_kernel_seam_offsets(rng, small_tiles, byte_off):
    """A streaming seam starts the windows ``byte_off`` bytes into the
    block (leading zero taps in the kernel)."""
    taps, raw, liq = _case(rng, 51, 8, 6000)
    num = (3000 - byte_off // 2 - 51) // 8 + 1
    got = np.asarray(u8_front_demod(taps, 8, jnp.asarray(raw), liq, num,
                                    byte_off=byte_off, interpret=True))
    np.testing.assert_allclose(
        got, _plain(taps, 8, raw, liq, num, byte_off), atol=TOL)


@pytest.mark.parametrize("lead", [(3,), (2, 2)])
def test_kernel_batched_leading_dims(rng, small_tiles, lead):
    taps, raw, liq = _case(rng, 51, 8, 4096, lead)
    got = np.asarray(u8_front_demod(taps, 8, jnp.asarray(raw), liq,
                                    interpret=True))
    num = (2048 - 51) // 8 + 1
    assert got.shape == lead + (num,)
    np.testing.assert_allclose(got, _plain(taps, 8, raw, liq, num),
                               atol=TOL)


def test_kernel_default_tile_and_ragged_bytes(rng):
    """The compiled tile geometry, on a byte count that is not a whole
    number of rows (the wrapper pads the row view)."""
    taps, raw, liq = _case(rng, 51, 8, 16390)
    num = (8195 - 51) // 8 + 1
    got = np.asarray(u8_front_demod(taps, 8, jnp.asarray(raw), liq,
                                    interpret=True))
    np.testing.assert_allclose(got, _plain(taps, 8, raw, liq, num),
                               atol=TOL)


def test_kernel_first_output_uses_last_iq(rng, small_tiles):
    """Only output 0 reads the carried sample; zeros give angle 0 there
    (the reference's initial phase)."""
    taps, raw, _ = _case(rng, 51, 8, 4096)
    y0 = np.asarray(u8_front_demod(taps, 8, jnp.asarray(raw),
                                   np.zeros(2, np.float32),
                                   interpret=True))
    y1 = np.asarray(u8_front_demod(taps, 8, jnp.asarray(raw),
                                   np.array([0.5, -0.5], np.float32),
                                   interpret=True))
    assert y0[0] == 0.0 and y1[0] != 0.0
    np.testing.assert_array_equal(y0[1:], y1[1:])


def test_kernel_rejects_odd_factor_and_bad_tiles(rng, monkeypatch):
    taps, raw, liq = _case(rng, 17, 5, 4096)
    with pytest.raises(ValueError, match="even"):
        u8_front_demod(taps, 5, jnp.asarray(raw), liq, interpret=True)
    monkeypatch.setattr(triton_front, "PHASES", 3)
    with pytest.raises(ValueError, match="powers of two"):
        u8_front_demod(taps, 8, jnp.asarray(raw), liq, interpret=True)


@pytest.mark.gpu
def test_kernel_compiled_matches_plain_on_gpu(gpu):
    """The compiled kernel at the FM front's width (one 1.3 MB block and
    a batch of 8) on a constant-envelope FM signal against the plain XLA
    stages on the card, the FIR at HIGHEST precision: f32 summation order
    only, so 1e-4 rad."""
    import jax
    from sdr_tpu.apps.chains import fm_taps
    rf = fm_taps()[0]
    n = 655_360
    for lead in ((), (8,)):
        k = np.arange(int(np.prod(lead, dtype=int)) * n).reshape(lead + (n,))
        phase = 100.0 * (1.0 - np.cos(2 * np.pi * 700.0 * k / 1.28e6))
        raw = np.empty(lead + (2 * n,), np.uint8)
        raw[..., 0::2] = np.round(0.9 * np.cos(phase) * 127 + 128)
        raw[..., 1::2] = np.round(0.9 * np.sin(phase) * 127 + 128)
        liq = np.zeros(lead + (2,), np.float32)
        num = (n - 51) // 8 + 1
        got = np.asarray(u8_front_demod(rf, 8, jnp.asarray(raw), liq, num))
        with jax.default_matmul_precision("highest"):
            want = _plain(rf, 8, raw, liq, num)
        np.testing.assert_allclose(got, want, atol=1e-4)
