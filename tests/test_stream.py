"""Streaming-runtime tests.

The load-bearing property (what the reference's cross-buffer functions
exist to provide, Filter.hs:600-611): processing a stream block-by-block
with carried state gives EXACTLY the same samples as processing the whole
stream as one giant block.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from sdr_tpu import ops
from sdr_tpu.ops import fir
from sdr_tpu import stream
from sdr_tpu.stream import (Fir, FmDemod, Agc, DcBlocker, Scale, Mix,
                            IqConvertU8, FftStream, Map, Pipeline)


def chunk_vs_whole(op, x, block, rtol=1e-5, atol=1e-5):
    """Run ``op`` over blocks with carry vs. as one big block."""
    n = (x.shape[-1] // block) * block
    x = x[..., :n]
    # one shot
    c0 = op.init_carry(n, x.dtype)
    _, whole = op.apply(c0, jnp.asarray(x))
    # blockwise
    c = op.init_carry(block, x.dtype)
    parts = []
    for i in range(0, n, block):
        c, y = op.apply(c, jnp.asarray(x[..., i:i + block]))
        parts.append(np.asarray(y))
    got = np.concatenate(parts, axis=-1)
    np.testing.assert_allclose(got, np.asarray(whole), rtol=rtol, atol=atol)
    return got


def test_fir_filter_stream(rng):
    x = rng.uniform(-1, 1, 8192).astype(np.float32)
    taps = rng.uniform(-1, 1, 64).astype(np.float32)
    chunk_vs_whole(Fir.filter(taps), x, 1024, atol=1e-4)


def test_fir_filter_stream_matches_padded_offline(rng):
    """Stream output == offline valid-mode filter of the zero-left-padded
    signal (the documented overlap-save warmup contract)."""
    x = rng.uniform(-1, 1, 4096).astype(np.float32)
    taps = rng.uniform(-1, 1, 33).astype(np.float32)
    op = Fir.filter(taps)
    got = chunk_vs_whole(op, x, 512, atol=1e-4)
    padded = np.concatenate([np.zeros(32, np.float32), x])
    want = np.asarray(fir.fir_filter(taps, padded, 4096))
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_fir_decimator_stream(rng, factor):
    x = (rng.uniform(-1, 1, 8192) + 1j * rng.uniform(-1, 1, 8192)).astype(
        np.complex64)
    taps = rng.uniform(-1, 1, 51).astype(np.float32)
    chunk_vs_whole(Fir.decimator(taps, factor), x, 1024, atol=1e-4)


@pytest.mark.parametrize("interp,decim", [(3, 10), (2, 3), (7, 4), (1, 5)])
def test_fir_resampler_stream(rng, interp, decim):
    x = rng.uniform(-1, 1, 16800).astype(np.float32)
    taps = rng.uniform(-1, 1, 31).astype(np.float32)
    block = 840  # divisible by 10, 3, 4, 5 after *interp
    chunk_vs_whole(Fir.resampler(taps, interp, decim), x, block, atol=1e-4)


def test_fir_resampler_stream_vs_oracle_stream(rng):
    """Blockwise resampler == the reference's sequential recurrence run over
    the same zero-padded stream (direct parity with resampleHighLevel
    semantics)."""
    from oracles import resample_oracle
    I, D, K = 3, 10, 31
    x = rng.uniform(-1, 1, 8400).astype(np.float32)
    op = Fir.resampler(rng.uniform(-1, 1, K).astype(np.float32), I, D)
    taps = op.spec.taps
    block = 840
    H = op.hist_len(block)
    got = chunk_vs_whole(op, x, block, atol=1e-4)
    padded = np.concatenate([np.zeros(H, np.float32), x])
    want, _ = resample_oracle(taps, I, D, padded.astype(np.float64), 0,
                              len(got))
    np.testing.assert_allclose(got, want, atol=0.01)


def test_fm_demod_stream(rng):
    x = (rng.normal(size=4096) + 1j * rng.normal(size=4096)).astype(
        np.complex64)
    chunk_vs_whole(FmDemod(), x, 512)


def test_agc_stream(rng):
    x = 3.0 * (rng.normal(size=2048) + 1j * rng.normal(size=2048)).astype(
        np.complex64)
    chunk_vs_whole(Agc(0.01, 1.0), x, 256, atol=1e-4)


def test_dc_blocker_stream(rng):
    x = (rng.uniform(-1, 1, 4096) + 1.0).astype(np.float32)
    chunk_vs_whole(DcBlocker(), x, 512, atol=1e-3)


def test_mix_stream_phase_continuity(rng):
    x = np.ones(4096, dtype=np.complex64)
    op = Mix(0.05)
    got = chunk_vs_whole(op, x, 256, atol=1e-3)
    want = np.exp(2j * np.pi * 0.05 * np.arange(4096))
    np.testing.assert_allclose(got, want, atol=1e-2)


def test_fft_stream(rng):
    x = (rng.normal(size=4096) + 1j * rng.normal(size=4096)).astype(
        np.complex64)
    op = FftStream(256, 128)
    n = 4096
    c0 = op.init_carry(n, x.dtype)
    _, whole = op.apply(c0, jnp.asarray(x))
    c = op.init_carry(512, x.dtype)
    parts = []
    for i in range(0, n, 512):
        c, y = op.apply(c, jnp.asarray(x[i:i + 512]))
        parts.append(np.asarray(y))
    got = np.concatenate(parts, axis=0)
    np.testing.assert_allclose(got, np.asarray(whole), rtol=1e-4, atol=1e-3)


# --- pipeline-level ---


def fm_pipeline(block):
    """The canonical FM chain (examples/fm/fm.hs:32-41) on synthetic taps."""
    rf_taps = ops.windowed_sinc(51, 0.1, ops.hamming)
    audio_rs = ops.windowed_sinc(31, 0.25, ops.hamming)
    audio_fl = ops.windowed_sinc(64, 0.5, ops.hamming)
    return Pipeline(
        [IqConvertU8(),
         Fir.decimator(rf_taps, 8),
         FmDemod(),
         Fir.resampler(audio_rs, 3, 10),
         Fir.filter(audio_fl),
         Scale(0.2)],
        block_in=block, in_dtype=jnp.uint8)


def test_pipeline_rate_validation():
    # 16384 u8 -> 8192 cplx -> 1024 after decimate; 1024*3 % 10 != 0
    with pytest.raises(ValueError):
        fm_pipeline(16384)


def test_pipeline_fm_chain_blockwise_equals_whole(rng):
    p = fm_pipeline(81920)
    # 81920 u8 -> 40960 cplx -> 5120 -> 5120 -> 1536 -> 1536 -> 1536
    assert p.block_out == 1536
    raw = rng.integers(0, 256, 81920 * 4).astype(np.uint8)
    _, whole = Pipeline(p.ops, block_in=81920 * 4).process(raw)
    _, blocks = p.process(raw)
    np.testing.assert_allclose(np.asarray(blocks), np.asarray(whole),
                               rtol=1e-4, atol=1e-4)


def test_pipeline_run_matches_process(rng):
    p = fm_pipeline(81920)
    raw = rng.integers(0, 256, 81920 * 3).astype(np.uint8)
    _, want = p.process(raw)
    got = np.concatenate(
        [np.asarray(y) for y in
         p.run(raw.reshape(3, 81920))], axis=-1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_pipeline_checkpoint_resume(rng, tmp_path):
    p = fm_pipeline(81920)
    raw = rng.integers(0, 256, 81920 * 4).astype(np.uint8)
    c, first = p.process(raw[: 81920 * 2])
    path = str(tmp_path / "carries.npz")
    p.checkpoint(c, path)
    c2 = p.restore(path)
    _, rest = p.process(raw[81920 * 2:], c2)
    _, whole = p.process(raw)
    got = np.concatenate([np.asarray(first), np.asarray(rest)], axis=-1)
    np.testing.assert_allclose(got, np.asarray(whole), rtol=1e-4, atol=1e-4)


def test_pipeline_batched_channels(rng):
    """Multi-channel (channelizer) batching: leading dims flow through."""
    taps = ops.windowed_sinc(33, 0.2, ops.hamming)
    p = Pipeline([Fir.decimator(taps, 4), FmDemod()],
                 block_in=1024, in_dtype=jnp.complex64, batch_shape=(8,))
    x = (rng.normal(size=(8, 4096)) + 1j * rng.normal(size=(8, 4096))
         ).astype(np.complex64)
    _, y = p.process(x)
    assert y.shape == (8, 1024)
    p1 = Pipeline(p.ops, block_in=1024, in_dtype=jnp.complex64)
    _, y0 = p1.process(x[3])
    np.testing.assert_allclose(np.asarray(y[3]), np.asarray(y0), atol=1e-5)


def test_pipeline_spectrogram(rng):
    p = Pipeline([FftStream(256, 128)], block_in=1024,
                 in_dtype=jnp.complex64)
    x = (rng.normal(size=4096) + 1j * rng.normal(size=4096)).astype(
        np.complex64)
    _, y = p.process(x)
    assert y.shape == (4096 // 128, 256)


@pytest.mark.parametrize("offset", [0, 1, 2])
def test_fir_resampler_stream_nonzero_offset(rng, offset):
    """Streaming with a nonzero initial phase offset (the reference's
    random starting group, TestSuite.hs:183)."""
    x = rng.uniform(-1, 1, 8400).astype(np.float32)
    taps = rng.uniform(-1, 1, 31).astype(np.float32)
    op = Fir.resampler(taps, 3, 10, offset=offset)
    chunk_vs_whole(op, x, 840, atol=1e-4)


def test_fir_streaming_offset_matches_offline(rng):
    from sdr_tpu.ops import fir as fir_ops
    offset = 2
    x = rng.uniform(-1, 1, 4200).astype(np.float32)
    taps = rng.uniform(-1, 1, 31).astype(np.float32)
    op = Fir.resampler(taps, 3, 10, offset=offset)
    H = op.hist_len(840)
    c = op.init_carry(840, np.float32)
    parts = []
    for i in range(0, 4200, 840):
        c, y = op.apply(c, jnp.asarray(x[i:i + 840]))
        parts.append(np.asarray(y))
    got = np.concatenate(parts)
    padded = np.concatenate([np.zeros(H, np.float32), x])
    want, _ = fir_ops.fir_resample(taps, 3, 10, padded, offset, len(got))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_fir_taps_longer_than_block(rng):
    """The reference requires filter length < buffer size (Filter.hs:5);
    overlap-save has no such constraint — history just spans multiple
    blocks."""
    x = rng.uniform(-1, 1, 4096).astype(np.float32)
    taps = rng.uniform(-1, 1, 500).astype(np.float32)  # >> block of 128
    chunk_vs_whole(Fir.filter(taps), x, 128, atol=1e-3)


def test_decimator_taps_longer_than_block(rng):
    x = rng.uniform(-1, 1, 8192).astype(np.float32)
    taps = rng.uniform(-1, 1, 300).astype(np.float32)
    chunk_vs_whole(Fir.decimator(taps, 4), x, 256, atol=1e-3)


def test_pipeline_run_batched_matches_run(rng):
    """Pipeline.run_batched — the single implementation of the
    segmented-carry loop (apps/fm.py --batched uses it) — equals the
    sequential run sample for sample, including a short final group."""
    p = fm_pipeline(81920)
    raw = rng.integers(0, 256, 81920 * 5).astype(np.uint8)
    want = np.concatenate(
        [np.asarray(y) for y in p.run(raw.reshape(5, 81920))], axis=-1)
    got = np.concatenate(
        list(p.run_batched(raw.reshape(5, 81920), parallel_blocks=2)),
        axis=-1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_pipeline_restore_rejects_shape_mismatch(rng, tmp_path):
    """A checkpoint from a structurally different pipeline (same op count,
    different filter lengths -> different history shapes) must not restore
    silently — a wrong-length Fir history would shift stream alignment."""
    import pytest
    taps_a = ops.windowed_sinc(64, 0.5, ops.hamming)
    taps_b = ops.windowed_sinc(32, 0.5, ops.hamming)
    p_a = Pipeline([Fir.filter(taps_a)], block_in=1024,
                   in_dtype=jnp.float32)
    p_b = Pipeline([Fir.filter(taps_b)], block_in=1024,
                   in_dtype=jnp.float32)
    path = str(tmp_path / "c.npz")
    p_a.checkpoint(p_a.init(), path)
    with pytest.raises(ValueError, match="shape"):
        p_b.restore(path)


def _chain_cases():
    from sdr_tpu.apps import chains
    u8 = jnp.uint8
    return {
        "fm_fused": (lambda: chains.fm_chain(), 81920, u8, ()),
        "fm_exact": (lambda: chains.fm_chain(front="exact"), 81920, u8, ()),
        "fm_quantized": (lambda: chains.fm_chain(front="quantized"), 81920,
                         u8, ()),
        "fm_deemphasis": (lambda: chains.fm_chain(deemphasis=75e-6), 81920,
                          u8, ()),
        "fm_stereo": (lambda: chains.fm_chain(stereo=True), 81920, u8, ()),
        "am": (chains.am_chain, 32768, u8, ()),
        "waterfall": (chains.waterfall_chain, 16384, u8, ()),
        "channelizer": (lambda: chains.channelizer_chain(4), 8000,
                        jnp.complex64, (4,)),
        "channelizer_wideband": (
            lambda: chains.channelizer_chain(4, wideband=True), 32000,
            jnp.complex64, ()),
    }


@pytest.mark.parametrize("name", list(_chain_cases()))
def test_pipeline_run_donates_every_chain(rng, name):
    """Pipeline.run donates its carries block to block.  Chains whose ops
    build a carry from one array twice (DcBlocker, Iir) must still run,
    and three blocks through run() equal process() on the same stream."""
    make, block, dtype, lead = _chain_cases()[name]
    if dtype == jnp.uint8:
        sig = rng.integers(0, 256, lead + (3 * block,)).astype(np.uint8)
    else:
        sig = (rng.normal(size=lead + (3 * block,))
               + 1j * rng.normal(size=lead + (3 * block,))
               ).astype(np.complex64)
    p = Pipeline(make(), block_in=block, in_dtype=dtype, batch_shape=lead)
    blocks = [sig[..., i * block:(i + 1) * block] for i in range(3)]
    got = np.concatenate([np.asarray(y) for y in p.run(blocks)],
                         axis=p._time_axis_out())
    _, want = p.process(sig)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
