"""Integer-matmul fused front end (ops/quantized.py, stream.U8FrontEnd)
and the fused front+demod (stream.U8FrontDemod).

Differential-tested against the exact f32 path (convert -> decimate), the
same strategy the reference applies across its kernel variants
(tests/TestSuite.hs:284-289, bound 0.01); the quantized path carries a
16-bit tap quantization so the practical bound here is ~1e-3.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from sdr_tpu.ops import fir, convert
from sdr_tpu.ops.quantized import fir_decimate_u8_planar
from sdr_tpu.stream import Pipeline, IqConvertU8, Fir, U8FrontEnd


@pytest.fixture
def rng():
    return np.random.default_rng(7)


@pytest.mark.parametrize("K,f,n", [(51, 8, 1 << 14), (64, 16, 1 << 13),
                                   (33, 4, 5000), (7, 1, 4096),
                                   (129, 8, 1 << 13)])
def test_u8_front_matches_f32(rng, K, f, n):
    raw = rng.integers(0, 256, 2 * n).astype(np.uint8)
    taps = rng.uniform(-1, 1, K).astype(np.float32)
    num = (n - K) // f + 1
    xc = convert.iq_u8_to_cfloat(jnp.asarray(raw))
    ref = np.asarray(fir.fir_decimate(taps, f, xc, num, method="direct"))
    got = np.asarray(fir_decimate_u8_planar(taps, f, jnp.asarray(raw), num))
    np.testing.assert_allclose(got[0] + 1j * got[1], ref, atol=1e-3)


@pytest.mark.parametrize("K,f,n", [(51, 8, 1 << 14), (33, 4, 5000)])
def test_u8_front_s8_precision(rng, K, f, n):
    """Single-band 8-bit-tap mode: half the matmul work.  Per-output error
    is bounded by the tap-quantization step: |err| <= K * max|tap| / 254
    (each tap off by at most half an LSB, |x| < 1).  For normalized
    real-filter taps (max|tap| ~ 0.2) that is ~2e-3 — inside the
    reference's 0.01 differential bound; this test's uniform(-1,1) taps
    are the worst case, so the bound scales with max|tap|."""
    raw = rng.integers(0, 256, 2 * n).astype(np.uint8)
    taps = rng.uniform(-1, 1, K).astype(np.float32)
    num = (n - K) // f + 1
    xc = convert.iq_u8_to_cfloat(jnp.asarray(raw))
    ref = np.asarray(fir.fir_decimate(taps, f, xc, num, method="direct"))
    got = np.asarray(fir_decimate_u8_planar(taps, f, jnp.asarray(raw), num,
                                            precision="s8"))
    bound = K * float(np.abs(taps).max()) / 254.0
    err = np.abs(got[0] + 1j * got[1] - ref)
    assert err.max() <= bound * np.sqrt(2), (err.max(), bound)
    # RMS is ~sqrt(K/3)/2 LSBs — an order tighter than the worst case
    assert np.sqrt((err ** 2).mean()) <= bound / 4


def test_u8_frontend_seam_split_bit_exact(rng):
    """Blockwise U8FrontEnd (the seam-split apply: boundary outputs from
    a tiny carry+head array, main outputs from a view of x) is
    BIT-IDENTICAL to the one-shot whole-stream computation with the 0x80
    warmup history prepended — every output is the same integer dot."""
    from sdr_tpu.apps.chains import fm_taps
    block, B = 16384, 5
    raw = rng.integers(0, 256, B * block).astype(np.uint8)
    rf = fm_taps()[0]
    for precision in ("s16", "s8"):
        pq = Pipeline([U8FrontEnd(rf, 8, precision=precision)],
                      block_in=block, in_dtype=jnp.uint8)
        _, yq = pq.process(raw)
        H = 2 * (rf.shape[0] - 8)
        whole = np.concatenate([np.full(H, 0x80, np.uint8), raw])
        want = fir_decimate_u8_planar(rf, 8, jnp.asarray(whole),
                                      B * block // 2 // 8,
                                      precision=precision)
        np.testing.assert_array_equal(np.asarray(yq), np.asarray(want))


def test_u8_front_batched_lead_dims(rng):
    raw = rng.integers(0, 256, (3, 2 * 4096)).astype(np.uint8)
    taps = rng.uniform(-1, 1, 31).astype(np.float32)
    num = (4096 - 31) // 4 + 1
    got = np.asarray(fir_decimate_u8_planar(taps, 4, jnp.asarray(raw), num))
    assert got.shape == (3, 2, num)
    for b in range(3):
        ref = np.asarray(fir_decimate_u8_planar(taps, 4,
                                                jnp.asarray(raw[b]), num))
        np.testing.assert_allclose(got[b], ref, atol=1e-6)


def test_u8_frontend_stream_matches_exact_stages(rng):
    """Blockwise U8FrontEnd == [IqConvertU8(planar) -> Fir.decimator]
    including the cross-block seam (0x80 warmup bytes = zero samples)."""
    from sdr_tpu.apps.chains import fm_taps
    block, B = 16384, 5
    raw = rng.integers(0, 256, B * block).astype(np.uint8)
    rf = fm_taps()[0]
    pe = Pipeline([IqConvertU8(planar=True),
                   Fir.decimator(rf, 8, method="conv")],
                  block_in=block, in_dtype=jnp.uint8)
    pq = Pipeline([U8FrontEnd(rf, 8)], block_in=block, in_dtype=jnp.uint8)
    _, ye = pe.process(raw)
    _, yq = pq.process(raw)
    np.testing.assert_allclose(np.asarray(yq), np.asarray(ye), atol=1e-3)


def test_quantized_fm_chain_parity():
    """Full quantized chain vs exact chain on a constant-envelope FM
    signal (random IQ would amplify front-end LSB noise through the
    demod's 1/|x| phase sensitivity — not a kernel property)."""
    from sdr_tpu.apps.chains import fm_chain
    fs, n = 1_280_000, 163840 * 2
    t = np.arange(n) / fs
    audio = np.sin(2 * np.pi * 1000 * t)
    iq = 0.9 * np.exp(1j * (2 * np.pi * 75e3 * np.cumsum(audio) / fs))
    raw = np.empty(2 * n, np.uint8)
    raw[0::2] = np.clip(np.round(iq.real * 128 + 128), 0, 255)
    raw[1::2] = np.clip(np.round(iq.imag * 128 + 128), 0, 255)
    pe = Pipeline(fm_chain(method="conv"), block_in=163840,
                  in_dtype=jnp.uint8)
    _, ye = pe.process(raw)
    for precision, atol in (("s16", 1e-3), ("s8", 8e-3)):
        pq = Pipeline(fm_chain(method="conv", front="quantized",
                               front_precision=precision),
                      block_in=163840, in_dtype=jnp.uint8)
        _, yq = pq.process(raw)
        np.testing.assert_allclose(np.asarray(yq), np.asarray(ye),
                                   atol=atol)


def test_fused_front_demod_stream_matches_pair(rng):
    """Blockwise U8FrontDemod == the exact f32 stages IqConvertU8(planar)
    -> Fir.decimator -> FmDemod(planar, poly) across block seams, in both
    the kernel path (interpret mode) and the plain XLA path the op takes
    on the CPU."""
    from sdr_tpu.stream import U8FrontDemod, FmDemod
    from sdr_tpu.apps.chains import fm_taps
    block, B = 16384, 5
    raw = rng.integers(0, 256, B * block).astype(np.uint8)
    rf = fm_taps()[0]
    pp = Pipeline([IqConvertU8(planar=True), Fir.decimator(rf, 8),
                   FmDemod(planar=True, atan2="poly")],
                  block_in=block, in_dtype=jnp.uint8)
    _, want = pp.process(raw)
    for interpret in (True, False):
        pf = Pipeline([U8FrontDemod(rf, 8, interpret=interpret)],
                      block_in=block, in_dtype=jnp.uint8)
        _, got = pf.process(raw)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-5)


def test_fused_front_demod_time_batched(rng):
    """Block-parallel (vmap + halo ppermute) U8FrontDemod == its
    sequential streamed run (exercises the 2K-byte shard_carry halo and
    the derived last-sample seed), kernel and XLA paths."""
    from sdr_tpu.stream import U8FrontDemod
    from sdr_tpu.apps.chains import fm_taps
    from sdr_tpu import parallel
    block, B = 16384, 4
    raw = rng.integers(0, 256, B * block).astype(np.uint8)
    rf = fm_taps()[0]
    for interpret in (True, False):
        ops = [U8FrontDemod(rf, 8, interpret=interpret)]
        p = Pipeline(ops, block_in=block, in_dtype=jnp.uint8)
        _, seq = p.process(raw)
        par = np.asarray(parallel.run_time_batched(ops, jnp.asarray(raw),
                                                   B))
        np.testing.assert_allclose(par, np.asarray(seq), atol=1e-5)


def test_quantized_chain_time_batched(rng):
    """Block-parallel (vmap) execution of the quantized chain equals its
    sequential streamed run."""
    from sdr_tpu.apps.chains import fm_chain
    from sdr_tpu import parallel
    block, B = 163840, 4
    raw = rng.integers(0, 256, B * block).astype(np.uint8)
    ops = fm_chain(method="conv", front="quantized")
    p = Pipeline(ops, block_in=block, in_dtype=jnp.uint8)
    _, seq = p.process(raw)
    par = np.asarray(parallel.run_time_batched(ops, jnp.asarray(raw), B))
    np.testing.assert_allclose(par, np.asarray(seq), atol=1e-5)


def test_segmented_batched_continuation(rng):
    """run_time_batched with carries in/out continues a stream exactly
    across segment seams (the bounded-memory offline/live-group path,
    Pipeline.process(parallel_blocks=...))."""
    from sdr_tpu.apps.chains import fm_chain
    from sdr_tpu.parallel.sharded import run_time_batched

    block, B, G = 163840, 4, 3
    raw = rng.integers(0, 256, G * B * block).astype(np.uint8)
    for front in ("exact", "quantized", "fused"):
        ops = fm_chain(method="conv", front=front)
        p = Pipeline(ops, block_in=block, in_dtype=jnp.uint8)
        _, seq = p.process(raw)
        cs = p.init()
        outs = []
        for g in range(G):
            seg = jnp.asarray(raw[g * B * block:(g + 1) * B * block])
            cs, y = run_time_batched(ops, seg, B, carries=cs,
                                     return_carries=True)
            outs.append(np.asarray(y))
        np.testing.assert_allclose(np.concatenate(outs), np.asarray(seq),
                                   atol=1e-5)
        # the high-level wrapper does the same loop
        cs2, y2 = p.process(raw, parallel_blocks=B)
        np.testing.assert_allclose(np.asarray(y2), np.asarray(seq),
                                   atol=1e-5)


def test_short_taps_edge(rng):
    """Taps shorter than the decimation factor (the band ends inside one
    window row, W < stride): the split main/halo formulation must still
    match the exact f32 path."""
    for K, f in [(3, 8), (5, 8), (8, 8)]:
        taps = rng.uniform(-1, 1, K).astype(np.float32)
        raw = jnp.asarray(rng.integers(0, 256, 4096).astype(np.uint8))
        num = (4096 // 2 - K) // f + 1
        got = fir_decimate_u8_planar(taps, f, raw, num)
        x = convert.iq_u8_to_cfloat(raw)
        want = fir.fir_decimate(taps, f, x, num, method="direct")
        want = jnp.stack([want.real, want.imag], axis=-2)
        assert float(jnp.abs(got - want).max()) < 3e-4


def test_q_out_geometry_invariance(rng):
    """Any band geometry q_out must yield bit-identical samples (it only
    moves the matmul-work tradeoff), including combined with a
    byte_off streaming seam."""
    import jax.numpy as jnp
    from sdr_tpu.ops.quantized import fir_decimate_u8_planar
    taps = rng.uniform(-1, 1, 51).astype(np.float32)
    raw = jnp.asarray(rng.integers(0, 256, 1 << 14, dtype=np.uint8))
    for prec in ("s8", "s16"):
        ref = np.asarray(fir_decimate_u8_planar(taps, 8, raw, 900,
                                                precision=prec))
        for q in (16, 32, 64, 256):
            got = np.asarray(fir_decimate_u8_planar(taps, 8, raw, 900,
                                                    precision=prec,
                                                    q_out=q))
            np.testing.assert_array_equal(got, ref)
    a = np.asarray(fir_decimate_u8_planar(taps, 8, raw, 800, q_out=32,
                                          byte_off=6))
    b = np.asarray(fir_decimate_u8_planar(taps, 8, raw[6:], 800))
    np.testing.assert_array_equal(a, b)


def test_u8_front_end_q_out_streaming(rng):
    """U8FrontEnd(q_out=...) streams identically to the default geometry."""
    import jax.numpy as jnp
    from sdr_tpu.stream import U8FrontEnd
    taps = rng.uniform(-1, 1, 51).astype(np.float32)
    raw = jnp.asarray(rng.integers(0, 256, (3, 4096), dtype=np.uint8))
    outs = []
    for q in (64, 128):
        op = U8FrontEnd(taps, 8, q_out=q)
        c = op.init_carry(4096, jnp.uint8)
        ys = []
        for b in range(3):
            c, y = op.apply(c, raw[b])
            ys.append(np.asarray(y))
        outs.append(np.concatenate(ys, axis=-1))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_chain_level_front_precision_accuracy():
    """CHAIN-level accuracy of the quantized fronts on a real FM signal:
    the demod's atan2 normalizes the front's amplitude-quantization
    error, so s8 lands ~1e-5 from the exact f32 front — 1000x inside
    the reference's 0.01 bound (the basis for fm_chain's s8 default)."""
    import jax.numpy as jnp
    from sdr_tpu.stream import Pipeline
    from sdr_tpu.stream.sources import fm_mod
    from sdr_tpu.apps.chains import fm_chain

    fs = 1_280_000.0
    n = 163840
    t = np.arange(n // 2) / fs
    audio = (0.8 * np.sin(2 * np.pi * 1000 * t)
             + 0.2 * np.sin(2 * np.pi * 4000 * t)).astype(np.float32)
    iq = fm_mod(audio, 75e3, fs)
    raw = np.empty(n, np.uint8)
    raw[0::2] = np.clip(np.round(iq.real * 127 + 128), 0, 255)
    raw[1::2] = np.clip(np.round(iq.imag * 127 + 128), 0, 255)

    outs = {}
    for tag, kw in (("exact", dict(front="exact")),
                    ("s16", dict(front="quantized",
                                 front_precision="s16")),
                    ("s8", dict(front="quantized",
                                front_precision="s8"))):
        p = Pipeline(fm_chain(method="conv", **kw),
                     block_in=n, in_dtype=jnp.uint8)
        _, y = p.process(jnp.asarray(raw))
        outs[tag] = np.asarray(y)
    assert np.abs(outs["s16"] - outs["exact"]).max() < 1e-5
    assert np.abs(outs["s8"] - outs["exact"]).max() < 1e-4


def _u8_front_oracle(taps, factor, raw, num):
    """Float reference: convert (convert.c:15-20) then decimate
    (decimate.c:73-82), per plane."""
    x = (raw.astype(np.float64) - 128.0) / 128.0
    i, q = x[0::2], x[1::2]
    out = np.empty((2, num))
    for c, comp in enumerate((i, q)):
        for m in range(num):
            out[c, m] = np.dot(taps, comp[m * factor: m * factor + len(taps)])
    return out


@pytest.mark.parametrize("precision", ["s8", "s16"])
@pytest.mark.parametrize("factor,ntaps", [(8, 51), (4, 33), (2, 17), (8, 72)])
def test_u8_front_oracle_geometries(rng, factor, ntaps, precision):
    """The XLA integer front against the float oracle at the tap/factor
    geometries of the FM front and its neighbours, within the tap
    quantization bound (half an LSB per tap, |x| < 1, both planes)."""
    raw = rng.integers(0, 256, 20000).astype(np.uint8)
    taps = rng.uniform(-1, 1, ntaps).astype(np.float32)
    num = (raw.shape[0] // 2 - ntaps) // factor + 1
    got = np.asarray(fir_decimate_u8_planar(taps, factor, jnp.asarray(raw),
                                            num, precision=precision))
    lsb = 254.0 if precision == "s8" else 65024.0
    bound = ntaps * float(np.abs(taps).max()) / lsb
    np.testing.assert_allclose(got, _u8_front_oracle(taps, factor, raw, num),
                               atol=bound)
