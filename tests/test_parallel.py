"""Sharded execution tests on the virtual 8-device CPU mesh.

The multi-device analog of the reference's differential strategy: the
sharded run must agree with the single-device run to the same tolerance
(SURVEY.md §4 'the sharded run must agree ... which IS the multi-node
test').  Exactness here is stronger: identical zero-padded-warmup
semantics, so tolerances are float-roundoff only.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from sdr_tpu import ops as O
from sdr_tpu import parallel
from sdr_tpu.stream import (Fir, FmDemod, DcBlocker, Scale, Mix,
                            IqConvertU8, FftStream, Pipeline)


def single_device_reference(op_list, x, block):
    p = Pipeline(op_list, block_in=block, in_dtype=x.dtype,
                 batch_shape=x.shape[:-1])
    _, y = p.process(x)
    return np.asarray(y)


@pytest.fixture(scope="module")
def mesh8():
    return parallel.time_mesh(8)


def test_left_halo(mesh8):
    x = jnp.arange(64, dtype=jnp.float32)

    def fn(xl):
        return parallel.left_halo(xl, 3, "t")

    y = jax.shard_map(fn, mesh=mesh8, in_specs=parallel.mesh.P("t"),
                      out_specs=parallel.mesh.P("t"), check_vma=False)(x)
    y = np.asarray(y).reshape(8, 3)
    np.testing.assert_array_equal(y[0], [0, 0, 0])
    np.testing.assert_array_equal(y[1], [5, 6, 7])
    np.testing.assert_array_equal(y[7], [53, 54, 55])


def test_time_sharded_fir_filter(rng, mesh8):
    x = rng.uniform(-1, 1, 8192).astype(np.float32)
    taps = rng.uniform(-1, 1, 63).astype(np.float32)
    chain = [Fir.filter(taps)]
    want = single_device_reference(chain, x, 1024)
    got = np.asarray(parallel.run_time_sharded(chain, mesh8, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_time_sharded_full_fm_chain(rng, mesh8):
    """The flagship: whole FM chain time-sharded across 8 devices equals the
    single-device stream."""
    rf = O.windowed_sinc(51, 0.1, O.hamming)
    ars = O.windowed_sinc(31, 0.25, O.hamming)
    afl = O.windowed_sinc(64, 0.5, O.hamming)
    chain = [IqConvertU8(), Fir.decimator(rf, 8), FmDemod(),
             Fir.resampler(ars, 3, 10), Fir.filter(afl), Scale(0.2)]
    raw = rng.integers(0, 256, 81920 * 8).astype(np.uint8)
    want = single_device_reference(chain, raw, 81920)
    got = np.asarray(parallel.run_time_sharded(chain, mesh8,
                                               jnp.asarray(raw)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_time_sharded_dc_blocker(rng, mesh8):
    x = (rng.uniform(-1, 1, 8192) + 0.7).astype(np.float32)
    chain = [DcBlocker()]
    want = single_device_reference(chain, x, 1024)
    got = np.asarray(parallel.run_time_sharded(chain, mesh8, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_time_sharded_mix(mesh8):
    x = np.ones(8192, dtype=np.complex64)
    chain = [Mix(0.05)]
    want = single_device_reference(chain, x, 1024)
    got = np.asarray(parallel.run_time_sharded(chain, mesh8, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_time_sharded_fft_stream(rng, mesh8):
    x = (rng.normal(size=8192) + 1j * rng.normal(size=8192)).astype(
        np.complex64)
    chain = [FftStream(256, 128)]
    p = Pipeline(chain, block_in=8192, in_dtype=x.dtype)
    _, want = p.process(x)
    got = np.asarray(parallel.run_time_sharded(chain, mesh8, jnp.asarray(x)))
    # sharded output: per-shard frame batches concatenated along frames
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-3)


def test_channel_sharded(rng, mesh8):
    taps = O.windowed_sinc(33, 0.2, O.hamming)
    chain = [Fir.decimator(taps, 4), FmDemod()]
    x = (rng.normal(size=(8, 4096)) + 1j * rng.normal(size=(8, 4096))
         ).astype(np.complex64)
    mesh = parallel.make_mesh((8,), ("c",))
    got = np.asarray(parallel.run_channel_sharded(chain, mesh,
                                                  jnp.asarray(x)))
    for c in range(8):
        want = single_device_reference(chain, x[c], 4096)
        np.testing.assert_allclose(got[c], want, atol=1e-4)


def test_grid_sharded_channel_time(rng):
    """2-D mesh {channel=2, time=4}: channelized FM chains, each channel's
    stream time-sharded with halo exchange."""
    mesh = parallel.channel_time_mesh(2, 4)
    rf = O.windowed_sinc(51, 0.1, O.hamming)
    chain = [Fir.decimator(rf, 8), FmDemod()]
    x = (rng.normal(size=(4, 81920)) + 1j * rng.normal(size=(4, 81920))
         ).astype(np.complex64)
    got = np.asarray(parallel.run_grid_sharded(chain, mesh, jnp.asarray(x)))
    for c in range(4):
        want = single_device_reference(chain, x[c], 20480)
        np.testing.assert_allclose(got[c], want, rtol=1e-4, atol=1e-4)


def test_agc_time_sharding_fails_fast(rng, mesh8):
    """Unshardable ops are rejected at runner CONSTRUCTION with guidance,
    not from deep inside shard_map tracing (the sequential-scan AGC
    without the sweep opt-in; the default linear AGC shards exactly)."""
    from sdr_tpu.stream import Agc
    x = (np.ones(8192) + 0j).astype(np.complex64)
    with pytest.raises(ValueError, match="approx_time_sharding"):
        parallel.run_time_sharded([Agc(0.01, 1.0, method="scan")], mesh8,
                                  jnp.asarray(x))
    with pytest.raises(ValueError, match="approx_time_sharding"):
        parallel.run_time_batched([Agc(0.01, 1.0, method="scan")],
                                  jnp.asarray(x), 8)


def test_agc_linear_matches_scan(rng):
    """The associative-scan AGC equals the literal sequential recurrence
    in the operating regime (positive gain)."""
    from sdr_tpu.ops import scans
    x = ((1.5 + 0.3 * rng.normal(size=16384))
         * np.exp(2j * np.pi * rng.uniform(size=16384))).astype(np.complex64)
    y_lin, g_lin = scans.agc(jnp.asarray(x), 0.005, 1.0, 1.0,
                             method="linear")
    y_seq, g_seq = scans.agc(jnp.asarray(x), 0.005, 1.0, 1.0,
                             method="scan")
    np.testing.assert_allclose(np.asarray(y_lin), np.asarray(y_seq),
                               atol=1e-4)
    np.testing.assert_allclose(float(g_lin), float(g_seq), atol=1e-4)


def test_agc_linear_exact_time_sharding(rng, mesh8):
    """Default (linear) AGC time-shards EXACTLY via the affine prefix —
    sharded == sequential streamed."""
    from sdr_tpu.stream import Agc
    n = 8 * 8192
    x = ((2.0 + 0.2 * rng.normal(size=n))
         * np.exp(2j * np.pi * rng.uniform(size=n))).astype(np.complex64)
    chain = [Agc(0.005, 1.0)]
    want = single_device_reference(chain, x, 8192)
    got = np.asarray(parallel.run_time_sharded(chain, mesh8,
                                               jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-4)
    got_b = np.asarray(parallel.run_time_batched(chain, jnp.asarray(x), 8))
    np.testing.assert_allclose(got_b, want, atol=1e-4)


def test_agc_approx_time_sharding(rng):
    """Documented approximate segmented AGC: R refinement sweeps with gain
    handoff.  The recurrence forgets its initial gain exponentially, so
    with blocks much longer than the AGC time constant the block-parallel
    output matches the sequential stream well inside the 0.01 differential
    bound."""
    from sdr_tpu.stream import Agc
    n, B = 65536, 8
    x = ((2.0 + 0.2 * rng.normal(size=n))
         * np.exp(2j * np.pi * rng.uniform(size=n))).astype(np.complex64)
    want = single_device_reference([Agc(0.005, 1.0, method="scan")],
                                   x, n // B)
    got = np.asarray(parallel.run_time_batched(
        [Agc(0.005, 1.0, method="scan", approx_time_sharding=2)],
        jnp.asarray(x), B))
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_am_chain_batched_path(rng):
    """BASELINE config #4 runs block-parallel out of the box (linear AGC
    shards exactly) and matches the sequential streamed run; the
    sequential-scan AGC variant still works via the sweep opt-in."""
    from sdr_tpu.apps.chains import am_chain
    from sdr_tpu.stream import Pipeline
    raw = rng.integers(0, 256, 8 * 16384, dtype=np.uint8)
    ops = am_chain()
    y = np.asarray(parallel.run_time_batched(ops, jnp.asarray(raw), 8))
    assert y.shape == (8 * 16384 // 2 // 16,)
    assert np.isfinite(y).all()
    p = Pipeline(ops, block_in=16384, in_dtype=jnp.uint8)
    _, seq = p.process(raw)
    np.testing.assert_allclose(y, np.asarray(seq), atol=1e-4)
    y2 = np.asarray(parallel.run_time_batched(am_chain(agc_approx=1),
                                              jnp.asarray(raw), 8))
    assert np.isfinite(y2).all()


def test_time_batched_matches_sequential(rng):
    """run_time_batched (vmap block-parallel on one device) reproduces the
    sequential streamed run exactly — the offline-throughput execution
    path used by the bench headline."""
    from sdr_tpu.apps.chains import fm_chain
    from sdr_tpu.stream import Pipeline

    block, B = 163840, 8
    ops = fm_chain(method="conv")
    raw = rng.integers(0, 256, B * block).astype(np.uint8)
    p = Pipeline(ops, block_in=block, in_dtype=jnp.uint8)
    _, seq = p.process(raw)
    par = np.asarray(parallel.run_time_batched(ops, jnp.asarray(raw), B))
    np.testing.assert_allclose(par, np.asarray(seq), atol=1e-5)


def test_time_batched_dc_blocker_exact(rng):
    """Affine-prefix recurrence composition works under vmap too."""
    x = rng.normal(size=16384).astype(np.float32)
    want = single_device_reference([DcBlocker()], x, 2048)
    got = np.asarray(parallel.run_time_batched([DcBlocker()],
                                               jnp.asarray(x), 8))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_mix_shard_phase_precision():
    """Shard-start LO phases come from a float64 host table reduced mod 1
    BEFORE the f32 cast, so phase error does not grow with shard index.
    512 shards of 16 samples: the old traced-f32 ``frac * idx`` form errs
    ~2e-4 here; the table keeps it at f32 rounding."""
    f = 0.1234567
    n, B = 8192, 512
    x = np.ones(n, dtype=np.complex64)
    got = np.asarray(parallel.run_time_batched([Mix(f)], jnp.asarray(x), B))
    want = np.exp(2j * np.pi * np.mod(f * np.arange(n, dtype=np.float64),
                                      1.0))
    np.testing.assert_allclose(got, want.astype(np.complex64), atol=3e-5)


def test_time_batched_channelize_restack(rng):
    """The block axis must merge into the CHANNEL-INNER time axis for
    Channelize chains ([..., C, n/C] per block -> [..., C, total/C]), not
    into the first per-block axis (the round-1 _restack bug: expected
    (C, total/C), got (B*C, n/C))."""
    from sdr_tpu.ops.channelize import channelizer_taps
    from sdr_tpu.stream import Channelize
    C, n, B = 4, 8192, 8
    taps = channelizer_taps(C, 6)
    op = Channelize(taps, C)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    c0 = op.init_carry(n, x.dtype)
    _, whole = op.apply(c0, jnp.asarray(x))
    got = np.asarray(parallel.run_time_batched([op], jnp.asarray(x), B))
    assert got.shape == (C, n // C)
    np.testing.assert_allclose(got, np.asarray(whole), atol=1e-4)
    # same through Pipeline.process (scan path) and parallel_blocks path
    p = Pipeline([op], block_in=n // B, in_dtype=x.dtype)
    _, seq = p.process(x)
    assert seq.shape == (C, n // C)
    np.testing.assert_allclose(np.asarray(seq), np.asarray(whole), atol=1e-4)
    _, par = p.process(x, parallel_blocks=4)
    np.testing.assert_allclose(np.asarray(par), np.asarray(whole), atol=1e-4)


def test_time_sharded_iir_cascade_exact(rng, mesh8):
    """Exact IIR time-sharding (matrix affine prefix): a sharded biquad
    cascade equals the sequential streamed run (VERDICT r3 #5)."""
    from sdr_tpu.stream import Iir
    import scipy.signal
    sos = scipy.signal.butter(4, 0.2, output="sos").astype(np.float32)
    x = rng.uniform(-1, 1, 8192).astype(np.float32)
    chain = [Iir(sos)]
    want = single_device_reference(chain, x, 1024)
    got = np.asarray(parallel.run_time_sharded(chain, mesh8, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_time_batched_iir_segment_continuation(rng):
    """Iir under the batch formulation, with carries continuing a stream
    across segments exactly (initial= path of Iir.shard_carry)."""
    from sdr_tpu.stream import Iir
    import scipy.signal
    sos = scipy.signal.butter(4, 0.15, output="sos").astype(np.float32)
    x = rng.uniform(-1, 1, 4096).astype(np.float32)
    chain = [Iir(sos)]
    want = single_device_reference(chain, x, 512)
    # two 4-block segments, state handed across the seam
    c1, y1 = parallel.run_time_batched(chain, jnp.asarray(x[:2048]), 4,
                                       return_carries=True)
    y2 = parallel.run_time_batched(chain, jnp.asarray(x[2048:]), 4,
                                   carries=c1)
    got = np.concatenate([np.asarray(y1), np.asarray(y2)])
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_time_sharded_fm_chain_iir_deemphasis(rng, mesh8):
    """The FM chain with the true-IIR de-emphasis stage time-shards and
    matches the sequential run."""
    from sdr_tpu.apps.chains import fm_chain
    chain = fm_chain(deemphasis=75e-6, deemphasis_mode="iir")
    raw = rng.integers(0, 256, 81920 * 8).astype(np.uint8)
    want = single_device_reference(chain, raw, 81920)
    got = np.asarray(parallel.run_time_sharded(chain, mesh8,
                                               jnp.asarray(raw)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
