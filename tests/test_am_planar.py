"""Planar AM chain: the all-real formulation must equal the complex one.

The planar chain keeps every stage all-real (no complex64 anywhere); these
tests pin it to the complex form.  Reference semantics: mix Util.hs:263-285,
agc Util.hs:329-348, envelope + chain shape examples/am/am.hs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sdr_tpu.apps.chains import am_chain
from sdr_tpu.stream import Pipeline, Mix, Agc, AmDemod
from sdr_tpu import parallel


def _am_raw(n, fs=1.0):
    rng = np.random.default_rng(7)
    t = np.arange(n)
    msg = 0.5 + 0.4 * np.sin(2 * np.pi * 0.001 * t)
    carrier = msg * np.exp(2j * np.pi * 0.25 * t)
    iq = carrier + 0.01 * (rng.standard_normal(n)
                           + 1j * rng.standard_normal(n))
    raw = np.empty(2 * n, np.uint8)
    raw[0::2] = np.clip(np.round(iq.real * 100 + 128), 0, 255)
    raw[1::2] = np.clip(np.round(iq.imag * 100 + 128), 0, 255)
    return raw


def _to_planar(x):
    return jnp.stack([jnp.real(x), jnp.imag(x)], axis=-2)


def test_mix_planar_matches_complex(rng):
    x = (rng.uniform(-1, 1, 4096) + 1j * rng.uniform(-1, 1, 4096)
         ).astype(np.complex64)
    mc, mp = Mix(-0.21), Mix(-0.21, planar=True)
    cc = mc.init_carry(4096, jnp.complex64)
    cp = mp.init_carry(4096, jnp.float32, batch_shape=(2,))
    xc, xp = jnp.asarray(x), _to_planar(jnp.asarray(x))
    for _ in range(3):  # carry continuity across blocks
        cc, yc = mc.apply(cc, xc)
        cp, yp = mp.apply(cp, xp)
        np.testing.assert_allclose(np.asarray(yp[..., 0, :]),
                                   np.asarray(jnp.real(yc)), atol=2e-6)
        np.testing.assert_allclose(np.asarray(yp[..., 1, :]),
                                   np.asarray(jnp.imag(yc)), atol=2e-6)
    np.testing.assert_allclose(np.asarray(cp),
                               [float(jnp.real(cc)), float(jnp.imag(cc))],
                               atol=2e-6)


def test_agc_planar_matches_complex(rng):
    x = (0.3 * (rng.uniform(0.2, 1, 8192) *
                np.exp(1j * rng.uniform(0, 7, 8192)))).astype(np.complex64)
    ac, ap = Agc(0.005, 1.0), Agc(0.005, 1.0, planar=True)
    cc = ac.init_carry(8192, jnp.complex64)
    cp = ap.init_carry(8192, jnp.float32, batch_shape=(2,))
    xc, xp = jnp.asarray(x), _to_planar(jnp.asarray(x))
    for _ in range(2):
        cc, yc = ac.apply(cc, xc)
        cp, yp = ap.apply(cp, xp)
        np.testing.assert_allclose(np.asarray(yp[..., 0, :]),
                                   np.asarray(jnp.real(yc)), atol=1e-5)
    np.testing.assert_allclose(float(cp), float(cc), atol=1e-5)


def test_amdemod_planar(rng):
    x = (rng.uniform(-1, 1, 1024) + 1j * rng.uniform(-1, 1, 1024)
         ).astype(np.complex64)
    _, yc = AmDemod().apply((), jnp.asarray(x))
    _, yp = AmDemod(planar=True).apply((), _to_planar(jnp.asarray(x)))
    np.testing.assert_allclose(np.asarray(yp), np.asarray(yc), atol=1e-6)


def test_am_chain_planar_matches_complex_pipeline():
    raw = _am_raw(1 << 16)
    outs = {}
    for planar in (False, True):
        p = Pipeline(am_chain(planar=planar), block_in=1 << 14,
                     in_dtype=jnp.uint8)
        _, outs[planar] = p.process(raw)
    a, b = np.asarray(outs[False]), np.asarray(outs[True])
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, atol=1e-4)  # reference bound is 0.01


def test_am_chain_planar_sharded_matches_sequential():
    raw = _am_raw(1 << 16)
    ops = am_chain()
    p = Pipeline(ops, block_in=1 << 16, in_dtype=jnp.uint8)
    _, seq = p.process(raw)
    got = parallel.run_time_sharded(am_chain(), parallel.time_mesh(8),
                                    jnp.asarray(raw))
    np.testing.assert_allclose(np.asarray(got).ravel(),
                               np.asarray(seq).ravel(), atol=1e-4)


def test_am_chain_planar_never_materializes_complex():
    ops = am_chain()
    dt = jnp.uint8
    for op in ops:
        dt = op.out_dtype(dt)
        assert not jnp.issubdtype(dt, jnp.complexfloating), repr(op)


def test_am_chain_planar_agc_approx_rejected():
    with pytest.raises(ValueError, match="planar"):
        am_chain(agc_approx=2, planar=True)
    ops = am_chain(agc_approx=2)  # auto-falls back to the complex form
    assert any(jnp.issubdtype(op.out_dtype(jnp.complex64),
                              jnp.complexfloating) for op in ops[1:2])
