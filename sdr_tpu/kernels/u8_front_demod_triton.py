"""Pallas kernel (Triton route): fused u8-IQ convert -> decimate -> FM demod.

The one stage of the FM chain that runs at the full input rate.  Per
decimated output it reads ``2*factor`` input bytes and writes one f32;
the decimated I/Q planes never leave registers.  The plain XLA forms
write the converted complex (or planar) block to device memory and read
it back, which is most of their traffic.

Layout.  The raw u8 block is viewed as rows of ``2*factor`` bytes (one
row per decimated output: ``factor`` interleaved I/Q pairs), read as
little-endian 32-bit words of two I/Q pairs each (so ``factor`` must be
even).  Output ``m`` reads rows ``m .. m+D-1`` with tap
``taps[d*factor + j]`` on the ``j``-th sample of row ``m+d``
(``D = ceil(K/factor)``).  The taps are constants of the compiled
kernel: every tap is one multiply-add per plane on a 1-D vector, and a
zero tap (padding, a seam offset) costs nothing.  A program owns ``G*R`` consecutive
outputs, dealt out in ``G`` phases: phase ``g`` holds outputs
``m0 + G*p + g`` for ``p < R``.  Phase ``g`` at shift ``d`` reads the row
set ``m0 + s + G*p`` with ``s = g + d``, so each of the ``G + D`` row
sets is loaded and converted once and feeds every phase that needs it.

Demod.  ``y[m] = atan2(x[m] * conj(x[m-1]))``.  Phase ``g`` finds its
predecessor in phase ``g-1``.  Phase 0's predecessor is the output just
before each of its outputs: a ``(G+1)``-th accumulator computed from row
set ``s = -1``, so no state passes between programs (they run in no
order).  Only the stream's first output takes the caller's ``last_iq``.

Conversion.  ``u8 | 0x4B000000`` read as f32 is ``2^23 + u8`` exactly, so
one OR and one subtract give ``u8 - 128`` without an int-to-float
instruction; the ``1/128`` scale is folded into the taps.

Arithmetic is f32 throughout (f32 taps, f32 sums in row order), so the
result matches the exact f32 front (``IqConvertU8`` -> ``Fir.decimator``
-> ``FmDemod(atan2='poly')``) to f32 rounding.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from sdr_tpu.ops.demod import fast_atan2

__all__ = ["u8_front_demod"]

# Tile geometry: the fastest of the (G, R, warps) points measured on an
# H100 at a 400 W limit, both at 32 x 10 MiB and at one 1.3 MB block.
PHASES = 4        # G: outputs interleaved per program row
ROWS = 256        # R: outputs per phase per program
NUM_WARPS = 4
NUM_STAGES = 1

_MAGIC = 0x4B000000                 # f32 bits of 2^23
_MAGIC_OFF = float(2 ** 23 + 128)   # 2^23 + the u8 zero level


def _plan(taps: np.ndarray, factor: int, byte_off: int):
    """Zero-padded, row-shaped taps ``[D][factor]`` scaled by 1/128, as
    Python floats (the kernel is specialized on them).

    ``byte_off`` (even) shifts every window right by ``byte_off/2``
    samples; it becomes leading zero taps, so the kernel's row view of
    the raw buffer always starts at byte 0 (no sliced copy)."""
    if byte_off % 2:
        raise ValueError(f"byte_off {byte_off} must be even (whole IQ pairs)")
    te = np.concatenate([np.zeros(byte_off // 2, np.float32),
                         np.asarray(taps, np.float32)])
    D = -(-te.shape[0] // factor)
    w = np.zeros(D * factor, np.float32)
    w[: te.shape[0]] = te / np.float32(128.0)
    return tuple(tuple(float(v) for v in row) for row in w.reshape(D, factor))


def _kernel(x_ref, liq_ref, o_ref, *, taps, factor: int, G: int, R: int,
            nrows: int):
    D = len(taps)
    wpr = factor // 2                      # u32 words (2 samples) per row
    m0 = pl.program_id(0) * (G * R)
    p = jax.lax.broadcasted_iota(jnp.int32, (R,), 0)
    # acc[g + 1] accumulates phase g in [-1, G), one [R] vector per plane
    acc_i = [None] * (G + 1)
    acc_q = [None] * (G + 1)

    def to_f32(b):                         # u8 in the low bits -> u8 - 128
        bits = b | jnp.uint32(_MAGIC)
        return jax.lax.bitcast_convert_type(bits, jnp.float32) - _MAGIC_OFF

    for s in range(-1, G + D - 1):
        rows = m0 + s + G * p
        ok = (rows >= 0) & (rows < nrows)
        for c in range(wpr):
            w = plgpu.load(x_ref.at[rows * wpr + c], mask=ok,
                           other=jnp.uint32(0x80808080))
            planes = (to_f32(w & 0xFF), to_f32((w >> 8) & 0xFF),
                      to_f32((w >> 16) & 0xFF), to_f32(w >> 24))
            for g in range(-1, G):
                d = s - g
                if not 0 <= d < D:
                    continue
                for j, (xi, xq) in ((2 * c, planes[:2]),
                                    (2 * c + 1, planes[2:])):
                    t = taps[d][j]
                    if t == 0.0:
                        continue
                    if acc_i[g + 1] is None:
                        acc_i[g + 1], acc_q[g + 1] = xi * t, xq * t
                    else:
                        acc_i[g + 1] = acc_i[g + 1] + xi * t
                        acc_q[g + 1] = acc_q[g + 1] + xq * t
    first = (m0 + G * p) == 0
    for g in range(G):
        ci, cq = acc_i[g + 1], acc_q[g + 1]
        pi, pq = acc_i[g], acc_q[g]
        if g == 0:
            pi = jnp.where(first, liq_ref[0], pi)
            pq = jnp.where(first, liq_ref[1], pq)
        y = fast_atan2(cq * pi - ci * pq, ci * pi + cq * pq)
        o_ref[m0 + g + G * p] = y


@functools.partial(jax.jit, static_argnames=(
    "taps_key", "factor", "num", "byte_off", "interpret", "phases", "rows",
    "num_warps"))
def _call(raw, last_iq, *, taps_key, factor, num, byte_off, interpret,
          phases, rows, num_warps):
    taps = _plan(np.frombuffer(taps_key, np.float32), factor, byte_off)
    row_b = 2 * factor
    n = raw.shape[-1]
    if n % row_b:
        raw = jnp.pad(raw, [(0, 0)] * (raw.ndim - 1)
                      + [(0, row_b - n % row_b)], constant_values=128)
    nrows = raw.shape[-1] // row_b
    lead = raw.shape[:-1]
    # little-endian u32 words: (I, Q, I, Q) bytes of two samples each
    words = jax.lax.bitcast_convert_type(
        raw.reshape((-1, nrows * factor // 2, 4)), jnp.uint32)
    tile = phases * rows
    grid = pl.cdiv(num, tile)
    call = pl.pallas_call(
        functools.partial(_kernel, taps=taps, factor=factor, G=phases,
                          R=rows, nrows=nrows),
        # whole tiles: every store is in bounds, the tail is sliced off
        out_shape=jax.ShapeDtypeStruct((grid * tile,), jnp.float32),
        grid=(grid,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="u8_front_demod",
    )
    liq = jnp.asarray(last_iq, jnp.float32).reshape(-1, 2)
    y = jax.vmap(call)(words, liq)
    return y[:, :num].reshape(lead + (num,))


def u8_front_demod(taps, factor: int, raw, last_iq=None, num: int = None,
                   *, byte_off: int = 0, interpret: bool = False):
    """Fused u8-IQ convert + decimate + FM demod.

    ``raw [..., 2n] u8`` interleaved IQ, ``last_iq [..., 2] f32`` (the
    sample before output 0; zeros on warmup) -> ``[..., num] f32``:
    ``atan2-poly(x[m] * conj(x[m-1]))`` over the decimated stream
    ``x[m] = sum_k taps[k] * (raw[2(m*f + k) + byte_off + c] - 128)/128``.

    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU
    tests); the compiled kernel runs only on an NVIDIA GPU.
    """
    taps = np.asarray(taps, dtype=np.float32)
    f = int(factor)
    n = (raw.shape[-1] - byte_off) // 2
    if num is None:
        num = (n - taps.shape[0]) // f + 1
    if last_iq is None:
        last_iq = jnp.zeros(raw.shape[:-1] + (2,), jnp.float32)
    if f % 2:
        raise ValueError(f"factor {f} must be even (two IQ samples per "
                         "32-bit word)")
    if PHASES & (PHASES - 1) or ROWS & (ROWS - 1):
        raise ValueError("PHASES and ROWS must be powers of two")
    return _call(raw, last_iq, taps_key=taps.tobytes(), factor=f,
                 num=int(num), byte_off=int(byte_off),
                 interpret=bool(interpret), phases=PHASES, rows=ROWS,
                 num_warps=NUM_WARPS)
