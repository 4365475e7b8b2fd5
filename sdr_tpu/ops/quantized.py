"""Quantized front end: fused IQ-convert + decimating FIR as an integer
matmul with exact s32 accumulation.

The receive chain's front half — interleaved u8 IQ -> (x-128)/128 ->
K-tap decimate-by-f — is where all the samples are (every later stage
runs at 1/f rate).  This module runs it as one u8 x s8 dot:

* the interleaved u8 block is viewed as non-overlapping window rows
  ``X[p, s] = raw[p*stride + s]`` (one free reshape); each row's window
  tail past ``stride`` lives at the start of row p+1, so the dot splits
  into a main part over ``X`` and a small halo part whose rows are the
  MAIN VIEW shifted by one row (plus one tiny tail slice) — the
  overlapping window matrix never materializes and no full-input copy
  is ever made (a non-start-aligned slice would be one);
* the u8 samples feed the dot DIRECTLY: with a per-column constant
  ``corr[c] = 128 * sum_w B[w, c]`` (host-side),
  ``X_u8 @ B - corr  ==  (X - 128) @ B`` exactly — no ``x ^ 0x80``
  elementwise pass over the input;
* taps are quantized to 16 bits (max |tap| -> 32512 = 127*256) and split
  into hi/lo s8 bytes side by side, so one dot accumulates both bands in
  s32 and ``acc = 256*hi + lo`` is the exact integer correlation with
  16-bit taps (|sum| <= 51*255*127 + 128*51*127 << 2^31 per band);
* the banded matrix ``B[2f*q + 2k + c, c*Q + q] = T16[k]`` taps the
  interleaved layout directly, so I and Q come out as the two contiguous
  column halves — the planar split is free.

One epilogue multiply recovers float:  y = acc * (max|tap| / 32512 / 128).
Accuracy vs the f32 reference path is ~2e-4 absolute (tap quantization
only), 50x inside the reference's 0.01 differential-test bound
(tests/TestSuite.hs:284-289).

Reference semantics covered: convertC (convert.c:15-20) fused with
decimateRR/RC (decimate.c:16-24); the banded window is the matmul analog
of their SIMD dot products.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["fir_decimate_u8_planar", "u8_front_plan"]

Q_DEFAULT = 64   # band geometry (outputs per window row)


@functools.lru_cache(maxsize=32)
def _plan(taps_bytes: bytes, n_taps: int, factor: int,
          precision: str = "s16", q_out: int = Q_DEFAULT, byte_off: int = 0):
    """Host-side banded-matrix construction (cached per (taps, factor)).

    ``precision='s16'``: taps quantized to 16 bits, band split into hi/lo
    s8 matrices (~2e-4 abs accuracy).  ``'s8'``: taps
    quantized straight to 8 bits, ONE band (half the matmul work,
    ~2e-3 abs — still 5x inside the reference's 0.01 differential bound);
    the lo matrix is returned as None.

    ``q_out``: outputs per window row (band has ``2*q_out`` columns =
    I then Q halves).  The band's dense MAC cost per complex output is
    ``(2*f*q_out + halo) * 2*q_out / q_out = 4*f*q_out + 2*halo`` —
    LINEAR in q_out.

    ``byte_off``: static shift of every window by that many input bytes —
    the band simply gets ``byte_off`` leading zero rows.  This lets a
    streaming caller whose history is not a whole number of output steps
    keep the big buffer UNSLICED (zero-copy) and absorb the sub-step
    offset into the plan.
    """
    taps = np.frombuffer(taps_bytes, dtype=np.float32)
    K, f = n_taps, factor
    # window bytes per tile row
    W = byte_off + (q_out - 1) * 2 * f + 2 * (K - 1) + 2
    stride = q_out * 2 * f                      # row start stride in bytes
    maxabs = float(np.abs(taps).max()) or 1.0
    qmax = 127.0 if precision == "s8" else 32512.0
    Tq = np.round(taps / maxabs * qmax).astype(np.int32)
    scale = maxabs / qmax / 128.0
    B = np.zeros((W, 2 * q_out), dtype=np.int32)
    for q in range(q_out):
        base = byte_off + 2 * f * q
        B[base: base + 2 * K: 2, q] = Tq             # I plane columns
        B[base + 1: base + 2 * K: 2, q_out + q] = Tq  # Q plane columns
    if precision == "s8":
        return W, stride, scale, B.astype(np.int8), None
    # split B = 256*hi + lo with lo in [-128, 127]: floor((B+128)/256)
    # (a round-half-up split; round-half-to-even can yield lo = +128,
    # which wraps in int8)
    Bhi32 = np.floor_divide(B + 128, 256)
    Blo32 = B - 256 * Bhi32
    assert Bhi32.max() <= 127 and Bhi32.min() >= -128
    assert Blo32.max() <= 127 and Blo32.min() >= -128
    return W, stride, scale, Bhi32.astype(np.int8), Blo32.astype(np.int8)


def u8_front_plan(taps, factor: int, precision: str = "s16",
                  q_out: int = Q_DEFAULT, byte_off: int = 0):
    """Expose the static plan (window width, row stride, scale, hi/lo
    banded s8 matrices; lo is None for precision='s8') — used by apply
    and by tests."""
    taps = np.asarray(taps, dtype=np.float32)
    return _plan(taps.tobytes(), taps.shape[0], int(factor), precision,
                 int(q_out), int(byte_off))


def fir_decimate_u8_planar(taps, factor: int, raw, num: int = None, *,
                           precision: str = "s16", byte_off: int = 0,
                           q_out: int | None = None):
    """Interleaved u8 IQ ``[..., 2n]`` -> decimated planar f32
    ``[..., 2, num]`` in one fused step (convert + K-tap decimate-by-f).

    Output sample m is ``sum_k taps[k] * (raw[2(m*f+k)+c] - 128)/128`` for
    component c — identical semantics to ``iq_u8_to_cfloat`` followed by
    ``fir_decimate`` (reference decimate.c:73-82 on convert.c:15-20
    output), computed exactly in int arithmetic with 16-bit-quantized
    taps (``precision='s16'``) or 8-bit-quantized taps (``'s8'``: one
    band instead of hi/lo — half the matmul work, ~2e-3 abs accuracy).

    The input is a free reshape feeding the dot directly, with no
    window matrix and no elementwise offset pass (see the module
    docstring).  ``byte_off`` statically shifts every window by that many
    bytes into ``raw`` (zero-copy streaming seams; see u8_front_plan).
    ``q_out`` picks the band geometry (outputs per window row) — any
    value yields identical samples.
    """
    if q_out is not None and int(q_out) < 1:
        raise ValueError(f"q_out must be >= 1, got {q_out}")
    taps = np.asarray(taps, dtype=np.float32)
    K, f = taps.shape[0], int(factor)
    q_out = int(q_out) if q_out is not None else Q_DEFAULT
    n = (raw.shape[-1] - byte_off) // 2
    if num is None:
        num = (n - K) // f + 1
    num = int(num)
    # the halo (window tail past the row stride) must fit within one row
    # for the shifted-reshape construction; bump q_out for long filters
    while 2 * f * q_out < byte_off + 2 * (K - 1) + 2 - 2 * f:
        q_out *= 2
    # the sub-step offset is absorbed into the band as leading zero rows
    # (u8_front_plan byte_off) — slicing the buffer instead would COPY
    # the whole block every seam-split streaming step
    W, stride, scale, Bhi, Blo = u8_front_plan(taps, f, precision,
                                               q_out=q_out,
                                               byte_off=byte_off)
    P = -(-num // q_out)
    # main view needs P whole rows even when the band is narrower than a
    # row (K < f makes W < stride)
    need = max((P - 1) * stride + W, P * stride)
    if need > raw.shape[-1]:
        raw = jnp.pad(raw, [(0, 0)] * (raw.ndim - 1)
                      + [(0, need - raw.shape[-1])])
    lead = raw.shape[:-1]
    # main rows: a free reshape of the input (never copied — the slice
    # starts at 0, which XLA treats as a view); each row's window tail
    # past ``stride`` is the first hw = W - stride bytes of row p+1, so
    # the halo rows come from the MAIN VIEW shifted by one row plus one
    # tiny tail slice — total copy cost ~hw/stride of the input (reading
    # the halo through ``raw[stride:]``, a non-start-aligned slice, would
    # make XLA materialize a FULL copy of the input).
    main = raw[..., : P * stride].reshape(lead + (P, stride))
    hw = max(0, W - stride)
    # hi|lo bands side by side in ONE dot — the input is read once for
    # both bands; the u8 samples feed the dot directly and the constant
    # column correction applies the -128 offset afterwards (exact):
    #   (X - 128) @ B  ==  X_u8 @ B - 128 * colsum(B)
    B2 = Bhi if Blo is None else np.concatenate([Bhi, Blo], axis=1)
    if B2.shape[0] < stride:                    # K <= f: band inside a row
        B2 = np.pad(B2, [(0, stride - B2.shape[0]), (0, 0)])
    corr = jnp.asarray(128 * B2.sum(axis=0, dtype=np.int64),
                       dtype=jnp.int32)
    cdims = (((main.ndim - 1,), (0,)), ((), ()))
    acc2 = jax.lax.dot_general(main, jnp.asarray(B2[:stride]), cdims,
                               preferred_element_type=jnp.int32) - corr
    if hw > 0:
        tail = raw[..., P * stride: P * stride + hw].reshape(
            lead + (1, hw))
        halo = jnp.concatenate([main[..., 1:, :hw], tail], axis=-2)
        acc2 = acc2 + jax.lax.dot_general(halo, jnp.asarray(B2[stride:]),
                                          cdims,
                                          preferred_element_type=jnp.int32)
    if Blo is None:
        acc = acc2
    else:
        q2 = 2 * q_out
        acc = acc2[..., :q2] * 256 + acc2[..., q2:]
    y = acc.astype(jnp.float32) * jnp.float32(scale)   # [..., P, 2*q_out]
    yi = y[..., :q_out].reshape(lead + (P * q_out,))[..., :num]
    yq = y[..., q_out:].reshape(lead + (P * q_out,))[..., :num]
    return jnp.stack([yi, yq], axis=-2)
