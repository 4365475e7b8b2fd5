"""Stream-operator wrappers over the pure DSP ops.

Each class pairs an op from :mod:`sdr_tpu.ops` with its carry management,
replacing the reference's stateful pipes:

  =====================  ==========================================
  this module            reference
  =====================  ==========================================
  ``IqConvertU8``        P.map interleavedIQUnsignedByteToFloat*
  ``IqConvertI16``       P.map interleavedIQSignedWordToFloat*
  ``Fir`` (I=D=1)        firFilter       (Filter.hs:530-569)
  ``Fir`` (I=1)          firDecimator    (Filter.hs:572-611)
  ``Fir`` (general)      firResampler    (Filter.hs:677-727)
  ``FmDemod``            fmDemod         (Demod.hs:39-46)
  ``AmDemod``            — (airband config: magnitude)
  ``Agc``                agcPipe         (Util.hs:343-348)
  ``DcBlocker``          dcBlockingFilter (Filter.hs:729-739)
  ``Scale``              P.map (VG.map (* k))
  ``Mix``                P.map (zipWith mult shifter)
  ``Map``                P.map
  ``FftStream``          fftw / fftwParallel (FFT.hs)
  =====================  ==========================================
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from sdr_tpu.ops import convert, demod, design, fftops, fir, scans, shift
from sdr_tpu.ops import channelize as chanz
from sdr_tpu.stream.block import StreamOp

__all__ = [
    "IqConvertU8", "IqConvertI16", "U8FrontEnd", "U8FrontDemod", "Fir",
    "FmDemod",
    "AmDemod", "Agc",
    "DcBlocker", "Scale", "Mix", "Map", "FftStream", "Channelize",
    "FmMod", "Iir", "StereoDecode",
]


class IqConvertU8(StreamOp):
    """Interleaved u8 I/Q -> complex64 (RTL-SDR front end).

    ``planar=True`` emits the planar-complex layout instead: f32 with a
    [2] component axis prepended to the block axis (real plane first).
    Downstream real-tap FIR stages are representation-agnostic (the plane
    axis batches), so a planar chain runs with zero complex<->planar
    relayouts; pair with ``FmDemod(planar=True)``.
    """

    def __init__(self, planar: bool = False):
        self.planar = planar
        self.extra_block_dims = 1 if planar else 0

    def out_len(self, n_in):
        if n_in % 2:
            raise ValueError("interleaved IQ needs even block")
        return n_in // 2

    def out_dtype(self, in_dtype):
        return jnp.float32 if self.planar else jnp.complex64

    def map_batch_shape(self, batch_shape):
        return batch_shape + (2,) if self.planar else batch_shape

    def apply(self, carry, x):
        fn = convert.iq_u8_to_planar if self.planar \
            else convert.iq_u8_to_cfloat
        return carry, fn(x)


class IqConvertI16(StreamOp):
    """Interleaved i16 I/Q -> complex64 (BladeRF front end).

    ``planar=True`` as in :class:`IqConvertU8`.
    """

    def __init__(self, planar: bool = False):
        self.planar = planar
        self.extra_block_dims = 1 if planar else 0

    def out_len(self, n_in):
        if n_in % 2:
            raise ValueError("interleaved IQ needs even block")
        return n_in // 2

    def out_dtype(self, in_dtype):
        return jnp.float32 if self.planar else jnp.complex64

    def map_batch_shape(self, batch_shape):
        return batch_shape + (2,) if self.planar else batch_shape

    def apply(self, carry, x):
        fn = convert.iq_i16_to_planar if self.planar \
            else convert.iq_i16_to_cfloat
        return carry, fn(x)


class U8FrontEnd(StreamOp):
    """Fused u8-IQ convert + decimating FIR as integer matmuls
    (ops/quantized.py) — the receive chain's front half as one u8 x s8
    dot with exact s32 accumulation.

    Input: interleaved u8 IQ ``[..., 2n]``; output: decimated planar
    f32 ``[..., 2, n/factor]``.  Replaces the
    ``IqConvertU8(planar=True) -> Fir.decimator(taps, factor)`` pair with
    identical semantics to ~2e-4 (16-bit tap quantization; the reference's
    differential bound is 0.01).  Carry: trailing ``2*(K - factor)`` raw
    bytes (overlap-save, in wire format).
    """

    def __init__(self, taps, factor: int, precision: str = "s16",
                 q_out: int | None = None):
        self.taps = np.asarray(taps, dtype=np.float32)
        self.factor = int(factor)
        self.n_taps = self.taps.shape[0]
        self.precision = precision
        # None = the band geometry's default (ops/quantized.py Q_DEFAULT)
        self.q_out = None if q_out is None else int(q_out)
        self.extra_block_dims = 1          # the [2] plane axis

    def out_len(self, n_in):
        if n_in % 2:
            raise ValueError("interleaved IQ needs even block")
        n = n_in // 2
        if n % self.factor:
            raise ValueError(
                f"complex block {n} not divisible by factor {self.factor}")
        return n // self.factor

    def out_dtype(self, in_dtype):
        return jnp.float32

    def map_batch_shape(self, batch_shape):
        return batch_shape + (2,)

    def _hist_bytes(self, n_in):
        return 2 * max(0, self.n_taps - self.factor)

    def init_carry(self, n_in, in_dtype, batch_shape=()):
        # batch_shape is input-side (no plane axis yet).  History is raw
        # bytes; the stream's zero SAMPLE is the byte 0x80 ((x-128)/128),
        # so warmup history must be 0x80-filled, not zero-filled.
        return jnp.full(batch_shape + (self._hist_bytes(n_in),), 0x80,
                        dtype=jnp.uint8)

    def apply(self, carry, x):
        from sdr_tpu.ops.quantized import fir_decimate_u8_planar
        n_out = self.out_len(x.shape[-1])
        H = carry.shape[-1]
        f2 = 2 * self.factor
        # Seam split: concat(carry, x) would copy the whole block — an
        # extra read+write HBM pass costing ~20-30% of the front end
        # itself.  Only the first ceil(H/2f) outputs read carry bytes;
        # compute those from a tiny seam array and the rest straight
        # from (a view of) x.  Bit-identical to the concat form: every
        # output is an independent integer dot product.
        mb = -(-H // f2) if H else 0
        seam_x = (mb - 1) * f2 + 2 * self.n_taps - H if mb else 0
        if H and 0 < seam_x <= x.shape[-1] and mb < n_out:
            xb = jnp.concatenate([carry, x[..., :seam_x]], axis=-1)
            yb = fir_decimate_u8_planar(self.taps, self.factor, xb, mb,
                                        precision=self.precision,
                                        q_out=self.q_out)
            # main outputs from the WHOLE block: the sub-step seam offset
            # is absorbed into the plan (byte_off), so the dot operand is
            # x itself — never a sliced/padded copy
            ym = fir_decimate_u8_planar(self.taps, self.factor, x,
                                        n_out - mb,
                                        precision=self.precision,
                                        byte_off=mb * f2 - H,
                                        q_out=self.q_out)
            return x[..., x.shape[-1] - H:], jnp.concatenate([yb, ym], -1)
        xext = jnp.concatenate([carry, x], axis=-1)
        y = fir_decimate_u8_planar(self.taps, self.factor, xext, n_out,
                                   precision=self.precision,
                                   q_out=self.q_out)
        new = xext[..., xext.shape[-1] - H:] if H else carry
        return new, y

    def shard_carry(self, x, axis_name, initial=None):
        from sdr_tpu.parallel.halo import left_halo, substitute_first
        h = left_halo(x, self._hist_bytes(x.shape[-1]), axis_name,
                      fill=0x80)
        return substitute_first(h, initial, axis_name)


class U8FrontDemod(StreamOp):
    """Fully fused receive front: u8 IQ -> convert -> decimate -> FM
    demod (reference convert.c + decimate.c + Demod.hs:20-28), f32 taps.

    On the GPU one Pallas kernel (Triton route, kernels/
    u8_front_demod_triton.py) does all three: the decimated I/Q planes
    stay in registers and the only write is the demod output.  On the
    CPU the same samples come from the plain XLA stages
    (``iq_u8_to_planar`` -> ``fir_decimate`` -> ``fm_demod_planar`` with
    the polynomial atan2).  ``interpret=True`` runs the kernel in the
    Pallas interpreter instead (tests).

    Carry: (trailing ``2*(K - f)`` raw bytes, last decimated (I, Q)
    sample).  Both are derivable from raw bytes, so the time-shard halo
    is a single ``2K``-byte ``ppermute``.
    """

    def __init__(self, taps, factor: int, interpret: bool = False):
        self.taps = np.asarray(taps, dtype=np.float32)
        self.factor = int(factor)
        self.n_taps = self.taps.shape[0]
        self.interpret = bool(interpret)

    out_dtype = U8FrontEnd.out_dtype
    out_len = U8FrontEnd.out_len

    def map_batch_shape(self, batch_shape):
        return batch_shape

    def _hist_bytes(self, n_in=None):
        return 2 * max(0, self.n_taps - self.factor)

    def init_carry(self, n_in, in_dtype, batch_shape=()):
        return (jnp.full(batch_shape + (self._hist_bytes(),), 0x80,
                         dtype=jnp.uint8),
                jnp.zeros(batch_shape + (2,), jnp.float32))

    def _decimate(self, raw, num):
        """Decimated planar I/Q ``[..., 2, num]`` of raw u8 bytes (XLA)."""
        return fir.fir_decimate(self.taps, self.factor,
                                convert.iq_u8_to_planar(raw), num)

    def apply(self, carry, x):
        from sdr_tpu.utils.device import device_family
        hist, liq = carry
        n_out = self.out_len(x.shape[-1])
        H = hist.shape[-1]
        f2 = 2 * self.factor
        mb = -(-H // f2) if H else 0
        seam_x = (mb - 1) * f2 + 2 * self.n_taps - H if mb else 0
        kernel = self.interpret or device_family() == "gpu"
        if not (kernel and H and 0 < seam_x <= x.shape[-1] and mb < n_out):
            xext = jnp.concatenate([hist, x], axis=-1)
            y, last = demod.fm_demod_planar(self._decimate(xext, n_out), liq,
                                            atan2="poly")
            return (xext[..., xext.shape[-1] - H:], last), y
        from sdr_tpu.kernels.u8_front_demod_triton import u8_front_demod
        # seam split: the mb outputs that read carried bytes come from a
        # tiny carry+head array; the kernel reads the WHOLE block (the
        # sub-step offset becomes leading zero taps) seeded with the
        # boundary's final (I, Q) sample — no copy of the block
        xb = jnp.concatenate([hist, x[..., :seam_x]], axis=-1)
        yb, last_b = demod.fm_demod_planar(self._decimate(xb, mb), liq,
                                           atan2="poly")
        ym = u8_front_demod(self.taps, self.factor, x, last_b, n_out - mb,
                            byte_off=mb * f2 - H, interpret=self.interpret)
        # next-block carry: the final decimated sample, recomputed from
        # the final 2K raw bytes
        liq_new = self._decimate(x[..., x.shape[-1] - 2 * self.n_taps:],
                                 1)[..., 0]
        return ((x[..., x.shape[-1] - H:], liq_new),
                jnp.concatenate([yb, ym], -1))

    def shard_carry(self, x, axis_name, initial=None):
        from sdr_tpu.parallel.halo import left_halo, substitute_first
        halo = left_halo(x, 2 * self.n_taps, axis_name, fill=0x80)
        hist = halo[..., halo.shape[-1] - self._hist_bytes():]
        liq = self._decimate(halo, 1)[..., 0]
        return substitute_first((hist, liq), initial, axis_name)


class Fir(StreamOp):
    """Streaming FIR filter / decimator / rational resampler.

    Overlap-save around the offline kernels: the carry holds the last
    ``hist`` input samples; ``apply`` runs the closed-form kernel on
    ``concat(hist, x)``.  Because the per-block output count is pinned to
    ``n_in * I / D`` (``n_in`` must make that integral), the resampler's
    coefficient phase is *block-invariant* — the phase that the reference
    threads through its existential ``dat`` carry (Filter.hs:137-144)
    reduces to a compile-time constant here (see the t_m = m*D - o0 closed
    form in ops/fir.py).

    ``method`` selects the execution path ('auto'/'direct'/'conv', and
    'band_xla' for rational resamplers) — the analog of the reference's fastFilterC/SSE/AVX
    constructor families (Filter.hs:177-502), except selection is explicit
    rather than CPUID-driven.
    """

    def __init__(self, spec: fir.FirSpec, offset: int = 0,
                 method: str = "auto"):
        self.spec = spec
        self.offset = int(offset)
        self.method = method

    @classmethod
    def filter(cls, taps, symmetric: bool = False, method: str = "auto"):
        return cls(fir.FirSpec(taps, symmetric=symmetric), method=method)

    @classmethod
    def decimator(cls, taps, factor: int, symmetric: bool = False,
                  method: str = "auto"):
        return cls(fir.FirSpec(taps, decimation=factor, symmetric=symmetric),
                   method=method)

    @classmethod
    def resampler(cls, taps, interpolation: int, decimation: int,
                  offset: int = 0, method: str = "auto"):
        return cls(fir.FirSpec(taps, interpolation, decimation),
                   offset=offset, method=method)

    # -- static planning ---------------------------------------------------

    def _check(self, n_in):
        I, D = self.spec.interpolation, self.spec.decimation
        if (n_in * I) % D:
            raise ValueError(
                f"block {n_in} incompatible with rate {I}/{D}: "
                f"n_in*I must be divisible by D")
        return n_in * I // D

    def hist_len(self, n_in: int) -> int:
        """History (overlap-save halo) length: the static bound on how far
        the last output of a block reads behind the block start."""
        n_out = self._check(n_in)
        I, D, K = (self.spec.interpolation, self.spec.decimation,
                   self.spec.n_taps)
        if I == 1:
            return max(0, K - D)
        m = np.arange(n_out, dtype=np.int64)
        t = m * D - self.offset
        o = (-t) % I
        i = (t + o) // I
        ktaps = -(-(K - o) // I)  # taps actually read per phase
        max_read = int((i + ktaps - 1).max())
        return max(0, max_read - n_in + 1)

    def out_len(self, n_in):
        return self._check(n_in)

    def init_carry(self, n_in, in_dtype, batch_shape=()):
        H = self.hist_len(n_in)
        return jnp.zeros(batch_shape + (H,), dtype=in_dtype)

    def _seam_plan(self, H: int, n_in: int, n_out: int):
        """(mb, seam_x, main_offset, main_start) for the seam split, or
        None when the split doesn't apply (no history, everything reads
        history, or taps longer than the block).

        ``mb`` outputs read history bytes; they are computed from a tiny
        ``concat(hist, x[:seam_x])`` buffer.  The remaining outputs read
        only ``x`` starting at ``main_start`` with phase ``main_offset``
        — derived by rebasing the closed form t_m = m*D - offset at
        m = mb (the affine phase recurrence makes the rebase exact).
        """
        if H == 0:
            return None
        I, D, K = (self.spec.interpolation, self.spec.decimation,
                   self.spec.n_taps)
        if I == 1:
            mb = -(-H // D)
            seam_x = (mb - 1) * D + K - H
            main_offset, rebase = 0, mb * D - H
        else:
            # closed-form positions of the first few outputs (only those
            # can read history: i_m grows ~D/I per output)
            bound = min(n_out, int((H * I + self.offset) // D) + 2)
            m = np.arange(bound + 1, dtype=np.int64)
            t = m * D - self.offset
            o = (-t) % I
            i = (t + o) // I
            mb = int(np.searchsorted(i, H))
            if mb == 0:
                return None
            ktaps = -(-(K - o[:mb]) // I)
            seam_x = int((i[:mb] + ktaps - 1).max()) - H + 1
            t0 = mb * D - self.offset
            a, b = divmod(t0, I)
            main_offset = (I - b) % I
            rebase = a + (1 if b else 0) - H
        if (not (0 < seam_x <= n_in) or mb >= n_out or rebase < 0
                or H > n_in):
            return None
        return mb, seam_x, main_offset, rebase

    def _run(self, x, n_out: int, offset: int, start: int = 0):
        I, D = self.spec.interpolation, self.spec.decimation
        if I == 1 and D == 1:
            return fir.fir_filter(self.spec.taps, x, n_out,
                                  method=self.method, start=start)
        if I == 1:
            return fir.fir_decimate(self.spec.taps, D, x, n_out,
                                    method=self.method, start=start)
        y, _ = fir.fir_resample(self.spec.taps, I, D, x, offset, n_out,
                                method=self.method, start=start)
        return y

    def apply(self, carry, x):
        n_in = x.shape[-1]
        n_out = self._check(n_in)
        H = carry.shape[-1]
        plan = self._seam_plan(H, n_in, n_out)
        if plan is not None:
            # Seam split: concat(hist, block) would copy the WHOLE block
            # through HBM every step (the dominant cost of the cheap
            # back-half stages).  Only the first mb outputs read history;
            # compute them from a tiny seam buffer and the rest straight
            # from x with the origin folded into the kernel (zero-copy).
            mb, seam_x, main_offset, main_start = plan
            seam = jnp.concatenate([carry, x[..., :seam_x]], axis=-1)
            yb = self._run(seam, mb, self.offset)
            ym = self._run(x, n_out - mb, main_offset, start=main_start)
            new_hist = x[..., n_in - H:]
            return new_hist, jnp.concatenate([yb, ym], axis=-1)
        xext = jnp.concatenate([carry, x], axis=-1)
        y = self._run(xext, n_out, self.offset)
        new_hist = xext[..., xext.shape[-1] - H:] if H else carry
        return new_hist, y

    def shard_carry(self, x, axis_name, initial=None):
        from sdr_tpu.parallel.halo import left_halo, substitute_first
        h = left_halo(x, self.hist_len(x.shape[-1]), axis_name)
        return substitute_first(h, initial, axis_name)


class FmDemod(StreamOp):
    """FM demodulation with last-sample carry (Demod.hs:39-46).

    ``planar=True``: input is planar-complex ``[..., 2, n]`` f32 (from
    ``IqConvertU8(planar=True)``); the carry is the previous block's final
    (re, im) pair and the plane axis is consumed.

    ``atan2='poly'`` (planar only): polynomial atan2 (ops.demod.fast_atan2,
    5.8e-7 rad max error) instead of jnp.arctan2: plain multiply-adds.
    """

    def __init__(self, planar: bool = False, atan2: str = "exact"):
        self.planar = planar
        self.atan2 = atan2
        self.extra_block_dims = -1 if planar else 0   # consumes [2] plane

    def out_dtype(self, in_dtype):
        return jnp.float32

    def map_batch_shape(self, batch_shape):
        return batch_shape[:-1] if self.planar else batch_shape

    def init_carry(self, n_in, in_dtype, batch_shape=()):
        # planar: batch_shape ends with the [2] plane axis, which is
        # exactly the (re, im) carry shape needed
        return jnp.zeros(batch_shape, dtype=in_dtype)

    def apply(self, carry, x):
        if self.planar:
            y, last = demod.fm_demod_planar(x, carry, atan2=self.atan2)
        else:
            y, last = demod.fm_demod(x, carry)
        return last, y

    def shard_carry(self, x, axis_name, initial=None):
        from sdr_tpu.parallel.halo import left_halo, substitute_first
        h = left_halo(x, 1, axis_name)[..., 0]
        return substitute_first(h, initial, axis_name)


class StereoDecode(StreamOp):
    """Broadcast-FM stereo multiplex decoder (beyond the reference —
    its example receiver is mono, examples/fm/fm.hs).

    Input: the demodulated composite ``[..., n]`` f32 at ``fs`` (the FM
    chain's post-decimation rate, 160 kS/s by default), containing
    mono (L+R) 0-15 kHz, the 19 kHz pilot, and (L-R) DSB on a 38 kHz
    subcarrier.  Output: ``[..., 2, n]`` — L and R planes at the same
    rate, which the existing ``Fir.resampler``/``Fir.filter`` audio
    stages batch over unchanged.

    Open-loop carrier recovery (no PLL, so the op stays a pure block
    transform): bandpass the pilot, SQUARE it (cos²θ = (1+cos 2θ)/2),
    bandpass at 38 kHz, and normalize by a 65-tap moving average of the
    squared pilot — every step is a centered odd-length FIR or an
    elementwise op, so blockwise output equals the one-shot run exactly
    and time sharding needs only a 192-sample halo (same invariant as
    ``Fir``).  Outputs lag the composite by 96 samples (0.6 ms at the
    default rate): the group delay of the pilot->carrier->difference
    filter cascade.

    ``separation_gain=2`` matches the standard multiplex scaling
    (half-amplitude subcarrier): L = mono + 2*diff, R = mono - 2*diff.

    **Pilot lock** (``pilot_lock=True``, default): an explicit
    lock/unlock decision gates the difference channel — the classic
    failure mode of open-loop stereo decoding is a confident-looking
    stereo image synthesized from noise when no pilot exists.  Per
    block, the normalized pilot power ``r = mean(bp19(x)^2) /
    mean(x^2)`` is compared against a hysteresis pair: ``r > lock_hi``
    locks (stereo), ``r < lock_lo`` unlocks (mono: the difference
    channel is zeroed so L == R), in between the previous block's state
    holds.  A locked broadcast composite has ``r`` ≈ 0.03-1 (pilot is
    ~10% deviation; the upper end is silence), a pilot-free signal ≈ 0,
    so the defaults (0.02 / 0.005) sit an order of magnitude from both.
    The lock recurrence is block-rate and *exactly* time-shardable: each
    shard's decision is an affine map on the entering lock state
    (decisive -> constant, hysteresis-hold -> identity), composed across
    shards by :func:`~sdr_tpu.parallel.halo.exclusive_affine_prefix` —
    sharded output equals the sequential streamed run bit-for-bit.
    (Decisions are made per block, so a *marginal* signal holding ``r``
    inside the hysteresis band can decode differently under different
    block sizes; decisive signals — the operating regime — cannot.)
    The soft Wiener normalization below still conditions the recovered
    carrier while locked.
    """

    H = 192                     # carry: trailing composite samples
    K = 65                      # all internal FIRs (odd -> integer delay)
    extra_block_dims = 1        # the [2] L/R plane axis (time stays -1)

    def __init__(self, fs: float = 160_000.0, separation_gain: float = 2.0,
                 pilot_floor: float = 1e-4, pilot_lock: bool = True,
                 lock_hi: float = 0.02, lock_lo: float = 0.005):
        ny = fs / 2
        if ny <= 53_000:
            # the DSB upper edge is 53 kHz and the hardcoded band-edge
            # table below reaches 52 kHz — rates at or under 106 kS/s
            # cannot carry (or cleanly design for) the multiplex
            raise ValueError(f"composite rate {fs:.0f} too low for the "
                             "stereo multiplex (needs > 106 kS/s)")
        K = self.K
        # transition widths are sized to what K=65 taps can actually
        # deliver (~4/K of Nyquist): the pilot bandpass only needs to
        # separate 19 kHz from mono (<=15 kHz) and DSB (>=23 kHz); the
        # 38 kHz bandpass only needs to kill the squared pilot's DC term
        try:
            self.bp19 = design.remez(
                K, [0, 15_300, 18_300, 19_700, 22_700, ny], [0, 1, 0],
                fs=fs)
            self.bp38 = design.remez(
                K, [0, 24_000, 34_000, 42_000, 52_000, ny], [0, 1, 0],
                fs=fs)
            self.lp15 = design.remez(K, [0, 15_000, 19_000, ny], [1, 0],
                                     fs=fs)
        except ImportError:  # scipy unavailable: windowed-sinc fallback
            ws, h = design.windowed_sinc, design.hamming
            self.bp19 = ws(K, 21_000 / ny, h) - ws(K, 17_000 / ny, h)
            self.bp38 = ws(K, 46_000 / ny, h) - ws(K, 30_000 / ny, h)
            self.lp15 = ws(K, 15_000 / ny, h)
        self.avg = np.full(K, 1.0 / K, dtype=np.float32)
        self.gain = float(separation_gain)
        self.pilot_floor = float(pilot_floor)
        self.pilot_lock = bool(pilot_lock)
        if not (0.0 <= lock_lo < lock_hi):
            raise ValueError("need 0 <= lock_lo < lock_hi")
        self.lock_hi, self.lock_lo = float(lock_hi), float(lock_lo)

    def out_len(self, n_in):
        return n_in

    def out_dtype(self, in_dtype):
        return jnp.float32

    def map_batch_shape(self, batch_shape):
        return batch_shape + (2,)

    def init_carry(self, n_in, in_dtype, batch_shape=()):
        return (jnp.zeros(batch_shape + (self.H,), dtype=jnp.float32),
                jnp.zeros(batch_shape, dtype=jnp.float32))  # lock state

    def _lock_metric(self, xe, sq):
        """Normalized pilot power of the (extended) block — the lock
        decision input, computed identically in apply and shard_carry."""
        return (jnp.mean(sq, axis=-1)
                / (jnp.mean(xe * xe, axis=-1) + 1e-12))

    def apply(self, carry, x):
        hist, lock = carry
        n = x.shape[-1]
        xe = jnp.concatenate([hist, x], axis=-1)         # [.., H + n]
        nt = xe.shape[-1]
        d = (self.K - 1) // 2                            # 32
        # centered-FIR index algebra: fir_filter output m is centered at
        # input position m + d; each cascade stage shifts the center
        pilot = fir.fir_filter(self.bp19, xe, nt - 2 * d)     # center +32
        sq = pilot * pilot                               # A^2/2 (1+cos2θ)
        car = fir.fir_filter(self.bp38, sq, nt - 4 * d)       # center +64
        norm = fir.fir_filter(self.avg, sq, nt - 4 * d)       # center +64
        # Wiener-style soft normalization: ~car/norm when the pilot power
        # is well above ``pilot_floor``, rolling smoothly to ZERO as it
        # vanishes — a hard division would amplify noise into full-scale
        # garbage on pilot-free (mono) signals.  The explicit pilot-lock
        # decision below handles the on/off question; this conditions the
        # recovered carrier while locked.
        eps2 = self.pilot_floor ** 2
        car = car * norm / (norm * norm + eps2)
        prod = xe[..., 2 * d: 2 * d + nt - 4 * d] * car  # aligned +64
        diff = fir.fir_filter(self.lp15, prod, nt - 6 * d)    # center +96
        # mono: compute exactly the n emitted outputs (centers
        # [H-96, H+n-96)) via the zero-copy start origin
        m = fir.fir_filter(self.lp15, xe, n, start=self.H - 4 * d)
        if self.pilot_lock:
            r = self._lock_metric(xe, sq)
            new_lock = jnp.where(
                r > self.lock_hi, jnp.ones_like(lock),
                jnp.where(r < self.lock_lo, jnp.zeros_like(lock), lock))
            gate = new_lock[..., None]
        else:
            new_lock, gate = lock, 1.0
        s = diff[..., :n] * self.gain * gate
        y = jnp.stack([m + s, m - s], axis=-2)
        return (xe[..., nt - self.H:], new_lock), y

    def shard_carry(self, x, axis_name, initial=None):
        from sdr_tpu.parallel.halo import (left_halo, substitute_first,
                                           exclusive_affine_prefix)
        h = left_halo(x, self.H, axis_name)
        if initial is not None:
            h = substitute_first(h, initial[0], axis_name)
        lock0 = jnp.zeros(x.shape[:-1], jnp.float32)
        if initial is not None:
            lock0 = jnp.broadcast_to(
                jnp.asarray(initial[1], jnp.float32), lock0.shape)
        if not self.pilot_lock:
            return (h, lock0)
        # the EXACT entering lock state: each shard's block decision is
        # an affine map on the lock (decisive -> constant, hold ->
        # identity), composed by the scalar affine prefix.  r is computed
        # from the same extended buffer apply will see, so apply's
        # recomputed decision reproduces the sequential stream exactly.
        xe = jnp.concatenate([h, jnp.asarray(x, jnp.float32)], axis=-1)
        d = (self.K - 1) // 2
        pilot = fir.fir_filter(self.bp19, xe, xe.shape[-1] - 2 * d)
        r = self._lock_metric(xe, pilot * pilot)
        decisive = (r > self.lock_hi) | (r < self.lock_lo)
        a = jnp.where(decisive, 0.0, 1.0)
        b = jnp.where(r > self.lock_hi, 1.0, 0.0)
        A, B = exclusive_affine_prefix(a, b, axis_name)
        return (h, A * lock0 + B)


class FmMod(StreamOp):
    """FM modulator with phase carry (transmit side; ops.demod.fm_mod)."""

    def __init__(self, sensitivity: float, amplitude: float = 1.0):
        self.sensitivity = sensitivity
        self.amplitude = amplitude

    def out_dtype(self, in_dtype):
        return jnp.complex64

    def init_carry(self, n_in, in_dtype, batch_shape=()):
        return jnp.zeros(batch_shape, dtype=jnp.float32)

    def apply(self, carry, x):
        y, phase = demod.fm_mod(x, self.sensitivity, carry, self.amplitude)
        return phase, y


class Iir(StreamOp):
    """Streaming cascaded-biquad IIR (ops/iir.py) with exact cross-block
    state: each section carries its last two inputs and outputs.

    Time-shardable EXACTLY: each section is an order-2 linear recurrence,
    so a shard's block reduces to one affine map on the state vector
    ``(y[-1], y[-2])`` — ``s -> C^n s + v`` with ``C`` the (constant)
    companion matrix and ``v`` the zero-entering-state final state — and
    an exclusive prefix composition across shards
    (:func:`~sdr_tpu.parallel.halo.exclusive_matrix_affine_prefix`)
    yields the exact recurrence state entering every shard.  Cascaded
    sections resolve left-to-right: section ``s+1``'s input stream is
    section ``s``'s exact local output, available once section ``s``'s
    entering state is known.  Cost: each section's scan runs twice
    (once inside ``shard_carry``, once in ``apply``) — IIR stages are
    tiny next to the FIR/demod stages, and exactness is the contract.

    De-emphasis, notch and equalizer filters for receive chains — the
    generalization of the reference's one hard-coded IIR (dcBlocker,
    c_sources/filter.c:152-161) to arbitrary biquad cascades.
    """

    def __init__(self, sos):
        sos = np.asarray(sos, dtype=np.float32)
        if sos.ndim == 1:
            sos = sos[None, :]
        if sos.shape[-1] != 6:
            raise ValueError("sos must be [S, 6]")
        self.sos = sos / sos[:, 3:4]  # normalize a0

    def init_carry(self, n_in, in_dtype, batch_shape=()):
        S = self.sos.shape[0]
        z = jnp.zeros(batch_shape + (S, 2), dtype=jnp.float32)
        return (z, z)  # (last two inputs, last two outputs) per section

    def apply(self, carry, x):
        from sdr_tpu.ops import iir as iir_ops
        xin, yout = carry
        new_xin, new_yout = [], []
        for s in range(self.sos.shape[0]):
            b, a = self.sos[s, :3], self.sos[s, 3:]
            # drive with the carried two input samples prepended
            xp = jnp.concatenate([xin[..., s, :], x], axis=-1)
            drive = (b[0] * xp[..., 2:] + b[1] * xp[..., 1:-1]
                     + b[2] * xp[..., :-2])
            # carried state vector is (y[-1], y[-2]); yout stores time order
            y = iir_ops.linear_recurrence(
                np.array([-a[1], -a[2]], dtype=np.float32), drive,
                jnp.stack([yout[..., s, 1], yout[..., s, 0]], axis=-1))
            new_xin.append(xp[..., -2:])
            new_yout.append(y[..., -2:])
            x = y
        return ((jnp.stack(new_xin, axis=-2),
                 jnp.stack(new_yout, axis=-2)), x)

    def shard_carry(self, x, axis_name, initial=None):
        """Exact entering state per shard for every section (docstring).

        ``initial = (xin0, yout0)`` (the carry pytree of a previous
        segment) continues the stream exactly: shard 0's entering state
        becomes ``A_prefix @ s0 + b_prefix`` with ``A_prefix`` the
        composed prefix matrix (identity on shard 0 itself).
        """
        from sdr_tpu.ops import iir as iir_ops
        from sdr_tpu.parallel.halo import (
            left_halo, substitute_first, exclusive_matrix_affine_prefix)
        x = jnp.asarray(x, jnp.float32)
        n = x.shape[-1]
        S = self.sos.shape[0]
        xin_list, yout_list = [], []
        for s in range(S):
            b, a = self.sos[s, :3], self.sos[s, 3:]
            coeffs = np.array([-a[1], -a[2]], dtype=np.float32)
            # last two inputs of this section's stream, from the left
            # neighbor (zeros on shard 0 = warmup, like every other halo)
            xin = left_halo(x, 2, axis_name)
            if initial is not None:
                xin = substitute_first(xin, initial[0][..., s, :],
                                       axis_name)
            xp = jnp.concatenate([xin, x], axis=-1)
            drive = (b[0] * xp[..., 2:] + b[1] * xp[..., 1:-1]
                     + b[2] * xp[..., :-2])
            # local affine reduction with zero entering y-state:
            # s_final = C^n @ s_enter + v,  v = zero-state final state
            y_zero = iir_ops.linear_recurrence(coeffs, drive)
            C = np.array([[coeffs[0], coeffs[1]], [1.0, 0.0]],
                         dtype=np.float64)
            Mn = jnp.asarray(np.linalg.matrix_power(C, n)
                             .astype(np.float32))
            v = jnp.stack([y_zero[..., -1], y_zero[..., -2]], axis=-1)
            M = jnp.broadcast_to(Mn, v.shape[:-1] + (2, 2))
            A, enter = exclusive_matrix_affine_prefix(M, v, axis_name)
            if initial is not None:
                # yout0 stores time order (y[-2], y[-1]); state is
                # (y[-1], y[-2])
                s0 = jnp.stack([initial[1][..., s, 1],
                                initial[1][..., s, 0]], axis=-1)
                enter = enter + jnp.einsum("...ij,...j->...i", A,
                                           jnp.asarray(s0, enter.dtype))
            xin_list.append(xin)
            # carry stores time order (y[-2], y[-1])
            yout_list.append(jnp.stack([enter[..., 1], enter[..., 0]],
                                       axis=-1))
            if s + 1 < S:
                # section s's EXACT local output drives section s+1
                x = iir_ops.linear_recurrence(coeffs, drive, enter)
        return (jnp.stack(xin_list, axis=-2),
                jnp.stack(yout_list, axis=-2))


class AmDemod(StreamOp):
    """AM envelope detector (stateless).

    ``planar=True``: input is planar-complex ``[..., 2, n]`` f32; the
    envelope consumes the plane axis (``sqrt(re^2 + im^2)``) — the
    all-real form of the planar AM chain."""

    def __init__(self, planar: bool = False):
        self.planar = planar
        self.extra_block_dims = -1 if planar else 0

    def map_batch_shape(self, batch_shape):
        return batch_shape[:-1] if self.planar else batch_shape

    def out_dtype(self, in_dtype):
        return jnp.float32

    def apply(self, carry, x):
        if self.planar:
            return carry, jnp.sqrt(x[..., 0, :] ** 2 + x[..., 1, :] ** 2)
        return carry, demod.am_demod(x)


class Agc(StreamOp):
    """Automatic gain control with gain carry (Util.hs:343-348).

    ``method='linear'`` (default): the gain recurrence evaluated as a
    first-order linear associative scan — exact under the positive-gain
    premise (``|x*g| = |x|*g``; see ops/scans.py, violated only at loop
    gains ``mu*|x| > 1`` where the true AGC is unstable anyway).  O(log n)
    depth instead of a per-sample ``lax.scan``, and
    time-shardable EXACTLY: each shard reduces its block to one affine
    map ``g -> A*g + B`` (``scans.agc_affine``), composed across shards
    by the same ``exclusive_affine_prefix`` the DC blocker uses.

    ``planar=True`` (linear method only): input is planar-complex
    ``[..., 2, n]`` f32; the gain scan runs on the all-real envelope
    ``sqrt(re^2+im^2)`` and both planes are scaled by it — numerically
    identical to the complex form, but no complex value ever enters the
    associative scan.

    ``method='scan'``: the literal sequential recurrence (the oracle and
    the pathological-regime form).  Not exactly time-shardable — by
    default sharded runners fail fast; ``approx_time_sharding=R`` opts
    into R refinement sweeps, each running the local AGC scan per shard
    and handing every shard's final gain to its right neighbor (one
    ppermute).  Because the recurrence forgets its initial gain
    exponentially (~mu*reference per sample), the entering-gain error
    after one sweep is O(decay^n_block) — far below the 0.01 bound for
    blocks much longer than the AGC time constant
    (tests/test_parallel.py).
    """

    def __init__(self, mu: float, reference: float, initial: float = 1.0,
                 method: str = "linear",
                 approx_time_sharding: int | None = None,
                 planar: bool = False):
        self.mu, self.reference, self.initial = mu, reference, initial
        if method not in ("linear", "scan"):
            raise ValueError(f"unknown agc method {method!r}")
        if planar and method != "linear":
            raise ValueError("Agc(planar=True) supports only the linear "
                             "method (the all-real gain scan)")
        self.method = method
        self.planar = planar
        if approx_time_sharding is not None and approx_time_sharding < 1:
            raise ValueError("approx_time_sharding must be >= 1")
        self.approx_time_sharding = approx_time_sharding
        self.time_shardable = (method == "linear"
                               or approx_time_sharding is not None)

    def init_carry(self, n_in, in_dtype, batch_shape=()):
        # planar: batch_shape ends with the [2] plane axis; the gain is
        # per-STREAM (shared by both planes), so the carry drops it
        if self.planar:
            batch_shape = batch_shape[:-1]
        return jnp.full(batch_shape, self.initial, dtype=jnp.float32)

    @staticmethod
    def _envelope(x):
        """|x| for planar-complex blocks [..., 2, n] — all-real."""
        return jnp.sqrt(x[..., 0, :] ** 2 + x[..., 1, :] ** 2)

    def apply(self, carry, x):
        if self.planar:
            g, final = scans.agc_gains(self._envelope(x), self.mu,
                                       self.reference, carry)
            return final, x * g[..., None, :]
        y, g = scans.agc(x, self.mu, self.reference, carry,
                         method=self.method)
        return g, y

    def shard_carry(self, x, axis_name, initial=None):
        if self.planar:
            from sdr_tpu.parallel.halo import exclusive_affine_prefix
            g0 = jnp.asarray(self.initial if initial is None else initial,
                             jnp.float32)
            g0 = jnp.broadcast_to(g0, x.shape[:-2])
            A, B = scans.agc_affine(self._envelope(x), self.mu,
                                    self.reference)
            Ap, Bp = exclusive_affine_prefix(A, B, axis_name)
            return Ap * g0 + Bp
        g0 = jnp.asarray(self.initial if initial is None else initial,
                         jnp.float32)
        g0 = jnp.broadcast_to(g0, x.shape[:-1])
        if self.method == "linear":
            from sdr_tpu.parallel.halo import exclusive_affine_prefix
            A, B = scans.agc_affine(x, self.mu, self.reference)
            Ap, Bp = exclusive_affine_prefix(A, B, axis_name)
            return Ap * g0 + Bp
        if self.approx_time_sharding is None:
            raise NotImplementedError(
                "Agc(method='scan') cannot be time-sharded exactly; use "
                "the default method='linear' (exact under the "
                "positive-gain premise), approx_time_sharding=R for the "
                "documented sweep approximation, or shard channels.")
        from sdr_tpu.parallel.halo import right_shift_scalar
        first = jax.lax.axis_index(axis_name) == 0
        enter = g0
        for _ in range(self.approx_time_sharding):
            _, g_final = scans.agc(x, self.mu, self.reference, enter,
                                   method=self.method)
            shifted = right_shift_scalar(g_final, axis_name)
            enter = jnp.where(first, g0, shifted)
        return enter


class DcBlocker(StreamOp):
    """DC blocking filter with (last_sample, last_output) carry
    (Filter.hs:729-739)."""

    def __init__(self, alpha: float = 0.997):
        self.alpha = alpha

    def init_carry(self, n_in, in_dtype, batch_shape=()):
        z = jnp.zeros(batch_shape, dtype=jnp.float32)
        return (z, z)

    def apply(self, carry, x):
        y, new = scans.dc_blocker(x, carry[0], carry[1], self.alpha)
        return new, y

    def shard_carry(self, x, axis_name, initial=None):
        """Exact time-sharding of the linear recurrence.

        The block reduces to one affine map y -> alpha^n * y + B (B = local
        scan of the differenced input from zero state); an exclusive prefix
        composition across shards (tiny all_gather) yields the exact
        recurrence state entering this shard.  See
        parallel/halo.py:exclusive_affine_prefix.

        With ``initial = (last_sample0, last_output0)`` the entering state
        is ``A_prefix * last_output0 + B_prefix`` (segment continuation).
        """
        from sdr_tpu.parallel.halo import (left_halo, substitute_first,
                                           exclusive_affine_prefix)
        last_sample = left_halo(x, 1, axis_name)[..., 0]
        if initial is not None:
            last_sample = substitute_first(last_sample, initial[0],
                                           axis_name)
        n = x.shape[-1]
        # local affine reduction with zero entering state
        y_local, _ = scans.dc_blocker(x, last_sample, 0.0, self.alpha)
        a_blk = jnp.asarray(self.alpha, jnp.float32) ** n
        b_blk = y_local[..., -1]
        A, y_enter = exclusive_affine_prefix(
            jnp.broadcast_to(a_blk, b_blk.shape), b_blk, axis_name)
        if initial is not None:
            y_enter = A * jnp.asarray(initial[1], y_enter.dtype) + y_enter
        return (last_sample, y_enter)


class Scale(StreamOp):
    """y = k * x (scale.c semantics, stateless)."""

    def __init__(self, factor: float):
        self.factor = factor

    def apply(self, carry, x):
        return carry, x * jnp.asarray(self.factor, dtype=jnp.float32)


class Mix(StreamOp):
    """Multiply by a complex local oscillator with phase continuity.

    Carry is the current unit phasor; each block multiplies by the static
    oscillator table and the carried phasor, then renormalizes the carry so
    f32 rounding cannot drift the magnitude over long streams.  Generalizes
    the reference's halfBandUp/quarterBandUp shift vectors (Util.hs:263-285)
    to arbitrary frequencies.

    ``planar=True``: input and output are planar-complex ``[..., 2, n]``
    f32 (the plane axis is batch to every other op); the LO table, the
    phasor carry, and the rotation are all (cos, sin) pairs — complex64
    never exists.  ``am_chain`` uses this form by default.
    """

    def __init__(self, freq: float, planar: bool = False):
        self.freq = float(freq)
        self.planar = planar

    def out_dtype(self, in_dtype):
        return jnp.float32 if self.planar else jnp.complex64

    def init_carry(self, n_in, in_dtype, batch_shape=()):
        if self.planar:
            # batch_shape ends with the [2] plane axis — exactly the
            # (re, im) phasor pair's shape (the FmDemod carry trick)
            z = jnp.zeros(batch_shape, dtype=jnp.float32)
            return z.at[..., 0].set(1.0)
        return jnp.ones(batch_shape, dtype=jnp.complex64)

    @staticmethod
    def _rot(ar, ai, br, bi):
        """(ar+j*ai) * (br+j*bi) as planar pairs."""
        return ar * br - ai * bi, ar * bi + ai * br

    def apply(self, carry, x):
        n = x.shape[-1]
        if self.planar:
            lo = shift.oscillator_planar(n, self.freq)
            cr, ci = carry[..., 0, None], carry[..., 1, None]
            pr_, pi_ = self._rot(lo[0], lo[1], cr, ci)
            yr, yi = self._rot(x[..., 0, :], x[..., 1, :], pr_, pi_)
            y = jnp.stack([yr, yi], axis=-2)
            ang = 2 * np.pi * np.mod(np.float64(self.freq) * n, 1.0)
            nr, ni = self._rot(carry[..., 0], carry[..., 1],
                               jnp.float32(np.cos(ang)),
                               jnp.float32(np.sin(ang)))
            norm = jax.lax.rsqrt(nr * nr + ni * ni)
            return jnp.stack([nr * norm, ni * norm], axis=-1), y
        lo = shift.oscillator(n, self.freq)
        step = jnp.asarray(np.exp(2j * np.pi * self.freq * n),
                           dtype=jnp.complex64)
        y = x * lo * carry[..., None]
        new = carry * step
        new = new / jnp.abs(new)
        return new, y

    def shard_carry(self, x, axis_name, initial=None):
        """LO phase at shard start is closed-form (no communication):
        exp(2*pi*j*freq*(shard_index * n)); times the entering phasor for
        segment continuation.

        The per-shard phase table is precomputed host-side in float64 and
        reduced mod 1 *before* the f32 cast, so phase error stays at f32
        rounding regardless of shard index (a traced f32
        ``frac_per_shard * idx`` accumulates ~1e-7 cycles per shard).
        The table is stored planar (cos, sin) — complex constants never
        cross a program boundary."""
        idx = jax.lax.axis_index(axis_name)
        n_shards = jax.lax.axis_size(axis_name)
        n = x.shape[-1]
        ang = 2.0 * np.pi * np.mod(
            np.float64(self.freq) * np.float64(n)
            * np.arange(n_shards, dtype=np.float64), 1.0)
        tab = jnp.asarray(
            np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32))
        if self.planar:
            # [..., 2] planar phasor; x is [..., 2, n] so the carry's
            # batch dims are x.shape[:-1] with the plane axis LAST
            pr_, pi_ = tab[idx, 0], tab[idx, 1]
            if initial is not None:
                init = jnp.asarray(initial, jnp.float32)
                pr_, pi_ = self._rot(pr_, pi_,
                                     init[..., 0], init[..., 1])
            return jnp.broadcast_to(jnp.stack([pr_, pi_], axis=-1),
                                    x.shape[:-2] + (2,))
        phasor = jax.lax.complex(tab[idx, 0], tab[idx, 1])
        phasor = jnp.broadcast_to(phasor, x.shape[:-1])
        if initial is not None:
            phasor = phasor * jnp.asarray(initial, phasor.dtype)
        return phasor


class Map(StreamOp):
    """Stateless elementwise map (the P.map analog)."""

    def __init__(self, fn: Callable, dtype=None):
        self.fn = fn
        self.dtype = dtype

    def out_dtype(self, in_dtype):
        return self.dtype if self.dtype is not None else in_dtype

    def apply(self, carry, x):
        return carry, self.fn(x)


class FftStream(StreamOp):
    """Windowed overlapping FFT frames: [..., n] -> [..., n/hop, size].

    The batched replacement for fftw/fftwParallel pipes (FFT.hs:44-168):
    all frames of a block are transformed in one batched FFT, which keeps
    the in-order output contract of fftwParallel by construction.  Overlap
    across block boundaries is carried as the trailing ``size - hop``
    samples.
    """

    extra_block_dims = 1
    time_axis_out = -2

    def __init__(self, size: int, hop: Optional[int] = None, window=None,
                 shift: bool = True, magnitude: bool = True,
                 planar: bool = False):
        self.size = size
        self.hop = hop if hop is not None else size
        if self.hop > size:
            raise ValueError("hop must be <= size")
        self.window = (np.asarray(window, dtype=np.float32)
                       if window is not None else design.hanning(size))
        self.shift = shift
        self.magnitude = magnitude
        # planar=True: input is planar-complex [..., 2, n] f32 (from
        # IqConvertU8(planar=True)); the planes join into complex only
        # for the FFT itself and end at |X|, so magnitude=True is
        # required.
        self.planar = planar
        if planar and not magnitude:
            raise ValueError("planar FftStream requires magnitude=True")
        self.extra_block_dims = 1 if not planar else 0

    def out_len(self, n_in):
        if n_in % self.hop:
            raise ValueError("block must be divisible by hop")
        return n_in // self.hop

    def out_dtype(self, in_dtype):
        return jnp.float32 if self.magnitude else jnp.complex64

    def map_batch_shape(self, batch_shape):
        return batch_shape[:-1] if self.planar else batch_shape

    def init_carry(self, n_in, in_dtype, batch_shape=()):
        return jnp.zeros(batch_shape + (self.size - self.hop,),
                         dtype=in_dtype)

    def apply(self, carry, x):
        xext = jnp.concatenate([carry, x], axis=-1)
        frames = fftops.frame(xext, self.size, self.hop, self.window)
        if self.planar:
            F = jnp.fft.fft(jax.lax.complex(frames[..., 0, :, :],
                                            frames[..., 1, :, :]))
            y = jnp.abs(F)
            if self.shift:
                y = jnp.fft.fftshift(y, axes=-1)
        else:
            F = fftops.fft(frames)
            if self.shift:
                F = jnp.fft.fftshift(F, axes=-1)
            y = jnp.abs(F) if self.magnitude else F
        H = self.size - self.hop
        new = xext[..., xext.shape[-1] - H:] if H else carry
        return new, y

    def shard_carry(self, x, axis_name, initial=None):
        from sdr_tpu.parallel.halo import left_halo, substitute_first
        h = left_halo(x, self.size - self.hop, axis_name)
        return substitute_first(h, initial, axis_name)


class Channelize(StreamOp):
    """Streaming polyphase DFT-filterbank: [..., n] wideband complex ->
    [..., C, n/C] channel streams (ops/channelize.py).

    Carry: the trailing (P-1)*C wideband samples so every block emits
    exactly n/C samples per channel with seamless branch-filter history.
    Typically followed by batched per-channel ops (the leading C axis
    broadcasts through every other StreamOp) — the wideband front end of
    the 64-channel FM bank (BASELINE config #5).
    """

    extra_block_dims = 1
    time_axis_out = -1

    def __init__(self, taps, n_channels: int):
        self.n_channels = int(n_channels)
        taps = np.asarray(taps, dtype=np.float32)
        self.taps_per_branch = -(-taps.shape[0] // self.n_channels)
        self.taps = taps

    def out_len(self, n_in):
        if n_in % self.n_channels:
            raise ValueError("block must be divisible by channel count")
        return n_in // self.n_channels

    def out_dtype(self, in_dtype):
        return jnp.complex64

    def map_batch_shape(self, batch_shape):
        # downstream ops see the emitted channel axis as a batch dim
        return batch_shape + (self.n_channels,)

    def init_carry(self, n_in, in_dtype, batch_shape=()):
        H = (self.taps_per_branch - 1) * self.n_channels
        return jnp.zeros(batch_shape + (H,), dtype=in_dtype)

    def apply(self, carry, x):
        xext = jnp.concatenate([carry, x], axis=-1)
        y = chanz.polyphase_channelize(self.taps, self.n_channels, xext,
                                       x.shape[-1] // self.n_channels)
        H = carry.shape[-1]
        new = xext[..., xext.shape[-1] - H:] if H else carry
        return new, y

    def shard_carry(self, x, axis_name, initial=None):
        from sdr_tpu.parallel.halo import left_halo, substitute_first
        h = left_halo(x, (self.taps_per_branch - 1) * self.n_channels,
                      axis_name)
        return substitute_first(h, initial, axis_name)
