"""Unified FIR / decimation / polyphase-resampling engine.

This is the replacement for the reference's entire kernel layer
(c_sources/filter.c, c_sources/decimate.c, c_sources/resample.c and their
Haskell fallbacks in hs_sources/SDR/FilterInternal.hs).  All three operator
families are instances of ONE formulation — a strided sliding dot product
with a per-output coefficient-phase:

    y[m] = sum_k  T[o_m, k] * x[i_m + k]

where for
  * filter    (filter.c:16   ``filterRR``):   i_m = m,       o_m = 0
  * decimate  (decimate.c:16 ``decimateRR``): i_m = m*D,     o_m = 0
  * resample  (resample.c:16 ``resampleRR``): closed form below.

The reference computes the resampler's input/phase positions with a
sequential recurrence (FilterInternal.hs:252-265):

    (q, r) = divmod(D - o - 1, I);  i += q + 1;  o' = I - 1 - r

We instead use the closed form (derived by introducing t_m = i_m*I - o_m,
which the recurrence advances by exactly D per output):

    t_m = m*D - o_0
    o_m = (-t_m) mod I          (coefficient phase, in [0, I))
    i_m = (t_m + o_m) // I      (= ceil(t_m / I), first input index)
    y[m] = sum_k  taps[o_m + k*I] * x[i_m + k]

Every output's read position and phase is a static function of m, so
blocks compile to static gathers and convolutions (no sequential scan),
and shard-start phases on a device mesh are computable without
serialization.

Execution paths: ``conv`` (XLA's conv_general_dilated, cuDNN on the GPU,
which also fuses with neighboring elementwise ops), ``direct`` (a
gather-einsum for tiny blocks and the CPU), and for rational resamplers
``band_xla`` (a banded matmul over a free reshape of the input).
``method='auto'`` dispatches per device family (utils/tuning.py: conv on
the GPU, a measured rate table on the CPU).  Strided (decimating) reads use a polyphase input split.
Complex samples with real taps (the RC kernel variants, filter.c:74) are
viewed as a [2, N] real batch on the filter/decimate paths, and as the
INTERLEAVED float32 view of the complex64 buffer on the resampler conv
path (``_resample_conv_c``).

Numerical contract: float32 in, float32 accumulate, identical summation
*results* to the reference within its own cross-implementation test bound of
0.01 absolute (tests/TestSuite.hs:284-289).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "FirSpec",
    "fir_filter",
    "fir_decimate",
    "fir_resample",
    "resample_output_count",
    "resample_end_offset",
    "prepare_phase_table",
]

LANE = 128  # below this many outputs, method="auto" takes "direct"


# ---------------------------------------------------------------------------
# Static planning helpers (host-side numpy, analog of FilterInternal.hs
# prepareCoeffs:290-319 — polyphase group table construction).
# ---------------------------------------------------------------------------

def prepare_phase_table(taps: np.ndarray, interpolation: int) -> np.ndarray:
    """Polyphase coefficient table  T[o, k] = taps[o + k*I]  (zero padded).

    Row ``o`` holds the coefficient subset used by outputs with phase ``o``.
    Equivalent to the strided groups the reference builds host-side in
    ``prepareCoeffs`` (FilterInternal.hs:297-319), but always with all I
    rows (the reference only materializes the phases its recurrence visits;
    indexing by the closed-form phase makes the distinction irrelevant).
    """
    taps = np.asarray(taps, dtype=np.float32)
    K = taps.shape[0]
    I = int(interpolation)
    Kp = -(-K // I)  # ceil: max taps per phase
    table = np.zeros((I, Kp), dtype=np.float32)
    for o in range(I):
        row = taps[o::I]
        table[o, : row.shape[0]] = row
    return table


def _resample_positions(num: int, interpolation: int, decimation: int,
                        offset: int) -> tuple[np.ndarray, np.ndarray]:
    """Closed-form (i_m, o_m) for outputs m in [0, num)."""
    m = np.arange(num, dtype=np.int64)
    t = m * decimation - offset
    o = (-t) % interpolation
    i = (t + o) // interpolation
    return i.astype(np.int32), o.astype(np.int32)


def resample_output_count(n_in: int, n_taps: int, interpolation: int,
                          decimation: int, offset: int) -> int:
    """Outputs computable from ``n_in`` input samples at start phase ``offset``.

    Mirrors the count the reference's streaming layer computes
    (Filter.hs:694): ``(n*I - K + offset) // D + 1``.
    """
    c = (n_in * interpolation - n_taps + offset) // decimation + 1
    return max(0, c)


def resample_end_offset(count: int, interpolation: int, decimation: int,
                        offset: int) -> int:
    """Phase after emitting ``count`` outputs (carry for the next block)."""
    return (offset - count * decimation) % interpolation


class FirSpec:
    """Static plan for a rational-rate FIR (the Filter/Decimator/Resampler
    config structs of Filter.hs:116-144, unified).

    Hashable/static so it can close over jitted functions.  ``interpolation
    == decimation == 1`` is a plain filter; ``interpolation == 1`` a
    decimator; otherwise a rational resampler.
    """

    def __init__(self, taps, interpolation: int = 1, decimation: int = 1,
                 symmetric: bool = False):
        taps = np.asarray(taps, dtype=np.float32)
        if symmetric:
            # The reference's symmetric kernels take the first half of a
            # linear-phase filter and mirror it (filter.c:50, Filter.hs:248).
            taps = np.concatenate([taps, taps[::-1]])
        if taps.ndim != 1:
            raise ValueError("taps must be 1-D")
        if interpolation < 1 or decimation < 1:
            raise ValueError("factors must be >= 1")
        self.taps = taps
        self.interpolation = int(interpolation)
        self.decimation = int(decimation)
        self.n_taps = int(taps.shape[0])
        self.phase_table = prepare_phase_table(taps, self.interpolation)
        self.taps_per_phase = self.phase_table.shape[1]

    def __hash__(self):
        return hash((self.taps.tobytes(), self.interpolation, self.decimation))

    def __eq__(self, other):
        return (isinstance(other, FirSpec)
                and self.interpolation == other.interpolation
                and self.decimation == other.decimation
                and np.array_equal(self.taps, other.taps))

    def __repr__(self):
        return (f"FirSpec(K={self.n_taps}, I={self.interpolation}, "
                f"D={self.decimation})")


# ---------------------------------------------------------------------------
# Execution paths.  Each takes x with shape [..., N] (leading dims batched)
# and returns [..., num].
# ---------------------------------------------------------------------------

def _as_real_batch(x):
    """View complex [..., N] as real [..., 2, N]; returns (xr, rebuild)."""
    if jnp.iscomplexobj(x):
        xr = jnp.stack([x.real, x.imag], axis=-2)
        return xr, lambda y: jax.lax.complex(y[..., 0, :], y[..., 1, :])
    return x, lambda y: y


def _gather_windows(x, starts: np.ndarray, length: int, starts_dev=None):
    """W[..., m, k] = x[..., starts[m] + k] via one gather.

    ``starts`` (host numpy) sizes the padding statically; ``starts_dev``
    optionally supplies the same values computed ON device (e.g. via
    arange) so huge index tables never become program constants — a [1M,
    128] embedded iota blows up compile payloads.
    """
    need = int(starts.max()) + length if starts.size else 0
    n = x.shape[-1]
    if need > n:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, need - n)]
        x = jnp.pad(x, pad)
    if starts_dev is None:
        starts_dev = jnp.asarray(starts.astype(np.int32))
    idx = starts_dev[:, None].astype(jnp.int32) + \
        jnp.arange(length, dtype=jnp.int32)[None, :]
    return jnp.take(x, idx, axis=-1)


def _precision():
    from sdr_tpu.utils.device import fir_precision
    return fir_precision()


def _fir_direct(taps_dev, x, num: int, factor: int, start: int = 0):
    """Gather-einsum path: works for any stride; reference semantics
    out[m] = sum_j taps[j] * x[start + m*factor + j]  (decimate.c:16-24)."""
    K = taps_dev.shape[0]
    starts = np.arange(num, dtype=np.int64) * factor + start
    starts_dev = jnp.arange(num, dtype=jnp.int32) * factor + start
    W = _gather_windows(x, starts, K, starts_dev)  # [..., num, K]
    return jnp.einsum("...mk,k->...m", W, taps_dev,
                      precision=_precision(),
                      preferred_element_type=jnp.float32)


def _fir_conv(taps_dev, x, num: int, factor: int, start: int = 0):
    """lax.conv_general_dilated path (cuDNN convolution on the GPU).

    ConvGeneralDilated computes cross-correlation (no kernel flip), which is
    exactly the reference's orientation (filter.c:16-24).

    ``start`` (a static input origin) is folded in as NEGATIVE low
    padding, and moderately over-long inputs are handled by computing
    extra outputs and truncating — the buffer is never sliced, because a
    slice feeding a conv materializes a full copy of the (potentially
    100s-of-MB) input in HBM.  When the input is FAR longer than the
    window span (num << n), extra-output work would dominate instead, so
    the input IS sliced — to ``need`` elements, which is small in
    exactly that regime.
    """
    K = taps_dev.shape[0]
    need = start + (num - 1) * factor + K
    n = x.shape[-1]
    if n > need and (n - need) * 8 > n:
        x = x[..., :need]
        n = need
    hi = max(0, need - n)
    lead = x.shape[:-1]
    xb = x.reshape((-1, 1, x.shape[-1]))           # [B, C=1, N]
    w = taps_dev.reshape((1, 1, K))                # [O=1, I=1, K]
    y = jax.lax.conv_general_dilated(
        xb, w, window_strides=(factor,), padding=[(-start, hi)],
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=_precision(),
        preferred_element_type=jnp.float32)
    return y.reshape(lead + (-1,))[..., :num]


def _pick_method(method: str, num: int, factor: int, n_taps: int) -> str:
    if method != "auto":
        return method
    if num < LANE:
        return "direct"
    # device-aware dispatch (the featureSelect analog, utils/device.py)
    from sdr_tpu.utils.device import best_method
    return best_method(n_taps, factor, num)


def _dispatch(taps_np: np.ndarray, x, num: int, factor: int, method: str,
              start: int = 0):
    method = _pick_method(method, num, factor, taps_np.shape[0])
    xr, rebuild = _as_real_batch(x)
    if method == "direct":
        y = _fir_direct(jnp.asarray(taps_np), xr, num, factor, start)
    elif method == "conv":
        y = _fir_conv(jnp.asarray(taps_np), xr, num, factor, start)
    else:
        raise ValueError(f"unknown method {method!r}")
    return rebuild(y)


# ---------------------------------------------------------------------------
# Public ops (reference kernel parity surface).
# ---------------------------------------------------------------------------

def fir_filter(taps, x, num: Optional[int] = None, method: str = "auto",
               start: int = 0):
    """Sliding dot product, reference ``filterRR``/``filterRC``
    (c_sources/filter.c:16,74):  y[i] = sum_j taps[j] * x[..., start+i+j].

    ``num`` defaults to the full valid length ``N - K + 1``.  Real taps;
    ``x`` may be real or complex (complex handled as a 2-row real batch,
    like the interleaved re/im layout of filter.c:74-84).  ``start`` is a
    static input origin folded into the kernel — zero-copy (equivalent
    to calling on ``x[..., start:]`` without the slice's copy).
    """
    taps_np = np.asarray(taps, dtype=np.float32)
    if num is None:
        num = x.shape[-1] - start - taps_np.shape[0] + 1
    if num < 0:
        raise ValueError("input shorter than filter")
    return _dispatch(taps_np, x, int(num), 1, method, int(start))


def fir_decimate(taps, factor: int, x, num: Optional[int] = None,
                 method: str = "auto", start: int = 0):
    """Strided sliding dot product, reference ``decimateRR``/``decimateRC``
    (c_sources/decimate.c:16,73):
    y[i] = sum_j taps[j] * x[..., start + i*factor + j].
    """
    taps_np = np.asarray(taps, dtype=np.float32)
    if num is None:
        num = (x.shape[-1] - start - taps_np.shape[0]) // factor + 1
    if num < 0:
        raise ValueError("input shorter than filter")
    return _dispatch(taps_np, x, int(num), int(factor), method, int(start))


def fir_resample(taps, interpolation: int, decimation: int, x,
                 offset: int = 0, num: Optional[int] = None,
                 method: str = "auto", start: int = 0):
    """Polyphase rational resampler, reference ``resampleRR``/``resample2RR``
    (c_sources/resample.c:16-48) and ``resampleHighLevel``
    (FilterInternal.hs:252-265).

    Returns ``(y, end_offset)`` where ``end_offset`` is the phase carry for
    the next block — same contract as the C kernel returning the final
    group (resample.c:48).

    Closed-form positions (see module docstring): output m reads input
    window starting at i_m with coefficient-phase row o_m.  Outputs with
    equal phase form arithmetic input sequences, so the whole op is a
    static gather + phase-table contraction — no sequential recurrence.

    ``start``: static input origin (output m reads
    ``x[..., start + i_m + k]``), folded into the kernel zero-copy.
    """
    taps_np = np.asarray(taps, dtype=np.float32)
    I, D = int(interpolation), int(decimation)
    K = taps_np.shape[0]
    offset = int(offset)
    start = int(start)
    if not (0 <= offset < I):
        raise ValueError("offset must be in [0, interpolation)")
    if num is None:
        num = resample_output_count(x.shape[-1] - start, K, I, D, offset)
    num = int(num)
    end_offset = resample_end_offset(num, I, D, offset)
    if num == 0:
        shape = x.shape[:-1] + (0,)
        return jnp.zeros(shape, x.dtype), end_offset
    if I == 1:
        y = _dispatch(taps_np, x, num, D, method, start)
        return y, 0

    if method == "auto":
        from sdr_tpu.utils.device import device_family
        from sdr_tpu.utils import tuning
        method = tuning.best_resample_method(
            device_family(), taps_np.shape[0], I, D, num)
    if method == "band_xla":
        xr, rebuild = _as_real_batch(x)
        y = _resample_band(taps_np, I, D, xr, offset, num, start)
        return rebuild(y), end_offset
    method = _pick_method(method, num, D, taps_np.shape[0])
    if method == "direct":
        # gather + per-output phase rows; fine on CPU / tiny blocks
        table = prepare_phase_table(taps_np, I)       # [I, Kp]
        Kp = table.shape[1]
        i_m, o_m = _resample_positions(num, I, D, offset)
        # device-side closed form (host copy above only sizes padding) —
        # embedding [num]-sized tables as constants bloats compile payloads
        t_dev = jnp.arange(num, dtype=jnp.int32) * D - offset
        o_dev = jnp.mod(-t_dev, I)
        i_dev = (t_dev + o_dev) // I + start
        xr, rebuild = _as_real_batch(x)
        W = _gather_windows(xr, i_m.astype(np.int64) + start, Kp, i_dev)
        rows = jnp.take(jnp.asarray(table), o_dev, axis=0)  # [num, Kp]
        y = jnp.einsum("...mk,mk->...m", W, rows,
                       precision=_precision(),
                       preferred_element_type=jnp.float32)
        return rebuild(y), end_offset
    if jnp.iscomplexobj(x):
        return _resample_conv_c(taps_np, I, D, x, offset, num,
                                start), end_offset
    return _resample_conv(taps_np, I, D, x, offset, num, start), end_offset


def _resample_conv(taps_np: np.ndarray, I: int, D: int, x, offset: int,
                   num: int, start: int = 0):
    """Gather-free polyphase resampler: ONE strided conv with I output
    channels.

    Outputs with equal phase ``j = m mod I`` advance through the input by
    exactly D samples (t grows by I*D per phase period, so i grows by D
    with o fixed).  Fold each phase's input start offset ``i_j - i_min``
    into its kernel as leading zeros; then

        y[q*I + j] = sum_d  Kmat[j, d] * x[i_min + q*D + d]

    is a stride-D VALID conv with I output channels, and the result only
    needs a [Q, I] -> [Q*I] interleave (free relayout, no gather).  This is
    the convolution form of the reference's per-group recurrence
    (c_sources/resample.c:16-48) — all phases advance in lockstep instead
    of sequentially.
    """
    table = prepare_phase_table(taps_np, I)           # [I, Kp]
    Kp = table.shape[1]
    J = min(I, num)
    t_j = np.arange(I, dtype=np.int64) * D - offset
    o_j = (-t_j) % I
    i_j = (t_j + o_j) // I
    i_min = int(i_j[:J].min())
    L = int((i_j[:J] - i_min).max()) + Kp
    Kmat = np.zeros((I, 1, L), dtype=np.float32)
    for j in range(J):
        s = int(i_j[j]) - i_min
        Kmat[j, 0, s: s + Kp] = table[int(o_j[j])]
    Q = -(-num // I)                                   # outputs per phase
    lo = i_min + start                                 # conv input origin
    need = lo + (Q - 1) * D + L
    n = x.shape[-1]
    # origin folded in as negative low padding, short input padded high —
    # the buffer itself is never sliced (a slice feeding a conv
    # materializes a full HBM copy of the input) UNLESS the input is far
    # longer than the window span, where the small slice beats computing
    # and discarding outputs over the whole buffer
    if n > need and (n - need) * 8 > n:
        x = x[..., :need]
        n = need
    lead = x.shape[:-1]
    xb = x.reshape((-1, 1, x.shape[-1]))               # [B, 1, N']
    y = jax.lax.conv_general_dilated(
        xb, jnp.asarray(Kmat), window_strides=(D,),
        padding=[(-lo, max(0, need - n))],
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=_precision(),
        preferred_element_type=jnp.float32)            # [B, I, >=Q]
    y = y[..., :Q]
    y = jnp.swapaxes(y, -1, -2).reshape(lead + (Q * I,))
    return y[..., :num]


def _resample_band(taps_np: np.ndarray, I: int, D: int, x, offset: int,
                   num: int, start: int = 0):
    """Banded-matmul polyphase resampler (real data, leading dims
    batched).

    Group G consecutive outputs per band row, with G a multiple of I so
    every row has the same phase pattern and rows advance through the
    input by exactly ``S = G*D/I`` samples.  Then

        y[G*p + g] = sum_k B[i_g + k, g] * x[p*S + i_g + k],
        B[i_g + k, g] = T[o_g, k]            (phase table rows)

    i.e. ``y_rows = X @ B`` where ``X[p, s] = x[p*S + s]`` is a FREE
    reshape of the input and the window tail past ``S`` is read through
    the one-row-shifted view (main + halo split dots — the same
    zero-copy structure as the int8 front end, ops/quantized.py).  No
    window matrix, no gather, no tiny-channel strided conv; the dense
    band costs ``~128*D/I`` MACs per output.

    A ragged tail of ``num mod G`` outputs (plus any outputs whose rows
    would read past the buffer) is computed by the direct gather path
    and concatenated — at most ~2G outputs, negligible.

    ``start + i_g`` offsets below one row stride are folded into the
    band as leading zero rows (zero-copy); larger static starts fall
    back to an explicit slice.
    """
    table = prepare_phase_table(taps_np, I)            # [I, Kp]
    Kp = table.shape[1]
    G = I * max(1, int(round(LANE / I)))               # ~128 outputs/row
    S = G * D // I
    # first-group geometry (p = 0, outputs g in [0, G)): i_0 = 0 exactly
    # (t_0 = -offset, o_0 = offset -> i_0 = 0), so ``start`` is the only
    # origin to fold in
    g = np.arange(G, dtype=np.int64)
    t_g = g * D - offset
    o_g = (-t_g) % I
    i_g = (t_g + o_g) // I
    lead_off = start
    if lead_off >= S:                                  # rare: large origin
        x = x[..., (lead_off // S) * S:]
        lead_off = lead_off % S
    start = lead_off  # x's origin from here on (tail path uses it too)
    W = lead_off + int(i_g.max()) + Kp
    halo_w = W - S
    while halo_w > S:                                  # long taps: widen rows
        G *= 2
        S = G * D // I
        g = np.arange(G, dtype=np.int64)
        t_g = g * D - offset
        o_g = (-t_g) % I
        i_g = (t_g + o_g) // I
        W = lead_off + int(i_g.max()) + Kp
        halo_w = W - S
    halo_w = max(0, halo_w)     # short taps: the band ends inside one row
    B = np.zeros((max(W, S), G), dtype=np.float32)
    for gg in range(G):
        s0 = lead_off + int(i_g[gg])
        B[s0: s0 + Kp, gg] = table[int(o_g[gg])]
    n = x.shape[-1]
    # rows that fit entirely in the buffer (the tail path covers the rest);
    # each main row needs S samples even when the band is narrower
    P = min(-(-num // G), max(0, (n - max(W, S)) // S + 1))
    n_band = min(num, P * G)
    lead = x.shape[:-1]
    if P > 0:
        # main rows: a free reshape (start-aligned).  Halo rows from the
        # MAIN VIEW shifted by one row plus a tiny tail slice — never a
        # non-start-aligned slice of the input, which XLA materializes
        # as a FULL copy (ops/quantized.py)
        main = x[..., : P * S].reshape(lead + (P, S))
        cdims = (((main.ndim - 1,), (0,)), ((), ()))
        y = jax.lax.dot_general(main, jnp.asarray(B[:S]), cdims,
                                precision=_precision(),
                                preferred_element_type=jnp.float32)
        if halo_w > 0:
            tail = x[..., P * S: P * S + halo_w]
            tpad = halo_w - tail.shape[-1]
            if tpad > 0:
                tail = jnp.pad(tail, [(0, 0)] * (x.ndim - 1) + [(0, tpad)])
            halo = jnp.concatenate(
                [main[..., 1:, :halo_w], tail.reshape(lead + (1, halo_w))],
                axis=-2)
            y = y + jax.lax.dot_general(halo, jnp.asarray(B[S: S + halo_w]),
                                        cdims, precision=_precision(),
                                        preferred_element_type=jnp.float32)
        y = y.reshape(lead + (P * G,))[..., :n_band]
    else:
        y = jnp.zeros(lead + (0,), jnp.float32)
    if n_band < num:                                   # ragged tail: gather
        rem = num - n_band
        t0 = n_band * D - offset
        off_t = (-t0) % I
        i_t = (t0 + off_t) // I
        tail, _ = fir_resample(taps_np, I, D, x, int(off_t), rem,
                               method="direct", start=start + int(i_t))
        y = jnp.concatenate([y, tail.astype(jnp.float32)], axis=-1)
    return y


def _resample_conv_c(taps_np: np.ndarray, I: int, D: int, x, offset: int,
                     num: int, start: int = 0):
    """Complex-input polyphase resampler on the INTERLEAVED float32 view.

    A complex64 buffer IS a (re, im)-interleaved float32 buffer, so the
    resampler becomes ONE strided real conv over that view: 2I output
    channels — channel j*2 + c computes component c of phase j via the
    phase-j kernel zero-stuffed to positions 2k + c — with stride 2D.
    The [Q, 2I] -> [Q*2I] relayout IS the interleaved complex output,
    viewed back as complex64 with no gather or transpose pair.

    Requires an 8-byte complex dtype for the float32 view; other complex
    inputs (e.g. numpy complex128) take the planar path instead.
    """
    if np.dtype(x.dtype).itemsize != 8:
        xr, rebuild = _as_real_batch(x)
        return rebuild(_resample_conv(taps_np, I, D, xr, offset, num, start))
    table = prepare_phase_table(taps_np, I)            # [I, Kp]
    Kp = table.shape[1]
    J = min(I, num)
    t_j = np.arange(I, dtype=np.int64) * D - offset
    o_j = (-t_j) % I
    i_j = (t_j + o_j) // I
    i_min = int(i_j[:J].min())
    L = int((i_j[:J] - i_min).max()) + Kp
    Kmat = np.zeros((2 * I, 1, 2 * L), dtype=np.float32)
    for j in range(J):
        s = int(i_j[j]) - i_min
        for c in (0, 1):
            Kmat[2 * j + c, 0, 2 * s + c: 2 * (s + Kp): 2] = table[int(o_j[j])]
    Q = -(-num // I)
    lo = 2 * (i_min + start)
    need = lo + (Q - 1) * 2 * D + 2 * L
    xi = x.view(jnp.float32)                           # [..., 2N]
    n = xi.shape[-1]
    if n > need and (n - need) * 8 > n:
        xi = xi[..., :need]
        n = need
    lead = x.shape[:-1]
    xb = xi.reshape((-1, 1, xi.shape[-1]))
    y = jax.lax.conv_general_dilated(
        xb, jnp.asarray(Kmat), window_strides=(2 * D,),
        padding=[(-lo, max(0, need - n))],
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=_precision(),
        preferred_element_type=jnp.float32)            # [B, 2I, >=Q]
    y = y[..., :Q]
    y = jnp.swapaxes(y, -1, -2).reshape(lead + (Q * 2 * I,))
    return y.view(x.dtype)[..., :num]
