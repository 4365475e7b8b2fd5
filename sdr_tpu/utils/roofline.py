"""Roofline accounting for streaming chains.

The reference ships no performance model at all (SURVEY.md §6: no
published numbers).  This module answers "how far is this stage from the
hardware floor?" statically: for every op in a chain it counts the bytes
that must cross device memory and the arithmetic on each execution unit,
and turns them into a per-stage lower bound

    floor = max(bytes_moved / BW_hbm,  f32_flops / F_f32,
                tf32_flops / F_tf32, bf16_flops / F_bf16,
                int8_ops / F_int8)

The byte model is the *fused* optimum: each stage reads its input once
from device memory and writes its output once — intermediates inside a
stage are assumed to stay in registers or shared memory.  Arithmetic is
counted for the execution path the op DISPATCHES to on the device family
the ceilings describe (``Ceilings.family``).  A floor is a bound, not a
prediction.

Ceilings are published peaks, keyed by the exact ``device_kind`` string
JAX reports; a device missing from :data:`PEAKS` is an error, not a
default.
"""

from __future__ import annotations

from dataclasses import dataclass, field, asdict

import numpy as np
import jax.numpy as jnp

__all__ = ["Ceilings", "StageCost", "stage_costs", "chain_roofline",
           "PEAKS", "peaks_for"]

LANE = 128   # below this many outputs the FIR dispatch takes 'direct'


@dataclass(frozen=True)
class Ceilings:
    """Published device peaks (units: bytes/s and ops/s)."""
    name: str
    family: str             # device family FIR dispatch resolves for
    hbm_bps: float          # device-memory bandwidth
    f32_flops: float        # f32 on the CUDA cores (FMA = 2 flops); also
                            # f32 matmul/conv at Precision.HIGHEST
    tf32_flops: float       # tensor cores, TF32 (f32 matmul at DEFAULT)
    bf16_flops: float       # tensor cores, dense bf16
    int8_ops: float         # tensor cores, dense int8
    source: str


# NVIDIA H100 SXM5 data sheet, dense rates (no sparsity) at the 700 W
# board limit.  A card set below 700 W (``nvidia-smi --query-gpu=
# power.limit``) cannot hold these clocks under load: state the limit
# beside any share of these peaks.
PEAKS = {
    "NVIDIA H100 80GB HBM3": Ceilings(
        "NVIDIA H100 80GB HBM3 (SXM5 data sheet)", family="gpu",
        hbm_bps=3.35e12, f32_flops=67e12, tf32_flops=495e12,
        bf16_flops=989e12, int8_ops=1979e12,
        source="NVIDIA H100 Tensor Core GPU data sheet, SXM5 column"),
}


def peaks_for(kind: str | None = None) -> Ceilings:
    """Peaks of ``kind`` (default: the attached device's ``device_kind``).
    Raises ``ValueError`` for a device not in :data:`PEAKS`."""
    if kind is None:
        from sdr_tpu.utils.device import device_kind
        kind = device_kind()
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(f"no published peaks for device kind {kind!r}; "
                         f"known: {sorted(PEAKS)}") from None


@dataclass
class StageCost:
    op: str
    n_in: int
    n_out: int
    bytes_in: int
    bytes_out: int
    f32_flops: float = 0.0
    tf32_flops: float = 0.0
    bf16_flops: float = 0.0
    int8_ops: float = 0.0
    note: str = ""
    floors: dict = field(default_factory=dict)

    @property
    def bytes_moved(self) -> int:
        return self.bytes_in + self.bytes_out

    def floor_s(self, c: Ceilings) -> float:
        self.floors = {
            "hbm": self.bytes_moved / c.hbm_bps,
            "f32": self.f32_flops / c.f32_flops,
            "tf32": self.tf32_flops / c.tf32_flops,
            "bf16": self.bf16_flops / c.bf16_flops,
            "int8": self.int8_ops / c.int8_ops,
        }
        return max(self.floors.values())


def _nbytes(n, dtype, batch=1):
    return int(n) * int(batch) * np.dtype(dtype).itemsize


def _resolve_fir_method(op, n_out: int, family: str) -> str:
    """The execution path a Fir stage dispatches to on ``family``
    (mirrors ops/fir.py at method='auto')."""
    from sdr_tpu.utils import tuning
    spec = op.spec
    if op.method != "auto":
        return op.method
    if n_out < LANE:
        return "direct"
    if spec.interpolation > 1:
        return tuning.best_resample_method(
            family, spec.n_taps, spec.interpolation, spec.decimation, n_out)
    return tuning.best_method(family, spec.n_taps, spec.decimation, n_out)


def _fir_cost(op, c: StageCost, n_out: int, cplx: bool, mul_out: int,
              family: str):
    """Fill the arithmetic cost of a Fir stage for its dispatched path:
    K (or padded-phase-row) MACs per output for conv/direct, the dense
    band's MACs for band_xla — all f32 at the FIR paths' HIGHEST
    precision."""
    spec = op.spec
    K, I, D = spec.n_taps, spec.interpolation, spec.decimation
    method = _resolve_fir_method(op, n_out, family)
    planes = 2 if cplx else 1
    if I > 1 and method == "band_xla":
        # dense [P, S] x [S, G] (+ halo) per G outputs
        G = I * max(1, int(round(LANE / I)))
        S = G * D // I
        Kp = spec.taps_per_phase
        macs_per_out = S + max(0, Kp + (G - 1) * D // I + 1 - S)
        c.note = f"xla band G={G} S={S}"
    else:
        macs_per_out = K if I == 1 else spec.taps_per_phase + 1
        c.note = method
    c.f32_flops = 2.0 * n_out * macs_per_out * mul_out * planes


def _cost_one(op, n_in: int, in_dtype, in_batch: tuple, batch: int,
              family: str):
    """(StageCost, n_out, out_dtype, out_batch) for one op at one block
    shape.  ``in_batch`` is the per-block leading shape (e.g. the planar
    [2] plane axis); ``batch`` the block-parallel multiplier."""
    from sdr_tpu.stream import ops as S

    n_out = op.out_len(n_in)
    out_dtype = op.out_dtype(in_dtype)
    out_batch = tuple(op.map_batch_shape(tuple(in_batch)))
    mul_in = batch * int(np.prod(in_batch)) if in_batch else batch
    mul_out = batch * int(np.prod(out_batch)) if out_batch else batch
    cplx_in = jnp.issubdtype(jnp.dtype(in_dtype), jnp.complexfloating)
    c = StageCost(op=type(op).__name__, n_in=n_in, n_out=n_out,
                  bytes_in=_nbytes(n_in, in_dtype, mul_in),
                  bytes_out=_nbytes(n_out, out_dtype, mul_out))

    if isinstance(op, S.U8FrontEnd):
        # the XLA int8 band (ops/quantized.py): a dense [P, stride+halo] x
        # [stride+halo, 2Q] dot per Q outputs, hi/lo bands for s16
        from sdr_tpu.ops.quantized import Q_DEFAULT
        q = op.q_out or Q_DEFAULT
        stride = 2 * op.factor * q
        halo = max(0, 2 * (op.n_taps - 1) + 2 - 2 * op.factor)
        rows = -(-n_out // q)
        bands = 2 if op.precision == "s16" else 1
        c.int8_ops = 2.0 * batch * rows * (stride + halo) * 2 * q * bands
        c.note = f"xla int8 band Q={q} {op.precision}"
    elif isinstance(op, S.U8FrontDemod):
        # fused kernel: K f32 MACs per plane per output, then the
        # polynomial-atan2 demod, all on the CUDA cores
        c.f32_flops = (2.0 * 2 * op.n_taps + 30.0) * n_out * batch
        c.note = "fused front kernel"
    elif isinstance(op, (S.IqConvertU8, S.IqConvertI16)):
        c.f32_flops = 4.0 * n_in * batch
    elif isinstance(op, S.Fir):
        _fir_cost(op, c, n_out, cplx_in, mul_in, family)
    elif isinstance(op, S.FmDemod):
        c.f32_flops = 30.0 * n_out * mul_out      # cross-mul + atan2
    elif isinstance(op, (S.AmDemod, S.Mix)):
        c.f32_flops = 10.0 * n_out * mul_out
    elif isinstance(op, (S.DcBlocker, S.Agc, S.Iir, S.FmMod)):
        # associative scan: ~2 logical passes over the data
        c.f32_flops = 20.0 * n_out * mul_out
        c.bytes_in *= 2
    elif isinstance(op, S.Scale):
        c.f32_flops = 1.0 * n_out * mul_out
    elif isinstance(op, S.FftStream):
        # out_len counts frames; each frame is one op.size-bin FFT row
        # (the row axis is the op's trailing output dim, not in n_out)
        c.bytes_out *= op.size
        c.f32_flops = 5.0 * op.size * np.log2(max(op.size, 2)) \
            * n_out * batch
        c.note = "xla fft"
    elif isinstance(op, S.Channelize):
        C = op.n_channels
        c.f32_flops = (2.0 * op.taps_per_branch
                       + 5.0 * np.log2(max(C, 2))) * n_out * C * 2 * batch
    return c, n_out, out_dtype, out_batch


def stage_costs(ops, block_in: int, in_dtype=jnp.uint8, batch: int = 1,
                family: str = "gpu"):
    """Walk a chain, returning one :class:`StageCost` per op, with each
    FIR stage costed for the path it dispatches to on ``family``."""
    out, n, dt, bshape = [], int(block_in), in_dtype, ()
    for op in ops:
        c, n, dt, bshape = _cost_one(op, n, dt, bshape, batch, family)
        out.append(c)
    return out


def chain_roofline(ops, block_in: int, in_dtype=jnp.uint8, batch: int = 1,
                   ceilings: Ceilings | str | None = None):
    """Per-stage and total hardware floors for a chain.

    ``ceilings``: a :class:`Ceilings`, a ``device_kind`` key of
    :data:`PEAKS`, or None for the attached device (which must be in
    the table).  Returns ``{"ceilings", "stages": [...], "total_floor_s",
    "input_samples", "sol_samples_per_s"}`` — JSON-ready.
    ``input_samples`` is complex input samples (u8 chains: bytes/2), so
    ``input_samples / total_floor_s`` is the chain's speed-of-light in
    the headline unit.
    """
    if not isinstance(ceilings, Ceilings):
        ceilings = peaks_for(ceilings)
    stages = stage_costs(ops, block_in, in_dtype, batch, ceilings.family)
    total = 0.0
    rows = []
    for s in stages:
        f = s.floor_s(ceilings)
        total += f
        d = asdict(s)
        d["floor_s"] = f
        d["bound_by"] = max(s.floors, key=s.floors.get)
        rows.append(d)
    n_cplx = block_in * batch
    if np.dtype(in_dtype) == np.uint8:
        n_cplx //= 2
    return {"ceilings": asdict(ceilings), "stages": rows,
            "total_floor_s": total, "input_samples": int(n_cplx),
            "sol_samples_per_s": n_cplx / total if total else float("inf")}
