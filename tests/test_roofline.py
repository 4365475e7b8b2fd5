"""Roofline accounting (utils/roofline.py): static per-stage floors.

The model's job is order-of-magnitude placement (memory- vs
compute-bound, stage ranking), so the assertions check structure,
conservation laws, and known relationships — not exact constants.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from sdr_tpu.apps.chains import fm_chain, waterfall_chain
from sdr_tpu.utils.roofline import (chain_roofline, stage_costs, PEAKS,
                                    peaks_for)

H100 = "NVIDIA H100 80GB HBM3"


def test_stage_shapes_walk_matches_ops():
    ops = fm_chain(method="conv", front="quantized")
    block = 163_840
    costs = stage_costs(ops, block, jnp.uint8)
    assert [c.op for c in costs] == [type(o).__name__ for o in ops]
    # shape walk: each stage's n_in is the previous n_out
    for prev, cur in zip(costs, costs[1:]):
        assert cur.n_in == prev.n_out
    # the full chain: 163840 bytes -> 81920 cplx -> /8 -> *3/10 audio
    assert costs[0].n_in == block
    assert costs[0].n_out == block // 2 // 8
    assert costs[-1].n_out == block // 2 // 8 * 3 // 10


def test_bytes_account_for_planes_and_dtypes():
    ops = fm_chain(method="conv", front="quantized")
    costs = stage_costs(ops, 163_840, jnp.uint8)
    front = costs[0]
    # u8 in: one byte per element; planar f32 out: 2 planes x 4 bytes
    assert front.bytes_in == 163_840
    assert front.bytes_out == 2 * 4 * front.n_out
    # demod consumes both planes, emits one real plane
    demod = costs[1]
    assert demod.bytes_in == 2 * 4 * demod.n_in
    assert demod.bytes_out == 4 * demod.n_out


def test_fused_floor_below_quantized_floor():
    """The fused front (no device-memory round trip of the I/Q planes)
    must have a strictly lower floor than convert+decimate+demod
    as separate stages."""
    block = 10_485_760
    q = chain_roofline(fm_chain(method="conv", front="quantized"), block,
                       ceilings=H100)
    f = chain_roofline(fm_chain(method="conv", front="fused"), block,
                       ceilings=H100)
    assert f["total_floor_s"] < q["total_floor_s"]
    assert f["sol_samples_per_s"] > q["sol_samples_per_s"]


def test_exact_front_is_memory_bound():
    r = chain_roofline(fm_chain(method="conv", front="exact", planar=True),
                       10_485_760, ceilings=H100)
    assert r["stages"][0]["op"] == "IqConvertU8"
    assert r["stages"][0]["bound_by"] == "hbm"


def test_batch_scales_floors_linearly():
    ops = fm_chain(method="conv", front="quantized")
    r1 = chain_roofline(ops, 1_638_400, batch=1, ceilings=H100)
    r8 = chain_roofline(ops, 1_638_400, batch=8, ceilings=H100)
    assert r8["total_floor_s"] == pytest.approx(8 * r1["total_floor_s"],
                                                rel=1e-6)
    # samples/s at the floor is batch-invariant
    assert r8["sol_samples_per_s"] == pytest.approx(
        r1["sol_samples_per_s"], rel=1e-6)


def test_waterfall_fft_counted():
    r = chain_roofline(waterfall_chain(1024, 512), 1_048_576,
                       ceilings=H100)
    fft = r["stages"][-1]
    assert fft["op"] == "FftStream"
    assert fft["f32_flops"] > 0
    # output rows are size-wide (f32 magnitude or c64), not one sample
    # per frame
    assert fft["bytes_out"] in (fft["n_out"] * 1024 * 4,
                                fft["n_out"] * 1024 * 8)


def test_json_ready_and_ceiling_select():
    r = chain_roofline(fm_chain(front="quantized"), 163_840,
                       ceilings=H100)
    import json
    json.dumps(r)  # must serialize
    assert r["ceilings"]["name"] == PEAKS[H100].name
    # a Ceilings object and its device_kind key give the same floors
    r2 = chain_roofline(fm_chain(front="quantized"), 163_840,
                        ceilings=PEAKS[H100])
    assert r2["total_floor_s"] == r["total_floor_s"]


def test_h100_peaks_are_the_data_sheet():
    c = peaks_for(H100)
    assert c.family == "gpu"
    assert (c.hbm_bps, c.f32_flops, c.tf32_flops, c.bf16_flops,
            c.int8_ops) == (3.35e12, 67e12, 495e12, 989e12, 1979e12)
    assert "data sheet" in c.source


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H200", "NVIDIA A100-SXM4-80GB"])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        peaks_for(kind)
    with pytest.raises(ValueError, match="no published peaks"):
        chain_roofline(fm_chain(front="quantized"), 163_840, ceilings=kind)


def test_attached_device_needs_peaks():
    """With no ceilings given the attached device's kind is looked up:
    the CPU has no published peaks, so the roofline refuses it."""
    with pytest.raises(ValueError, match="no published peaks"):
        chain_roofline(fm_chain(front="quantized"), 163_840)
