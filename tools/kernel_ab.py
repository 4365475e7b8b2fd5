"""Kernel A/B on the GPU: the fused front kernel (at several tile
geometries) against the plain XLA forms it replaces, and the FIR
execution paths per tap family (the rates behind utils/tuning.py).

    python tools/kernel_ab.py [--out chiprun_out/kernel_ab.json]

Every case is jitted, compiled and run twice before timing; the time is
the median over 5 windows of ``block_until_ready`` around 10 calls.
Refuses to run without a GPU.  Prints one JSON object per case and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sdr_tpu.apps.chains import fm_taps  # noqa: E402
from sdr_tpu.ops import convert, demod, design, fir  # noqa: E402


def timeit(fn, *args, windows=5, reps=10):
    jax.block_until_ready(fn(*args))
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / reps)
    return statistics.median(ts)


def run_case(results, name, fn, args, n_in, unit="input samples"):
    try:
        t = timeit(jax.jit(fn), *args)
        row = {"case": name, "ms": t * 1e3, "rate": n_in / t, "unit": unit}
    except Exception as e:   # report and go on: one failed path is a finding
        row = {"case": name, "error": f"{type(e).__name__}: {e}"[:400]}
    results.append(row)
    print(json.dumps(row), flush=True)


def front_cases(results, batch, block_bytes):
    from sdr_tpu.kernels import u8_front_demod_triton as kt
    from sdr_tpu.ops.quantized import fir_decimate_u8_planar
    rf = fm_taps()[0]
    key = jax.random.PRNGKey(0)
    raw = jax.random.randint(key, (batch, block_bytes), 0, 256,
                             jnp.int32).astype(jnp.uint8)
    num = block_bytes // 16
    liq = jnp.zeros((batch, 2), jnp.float32)
    n_in = batch * block_bytes // 2
    # the 2(K - 8)-byte window tail past the last output, rounded up to
    # whole 16-byte rows so the kernel's row view needs no padded copy
    tail = -(-2 * (rf.shape[0] - 8) // 16) * 16
    xpad = jnp.pad(raw, [(0, 0), (0, tail)], constant_values=128)

    def exact(method):
        def f(r):
            x = convert.iq_u8_to_planar(r)
            iq = fir.fir_decimate(rf, 8, x, num, method=method)
            return demod.fm_demod_planar(iq, liq, atan2="poly")[0]
        return f

    def quant(prec):
        def f(r):
            iq = fir_decimate_u8_planar(rf, 8, r, num, precision=prec)
            return demod.fm_demod_planar(iq, liq, atan2="poly")[0]
        return f

    with jax.default_matmul_precision("highest"):
        ref = jax.jit(exact("conv"))(xpad)
    shipped = kt.PHASES, kt.ROWS, kt.NUM_WARPS
    for G, R, W in ((4, 256, 4), (8, 256, 4), (16, 128, 4), (8, 512, 8),
                    (8, 128, 4), (16, 256, 8)):
        # the tile geometry is read when the jitted case is first traced
        kt.PHASES, kt.ROWS, kt.NUM_WARPS = G, R, W
        fn = (lambda r: kt.u8_front_demod(rf, 8, r, liq, num))
        try:
            err = float(jnp.abs(jax.jit(fn)(xpad) - ref).max())
        except Exception as e:
            err = f"{type(e).__name__}: {e}"[:400]
        results.append({"case": f"front_kernel_G{G}_R{R}_w{W}_maxerr",
                        "value": err})
        print(json.dumps(results[-1]), flush=True)
        run_case(results, f"front_kernel_G{G}_R{R}_w{W}", fn, (xpad,), n_in)
    kt.PHASES, kt.ROWS, kt.NUM_WARPS = shipped
    run_case(results, "front_xla_exact_conv", exact("conv"), (xpad,), n_in)
    run_case(results, "front_xla_quantized_s8", quant("s8"), (xpad,), n_in)
    run_case(results, "front_xla_quantized_s16", quant("s16"), (xpad,), n_in)
    for prec in ("s8", "s16"):
        try:
            got = jax.jit(quant(prec))(xpad)
            err = float(jnp.abs(got - ref).max())
        except Exception as e:
            err = f"{type(e).__name__}: {e}"[:400]
        results.append({"case": f"front_xla_quantized_{prec}_maxerr",
                        "value": err})
        print(json.dumps(results[-1]), flush=True)


def fir_cases(results, batch):
    rf, ars, afl = fm_taps()
    key = jax.random.PRNGKey(1)
    chan = design.windowed_sinc(64, 1.0 / 16, design.hamming)

    def sig(shape):
        return jax.random.normal(key, shape, jnp.float32)

    fams = [
        # (name, taps, I, D, input shape)
        ("decimate_k51_d8_fm", rf, 1, 8, (batch, 2, 5_242_880)),
        ("decimate_k51_d8_chan64", rf, 1, 8, (64, 2, 640_000)),
        ("decimate_k64_d16_am", chan, 1, 16, (batch, 2, 524_288)),
        ("resample_k31_3_10", ars, 3, 10, (batch, 655_360)),
        ("filter_k64_audio", afl, 1, 1, (batch, 196_608)),
    ]
    methods = {1: ("conv", "direct"), 3: ("conv", "band_xla", "direct")}
    for name, taps, I, D, shape in fams:
        for m in methods[I]:
            shp = shape
            if m == "direct":
                # the gather path builds [num, K] windows: run it at 1/8
                # of the batch so it fits, rates are per input sample
                shp = (max(1, shape[0] // 8),) + shape[1:]
            x = sig(shp)
            n_in = int(np.prod(shp))

            def f(x, taps=taps, I=I, D=D, m=m):
                n = x.shape[-1]
                if I == 1:
                    return fir.fir_decimate(taps, D, x, method=m) if D > 1 \
                        else fir.fir_filter(taps, x, method=m)
                num = fir.resample_output_count(n, taps.shape[0], I, D, 0)
                return fir.fir_resample(taps, I, D, x, 0, num, method=m)[0]
            run_case(results, f"{name}_{m}", f, (x,), n_in)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="chiprun_out/kernel_ab.json")
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU found (platform {dev.platform!r})", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    results = [{"device": dev.device_kind, "nvidia_smi": smi}]
    front_cases(results, args.batch, 10 * 1024 * 1024)
    front_cases(results, 1, 1_310_720)
    fir_cases(results, args.batch)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
