"""Smoke test of the main path on an NVIDIA GPU.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the sharded paths only

Runs in one process (a second JAX process could not get the card's
memory).  Each phase drives the apps and chains through their public
entry points at deployment sizes and compares the result with the float64
numpy references in tests/oracles.py within the reference's 0.01 bound
(tests/TestSuite.hs:284-289) unless a phase states another tolerance.
Exits non-zero, and prints no result, when JAX finds no GPU or when any
phase fails.  The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import wave

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FS = 1_280_000.0           # RTL-SDR broadcast-FM capture rate
BOUND = 0.01               # the reference's cross-implementation bound

# sizes (the apps' defaults and the offline deployment shape)
FM_SECONDS = 20.0                  # 51.2 MB u8 capture
FM_BLOCK = 1_310_720               # apps.fm --block default
OFFLINE_BLOCK = 10 * 1024 * 1024   # u8 bytes per block
OFFLINE_BLOCKS = 32                # Pipeline.process(parallel_blocks=32)
AM_BLOCK = 1_048_576               # apps.am --block default
AM_BLOCKS = 8
WF_BLOCK = 1_048_576               # apps.waterfall --block default
CHAN_SECONDS = 0.5                 # apps.channelizer --seconds default
WIDE_SECONDS = 0.05                # --wideband: 64 x 64,000 = 4.1 M samples


def log(msg):
    print(msg, flush=True)


def check(name, err, tol):
    ok = bool(np.isfinite(err) and err <= tol)
    log(f"  {name}: max abs diff {err:.3e} (tolerance {tol:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: {err} > {tol}")


def tone_hz(audio, rate):
    a = np.asarray(audio, np.float64)[len(audio) // 10:]
    spec = np.abs(np.fft.rfft(a - a.mean()))
    return float(np.argmax(spec) * rate / len(a))


def check_tone(name, audio, rate, want_hz):
    got = tone_hz(audio, rate)
    ok = abs(got - want_hz) <= max(2.0, 2 * rate / len(audio))
    log(f"  {name}: dominant tone {got:.1f} Hz (want {want_hz:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: tone {got} Hz, want {want_hz}")


def read_wav(path):
    with wave.open(path) as wf:
        pcm = np.frombuffer(wf.readframes(wf.getnframes()), "<i2")
        return pcm.astype(np.float64) / 32767.0, wf.getframerate()


def run_app(main, argv):
    """An app's ``main(argv)`` in this process; returns what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"  | {line}")
    if rc:
        raise AssertionError(f"{main.__module__} exited {rc}")
    return out


_HLO_DEF = re.compile(r"\s*(?:ROOT )?%([\w.\-]+) = ")


def _balanced(text, i):
    """Index past the bracket group that opens at ``text[i]``."""
    depth = 0
    for j in range(i, len(text)):
        depth += text[j] in "([{"
        depth -= text[j] in ")]}"
        if depth == 0:
            return j + 1
    return len(text)


def gemm_lowering(fn, *args):
    """What the compiled program's integer (s32-result) dots became: a
    one-line verdict and their cuBLAS custom calls, Triton GEMM fusions
    and dots left to XLA's own code generator, each as
    ``op(operand types) -> result``."""
    shape, ops = {}, []
    for line in fn.lower(*args).compile().as_text().splitlines():
        m = _HLO_DEF.match(line)
        if not m:
            continue
        rest = line[m.end():]
        cut = _balanced(rest, 0) if rest.startswith("(") else rest.find(" ")
        shape[m.group(1)] = re.sub(r"\{[^}]*\}", "", rest[:cut])
        op = rest[cut:].lstrip()
        name = op[: op.find("(")]
        args_ = op[op.find("("): _balanced(op, op.find("("))]
        if "__cublas" in line:
            kind = re.search(r'custom_call_target="([^"]+)"', line).group(1)
        elif "__triton_gemm" in line:
            kind = "triton_gemm fusion"
        elif name == "dot":
            kind = "dot"
        else:
            continue
        ops.append((kind, re.findall(r"%([\w.\-]+)", args_), m.group(1)))
    lines, operand_types = [], []
    for kind, operands, out in ops:
        if not shape[out].lstrip("(").startswith("s32"):
            continue
        types = [shape.get(o, "?") for o in operands]
        operand_types.append((kind, [t.split("[")[0] for t in types]))
        lines.append(f"{kind}({', '.join(types)}) -> {shape[out]}")
    cublas = [t for k, t in operand_types if k.startswith("__cublas")]
    if any(t[:2] == ["s8", "s8"] for t in cublas):
        verdict = "int8 GEMM in cuBLAS"
    elif cublas:
        verdict = f"cuBLAS GEMM on {cublas[0][:2]} operands, not int8"
    elif any(k == "triton_gemm fusion" for k, _ in operand_types):
        verdict = "Triton GEMM fusion"
    else:
        verdict = "no GEMM library call: XLA's own loop code"
    return verdict, list(dict.fromkeys(lines))


def log_gemm_lowering(name, fn, *args):
    verdict, lines = gemm_lowering(fn, *args)
    log(f"  {name} compiles to: {verdict}")
    for line in lines[:12]:
        log(f"    {line}")


def timed(fn, *args, reps=5):
    """Median seconds of ``fn(*args)`` to ``block_until_ready``, after a
    compile-and-warm call outside the window."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def fm_capture(n_samples, tone=700.0, amp=0.9):
    """u8 interleaved IQ of a 75 kHz-deviation FM carrier at baseband
    modulated by one tone (phase in closed form, float64)."""
    t = np.arange(n_samples, dtype=np.float64) / FS
    phase = (75e3 / tone) * (1.0 - np.cos(2 * np.pi * tone * t))
    raw = np.empty(2 * n_samples, np.uint8)
    raw[0::2] = np.clip(np.round(amp * np.cos(phase) * 127 + 128), 0, 255)
    raw[1::2] = np.clip(np.round(amp * np.sin(phase) * 127 + 128), 0, 255)
    return raw


def am_capture(n_samples, if_freq=0.25, tone=500.0):
    """u8 IQ of an AM carrier ``if_freq`` cycles/sample off centre, 50%
    modulated by one tone."""
    n = np.arange(n_samples, dtype=np.float64)
    env = 0.4 * (1.0 + 0.5 * np.sin(2 * np.pi * tone * n / FS))
    x = env * np.exp(2j * np.pi * np.mod(if_freq * n, 1.0))
    raw = np.empty(2 * n_samples, np.uint8)
    raw[0::2] = np.clip(np.round(x.real * 127 + 128), 0, 255)
    raw[1::2] = np.clip(np.round(x.imag * 127 + 128), 0, 255)
    return raw


# --------------------------------------------------------------------------
# phases (one card)
# --------------------------------------------------------------------------

def phase_fm_app(tmp):
    """apps.fm on a 20 s broadcast capture, sequential and --batched 8."""
    from sdr_tpu.apps import fm
    from sdr_tpu.apps.chains import fm_taps
    import oracles
    block = FM_BLOCK
    raw = fm_capture(int(FM_SECONDS * FS))
    path = os.path.join(tmp, "fm.iq")
    raw.tofile(path)
    used = raw[: len(raw) // block * block]
    rf, ars, afl = fm_taps()
    want = oracles.fm_chain_oracle(used, rf, ars, afl, 0.2, block)
    for tag, extra in (("sequential", []), ("batched 8", ["--batched", "8"])):
        wav = os.path.join(tmp, "fm.wav")
        t0 = time.perf_counter()
        rc = fm.main(["--in", path, "--out", wav, "--block", str(block)]
                     + extra)
        dt = time.perf_counter() - t0
        if rc:
            raise AssertionError(f"apps.fm exited {rc}")
        audio, rate = read_wav(wav)
        log(f"  apps.fm {tag}: {len(audio)} samples at {rate} Hz in "
            f"{dt:.2f} s wall (compile included)")
        check_tone(f"fm {tag}", audio, rate, 700.0)
        if audio.shape != want.shape:
            raise AssertionError(f"audio {audio.shape} != {want.shape}")
        check(f"fm {tag} vs float64 reference", float(np.abs(audio - want)
                                                    .max()), BOUND)


def phase_fm_offline():
    """fm_chain() through Pipeline.process(parallel_blocks=32) on
    32 x 10 MiB, the fused front against the plain XLA front, and the
    kernel's time beside XLA's for the same call."""
    import jax
    import jax.numpy as jnp
    from sdr_tpu.apps.chains import fm_chain, fm_taps
    from sdr_tpu.parallel.sharded import run_time_batched
    from sdr_tpu.stream import (Fir, FmDemod, IqConvertU8, Pipeline,
                                U8FrontDemod)
    import oracles
    block, nb = OFFLINE_BLOCK, OFFLINE_BLOCKS
    raw = fm_capture(block * nb // 2)
    rf, ars, afl = fm_taps()
    x = jax.device_put(raw)
    ops = fm_chain()
    log(f"  fm_chain() stages: {[type(o).__name__ for o in ops]}")
    _, y = Pipeline(ops, block_in=block, in_dtype=jnp.uint8).process(
        x, parallel_blocks=nb)
    y = np.asarray(y)
    want = oracles.fm_chain_oracle(raw, rf, ars, afl, 0.2, block)
    log(f"  {nb} x {block} u8 in -> {y.shape[-1]} audio samples")
    check("fm offline vs float64 reference", float(np.abs(y - want).max()),
          BOUND)

    # the front alone: kernel vs the plain XLA stages, same samples.  Both
    # sum the same f32 products in another order (~1e-7 relative on this
    # constant-envelope signal) and share the 5.8e-7 rad polynomial
    # atan2, so 1e-4 rad leaves two orders of margin.
    front_k = [U8FrontDemod(rf, 8)]
    front_x = [IqConvertU8(planar=True), Fir.decimator(rf, 8),
               FmDemod(planar=True, atan2="poly")]
    fk = jax.jit(lambda r: run_time_batched(front_k, r, nb))
    fx = jax.jit(lambda r: run_time_batched(front_x, r, nb))
    check("fused front vs plain XLA front (rad)",
          float(jnp.abs(fk(x) - fx(x)).max()), 1e-4)
    chain_x = fm_chain(front="exact", planar=True)
    ck = jax.jit(lambda r: run_time_batched(ops, r, nb))
    cx = jax.jit(lambda r: run_time_batched(chain_x, r, nb))
    # apps.fm --front quantized: XLA's u8 x s8 -> s32 dot (s8 taps)
    chain_q = fm_chain(front="quantized")
    cq = jax.jit(lambda r: run_time_batched(chain_q, r, nb))
    check("fm offline, quantized front, vs float64 reference",
          float(np.abs(np.asarray(cq(x)) - want).max()), BOUND)
    # what the card runs for the quantized front's u8 x s8 -> s32 dot, and
    # for a plain s8 x s8 -> s32 dot of the same width
    log_gemm_lowering("quantized chain (u8 x s8 -> s32 dot)", cq, x)
    a8 = jnp.ones((1 << 16, 1024), jnp.int8)
    b8 = jnp.ones((1024, 256), jnp.int8)
    log_gemm_lowering("s8 x s8 -> s32 dot [65536, 1024] x [1024, 256]",
                      jax.jit(lambda a, b: jax.lax.dot_general(
                          a, b, (((1,), (0,)), ((), ())),
                          preferred_element_type=jnp.int32)), a8, b8)
    mem = ck.lower(x).compile().memory_analysis()
    log(f"  memory_analysis (fused chain, {nb} x {block} B): {mem}")
    for name, fn in (("fused kernel", fk), ("plain XLA", fx)):
        cost = fn.lower(x).compile().cost_analysis()
        cost = cost[0] if isinstance(cost, list) else cost
        log(f"  front HLO bytes accessed, {name}: "
            f"{cost.get('bytes accessed', float('nan')):.4g}")
    n_in = raw.size // 2
    for name, fn in (("front: fused kernel", fk), ("front: plain XLA", fx),
                     ("chain: fused front", ck),
                     ("chain: plain XLA front", cx),
                     ("chain: quantized front", cq)):
        t = timed(fn, x)
        log(f"  time {name}: {t * 1e3:.3f} ms "
            f"({n_in / t / 1e9:.1f} GS/s complex in)")


def phase_am_app(tmp):
    """apps.am at its default 1,048,576-byte block, 500 Hz tone."""
    from sdr_tpu.apps import am
    from sdr_tpu.ops import design
    import oracles
    block, nb = AM_BLOCK, AM_BLOCKS
    raw = am_capture(block * nb // 2)
    path = os.path.join(tmp, "am.iq")
    raw.tofile(path)
    wav = os.path.join(tmp, "am.wav")
    if am.main(["--in", path, "--out", wav, "--block", str(block)]):
        raise AssertionError("apps.am failed")
    audio, rate = read_wav(wav)
    log(f"  apps.am: {len(audio)} samples at {rate} Hz")
    check_tone("am", audio, rate, 500.0)
    want = oracles.am_chain_oracle(
        raw, 0.25, design.windowed_sinc(64, 1.0 / 16, design.hamming), 16,
        0.005, 0.5)
    check("am vs float64 reference", float(np.abs(audio - want).max()),
          BOUND)


def phase_waterfall():
    """waterfall_chain(1024, 512) at the app's 1,048,576-byte block
    against numpy.fft: f32 FFT rounding, so the bound is relative to the
    largest bin (1e-4)."""
    import jax.numpy as jnp
    from sdr_tpu.apps.chains import waterfall_chain
    from sdr_tpu.ops import design
    from sdr_tpu.stream import Pipeline
    import oracles
    raw = fm_capture(4 * WF_BLOCK // 2)
    _, rows = Pipeline(waterfall_chain(1024, 512), block_in=WF_BLOCK,
                       in_dtype=jnp.uint8).process(jnp.asarray(raw))
    rows = np.asarray(rows)
    want = oracles.waterfall_oracle(raw, design.blackman(1024), 512)
    log(f"  waterfall rows {rows.shape}")
    if rows.shape != want.shape:
        raise AssertionError(f"rows {rows.shape} != {want.shape}")
    check("waterfall vs numpy.fft (relative to max bin)",
          float(np.abs(rows - want).max() / want.max()), 1e-4)


def phase_channelizer(tmp):
    """apps.channelizer --channels 64 on one card; three channels'
    audio against the float64 reference and their tones."""
    from sdr_tpu.apps import channelizer
    from sdr_tpu.apps.chains import fm_taps
    import oracles
    prefix = os.path.join(tmp, "chan")
    if channelizer.main(["--channels", "64", "--synthetic",
                         "--seconds", str(CHAN_SECONDS),
                         "--out-prefix", prefix]):
        raise AssertionError("apps.channelizer failed")
    n = int(FS * CHAN_SECONDS) // 80 * 80
    x = channelizer.synthesize(64, n, FS)
    rf, ars, afl = fm_taps()
    # tones 200 + 150c Hz: channels above ~48 sit past the audio filter's
    # 7.5 kHz band edge, so check three inside it
    for c in (0, 20, 40):
        audio, rate = read_wav(f"{prefix}{c:03d}.wav")
        check_tone(f"channel {c}", audio, rate, 200.0 + 150.0 * c)
        y = oracles.decimate_stream(rf, 8, x[c].astype(np.complex128))
        y = np.angle(y * np.conj(np.concatenate([[0j], y[:-1]])))
        y = oracles.resample_stream(ars, 3, 10, y, len(y))
        want = 0.2 * oracles.filter_stream(afl, y)
        check(f"channel {c} vs float64 reference",
              float(np.abs(audio - want).max()), BOUND)


# --------------------------------------------------------------------------
# --multi: the sharded paths on four cards against one card
# --------------------------------------------------------------------------

def check_wavs(name, prefix, want, tol):
    """Every channel's WAV (16-bit, so within 1.6e-5 of its samples)
    against ``want [channels, n]``."""
    got = np.stack([read_wav(f"{prefix}{c:03d}.wav")[0]
                    for c in range(want.shape[0])])
    if got.shape != want.shape:
        raise AssertionError(f"{name}: {got.shape} != {want.shape}")
    check(name, float(np.abs(got - want).max()), tol)


def phase_multi(tmp):
    """apps.channelizer, channel-sharded and (--wideband) time-sharded
    over every visible card, and the FM chain time-sharded over a 1-D mesh
    of 4 cards, each against the same input on one card; tolerances as
    tests/test_parallel.py."""
    import jax
    import jax.numpy as jnp
    from sdr_tpu import parallel
    from sdr_tpu.apps import channelizer
    from sdr_tpu.apps.chains import channelizer_chain, fm_chain
    from sdr_tpu.stream import Pipeline
    n_dev = len(jax.devices())
    if n_dev != 4:
        raise AssertionError(f"--multi needs 4 GPUs, found {n_dev}")

    prefix = os.path.join(tmp, "chan")
    out = run_app(channelizer.main, [
        "--channels", "64", "--synthetic", "--seconds", str(CHAN_SECONDS),
        "--out-prefix", prefix])
    if "on 4 devices" not in out:
        raise AssertionError("apps.channelizer did not shard over 4 cards")
    n = int(FS * CHAN_SECONDS) // 80 * 80
    x = jax.device_put(channelizer.synthesize(64, n, FS))
    one = parallel.run_channel_sharded(
        channelizer_chain(64),
        parallel.make_mesh((1,), ("c",), jax.devices()[:1]), x)
    check_wavs("apps.channelizer on 4 cards vs 1 card", prefix,
               np.asarray(one), 1e-4)

    prefix = os.path.join(tmp, "wide")
    out = run_app(channelizer.main, [
        "--channels", "64", "--synthetic", "--wideband",
        "--seconds", str(WIDE_SECONDS), "--out-prefix", prefix])
    if "on 4 devices" not in out:
        raise AssertionError("apps.channelizer --wideband did not shard "
                             "over 4 cards")
    n = int(FS * WIDE_SECONDS) // 80 * 80
    wide = channelizer.stack_wideband(channelizer.synthesize(64, n, FS))
    _, seq = Pipeline(channelizer_chain(64, wideband=True),
                      block_in=wide.shape[-1] // 4,
                      in_dtype=jnp.complex64).process(jax.device_put(wide))
    check_wavs("apps.channelizer --wideband on 4 cards vs sequential on "
               "1 card", prefix, np.asarray(seq), 1e-3)

    block = OFFLINE_BLOCK
    raw = jax.device_put(fm_capture(4 * block // 2))
    ops = fm_chain()
    got = parallel.run_time_sharded(ops, parallel.time_mesh(4), raw)
    _, seq = Pipeline(ops, block_in=block, in_dtype=jnp.uint8).process(raw)
    log(f"  time-sharded FM chain: {got.shape} over 4 cards")
    check("fm chain 4 cards vs Pipeline.process",
          float(np.abs(np.asarray(got) - np.asarray(seq)).max()), 1e-4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded paths, on four GPUs")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU found: JAX platform is {devs[0].platform!r}",
              file=sys.stderr)
        return 2
    try:
        sys.path.insert(0, ROOT)
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from sdr_tpu.utils import enable_compile_cache
        import oracles  # noqa: F401
    except ImportError as e:
        print(f"sdr_tpu not found beside {__file__}: {e}", file=sys.stderr)
        return 3
    log(f"compile cache: {enable_compile_cache()}")
    dev = devs[0]
    log(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(devs)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    log(smi)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    if args.multi:
        phases = [("multi", lambda: phase_multi(tmp))]
    else:
        phases = [("fm app", lambda: phase_fm_app(tmp)),
                  ("fm offline", phase_fm_offline),
                  ("am app", lambda: phase_am_app(tmp)),
                  ("waterfall", phase_waterfall),
                  ("channelizer app", lambda: phase_channelizer(tmp))]
    failed = []
    try:
        for name, fn in phases:
            log(f"[phase] {name}")
            t0 = time.perf_counter()
            try:
                fn()
            except Exception:
                traceback.print_exc()
                failed.append(name)
            log(f"[phase] {name}: {'FAILED' if name in failed else 'ok'} "
                f"in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
