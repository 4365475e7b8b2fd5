"""Tests for sources, plot consumers, device dispatch, profiling."""

import numpy as np
import pytest

from sdr_tpu.stream import (stream_string, stream_random, fork, devnull,
                            tone, noise, fm_mod)
from sdr_tpu.io import plot_line, plot_fill, Waterfall
from sdr_tpu.utils import best_method, device_kind, timed, trace
from sdr_tpu import ops


def test_stream_string_bits():
    it = stream_string(b"\x01\x80", 16)
    blk = next(it)
    # LSB-first: byte 0x01 -> bit0=1 others 0; 0x80 -> bit7=1
    want = np.full(16, -1.0, np.float32)
    want[0] = 1.0
    want[15] = 1.0
    np.testing.assert_array_equal(blk, want)
    # repeats
    np.testing.assert_array_equal(next(it), want)


def test_stream_string_wraps_mid_block():
    it = stream_string(b"\xff", 12)
    np.testing.assert_array_equal(next(it), np.ones(12, np.float32))


def test_stream_random():
    it = stream_random(256, seed=1)
    a, b = next(it), next(it)
    assert set(np.unique(a)) <= {-1.0, 1.0}
    assert not np.array_equal(a, b)


def test_fork_and_devnull():
    seen = []
    fork([np.zeros(4)] * 3, seen.append, seen.append)
    assert len(seen) == 6
    assert devnull(iter([1, 2, 3])) == 3


def test_tone_noise_fm_mod():
    t = tone(0.1, 1000)
    spec = np.abs(np.fft.fft(t))
    assert np.argmax(spec) == 100
    n = noise(1000, scale=2.0)
    assert abs(np.sqrt(np.mean(np.abs(n) ** 2)) - 2.0) < 0.2
    audio = np.sin(2 * np.pi * 0.01 * np.arange(1000))
    iq = fm_mod(audio, 0.1, 1.0)
    y, _ = ops.fm_demod(iq)
    np.testing.assert_allclose(np.asarray(y)[1:],
                               2 * np.pi * 0.1 * audio[1:], atol=1e-2)


def test_plots(tmp_path, rng):
    y = rng.normal(size=256)
    plot_line(y, str(tmp_path / "l.png"), title="t")
    plot_fill(np.abs(y), str(tmp_path / "f.png"))
    wf = Waterfall(64, rows=32)
    for _ in range(5):
        wf.push(rng.uniform(0.1, 1.0, (3, 64)))
    wf.save(str(tmp_path / "w.png"))
    for f in ["l.png", "f.png", "w.png"]:
        assert (tmp_path / f).stat().st_size > 500


def test_best_method_cpu():
    assert best_method(64, 8) in {"conv", "direct"}
    assert isinstance(device_kind(), str)


def test_tuning_table_dispatch(tmp_path, monkeypatch):
    """On the GPU one fixed path (conv won every family measured on the
    card); on the CPU the argmax over the measured rate table, small
    problems taking the gather path; any other family is an error."""
    from sdr_tpu.utils import tuning
    assert tuning.best_method("gpu", 64) == "conv"
    assert tuning.best_method("gpu", 51, factor=8) == "conv"
    assert tuning.best_method("gpu", 64, factor=16) == "conv"
    assert tuning.best_resample_method("gpu", 31, 3, 10) == "conv"
    assert tuning.best_method("cpu", 32, num=100) == "direct"
    assert tuning.best_resample_method("cpu", 31, 3, 10, num=100) == "direct"
    with pytest.raises(ValueError, match="no measured dispatch table"):
        tuning.best_method("metal", 32)
    assert tuning.best_method("cpu", 32) == "conv"
    # runtime override of the CPU table via SDR_TPU_TUNING_JSON
    p = tmp_path / "t.json"
    p.write_text('{"cpu": {"filter": {"direct": {"32": 9e99}}}}')
    monkeypatch.setenv("SDR_TPU_TUNING_JSON", str(p))
    assert tuning.best_method("cpu", 32) == "direct"
    assert tuning.best_method("gpu", 32) == "conv"


def test_timed_and_trace(capsys):
    with timed("x"):
        pass
    assert "x:" in capsys.readouterr().out
    with trace("region"):
        pass


def test_axes_helpers():
    from sdr_tpu.io import zero_axis, centered_axis
    z = zero_axis(8, 48000)
    assert z[0] == 0 and z[1] == 6000
    c = centered_axis(8, 48000)
    assert c[4] == 0 and c[0] == -24000


class _FakeDevice:
    def __init__(self, platform):
        self.platform = platform
        self.device_kind = platform


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_device_family_known(monkeypatch, platform):
    import jax
    from sdr_tpu.utils import device_family
    monkeypatch.setattr(jax, "devices", lambda: [_FakeDevice(platform)])
    assert device_family() == platform


@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_device_family_unknown_raises(monkeypatch, platform):
    import jax
    from sdr_tpu.utils import device_family
    monkeypatch.setattr(jax, "devices", lambda: [_FakeDevice(platform)])
    with pytest.raises(RuntimeError, match="unsupported device platform"):
        device_family()


def test_device_family_here_is_cpu():
    from sdr_tpu.utils import device_family
    assert device_family() == "cpu"


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and the helper sets nothing."""
    import jax
    from sdr_tpu.utils import enable_compile_cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_repo_dir(monkeypatch):
    """Without the variable the cache is the fixed <repo>/.jax_cache."""
    import os
    import jax
    from sdr_tpu.utils import enable_compile_cache
    from sdr_tpu.utils.cache import REPO_CACHE
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = enable_compile_cache()
        assert path == REPO_CACHE
        assert path == os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
