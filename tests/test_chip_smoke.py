"""chip_smoke.py and bench.py on the CPU: every phase function at tiny
sizes, the refusal to run without a GPU, and the compile-cache placement
their entry points share."""

import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import bench
import chip_smoke
from mercury_tpu import compile_cache

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("cfg", [9, 0])
def test_phase_decode_tiny(cfg):
    """Noise sweep and carrier-offset sweep both decode every row (CONFIG_0
    exercises the coherent deep scan and pilot arbitration)."""
    rec = chip_smoke.phase_decode(cfg, batch=2, reps=1)
    assert rec["config"] == cfg and rec["batch"] == 2
    assert rec["ms_per_call"] > 0 and rec["msamples_per_s"] > 0


def test_phase_served_tiny():
    rec = chip_smoke.phase_served(cfg=16, n_channels=4, rounds=2)
    assert rec["channels"] == 4 and rec["realtime_channels"] > 0


def test_phase_arq_tiny(monkeypatch, tmp_path):
    # the CLI enables the persistent compile cache; point it away from the
    # checkout for this process
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    rec = chip_smoke.phase_arq(snr_db=25.0, n_bytes=300)
    assert rec["bytes"] == 300 and rec["wall_s"] > 0


def test_parity_formulations_tiny():
    rec = chip_smoke.parity_formulations(batch=2, cfgs=(9,))
    errs = {k: v for k, v in rec.items() if not k.startswith("ldpc")}
    assert errs and max(errs.values()) < 1e-4      # full f32 on the CPU
    assert rec["ldpc_rate8_bits_equal"]


def test_parity_deep_scans_tiny():
    rec = chip_smoke.parity_deep_scans(batch=2)
    assert max(rec.values()) < 1e-4


def test_parity_chain_tiny():
    assert chip_smoke.parity_chain(9, batch=2) == {"cfg9_chain_rows_equal": 2}


def test_smoke_failure_is_raised():
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke._check(False, "wrong output")


def test_main_refuses_without_gpu(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jax.devices()[0].platform != "gpu"
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and out.strip() == ""


def test_main_outside_the_repo_fails(tmp_path):
    """chip_smoke.py alone, without the package beside it, exits non-zero
    and prints no result line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_bench_refuses_without_gpu(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert bench.main() == 1
    assert "rx_demod_ldpc" not in capsys.readouterr().out


@pytest.mark.parametrize("env_dir", [None, "set"])
def test_compile_cache_placement(monkeypatch, tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set the cache is JAX's and nothing is
    configured here; unset, it is the fixed directory in the checkout,
    which .gitignore lists."""
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert compile_cache.enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = compile_cache.enable_compile_cache()
            assert path == str(REPO / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
            assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_capture_batch_places_and_shifts():
    """capture_batch puts each frame at its own delay and moves its spectrum
    by its own carrier offset (a tone lands exactly on the shifted bin)."""
    from mercury_tpu.channel import sim

    fs, n, buf_len = 48000.0, 4800, 12000
    t = np.arange(n) / fs
    frames = np.stack([np.cos(2 * np.pi * 1500.0 * t),
                       np.cos(2 * np.pi * 2000.0 * t)]).astype(np.float32)
    delays = np.array([1000, 6000])
    offsets = np.array([50.0, -120.0])
    buf = np.asarray(sim.capture_batch(jax.random.key(0), frames, delays,
                                       buf_len, 0.0, fs, offsets))
    assert buf.shape == (2, buf_len) and buf.dtype == np.float32
    for row, (d, f0, df) in enumerate(zip(delays, (1500.0, 2000.0), offsets)):
        before = buf[row, : d - 200]                        # silence before
        assert np.sum(before ** 2) < 1e-3 * np.sum(frames[row] ** 2)
        seg = buf[row, d + 200: d + 200 + 4000]
        spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
        peak = np.argmax(spec) * fs / len(seg)
        assert abs(peak - (f0 + df)) <= fs / len(seg)


def test_capture_batch_noise_level():
    from mercury_tpu.channel import sim

    frames = np.zeros((3, 100), np.float32)
    buf = np.asarray(sim.capture_batch(jax.random.key(1), frames,
                                       np.zeros(3, np.int32), 50000, 0.3))
    assert np.isfinite(buf).all()
    assert abs(buf.std() - 0.3) < 0.01
