#!/usr/bin/env python
"""Smoke test of the receive chain on one NVIDIA GPU, at deployment sizes.

    python chip_smoke.py           # phases 1-8 below, on jax.devices()[0]
    python chip_smoke.py --multi   # only the two 4-GPU receive paths

Single-card phases, all in this one process:

  1. device check: jax.devices()[0] must be a GPU
  2. CONFIG_9, batch 256: TX -> AWGN at Es/N0 12 dB -> RxChain.receive
  3. CONFIG_0, batch 256: coherent deep scan + pilot arbitration
  4. CONFIG_3, batch 256: noncoherent deep scan
  5. ROBUST_0, batch 64: MFSK
  6. served path: FusedDevicePool at 256 CONFIG_9 channels
  7. ARQ: a two-node session through `python -m mercury_tpu -m SIM`
  8. parity: each formulation the GPU picks against its plain reference,
     and the whole chain on the GPU against a CPU run of the same buffers

Decode phases use random frame delays, a random carrier offset per row and
an SNR about 10 dB above the mode's documented threshold; every row must
pass CRC and return the payload that was sent. Each phase prints one line
with compile seconds, ms per call, Msamples/s and the device's
peak_bytes_in_use so far. A failing check raises: the process then exits
non-zero and prints no result line. The last line of standard output is
one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np

# documented thresholds (effective per-carrier Es/N0 for OFDM, channel SNR
# for MFSK) of the modes the phases run; the OFDM passband parameter sits
# 5 dB above the effective value (docs/esn0_reconciliation.md)
DOCUMENTED_DB = {0: -10.0, 3: -4.5, 100: -13.0}
# CONFIG_9 runs at the headline benchmark's Es/N0
CFG9_ESN0_DB = 12.0
PASSBAND_OFFSET_DB = 5.0
# Carrier offsets get their own sweep at a high SNR: at 10 dB above
# threshold the OFDM chain loses 10-20% of rows to its fine CFO estimate
# once the offset is not zero (a receiver limit, the same on the CPU), so
# offsets and threshold noise are checked apart.
OFDM_CFO_MAX_HZ = 120.0
CFO_SWEEP_DB = 25.0
# the matched filter's delay grid (2 x interp samples, interp = 4 in every
# mode): frame starts on it cannot tie between two grid points
MF_GRID = 8


class SmokeFailure(RuntimeError):
    """A phase's output is wrong."""


def card_identity() -> str:
    """The card's name and power limit from nvidia-smi, run as a child that
    does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def peak_bytes(device=None):
    import jax

    stats = (device or jax.devices()[0]).memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _time_calls(fn, arg, reps: int):
    """(compile_s, ms_per_call, result): the first call compiles and runs;
    the median of `reps` further calls, each waited for, is the call time."""
    import jax

    t0 = time.perf_counter()
    res = jax.block_until_ready(fn(arg))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = jax.block_until_ready(fn(arg))
        times.append(time.perf_counter() - t0)
    call_s = float(np.median(times)) if times else first
    return max(first - call_s, 0.0), call_s * 1e3, res


def phase_snr_db(cfg: int) -> float:
    """The harness parameter about 10 dB above the documented threshold
    (CONFIG_9: the benchmark's 12 dB)."""
    from mercury_tpu.core.geometry import build_geometry

    if cfg == 9:
        return CFG9_ESN0_DB
    off = 0.0 if build_geometry(cfg, with_pre_eq=False).spec.is_mfsk \
        else PASSBAND_OFFSET_DB
    return DOCUMENTED_DB[cfg] + off + 10.0


def make_capture(cfg: int, batch: int, snr_db: float, seed: int,
                 delay_grid: int = 1, cfo: bool = False):
    """(geometry, payload [B, bytes], delays [B], capture [B, buffer]) for
    `batch` random payloads at random delays. With `cfo`, each row also
    gets a random carrier offset: inside +-120 Hz for OFDM; for MFSK, which
    has no carrier-offset correction, at most a tenth of a tone spacing.
    MFSK delays are symbol-aligned; delay_grid rounds OFDM delays to a
    multiple of that many samples."""
    import jax

    from mercury_tpu.channel import sim
    from mercury_tpu.core.geometry import build_geometry
    from mercury_tpu.modem.tx import TxChain

    g = build_geometry(cfg)
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, (batch, g.frame_bytes)).astype(np.uint8)
    frames = TxChain(g).transmit(payload)
    buf_len = g.nofdm * g.buffer_nsymb * g.interp
    sym = g.nofdm * g.interp
    slack = buf_len - frames.shape[1]
    if g.spec.is_mfsk:
        delays = rng.integers(1, slack // sym, batch) * sym
        cfo_max = 0.1 * g.fs / (g.interp * g.nfft)
        sigma = sim.sigma_for_channel_snr(np.asarray(frames[0]), snr_db,
                                          g.fs, g.bandwidth)
    else:
        delays = rng.integers(sym, slack - sym, batch)
        delays = delays // delay_grid * delay_grid
        cfo_max = OFDM_CFO_MAX_HZ
        sigma = sim.sigma_for_esn0(snr_db)
    offsets = rng.uniform(-cfo_max, cfo_max, batch) if cfo else None
    buf = sim.capture_batch(jax.random.key(seed), frames, delays, buf_len,
                            sigma, g.fs, offsets)
    return g, payload, delays.astype(np.int64), buf


def check_decoded(g, res, payload, delays) -> None:
    ok = np.asarray(res.crc_ok)
    _check(bool(ok.all()), f"CRC failed on {int((~ok).sum())}/{ok.size} rows")
    got = np.asarray(res.payload)
    _check(bool((got == payload).all()), "decoded payload differs from sent")
    if not g.spec.is_mfsk:
        err = np.abs(np.asarray(res.delay) - delays)
        _check(int(err.max()) <= g.ngi * g.interp,
               f"frame start off by up to {int(err.max())} samples")


def phase_decode(cfg: int, batch: int, reps: int = 3, seed: int = 0) -> dict:
    """TX -> channel -> RxChain.receive for one mode at one batch size,
    twice on one compiled program: random delays at about 10 dB above the
    threshold (timed), then random delays and carrier offsets at
    CFO_SWEEP_DB."""
    from mercury_tpu.modem.rx import RxChain

    snr = phase_snr_db(cfg)
    g, payload, delays, buf = make_capture(cfg, batch, snr, seed)
    rx = RxChain(g)
    compile_s, ms, res = _time_calls(rx.receive, buf, reps)
    check_decoded(g, res, payload, delays)
    snr_cfo = snr if g.spec.is_mfsk else CFO_SWEEP_DB
    g, payload, delays, buf = make_capture(cfg, batch, snr_cfo, seed + 1,
                                           cfo=True)
    check_decoded(g, rx.receive(buf), payload, delays)
    return {"config": cfg, "batch": batch, "snr_db": snr,
            "cfo_sweep_snr_db": snr_cfo,
            "compile_s": round(compile_s, 3), "ms_per_call": round(ms, 3),
            "msamples_per_s": round(buf.size / ms / 1e3, 3)}


def phase_served(cfg: int = 9, n_channels: int = 256, rounds: int = 3,
                 seed: int = 1) -> dict:
    """FusedDevicePool in lockstep: each round feeds every channel one new
    frame; every fed frame must be decoded exactly once, in its round."""
    from mercury_tpu.core.geometry import build_geometry
    from mercury_tpu.modem.tx import TxChain
    from mercury_tpu.scale.serve import FusedDevicePool

    g = build_geometry(cfg)
    pool = FusedDevicePool(g, n_channels)
    sym, frame_syms, buf_syms = pool.sym_len, pool.frame_syms, g.buffer_nsymb
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, (rounds, n_channels, g.frame_bytes)
                           ).astype(np.uint8)
    frames = np.asarray(TxChain(g).transmit(
        payload.reshape(rounds * n_channels, -1)), np.float32
    ).reshape(rounds, n_channels, -1)
    # a frame sits at the same window position every round and leaves the
    # window before the next round decodes, so the re-arm countdown lets
    # each round decode exactly the frame it fed
    lead = 2
    chunk_syms = max(frame_syms + lead + 2,
                     -(-(buf_syms + frame_syms + lead) // 2))
    chunk = chunk_syms * sym
    noise = (2e-3 * rng.standard_normal((n_channels, chunk))).astype(np.float32)
    blocks = []
    for r in range(rounds):
        blk = noise.copy()
        blk[:, lead * sym: lead * sym + frames.shape[-1]] += frames[r]
        blocks.append(blk)
    prime = np.zeros((n_channels, max(buf_syms - chunk_syms, 0) * sym),
                     np.float32)
    _check(not pool.unpack(pool.round(prime)), "decoded a frame from silence")

    times, decoded = [], 0
    first = None
    for r in range(rounds):
        t0 = time.perf_counter()
        out = pool.unpack(pool.round(blocks[r]))
        dt = time.perf_counter() - t0
        if first is None:
            first = dt
        else:
            times.append(dt)
        chans = sorted(c for c, _ in out)
        _check(chans == list(range(n_channels)),
               f"round {r}: {len(chans)}/{n_channels} channels decoded")
        for c, res in out:
            _check(bytes(np.asarray(res.payload)[0]) == bytes(payload[r, c]),
                   f"round {r} channel {c}: wrong payload")
        decoded += len(out)
    _check(decoded == rounds * n_channels, "a frame was decoded twice")
    ms = float(np.median(times)) * 1e3 if times else first * 1e3
    return {"config": cfg, "channels": n_channels, "rounds": rounds,
            "compile_s": round(max(first - ms / 1e3, 0.0), 3),
            "ms_per_call": round(ms, 3),
            "msamples_per_s": round(n_channels * pool.buf_len / ms / 1e3, 3),
            "realtime_channels": int(n_channels * chunk / (ms / 1e3) / g.fs)}


def phase_arq(snr_db: float = 25.0, n_bytes: int = 2000) -> dict:
    """A two-node ARQ session through the command-line entry point."""
    from mercury_tpu.__main__ import main as cli_main

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["-m", "SIM", "--snr", str(snr_db),
                       "--bytes", str(n_bytes)])
    wall = time.perf_counter() - t0
    text = out.getvalue()
    _check(rc == 0 and f"{n_bytes}/{n_bytes} bytes (OK)" in text,
           "ARQ session did not deliver every byte: " + text[-300:])
    return {"snr_db": snr_db, "bytes": n_bytes, "wall_s": round(wall, 3),
            "compile_s": None, "ms_per_call": None, "msamples_per_s": None}


def _rel_err(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _on_cpu_backend():
    """Context in which JAX code traces as the CPU backend would: the
    formulation choices keyed on jax.default_backend() take their CPU
    branch, and new arrays live on the CPU device."""
    import jax

    stack = contextlib.ExitStack()
    stack.enter_context(jax.default_device(jax.devices("cpu")[0]))
    stack.enter_context(mock.patch.object(jax, "default_backend",
                                          return_value="cpu"))
    return stack


def parity_formulations(batch: int = 16, cfgs=(0, 9), seed: int = 2) -> dict:
    """Each formulation the accelerator picks against its plain reference,
    at the widths of each config in `cfgs`. Returns max errors relative to
    the reference's peak magnitude."""
    import jax.numpy as jnp

    from mercury_tpu.core.geometry import build_geometry
    from mercury_tpu.dsp import ops
    from mercury_tpu.fec import ldpc
    from mercury_tpu.fec.tables import load_code

    rng = np.random.default_rng(seed)
    out = {}
    # Float32 matmuls at default precision may run with TF32 operands
    # (10-bit mantissa, rounding ~2^-11 relative) on the GPU. Outputs of
    # such products keep ~1e-3 of their peak magnitude: tolerance 4e-3.
    # Full-f32 routes reach ~1e-6. bf16 operands (LDPC) are checked by
    # their decisions, not their values.
    mm_tol = 4e-3
    for cfg in cfgs:
        g = build_geometry(cfg, with_pre_eq=False)
        n = g.nofdm * g.buffer_nsymb * g.interp
        pb = rng.standard_normal((batch, n)).astype(np.float32)
        w = 2 * np.pi * g.fc / g.fs
        # time-sync FIR: mixer folded into Toeplitz taps vs mix -> conv
        got = ops.fir_same_strided_mix_mm(jnp.asarray(pb), g.fir_rx_ts, 4, w,
                                          float(np.sqrt(2.0)))
        t = np.arange(n, dtype=np.float64)
        osc = (np.sqrt(2.0) * np.exp(1j * w * t)).astype(np.complex64)
        with _on_cpu_backend():
            ref = ops.fir_same_strided(jnp.asarray(pb) * jnp.asarray(osc),
                                       jnp.asarray(g.fir_rx_ts, jnp.float32), 4)
        out[f"cfg{cfg}_fir_ts_mix_mm"] = _rel_err(got, ref)
        # data FIR over a frame segment: Toeplitz vs conv (real taps)
        seg = pb[:, : g.nofdm * g.nsymb * g.interp + len(g.fir_rx_data) - 1]
        n_out = (seg.shape[-1] - (len(g.fir_rx_data) - 1)) // g.interp
        got = ops.fir_decimate_mm(jnp.asarray(seg), g.fir_rx_data, g.interp,
                                  n_out)
        with _on_cpu_backend():
            ref = ops.fir_decimate_segment(
                jnp.asarray(seg), jnp.asarray(g.fir_rx_data, jnp.float32),
                g.interp)[:, :n_out]
        out[f"cfg{cfg}_fir_data_mm"] = _rel_err(got, ref)
        # OFDM demodulator: DFT matmul with the depad fold vs FFT
        sym = (rng.standard_normal((batch, g.nsymb, g.nofdm))
               + 1j * rng.standard_normal((batch, g.nsymb, g.nofdm))
               ).astype(np.complex64)
        got = ops.ofdm_demod(jnp.asarray(sym), g.pad_map, g.nfft, g.ngi,
                             use_mm=True)
        ref = np.fft.fft(sym[..., g.ngi: g.ngi + g.nfft].astype(np.complex128),
                         axis=-1)[..., np.asarray(g.pad_map)] / g.nfft
        out[f"cfg{cfg}_dft_mm"] = _rel_err(got, ref)
        # Schmidl-Cox box sums at the receiver's base rate and candidate
        # stride: Toeplitz matmul vs float64 cumsum
        length, stride = g.ngi + g.nfft // 2, 4
        x = rng.standard_normal((batch, n // g.interp)).astype(np.float32)
        n_box = (x.shape[-1] - length) // stride + 1
        got = ops.box_sum_valid(jnp.asarray(x), length, n_box, use_mm=True,
                                stride=stride)
        c = np.concatenate([np.zeros((batch, 1)),
                            np.cumsum(x.astype(np.float64), axis=-1)], axis=-1)
        idx = stride * np.arange(n_box)
        ref = c[:, idx + length] - c[:, idx]
        # relative to the worst-case sum length*max|x|, not to the sums
        out[f"cfg{cfg}_box_sum_mm"] = float(
            np.max(np.abs(np.asarray(got) - ref)) / (length * np.abs(x).max()))
    for key, err in out.items():
        _check(err <= mm_tol, f"{key}: relative error {err:.2e} > {mm_tol}")

    # LDPC: bf16 layered matmul decoder vs the flooding decoder (float32,
    # CPU formulation) on the same noisy codewords — equal hard decisions
    for rate in sorted({build_geometry(c, with_pre_eq=False).spec.ldpc_rate_num
                        for c in cfgs}):
        code = load_code(rate)
        u = rng.integers(0, 2, (batch, code.k))
        cw = np.asarray(ldpc.encode(code, jnp.asarray(u)))
        sigma = {1: 1.2, 8: 0.6}.get(rate, 0.6)
        y = (1 - 2 * cw) + sigma * rng.standard_normal(cw.shape)
        llr = (2 / sigma ** 2 * y).astype(np.float32)
        b_mm, _i, ok_mm = ldpc.decode_mm(jnp.asarray(llr), rate)
        with _on_cpu_backend():
            b_fl, _i, ok_fl = ldpc.decode(jnp.asarray(llr), rate)
        _check(bool(np.asarray(ok_mm).all() and np.asarray(ok_fl).all()),
               f"LDPC rate {rate}/16: a decoder did not converge")
        _check(bool((np.asarray(b_mm) == np.asarray(b_fl)).all()
                    and (np.asarray(b_mm)[:, :code.k] == u).all()),
               f"LDPC rate {rate}/16: decoders disagree")
        out[f"ldpc_rate{rate}_bits_equal"] = True
    return out


def parity_deep_scans(batch: int = 16, seed: int = 3, coh_cfg: int = 0,
                      nc_cfg: int = 3) -> dict:
    """The deep-acquisition scans at the widths RxChain gives them, against
    the float64 NumPy correlation (modem.sync_ref): the coherent scan of
    coh_cfg and the noncoherent scan of nc_cfg, on noisy segments with a
    planted preamble per row."""
    import jax.numpy as jnp

    from mercury_tpu.core.geometry import build_geometry
    from mercury_tpu.modem import sync, sync_ref
    from mercury_tpu.modem.rx import RxChain

    rng = np.random.default_rng(seed)
    out = {}
    # Scores are normalized correlations in [0, Lp]. float32 FFT rounding
    # leaves ~1e-5 of them; bf16 would leave ~1e-2: tolerance 1e-3 absolute.
    tol = 1e-3
    for name, cfg in (("coherent", coh_cfg), ("noncoherent", nc_cfg)):
        g = build_geometry(cfg, with_pre_eq=False)
        rx = RxChain(g)
        tmpl = rx._mf_templates
        mf_d = 2 * g.interp
        lp, s_tmpl = tmpl.shape
        tmpl_d = tmpl[:, ::mf_d]
        s_d = tmpl_d.shape[-1]
        n_gd = (g.nofdm * g.buffer_nsymb) // 2
        win = (n_gd - lp * s_d) // 2
        seg_len = 2 * win + lp * s_d
        t_d = np.arange(s_d) * mf_d
        if name == "coherent":
            grid = np.arange(-30, 31) * 4.0
            t_abs = t_d[None, :] + np.arange(lp)[:, None] * s_tmpl
            bank = np.stack([tmpl_d * np.exp(-2j * np.pi * f * t_abs / g.fs)
                             for f in grid]).reshape(len(grid), 1, lp * s_d)
        else:
            grid = np.arange(-4, 5) * 30.0
            bank = np.stack([tmpl_d * np.exp(-2j * np.pi * f * t_d / g.fs)[None]
                             for f in grid])
        bank = bank.astype(np.complex64)
        # noise at twice the template's amplitude: a preamble 6 dB under
        # the noise, still far above the correlation's detection floor
        amp = 2.0 * np.sqrt(np.mean(np.abs(bank) ** 2) / 2.0)
        seg = (rng.standard_normal((batch, seg_len))
               + 1j * rng.standard_normal((batch, seg_len))) * amp
        lags = rng.integers(0, 2 * win, batch)
        rows = rng.integers(0, len(grid), batch)
        for i in range(batch):
            seg[i, lags[i]: lags[i] + lp * s_d] += bank[rows[i]].reshape(-1)
        seg = seg.astype(np.complex64)
        ref = sync_ref.bank_scores(seg, bank, win)
        if name == "coherent":
            smax, _sarg = sync.coherent_scan_max(jnp.asarray(seg), bank, win)
            got = np.asarray(smax)
            ref = ref.max(axis=1)
        else:
            got = np.asarray(sync.bank_scores(jnp.asarray(seg), bank, win,
                                              use_mm=False))
        err = float(np.max(np.abs(got - ref)))
        out[f"{name}_cfg{cfg}_max_abs_err"] = err
        _check(err <= tol, f"{name} scan: score error {err:.2e} > {tol}")
        peak = got.reshape(batch, -1).argmax(-1) % got.shape[-1]
        _check(bool((peak == lags).all()),
               f"{name} scan: planted lag not found on every row")
    return out


def parity_chain(cfg: int, batch: int = 16, seed: int = 4) -> dict:
    """Whole chain on the accelerator vs a CPU-backend run (CPU device, CPU
    formulations) of the same buffers: payload, crc_ok and delay equal.
    Delays sit on the matched filter's 2*interp grid so that a delay is
    never a tie between two grid points."""
    import jax

    from mercury_tpu.modem.rx import RxChain

    g, payload, delays, buf = make_capture(cfg, batch, phase_snr_db(cfg), seed,
                                           delay_grid=MF_GRID)
    buf = np.asarray(buf)
    res = RxChain(g).receive(buf)
    check_decoded(g, res, payload, delays)
    with _on_cpu_backend():
        res_c = RxChain(g).receive(buf)
        res_c = jax.tree_util.tree_map(np.asarray, res_c)
    for field in ("payload", "crc_ok", "delay"):
        a = np.asarray(getattr(res, field))
        b = np.asarray(getattr(res_c, field))
        _check(bool((a == b).all()),
               f"cfg{cfg}: {field} differs between the accelerator and CPU "
               f"on {int((a != b).reshape(batch, -1).any(-1).sum())} rows")
    return {f"cfg{cfg}_chain_rows_equal": batch}


def phase_parity(batch: int = 16) -> dict:
    t0 = time.perf_counter()
    rec = {}
    rec.update(parity_formulations(batch))
    rec.update(parity_deep_scans(batch))
    for cfg in (9, 0):
        rec.update(parity_chain(cfg, batch))
    return {"wall_s": round(time.perf_counter() - t0, 3), "compile_s": None,
            "ms_per_call": None, "msamples_per_s": None, **rec}


def phase_multi(n_dev: int = 4, per_dev: int = 256, seed: int = 5) -> dict:
    """channel_parallel_receive of CONFIG_9 over n_dev devices vs
    single-device receive of the same buffers (payload, crc_ok, delay equal,
    zero collectives in the compiled program), then time_sharded_receive
    of one stream with one frame per device slice."""
    import jax
    import jax.numpy as jnp

    from mercury_tpu.modem.rx import RxChain
    from mercury_tpu.modem.tx import TxChain
    from mercury_tpu.scale import analysis, shard

    _check(len(jax.devices()) >= n_dev, f"needs {n_dev} devices")
    mesh = shard.make_mesh(n_dev)
    g, payload, delays, buf = make_capture(9, n_dev * per_dev, phase_snr_db(9),
                                           seed)
    rx = RxChain(g)
    run = shard.channel_parallel_receive(rx, mesh)
    x = shard.shard_batch(mesh, jnp.asarray(buf))
    t0 = time.perf_counter()
    colls = analysis.hlo_collectives(run, x)        # lowers and compiles
    compile_s = time.perf_counter() - t0
    _check(colls == {}, f"collectives in channel-parallel receive: {colls}")
    _, ms, res = _time_calls(run, x, 3)
    check_decoded(g, res, payload, delays)
    one = rx.receive(jax.device_put(np.asarray(buf), jax.devices()[0]))
    for field in ("payload", "crc_ok", "delay"):
        _check(bool((np.asarray(getattr(res, field))
                     == np.asarray(getattr(one, field))).all()),
               f"channel-parallel {field} differs from one-device receive")

    # one long stream, one frame starting inside each device's slice
    rng = np.random.default_rng(seed)
    n_local = g.nofdm * g.buffer_nsymb * g.interp
    pay_t = rng.integers(0, 256, (n_dev, g.frame_bytes)).astype(np.uint8)
    fr = np.asarray(TxChain(g).transmit(pay_t))
    stream = (2e-3 * rng.standard_normal((1, n_dev * n_local))
              ).astype(np.float32)
    for k in range(n_dev):
        st = k * n_local + int(rng.integers(g.nofdm * g.interp,
                                            n_local - fr.shape[1]))
        stream[0, st: st + fr.shape[1]] += fr[k]
    run_t = shard.time_sharded_receive(rx, mesh, time_axis="ch")
    ts_compile, ts_ms, res_t = _time_calls(run_t, jnp.asarray(stream), 3)
    _check(bool(np.asarray(res_t.crc_ok).all()),
           "time-sharded receive missed a frame")
    _check(bool((np.asarray(res_t.payload)[:, 0] == pay_t).all()),
           "time-sharded receive returned a wrong payload")
    return {"devices": n_dev, "batch": n_dev * per_dev,
            "compile_s": round(compile_s, 3), "ms_per_call": round(ms, 3),
            "msamples_per_s": round(buf.size / ms / 1e3, 3),
            "time_sharded_compile_s": round(ts_compile, 3),
            "time_sharded_ms_per_call": round(ts_ms, 3)}


def _report(name: str, rec: dict) -> None:
    rec = dict(rec, peak_bytes_in_use=peak_bytes())
    print(f"phase {name}: {json.dumps(rec)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-GPU channel-parallel and "
                         "time-sharded receive paths")
    args = ap.parse_args(argv)

    from mercury_tpu.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    n_dev = len(jax.devices())
    print(f"card: {card_identity()}", flush=True)
    print(f"jax {jax.__version__}, {n_dev} x {dev.device_kind}, "
          f"compile cache {cache}", flush=True)
    _report("1_device", {"platform": dev.platform, "kind": dev.device_kind,
                         "count": n_dev})
    if args.multi:
        _report("multi", phase_multi())
    else:
        _report("2_cfg9", phase_decode(9, 256))
        _report("3_cfg0", phase_decode(0, 256))
        _report("4_cfg3", phase_decode(3, 256))
        _report("5_robust0", phase_decode(100, 64))
        _report("6_served", phase_served())
        _report("7_arq", phase_arq())
        _report("8_parity", phase_parity())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": n_dev}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
