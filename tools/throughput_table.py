#!/usr/bin/env python
"""Per-mode RX throughput table + batch-size sweep.

bench.py measures one operating point (CONFIG_9, batch 256). This tool
measures the COMPLETE mode zoo — all 17 OFDM configs and the 3 MFSK
ROBUST modes:
full RX (mixer+FIR -> sync -> channel est -> equalize -> demap -> LDPC ->
CRC) throughput per mode, the deep-sync acquisition profile split out for
CONFIG_0, plus a batch-size sweep at CONFIG_9 showing where the
dispatch-latency knee sits.

Writes chiprun_out/throughput.json (--out) and prints a markdown table.
Times are the device JAX finds first; the record names it.

Usage: python tools/throughput_table.py [--quick]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODES = list(range(17)) + [100, 101, 102]   # every OFDM + MFSK mode
BATCH = 256
REPS = 10
BATCH_SWEEP = [1, 4, 16, 64, 256, 512]


def measure(config: int, batch: int, reps: int,
            deep_sync: bool | None = None) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mercury_tpu.channel import sim
    from mercury_tpu.core.geometry import build_geometry
    from mercury_tpu.modem.rx import RxChain
    from mercury_tpu.modem.tx import TxChain

    g = build_geometry(config)
    tx, rx = TxChain(g), RxChain(g, deep_sync=deep_sync)
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, (batch, g.frame_bytes)).astype(np.uint8)
    frames = tx.transmit(payload)
    buf_len = g.nofdm * g.buffer_nsymb * g.interp
    delay = ((g.preamble_nsymb + 2) * g.nofdm + 50) * g.interp
    # 30 dB: comfortably above every mode's waterfall once the ~5 dB
    # passband->per-carrier offset is taken out (cfg16 thresholds at 18 dB
    # per-carrier; at 20 dB passband it cannot decode and the LDPC runs to
    # max iterations, which would understate throughput by ~4x)
    buf = sim.awgn_passband(jax.random.key(1), frames,
                            sim.sigma_for_esn0(30.0), delay, buf_len)
    buf = jnp.asarray(buf, dtype=jnp.float32)

    t_c0 = time.perf_counter()
    res = rx.receive(buf)                       # compile + warmup
    jax.block_until_ready(res.payload)
    compile_s = time.perf_counter() - t_c0

    t0 = time.perf_counter()
    for _ in range(reps):
        res = rx.receive(buf)
    jax.block_until_ready(res.payload)
    dt = time.perf_counter() - t0

    ok = np.asarray(res.crc_ok)
    sps = batch * buf_len * reps / dt
    # payload goodput: decoded payload bits per wall second
    goodput = int(ok.sum()) * g.frame_bytes * 8 * reps / dt
    # air-rate context: the real-time channel consumes 48000 samples/s,
    # so one device sustains sps/48000 concurrent real-time channels
    return {
        "config": config,
        "deep_sync": rx.deep_sync,
        "batch": batch,
        "buf_len": buf_len,
        "frame_bytes": g.frame_bytes,
        "msamples_per_s": round(sps / 1e6, 1),
        "decode_goodput_mbit_s": round(goodput / 1e6, 1),
        "realtime_channels": int(sps / 48000),
        "crc_ok_frac": round(float(ok.mean()), 4),
        "ms_per_call": round(dt / reps * 1e3, 3),
        "compile_s": round(compile_s, 1),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="3 reps, skip batch sweep (CI smoke)")
    ap.add_argument("--out", default="chiprun_out/throughput.json")
    args = ap.parse_args()
    reps = 3 if args.quick else REPS

    from mercury_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    dev = jax.devices()[0]

    rows = []
    for cfg in MODES:
        r = measure(cfg, BATCH, reps)
        rows.append(r)
        print(f"  cfg{cfg}: {r['msamples_per_s']} Ms/s "
              f"({r['realtime_channels']} rt-channels, crc {r['crc_ok_frac']})",
              file=sys.stderr)
    # CONFIG_0 with acquisition profiles split out: deep sync (default below
    # CONFIG_5) buys ~6 dB of acquisition for ~5x front-end cost — the
    # high-SNR batched-throughput deployment can turn it off
    r = measure(0, BATCH, reps, deep_sync=False)
    rows.append(r)
    print(f"  cfg0 (deep off): {r['msamples_per_s']} Ms/s", file=sys.stderr)

    sweep = []
    if not args.quick:
        for b in BATCH_SWEEP:
            r = measure(9, b, reps)
            sweep.append(r)
            print(f"  batch {b}: {r['msamples_per_s']} Ms/s "
                  f"({r['ms_per_call']} ms/call)", file=sys.stderr)

    out = {"meta": {"platform": dev.platform, "device_kind": dev.device_kind,
                    "device_count": len(jax.devices()), "reps": reps,
                    "esn0_db": 30.0, "batch": BATCH},
           "per_mode": rows, "batch_sweep": sweep}
    path = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)

    name = {100: "ROBUST_0", 101: "ROBUST_1", 102: "ROBUST_2"}
    print("| config | Msamples/s | goodput Mbit/s | realtime channels | ms/call |")
    print("|---|---:|---:|---:|---:|")
    for r in rows:
        label = name.get(r["config"], "CONFIG_" + str(r["config"]))
        if r["config"] <= 4 and not r["deep_sync"]:
            label += " (deep_sync=off)"
        print(f"| {label} "
              f"| {r['msamples_per_s']} | {r['decode_goodput_mbit_s']} "
              f"| {r['realtime_channels']} | {r['ms_per_call']} |")
    if sweep:
        print("\n| batch | Msamples/s | ms/call |")
        print("|---:|---:|---:|")
        for r in sweep:
            print(f"| {r['batch']} | {r['msamples_per_s']} | {r['ms_per_call']} |")
    print(f"\nwrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
