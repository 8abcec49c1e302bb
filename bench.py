#!/usr/bin/env python
"""Headline benchmark: RX samples/s per GPU (full demod + LDPC decode).

Runs the complete per-mode RX program (mixer + FIR + sync + channel est +
equalize + demap + LDPC BP + CRC) on a batch of capture buffers already on
the device and measures passband samples processed per second on one GPU.

Baseline: the reference C++ modem's receive_byte throughput on one CPU
thread (tools/golden_gen rxbench 9 -> 1.77 Msamples/s). vs_baseline is the
speedup over that.

    python bench.py

Runs in one process on the first device JAX finds and fails (exit 1, no
result line) unless it is an NVIDIA GPU. Prints the card's name and power
limit, then ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"platform", "device_kind", "device_count", "card"}.
"""

import json
import sys
import time

import numpy as np

REFERENCE_CPU_SAMPLES_PER_S = 1.77e6  # tools/golden_gen rxbench 9, one thread
CFG = 9            # QPSK 8/16 — mid-ladder workhorse mode
BATCH = 256
REPS = 10


def main() -> int:
    from chip_smoke import card_identity
    from mercury_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from mercury_tpu.channel import sim
    from mercury_tpu.core.geometry import build_geometry
    from mercury_tpu.modem.rx import RxChain
    from mercury_tpu.modem.tx import TxChain

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs an NVIDIA GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    card = card_identity()
    print(f"card: {card}", flush=True)

    g = build_geometry(CFG)
    tx, rx = TxChain(g), RxChain(g)
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, (BATCH, g.frame_bytes)).astype(np.uint8)
    frames = tx.transmit(payload)
    buf_len = g.nofdm * g.buffer_nsymb * g.interp
    delay = ((g.preamble_nsymb + 2) * g.nofdm + 50) * g.interp
    buf = sim.awgn_passband(jax.random.key(1), frames, sim.sigma_for_esn0(12.0),
                            delay, buf_len)
    buf = jnp.asarray(buf, dtype=jnp.float32)

    res = jax.block_until_ready(rx.receive(buf))      # compile + warmup
    ok = np.asarray(res.crc_ok)
    if not ok.all():
        print(f"bench: only {int(ok.sum())}/{BATCH} rows decoded",
              file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    for _ in range(REPS):
        res = rx.receive(buf)
    jax.block_until_ready(res)
    dt = time.perf_counter() - t0

    sps = BATCH * buf_len * REPS / dt
    print(json.dumps({
        "metric": "rx_demod_ldpc_samples_per_sec_per_chip",
        "value": round(sps / 1e6, 3),
        "unit": "Msamples/s",
        "vs_baseline": round(sps / REFERENCE_CPU_SAMPLES_PER_S, 2),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
