#!/usr/bin/env python
"""Gearshift/BREAK stress through the REAL audio path (VERDICT r4 item 5).

tools/link_benchmark.py stress/adaptive run over LinkSimulator's direct
delivery; this tool runs the same noise-burst scenario through the full
audio engine instead — the reference's VB-cable topology
(/root/reference/tools/awgn_turboshift_test.py:50-80):

    commander --poll--> tx_transfer -> playback thread -> LoopbackDevice
      (+ scheduled AWGN burst) -> capture thread -> AudioBurstTransport
      (energy squelch segmentation) -> responder.on_samples -> RX chain

A scheduled noise burst (sigma chosen so the current data config fails
while the ACK/BREAK tone patterns and ROBUST floor stay decodable) forces
the gearshift-down / emergency-BREAK machinery across the
burst-segmentation/squelch/ring path. Events are logged in the
`t ROLE: event` format tools/analyze_link_log.py parses; the summary, the
timeline and the analyzer report land in docs/audio_stress_r5.json.

    JAX_PLATFORMS=cpu python tools/audio_stress_r5.py --bytes 120
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bytes", type=int, default=120)
    ap.add_argument("--init-config", type=int, default=2)
    ap.add_argument("--quiet-sigma", type=float, default=2e-3)
    ap.add_argument("--burst-sigma", type=float, default=1.0,
                    help="burst AWGN sigma: kills CONFIG_2+ data frames "
                    "(in-band SNR ~ -6 dB) while BREAK/ACK tone patterns "
                    "and the ROBUST floor remain workable")
    ap.add_argument("--burst", type=float, nargs=2, default=[40.0, 160.0],
                    metavar=("T0", "T1"), help="burst window, virtual s")
    ap.add_argument("--wall-budget", type=float, default=2400.0)
    ap.add_argument("--out", default="docs/audio_stress_r5.json")
    args = ap.parse_args()

    from mercury_tpu.link import protocol as P
    from mercury_tpu.link.node import ArqConfig, ArqNode
    from mercury_tpu.native.audio import (AudioBurstTransport, AudioIO,
                                          LoopbackDevice)

    now_holder = [0.0]                     # virtual link clock (ms)
    b0, b1 = args.burst

    def sigma_now() -> float:
        t_s = now_holder[0] / 1000.0
        return args.burst_sigma if b0 <= t_s < b1 else args.quiet_sigma

    def make_channel(seed):
        rng = np.random.default_rng(seed)

        def f(x):
            return x + rng.normal(0.0, sigma_now(), len(x)).astype(np.float32)
        return f

    log_lines: list[str] = []

    def ev(role):
        def f(e):
            line = f"{now_holder[0]/1000.0:9.2f} {role}: {e}"
            log_lines.append(line)
            print(line, flush=True)
        return f

    cfg = ArqConfig(init_configuration=args.init_config, gear_shift_on=True,
                    robust_enabled=True, batch_size=2)
    node_a = ArqNode("VE3TPU", P.COMMANDER, cfg, on_event=ev("CMD"))
    node_b = ArqNode("N0CALL", P.RESPONDER, cfg, on_event=ev("RSP"))

    c1a, c1b = LoopbackDevice.pair(channel_fn=make_channel(1))
    c2a, c2b = LoopbackDevice.pair(channel_fn=make_channel(2))
    io_a = AudioIO(playback_dev=c1a, capture_dev=c2b, symbol_len=1088,
                   window_nsymb=4, block=1024, use_window=False)
    io_b = AudioIO(playback_dev=c2a, capture_dev=c1b, symbol_len=1088,
                   window_nsymb=4, block=1024, use_window=False)
    io_a.start()
    io_b.start()
    # squelch between quiet noise floor and burst RMS (the burst noise only
    # rides written blocks — the virtual cable is silent between writes, so
    # the energy segmentation stays valid even at decode-killing sigma)
    t_a = AudioBurstTransport(io_a, squelch=0.02, hang_samples=4096)
    t_b = AudioBurstTransport(io_b, squelch=0.02, hang_samples=4096)

    payload = bytes(np.random.default_rng(3).integers(0, 256, args.bytes)
                    .astype(np.uint8))
    timeline = []
    t_wall0 = time.monotonic()

    def shuttle(io_src, t_dst, node_dst, block):
        io_src.tx_transfer(block)
        t_end = time.monotonic() + 15.0
        while time.monotonic() < t_end:
            burst = t_dst.capture()
            if burst is not None:
                node_dst.on_samples(burst, now_holder[0])
                return True
            time.sleep(0.02)
        return False

    try:
        node_a.send_data(payload)
        node_a.connect("N0CALL")
        deadline = time.monotonic() + args.wall_budget
        lost = 0
        while time.monotonic() < deadline:
            progressed = False
            for src, io_src, t_dst, dst in (
                    (node_a, io_a, t_b, node_b),
                    (node_b, io_b, t_a, node_a)):
                for block in src.poll(now_holder[0]):
                    airtime = 1000.0 * len(block) / 48000.0
                    now_holder[0] += airtime + 300.0
                    if not shuttle(io_src, t_dst, dst, np.asarray(block)):
                        lost += 1
                    progressed = True
                    timeline.append({
                        "t_s": round(now_holder[0] / 1000.0, 1),
                        "sigma": sigma_now(),
                        "cfg_cmd": node_a.current_configuration,
                        "delivered": len(node_b.fifo_rx),
                        "breaks": node_a.stats.breaks_sent,
                        "downs": node_a.stats.gearshift_downs,
                        "ups": node_a.stats.gearshift_ups,
                    })
            if len(node_b.fifo_rx) >= len(payload):
                break
            if not progressed:
                now_holder[0] += 200.0
    finally:
        io_a.stop()
        io_b.stop()

    got = node_b.received()
    summary = {
        "delivered": len(got), "intact": got == payload,
        "virtual_seconds": round(now_holder[0] / 1000.0, 1),
        "wall_seconds": round(time.monotonic() - t_wall0, 1),
        "burst_window_s": [b0, b1],
        "burst_sigma": args.burst_sigma,
        "final_config": node_a.current_configuration,
        "breaks_sent": node_a.stats.breaks_sent,
        "gearshift_downs": node_a.stats.gearshift_downs,
        "gearshift_ups": node_a.stats.gearshift_ups,
        "bursts_lost_in_transport": lost,
    }

    # run the log-forensics analyzer over the captured event stream
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import analyze_link_log as an
    events = an.parse_lines(log_lines)
    report = an.analyze(events)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"summary": summary, "timeline": timeline,
                   "events": log_lines, "analyzer": report}, f, indent=1)
    print(json.dumps(summary))
    ok = (summary["intact"] and summary["breaks_sent"] >= 1
          and summary["gearshift_downs"] >= 1)
    print("STRESS", "PASS" if ok else "INCOMPLETE")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
