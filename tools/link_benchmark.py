#!/usr/bin/env python
"""ARQ link benchmark: effective throughput vs channel SNR.

This repo's equivalent of the reference's tools/mercury_benchmark.py
(sweep/stress/adaptive sub-commands, measurement = delivered bytes over the
session window — SURVEY §4.3), but over the deterministic simulated channel
so a full sweep runs in minutes instead of hours of wall-clock audio.

  python tools/link_benchmark.py sweep --config 9 --snrs 5,10,15
  python tools/link_benchmark.py adaptive --snrs 0,10,20,30
  python tools/link_benchmark.py stress --bytes 4000 --burst-snr -5

stress: random noise bursts against the gearshift/BREAK machinery
(reference run_stress, mercury_benchmark.py:829+): the channel SNR drops to
--burst-snr for random burst windows and recovers; the tool records a
timeline of (sim time, SNR, current config, delivered bytes) and reports
whether the transfer survived. --chart renders the timeline as a PNG."""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def run_session(init_cfg, snr_db, n_bytes, gear, robust, seed=0,
                max_sim_s=3600, fading=None, profile="static"):
    from mercury_tpu.link import protocol as P
    from mercury_tpu.link.node import ArqConfig, ArqNode
    from mercury_tpu.link.sim import ChannelModel, LinkSimulator

    cfg = ArqConfig(init_configuration=init_cfg, gear_shift_on=gear,
                    robust_enabled=robust, rx_profile=profile)
    cmd = ArqNode("VE3TPU", P.COMMANDER, cfg)
    rsp = ArqNode("N0CALL", P.RESPONDER, cfg)
    sim = LinkSimulator(cmd, rsp, ChannelModel(snr_db=snr_db, seed=seed,
                                               fading=fading))
    payload = bytes(np.random.default_rng(seed).integers(0, 256, n_bytes)
                    .astype(np.uint8))
    cmd.send_data(payload)
    cmd.connect("N0CALL")
    t = sim.run(max_sim_s=max_sim_s,
                until=lambda: len(rsp.fifo_rx) >= n_bytes)
    got = rsp.received()
    return {
        "snr_db": snr_db,
        "delivered": len(got),
        "intact": got == payload,
        "sim_seconds": round(t, 1),
        "bytes_per_min": round(len(got) * 60.0 / max(t, 1e-9), 1),
        "bps": round(len(got) * 8.0 / max(t, 1e-9), 1),
        "final_config": cmd.current_configuration,
        "breaks": cmd.stats.breaks_sent,
        "gearshift_ups": cmd.stats.gearshift_ups,
    }


def run_stress(init_cfg, n_bytes, base_snr, burst_snr, seed=0,
               max_sim_s=3600, tick_s=5.0):
    """Noise-burst resilience run: random SNR bursts while a transfer is in
    flight, gearshift + BREAK enabled. Returns (summary, timeline)."""
    from mercury_tpu.link import protocol as P
    from mercury_tpu.link.node import ArqConfig, ArqNode
    from mercury_tpu.link.sim import ChannelModel, LinkSimulator

    rng = np.random.default_rng(seed)
    # precompute random burst windows (reference stress: random on/off)
    bursts, t = [], 0.0
    while t < max_sim_s:
        t += float(rng.uniform(20.0, 60.0))          # quiet gap
        dur = float(rng.uniform(8.0, 25.0))          # burst duration
        bursts.append((t, t + dur))
        t += dur

    def snr_at(now_s):
        for a, b in bursts:
            if a <= now_s < b:
                return burst_snr
        return base_snr

    cfg = ArqConfig(init_configuration=init_cfg, gear_shift_on=True,
                    robust_enabled=True)
    cmd = ArqNode("VE3TPU", P.COMMANDER, cfg)
    rsp = ArqNode("N0CALL", P.RESPONDER, cfg)
    sim = LinkSimulator(cmd, rsp,
                        ChannelModel(seed=seed, snr_schedule=snr_at))
    payload = bytes(rng.integers(0, 256, n_bytes).astype(np.uint8))
    cmd.send_data(payload)
    cmd.connect("N0CALL")

    timeline, elapsed = [], 0.0
    while elapsed < max_sim_s and len(rsp.fifo_rx) < n_bytes:
        elapsed += sim.run(max_sim_s=tick_s,
                           until=lambda: len(rsp.fifo_rx) >= n_bytes)
        timeline.append({
            "t_s": round(elapsed, 1),
            "snr_db": snr_at(elapsed),
            "config": cmd.current_configuration,
            "delivered": len(rsp.fifo_rx),
            "breaks": cmd.stats.breaks_sent,
        })
        if cmd.link_status == P.DROPPED or rsp.link_status == P.DROPPED:
            break
    got = rsp.received()
    summary = {
        "delivered": len(got),
        "intact": got == payload,
        "sim_seconds": round(elapsed, 1),
        "bytes_per_min": round(len(got) * 60.0 / max(elapsed, 1e-9), 1),
        "final_config": cmd.current_configuration,
        "breaks": cmd.stats.breaks_sent,
        "gearshift_ups": cmd.stats.gearshift_ups,
        "gearshift_downs": cmd.stats.gearshift_downs,
        "bursts": [[round(a, 1), round(b, 1)] for a, b in bursts
                   if a < elapsed],
    }
    return summary, timeline


def stress_chart(timeline, bursts, path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ts = [p["t_s"] for p in timeline]
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(12, 6), sharex=True)
    ax1.step(ts, [p["config"] for p in timeline], where="post",
             label="config")
    for a, b in bursts:
        ax1.axvspan(a, b, alpha=0.2, color="red")
        ax2.axvspan(a, b, alpha=0.2, color="red")
    ax1.set_ylabel("config")
    ax1.legend(loc="upper left")
    ax2.plot(ts, [p["delivered"] for p in timeline], label="delivered bytes")
    ax2.set_xlabel("simulated seconds")
    ax2.set_ylabel("bytes")
    ax2.legend(loc="upper left")
    fig.savefig(path, dpi=100, bbox_inches="tight")
    print(f"wrote {path}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["sweep", "adaptive", "stress"])
    ap.add_argument("--config", type=int, default=0)
    ap.add_argument("--snrs", default="0,5,10,15,20,25,30")
    ap.add_argument("--bytes", type=int, default=2000)
    ap.add_argument("--robust", action="store_true")
    ap.add_argument("--base-snr", type=float, default=15.0)
    ap.add_argument("--burst-snr", type=float, default=-5.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chart", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--fading", default=None,
                    choices=["good", "moderate", "poor"],
                    help="continuous Watterson fading (CCIR preset) on top "
                    "of the AWGN; pairs with --profile track")
    ap.add_argument("--profile", default="static",
                    choices=["static", "track"],
                    help="receiver profile (track = decision-directed "
                    "fading tracking, docs/fading_r2.md)")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    if args.mode == "stress":
        summary, timeline = run_stress(args.config, args.bytes,
                                       args.base_snr, args.burst_snr,
                                       seed=args.seed)
        print(json.dumps(summary, indent=1))
        if args.chart:
            stress_chart(timeline, summary["bursts"], args.chart)
        if args.out:
            json.dump({"summary": summary, "timeline": timeline},
                      open(args.out, "w"), indent=1)
            print(f"wrote {args.out}")
        return

    snrs = [float(s) for s in args.snrs.split(",")]
    gear = args.mode == "adaptive"
    results = []
    for snr in snrs:
        r = run_session(args.config, snr, args.bytes, gear, args.robust,
                        seed=int(snr * 10) & 0xFF, fading=args.fading,
                        profile=args.profile)
        results.append(r)
        print(f"SNR {snr:+.0f} dB: {r['bytes_per_min']} B/min "
              f"({r['bps']} bps), final cfg {r['final_config']}, "
              f"{'OK' if r['intact'] else 'INCOMPLETE'} in {r['sim_seconds']}s")
    if args.out:
        json.dump(results, open(args.out, "w"), indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
