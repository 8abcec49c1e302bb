#!/usr/bin/env python
"""BER waterfall campaign: all modes x densities x harness conventions.

The round-2 Es/N0 evidence (VERDICT r1 #1): full waterfalls with >=1000
frames/point at threshold, for

- the BASEBAND harness (reference baseband_test_EsN0 convention: sigma =
  10^(-EsN0/20) on 1/sqrt(Nfft)-normalized symbols == per-carrier Es/N0,
  the convention of the documented table common_defines.h:129-148 —
  verified against the reference binary via `golden_gen berbb`),
- the PASSBAND harness (reference passband_test_EsN0 convention: the same
  sigma formula applied to the passband waveform; effective per-carrier
  Es/N0 = parameter + delta, where delta is measured per config by
  BerHarness.front_end_delta), and
- the MFSK channel-SNR convention (sigma calibrated from measured TX power,
  telecom_system.cc:271-288).

Writes/updates docs/ber_r2.json incrementally (safe to re-run: finished
(config, density, harness) triples are skipped). Runs on the device JAX finds
first (JAX_PLATFORMS=cpu to force the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Documented Es/N0 @ FER<0.1 (common_defines.h:129-148); MFSK rows are
# channel SNR (telecom_system.cc:2642)
DOCUMENTED = {0: -10.0, 1: -7.5, 2: -6.0, 3: -4.5, 4: -3.5, 5: -2.5,
              6: -1.5, 7: -0.5, 8: 0.5, 9: 1.5, 10: 3.0, 11: 4.0,
              12: 6.5, 13: 7.5, 14: 9.0, 15: 12.5, 16: 13.5,
              100: -13.0, 101: -11.0, 102: -8.0}

OFDM_CFGS = list(range(17))
MFSK_CFGS = [100, 101, 102]


def find_waterfall(run_fn, start: float, step: float, n_scan: int,
                   n_confirm: int, max_offset: float, log):
    """Ascending scan at n_scan frames/point; once FER dips below 0.07,
    confirm (with n_confirm frames) the half-step below and the point itself;
    waterfall = lowest confirmed Es/N0 with FER < 0.1."""
    points = []
    e = start
    cand = None
    while e <= start + max_offset + 1e-9:
        p = run_fn(e, n_scan)
        points.append(p)
        log(f"  scan {e:+.2f} dB: FER={p.fer:.3f} ({p.frames} fr)")
        if p.fer < 0.07:
            cand = e
            break
        e += step
    if cand is None:
        return points, None
    wf = None
    for e2 in (cand - step / 2, cand):
        p = run_fn(e2, n_confirm)
        points.append(p)
        log(f"  confirm {e2:+.2f} dB: FER={p.fer:.4f} ({p.frames} fr)")
        if p.fer < 0.1:
            wf = e2
            break
    while wf is None and cand <= start + max_offset:
        cand += step
        p = run_fn(cand, n_confirm)
        points.append(p)
        log(f"  confirm {cand:+.2f} dB: FER={p.fer:.4f} ({p.frames} fr)")
        if p.fer < 0.1:
            wf = cand
    # refine downward in half-steps while the confirmation still passes
    for _ in range(6):
        if wf is None:
            break
        e3 = wf - step / 2
        p = run_fn(e3, n_confirm)
        points.append(p)
        log(f"  refine {e3:+.2f} dB: FER={p.fer:.4f} ({p.frames} fr)")
        if p.fer < 0.1:
            wf = e3
        else:
            break
    return points, wf


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="docs/ber_r4.json")
    ap.add_argument("--harness", default="all",
                    choices=["all", "bb", "pb", "mfsk", "ctrl"])
    ap.add_argument("--configs", type=int, nargs="*", default=None)
    ap.add_argument("--density", default="both",
                    choices=["both", "high", "low"])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--scan-frames", type=int, default=256)
    ap.add_argument("--confirm-frames", type=int, default=1024)
    args = ap.parse_args()

    import jax

    platform = jax.devices()[0].platform

    from mercury_tpu.channel.ber import BerHarness
    from mercury_tpu.core.modes import HIGH_DENSITY, LOW_DENSITY

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {"meta": {"platform": platform,
                        "scan_frames": args.scan_frames,
                        "confirm_frames": args.confirm_frames,
                        "batch": args.batch},
               "results": []}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["config"], r["density"], r["harness"])
            for r in results["results"]}

    def log(msg):
        print(msg, flush=True)

    def save():
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(results, f, indent=1)
        os.replace(tmp, args.out)

    densities = {"both": [("high", HIGH_DENSITY), ("low", LOW_DENSITY)],
                 "high": [("high", HIGH_DENSITY)],
                 "low": [("low", LOW_DENSITY)]}[args.density]

    jobs = []
    # baseband first (both densities), then passband (high), then MFSK
    if args.harness in ("all", "bb"):
        for dname, d in densities:
            for c in OFDM_CFGS:
                jobs.append((c, dname, d, "baseband"))
    if args.harness in ("all", "pb"):
        # both densities are first-class operating modes
        # (telecom_system.cc:1818-1876) — run the full passband chain
        # (sync + CFO + estimation) for each
        for dname, d in densities:
            for c in OFDM_CFGS:
                jobs.append((c, dname, d, "passband"))
    if args.harness in ("all", "mfsk"):
        for c in MFSK_CFGS:
            jobs.append((c, "high", HIGH_DENSITY, "mfsk"))
            # the reference's own MFSK test bypasses sync (mfsk_fixed_delay,
            # telecom_system.cc:663-673) — measure that convention too
            jobs.append((c, "high", HIGH_DENSITY, "mfsk_fixed"))
    if args.harness in ("all", "ctrl"):
        # punctured short control frames (ROBUST_0/1 only): the reference
        # documents an UNCHANGED waterfall vs data frames
        # (telecom_system.cc:2968-2994; sweep tool punctured_ber_test.py)
        for c in (100, 101):
            jobs.append((c, "high", HIGH_DENSITY, "ctrl"))
            jobs.append((c, "high", HIGH_DENSITY, "ctrl_fixed"))
    if args.configs is not None:
        jobs = [j for j in jobs if j[0] in args.configs]

    for cfg, dname, dens, harness in jobs:
        if (cfg, dname, harness) in done:
            continue
        t0 = time.time()
        log(f"=== cfg{cfg} {dname} {harness} ===")
        h = BerHarness(cfg, batch=args.batch, pilot_density=dens,
                       ctrl=harness.startswith("ctrl"))
        doc = DOCUMENTED.get(cfg)
        delta = None
        if harness == "baseband":
            run_fn = h.run_point_baseband
            start = (doc if doc is not None else 0.0) - 2.0
            step, max_off = 0.5, 26.0
        elif harness == "passband":
            delta = h.front_end_delta()
            log(f"  front-end delta = {delta:+.2f} dB "
                f"(effective EsN0 = parameter {delta:+.2f})")
            run_fn = h.run_point
            start = (doc if doc is not None else 0.0) - delta - 2.0
            step, max_off = 0.5, 26.0
        else:  # mfsk/ctrl channel-SNR convention (sync-on or fixed-delay)
            if harness.endswith("_fixed"):
                import functools
                run_fn = functools.partial(h.run_point, fixed_delay=True)
            else:
                run_fn = h.run_point
            start = (doc if doc is not None else -14.0) - 3.0
            step, max_off = 0.5, 20.0

        points, wf = find_waterfall(run_fn, start, step, args.scan_frames,
                                    args.confirm_frames, max_off, log)
        entry = {
            "config": cfg, "density": dname, "harness": harness,
            "delta_db": None if delta is None else round(delta, 3),
            "documented_db": doc,
            "waterfall_fer10": wf,
            "effective_waterfall_db": (None if wf is None else
                                       round(wf + (delta or 0.0), 2)),
            "gap_vs_documented_db": (None if (wf is None or doc is None) else
                                     round(wf + (delta or 0.0) - doc, 2)),
            "points": [[p.esn0_db, p.frames, p.frame_errors,
                        round(p.fer, 5), round(p.ber, 7)] for p in points],
            "seconds": round(time.time() - t0, 1),
        }
        results["results"].append(entry)
        done.add((cfg, dname, harness))
        save()
        log(f"  -> waterfall {wf} dB (effective "
            f"{entry['effective_waterfall_db']}, doc {doc}, "
            f"gap {entry['gap_vs_documented_db']}) in {entry['seconds']}s")
    save()
    log("campaign complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
