"""BICM-ID A/B at the top of the mode ladder (VERDICT r4 item 2).

docs/esn0_reconciliation.md §5c argued from genie runs that the residual
cfg10/11/14/15/16 documented-table gaps are FEC/demapper-bound — without
trying iterative demapping-decoding. This experiment runs it: BP extrinsics
fed back as full log-MAP demapper priors (RxChain(bicm_iters=N),
psk.demod_full), baseband harness, A/B at and below the documented
thresholds.

    JAX_PLATFORMS=cpu python tools/bicm_id_r5.py [--frames 256]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--out", default="docs/bicm_id_r5.json")
    ap.add_argument("--configs", type=int, nargs="*",
                    default=[13, 14, 15, 16])
    ap.add_argument("--iters", type=int, nargs="*", default=[0, 1, 2, 3])
    args = ap.parse_args()

    import jax


    from mercury_tpu.channel.ber import BerHarness

    # documented threshold and the points to probe around it (the A/B
    # question is whether BICM-ID moves the waterfall >= 0.5 dB toward the
    # documented value from the round-4 measured one)
    POINTS = {13: (7.5, [7.0, 7.5]),       # r4 waterfall 7.0 (beats doc)
              14: (9.0, [9.5, 10.0, 10.75]),   # r4 waterfall 10.75
              15: (12.5, [12.25, 12.75]),  # r4 waterfall 12.75
              16: (13.5, [14.5, 15.0, 15.75])}  # r4 waterfall 15.75

    results = {"meta": {"frames": args.frames,
                        "harness": "baseband", "dd": False,
                        "platform": jax.devices()[0].platform},
               "rows": []}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["config"], r["esn0_db"], r["bicm_iters"])
            for r in results["rows"]}

    for cfg in args.configs:
        doc, pts = POINTS[cfg]
        for esn0 in pts:
            for it in args.iters:
                if (cfg, esn0, it) in done:
                    continue
                t0 = time.time()
                # dd=False isolates the demapper-decoder axis (the genie
                # analysis showed DD ~= genie channel, +-0.03 FER)
                h = BerHarness(cfg, batch=args.batch, dd=False,
                               bicm_iters=it)
                p = h.run_point_baseband(esn0, args.frames)
                row = {"config": cfg, "esn0_db": esn0, "bicm_iters": it,
                       "documented_db": doc, "frames": p.frames,
                       "fer": round(p.fer, 4), "ber": round(p.ber, 6),
                       "seconds": round(time.time() - t0, 1)}
                results["rows"].append(row)
                done.add((cfg, esn0, it))
                print(json.dumps(row), flush=True)
                tmp = args.out + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(results, f, indent=1)
                os.replace(tmp, args.out)
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
