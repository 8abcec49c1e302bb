"""Comparison of the flooding BP decoder (`decode`) and the
matmul-redistribution layered decoder (`decode_mm`), per LDPC rate.

For each rate it measures, on the default JAX backend:

  * ms/sweep, forced: wall time of a fixed number of sweeps on hopeless
    (non-converging) inputs, differenced between two iteration caps so
    dispatch overhead cancels;
  * sweeps-to-converge at threshold SNR: mean + p95 of the decoder's own
    iteration counter over a batch of near-threshold codewords (lockstep
    batch wall time is set by the slowest codeword, so max is reported too);
  * end-to-end wall ms for a B-row batch at threshold SNR (what the RX
    chain actually pays).

Writes chiprun_out/ldpc_mm_bench.json.

Run: python tools/ldpc_mm_bench.py [batch] [reps]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from mercury_tpu.fec import ldpc
from mercury_tpu.fec.tables import load_code

# near-threshold noise per rate (same operating points as tests/test_fec.py)
SIGMA = {1: 1.5, 2: 1.3, 3: 1.2, 4: 1.0, 5: 0.95, 6: 0.9, 8: 0.75, 14: 0.45}


def _llrs(rate, b, seed=7):
    code = load_code(rate)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (b, code.k))
    cw = np.asarray(ldpc.encode(code, jnp.asarray(u)))
    sigma = SIGMA[rate]
    y = (1 - 2 * cw) + sigma * rng.standard_normal(cw.shape)
    return jnp.asarray((2 / sigma ** 2 * y).astype(np.float32))


def _hopeless(rate, b, seed=3):
    """LLRs that never converge: pure noise, tiny magnitude."""
    code = load_code(rate)
    rng = np.random.default_rng(seed)
    return jnp.asarray(0.3 * rng.standard_normal((b, code.n)
                                                 ).astype(np.float32))


def _time(fn, *args, reps=5):
    out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts) * 1e3


def main():
    b = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    backend = jax.default_backend()
    print(f"backend={backend} batch={b}")
    rows = []
    for rate in sorted(SIGMA):
        bad = _hopeless(rate, b)
        thr = _llrs(rate, b)
        row = {"rate_num": rate, "batch": b}
        for name, fn in (
            ("flood", lambda llr, mi: ldpc.decode(llr, rate, max_iter=mi)),
            ("layered", lambda llr, mi: ldpc.decode_mm(llr, rate,
                                                       max_iter=mi)),
        ):
            hi = _time(fn, bad, 40, reps=reps)
            lo = _time(fn, bad, 10, reps=reps)
            ms_per_sweep = (hi - lo) / 30.0
            e2e = _time(fn, thr, 50, reps=reps)
            bits, iters, ok = fn(thr, 50)
            it = np.asarray(iters)
            okm = np.asarray(ok)
            conv = it[okm]
            row[name] = {
                "ms_per_sweep": round(ms_per_sweep, 4),
                "sweeps_mean": round(float(conv.mean()), 2),
                "sweeps_p95": int(np.percentile(conv, 95)),
                "sweeps_max": int(conv.max()),
                "fer": round(float((~okm).mean()), 4),
                "e2e_ms": round(e2e, 3),
            }
            print(f"rate {rate:2d}/16 {name:8s} {ms_per_sweep:7.4f} ms/sweep"
                  f"  sweeps mean {conv.mean():5.2f} p95 {row[name]['sweeps_p95']:3d}"
                  f" max {conv.max():3d}  FER {row[name]['fer']:.3f}"
                  f"  e2e {e2e:8.3f} ms")
        nl = ldpc._default_layers(rate)
        row["n_layers"] = nl
        row["speedup_e2e"] = round(row["flood"]["e2e_ms"]
                                   / row["layered"]["e2e_ms"], 3)
        rows.append(row)
        print(f"          L={nl}  e2e speedup {row['speedup_e2e']}x")
    dev = jax.devices()[0]
    out = {"backend": backend, "device_kind": dev.device_kind, "batch": b,
           "note": "ms/sweep = (t(40 iter) - t(10 iter))/30 on hopeless "
                   "inputs; e2e = wall ms of a full decode call on a "
                   "near-threshold batch (lockstep: slowest row dominates)",
           "rows": rows}
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out", "ldpc_mm_bench.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
