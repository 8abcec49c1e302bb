"""Round-5 diagnosis of the cfg0 passband acquisition floor (VERDICT r4 #1).

The last sensitivity loss that is ours: cfg0 passband waterfalls at
effective −8.75 dB vs −10.0 baseband (docs/esn0_reconciliation.md §4 +
round-4 addendum). This experiment decomposes the loss at the floor:

  1. FER fixed-delay (genie sync)   — the FEC/demod bound through passband
  2. FER sync-on (shipping chain)   — the acquisition cost
  3. misacquisition rate            — |chosen − true| > GI
  4. rescue potential               — among misacquired rows, how often the
     true delay sits in the top-N of the deep-scan arbitration stack (if
     often: a better FINAL arbitration metric closes the gap; if rarely:
     the scan itself must integrate longer)

Run CPU-only (A/B, both arms on the same backend):
    JAX_PLATFORMS=cpu python tools/acq_floor_r5.py [param_db] [frames]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax


import jax.numpy as jnp
import numpy as np


def main() -> int:
    param = float(sys.argv[1]) if len(sys.argv) > 1 else -4.75
    n_frames = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    from mercury_tpu.channel import sim
    from mercury_tpu.channel.ber import BerHarness

    h = BerHarness(0, batch=32, seed=0)
    g = h.geom
    gi_interp = g.ngi * g.interp
    rng = np.random.default_rng(0)
    key = jax.random.key(1234)

    arb_jit = jax.jit(h.rx.receive_fn, static_argnames=("stage",))
    stats = dict(frames=0, fe_sync=0, fe_fixed=0, misacq=0,
                 misacq_true_in_top=np.zeros(9, int), misacq_rank_hist=[])
    topk = (1, 2, 4, 8, 16, 32, 64, 128, 256)

    while stats["frames"] < n_frames:
        b = h.batch
        payload = rng.integers(0, 256, (b, g.frame_bytes)).astype(np.uint8)
        tx_frames = h.tx.transmit(payload)
        sigma = sim.sigma_for_esn0(param)
        key, sub = jax.random.split(key)
        buf = sim.awgn_passband(sub, tx_frames, sigma, h.delay, h.buf_len,
                                fill="signal")
        buf = jnp.asarray(buf, jnp.float32)

        res = h.rx.receive(buf)
        got = np.asarray(res.payload)
        fe_sync = (np.unpackbits(got ^ payload, axis=-1).sum(-1) > 0)

        delays_f = jnp.full(b, h.delay, jnp.int32)
        freqs = jnp.zeros(b, jnp.float32)
        p_fix, _ok, _i, _s, _mh = h.rx.decode_at_jit(buf, delays_f, freqs)
        fe_fixed = (np.unpackbits(np.asarray(p_fix) ^ payload, axis=-1)
                    .sum(-1) > 0)

        chosen = np.asarray(res.delay)
        # receive() subtracts the deliberate -8 advance; true start h.delay
        err = np.abs(chosen + 8 - h.delay)
        mis = err > gi_interp

        delays_a, scores_a, _cfos_a = arb_jit(buf, stage="arb")
        delays_a = np.asarray(delays_a)          # [rows, B]
        scores_a = np.asarray(scores_a)
        order = np.argsort(-scores_a, axis=0)    # best row first
        d_sorted = np.take_along_axis(delays_a, order, axis=0)
        true_hit = np.abs(d_sorted - h.delay) <= gi_interp   # [rows, B]
        first_rank = np.where(true_hit.any(0), true_hit.argmax(0),
                              d_sorted.shape[0])

        n_rows_tot = d_sorted.shape[0]
        for bi in range(b):
            if mis[bi]:
                # first_rank == n_rows means the true start is in NO
                # arbitration row at all — do not let it masquerade as
                # "in top-k" for k > n_rows
                stats["misacq_rank_hist"].append(int(first_rank[bi]))
                if first_rank[bi] >= n_rows_tot:
                    continue
                for ki, k in enumerate(topk):
                    if first_rank[bi] < k:
                        stats["misacq_true_in_top"][ki] += 1
        stats["frames"] += b
        stats["fe_sync"] += int(fe_sync.sum())
        stats["fe_fixed"] += int(fe_fixed.sum())
        stats["misacq"] += int(mis.sum())
        print(f"  .. {stats['frames']}/{n_frames}: sync FER "
              f"{stats['fe_sync']/stats['frames']:.3f}, fixed "
              f"{stats['fe_fixed']/stats['frames']:.3f}, misacq "
              f"{stats['misacq']/stats['frames']:.3f}", flush=True)

    n = stats["frames"]
    out = {
        "config": 0, "param_db": param, "effective_db": param - 5.0,
        "frames": n,
        "fer_sync_on": round(stats["fe_sync"] / n, 4),
        "fer_fixed_delay": round(stats["fe_fixed"] / n, 4),
        "misacq_rate": round(stats["misacq"] / n, 4),
        "n_arb_rows": int(d_sorted.shape[0]),
        "misacq_true_in_topk": {
            str(k): int(v) for k, v in zip(topk,
                                           stats["misacq_true_in_top"])},
        "misacq_count": stats["misacq"],
        "misacq_rank_hist": stats["misacq_rank_hist"],
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
