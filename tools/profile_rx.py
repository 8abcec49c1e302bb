#!/usr/bin/env python
"""Per-stage timing of the RX chain on the active backend.

Breaks receive() into its pipeline stages and times each jitted piece
separately to find where the samples/s budget goes.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from mercury_tpu.channel import sim
from mercury_tpu.core.geometry import build_geometry
from mercury_tpu.dsp import ops
from mercury_tpu.fec import ldpc
from mercury_tpu.modem import sync
from mercury_tpu.modem.rx import RxChain
from mercury_tpu.modem.tx import TxChain

CFG = int(sys.argv[1]) if len(sys.argv) > 1 else 9
BATCH = int(sys.argv[2]) if len(sys.argv) > 2 else 32
REPS = 10


def timeit(name, fn, *args):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / REPS
    print(f"{name:34s} {dt*1e3:9.3f} ms")
    return out, dt


def main():
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
    print(f"cfg={CFG} batch={BATCH} buf_len={buf_len} "
          f"({BATCH*buf_len/1e6:.2f} Msamples/iter)")

    # cumulative cost at each truncation of the real receive() program —
    # the differences are the marginal cost of each pipeline section
    ts = {}
    for stage in ("sync", "refine", "hyp", "full"):
        _, ts[stage] = timeit(f"receive[:{stage}]", rx._receive_jit, buf, stage)
    t_total = ts["full"]
    print(f"  marginal: sync={ts['sync']*1e3:.2f}  "
          f"mf-refine={(ts['refine']-ts['sync'])*1e3:.2f}  "
          f"extract+cfo-hyp={(ts['hyp']-ts['refine'])*1e3:.2f}  "
          f"demap+ldpc+crc={(ts['full']-ts['hyp'])*1e3:.2f} ms")

    # isolated sub-kernels (compiled separately; small launch overhead each)
    mix_fn = jax.jit(lambda pb: rx.mix(pb, 0.0))
    iq, t_mix = timeit("mix (full buffer)", mix_fn, buf)

    fir_strided = (ops.fir_same_strided_mm if rx._mm_fir
                   else ops.fir_same_strided)
    firn_fn = jax.jit(lambda x: fir_strided(x, rx._fir_ts, g.interp))
    bbn, t_fir = timeit(f"fir_same_strided /{g.interp} (TS)", firn_fn, iq)

    sc_fn = jax.jit(lambda x: sync.schmidl_cox_metric(x, g, decim=g.interp))
    (met, cfo), t_sc = timeit("schmidl_cox_metric", sc_fn, bbn)

    dly = jnp.full((BATCH,), delay, jnp.int32)
    ext_fn = jax.jit(lambda x, d: rx.extract_frame_decimated_pb(
        x, d, rx.active_nsymb))
    dec0, t_ext = timeit("extract_frame_decimated_pb", ext_fn, buf, dly)

    dg_fn = jax.jit(rx.demod_grid)
    grid, t_dg = timeit("demod_grid", dg_fn, dec0)

    gs_fn = jax.jit(rx.grid_stats)
    _, t_gs = timeit("grid_stats (1 hyp)", gs_fn, grid)

    do_fn = jax.jit(rx.decode_ofdm)
    (llr, _, _, _), t_do = timeit("decode_ofdm (est+eq+demap)", do_fn, grid)

    lp_fn = jax.jit(rx.llr_to_payload)
    _, t_lp = timeit("llr_to_payload (LDPC+CRC)", lp_fn, llr)

    llr_n = jnp.concatenate([
        llr[..., : g.n_real], llr[..., : g.n_virtual],
        llr[..., g.n_real: g.n_real + g.ldpc_p]], axis=-1).astype(jnp.float32)
    dec_fn = jax.jit(lambda l: ldpc.decode(l, g.spec.ldpc_rate_num))
    _, t_ldpc = timeit("ldpc.decode alone", dec_fn, llr_n)

    sps = BATCH * buf_len / t_total
    print(f"\nreceive() = {sps/1e6:.1f} Msamples/s")


if __name__ == "__main__":
    main()
