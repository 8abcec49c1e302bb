#!/usr/bin/env python
"""Ladder-floor gap experiments (VERDICT r3 item 6): cfg0/−10.0,
cfg1/−7.5, cfg6/−1.5 baseband sit 0.25–0.5 dB shy of the documented
thresholds that the reference build meets (docs/ref_oracle_bb.json).

Decomposes the gap at the documented threshold point with genie variants
of the baseband chain:

  current     — the shipped chain (estimated H, estimated sigma^2)
  genie-chan  — H≡1 known, true sigma^2 (floor of all estimation work:
                isolates FEC + max-log demapper)
  est-H       — estimated H, true sigma^2 (isolates the noise estimate)
  scale k     — current chain with the LLR scale (1/variance) multiplied
                by k (noise-estimate bias sensitivity)
  iter100     — current chain with the BP cap raised 50 -> 100

Usage: python tools/ladder_floor_exp.py [--cfg 0] [--esn0 -10.0]
       [--frames 512] [--batch 128]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_step(cfg: int, variant: str, ldpc_max_iter: int = 50,
               scale: float = 1.0):
    import jax
    import jax.numpy as jnp

    from mercury_tpu.core.geometry import build_geometry
    from mercury_tpu.dsp import ops
    from mercury_tpu.fec import ldpc
    from mercury_tpu.modem import psk
    from mercury_tpu.modem.rx import RxChain
    from mercury_tpu.modem.tx import TxChain

    g = build_geometry(cfg)
    tx = TxChain(g)
    rx = RxChain(g, ldpc_max_iter=ldpc_max_iter)
    code = tx.code
    norm = float(np.sqrt(g.nfft))
    pilots_np = g.pilot_seq.astype(np.complex64)
    bit_perm = jnp.asarray(g.bit_perm)
    bit_iperm = jnp.asarray(np.argsort(np.asarray(g.bit_perm)))
    tf_perm = jnp.asarray(g.tf_perm)
    tf_iperm = jnp.asarray(np.argsort(np.asarray(g.tf_perm)))
    data_cells = jnp.asarray(g.data_cells)
    pad_map = jnp.asarray(g.pad_map)
    const = tx._const

    def step(bits, sigma, key):
        b = bits.shape[0]
        u = jnp.concatenate([bits, bits[:, : g.n_virtual]], axis=-1)
        cw = ldpc.encode(code, u)
        tx_bits = jnp.concatenate([bits, cw[:, code.k:]], axis=-1)
        inter = jnp.take(tx_bits, bit_perm, axis=-1)
        syms = psk.mod(inter, const)
        syms = jnp.take(syms, tf_perm, axis=-1)
        flat = jnp.zeros((b, g.nsymb * g.nc), dtype=jnp.complex64)
        flat = flat.at[:, data_cells].set(syms.astype(jnp.complex64))
        flat = flat.at[:, jnp.asarray(g.pilot_cells)].set(pilots_np[None])
        grid = flat.reshape(b, g.nsymb, g.nc)
        td = ops.ofdm_mod(grid, pad_map, g.nfft, g.ngi) / norm
        k1, k2 = jax.random.split(key)
        noise = (sigma / np.float32(np.sqrt(2))) * (
            jax.random.normal(k1, td.shape)
            + 1j * jax.random.normal(k2, td.shape))
        rx_td = (td + noise) * norm
        rx_grid = ops.ofdm_demod(rx_td, pad_map, g.nfft, g.ngi)

        if variant == "genie-chan":
            rflat = rx_grid.reshape(b, -1)
            data = jnp.take(rflat, data_cells, axis=-1)
            data = jnp.take(data, tf_iperm, axis=-1)
            llr = psk.demod(data, const, sigma * sigma
                            * jnp.ones((b,), jnp.float32))
            llr = jnp.take(llr, bit_iperm, axis=-1)
        elif variant == "est-H":
            eq, _var, _mh, _vf = rx.grid_stats(rx_grid)
            data = jnp.take(eq, data_cells, axis=-1)
            data = jnp.take(data, tf_iperm, axis=-1)
            llr = psk.demod(data, const, sigma * sigma
                            * jnp.ones((b,), jnp.float32))
            llr = jnp.take(llr, bit_iperm, axis=-1)
        else:            # current / scale / iter variants
            eq, var, _mh, _vf = rx.grid_stats(rx_grid)
            data = jnp.take(eq, data_cells, axis=-1)
            data = jnp.take(data, tf_iperm, axis=-1)
            llr = psk.demod(data, const, var / np.float32(scale))
            llr = jnp.take(llr, bit_iperm, axis=-1)

        llr_n = jnp.concatenate([
            llr[..., : g.n_real],
            llr[..., : g.n_virtual],
            llr[..., g.n_real: g.n_real + g.ldpc_p],
        ], axis=-1).astype(jnp.float32)
        bits_out, _it, _conv = rx._ldpc_decode(llr_n, g.spec.ldpc_rate_num)
        return jnp.sum(bits_out[..., : g.n_real] != bits, axis=-1)

    return jax.jit(step), g


def run(cfg: int, esn0: float, variant: str, frames: int, batch: int,
        **kw) -> float:
    import jax
    import jax.numpy as jnp

    step, g = build_step(cfg, variant, **kw)
    n_real = g.n_bits - g.ldpc_p
    rng = np.random.default_rng(17)
    sigma = 10 ** (-esn0 / 20.0)
    key = jax.random.key(int(abs(esn0) * 977 + 13) & 0x7FFFFFFF)
    fe = n = 0
    while n < frames:
        bits = rng.integers(0, 2, (batch, n_real)).astype(np.int32)
        key, sub = jax.random.split(key)
        errs = np.asarray(step(jnp.asarray(bits), jnp.float32(sigma), sub))
        fe += int((errs > 0).sum())
        n += batch
    return fe / n


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", type=int, default=0)
    ap.add_argument("--esn0", type=float, default=-10.0)
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--variants", nargs="*", default=[
        "current", "genie-chan", "est-H", "scale0.8", "scale1.25",
        "iter100"])
    args = ap.parse_args()

    import jax


    import time
    for v in args.variants:
        kw = {}
        name = v
        if v.startswith("scale"):
            kw = {"scale": float(v[5:])}
            v = "scale"
        elif v == "iter100":
            kw = {"ldpc_max_iter": 100}
            v = "current"
        t0 = time.time()
        fer = run(args.cfg, args.esn0, v, args.frames, args.batch, **kw)
        print(f"cfg{args.cfg} @{args.esn0:+.2f} {name}: FER {fer:.4f} "
              f"({args.frames} fr, {time.time()-t0:.0f}s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
