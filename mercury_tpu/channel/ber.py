"""Monte-Carlo BER/FER harness — the framework's primary correctness gate
(SURVEY §4: replicates the reference's PLOT_BASEBAND/PLOT_PASSBAND self-test,
telecom_system.cc:96-330, 2393-2480), batched: one receive() call evaluates an
entire batch of independent noisy frames per SNR point.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from mercury_tpu.channel import sim
from mercury_tpu.core.geometry import ModeGeometry, build_geometry
from mercury_tpu.modem.rx import RxChain
from mercury_tpu.modem.tx import TxChain


@dataclass
class BerPoint:
    esn0_db: float
    frames: int
    frame_errors: int
    bit_errors: int
    bits: int

    @property
    def fer(self) -> float:
        return self.frame_errors / max(self.frames, 1)

    @property
    def ber(self) -> float:
        return self.bit_errors / max(self.bits, 1)


@dataclass
class BerSweep:
    config: int
    points: list[BerPoint] = field(default_factory=list)

    def waterfall(self, fer_threshold: float = 0.1) -> float | None:
        """Lowest Es/N0 with FER below threshold."""
        ok = [p.esn0_db for p in self.points if p.fer < fer_threshold]
        return min(ok) if ok else None


class BerHarness:
    """Passband AWGN BER harness for one mode."""

    def __init__(self, config: int, batch: int = 32, seed: int = 0,
                 pilot_density: int = 0, ctrl: bool = False, **rx_kwargs):
        """ctrl=True sweeps the MFSK punctured short CONTROL frames
        (ROBUST_0 1200 bits / ROBUST_1 1400 bits) instead of data frames —
        the reference documents that their waterfall is UNCHANGED vs data
        frames (telecom_system.cc:2968-2994) and ships a dedicated sweep
        (tools/punctured_ber_test.py, CLI -P, main.cc:312-318); ARQ link
        setup rides these frames, so the property needs its own campaign
        rows (docs/ctrl_ber_r5.json)."""
        self.geom = build_geometry(config, pilot_density)
        self.ctrl = bool(ctrl)
        self.tx = TxChain(self.geom, ctrl=ctrl)
        self.rx = RxChain(self.geom, ctrl=ctrl, **rx_kwargs)
        self.batch = batch
        self.seed = seed
        self._bb_step = None       # lazily-built jitted baseband MC step
        g = self.geom
        self.buf_len = g.nofdm * g.buffer_nsymb * g.interp
        # same delay structure as the reference harness
        # (telecom_system.cc:247-254,290); MFSK sync quantizes to symbol
        # boundaries so its frames are placed symbol-aligned
        if g.spec.is_mfsk:
            self.delay = (g.preamble_nsymb + 2) * g.nofdm * g.interp
        else:
            self.delay = ((g.preamble_nsymb + 2) * g.nofdm + 50) * g.interp

    def run_point(self, esn0_db: float, n_frames: int | None = None,
                  fixed_delay: bool = False) -> BerPoint:
        """One passband Monte-Carlo point. fixed_delay=True bypasses time
        sync and decodes at the known frame offset — the convention of the
        reference's own MFSK passband test (mfsk_fixed_delay,
        telecom_system.cc:663-673), whose documented −13/−11/−8 dB
        waterfalls assume perfect sync."""
        import jax.numpy as jnp

        g = self.geom
        n_frames = n_frames or self.batch
        rng = np.random.default_rng(self.seed + hash(esn0_db) % 65536)
        frame_errors = bit_errors = frames = 0
        payload_bits_per_frame = g.frame_bytes * 8
        key = jax.random.key(int(esn0_db * 1000) & 0x7FFFFFFF)

        while frames < n_frames:
            b = min(self.batch, n_frames - frames)
            payload = rng.integers(0, 256, (b, g.frame_bytes)).astype(np.uint8)
            tx_frames = self.tx.transmit(payload)
            if g.spec.is_mfsk:
                sigma = sim.sigma_for_channel_snr(
                    np.asarray(tx_frames[0]), esn0_db, g.fs, g.bandwidth)
            else:
                sigma = sim.sigma_for_esn0(esn0_db)
            key, sub = jax.random.split(key)
            # fill="signal": the reference pads the pre-delay region with
            # random signal samples (awgn.cc apply_with_delay), stressing
            # false sync locks — match it so waterfall numbers are comparable
            buf = sim.awgn_passband(sub, tx_frames, sigma, self.delay,
                                    self.buf_len, fill="signal")
            if fixed_delay:
                delays = jnp.full(b, self.delay, jnp.int32)
                freqs = jnp.zeros(b, jnp.float32)
                payloads, _ok, _i, _s, _mh = self.rx.decode_at_jit(
                    jnp.asarray(buf, jnp.float32), delays, freqs)

                class _R:  # same shape as RxResult for the tail below
                    payload = payloads
                res = _R()
            else:
                res = self.rx.receive(buf)
            got = np.asarray(res.payload)
            errs = np.unpackbits(got ^ payload, axis=-1).sum(axis=-1)
            frame_errors += int((errs > 0).sum())
            bit_errors += int(errs.sum())
            frames += b
        return BerPoint(esn0_db, frames, frame_errors, bit_errors,
                        frames * payload_bits_per_frame)

    def _build_bb_step(self):
        """One jitted baseband Monte-Carlo step over a fixed batch: complex
        constants (pilots) close over as numpy so they become HLO literals
        of the compiled step."""
        import jax.numpy as jnp

        from mercury_tpu.dsp import ops
        from mercury_tpu.fec import ldpc
        from mercury_tpu.modem import psk

        g = self.geom
        tx, rx = self.tx, self.rx
        code = tx.code
        n_real = g.n_bits - g.ldpc_p
        norm = float(np.sqrt(g.nfft))
        pilots_np = g.pilot_seq.astype(np.complex64)
        bit_perm = jnp.asarray(g.bit_perm)
        tf_perm = jnp.asarray(g.tf_perm)
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
            dec = rx.bb_decode_bits(rx_grid)
            return jnp.sum(dec != bits, axis=-1)

        return jax.jit(step)

    def run_point_baseband(self, esn0_db: float,
                           n_frames: int | None = None) -> BerPoint:
        """Baseband Monte-Carlo (reference: baseband_test_EsN0,
        telecom_system.cc:96-229): no preamble/sync/mixers/CRC/dispersal —
        complex AWGN applied at the OFDM symbol level with the 1/sqrt(Nfft)
        power normalization; isolates FEC + estimation + demapping. The
        Es/N0 parameter is the clean per-carrier convention (sigma =
        10^(-EsN0/20) on 1/sqrt(Nfft)-normalized symbols), the same
        convention as the documented Es/N0@FER<0.1 table
        (common_defines.h:129-148) — verified against the reference's own
        binary via `golden_gen berbb`."""
        import jax.numpy as jnp

        g = self.geom
        if g.spec.is_mfsk:
            raise ValueError("baseband harness is OFDM-only (reference parity)")
        if self._bb_step is None:
            self._bb_step = self._build_bb_step()
        n_frames = n_frames or self.batch
        rng = np.random.default_rng(self.seed + 17)
        sigma = 10 ** (-esn0_db / 20.0)
        frame_errors = bit_errors = frames = 0
        n_real = g.n_bits - g.ldpc_p
        key = jax.random.key(int(abs(esn0_db) * 977 + 13) & 0x7FFFFFFF)

        while frames < n_frames:
            b = self.batch                  # fixed shape: no tail recompile
            bits = rng.integers(0, 2, (b, n_real)).astype(np.int32)
            key, sub = jax.random.split(key)
            errs = np.asarray(self._bb_step(jnp.asarray(bits),
                                            jnp.float32(sigma), sub))
            take = min(b, n_frames - frames)
            errs = errs[:take]
            frame_errors += int((errs > 0).sum())
            bit_errors += int(errs.sum())
            frames += take
        return BerPoint(esn0_db, frames, frame_errors, bit_errors,
                        frames * n_real)

    def front_end_delta(self, n_noise: int = 32) -> float:
        """Measured conversion between the passband harness's Es/N0
        parameter and the effective per-carrier Es/N0 (the baseband/table
        convention): delta = 10*log10(S/N) at parameter 0 dB, where S is the
        mean data-cell power of the real TX frame after the RX front-end
        (mix -> FIR -> decimate -> FFT) and N is the mean data-cell power of
        unit-parameter passband noise (sigma=1 -> per-sample power 1/2)
        through the same front-end. Effective Es/N0 = parameter + delta.

        Decomposition (documented in docs/esn0_reconciliation.md): the
        broadband->in-band factor 10*log10(f_nyq/BW) = +10.1 dB, TX power,
        pilot/preamble boost share, and FIR passband gain."""
        import jax.numpy as jnp

        g = self.geom
        rng = np.random.default_rng(self.seed + 99)
        payload = rng.integers(0, 256, (1, g.frame_bytes)).astype(np.uint8)
        pb = np.asarray(self.tx.transmit(payload))
        pad = np.zeros((1, pb.shape[-1] + 4 * g.nofdm * g.interp), np.float32)
        pad[:, : pb.shape[-1]] = pb
        data_cells = jnp.asarray(g.data_cells)

        # single jitted program returning a real scalar: one dispatch
        # instead of eager per-op dispatch
        @jax.jit
        def mean_data_cell_power(x):
            iq = self.rx.mix(x, 0.0)
            fr = self.rx.extract_frame_decimated(
                iq, jnp.zeros(x.shape[0], jnp.int32), self.rx.active_nsymb)
            grid = self.rx.demod_grid(fr).reshape(x.shape[0], -1)
            cells = jnp.take(grid, data_cells, axis=-1)
            return jnp.mean(jnp.abs(cells) ** 2)

        s_pow = float(mean_data_cell_power(jnp.asarray(pad)))
        noise = (1.0 / np.sqrt(2.0)) * rng.standard_normal(
            (n_noise, pad.shape[-1])).astype(np.float32)
        n_pow = float(mean_data_cell_power(jnp.asarray(noise)))
        return 10.0 * float(np.log10(s_pow / n_pow))

    def sweep(self, esn0_list, n_frames: int | None = None,
              early_exit_fer: float = 0.0, verbose: bool = False) -> BerSweep:
        """Sweep descending-difficulty points; optional early exit once FER
        reaches `early_exit_fer` (the reference's waterfall early-exit)."""
        out = BerSweep(self.geom.spec.config)
        for e in esn0_list:
            p = self.run_point(e, n_frames)
            out.points.append(p)
            if verbose:
                print(f"cfg{out.config} Es/N0={e:+.1f} dB: FER={p.fer:.3f} "
                      f"BER={p.ber:.5f}")
            if p.fer <= early_exit_fer:
                break
        return out
