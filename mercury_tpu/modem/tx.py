"""Transmit chain: payload bytes -> passband samples, batched and jittable.

Order of operations mirrors the reference transmit_byte/transmit_bit
(telecom_system.cc:342-634): CRC16 append -> energy dispersal -> virtual-bit
duplication -> LDPC encode -> parity relocation -> bit interleave -> PSK/MFSK
map -> time/freq interleave -> framing with pilots -> pre-equalization ->
IFFT+GI -> power normalization -> x4 linear interpolation + carrier mix ->
PAPR clip -> TX FIR cascade.  Everything is a fixed tensor program per mode;
the batch axis carries independent frames (channels).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from mercury_tpu.core import crc as crc_mod
from mercury_tpu.core.geometry import ModeGeometry, PILOT, DATA
from mercury_tpu.dsp import ops
from mercury_tpu.fec import ldpc
from mercury_tpu.fec.tables import load_code
from mercury_tpu.modem import mfsk as mfsk_mod
from mercury_tpu.modem import psk


@dataclass
class TxChain:
    """Per-mode TX program. Construct once, call transmit() on byte batches.

    ctrl=True selects the MFSK short control frame: only the first ctrl_nbits
    interleaved bits are modulated (punctured LDPC), giving ctrl_nsymb
    symbols instead of Nsymb (reference: telecom_system.cc:411-416,2968-2994).
    """
    geom: ModeGeometry
    real_dtype: Any = jnp.float32
    ctrl: bool = False

    def __post_init__(self):
        g = self.geom
        if self.ctrl and not (g.spec.is_mfsk and g.spec.ctrl_nbits > 0):
            raise ValueError("ctrl frames exist only for ROBUST_0/ROBUST_1")
        self.active_nsymb = g.ctrl_nsymb if self.ctrl else g.nsymb
        self.active_nbits = g.spec.ctrl_nbits if self.ctrl else g.n_bits
        self.cdtype = jnp.complex128 if self.real_dtype == jnp.float64 else jnp.complex64
        # complex constants stay numpy: numpy closures embed as HLO
        # literals of the compiled program
        self.np_cdtype = np.complex128 if self.real_dtype == jnp.float64 else np.complex64
        self.code = load_code(g.spec.ldpc_rate_num)
        a, c0 = crc_mod.crc_affine(g.frame_bytes)
        self._crc_a = jnp.asarray(a.astype(np.float32))
        self._crc_c0 = jnp.asarray(c0.astype(np.int32))
        self._dispersal = jnp.asarray(g.dispersal[: g.n_real].astype(np.int32))
        self._bit_perm = jnp.asarray(g.bit_perm)
        self._tf_perm = jnp.asarray(g.tf_perm)
        self._pad_map = jnp.asarray(g.pad_map)
        self._pilot_scatter = jnp.asarray(g.pilot_cells)
        self._data_scatter = jnp.asarray(g.data_cells)
        self._pilot_seq = np.asarray(g.pilot_seq, self.np_cdtype)
        if g.spec.is_mfsk:
            pre = mfsk_mod.preamble_grid(g.mfsk, g.nc, g.preamble_nsymb)
            self._pre_grid = np.asarray(pre, self.np_cdtype)
            self._pre_eq = None
        else:
            pre = g.preamble_vals * g.pre_eq[None, :] if g.pre_eq is not None else g.preamble_vals
            self._pre_grid = np.asarray(pre, self.np_cdtype)
            self._pre_eq = (np.asarray(g.pre_eq, self.np_cdtype)
                            if g.pre_eq is not None else None)
            self._const = np.asarray(g.constellation, self.np_cdtype)
        taps = self.real_dtype
        self._fir_tx1 = jnp.asarray(g.fir_tx1).astype(taps)
        self._fir_tx2 = jnp.asarray(g.fir_tx2).astype(taps)

        # power staging (telecom_system.cc:507-527)
        self._power_norm = float(np.sqrt(g.nfft * g.interp))
        self._amp_data = float(np.sqrt(0.1))     # sqrt(output_power_Watt)
        self._amp_pre = self._amp_data * float(np.sqrt(2.0))  # preamble boost
        if g.spec.is_mfsk:
            boost = np.sqrt(g.nc / g.mfsk.nstreams) * 10 ** (-2.0 / 20.0)
            self._amp_data *= float(boost)
            self._amp_pre *= float(boost)

    # ------------------------------------------------------------------
    def frame_bits(self, payload_bytes: jnp.ndarray) -> jnp.ndarray:
        """payload bytes [B, frame_bytes] (uint8) -> nReal transmit bits
        (pad + CRC16 append, reference transmit_byte)."""
        g = self.geom
        bits = self._bytes_to_bits(payload_bytes)              # [B, frame8]
        crc = jnp.mod(bits.astype(jnp.float32) @ self._crc_a.T, 2.0).astype(jnp.int32)
        crc = jnp.bitwise_xor(crc, self._crc_c0[None])
        waste = g.n_real - g.frame_bytes * 8 - 16
        zeros = jnp.zeros((bits.shape[0], waste), dtype=jnp.int32)
        return jnp.concatenate([bits.astype(jnp.int32), crc, zeros], axis=-1)

    @staticmethod
    def _bytes_to_bits(payload_bytes: jnp.ndarray) -> jnp.ndarray:
        shifts = jnp.arange(8, dtype=jnp.int32)
        b = payload_bytes.astype(jnp.int32)
        bits = (b[..., None] >> shifts) & 1                    # LSB first
        return bits.reshape(*payload_bytes.shape[:-1], -1)

    # ------------------------------------------------------------------
    def encode_bits(self, real_bits: jnp.ndarray) -> jnp.ndarray:
        """dispersal + virtual duplication + LDPC + parity relocation ->
        transmitted bit vector [B, nBits]."""
        g = self.geom
        disp = jnp.bitwise_xor(real_bits, self._dispersal[None])
        u = jnp.concatenate([disp, disp[:, : g.n_virtual]], axis=-1)  # [B, K]
        cw = ldpc.encode(self.code, u)
        return jnp.concatenate([disp, cw[:, self.code.k:]], axis=-1)  # [B, nBits]

    # ------------------------------------------------------------------
    def modulate(self, tx_bits: jnp.ndarray) -> jnp.ndarray:
        """transmitted bits [B, nBits] -> unfiltered passband
        [B, total_frame_size] (message_location == NO_FILTER_MESSAGE)."""
        g = self.geom
        b = tx_bits.shape[0]
        inter = jnp.take(tx_bits, self._bit_perm, axis=-1)

        if g.spec.is_mfsk:
            grid = mfsk_mod.mod(inter[..., : self.active_nbits], g.mfsk, g.nc,
                                self.active_nsymb, self.cdtype)
        else:
            syms = psk.mod(inter, self._const)
            syms = jnp.take(syms, self._tf_perm, axis=-1)
            flat = jnp.zeros((b, g.nsymb * g.nc), dtype=self.cdtype)
            flat = flat.at[:, self._data_scatter].set(syms)
            flat = flat.at[:, self._pilot_scatter].set(
                jnp.broadcast_to(self._pilot_seq, (b, self._pilot_seq.shape[0])))
            grid = flat.reshape(b, g.nsymb, g.nc)
            if self._pre_eq is not None:
                grid = grid * self._pre_eq[None, None, :]

        pre = jnp.broadcast_to(self._pre_grid, (b, *self._pre_grid.shape))

        td_pre = ops.ofdm_mod(pre, self._pad_map, g.nfft, g.ngi)
        td_dat = ops.ofdm_mod(grid, self._pad_map, g.nfft, g.ngi)
        td_pre = td_pre.reshape(b, -1) * (self._amp_pre / self._power_norm)
        td_dat = td_dat.reshape(b, -1) * (self._amp_data / self._power_norm)

        # interpolate each segment separately (the reference calls
        # baseband_to_passband once per segment, so the linear-interp tail
        # extrapolation happens at each segment end), then mix continuously.
        int_pre = ops.linear_interp(td_pre, g.interp)
        int_dat = ops.linear_interp(td_dat, g.interp)
        bb = jnp.concatenate([int_pre, int_dat], axis=-1)
        pb = ops.mix_to_passband(bb, g.fs, g.fc, float(np.sqrt(2.0)), 0)

        n_pre = int_pre.shape[-1]
        clipped_pre = ops.peak_clip(pb[:, :n_pre], 7.0)
        clipped_dat = ops.peak_clip(pb[:, n_pre:], 10.0)
        return jnp.concatenate([clipped_pre, clipped_dat], axis=-1).astype(self.real_dtype)

    # ------------------------------------------------------------------
    def filter_single(self, passband: jnp.ndarray) -> jnp.ndarray:
        """TX FIR cascade for a standalone frame (SINGLE_MESSAGE)."""
        f1 = ops.fir_same(passband, self._fir_tx1)
        return ops.fir_same(f1, self._fir_tx2).astype(self.real_dtype)

    # ------------------------------------------------------------------
    @functools.cached_property
    def _transmit_jit(self):
        @jax.jit
        def run(payload_bytes):
            bits = self.frame_bits(payload_bytes)
            tx_bits = self.encode_bits(bits)
            pb = self.modulate(tx_bits)
            return self.filter_single(pb)
        return run

    @functools.cached_property
    def _transmit_nofilter_jit(self):
        @jax.jit
        def run(payload_bytes):
            bits = self.frame_bits(payload_bytes)
            tx_bits = self.encode_bits(bits)
            return self.modulate(tx_bits)
        return run

    @functools.cached_property
    def _transmit_batch_jit(self):
        @jax.jit
        def run(payload_bytes):
            bits = self.frame_bits(payload_bytes)
            tx_bits = self.encode_bits(bits)
            frames = self.modulate(tx_bits)                     # [B, F] unfiltered
            b, f = frames.shape
            # reference send_batch (arq_common.cc:2236-2248): concatenate the
            # batch, pad one frame-copy at each end, FIR the whole stream so
            # frame boundaries see real neighbours instead of zeros
            stream = jnp.concatenate(
                [frames[0], frames.reshape(-1), frames[-1]])[None]
            f1 = ops.fir_same(stream, self._fir_tx1)
            f2 = ops.fir_same(f1, self._fir_tx2)
            return f2[0, f: f + b * f].reshape(b, f).astype(self.real_dtype)
        return run

    def transmit_batch(self, payload_bytes) -> jnp.ndarray:
        """Batch of frames destined for back-to-back transmission: the TX FIR
        cascade runs over the concatenated stream with edge padding (the
        reference's send_batch overlap filtering), so inter-frame boundaries
        carry real filter tails. Returns [B, total_frame_size]; concatenate
        rows for the air."""
        payload_bytes = jnp.asarray(payload_bytes)
        if payload_bytes.shape[-1] != self.geom.frame_bytes:
            raise ValueError("transmit_batch requires full-width payload rows")
        return self._transmit_batch_jit(payload_bytes)

    def transmit(self, payload_bytes, filtered: bool = True) -> jnp.ndarray:
        """payload bytes [B, <=frame_bytes] -> passband [B, total_frame_size].
        Short payloads are zero-padded to the frame size (the CRC covers the
        padded frame, matching reference transmit_byte semantics)."""
        payload_bytes = jnp.asarray(payload_bytes)
        nb = payload_bytes.shape[-1]
        if nb > self.geom.frame_bytes:
            raise ValueError(
                f"payload is {nb} bytes but {self.geom.spec.config} frames "
                f"carry at most {self.geom.frame_bytes} bytes")
        if nb < self.geom.frame_bytes:
            pad = jnp.zeros((*payload_bytes.shape[:-1],
                             self.geom.frame_bytes - nb), dtype=payload_bytes.dtype)
            payload_bytes = jnp.concatenate([payload_bytes, pad], axis=-1)
        if filtered:
            return self._transmit_jit(payload_bytes)
        return self._transmit_nofilter_jit(payload_bytes)
