"""Receive chain: passband capture buffer -> decoded payload, batched.

Mirrors the reference receive_byte pipeline (telecom_system.cc:646-1518) with
a batch-first control structure: instead of a sequential trial loop with
data-dependent branches, the chain computes the Schmidl-Cox metric for every
offset at once (sync.py), decodes at the best hypothesis, and handles retry
policy by batching hypotheses. All stages are jit-compiled tensor programs;
channel estimation is a single matmul against the precomputed per-mode
operator (geometry.est_op).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from mercury_tpu.core import crc as crc_mod
from mercury_tpu.core.geometry import LS_WINDOW, ModeGeometry
from mercury_tpu.core.modes import ZERO_FORCE
from mercury_tpu.dsp import ops
from mercury_tpu.fec import ldpc
from mercury_tpu.fec.tables import load_code
from mercury_tpu.modem import mfsk as mfsk_mod
from mercury_tpu.modem import psk, sync

PILOT_BOOST = 1.33


@dataclass
class RxResult:
    """Per-frame decode outcome (all arrays batched)."""
    payload: jnp.ndarray        # [B, frame_bytes] uint8
    crc_ok: jnp.ndarray         # [B] bool (CRC self-check passed, not all-zeros)
    delay: jnp.ndarray          # [B] int32 detected frame start (interp samples)
    freq_offset: jnp.ndarray    # [B] float Hz (Moose)
    snr_db: jnp.ndarray         # [B] float
    iters: jnp.ndarray          # [B] int32 LDPC iterations
    sync_metric: jnp.ndarray    # [B] float coarse sync correlation
    mean_h: jnp.ndarray         # [B] float mean |H| at pilots (OFDM only)


class RxChain:
    """Per-mode RX program.

    ctrl=True decodes MFSK short control frames: only ctrl_nsymb symbols are
    demodulated and LLRs beyond ctrl_nbits are zeroed (punctured positions =
    erasures; reference telecom_system.cc:1184-1193).

    cfo_range selects the acquisition profile: "wide" (default) resolves the
    93.75 Hz coarse-CFO alias with a 3-way matched-filter vote and 4 CFO
    hypotheses — clean decode past ±120 Hz at ~30% throughput cost; "narrow"
    covers ~±45 Hz (still 2x the reference's native range) at full speed.
    """

    def __init__(self, geom: ModeGeometry, real_dtype: Any = jnp.float32,
                 ctrl: bool = False, cfo_range: str = "wide",
                 deep_sync: bool | None = None, ldpc_algo: str = "layered",
                 deep_profile: str = "pruned",
                 deep_coherent: bool | None = None, deep_topn: int = 16,
                 dd: bool | None = None, bicm_iters: int | None = None,
                 dd_window: tuple[int, int] | None = None,
                 dd_passes: int = 1, ldpc_max_iter: int = 50,
                 llr_scale: float | None = None, mfsk_soft: str = "sumexp",
                 mfsk_noise_pool: bool = True, mfsk_sync_cands: int = 2,
                 mfsk_exp_scale: float = 1.0, mfsk_clamp: float = 5.0):
        self.geom = geom
        self.real_dtype = real_dtype
        # LDPC iteration cap (reference default 50, -I flag / INI
        # LDPCIterationsMax); runtime changes via set_ldpc_max_iter
        self.ldpc_max_iter = int(ldpc_max_iter)
        if ctrl and not (geom.spec.is_mfsk and geom.spec.ctrl_nbits > 0):
            raise ValueError("ctrl frames exist only for ROBUST_0/ROBUST_1")
        if cfo_range not in ("wide", "narrow"):
            raise ValueError("cfo_range must be 'wide' or 'narrow'")
        self.cfo_range = cfo_range
        if deep_sync is None:
            # auto: the configs whose FEC waterfall sits below the blind
            # Schmidl-Cox acquisition floor (~-3 dB effective per-carrier,
            # docs/esn0_reconciliation.md §4) get the global known-preamble
            # acquisition; everything else doesn't need it and keeps the
            # cheaper coarse search (CONFIG_0-4 thresholds: -10..-3.5 dB)
            deep_sync = (not geom.spec.is_mfsk) and geom.spec.config <= 4
        self.deep_sync = bool(deep_sync)
        if deep_profile not in ("pruned", "c2f", "full"):
            raise ValueError("deep_profile must be 'pruned', 'c2f' or "
                             "'full'")
        # "pruned" (default): the whole-buffer known-preamble scan with the
        # CFO grid pruned 15 -> 30 Hz (17 -> 9 hypotheses wide) and every
        # hypothesis entering final arbitration directly — halves the
        # whole-buffer scan's correlation work; the <=15 Hz grid residual
        # is inside Moose's +-23.4 Hz pull-in at decode, and threshold FER
        # is unchanged at 1024 frames. "c2f": scan nominates top-N
        # candidates into the per-candidate refinement — same FER, kept
        # for study. "full": round-3 behavior (15 Hz grid).
        self.deep_profile = deep_profile
        # c2f tuning knobs: coarse-scan extra time decimation, coarse CFO
        # grid spacing (Hz), and how many top (delay, CFO) rows the refine
        # stage re-scores
        self._c2f_decim = 1
        self._c2f_grid_hz = 30.0
        self._c2f_topn = 4
        self._c2f_lp = None           # preamble symbols in the scan (None=all)
        self._c2f_refine_offsets = True   # add +-grid/2 to the refine bank
        # whole-buffer scan grid spacing for the pruned/full profiles
        self._deep_grid_hz = 30.0 if deep_profile == "pruned" else 15.0
        # Coherent deep acquisition (round 5, docs/acq_floor_r5.md): the
        # noncoherent scan NOMINATES deep_topn distinct peaks per CFO row;
        # a fully-coherent re-score over a fine static CFO grid (inter-
        # symbol phase compensated, sync.coherent_preamble_rescore) then
        # arbitrates all candidates — recovering the ~1 dB noncoherent
        # combining loss that set the cfg0 passband acquisition floor.
        # deep_coherent=None (default) resolves per config: True only for
        # CONFIG_0 — the one mode whose operating floor sits at the
        # acquisition limit; cfg1-4's round-4 campaign already measured
        # passband == baseband with the cheap argmax arbitration
        # (docs/ber_r4b.json), so the coherent surface would be pure cost
        # there.
        if deep_coherent is None:
            deep_coherent = (not geom.spec.is_mfsk
                             and geom.spec.config == 0)
        self.deep_coherent = bool(deep_coherent)
        self._deep_topn = int(deep_topn)
        self._deep_coh_grid_hz = 4.0
        # CRC-gated second-candidate decode for the deep-acquisition path
        # (round 5): when the primary decode fails CRC, decode once more at
        # the runner-up pilot-arbitration start (outside the winner's GI
        # plateau). lax.cond keeps clean-batch throughput untouched.
        self._deep_rescue = True
        # pilot-extended arbitration: re-score the top-M coherent
        # candidates against the pilot-only symbol waveforms (7x the
        # preamble's integrable energy at cfg0 — sync.pilot_rescore).
        # M=32 with topn=16 nominees (round 5): the acq-floor ranks put
        # the true start at coherent ranks 8-15+ in ~1/3 of residual
        # misses (tools/acq_floor_r5.py) — letting the higher-energy pilot
        # metric arbitrate the whole deep shortlist walks cfg0 @ eff
        # -9.75 down 0.109 -> 0.098 (M=16) -> 0.090 (topn12/M=24) ->
        # 0.082 (topn16/M=32) on identical realizations (CPU A/B ladder,
        # docs/ber_r5.json)
        self._deep_pil_topm = 32
        if ldpc_algo not in ("spa", "minsum", "layered", "layered-minsum"):
            raise ValueError("ldpc_algo must be 'spa', 'minsum', 'layered' "
                             "or 'layered-minsum'")
        # OFDM demapper LLR calibration: max-log LLRs into a tanh-BP are
        # slightly overconfident (miscalibration grows at the low-rate
        # configs where 15/16 of the codeword is parity); a 0.9 shrink is
        # the standard remedy and measures neutral-or-better at EVERY
        # ladder point (docs/ladder_floor_r4.md A/B) — it is one of the two
        # changes that close the cfg0/1/6 floor gaps vs the documented
        # thresholds. llr_scale=1.0 restores the uncalibrated demapper;
        # None (the default) resolves to the calibrated value so an
        # explicitly-passed 0.9 is honored even at rate 1/16.
        if llr_scale is None:
            # rate-dependent calibration: at rate 1/16 (15/16 of the
            # codeword is parity) the max-log overconfidence amplifies
            # through more BP mixing — 0.85 measures strictly better at
            # the cfg0 threshold (batch-256 realization: FER 0.0791 ->
            # 0.0732 on CPU) and the rate is used by cfg0/ROBUST only
            # (MFSK has its own demod scale, unaffected)
            llr_scale = 0.85 if geom.spec.ldpc_rate_num == 1 else 0.9
        self.llr_scale = float(llr_scale)
        self._llr_scale_f = np.float32(llr_scale)
        # MFSK demod (round 4, docs/ladder_floor_r4.md): sumexp = proper
        # noncoherent marginalization over the tone hypotheses instead of
        # the reference's max-log; noise_pool = frame-pooled out-of-band
        # noise estimate (the per-symbol 18-bin estimate's variance was the
        # single largest ROBUST_0 loss: -13 dB fixed-delay FER 0.109 ->
        # 0.027 with both). mfsk_soft="maxlog", mfsk_noise_pool=False
        # restore reference-parity demod behavior.
        self.mfsk_soft = mfsk_soft
        self.mfsk_noise_pool = bool(mfsk_noise_pool)
        self.mfsk_exp_scale = float(mfsk_exp_scale)
        self.mfsk_clamp = float(mfsk_clamp)
        self._mfsk_sync_cands = int(mfsk_sync_cands)
        # layered default (round 4): the matmul-redistribution
        # variable-disjoint layered schedule (fec/ldpc.py:decode_mm) makes
        # ~2x the per-sweep progress of flooding at the same 50-sweep
        # reference budget — at the rate-1/16..8/16 floor configs that is
        # the difference between missing and MEETING the documented
        # thresholds (cfg0 -10.0 / cfg1 -7.5 / cfg6 -1.5:
        # docs/ladder_floor_r4.md; FER <= flooding SPA at every other
        # ladder point, measured at 1024 frames in round 3). 'spa'/'minsum'
        # keep the flooding schedule (spa = the r2/r3 BER campaign decoder).
        self.ldpc_algo = ldpc_algo
        if dd is None:
            # auto: decision-directed re-estimation pays where channel
            # estimation noise (not FEC strength) sets the waterfall — the
            # 8PSK/16QAM/32QAM modes (CONFIG_10/11/13/14/15/16). The decoded
            # codeword turns every data cell into a virtual pilot; the
            # re-estimate averages ~window^2 cells instead of the sparse
            # pilot lattice. Runs only on rows whose first BP pass failed to
            # converge (lax.cond skips the whole pass when all converge), so
            # the clean-signal throughput cost is ~zero. The reference has
            # no equivalent (its estimator is strictly pilot-driven,
            # ofdm.cc:1266-1451) — this is where the framework out-designs
            # it at the top of the mode ladder.
            dd = (not geom.spec.is_mfsk and not ctrl
                  and geom.estimator != ZERO_FORCE
                  and geom.constellation is not None
                  and len(geom.constellation) >= 8)
        if dd and (geom.spec.is_mfsk or geom.estimator == ZERO_FORCE):
            raise ValueError("decision-directed estimation requires an OFDM "
                             "mode with the LS estimator")
        self.dd = bool(dd)
        # BICM-ID (round 5): feed the decoder extrinsics back into a full
        # log-MAP demapper as symbol priors and re-decode, bicm_iters
        # times, on rows whose first BP pass failed (psk.demod_full /
        # _bicm_decode). The A/B at the cfg13-16 documented thresholds is
        # docs/bicm_id_r5.md: ~0.4-0.5 dB at CONFIG_16 (whose 32QAM cross
        # mapping is non-Gray, nearest-neighbor Hamming 1.154) and
        # measured-nil at the perfectly-Gray cfg13/14/15 mappings — so the
        # auto default (None) turns it on for 32QAM only. Runs only on
        # rows whose first BP pass failed (lax.cond-gated), so the
        # clean-signal cost is ~zero.
        if bicm_iters is None:
            bicm_iters = 2 if (not geom.spec.is_mfsk
                               and not ctrl
                               and geom.constellation is not None
                               and len(geom.constellation) == 32
                               and ldpc_algo in ("layered",
                                                 "layered-minsum")) else 0
        if bicm_iters and (geom.spec.is_mfsk or geom.constellation is None):
            raise ValueError("bicm_iters requires an OFDM mode")
        if bicm_iters and ldpc_algo not in ("layered", "layered-minsum"):
            raise ValueError("bicm_iters requires the layered decoder "
                             "(soft posterior output)")
        self.bicm_iters = int(bicm_iters)
        # dd_window (symbols, carriers): the smoothing span of the DD
        # re-estimate. Default = the pilot LS window (best on AWGN/static
        # channels). Fading channels want a NARROW time window — e.g. (5, 9)
        # tracks ~1 Hz Doppler across a multi-second frame, the thing the
        # per-frame pilot estimator cannot do (docs/fading_r2.md) — which
        # the dense virtual-pilot lattice affords but the sparse pilot
        # lattice does not. dd_passes > 1 iterates the re-estimation
        # (decisions from pass k re-estimate pass k+1), crawling into fades.
        if dd_window is None:
            dd_window = (LS_WINDOW, LS_WINDOW)
        if dd_window[0] % 2 == 0 or dd_window[1] % 2 == 0:
            raise ValueError("dd_window spans must be odd")
        self.dd_window = (int(dd_window[0]), int(dd_window[1]))
        self.dd_passes = int(dd_passes)
        self.ctrl = ctrl
        self.active_nsymb = geom.ctrl_nsymb if ctrl else geom.nsymb
        self.active_nbits = geom.spec.ctrl_nbits if ctrl else geom.n_bits
        self.cdtype = jnp.complex128 if real_dtype == jnp.float64 else jnp.complex64
        self.np_cdtype = np.complex128 if real_dtype == jnp.float64 else np.complex64
        g = geom
        self.code = load_code(g.spec.ldpc_rate_num)
        self._osc_cache: dict = {}
        self._fir_ts = jnp.asarray(g.fir_rx_ts).astype(real_dtype)
        self._fir_data = jnp.asarray(g.fir_rx_data).astype(real_dtype)
        self._pad_map = jnp.asarray(g.pad_map)
        self._bit_iperm = jnp.asarray(g.bit_iperm)
        self._tf_iperm = jnp.asarray(g.tf_iperm)
        self._data_cells = jnp.asarray(g.data_cells)
        self._pilot_cells = jnp.asarray(g.pilot_cells)
        self._dispersal = jnp.asarray(g.dispersal[: g.n_real].astype(np.int32))
        if not g.spec.is_mfsk:
            self._pilot_seq = np.asarray(g.pilot_seq, self.np_cdtype)
            self._est_op = jnp.asarray(g.est_op).astype(real_dtype)
            self._const = np.asarray(g.constellation, self.np_cdtype)
            self._bit_perm = jnp.asarray(g.bit_perm)
            self._tf_perm = jnp.asarray(g.tf_perm)
            if g.estimator == ZERO_FORCE:
                # Leave-one-out pilot smoother for the ZF noise estimate:
                # each pilot's channel predicted from its k nearest pilot
                # neighbours on the (symbol, carrier) lattice. The residual
                # |h_meas - h_loo| isolates estimation noise even though the
                # ZF estimate itself passes exactly through the measurements
                # (a post-eq pilot residual is identically 0 for ZF, and the
                # pre-eq residual absorbs the timing phase ramp — both are
                # unusable as an LLR scale).
                k_nn = 4
                s_pil = (g.pilot_cells // g.nc).astype(np.float64)
                c_pil = (g.pilot_cells % g.nc).astype(np.float64)
                npil = len(g.pilot_cells)
                # distance in lattice units; symbols weighted by Dy spacing
                d2 = ((s_pil[:, None] - s_pil[None, :]) ** 2
                      + (c_pil[:, None] - c_pil[None, :]) ** 2)
                np.fill_diagonal(d2, np.inf)
                s_loo = np.zeros((npil, npil), np.float64)
                for i in range(npil):
                    nn = np.argsort(d2[i])[:k_nn]
                    s_loo[i, nn] = 1.0 / k_nn
                self._loo_op = jnp.asarray(s_loo.astype(np.float32))
                self._loo_scale = k_nn / (k_nn + 1.0)
            else:
                # Ramp-aware LS: the windowed-LS smoother cannot track the
                # linear phase ramp a (deliberate, ±quantization) timing
                # offset paints across carriers — plain window averaging
                # attenuates it into an estimation-bias floor (~-19 dB MER
                # on the reference's own high-SNR captures). Precompute
                # same-symbol carrier-adjacent pilot pairs; at run time the
                # pair-correlation angle gives the per-bin slope, the pilot
                # measurements are de-rotated before the smoothing matmul
                # and the full grid re-rotated after (exact for a pure
                # timing ramp, noise-robust: one angle from ~nPil pairs).
                s_of_r = g.pilot_cells // g.nc
                c_of_r = g.pilot_cells % g.nc
                # signed FFT bins: pad_map wraps mid-band (…255, 1…) but the
                # timing ramp exp(j 2π t_off bin/Nfft) is continuous in the
                # SIGNED frequency — using raw bin numbers would put a
                # slope*254 phase tear through the middle of the band
                pm = np.asarray(g.pad_map).astype(np.float64)
                pm_signed = np.where(pm >= g.nfft / 2, pm - g.nfft, pm)
                bins = pm_signed[c_of_r]
                pair_a, pair_b, dbins = [], [], []
                for s_row in np.unique(s_of_r):
                    kk = np.nonzero(s_of_r == s_row)[0]
                    kk = kk[np.argsort(bins[kk])]
                    for i in range(len(kk) - 1):
                        a_i, b_i = kk[i + 1], kk[i]
                        pair_a.append(a_i)
                        pair_b.append(b_i)
                        dbins.append(bins[a_i] - bins[b_i])
                dbins = np.asarray(dbins)
                dmin = dbins.min()
                keep = dbins == dmin     # uniform spacing -> single angle
                self._ramp_a = jnp.asarray(np.asarray(pair_a)[keep])
                self._ramp_b = jnp.asarray(np.asarray(pair_b)[keep])
                self._ramp_dbin = float(dmin)
                # long-lag refinement pairs: the slope-estimate noise scales
                # as 1/lag, and single-short-lag noise times the smoothing
                # window span costs ~1 dB at 32QAM (measured, cfg16 baseband
                # 16.0 dB FER 0.012 no-noise vs 0.254 single-lag). Pick the
                # most frequent exact bin lag in (2*dmin, 12] — inside the
                # |slope| < 2*pi*10/256 wrap limit — and refine the coarse
                # angle with it. Falls back to single-lag when the lattice
                # offers no such pairs.
                la, lb, ld = [], [], []
                for s_row in np.unique(s_of_r):
                    kk = np.nonzero(s_of_r == s_row)[0]
                    bb_s = bins[kk]
                    for i in range(len(kk)):
                        for j2 in range(len(kk)):
                            d = bb_s[i] - bb_s[j2]
                            if 2 * dmin < d <= 12.0:
                                la.append(kk[i])
                                lb.append(kk[j2])
                                ld.append(d)
                if ld:
                    ld = np.asarray(ld)
                    vals, cnts = np.unique(ld, return_counts=True)
                    l2 = vals[np.argmax(cnts)]
                    sel = ld == l2
                    self._ramp2_a = jnp.asarray(np.asarray(la)[sel])
                    self._ramp2_b = jnp.asarray(np.asarray(lb)[sel])
                    self._ramp2_dbin = float(l2)
                else:
                    self._ramp2_a = None
                self._pil_bins = np.asarray(bins, np.float32)
                cell_bins = pm_signed[
                    np.arange(g.nsymb * g.nc) % g.nc].astype(np.float32)
                self._cell_bins = np.asarray(cell_bins)
                # timing error is bounded by the MF grid + the -8 advance:
                # |t_off| < 10 base samples -> |slope| < 2*pi*10/256
                self._ramp_max = float(2 * np.pi * 10.0 / g.nfft)
            # CFO-hypothesis selection operators: the per-hypothesis metric
            # (pilot variance) needs only the pilot cells, so instead of a
            # full FFT demod per hypothesis the pilots are extracted with a
            # per-symbol partial DFT (a matmul): [S, maxP, Nfft] operator
            # + slot map back to pilot_cells order, plus the pilot-row slice
            # of the channel-estimation operator.
            s_of = g.pilot_cells // g.nc
            c_of = g.pilot_cells % g.nc
            k_bins = np.asarray(g.pad_map)[c_of].astype(np.float64)
            t_fft = np.arange(g.nfft, dtype=np.float64)
            rows = np.exp(-2j * np.pi * np.outer(k_bins, t_fft) / g.nfft) / g.nfft
            counts = np.bincount(s_of, minlength=g.nsymb)
            maxp = int(counts.max())
            pil_op = np.zeros((g.nsymb, maxp, g.nfft), np.complex128)
            pil_slot = np.zeros(len(s_of), np.int64)
            fill = np.zeros(g.nsymb, np.int64)
            for i, s in enumerate(s_of):
                pil_op[s, fill[s]] = rows[i]
                pil_slot[i] = s * maxp + fill[s]
                fill[s] += 1
            self._pil_dft_op = np.asarray(pil_op, self.np_cdtype)
            self._pil_slot = jnp.asarray(pil_slot)
            self._est_pil_op = jnp.asarray(
                np.asarray(g.est_op)[g.pilot_cells]).astype(real_dtype)
            if self.dd:
                # Decision-directed constants: a gather map placing the
                # re-encoded symbol decisions (tf-deint order, as produced by
                # _reencode_symbols) and the known pilots onto the flat grid
                # (unused cells -> the trailing zero slot, weight 0 in the
                # weighted window estimate), plus unnormalized box-window
                # matrices for the separable (symbol x carrier) smoothing
                # H = box(y x*) / box(|x|^2) — the same window span as the
                # pilot LS estimator, but averaging every cell.
                npil = len(g.pilot_cells)
                ndata = len(g.data_cells)
                src = np.full(g.nsymb * g.nc, npil + ndata, np.int64)
                src[np.asarray(g.pilot_cells)] = np.arange(npil)
                dc_sym = np.asarray(g.data_cells)[np.asarray(g.tf_iperm)]
                src[dc_sym] = npil + np.arange(ndata)
                self._dd_src = jnp.asarray(src)
                half_s, half_c = self.dd_window[0] // 2, self.dd_window[1] // 2
                idx_s = np.arange(g.nsymb)
                idx_c = np.arange(g.nc)
                self._dd_box_s = jnp.asarray(
                    (np.abs(idx_s[:, None] - idx_s[None, :]) <= half_s
                     ).astype(np.float32)).astype(real_dtype)
                self._dd_box_c = jnp.asarray(
                    (np.abs(idx_c[:, None] - idx_c[None, :]) <= half_c
                     ).astype(np.float32)).astype(real_dtype)
        # known-preamble matched-filter templates (interp-rate waveforms)
        from mercury_tpu.core import hostdsp
        if g.spec.is_mfsk:
            pre_vals = mfsk_mod.preamble_grid(g.mfsk, g.nc, g.preamble_nsymb)
        else:
            pre_vals = g.preamble_vals
            if g.pre_eq is not None:
                pre_vals = pre_vals * g.pre_eq[None, :]
        td = np.concatenate([
            hostdsp.symbol_mod(pre_vals[l], g.nfft, g.ngi, 1)
            for l in range(g.preamble_nsymb)])
        tmpl = hostdsp.linear_interp_x4(td, g.interp)
        self._mf_templates = np.asarray(
            tmpl.reshape(g.preamble_nsymb, g.nofdm * g.interp), self.np_cdtype)
        if self.deep_sync and not g.spec.is_mfsk:
            # per-symbol PILOT-ONLY waveforms for the pilot-extended
            # arbitration (sync.pilot_rescore): the frame grid with data
            # cells zeroed, pre-equalized exactly like TX (tx.py:modulate)
            flat_p = np.zeros(g.nsymb * g.nc, np.complex128)
            flat_p[np.asarray(g.pilot_cells)] = np.asarray(g.pilot_seq)
            grid_p = flat_p.reshape(g.nsymb, g.nc)
            if g.pre_eq is not None:
                grid_p = grid_p * np.asarray(g.pre_eq)[None, :]
            td_p = np.concatenate([
                hostdsp.symbol_mod(grid_p[s], g.nfft, g.ngi, 1)
                for s in range(g.nsymb)])
            tp = hostdsp.linear_interp_x4(td_p, g.interp)
            self._pil_templates = np.asarray(
                tp.reshape(g.nsymb, g.nofdm * g.interp), self.np_cdtype)

        # route the decimating FIRs through the banded-Toeplitz matmul on
        # accelerator backends; the direct conv is faster on CPU
        self._mm_fir = jax.default_backend() != "cpu"

        ncheck = g.frame_bytes + 2
        a, c0 = crc_mod.crc_affine(ncheck)
        self._crc_a = jnp.asarray(a.astype(np.float32))
        self._crc_c0 = jnp.asarray(c0.astype(np.int32))
        self._crc_nbits = ncheck * 8

    # ------------------------------------------------------------------
    def _osc_const(self, n: int, t0: int = 0) -> np.ndarray:
        """sqrt(2)*exp(+j*2*pi*fc/fs*(t0+i)) for i in [0, n): the f=0 mixer
        oscillator is batch-invariant, so it is built once on the host (in
        float64, better than the on-device float32 phase) and embedded as a
        jit constant — the mixer becomes one vector multiply instead of
        2n transcendentals per call."""
        arr = self._osc_cache.get((n, t0))
        if arr is None:
            g = self.geom
            t = t0 + np.arange(n, dtype=np.float64)
            ph = (2 * np.pi * g.fc / g.fs) * t
            arr = (np.sqrt(2.0) * (np.cos(ph) + 1j * np.sin(ph))
                   ).astype(self.np_cdtype)
            self._osc_cache[(n, t0)] = arr
        return arr

    def mix(self, pb: jnp.ndarray, freq_offset=0.0) -> jnp.ndarray:
        """Passband [B, n] -> complex IQ at fc + freq_offset (no filtering)."""
        g = self.geom
        n = pb.shape[-1]
        if isinstance(freq_offset, (int, float)) and freq_offset == 0.0:
            return pb.astype(self.real_dtype) * self._osc_const(n)
        t = jnp.arange(n, dtype=self.real_dtype)
        f = jnp.asarray(freq_offset, dtype=self.real_dtype)
        f = jnp.reshape(f, (-1, 1)) if f.ndim else f
        ph = (2 * np.pi / g.fs) * (g.fc + f) * t
        return pb.astype(self.real_dtype) * np.sqrt(2.0) * (jnp.cos(ph) + 1j * jnp.sin(ph))

    def to_baseband(self, pb: jnp.ndarray, freq_offset=0.0, data_fir: bool = True):
        """Passband [B, n] -> interpolated-rate complex baseband, mixed at
        fc + freq_offset ([B] or scalar), FIR filtered (reference
        passband_to_baseband with decimation_rate=1)."""
        taps = self._fir_data if data_fir else self._fir_ts
        return ops.fir_same(self.mix(pb, freq_offset), taps)

    def measure_signal_dbm(self, pb: jnp.ndarray) -> jnp.ndarray:
        """Idle-channel signal strength in dBm re 1 mW, batched [B, n] ->
        [B] (reference measure_signal_only, telecom_system.cc:1520-1541:
        passband -> baseband through the time-sync FIR at full rate, then
        mean complex power -> 10*log10(P/1mW), ofdm.cc:1523-1539). Used on
        capture windows that decode nothing — the noise-floor / busy-channel
        evidence the decoded-frame SNR cannot provide."""
        if getattr(self, "_measure_jit", None) is None:
            def _m(x):
                bb = self.to_baseband(x, data_fir=False)
                p = jnp.mean(jnp.real(bb) ** 2 + jnp.imag(bb) ** 2, axis=-1)
                return 10.0 * jnp.log10(jnp.maximum(p, 1e-30) / 1e-3)
            self._measure_jit = jax.jit(_m)
        return self._measure_jit(pb)

    def extract_frame_decimated(self, iq: jnp.ndarray, delay: jnp.ndarray,
                                n_symb: int) -> jnp.ndarray:
        """Frame extraction fused with the data FIR: slice the *unfiltered*
        IQ segment at per-row delay and run a polyphase decimating FIR that
        produces exactly the base-rate samples the demodulator reads.
        Replaces [full-buffer FIR at interp rate -> slice -> ::interp]
        (identical values, ~interp x buffer/frame less filter work)."""
        g = self.geom
        ntaps = self._fir_data.shape[0]
        center = (ntaps - 1) // 2
        frame_interp = g.nofdm * (n_symb + g.preamble_nsymb) * g.interp
        seg_len = frame_interp + ntaps - 1
        # pad so the segment window never clamps (clamping would silently
        # shift the filter alignment by up to `center` samples at the edges)
        iq_pad = jnp.pad(iq, [(0, 0), (center, ntaps)])
        start = jnp.clip(delay.astype(jnp.int32), 0,
                         iq_pad.shape[-1] - seg_len)

        def slice_one(row, st):
            return jax.lax.dynamic_slice(row, (st,), (seg_len,))

        seg = jax.vmap(slice_one)(iq_pad, start)
        return ops.fir_decimate_segment(seg, self._fir_data, g.interp)

    def extract_frame_decimated_pb(self, pb: jnp.ndarray, delay: jnp.ndarray,
                                   n_symb: int) -> jnp.ndarray:
        """extract_frame_decimated fused with the f=0 mixer: slice the REAL
        passband at per-row delay, multiply by the matching slice of the
        precomputed oscillator constant, then run the polyphase decimating
        data FIR. Identical values to mix(pb,0) -> extract_frame_decimated,
        but the full-buffer complex IQ array is never materialized."""
        g = self.geom
        ntaps = self._fir_data.shape[0]
        center = (ntaps - 1) // 2
        frame_interp = g.nofdm * (n_symb + g.preamble_nsymb) * g.interp
        seg_len = frame_interp + ntaps - 1
        pb_pad = jnp.pad(pb.astype(self.real_dtype), [(0, 0), (center, ntaps)])
        osc = jnp.asarray(self._osc_const(pb_pad.shape[-1], -center))
        start = jnp.clip(delay.astype(jnp.int32), 0,
                         pb_pad.shape[-1] - seg_len)

        def slice_pb(row, st):
            return jax.lax.dynamic_slice(row, (st,), (seg_len,))

        seg_pb = jax.vmap(slice_pb)(pb_pad, start)
        if self._mm_fir:
            # fold the mixer into complex FIR taps + an output-rate rotation:
            # one anchor value per row from the float64-phase oscillator
            # table times a host-constant step vector (one gather per row,
            # not per sample) — the complex full-rate segment never exists
            # (ops.fir_decimate_mix_mm)
            n_out = frame_interp // g.interp
            w_rad = 2 * np.pi * g.fc / g.fs
            step_key = ("mix_step", n_out, g.interp)
            step = self._osc_cache.get(step_key)
            if step is None:
                m = np.arange(n_out, dtype=np.float64) * g.interp
                step = np.exp(1j * w_rad * m).astype(self.np_cdtype)
                self._osc_cache[step_key] = step
            osc_start = jnp.take(osc, start, axis=0)           # [B]
            ofac = osc_start[:, None] * jnp.asarray(step)[None]
            return ops.fir_decimate_mix_mm(seg_pb, self._fir_data, g.interp,
                                           n_out, w_rad, ofac)
        osc_seg = jax.vmap(
            lambda st: jax.lax.dynamic_slice(osc, (st,), (seg_len,)))(start)
        seg = seg_pb * osc_seg
        return ops.fir_decimate_segment(seg, self._fir_data, g.interp)

    # ------------------------------------------------------------------
    def extract_frame(self, bb: jnp.ndarray, delay: jnp.ndarray) -> jnp.ndarray:
        """Slice the frame at per-row delay and decimate to base rate."""
        g = self.geom
        frame_len = g.nofdm * (self.active_nsymb + g.preamble_nsymb) * g.interp

        def slice_one(row, d):
            return jax.lax.dynamic_slice(row, (d,), (frame_len,))

        frames = jax.vmap(slice_one)(bb, delay.astype(jnp.int32))
        return frames[..., :: g.interp]

    # ------------------------------------------------------------------
    def demod_grid(self, frame_decim: jnp.ndarray) -> jnp.ndarray:
        """Decimated frame [B, (P+S)*Nofdm] -> carrier grid [B, S, Nc]."""
        g = self.geom
        b = frame_decim.shape[0]
        data = frame_decim[..., g.preamble_nsymb * g.nofdm:]
        sym = data.reshape(b, self.active_nsymb, g.nofdm)
        return ops.ofdm_demod(sym, self._pad_map, g.nfft, g.ngi)

    # ------------------------------------------------------------------
    def grid_stats(self, grid: jnp.ndarray):
        """AGC + channel estimation + equalization for one carrier grid.
        Returns (equalized flat grid, variance, mean_h, var_full)."""
        eq, variance, mean_h, var_full, _flat, _slope = \
            self._grid_stats_internal(grid)
        return eq, variance, mean_h, var_full

    def _grid_stats_internal(self, grid: jnp.ndarray):
        """grid_stats plus the internals the decision-directed second pass
        needs: the AGC'd flat grid and the estimated timing-ramp slope
        (zeros for the ZF estimator, which has no ramp model)."""
        g = self.geom
        b = grid.shape[0]
        flat = grid.reshape(b, -1)
        y_pil = jnp.take(flat, self._pilot_cells, axis=-1)
        gain = PILOT_BOOST / jnp.mean(jnp.abs(y_pil), axis=-1, keepdims=True)
        flat = flat * gain
        y_pil = y_pil * gain
        if g.estimator != ZERO_FORCE:
            # ramp-aware LS: de-rotate the timing phase ramp before the
            # smoothing matmul, re-rotate the smoothed grid (see __init__)
            h_meas = y_pil / self._pilot_seq
            pa = jnp.take(h_meas, self._ramp_a, axis=-1)
            pb = jnp.take(h_meas, self._ramp_b, axis=-1)
            corr = jnp.sum(pa * jnp.conj(pb), axis=-1)
            # coherence shrinkage: |corr|/Σ|pa||pb| ≈ |h|²/(|h|²+σ²) — near 1
            # on clean signals (full ramp correction), near 0 at threshold
            # SNR where the pair angle is noise (falls back to plain LS
            # instead of injecting a random ramp; cfg0 at -9 dB effective
            # lost frames without this)
            denom = jnp.sum(jnp.abs(pa) * jnp.abs(pb), axis=-1)
            coh = jnp.abs(corr) / jnp.maximum(denom, 1e-30)
            slope = (coh * jnp.arctan2(corr.imag, corr.real)
                     / self._ramp_dbin)
            if self._ramp2_a is not None:
                # long-lag refinement: unwrap against the coarse slope,
                # residual angle / lag is ~lag/dmin times less noisy
                qa = jnp.take(h_meas, self._ramp2_a, axis=-1)
                qb = jnp.take(h_meas, self._ramp2_b, axis=-1)
                corr2 = jnp.sum(qa * jnp.conj(qb), axis=-1)
                corr2 = corr2 * jnp.exp(-1j * slope * self._ramp2_dbin)
                den2 = jnp.sum(jnp.abs(qa) * jnp.abs(qb), axis=-1)
                coh2 = jnp.abs(corr2) / jnp.maximum(den2, 1e-30)
                slope = slope + (coh2 * jnp.arctan2(corr2.imag, corr2.real)
                                 / self._ramp2_dbin)
            slope = jnp.clip(slope, -self._ramp_max,
                             self._ramp_max).astype(self.real_dtype)
            rot_p = jnp.exp(-1j * slope[:, None]
                            * jnp.asarray(self._pil_bins)[None]
                            ).astype(self.cdtype)
            y_est = y_pil * rot_p
            # HIGHEST precision: the estimation smoothing runs on noise-
            # dominated pilots at threshold SNR — a reduced-precision
            # (bf16 or TF32) matmul adds estimation noise exactly where the
            # floor configs live (it moved FER at the borderline cfg0/-10
            # point); the operator is tiny, the cost is invisible next to
            # the FIR/FFT stages
            hp = jax.lax.Precision.HIGHEST
            h = (jnp.matmul(y_est.real, self._est_op.T, precision=hp)
                 + 1j * jnp.matmul(y_est.imag, self._est_op.T, precision=hp))
            h = h * jnp.exp(1j * slope[:, None]
                            * jnp.asarray(self._cell_bins)[None]
                            ).astype(self.cdtype)
        else:
            hp = jax.lax.Precision.HIGHEST
            h = (jnp.matmul(y_pil.real, self._est_op.T, precision=hp)
                 + 1j * jnp.matmul(y_pil.imag, self._est_op.T, precision=hp))
            slope = jnp.zeros(b, self.real_dtype)
        h_pil = jnp.take(h, self._pilot_cells, axis=-1)
        mean_h = jnp.mean(jnp.abs(h_pil), axis=-1)
        if g.spec.amplitude_restoration:
            h_eq = h / jnp.maximum(jnp.abs(h), 1e-30)
        else:
            h_eq = h
        eq = flat / h_eq
        if g.estimator == ZERO_FORCE:
            # ZF noise estimate via leave-one-out pilot smoothing: the ZF
            # estimate passes exactly through the pilot measurements, so the
            # post-eq pilot residual is identically ~0 — scaling LLRs by its
            # inverse turns them into near-hard decisions and costs ~5-7 dB
            # at 16QAM/32QAM rate-14/16 (found by the r2 BER campaign). The
            # residual against the k-NN-predicted channel isolates the
            # per-pilot noise; x k/(k+1) corrects the prediction's own noise.
            h_meas = y_pil / self._pilot_seq
            h_loo = ((h_meas.real @ self._loo_op.T)
                     + 1j * (h_meas.imag @ self._loo_op.T))
            resid = (h_meas - h_loo) * self._pilot_seq
            variance = (jnp.mean(jnp.abs(resid) ** 2, axis=-1)
                        * self._loo_scale)
        else:
            # LS: residual of the equalized pilots against the known
            # sequence (the smoothed estimate does not pass through the
            # measurements, so this is a proper noise measure — and unlike
            # the reference's pre-eq measure_variance it does not absorb
            # the sampling-offset phase ramp)
            eq_pil = jnp.take(eq, self._pilot_cells, axis=-1)
            variance = jnp.mean(jnp.abs(eq_pil - self._pilot_seq) ** 2,
                                axis=-1)
        eq_full_pil = y_pil / h_pil
        var_full = jnp.mean(jnp.abs(eq_full_pil - self._pilot_seq) ** 2, axis=-1)
        return eq, variance, mean_h, var_full, flat, slope

    # ------------------------------------------------------------------
    def _ofdm_llr(self, grid: jnp.ndarray):
        """Carrier grid -> deinterleaved LLRs plus the per-grid internals
        (flat AGC'd grid, ramp slope, equalized data, variances, mean_h)."""
        eq, variance, mean_h, var_full, flat, slope = \
            self._grid_stats_internal(grid)
        data = jnp.take(eq, self._data_cells, axis=-1)          # [B, nData]
        data = jnp.take(data, self._tf_iperm, axis=-1)
        llr = psk.demod(data, self._const, variance) * self._llr_scale_f
        llr = jnp.take(llr, self._bit_iperm, axis=-1)
        return llr, (flat, slope, data, variance, mean_h, var_full)

    def decode_ofdm(self, grid: jnp.ndarray):
        """Carrier grid -> LLRs + channel stats (AGC, estimation,
        equalization, demapping, deinterleaving)."""
        g = self.geom
        llr, (_f, _s, data, variance, mean_h, var_full) = self._ofdm_llr(grid)
        snr = 10.0 * jnp.log10(1.0 / jnp.maximum(
            var_full if g.spec.amplitude_restoration else variance, 1e-30))
        return llr, snr, mean_h, data

    # ------------------------------------------------------------------
    def _reencode_symbols(self, wire_bits: jnp.ndarray) -> jnp.ndarray:
        """Re-encode + re-modulate decoded wire bits (post-dispersal, as
        transmitted) into the ideal data symbols, tf-deint order — the
        decision-feedback primitive shared by the MER SNR measure and the
        decision-directed channel re-estimation."""
        g = self.geom
        u = jnp.concatenate([wire_bits, wire_bits[..., : g.n_virtual]],
                            axis=-1)
        cw = ldpc.encode(self.code, u)
        tx_bits = jnp.concatenate([wire_bits, cw[..., self.code.k:]], axis=-1)
        inter = jnp.take(tx_bits, self._bit_perm, axis=-1)
        return psk.mod(inter, self._const)                     # tf-deint order

    def _mer_snr(self, real_bits: jnp.ndarray, data_eq: jnp.ndarray) -> jnp.ndarray:
        """MER-based SNR for the ZF-estimator modes: re-encode the decoded
        payload, re-modulate, and compare against the equalized data symbols
        (reference: telecom_system.cc:1376-1401)."""
        ideal = self._reencode_symbols(
            jnp.bitwise_xor(real_bits, self._dispersal[None]))
        var = jnp.mean(jnp.abs(ideal - data_eq) ** 2, axis=-1)
        return -10.0 * jnp.log10(jnp.maximum(var, 1e-30))

    # ------------------------------------------------------------------
    def _dd_demod(self, flat: jnp.ndarray, slope: jnp.ndarray,
                  wire_bits: jnp.ndarray):
        """Decision-directed second demod pass: treat the re-encoded decoded
        codeword as pilots on EVERY data cell, re-estimate the channel with
        a weighted (symbol x carrier) box window — H = box(y x*)/box(|x|^2),
        two small matmuls — then re-equalize and re-demap.
        The timing ramp measured by the first pass is de-rotated before the
        window average and re-applied after, exactly as in grid_stats."""
        g = self.geom
        b = flat.shape[0]
        ideal = self._reencode_symbols(wire_bits).astype(self.cdtype)
        npil = self._pilot_seq.shape[0]
        xsrc = jnp.concatenate([
            jnp.broadcast_to(jnp.asarray(self._pilot_seq)[None], (b, npil)),
            ideal,
            jnp.zeros((b, 1), self.cdtype)], axis=-1)
        x_flat = jnp.take(xsrc, self._dd_src, axis=-1)          # [B, S*Nc]
        rot = jnp.exp(-1j * slope[:, None]
                      * jnp.asarray(self._cell_bins)[None]).astype(self.cdtype)
        y = flat * rot
        num = y * jnp.conj(x_flat)
        den = jnp.abs(x_flat) ** 2

        def box2d(x2):                                          # [B, S, Nc]
            x2 = jnp.einsum("st,btc->bsc", self._dd_box_s, x2)
            return jnp.einsum("bsc,cd->bsd", x2, self._dd_box_c)

        sh = (b, g.nsymb, g.nc)
        num_s = (box2d(num.real.reshape(sh))
                 + 1j * box2d(num.imag.reshape(sh))).reshape(b, -1)
        den_s = box2d(den.astype(self.real_dtype).reshape(sh)).reshape(b, -1)
        h = num_s / jnp.maximum(den_s, 1e-12)
        h = h * jnp.conj(rot)                  # restore the timing ramp
        h_pil = jnp.take(h, self._pilot_cells, axis=-1)
        mean_h = jnp.mean(jnp.abs(h_pil), axis=-1)
        if g.spec.amplitude_restoration:
            h_eq = h / jnp.maximum(jnp.abs(h), 1e-30)
        else:
            h_eq = h
        eq = flat / h_eq
        eq_pil = jnp.take(eq, self._pilot_cells, axis=-1)
        variance = jnp.mean(jnp.abs(eq_pil - self._pilot_seq) ** 2, axis=-1)
        eq_full_pil = jnp.take(flat, self._pilot_cells, axis=-1) / h_pil
        var_full = jnp.mean(jnp.abs(eq_full_pil - self._pilot_seq) ** 2,
                            axis=-1)
        data = jnp.take(eq, self._data_cells, axis=-1)
        data = jnp.take(data, self._tf_iperm, axis=-1)
        llr = psk.demod(data, self._const, variance) * self._llr_scale_f
        llr = jnp.take(llr, self._bit_iperm, axis=-1)
        return llr, data, variance, mean_h, var_full

    def _decode_llr_dd(self, llr, flat, slope, data, variance, var_full,
                       mean_h):
        """LDPC decode with the optional decision-directed second pass.
        Rows whose first BP pass converged keep their result; the others are
        re-estimated/re-decoded. lax.cond skips the whole second pass when
        every row converged, so the clean-signal cost is one all-reduce."""
        payload, crc_ok, iters, real_bits, conv = self.llr_to_payload(
            llr, data, variance)
        if not self.dd:
            return (payload, crc_ok, iters, real_bits, data, variance,
                    var_full, mean_h)

        def run_dd(args):
            payload, crc_ok, iters, real_bits, data, variance, var_full, \
                mean_h = args
            conv_c = conv
            for _ in range(self.dd_passes):
                wire = jnp.bitwise_xor(real_bits, self._dispersal[None])
                llr2, data2, var2, mh2, vf2 = self._dd_demod(flat, slope,
                                                             wire)
                payload2, crc2, it2, rb2, conv2 = self.llr_to_payload(
                    llr2, data2, var2)
                use2 = ~conv_c
                u2c = use2[:, None]
                payload = jnp.where(u2c, payload2, payload)
                crc_ok = jnp.where(use2, crc2, crc_ok)
                iters = jnp.where(use2, it2, iters)
                real_bits = jnp.where(u2c, rb2, real_bits)
                data = jnp.where(u2c, data2, data)
                variance = jnp.where(use2, var2, variance)
                var_full = jnp.where(use2, vf2, var_full)
                mean_h = jnp.where(use2, mh2, mean_h)
                conv_c = jnp.where(use2, conv2, conv_c)
            return (payload, crc_ok, iters, real_bits, data, variance,
                    var_full, mean_h)

        args = (payload, crc_ok, iters, real_bits, data, variance, var_full,
                mean_h)
        return jax.lax.cond(jnp.all(conv), lambda a: a, run_dd, args)

    # ------------------------------------------------------------------
    def decode_mfsk(self, grid: jnp.ndarray):
        g = self.geom
        llr = mfsk_mod.demod(grid, g.mfsk, g.nc, self.active_nsymb,
                             soft=self.mfsk_soft,
                             exp_scale=self.mfsk_exp_scale,
                             clamp=self.mfsk_clamp,
                             noise_pool=self.mfsk_noise_pool)
        if self.active_nbits < g.n_bits:   # punctured positions = erasures
            pad = jnp.zeros((*llr.shape[:-1], g.n_bits - self.active_nbits),
                            dtype=llr.dtype)
            llr = jnp.concatenate([llr, pad], axis=-1)
        llr = jnp.take(llr, self._bit_iperm, axis=-1)
        snr = jnp.zeros(grid.shape[0], dtype=self.real_dtype)
        return llr, snr, jnp.ones(grid.shape[0], dtype=self.real_dtype)

    # ------------------------------------------------------------------
    def _ldpc_decode(self, llr_n: jnp.ndarray, rate_num: int):
        """Dispatch the configured BP variant: flooding (`decode`) for
        spa/minsum, matmul-layered (`decode_mm`) for layered[-minsum]."""
        mi = getattr(self, "ldpc_max_iter", 50)
        if self.ldpc_algo in ("layered", "layered-minsum"):
            check = "minsum" if self.ldpc_algo == "layered-minsum" else "spa"
            return ldpc.decode_mm(llr_n, rate_num, algo=check, max_iter=mi)
        return ldpc.decode(llr_n, rate_num, algo=self.ldpc_algo, max_iter=mi)

    def set_ldpc_max_iter(self, n: int) -> None:
        """Runtime LDPC-iteration change (the reference GUI's slider,
        gui_main.cc:452-1124 / -I flag, main.cc:303-310). The decode cap is
        baked into the compiled programs, so the cached jits are dropped and
        the next receive recompiles — the analogue of the reference's
        reinit_subsystems partial rebuild (telecom_system.cc:2656-2713)."""
        self.ldpc_max_iter = int(n)
        for prop in ("receive_fn", "_receive_jit", "decode_at_jit",
                     "refine_decode_jit"):
            self.__dict__.pop(prop, None)

    # ------------------------------------------------------------------
    def _bicm_decode(self, llr: jnp.ndarray, data: jnp.ndarray,
                     variance: jnp.ndarray):
        """First BP pass + bicm_iters iterative demapping-decoding passes
        (BICM-ID) on rows whose BP did not converge: decoder extrinsic
        (posterior - input) -> virtual-bit fold + bit_perm -> per-symbol
        priors -> full log-MAP demapper (psk.demod_full) -> re-decode.
        lax.cond skips the whole loop when every row converged. llr: wire-
        order deinterleaved LLRs [B, nBits]; data: equalized symbols in
        tf-deint order; variance: [B]. Returns (bits_n, iters, conv)."""
        g = self.geom

        def to_n(llr_w):
            return jnp.concatenate([
                llr_w[..., : g.n_real], llr_w[..., : g.n_virtual],
                llr_w[..., g.n_real: g.n_real + g.ldpc_p]],
                axis=-1).astype(jnp.float32)

        check = "minsum" if self.ldpc_algo == "layered-minsum" else "spa"
        mi = getattr(self, "ldpc_max_iter", 50)

        def dec(l_n):
            return ldpc.decode_mm(l_n, g.spec.ldpc_rate_num, algo=check,
                                  max_iter=mi, soft=True)

        llr_n0 = to_n(llr)
        bits, iters, conv, post = dec(llr_n0)
        if self.bicm_iters == 0:
            return bits, iters, conv
        nb = int(np.log2(len(self._const)))
        # the channel LLRs carry the llr_scale calibration; keep the
        # demapper's channel metric in the same units by scaling the
        # distances (effective variance / scale), so decoder extrinsics
        # and channel scores mix consistently
        var_eff = variance / self._llr_scale_f

        def run_id(args):
            bits, iters, conv_c, llr_nc, post_c = args
            for _ in range(self.bicm_iters):
                ext_n = post_c - llr_nc
                ext_real = ext_n[..., : g.n_real]
                # virtual bits duplicate the first n_virtual wire bits —
                # their extrinsics add (telecom_system.cc:1300-1308 layout)
                ext_real = ext_real.at[..., : g.n_virtual].add(
                    ext_n[..., g.n_real: g.n_real + g.n_virtual])
                ext_wire = jnp.concatenate(
                    [ext_real, ext_n[..., g.n_real + g.n_virtual:]],
                    axis=-1)
                la_sym = jnp.take(ext_wire, self._bit_perm, axis=-1)
                la = la_sym.reshape(*la_sym.shape[:-1], -1, nb)
                ext2 = psk.demod_full(data, self._const, var_eff, la)
                llr2 = jnp.take(ext2, self._bit_iperm, axis=-1)
                llr_n2 = to_n(llr2)
                bits2, it2, conv2, post2 = dec(llr_n2)
                use = ~conv_c
                uc = use[:, None]
                bits = jnp.where(uc, bits2, bits)
                iters = jnp.where(use, iters + it2, iters)
                llr_nc = jnp.where(uc, llr_n2, llr_nc)
                post_c = jnp.where(uc, post2, post_c)
                conv_c = jnp.where(use, conv2, conv_c)
            return bits, iters, conv_c, llr_nc, post_c

        args = (bits, iters, conv, llr_n0, post)
        bits, iters, conv, _l, _p = jax.lax.cond(
            jnp.all(conv), lambda a: a, run_id, args)
        return bits, iters, conv

    # ------------------------------------------------------------------
    def llr_to_payload(self, llr: jnp.ndarray, data: jnp.ndarray = None,
                       variance: jnp.ndarray = None):
        """Deinterleaved LLRs [B, nBits] -> LDPC decode -> CRC check
        (parity/virtual-bit shuffle per telecom_system.cc:1300-1308).
        When bicm_iters > 0 and the equalized data symbols + variance are
        provided, non-converged rows run the iterative demapping-decoding
        loop (_bicm_decode) before the CRC check."""
        g = self.geom
        if self.bicm_iters > 0 and data is not None:
            bits, iters, conv = self._bicm_decode(llr, data, variance)
        else:
            llr_n = jnp.concatenate([
                llr[..., : g.n_real],
                llr[..., : g.n_virtual],
                llr[..., g.n_real: g.n_real + g.ldpc_p],
            ], axis=-1).astype(jnp.float32)
            bits, iters, conv = self._ldpc_decode(llr_n,
                                                  g.spec.ldpc_rate_num)
        real_bits = jnp.bitwise_xor(bits[..., : g.n_real], self._dispersal[None])
        all_zeros = jnp.all(real_bits[..., : (g.n_real // 8) * 8] == 0, axis=-1)
        crc_bits = real_bits[..., : self._crc_nbits]
        crc = jnp.mod(crc_bits.astype(jnp.float32) @ self._crc_a.T, 2.0).astype(jnp.int32)
        crc = jnp.bitwise_xor(crc, self._crc_c0[None])
        crc_ok = jnp.all(crc == 0, axis=-1) & ~all_zeros
        payload_bits = real_bits[..., : g.frame_bytes * 8]
        shifts = jnp.arange(8, dtype=jnp.int32)
        payload = jnp.sum(
            payload_bits.reshape(*payload_bits.shape[:-1], -1, 8)
            << shifts, axis=-1).astype(jnp.uint8)
        return payload, crc_ok, iters, real_bits, conv

    # ------------------------------------------------------------------
    def bb_decode_bits(self, grid: jnp.ndarray) -> jnp.ndarray:
        """Baseband-harness decode: carrier grid -> LDPC-decoded info bits
        (no dispersal/CRC, reference baseband_test_EsN0 parity,
        telecom_system.cc:96-229), including the decision-directed second
        pass when enabled. In this harness the wire bits ARE the info bits
        (no energy dispersal), so the decoded codeword feeds the
        re-estimation directly."""
        g = self.geom
        llr, (flat, slope, data, variance, _mh, _vf) = self._ofdm_llr(grid)

        def bp(llr_in):
            llr_n = jnp.concatenate([
                llr_in[..., : g.n_real],
                llr_in[..., : g.n_virtual],
                llr_in[..., g.n_real: g.n_real + g.ldpc_p],
            ], axis=-1).astype(jnp.float32)
            return self._ldpc_decode(llr_n, g.spec.ldpc_rate_num)

        if self.bicm_iters > 0:
            bits, _iters, conv = self._bicm_decode(llr, data, variance)
        else:
            bits, _iters, conv = bp(llr)
        if not self.dd:
            return bits[..., : g.n_real]

        def run_dd(bits1):
            conv_c = conv
            for _ in range(self.dd_passes):
                llr2, _d2, _v2, _m2, _f2 = self._dd_demod(
                    flat, slope, bits1[..., : g.n_real])
                bits2, _it2, conv2 = bp(llr2)
                use2 = ~conv_c
                bits1 = jnp.where(use2[:, None], bits2, bits1)
                conv_c = jnp.where(use2, conv2, conv_c)
            return bits1

        bits = jax.lax.cond(jnp.all(conv), lambda b_: b_, run_dd, bits)
        return bits[..., : g.n_real]

    # ------------------------------------------------------------------
    def decode_at(self, pb_buffer: jnp.ndarray, delay: jnp.ndarray,
                  freq_offset: jnp.ndarray):
        """Decode a frame from the capture buffer at a known delay and
        frequency offset."""
        g = self.geom
        iq = self.mix(pb_buffer, freq_offset)
        frame = self.extract_frame_decimated(iq, delay, self.active_nsymb)
        grid = self.demod_grid(frame)
        if g.spec.is_mfsk:
            llr, snr, mean_h = self.decode_mfsk(grid)
            payload, crc_ok, iters, _bits, _conv = self.llr_to_payload(llr)
        else:
            llr, (flat, slope, data, variance, mean_h, var_full) = \
                self._ofdm_llr(grid)
            (payload, crc_ok, iters, real_bits, data, variance, var_full,
             mean_h) = self._decode_llr_dd(llr, flat, slope, data, variance,
                                           var_full, mean_h)
            if g.estimator == ZERO_FORCE:
                snr = self._mer_snr(real_bits, data)
            else:
                snr = 10.0 * jnp.log10(1.0 / jnp.maximum(
                    var_full if g.spec.amplitude_restoration else variance,
                    1e-30))
        return payload, crc_ok, iters, snr, mean_h

    # ------------------------------------------------------------------
    @functools.cached_property
    def receive_fn(self):
        """The un-jitted receive program (for custom jit/sharding wrappers).

        `stage` truncates the program for profiling ablations: "sync" stops
        after the coarse Schmidl-Cox candidate search, "refine" after the
        matched-filter delay arbitration, "hyp" after CFO-hypothesis
        selection; "full" (default) runs the whole chain."""
        g = self.geom

        def run(pb_buffer, stage: str = "full", sync_limit: int | None = None):
            """sync_limit (static, interp samples): only frame starts below
            this offset are eligible sync candidates — used by the
            time-sharded receiver so a device never claims the frame whose
            start belongs to its right neighbour's slice (the halo exists
            only to *complete* frames that start locally)."""
            b = pb_buffer.shape[0]
            # 1) coarse sync on a base-rate time-sync-FIR baseband (the TS
            # filter bandlimits far below the decimated Nyquist; the MF
            # refinement below restores sub-GI timing). The full interp-rate
            # IQ is never materialized: on accelerators the f=0 mixer folds
            # into complex FIR taps + a base-rate output rotation
            # (ops.fir_same_strided_mix_mm), so the real passband goes
            # straight into the strided matmul.
            ts_dec = g.interp
            if self._mm_fir:
                bb_ts = ops.fir_same_strided_mix_mm(
                    pb_buffer.astype(self.real_dtype), self._fir_ts, ts_dec,
                    2 * np.pi * g.fc / g.fs, float(np.sqrt(2.0)))
            else:
                bb_ts = ops.fir_same_strided(self.mix(pb_buffer, 0.0),
                                             self._fir_ts, ts_dec)
            if g.spec.is_mfsk:
                met = sync.mfsk_sync_metric(bb_ts, g, decim=ts_dec)
                if sync_limit is not None:
                    sym_pos = jnp.arange(met.shape[-1]) * (g.nofdm * g.interp)
                    met = jnp.where(sym_pos[None] >= sync_limit, -1.0, met)
                sym_idx = jnp.argmax(met, axis=-1)
                delay = (sym_idx * g.nofdm * g.interp).astype(jnp.int32)
                metric = jnp.take_along_axis(met, sym_idx[:, None], axis=-1)[:, 0]
                freq = jnp.zeros(b, self.real_dtype)
                payload, crc_ok, iters, snr, mean_h = self.decode_at(
                    pb_buffer, delay, freq)
                # second-candidate arbitration (round 4): at the ROBUST_0
                # waterfall the tone sync's argmax is the dominant residual
                # loss (fixed-delay FER 0.027 vs sync-on 0.12 at -13 dB);
                # decode the runner-up symbol offset (outside +-1 symbol of
                # the winner) and keep whichever passes CRC — the reference
                # spends its budget on re-trials instead
                # (telecom_system.cc:931).
                if self._mfsk_sync_cands > 1:
                    pos = jnp.arange(met.shape[-1])
                    sup = jnp.abs(pos[None, :] - sym_idx[:, None]) <= 1
                    met2 = jnp.where(sup, -1.0, met)
                    sym2 = jnp.argmax(met2, axis=-1)
                    delay2 = (sym2 * g.nofdm * g.interp).astype(jnp.int32)
                    metric2 = jnp.take_along_axis(met, sym2[:, None],
                                                  axis=-1)[:, 0]
                    res1 = (payload, crc_ok, delay, iters, snr, mean_h,
                            metric)

                    def second(args):
                        (payload, crc_ok, delay, iters, snr, mean_h,
                         metric) = args
                        p2, ok2, it2, snr2, mh2 = self.decode_at(
                            pb_buffer, delay2, freq)
                        use2 = ~crc_ok & ok2
                        return (jnp.where(use2[:, None], p2, payload),
                                crc_ok | use2,
                                jnp.where(use2, delay2, delay),
                                jnp.where(use2, it2, iters),
                                jnp.where(use2, snr2, snr),
                                jnp.where(use2, mh2, mean_h),
                                # metric follows the winning hypothesis so
                                # RxResult.sync_metric and .delay always
                                # describe the same sync candidate
                                jnp.where(use2, metric2, metric))

                    # only pay the second decode when some row failed —
                    # zero cost on clean batches (same gating pattern as
                    # the decision-directed pass)
                    (payload, crc_ok, delay, iters, snr, mean_h, metric) = \
                        jax.lax.cond(jnp.all(crc_ok), lambda a: a, second,
                                     res1)
                return RxResult(payload, crc_ok, delay, freq, snr, iters,
                                metric, mean_h)

            # candidate grid: every 4th base-rate offset (16 interp
            # samples) — the SC plateau is a GI wide and the MF refinement
            # searches +-2 symbols around each candidate, so nothing is
            # lost (the reference scans at step=100 interp samples)
            sc_scan = 4 if (g.ngi % 4 == 0 and g.nfft % 8 == 0) else 1
            cand_step = ts_dec * sc_scan
            met, cfo_arr = sync.schmidl_cox_metric(bb_ts, g, decim=ts_dec,
                                                   scan=sc_scan)
            if sync_limit is not None:
                pos_i = jnp.arange(met.shape[-1]) * cand_step
                met = jnp.where(pos_i[None] >= sync_limit, 0.0, met)
            # Top-K SC candidates with one-preamble-symbol suppression: the
            # normalized SC metric can score a *partial* preamble at a window
            # edge (or the next frame's first symbols) above the complete
            # frame — silence cancels from numerator and denominator alike
            # (the reference fights this with energy gates + retry trials,
            # telecom_system.cc:805-924). The known-preamble matched filter
            # is immune, so it arbitrates among the SC candidates.
            n_k = 3 if self.cfo_range == "wide" else 2
            sym_cand = max((g.nofdm * g.interp) // cand_step, 1)
            met_work = met
            cand_list, cfo_list, metric_list = [], [], []
            for _k in range(n_k):
                idx_k = jnp.argmax(met_work, axis=-1)
                cand_list.append((idx_k * cand_step).astype(jnp.int32))
                metric_list.append(
                    jnp.take_along_axis(met, idx_k[:, None], axis=-1)[:, 0])
                cfo_list.append(jnp.take_along_axis(
                    cfo_arr, idx_k[:, None], axis=-1)[:, 0].astype(self.real_dtype))
                pos = jnp.arange(met.shape[-1])
                suppress = jnp.abs(pos[None, :] - idx_k[:, None]) < sym_cand
                met_work = jnp.where(suppress, -1.0, met_work)
            metric = metric_list[0]
            if stage == "sync":
                return cand_list, cfo_list, metric

            # matched-filter arbitration over (candidate x CFO-alias), run on
            # the base-rate TS baseband already computed for the coarse sync:
            # the TS FIR bandlimits far below the decimated Nyquist, so the
            # only loss is timing resolution — the MF delay quantizes to
            # `interp` samples, absorbed by the guard interval exactly like
            # the reference's deliberately-early fine sync. Versus a
            # full-rate MF this cuts the FFT-correlation work ~16x and skips
            # the per-candidate re-filtering entirely.
            lp, s_tmpl = self._mf_templates.shape
            # MF lag = mf_d interp samples. The TS FIR's stopband edge is
            # ~2.5 kHz (cut 0.9*bw/2 + 3 kHz transition), so a 2*interp
            # decimation (3 kHz Nyquist at fs=48k) still holds the whole
            # filtered spectrum; delay quantization stays far inside the GI.
            mf_d = 2 * ts_dec if s_tmpl % (2 * ts_dec) == 0 else ts_dec
            mf_s = mf_d // ts_dec                 # stride within bb_ts
            window = 2 * g.nofdm * g.interp
            win_d = window // mf_d
            s_d = s_tmpl // mf_d
            seg_d_len = 2 * win_d + lp * s_d
            n_ts = bb_ts.shape[-1]
            seg_core = seg_d_len * mf_d
            max_start = (n_ts * ts_dec - seg_core) // mf_d * mf_d
            tmpl_d = np.ascontiguousarray(self._mf_templates[:, ::mf_d])
            alias = g.fs / ((g.nfft // 2) * g.interp)   # host-constant Hz

            # Coarse-to-fine deep acquisition (round 4): the round-3 deep
            # path scanned the WHOLE buffer at MF resolution over the full
            # 15 Hz CFO grid (the most expensive stage of CONFIG_0-4).
            # The scan only
            # needs to NOMINATE the true start among the top few
            # candidates, not resolve it: scan at 2x extra decimation with
            # a 30 Hz grid (~4x less correlation work), take the top-N
            # (delay, CFO) rows, and let them re-score in the same
            # per-candidate refinement as the SC candidates — at full MF
            # resolution with +-15 Hz bank offsets, so the refined
            # hypothesis density matches the old grid exactly.
            dc = self._c2f_decim
            deep_c2f = (self.deep_sync and self.deep_profile == "c2f"
                        and (s_tmpl // mf_d) % dc == 0)
            if deep_c2f:
                mf_dc = dc * mf_d
                s_dc = s_tmpl // mf_dc
                lp_c = min(self._c2f_lp or lp, lp)
                tmpl_c = np.ascontiguousarray(
                    self._mf_templates[:lp_c, ::mf_dc])
                gs = float(self._c2f_grid_hz)
                span_c = 120.0 if self.cfo_range == "wide" else 30.0
                n_hc = int(round(span_c / gs))
                grid_c = np.arange(-n_hc, n_hc + 1) * gs
                t_c = np.arange(tmpl_c.shape[-1], dtype=np.float64) * mf_dc
                bank_c = np.stack([
                    tmpl_c * np.exp(-1j * (2 * np.pi / g.fs)
                                    * f_h * t_c)[None]
                    for f_h in grid_c]).astype(self.np_cdtype)  # [Hc, Lp, Sc]
                stride_c = dc * mf_s
                n_gc = n_ts // stride_c
                win_c = (n_gc - lp_c * s_dc) // 2
                seg_c = bb_ts[..., : (2 * win_c + lp_c * s_dc) * stride_c
                              : stride_c]
                delay_c, score_c = sync.matched_filter_refine_bank(
                    seg_c, jnp.zeros(b, jnp.int32), bank_c, win_c,
                    use_mm=False)                               # [B, Hc]
                n_deep = min(self._c2f_topn, score_c.shape[-1])
                _, top_i = jax.lax.top_k(score_c, n_deep)       # [B, N]
                d_top = (jnp.take_along_axis(delay_c, top_i, axis=-1)
                         * mf_dc)                               # interp samp
                cfo_top = jnp.asarray(grid_c, self.real_dtype)[top_i]
                for n in range(n_deep):
                    cand_list.append(d_top[:, n].astype(jnp.int32))
                    cfo_list.append(cfo_top[:, n])

            def slice_one(row, st_ts):
                return jax.lax.dynamic_slice(row, (st_ts,),
                                             (seg_d_len * mf_s,))

            # SC lag-phase CFO is ambiguous modulo 93.75 Hz. The alias part
            # of each hypothesis is data-INDEPENDENT, so it rotates the
            # host-precomputed template bank instead of the segments: only
            # the data-dependent coarse CFO rotates each candidate segment
            # (K forward FFTs and one exp per candidate instead of K*A).
            if self.cfo_range == "wide":
                alias_offsets = (0.0, float(alias), -float(alias))
            else:
                alias_offsets = (0.0,)
            if (deep_c2f and self._c2f_refine_offsets
                    and float(self._c2f_grid_hz) > 15.0):
                # a coarse grid wider than 15 Hz leaves >7.5 Hz residual;
                # +-grid/2 bank offsets restore the old 15 Hz hypothesis
                # density at refine time (without them the residual is
                # still within Moose's +-23.4 Hz pull-in at decode — the
                # offsets only sharpen the refine's arbitration scores)
                half = float(self._c2f_grid_hz) / 2.0
                alias_offsets = alias_offsets + (half, -half)
            t_tmpl = np.arange(tmpl_d.shape[-1], dtype=np.float64) * mf_d
            tmpl_bank = np.stack([
                tmpl_d * np.exp(-1j * (2 * np.pi / g.fs) * f_a * t_tmpl)[None]
                for f_a in alias_offsets]).astype(self.np_cdtype)  # [A, Lp, S]

            seg_rows, start_rows, cfo_rows = [], [], []
            n_cand_tot = len(cand_list)
            for k in range(n_cand_tot):
                coarse = cand_list[k]
                coarse_cfo_k = cfo_list[k]
                # segment start in interp samples, aligned to the MF grid
                seg_start = (jnp.clip(coarse - window, 0, max(max_start, 0))
                             // mf_d) * mf_d
                seg_d = jax.vmap(slice_one)(bb_ts,
                                            seg_start // ts_dec)[..., ::mf_s]
                t_seg = (seg_start[:, None].astype(self.real_dtype)
                         + jnp.arange(seg_d_len, dtype=self.real_dtype) * mf_d)
                rot_seg = jnp.exp(1j * (2 * np.pi / g.fs)
                                  * coarse_cfo_k[:, None] * t_seg
                                  ).astype(self.cdtype)
                seg_rows.append(seg_d * rot_seg)                 # [B, L]
                start_rows.append(seg_start // mf_d)
                cfo_rows.append(jnp.stack(
                    [coarse_cfo_k + f_a for f_a in alias_offsets]))  # [A, B]
            seg_all = jnp.concatenate(seg_rows, axis=0)          # [K*B, L]
            start_all = jnp.concatenate(start_rows, axis=0)
            delay_f, score_f = sync.matched_filter_refine_bank(
                seg_all, start_all, tmpl_bank, win_d)            # [K*B, A]
            n_alias = len(alias_offsets)
            n_rows = n_cand_tot * n_alias
            # [K*B, A] -> [K, B, A] -> [K, A, B] -> [K*A, B]
            delays = (jnp.swapaxes(delay_f.reshape(n_cand_tot, b, n_alias),
                                   1, 2)
                      .reshape(n_rows, b) * mf_d)               # [K*A, B]
            scores = jnp.swapaxes(score_f.reshape(n_cand_tot, b, n_alias),
                                  1, 2).reshape(n_rows, b)
            cfos = jnp.concatenate(cfo_rows, axis=0)
            deep_coh = (self.deep_sync and not deep_c2f
                        and self.deep_coherent)
            d_deep = None
            deep_cand2 = None       # (delay2, cfo2, have2) rescue candidate
            if self.deep_sync and not deep_c2f and not deep_coh:
                # Global known-preamble acquisition, noncoherent variant
                # (deep_coherent=False — the round-4 chain): correlate the
                # known preamble against the ENTIRE decimated TS baseband
                # over a static 30 Hz CFO grid (coherent per preamble
                # symbol, noncoherent |.| across symbols) and let those
                # hypotheses join the argmax arbitration. This is the
                # capability the reference lacks entirely (its passband
                # sync gates FER 1.0).
                span = 120.0 if self.cfo_range == "wide" else 30.0
                gsf = float(self._deep_grid_hz)
                n_h = int(round(span / gsf))
                grid_f = np.arange(-n_h, n_h + 1) * gsf
                bank_g = np.stack([
                    tmpl_d * np.exp(-1j * (2 * np.pi / g.fs)
                                    * f_h * t_tmpl)[None]
                    for f_h in grid_f]).astype(self.np_cdtype)  # [H, Lp, S]
                n_gd = n_ts // mf_s             # whole buffer at mf_d rate
                win_g = (n_gd - lp * s_d) // 2
                seg_g = bb_ts[..., : (2 * win_g + lp * s_d) * mf_s: mf_s]
                # float32 FFT correlation (cuFFT on the GPU): on an H100 it
                # beat the matmul FFT this stage used before, 3.2 against
                # 6.8 ms of device time at batch 256 (PERF.md, PR 1)
                with jax.named_scope("noncoherent_scan"):
                    delay_g, score_g = sync.matched_filter_refine_bank(
                        seg_g, jnp.zeros(b, jnp.int32), bank_g, win_g,
                        use_mm=False)                           # [B, H]
                delays = jnp.concatenate([delays, delay_g.T * mf_d],
                                         axis=0)
                scores = jnp.concatenate([scores, score_g.T], axis=0)
                cfos = jnp.concatenate(
                    [cfos, jnp.asarray(grid_f, self.real_dtype)[:, None]
                     * jnp.ones((1, b), self.real_dtype)], axis=0)
            if deep_coh:
                # COHERENT whole-buffer acquisition (round 5 redesign): ONE
                # matched-filter pass scores the FULL preamble coherently —
                # inter-symbol phase included — at EVERY lag for every CFO
                # row of a fine (4 Hz) static grid (bank [F, 1, Lp*S_d]).
                # Max-combining the CFO axis elementwise then gives the
                # global coherent acquisition surface, and nomination is a
                # single pooled top-M over it. This replaces BOTH the
                # round-4 noncoherent nomination AND the round-5
                # per-candidate coherent re-score, and gathers only [B, M]
                # scalars. It also removes the
                # nomination-bound misacquisitions outright: the true
                # start no longer has to surface in any per-CFO-row
                # shortlist (tools/acq_floor_r5.py: 6/9 residual misses
                # were in NO arbitration row).
                n_gd = n_ts // mf_s             # whole buffer at mf_d rate
                win_g = (n_gd - lp * s_d) // 2
                seg_g = bb_ts[..., : (2 * win_g + lp * s_d) * mf_s: mf_s]
                gsc = float(self._deep_coh_grid_hz)
                span_c2 = 120.0 if self.cfo_range == "wide" else 45.0
                n_hc2 = int(round(span_c2 / gsc))
                grid_coh = np.arange(-n_hc2, n_hc2 + 1) * gsc
                t_abs = (np.arange(tmpl_d.shape[-1])[None, :] * mf_d
                         + np.arange(lp)[:, None] * s_tmpl)     # [Lp, S_d]
                bank_coh = np.stack([
                    tmpl_d * np.exp(-1j * (2 * np.pi / g.fs) * f_h * t_abs)
                    for f_h in grid_coh]).astype(self.np_cdtype)
                bank_c1 = bank_coh.reshape(len(grid_coh), 1, lp * s_d)
                with jax.named_scope("coherent_scan"):
                    smax, sarg = sync.coherent_scan_max(seg_g, bank_c1,
                                                        win_g)  # [B, L]
                if sync_limit is not None:
                    lag_i = jnp.arange(smax.shape[-1]) * mf_d
                    smax = jnp.where(lag_i[None] >= sync_limit,
                                     -jnp.inf, smax)
                m_top = self._deep_pil_topm
                d_lag, s_top = sync.topk_pooled(
                    smax, jnp.zeros(b, jnp.int32), m_top, 8)    # [B, M]
                f_top = jnp.take_along_axis(sarg, d_lag, axis=-1)
                d_top = d_lag * mf_d                 # interp-rate starts
                if stage == "arb":   # diagnostic: the nomination stack
                    cfo_at = jnp.asarray(grid_coh, self.real_dtype)[f_top]
                    return d_top.T, s_top.T, cfo_at.T
                # pilot-extended final arbitration: among the top-M
                # coherent candidates (each at its best CFO), the pilot
                # lattice — 7x the preamble energy — picks the start
                bank_pil = np.stack([
                    self._pil_templates[:, ::mf_d]
                    * np.exp(-1j * (2 * np.pi / g.fs) * f_h
                             * np.arange(0, s_tmpl, mf_d))[None]
                    for f_h in grid_coh]).astype(self.np_cdtype)
                with jax.named_scope("pilot_arbitration"):
                    score_p = sync.pilot_rescore(
                        bb_ts, d_top, f_top, bank_pil, mf_s, ts_dec,
                        lp * s_tmpl)                            # [B, M]
                pick_m = jnp.argmax(score_p, axis=-1)           # [B]
                delay = jnp.take_along_axis(d_top, pick_m[:, None],
                                            axis=1)[:, 0]
                coarse_cfo = jnp.asarray(grid_coh, self.real_dtype)[
                    jnp.take_along_axis(f_top, pick_m[:, None],
                                        axis=1)[:, 0]]
                if self._deep_rescue:
                    # CRC-gated rescue candidate: runner-up
                    # pilot-arbitration start OUTSIDE the winner's GI
                    # plateau; decoding it costs nothing on clean batches
                    # (lax.cond-gated below, the MFSK second-candidate
                    # pattern)
                    gi_w = g.ngi * g.interp
                    far = jnp.abs(d_top - delay[:, None]) > gi_w
                    sp2 = jnp.where(far, score_p, -jnp.inf)
                    pick2 = jnp.argmax(sp2, axis=-1)            # [B]
                    delay2 = jnp.take_along_axis(
                        d_top, pick2[:, None], axis=1)[:, 0]
                    cfo2 = jnp.asarray(grid_coh, self.real_dtype)[
                        jnp.take_along_axis(f_top, pick2[:, None],
                                            axis=1)[:, 0]]
                    deep_cand2 = (delay2, cfo2,
                                  jnp.any(far, axis=-1))
            else:
                if sync_limit is not None:
                    # a boundary frame's GI plateau can sneak a candidate
                    # just under the limit and then refine PAST it —
                    # arbitrate only among owned hypotheses
                    scores = jnp.where(delays >= sync_limit, -jnp.inf,
                                       scores)
                if stage == "arb":   # diagnostic: the full pre-argmax stacks
                    return delays, scores, cfos
                pick_a = jnp.argmax(scores, axis=0)             # [B]
                delay = jnp.take_along_axis(delays, pick_a[None], axis=0)[0]
                coarse_cfo = jnp.take_along_axis(cfos, pick_a[None],
                                                 axis=0)[0]
            # sample a little early inside the guard interval: the exact
            # frame-start sample sits on the ISI boundary of the RX FIR tails,
            # a small advance is absorbed by the cyclic prefix + channel
            # estimator (the reference's fine sync lands 7-13 samples early)
            delay = delay - 8
            # clamp so the frame slice stays inside the actual input buffer
            # (equals the buffer_nsymb-window bound for the standard capture
            # length, but stays correct for longer sharded/streaming windows)
            max_delay = (pb_buffer.shape[-1]
                         - g.nofdm * (g.nsymb + g.preamble_nsymb) * g.interp)
            delay = jnp.clip(delay, 0, max_delay)
            if stage == "refine":
                return delay, coarse_cfo, metric

            def _decode_from(delay, coarse_cfo):
                """Post-arbitration decode at one (start, coarse CFO)
                hypothesis: extract + Moose + CFO-hypothesis select + LDPC.
                Factored so the deep-acquisition rescue can run it on the
                runner-up candidate under lax.cond."""
                # 2) polyphase data FIR over the frame segment only (mixer fused
                #    into the slice); Moose CFO measured on the coarse-corrected
                #    frame -> total f0
                dec0 = self.extract_frame_decimated_pb(pb_buffer, delay,
                                                       self.active_nsymb)
                t_dec = (delay[:, None].astype(self.real_dtype)
                         + jnp.arange(dec0.shape[-1], dtype=self.real_dtype) * g.interp)
                rot_c = jnp.exp(1j * (2 * np.pi / g.fs)
                                * coarse_cfo[:, None] * t_dec).astype(self.cdtype)
                resid = sync.moose_cfo(dec0 * rot_c, g).astype(self.real_dtype)
                freq_m = coarse_cfo + resid
                freq_m = jnp.where(jnp.abs(freq_m) > 0.1, freq_m, 0.0)

                # 3) CFO hypotheses: correct by rotating the extracted frame
                #    (equivalent to re-mixing at fc+f for narrowband f; the
                #    reference re-runs the full mixer+FIR instead). Moose is
                #    unambiguous only within ±half a subcarrier spacing
                #    (±23.4 Hz); the ±1-subcarrier aliases extend coverage to
                #    ≈±70 Hz (the reference's ±30 Hz grid search covers less).
                #    Pick the hypothesis with the lowest pilot variance, then run
                #    the expensive LDPC decode once — a parallel, fixed-shape
                #    select instead of the reference's sequential retry trials.
                subc = self.real_dtype(g.bandwidth / g.nc)
                if self.cfo_range == "wide":
                    hyps = (freq_m, jnp.zeros_like(freq_m),
                            freq_m + subc, freq_m - subc)
                else:
                    hyps = (freq_m, jnp.zeros_like(freq_m))
                if g.estimator == ZERO_FORCE:
                    # ZF forces the pilots exact, so pilot variance cannot
                    # discriminate hypotheses — use the hard-decision error
                    # power of the equalized data symbols instead (needs the
                    # full grid per hypothesis)
                    grids, variances, sel_metrics, stats = [], [], [], []
                    for f_h in hyps:
                        rot = jnp.exp(1j * (2 * np.pi / g.fs) * f_h[:, None] * t_dec)
                        dec_h = dec0 * rot.astype(self.cdtype)
                        grid_h = self.demod_grid(dec_h)
                        eq, var, mh, var_full = self.grid_stats(grid_h)
                        grids.append(eq)
                        variances.append(var)
                        stats.append((mh, var_full))
                        data_h = jnp.take(eq, self._data_cells, axis=-1)
                        d2 = jnp.min(jnp.abs(data_h[..., None] - self._const) ** 2,
                                     axis=-1)
                        sel_metrics.append(jnp.mean(d2, axis=-1))
                    var_stack = jnp.stack(sel_metrics, axis=0)     # [H, B]
                    pick = jnp.argmin(var_stack, axis=0)           # [B]
                    eq = jnp.take_along_axis(
                        jnp.stack(grids, axis=0), pick[None, :, None], axis=0)[0]
                    variance = jnp.take_along_axis(
                        jnp.stack(variances, axis=0), pick[None], axis=0)[0]
                    mean_h = jnp.take_along_axis(
                        jnp.stack([s[0] for s in stats], 0), pick[None], axis=0)[0]
                    var_full = jnp.take_along_axis(
                        jnp.stack([s[1] for s in stats], 0), pick[None], axis=0)[0]
                    freq = jnp.take_along_axis(jnp.stack(hyps, 0), pick[None],
                                               axis=0)[0]
                    flat = slope = None       # ZF: no decision-directed pass
                else:
                    # pilot variance discriminates, and it only needs the pilot
                    # cells: per hypothesis, extract them with the per-symbol
                    # partial-DFT matmul and run the pilot-side half of
                    # grid_stats; only the winner pays the full FFT demod
                    pil_dft = jnp.asarray(self._pil_dft_op)
                    pre = g.preamble_nsymb * g.nofdm
                    sel_metrics = []
                    for f_h in hyps:
                        rot = jnp.exp(1j * (2 * np.pi / g.fs) * f_h[:, None] * t_dec)
                        dec_h = dec0 * rot.astype(self.cdtype)
                        sym = dec_h[..., pre:].reshape(b, self.active_nsymb,
                                                       g.nofdm)
                        sym = sym[..., g.ngi: g.ngi + g.nfft]
                        y3 = jnp.einsum("bst,spt->bsp", sym, pil_dft)
                        y_pil = jnp.take(y3.reshape(b, -1), self._pil_slot,
                                         axis=-1)                  # [B, nPil]
                        gain = PILOT_BOOST / jnp.mean(jnp.abs(y_pil), axis=-1,
                                                      keepdims=True)
                        y_pil = y_pil * gain
                        h_pil = ((y_pil.real @ self._est_pil_op.T)
                                 + 1j * (y_pil.imag @ self._est_pil_op.T))
                        if g.spec.amplitude_restoration:
                            h_eq = h_pil / jnp.maximum(jnp.abs(h_pil), 1e-30)
                        else:
                            h_eq = h_pil
                        var_h = jnp.mean(
                            jnp.abs(y_pil / h_eq - self._pilot_seq) ** 2, axis=-1)
                        sel_metrics.append(var_h)
                    var_stack = jnp.stack(sel_metrics, axis=0)     # [H, B]
                    pick = jnp.argmin(var_stack, axis=0)           # [B]
                    freq = jnp.take_along_axis(jnp.stack(hyps, 0), pick[None],
                                               axis=0)[0]
                    rot = jnp.exp(1j * (2 * np.pi / g.fs) * freq[:, None] * t_dec)
                    grid_w = self.demod_grid(dec0 * rot.astype(self.cdtype))
                    eq, variance, mean_h, var_full, flat, slope = \
                        self._grid_stats_internal(grid_w)
                if stage == "hyp":
                    return eq, variance, freq

                data = jnp.take(eq, self._data_cells, axis=-1)
                data = jnp.take(data, self._tf_iperm, axis=-1)
                llr = psk.demod(data, self._const, variance)
                llr = jnp.take(llr, self._bit_iperm, axis=-1)
                (payload, crc_ok, iters, real_bits, data, variance, var_full,
                 mean_h) = self._decode_llr_dd(llr, flat, slope, data, variance,
                                               var_full, mean_h)
                if not g.spec.amplitude_restoration:
                    # QAM modes (any estimator): decision-directed MER on the
                    # equalized data. The pilot-residual variance would fold in
                    # the LS smoother's estimation bias (~-17 dB floor on the
                    # sparse low-density lattice) and under-report strong
                    # signals, starving the gearshift of headroom evidence.
                    snr = self._mer_snr(real_bits, data)
                else:
                    snr = 10.0 * jnp.log10(1.0 / jnp.maximum(var_full, 1e-30))
                return RxResult(payload, crc_ok, delay, freq, snr, iters,
                                metric, mean_h)

            if stage == "hyp":
                return _decode_from(delay, coarse_cfo)
            out = _decode_from(delay, coarse_cfo)
            if deep_cand2 is not None:
                delay2 = jnp.clip(deep_cand2[0] - 8, 0, max_delay)
                cfo2, have2 = deep_cand2[1], deep_cand2[2]

                def _rescue(r1):
                    r2 = _decode_from(delay2, cfo2)
                    use2 = ~r1.crc_ok & r2.crc_ok & have2
                    # sync_metric stays the arbitration-stage metric for
                    # both hypotheses (same coarse stage); delay/freq flip
                    # with the winning candidate
                    return jax.tree_util.tree_map(
                        lambda a1, a2: jnp.where(
                            use2.reshape((-1,) + (1,) * (a1.ndim - 1)),
                            a2, a1), r1, r2)

                out = jax.lax.cond(jnp.all(out.crc_ok), lambda r: r,
                                   _rescue, out)
            return out

        return run

    @functools.cached_property
    def _receive_jit(self):
        return jax.jit(self.receive_fn, static_argnames=("stage", "sync_limit"))

    @functools.cached_property
    def decode_at_jit(self):
        """Jitted decode-at-known-delay (used by the link layer to decode the
        frames of a batch after syncing on the first one)."""
        return jax.jit(self.decode_at)

    @functools.cached_property
    def refine_decode_jit(self):
        """Jitted per-frame re-sync + decode for the sibling frames of a
        batch: each row's delay is refined with the known-preamble matched
        filter within ±window samples of its nominal offset before
        decoding, so a transport that pads, coalesces or drifts between
        frames (the reference's window arithmetic tolerates this,
        arq_common.cc:2690-2730) cannot break the fixed-slot assumption.
        Returns (payload, crc_ok, iters, snr, mean_h, delay, score)."""
        from mercury_tpu.modem import sync as sync_mod
        templates = jnp.asarray(self._mf_templates)

        def run(rows, coarse_delay, freq, window: int):
            iq = self.mix(rows, freq)
            d, score = sync_mod.matched_filter_refine(
                iq, coarse_delay, templates, self.geom, window)
            out = self.decode_at(rows, d - 8, freq)
            return (*out, d, score)
        return jax.jit(run, static_argnames=("window",))

    def receive(self, pb_buffer) -> RxResult:
        """Full RX: sync + CFO + decode. pb_buffer: [B, buffer_samples]."""
        return self._receive_jit(jnp.asarray(pb_buffer))


jax.tree_util.register_pytree_node(
    RxResult,
    lambda r: ((r.payload, r.crc_ok, r.delay, r.freq_offset, r.snr_db,
                r.iters, r.sync_metric, r.mean_h), None),
    lambda _, c: RxResult(*c),
)
