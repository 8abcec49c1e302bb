"""Float64 NumPy references for the acquisition scans in modem/sync.py.

Plain, loop-level formulations of the same semantics, independent of the
routes the library picks per backend (FFT size, Toeplitz blocking, operand
dtype). The CPU tests and the on-card parity check compare against them.
"""

from __future__ import annotations

import numpy as np


def _silence_floor(e: np.ndarray, s: int) -> np.ndarray:
    """Per-row window-energy floor of the normalized scores: windows whose
    energy is at or below 1e-4 x the mean window energy score 0."""
    return 1e-4 * e.mean(axis=-1, keepdims=True) * s + 1e-20


def bank_scores(seg: np.ndarray, bank: np.ndarray, window: int) -> np.ndarray:
    """score [B, A, 2*window+1]: for every lag d and bank row a, the sum over
    preamble symbols l of |<seg[d + l*S : d + l*S + S], bank[a, l]>| divided
    by the window norm and the template norm (zero for silent windows).
    seg: [B, L] complex; bank: [A, Lp, S] complex."""
    seg = np.asarray(seg, np.complex128)
    bank = np.asarray(bank, np.complex128)
    b, seg_len = seg.shape
    a, lp, s = bank.shape
    n_cand = 2 * window + 1
    # linear (non-circular) correlation of every row against every template
    n = 1 << int(np.ceil(np.log2(seg_len + s)))
    xf = np.fft.fft(seg, n=n, axis=-1)
    tf = np.fft.fft(bank, n=n, axis=-1)
    corr = np.fft.ifft(xf[:, None, None, :] * np.conj(tf)[None], axis=-1)
    e = np.abs(seg) ** 2
    ce = np.concatenate([np.zeros((b, 1)), np.cumsum(e, axis=-1)], axis=-1)
    floor = _silence_floor(e, s)
    t_norm = np.sqrt(np.sum(np.abs(bank) ** 2, axis=-1))         # [A, Lp]
    score = np.zeros((b, a, n_cand))
    for l in range(lp):
        lo = l * s
        c_l = np.abs(corr[:, :, l, lo: lo + n_cand])
        e_l = ce[:, lo + s: lo + s + n_cand] - ce[:, lo: lo + n_cand]
        term = c_l / (np.sqrt(np.maximum(e_l, floor))[:, None]
                      * t_norm[None, :, l, None])
        score += np.where((e_l > floor)[:, None], term, 0.0)
    return score


def pilot_rescore(bb_ts: np.ndarray, cand_delay: np.ndarray,
                  cand_fidx: np.ndarray, bank: np.ndarray, mf_s: int,
                  ts_dec: int, pre_span: int) -> np.ndarray:
    """score [B, M]: for candidate m of row b, the sum over symbols of the
    normalized |correlation| between the decimated baseband segment starting
    at (cand_delay + pre_span) and the pilot-only template of CFO row
    cand_fidx (zero for silent symbols)."""
    bb_dec = np.asarray(bb_ts, np.complex128)[:, ::mf_s]
    bank = np.asarray(bank, np.complex128)
    f_n, nsym, s_d = bank.shape
    b, m = np.shape(cand_delay)
    n_dec = bb_dec.shape[-1]
    span = nsym * s_d
    e_t = np.sum(np.abs(bank[0]) ** 2, axis=-1)                  # [Nsym]
    out = np.zeros((b, m))
    for i in range(b):
        segs = []
        for j in range(m):
            st = (int(cand_delay[i, j]) + pre_span) // (ts_dec * mf_s)
            st = min(max(st, 0), max(n_dec - span, 0))
            segs.append(bb_dec[i, st: st + span].reshape(nsym, s_d))
        segs = np.stack(segs)                                    # [M, Nsym, S]
        e_s = np.sum(np.abs(segs) ** 2, axis=-1)                 # [M, Nsym]
        floor = 1e-4 * e_s.mean() + 1e-20
        for j in range(m):
            c = np.sum(segs[j] * np.conj(bank[int(cand_fidx[i, j])]), axis=-1)
            term = np.abs(c) / np.sqrt(np.maximum(e_s[j] * e_t, 1e-30))
            out[i, j] = np.sum(np.where(e_s[j] > floor, term, 0.0))
    return out
