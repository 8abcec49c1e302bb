"""Synchronization: Schmidl-Cox time sync, Moose fine CFO, MFSK tone sync.

Tensor formulation: the reference's O(window x preamble) sliding
correlation (ofdm.cc:1735-1844) collapses into cumulative-sum algebra.  With
S = (Ngi+Nfft)*R the per-window sums are differences of "comb" arrays
C[i] = sum_l P[i + l*S] (P a prefix sum), so the correlation metric for EVERY
candidate offset is computed with a handful of shifted vector ops — no
gathers, no loops, exact same metric as the reference at step=1 (the
reference subsamples with step=100; evaluating all offsets is strictly
better and free here).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mercury_tpu.core.geometry import ModeGeometry


def _comb(prefix: jnp.ndarray, n_sections: int, stride: int, out_len: int) -> jnp.ndarray:
    """C[i] = sum_{l<n_sections} prefix[i + l*stride], for i < out_len."""
    acc = prefix[..., :out_len]
    for l in range(1, n_sections):
        acc = acc + prefix[..., l * stride: l * stride + out_len]
    return acc


def schmidl_cox_metric(bb: jnp.ndarray, geom: ModeGeometry,
                       decim: int = 1,
                       use_mm: bool | None = None,
                       scan: int = 1) -> jnp.ndarray:
    """Normalized Schmidl-Cox correlation for every candidate start offset.

    bb: baseband [B, n] at interp rate divided by `decim` (the time-sync FIR
    bandlimits to <1.1 kHz, so a 2x-decimated search loses nothing but a
    sample of timing resolution that the matched-filter refinement restores).
    Returns metric [B, n_cand]; candidate i corresponds to interp-rate offset
    i*decim*scan. `scan` strides the candidate grid (the metric plateau is
    one GI wide and the matched-filter refinement re-localizes within +-2
    symbols, so scanning every 4th offset loses nothing — the reference
    scans at step=100 interp samples); all window offsets must divide by
    scan, asserted below. Matches the reference time_sync_preamble metric: GI-lag and
    half-symbol-lag correlations summed over the preamble symbols, normalized
    by sqrt(norm_a * norm_b); near-zero-energy windows are zeroed
    (norm < 0.001 guard, ofdm.cc:1813-1816).

    The per-window sums are sliding box sums of the lag-product arrays; on
    accelerators they run as banded-Toeplitz matmuls (ops.box_sum_valid
    matmul path — free of the float32 cancellation of long prefix sums),
    combed over the preamble symbols with `lp` shifted adds.
    """
    if use_mm is None:
        use_mm = jax.default_backend() != "cpu"
    r = geom.interp // decim
    assert r * decim == geom.interp
    nfft_r, ngi_r = geom.nfft * r, geom.ngi * r
    half_r = (geom.nfft // 2) * r
    s = nfft_r + ngi_r
    lp = geom.preamble_nsymb
    n = bb.shape[-1]
    n_cand = max(n - lp * s, 1)
    assert scan == 1 or (s % scan == 0 and ngi_r % scan == 0
                         and nfft_r % scan == 0 and half_r % scan == 0), scan
    n_scan = -(-n_cand // scan)
    s_c = s // scan

    # Complex lag products: a carrier offset rotates each lag correlation by
    # a fixed phase (2π·Δf·lag/fs), so taking |·| per lag type makes the
    # coarse metric CFO-immune — the reference's real-part sum collapses
    # around ±22 Hz, which is why it needs its ±30 Hz re-mix search; this
    # formulation doesn't (intra-window rotation is negligible).
    p1 = bb[..., :-nfft_r] * jnp.conj(bb[..., nfft_r:])
    p2 = bb[..., :-half_r] * jnp.conj(bb[..., half_r:])
    e = jnp.real(bb) ** 2 + jnp.imag(bb) ** 2

    from mercury_tpu.dsp import ops as _ops
    # comb reach: window sums are read at offsets i + l*s for l < lp
    comb_span = (lp - 1) * s
    # b1[j]  = Σ_{k<ngi}  p1[j+k]          (GI-lag correlation window)
    # b2[j]  = Σ_{k<half} p2[j+k]          (half-symbol-lag window)
    # ea[j]  = Σ_{k<ngi+half} e[j+k]       (norm_a energy window)
    # eb1[j] = Σ_{k<ngi}  e[j+k]           (norm_b part 1, at offset nfft)
    # eb2[j] = Σ_{k<half} e[j+k]           (norm_b part 2, at offset ngi+half)
    cs = comb_span // scan
    b1 = _ops.box_sum_valid(p1, ngi_r, n_scan + cs, use_mm, scan)
    b2 = _ops.box_sum_valid(p2, half_r, n_scan + cs + ngi_r // scan,
                            use_mm, scan)
    ea = _ops.box_sum_valid(e, ngi_r + half_r, n_scan + cs, use_mm, scan)
    eb1 = _ops.box_sum_valid(e, ngi_r, n_scan + cs + nfft_r // scan,
                             use_mm, scan)
    eb2 = _ops.box_sum_valid(e, half_r,
                             n_scan + cs + (ngi_r + half_r) // scan,
                             use_mm, scan)

    out_len = n_scan
    gi_c = _comb(b1, lp, s_c, out_len)
    half_c = _comb(b2[..., ngi_r // scan:], lp, s_c, out_len)
    norm_a = _comb(ea, lp, s_c, out_len)
    norm_b = (_comb(eb1[..., nfft_r // scan:], lp, s_c, out_len)
              + _comb(eb2[..., (ngi_r + half_r) // scan:], lp, s_c, out_len))
    gi_num = jnp.abs(gi_c)
    half_num = jnp.abs(half_c)
    corr = gi_num + half_num
    denom = jnp.sqrt(jnp.maximum(norm_a * norm_b, 1e-30))
    # Energy gates: the reference's absolute norm<1e-3 guard, plus a relative
    # gate at -20 dB of the strongest window (kills ratio≈1 windows in
    # near-silence regions, which cannot be the peak).
    floor = jnp.maximum(1e-3, 1e-2 * jnp.max(norm_a, axis=-1, keepdims=True))
    metric = jnp.where((norm_a < floor) | (norm_b < floor), 0.0, corr / denom)

    # free coarse CFO per candidate from the half-symbol lag phase:
    # angle(Σ p2) = -2π·Δf·(Nfft/2·R_interp)/fs, unambiguous over ±fs/Nfft
    # = ±46.9 Hz (twice Moose's range) — used to pre-rotate the matched
    # filter and seed the CFO hypothesis set.
    # lag in real-time seconds is decim-invariant: half_r*decim / fs
    # sign: the reference's conjugate-free mixer (+sin arm) produces the
    # conjugate baseband, so the apparent rotation is negated relative to
    # the textbook convention (verified against injected offsets)
    lag_s = (geom.nfft // 2) * geom.interp / geom.fs
    cfo = jnp.arctan2(jnp.imag(half_c), jnp.real(half_c)) / (2 * np.pi * lag_s)
    return metric, cfo


def matched_filter_refine(bb: jnp.ndarray, coarse_delay: jnp.ndarray,
                          templates: jnp.ndarray, geom: ModeGeometry,
                          window: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Refine the Schmidl-Cox delay with a known-preamble matched filter.

    The self-referential Schmidl-Cox metric has a plateau: offsets one whole
    preamble symbol early/late still overlap 3 of 4 identical halves, so
    noise can tip the argmax by ±(Nofdm*R). Correlating against the *known*
    preamble waveform kills the ambiguity. To stay CFO-tolerant the
    correlation is coherent per preamble symbol and combined non-coherently
    (|.| per symbol): a 30 Hz offset costs <1 dB per 5.7 ms symbol instead of
    destroying a 23 ms coherent correlation. (New capability vs the
    reference, which retries decode trials instead.)

    bb: [B, n] interp-rate baseband. templates: [Lp, S] complex preamble
    symbol waveforms (interp rate, incl. GI). Returns (delay [B], score [B]).
    """
    lp, s = templates.shape
    seg_len = 2 * window + lp * s
    n = bb.shape[-1]
    start = jnp.clip(coarse_delay - window, 0, max(n - seg_len, 0))

    def slice_one(row, st):
        return jax.lax.dynamic_slice(row, (st,), (seg_len,))

    seg = jax.vmap(slice_one)(bb, start)
    return matched_filter_refine_seg(seg, start, templates, window)


def matched_filter_refine_seg(seg: jnp.ndarray, start: jnp.ndarray,
                              templates: jnp.ndarray,
                              window: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Matched-filter refinement over a pre-extracted full-rate segment.
    seg: [B, 2*window + Lp*S]; start: absolute offset of seg[0]."""
    delay, score = matched_filter_refine_bank(
        seg, start, np.asarray(templates)[None], window)
    return delay[:, 0], score[:, 0]


def topk_pooled(score: jnp.ndarray, start, topn: int,
                pool_w: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Top-N peaks of score [..., n_cand] with plateau suppression: max-pool
    into pool_w-wide windows first so the N nominees are distinct peaks, not
    N samples of one peak. Returns (delay [..., N] = start + offset,
    score [..., N])."""
    n_cand = score.shape[-1]
    n_pool = -(-n_cand // pool_w)
    pad = n_pool * pool_w - n_cand
    sp = jnp.pad(score, [(0, 0)] * (score.ndim - 1) + [(0, pad)],
                 constant_values=-jnp.inf)
    sp = sp.reshape(*score.shape[:-1], n_pool, pool_w)
    pooled = jnp.max(sp, axis=-1)
    inner = jnp.argmax(sp, axis=-1)
    k = min(topn, n_pool)
    top_s, top_i = jax.lax.top_k(pooled, k)                   # [..., N]
    off = top_i * pool_w + jnp.take_along_axis(inner, top_i, axis=-1)
    if isinstance(start, jnp.ndarray) and start.ndim:
        off = off + start.reshape(start.shape + (1,) * (off.ndim - start.ndim))
    else:
        off = off + start
    return off.astype(jnp.int32), top_s


def matched_filter_refine_bank(seg: jnp.ndarray, start: jnp.ndarray,
                               bank: np.ndarray, window: int,
                               use_mm: bool | None = None,
                               topn: int = 1, pool_w: int = 8,
                               ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Matched-filter refinement against a bank of A template variants
    (e.g. CFO-alias rotations, host-precomputed) in one pass.

    Rotating the *segment* by e^{jwt} and rotating the *template* by
    e^{-jwt} give the same per-symbol |correlation| (only the constant
    phase e^{jwd} differs), so data-independent CFO hypotheses move to the
    template side — one shared windows/FFT pass for the whole bank.

    use_mm selects the correlation engine: banded-Toeplitz matmuls
    (accelerator default — only the n_cand lags actually scored are
    computed) or FFT correlation (CPU default — fewer flops).

    seg: [B, 2*window + Lp*S]; start: absolute offset of seg[0];
    bank: [A, Lp, S] complex. Returns (delay [B, A], score [B, A]); with
    topn > 1, (delay [B, A, N], score [B, A, N]) — the N best DISTINCT
    peaks per row (pool_w-window plateau suppression, see topk_pooled),
    used by the coherent deep-acquisition re-score to nominate more than
    one start hypothesis per CFO row.
    """
    a, lp, s = bank.shape
    score = bank_scores(seg, np.asarray(bank), window, use_mm=use_mm)
    if topn > 1:
        d_n, s_n = topk_pooled(score, start[:, None, None], topn, pool_w)
        return d_n, s_n / lp
    best = jnp.argmax(score, axis=-1)                          # [B, A]
    delay = start[:, None] + best
    return (delay.astype(jnp.int32),
            jnp.take_along_axis(score, best[..., None], axis=-1)[..., 0] / lp)


def coherent_scan_max(seg: jnp.ndarray, bank: np.ndarray, window: int
                      ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(smax [B, n_cand], sarg [B, n_cand] int32): bank_scores max-combined
    over the hypothesis axis. The coherent surface sets the CONFIG_0
    acquisition floor, so it is a float32 FFT correlation on every backend
    (cuFFT on the GPU): never bf16 or TF32 operands. On an H100 it also
    beat the float32 Toeplitz matmul, 5.4 against 25.9 ms of device time at
    batch 256 (PERF.md, PR 1)."""
    score = bank_scores(seg, bank, window, use_mm=False)
    return jnp.max(score, axis=1), jnp.argmax(score, axis=1).astype(jnp.int32)


def bank_scores(seg: jnp.ndarray, bank: np.ndarray, window: int,
                use_mm: bool | None = None, mm_dtype=None) -> jnp.ndarray:
    """Normalized matched-filter scores of `bank` [A, Lp, S] against seg at
    every lag 0..2*window: the raw [B, A, n_cand] surface behind
    matched_filter_refine_bank, exposed for whole-buffer acquisition scans
    that combine rows themselves (e.g. the coherent scan max-combines the
    CFO axis before nomination).

    use_mm=False is a float32 FFT correlation (jnp.fft: cuFFT on the GPU),
    the route of the whole-buffer scans. mm_dtype is the Toeplitz route's
    operand dtype. None means bfloat16 off the CPU: there the scores only
    arbitrate (candidate x alias) and ~0.1% operand rounding does not move
    the argmax."""
    if use_mm is None:
        use_mm = jax.default_backend() != "cpu"
    if seg.dtype == jnp.complex128:
        use_mm = False                   # the matmul path is f32-only
    a, lp, s = bank.shape
    n_cand = 2 * window + 1
    bank = np.asarray(bank)

    if use_mm:
        n_off = n_cand + (lp - 1) * s
        filt = np.conj(bank).reshape(a * lp, s)
        from mercury_tpu.dsp import ops as _ops
        if mm_dtype is None and jax.default_backend() != "cpu":
            mm_dtype = jnp.bfloat16
        c_re, c_im = _ops.corr_valid_mm_multi(seg, filt, n_off,
                                              mm_dtype=mm_dtype)
        c_all = (c_re.reshape(seg.shape[0], a, lp, n_off),
                 c_im.reshape(seg.shape[0], a, lp, n_off))

        def corr_abs(l):
            cr = c_all[0][:, :, l, l * s: l * s + n_cand]
            ci = c_all[1][:, :, l, l * s: l * s + n_cand]
            return jnp.sqrt(cr * cr + ci * ci)
    else:
        # a transform of at least seg_len points keeps every scored lag
        # (l*s + d + t < seg_len) clear of the circular wrap
        seg_len = seg.shape[-1]
        nfft2 = 1
        while nfft2 < seg_len:
            nfft2 *= 2
        tfc = np.conj(np.fft.fft(bank, n=nfft2, axis=-1))
        xf = jnp.fft.fft(seg, n=nfft2, axis=-1)
        corr = jnp.fft.ifft(xf[:, None, None, :]
                            * jnp.asarray(tfc, dtype=xf.dtype)[None],
                            axis=-1)                           # [B, A, Lp, n2]

        def corr_abs(l):
            return jnp.abs(corr[:, :, l, l * s: l * s + n_cand])

    e = jnp.abs(seg) ** 2
    ce = jnp.concatenate([jnp.zeros_like(e[..., :1]), jnp.cumsum(e, axis=-1)], axis=-1)
    t_norm = np.sqrt(np.sum(np.abs(bank) ** 2, axis=-1))       # [A, Lp]

    score = jnp.zeros((seg.shape[0], a, n_cand), dtype=seg.real.dtype)
    # mean energy scale for the silence guard: float32 prefix-sum cancellation
    # can drive window energies to ~0 (or negative) in exact silence, which
    # would explode the normalized score — zero those windows instead
    e_floor = 1e-4 * jnp.mean(e, axis=-1, keepdims=True) * s + 1e-20
    for l in range(lp):
        c_l = corr_abs(l)
        e_l = ce[..., l * s + s: l * s + s + n_cand] - ce[..., l * s: l * s + n_cand]
        term = c_l / (jnp.sqrt(jnp.maximum(e_l, e_floor))[:, None]
                      * jnp.asarray(t_norm[None, :, l, None]))
        score = score + jnp.where(e_l[:, None] > e_floor[:, None], term, 0.0)
    return score


def coherent_preamble_rescore(bb_ts: jnp.ndarray, cand_delay: jnp.ndarray,
                              bank: np.ndarray, mf_s: int,
                              ts_dec: int) -> jnp.ndarray:
    """Fully-coherent preamble scoring of candidate frame starts.

    The scan metrics above combine the per-preamble-symbol correlations
    noncoherently (|c_l| per symbol, summed) to stay CFO-tolerant — which
    costs ~1-1.2 dB of metric SNR at Lp=4 relative to the coherent sum
    |sum_l c_l| that a static channel allows. At the deep-acquisition floor
    (cfg0 at effective −10 dB) that loss IS the remaining passband-vs-
    baseband gap (tools/acq_floor_r5.py: misacquisition 0.18 where genie
    sync decodes at FER 0.02). This stage restores the coherent gain for a
    SHORTLIST of candidates: each bank row carries one CFO hypothesis with
    the template rotated in ABSOLUTE time — including the l*S inter-symbol
    phase — so for the correct hypothesis the per-symbol correlations add
    in phase; a fine grid (~4 Hz) bounds the residual inter-symbol drift
    to <0.5 dB. Capability the reference lacks entirely (its passband sync
    gates FER 1.0; its trial loop re-decodes instead,
    telecom_system.cc:931-1017).

    bb_ts: [B, n_ts] base-rate TS baseband (interp rate / ts_dec).
    cand_delay: [B, N] interp-rate start candidates (multiples of
      mf_d = mf_s * ts_dec, as produced by the MF scan/refinement).
    bank: [F, Lp, S_d] complex, template symbol l sampled at mf_d rate and
      rotated by exp(-j*2*pi*f*(l*S + t*mf_d)/fs).
    Returns score [B, N, F], normalized by segment energy x template norm.
    """
    f_n, lp, s_d = bank.shape
    b, n_ts = bb_ts.shape
    # Decimate ONCE, then take CONTIGUOUS per-candidate slices. Every
    # candidate is a multiple of mf_d = mf_s*ts_dec (MF-scan grid), so
    # bb_ts[idx0 + k*mf_s] == bb_dec[idx0/mf_s + k] exactly, and the
    # slices read mf_s times fewer bytes than full-rate spans strided
    # afterwards.
    bb_dec = bb_ts[:, ::mf_s]                      # [B, n_ts/mf_s]
    span_d = lp * s_d
    n_dec = bb_dec.shape[-1]
    idx0 = jnp.clip(cand_delay // (ts_dec * mf_s), 0,
                    max(n_dec - span_d, 0))

    def slice_one(row, st):
        return jax.lax.dynamic_slice(row, (st,), (span_d,))

    seg = jax.vmap(jax.vmap(slice_one, in_axes=(None, 0)),
                   in_axes=(0, 0))(bb_dec, idx0)   # [B, N, Lp*S_d]
    bk = np.conj(np.asarray(bank)).reshape(f_n, lp * s_d)
    # HIGHEST precision: at the acquisition floor the signal sits ~10 dB
    # under the noise and the coherent gain must come out of a ~2400-long
    # dot product; reduced-precision multiplies (bf16, TF32) cost
    # measurable waterfall there (same reason as the estimation operator)
    c = jnp.einsum("bns,fs->bnf", seg, jnp.asarray(bk, dtype=seg.dtype),
                   precision=jax.lax.Precision.HIGHEST)
    e = jnp.sum(jnp.real(seg) ** 2 + jnp.imag(seg) ** 2, axis=-1)  # [B, N]
    t2 = float(np.sum(np.abs(bank[0]) ** 2))       # rotation-invariant
    return jnp.abs(c) / jnp.sqrt(jnp.maximum(e[..., None] * t2, 1e-30))


def pilot_rescore(bb_ts: jnp.ndarray, cand_delay: jnp.ndarray,
                  cand_fidx: jnp.ndarray, bank: np.ndarray, mf_s: int,
                  ts_dec: int, pre_span: int) -> jnp.ndarray:
    """Pilot-lattice extended-preamble scoring of candidate frame starts.

    The preamble carries ~200 Es-units of energy at cfg0; the pilot lattice
    carries ~1400 (800 pilots x 1.33^2 boost) — 7x more integrable signal
    for start arbitration. Each candidate (delay, CFO-grid-index) pair from
    the coherent preamble stage is re-scored against the per-symbol
    PILOT-ONLY waveforms (data cells zero in the template: the unknown data
    acts as zero-mean self-noise in the correlation). Time-domain
    correlation keeps the mf_d delay quantization harmless (peak width
    ~1/BW >> mf_d), where a frequency-domain pilot correlation would lose
    within-symbol carrier coherence to the residual timing ramp. Coherent
    within each symbol (CFO known to ~grid/2 from the coherent stage),
    noncoherent |.| across symbols (the multi-second frame drifts many
    radians even at 2 Hz residual).

    bb_ts: [B, n_ts] base-rate TS baseband. cand_delay: [B, M] interp-rate
    frame starts. cand_fidx: [B, M] indices into the CFO grid. bank:
    [F, Nsymb, S_d] complex pilot-only symbol templates at mf_d rate, each
    rotated by its grid CFO in LOCAL symbol time (absolute phase cancels in
    the per-symbol |.|), with TX pre-equalization applied. pre_span:
    preamble length in interp samples. Returns score [B, M] (sum of
    normalized per-symbol correlation magnitudes).
    """
    f_n, nsym, s_d = bank.shape
    b, n_ts = bb_ts.shape
    # decimate once + contiguous slices (see coherent_preamble_rescore);
    # the <=mf_d start quantization this introduces sits well inside the
    # ~1/BW pilot correlation peak width
    bb_dec = bb_ts[:, ::mf_s]
    span_d = nsym * s_d
    n_dec = bb_dec.shape[-1]
    start = cand_delay + pre_span
    idx0 = jnp.clip(start // (ts_dec * mf_s), 0, max(n_dec - span_d, 0))

    def slice_one(row, st):
        return jax.lax.dynamic_slice(row, (st,), (span_d,))

    seg = jax.vmap(jax.vmap(slice_one, in_axes=(None, 0)),
                   in_axes=(0, 0))(bb_dec, idx0)
    seg = seg.reshape(b, cand_delay.shape[1], nsym, s_d)
    bank_j = jnp.asarray(np.conj(np.asarray(bank)), dtype=seg.dtype)
    bk = jnp.take(bank_j, cand_fidx, axis=0)       # [B, M, Nsymb, S_d]
    c = jnp.sum(seg * bk, axis=-1)                 # [B, M, Nsymb]
    e_s = jnp.sum(jnp.real(seg) ** 2 + jnp.imag(seg) ** 2, axis=-1)
    e_t = np.sum(np.abs(np.asarray(bank[0])) ** 2, axis=-1)     # [Nsymb]
    e_floor = 1e-4 * jnp.mean(e_s, axis=(-2, -1), keepdims=True) + 1e-20
    term = jnp.abs(c) / jnp.sqrt(jnp.maximum(
        e_s * jnp.asarray(e_t, e_s.dtype)[None, None], 1e-30))
    return jnp.sum(jnp.where(e_s > e_floor, term, 0.0), axis=-1)


def gi_time_sync_metric(bb: jnp.ndarray, geom: ModeGeometry,
                        decim: int = 1,
                        ts_nsymb: int | None = None) -> jnp.ndarray:
    """Legacy guard-interval time sync (reference cl_ofdm::time_sync,
    ofdm.cc:1659-1733): for every candidate offset, correlate each of the
    first `ts_nsymb` symbols' GI against its cyclic copy Nfft later,
    normalized by the window energies. The reference's O(size x Nsymb x Ngi)
    loop collapses into cumulative-sum comb algebra (same trick as the
    Schmidl-Cox metric above). Returns metric [B, n_cand]; candidate i is
    interp-rate offset i*decim.
    """
    r = geom.interp // decim
    assert r * decim == geom.interp
    nfft_r, ngi_r = geom.nfft * r, geom.ngi * r
    s = nfft_r + ngi_r
    # reference default: time_sync_Nsymb = Nsymb (telecom_system.cc:2913-2915)
    lp = ts_nsymb if ts_nsymb is not None else geom.nsymb
    n = bb.shape[-1]
    # candidates whose every correlation window lies inside the buffer (the
    # reference's i < size-S loop quietly reads past `size`; we don't)
    n_cand = max(n - nfft_r - (lp - 1) * s - ngi_r, 1)

    # Re(a * conj(b)) at lag Nfft == the reference's re*re + im*im sum
    p = jnp.real(bb[..., :-nfft_r] * jnp.conj(bb[..., nfft_r:]))
    e = jnp.real(bb) ** 2 + jnp.imag(bb) ** 2

    zero = jnp.zeros_like(p[..., :1])
    cp = jnp.concatenate([zero, jnp.cumsum(p, axis=-1)], axis=-1)
    ce = jnp.concatenate([zero, jnp.cumsum(e, axis=-1)], axis=-1)

    c = _comb(cp, lp, s, n_cand + ngi_r)
    ca = _comb(ce, lp, s, n_cand + ngi_r)
    cb = _comb(ce[..., nfft_r:], lp, s, n_cand + ngi_r)
    corr = c[..., ngi_r:] - c[..., :n_cand]
    norm_a = ca[..., ngi_r:] - ca[..., :n_cand]
    norm_b = cb[..., ngi_r:] - cb[..., :n_cand]
    return corr / jnp.sqrt(jnp.maximum(norm_a * norm_b, 1e-30))


def gi_symbol_sync_metric(frame_bb: jnp.ndarray,
                          geom: ModeGeometry) -> jnp.ndarray:
    """Legacy per-symbol sync-quality metric (reference cl_ofdm::symbol_sync,
    ofdm.cc:2188-2266): for each OFDM symbol of a frame-aligned baseband,
    |normalized correlation| between the half-symbol windows at the symbol
    start and +Nfft/2. Returns metric [B, Nsymb] (argsort for the
    reference's location_to_return ranking)."""
    nofdm, half = geom.nofdm, geom.nfft // 2
    nsymb = frame_bb.shape[-1] // nofdm
    sym = frame_bb[..., : nsymb * nofdm].reshape(*frame_bb.shape[:-1],
                                                 nsymb, nofdm)
    a = sym[..., :half]
    b = sym[..., half: 2 * half]
    corr = jnp.sum(jnp.real(a * jnp.conj(b)), axis=-1)
    norm_a = jnp.sum(jnp.abs(a) ** 2, axis=-1)
    norm_b = jnp.sum(jnp.abs(b) ** 2, axis=-1)
    return jnp.abs(corr) / jnp.sqrt(jnp.maximum(norm_a * norm_b, 1e-30))


def moose_cfo(frame_decim: jnp.ndarray, geom: ModeGeometry) -> jnp.ndarray:
    """Fine fractional CFO from preamble half-symbol repetition
    (reference: carrier_sampling_frequency_sync, ofdm.cc:540-595).

    frame_decim: [B, >= preamble_nsymb*Nofdm] decimated baseband starting at
    the frame (preamble first). Returns frequency offset in Hz [B].
    The reference skips the GI (called with &baseband[Ngi]) and uses
    preamble_nsymb/2 symbols (min 1), duplicating each half into an Nfft
    frame, FFT, depad, and correlating the two halves across carriers.
    """
    nfft, ngi, nc = geom.nfft, geom.ngi, geom.nc
    nsym = max(geom.preamble_nsymb // 2, 1)
    pad_map = jnp.asarray(geom.pad_map)
    subc = geom.bandwidth / nc

    mul = jnp.zeros(frame_decim.shape[:-1], dtype=frame_decim.dtype)
    for j in range(nsym):
        base = ngi + j * (nfft + ngi)
        h1 = frame_decim[..., base: base + nfft // 2]
        h2 = frame_decim[..., base + nfft // 2: base + nfft]
        f1 = jnp.concatenate([h1, h1], axis=-1)
        f2 = jnp.concatenate([h2, h2], axis=-1)
        d1 = (jnp.fft.fft(f1, axis=-1) / nfft)[..., pad_map]
        d2 = (jnp.fft.fft(f2, axis=-1) / nfft)[..., pad_map]
        mul = mul + jnp.sum(jnp.conj(d2) * d1, axis=-1)
    # reference get_angle() == atan2 in (-pi, pi]
    angle = jnp.arctan2(jnp.imag(mul), jnp.real(mul))
    return (angle / np.pi) * subc


def mfsk_sync_metric(bb: jnp.ndarray, geom: ModeGeometry,
                     decim: int = 1) -> jnp.ndarray:
    """MFSK preamble tone correlation per symbol-aligned offset
    (reference: time_sync_mfsk, ofdm.cc:1969-2063).

    bb: baseband [B, n] at interp/decim rate. Returns metric
    [B, n_symb_cand]; candidate s corresponds to delay s * Nofdm * interp.
    """
    p = geom.mfsk
    r = geom.interp // decim
    assert r * decim == geom.interp
    nofdm, nfft, ngi, nc = geom.nofdm, geom.nfft, geom.ngi, geom.nc
    n = bb.shape[-1]
    buffer_nsymb = n // (nofdm * r)
    lp = min(geom.preamble_nsymb, len(p.preamble_tones))
    n_cand = buffer_nsymb - geom.preamble_nsymb + 1

    # decimate, frame into symbols, FFT each symbol
    dec = bb[..., ::r][..., : buffer_nsymb * nofdm]
    sym = dec.reshape(*bb.shape[:-1], buffer_nsymb, nofdm)[..., ngi: ngi + nfft]
    spec = jnp.fft.fft(sym, axis=-1) / nfft
    grid = spec[..., jnp.asarray(geom.pad_map)]               # [B, S, Nc]
    energy = jnp.abs(grid) ** 2
    e_total = jnp.sum(energy, axis=-1)                        # [B, S]

    # per preamble symbol p: energy at expected tone bins across streams
    ratios = []
    for pp in range(geom.preamble_nsymb):
        tone = int(p.preamble_tones[pp % lp])
        e_t = sum(energy[..., int(off) + tone] for off in p.stream_offsets)
        ratios.append(jnp.where(e_total > 0, e_t / jnp.maximum(e_total, 1e-30), 0.0))
    ratio = jnp.stack(ratios, axis=-1)                        # [B, S, Lp]

    # metric(s) = sum_p ratio[s+p, p]
    met = jnp.zeros((*bb.shape[:-1], n_cand), dtype=ratio.dtype)
    for pp in range(geom.preamble_nsymb):
        met = met + ratio[..., pp: pp + n_cand, pp]
    return met


def pattern_detect_metric(bb: jnp.ndarray, geom: ModeGeometry, tones: np.ndarray,
                          mfsk_params=None) -> tuple[jnp.ndarray, jnp.ndarray]:
    """ACK/BREAK tone-pattern detection (reference: detect_ack_pattern,
    ofdm.cc:2067-2186): per symbol-aligned window, count symbols whose
    expected hopped tone is the peak of its stream band, and accumulate
    E_target/E_total for the matched symbols.

    Returns (metric [B, n_cand], matched [B, n_cand]).
    """
    p = mfsk_params if mfsk_params is not None else geom.mfsk
    r = geom.interp
    nofdm, ngi = geom.nofdm, geom.ngi
    n = bb.shape[-1]
    buffer_nsymb = n // (nofdm * r)
    nsymb_pat = p.ack_pattern_nsymb
    n_cand = buffer_nsymb - nsymb_pat + 1
    if n_cand < 1:
        z = jnp.zeros((*bb.shape[:-1], 1))
        return z, z

    dec = bb[..., ::r][..., : buffer_nsymb * nofdm]
    sym = dec.reshape(*bb.shape[:-1], buffer_nsymb, nofdm)[..., ngi: ngi + geom.nfft]
    spec = jnp.fft.fft(sym, axis=-1) / geom.nfft
    grid = spec[..., jnp.asarray(geom.pad_map)]
    energy = jnp.abs(grid) ** 2                                # [B, S, Nc]
    e_total = jnp.sum(energy, axis=-1)

    contrib = []   # [B, S] per pattern position
    hit = []
    for pos in range(nsymb_pat):
        base = int(tones[pos % len(tones)])
        actual = (base + pos * p.tone_hop_step) % p.m
        e_exp = sum(energy[..., int(off) + actual] for off in p.stream_offsets)
        any_peak = False
        for off in p.stream_offsets:
            band = energy[..., int(off): int(off) + p.m]
            peak = jnp.max(band, axis=-1)
            e_this = energy[..., int(off) + actual]
            any_peak = (e_this >= peak) | any_peak
        contrib.append(jnp.where(any_peak, e_exp / jnp.maximum(e_total, 1e-30), 0.0))
        hit.append(any_peak)
    contrib = jnp.stack(contrib, axis=-1)                      # [B, S, 16]
    hit = jnp.stack(hit, axis=-1)

    met = jnp.zeros((*bb.shape[:-1], n_cand))
    cnt = jnp.zeros((*bb.shape[:-1], n_cand))
    for pos in range(nsymb_pat):
        met = met + contrib[..., pos: pos + n_cand, pos]
        cnt = cnt + hit[..., pos: pos + n_cand, pos]
    return met, cnt
