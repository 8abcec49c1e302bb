"""Batched, statically-shaped DSP primitives for the device compute path.

Every function is shape-polymorphic over a leading batch axis and jit-safe.
Semantics match the reference implementations cited per function; the layout
is frames-as-tensors instead of sample-at-a-time loops.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def fir_same(x: jnp.ndarray, taps) -> jnp.ndarray:
    """Center-aligned 'same' FIR convolution, batched over the leading axis.

    Matches cl_FIR::apply (reference: fir_filter.cc:167-210): out[i] =
    sum_j h[j] x[i - j + (nTaps-1)//2], zero-padded edges. Works for real or
    complex x (complex filtered as two real convolutions).
    """
    taps = jnp.asarray(taps)
    if jnp.iscomplexobj(x):
        re = fir_same(x.real, taps)
        im = fir_same(x.imag, taps)
        return re + 1j * im
    x = jnp.atleast_2d(x)
    n = x.shape[-1]
    ntaps = taps.shape[0]
    center = (ntaps - 1) // 2
    # conv_general_dilated computes correlation with flipped rhs == convolution
    lhs = x[:, None, :].astype(taps.dtype)
    rhs = jnp.flip(taps)[None, None, :]
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1,),
        padding=[(ntaps - 1 - center, center)],
        dimension_numbers=("NCH", "IOH", "NCH"))
    return out[:, 0, :n]


def fir_same_strided(x: jnp.ndarray, taps, stride: int) -> jnp.ndarray:
    """Centered 'same' FIR evaluated only at positions 0, stride, 2*stride…
    — out[m] == fir_same(x)[m*stride], at 1/stride the filter work."""
    taps = jnp.asarray(taps)
    if jnp.iscomplexobj(x):
        return (fir_same_strided(x.real, taps, stride)
                + 1j * fir_same_strided(x.imag, taps, stride))
    x = jnp.atleast_2d(x)
    ntaps = taps.shape[0]
    center = (ntaps - 1) // 2
    lhs = x[:, None, :].astype(taps.dtype)
    rhs = jnp.flip(taps)[None, None, :]
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(stride,),
        padding=[(ntaps - 1 - center, center)],
        dimension_numbers=("NCH", "IOH", "NCH"))
    return out[:, 0]


def fir_decimate_segment(seg: jnp.ndarray, taps, stride: int) -> jnp.ndarray:
    """Polyphase decimating FIR over a pre-extracted segment.

    seg: [..., n_out*stride + ntaps - 1] where seg[k] corresponds to
    x[start - center + k] of the underlying signal (center = (ntaps-1)//2).
    Returns out[..., n_out] with out[m] == fir_same(x)[start + m*stride] —
    i.e. identical values to filtering the whole signal and taking every
    stride-th sample from `start`, at 1/stride of the work and only over
    the segment (the RX hot-path optimization: the decoder only ever reads
    base-rate samples of the frame, so the interp-rate FIR over the full
    capture buffer is wasted work).
    """
    taps = jnp.asarray(taps)
    if jnp.iscomplexobj(seg):
        return (fir_decimate_segment(seg.real, taps, stride)
                + 1j * fir_decimate_segment(seg.imag, taps, stride))
    ntaps = taps.shape[0]
    n_out = (seg.shape[-1] - (ntaps - 1)) // stride
    lhs = seg[:, None, :].astype(taps.dtype)
    rhs = jnp.flip(taps)[None, None, :]
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(stride,), padding="VALID",
        dimension_numbers=("NCH", "IOH", "NCH"))
    return out[:, 0, :n_out]


_toeplitz_cache: dict = {}


def _fir_toeplitz(taps_key: bytes, taps: np.ndarray, stride: int,
                  k_blk: int) -> np.ndarray:
    """Banded Toeplitz operator T [W, K] with W = (K-1)*stride + ntaps
    (rounded up to the lane width), T[i, k] = taps[ntaps-1 - (i - k*stride)]
    where in range: a block of K decimated FIR outputs is then one matmul
    `window @ T` instead of a 129-tap loop — the FIR runs as a matmul."""
    key = (taps_key, stride, k_blk)
    t = _toeplitz_cache.get(key)
    if t is None:
        ntaps = taps.shape[0]
        w = (k_blk - 1) * stride + ntaps
        w = -(-w // 128) * 128
        t = np.zeros((w, k_blk), dtype=np.float32)
        hr = taps[::-1].astype(np.float32)
        for k in range(k_blk):
            t[k * stride: k * stride + ntaps, k] = hr
        _toeplitz_cache[key] = t
    return t


def _valid_windows(y: jnp.ndarray, w: int, stride: int, n_out: int,
                   k_blk: int) -> tuple[jnp.ndarray, int]:
    """Blocked sliding windows [B, nb, W] so that window c row covers
    y[c*k_blk*stride : c*k_blk*stride + W]."""
    nb = -(-n_out // k_blk)
    blk = k_blk * stride
    halo = w - blk
    need = nb * blk + max(halo, 0)
    b = y.shape[0]
    y = jnp.pad(y, [(0, 0), (0, max(need - y.shape[-1], 0))])[..., :need]
    if halo <= blk:
        main = y[..., : nb * blk].reshape(b, nb, blk)
        tail = jnp.concatenate(
            [main[:, 1:, :halo],
             y[..., nb * blk: nb * blk + halo][:, None, :]], axis=1)
        win = jnp.concatenate([main, tail], axis=-1)      # [B, nb, W]
    else:
        # window wider than the block stride (short taps / stride 1):
        # build the [nb, W] windows with one gather
        idx = (np.arange(nb)[:, None] * blk
               + np.arange(w)[None, :]).astype(np.int32)
        win = y[:, jnp.asarray(idx)]                      # [B, nb, W]
    return win, nb


def _fir_decimate_valid_mm(y: jnp.ndarray, taps, stride: int,
                           n_out: int, k_blk: int = 128) -> jnp.ndarray:
    """out[m] = sum_u taps[ntaps-1-u] * y[m*stride + u] for m < n_out,
    computed as blocked banded matmuls. Real y; real or complex
    taps (complex taps -> complex output from one real windows tensor)."""
    taps_np = np.asarray(taps)
    b = y.shape[0]

    def t_op_for(t_real: np.ndarray) -> np.ndarray:
        t32 = np.ascontiguousarray(t_real, dtype=np.float32)
        return _fir_toeplitz(t32.tobytes(), t32, stride, k_blk)

    def mm(win, t_op, nb):
        out = jnp.einsum("bci,ik->bck", win, jnp.asarray(t_op),
                         preferred_element_type=jnp.float32)
        return out.reshape(b, nb * k_blk)[..., :n_out]

    if np.iscomplexobj(taps_np):
        t_r, t_i = t_op_for(taps_np.real), t_op_for(taps_np.imag)
        win, nb = _valid_windows(y, t_r.shape[0], stride, n_out, k_blk)
        return mm(win, t_r, nb) + 1j * mm(win, t_i, nb)
    t_op = t_op_for(taps_np)
    win, nb = _valid_windows(y, t_op.shape[0], stride, n_out, k_blk)
    return mm(win, t_op, nb)


def fir_decimate_mm(y: jnp.ndarray, taps, stride: int,
                    n_out: int) -> jnp.ndarray:
    """Complex/real wrapper over the matmul decimating FIR (VALID alignment:
    y[k] corresponds to x[start - center + k], like fir_decimate_segment)."""
    if jnp.iscomplexobj(y):
        return (fir_decimate_mm(y.real, taps, stride, n_out)
                + 1j * fir_decimate_mm(y.imag, taps, stride, n_out))
    return _fir_decimate_valid_mm(y, taps, stride, n_out)


def fir_same_strided_mm(x: jnp.ndarray, taps, stride: int) -> jnp.ndarray:
    """fir_same_strided computed via the blocked banded matmul — identical
    values, as one matmul."""
    if jnp.iscomplexobj(x):
        return (fir_same_strided_mm(x.real, taps, stride)
                + 1j * fir_same_strided_mm(x.imag, taps, stride))
    taps_np = np.asarray(taps)
    ntaps = taps_np.shape[0]
    center = (ntaps - 1) // 2
    left = ntaps - 1 - center
    n = x.shape[-1]
    n_out = (n - 1) // stride + 1
    y = jnp.pad(x, [(0, 0), (left, 0)])
    return _fir_decimate_valid_mm(y, taps_np, stride, n_out)


def fir_same_strided_mix_mm(x: jnp.ndarray, taps, stride: int,
                            w_rad: float, amp: float) -> jnp.ndarray:
    """== fir_same_strided(x * osc, taps, stride) for the oscillator
    osc[n] = amp * e^{j*w_rad*n}, WITHOUT materializing the full-rate
    complex mix: since the oscillator is exponential, it folds into
    complex FIR taps ct[k] = taps[k]*e^{j*w_rad*(center-k)} plus a
    decimated-rate output rotation amp*e^{j*w_rad*m*stride}. One real
    windows tensor feeds two real matmuls — the mixer costs nothing at
    the full rate. x real [B, n]."""
    taps_np = np.asarray(taps, dtype=np.float64)
    ntaps = taps_np.shape[0]
    center = (ntaps - 1) // 2
    left = ntaps - 1 - center
    k = np.arange(ntaps, dtype=np.float64)
    ct = (taps_np * np.exp(1j * w_rad * (center - k))).astype(np.complex128)
    n = x.shape[-1]
    n_out = (n - 1) // stride + 1
    y = jnp.pad(x, [(0, 0), (left, 0)])
    out = _fir_decimate_valid_mm(y, ct, stride, n_out)
    ofac = (amp * np.exp(1j * w_rad * stride
                         * np.arange(n_out, dtype=np.float64))
            ).astype(np.complex64)
    return out * jnp.asarray(ofac)


def fir_decimate_mix_mm(seg: jnp.ndarray, taps, stride: int, n_out: int,
                        w_rad: float, ofac: jnp.ndarray) -> jnp.ndarray:
    """== fir_decimate_mm(seg * osc_seg, taps, stride, n_out) for a mixer
    slice osc_seg[b, u] = ofac[b, 0]-anchored oscillator at w_rad rad/sample:
    osc_seg[b, u] = ofac-phase(b) * e^{j*w_rad*u}. The mixer folds into
    complex taps ct_rev[u] = taps[nt-1-u]*e^{j*w_rad*u}; the caller passes
    ofac[b, m] = oscillator value at output sample m*stride of row b
    (typically a gather from a float64-phase host table — exact), so the
    full-rate complex mixed segment never exists. seg real [B, L]."""
    taps_np = np.asarray(taps, dtype=np.float64)
    ntaps = taps_np.shape[0]
    k = np.arange(ntaps, dtype=np.float64)
    ct = (taps_np * np.exp(1j * w_rad * (ntaps - 1 - k))).astype(np.complex128)
    out = _fir_decimate_valid_mm(seg, ct, stride, n_out)
    return out * ofac.astype(out.dtype)


_corr_bank_cache: dict = {}


def corr_valid_mm_multi(x: jnp.ndarray, filt: np.ndarray, n_out: int,
                        k_blk: int = 128,
                        mm_dtype=None) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Sliding correlations of one complex signal against F complex filters
    as matmuls: c[b, f, j] = sum_t x[b, j+t] * filt[f, t] for j < n_out.

    x: [B, L] complex; filt: [F, S] complex (host numpy — pass the
    conjugate for a matched filter). Returns (re, im) each [B, F, n_out]
    float32. The windows tensor is built once and shared by all filters —
    this is what makes a bank of alias-rotated templates nearly free versus
    one filter.
    """
    f_n, s = filt.shape
    blk = k_blk
    nb = -(-n_out // blk)
    w = blk - 1 + s
    need = (nb - 1) * blk + w
    b = x.shape[0]
    x = jnp.pad(x, [(0, 0), (0, max(need - x.shape[-1], 0))])[..., :need]
    idx = (np.arange(nb)[:, None] * blk + np.arange(w)[None, :]).astype(np.int32)
    win = x[:, jnp.asarray(idx)]                           # [B, nb, W] complex

    key = (filt.tobytes(), filt.shape, str(filt.dtype), blk)
    t_ops = _corr_bank_cache.get(key)
    if t_ops is None:
        tr = np.zeros((w, f_n * blk), np.float32)
        ti = np.zeros((w, f_n * blk), np.float32)
        fr = filt.real.astype(np.float32)
        fi = filt.imag.astype(np.float32)
        for m in range(blk):
            tr[m: m + s, m::blk] = fr.T
            ti[m: m + s, m::blk] = fi.T
        _corr_bank_cache[key] = t_ops = (tr, ti)
    tr, ti = (jnp.asarray(t) for t in t_ops)
    wr, wi = jnp.real(win), jnp.imag(win)
    if mm_dtype is not None:
        # reduced-precision inputs (f32 accumulation): ~0.1% score noise —
        # fine for arbitration scores, do not use on the decode data path
        tr, ti = tr.astype(mm_dtype), ti.astype(mm_dtype)
        wr, wi = wr.astype(mm_dtype), wi.astype(mm_dtype)
    mm = lambda a, t: jnp.einsum("bnw,wk->bnk", a, t,
                                 preferred_element_type=jnp.float32)
    re = mm(wr, tr) - mm(wi, ti)
    im = mm(wr, ti) + mm(wi, tr)

    def fold(o):                                           # [B,nb,F*blk]
        o = o.reshape(b, nb, f_n, blk)
        o = jnp.swapaxes(o, 1, 2).reshape(b, f_n, nb * blk)
        return o[..., :n_out]

    return fold(re), fold(im)


def box_sum_valid(x: jnp.ndarray, length: int, n_out: int,
                  use_mm: bool = True, stride: int = 1) -> jnp.ndarray:
    """Strided sliding-window sums S[j] = sum_{k<length} x[..., j*stride+k]
    for j < n_out.

    use_mm routes through the banded-Toeplitz matmul (the accelerator
    route); otherwise a prefix-sum difference (faster on CPU, but subject to
    float32 cancellation on long buffers). Complex x is handled as two real
    passes.
    """
    if jnp.iscomplexobj(x):
        return (box_sum_valid(x.real, length, n_out, use_mm, stride)
                + 1j * box_sum_valid(x.imag, length, n_out, use_mm, stride))
    if use_mm and x.dtype != jnp.float64:   # the matmul path is f32-only
        ones = np.ones(length, dtype=np.float32)
        return _fir_decimate_valid_mm(x, ones, stride, n_out, k_blk=256)
    c = jnp.cumsum(x, axis=-1)
    c = jnp.concatenate([jnp.zeros_like(c[..., :1]), c], axis=-1)
    idx0 = stride * jnp.arange(n_out)
    return c[..., length:][..., idx0] - c[..., idx0]


def linear_interp(x: jnp.ndarray, rate: int) -> jnp.ndarray:
    """Linear interpolation upsampler (reference rational_resampler
    INTERPOLATION, ofdm.cc:2278-2291); the final input sample is linearly
    extrapolated from the last two. x: [..., N] -> [..., N*rate]."""
    n = x.shape[-1]
    frac = jnp.arange(rate, dtype=jnp.result_type(x.real)) / rate
    body = x[..., :-1, None] + (x[..., 1:, None] - x[..., :-1, None]) * frac
    body = body.reshape(*x.shape[:-1], (n - 1) * rate)
    tail_f = (rate + jnp.arange(rate, dtype=frac.dtype)) / rate
    tail = x[..., n - 2, None] + (x[..., n - 1, None] - x[..., n - 2, None]) * tail_f
    return jnp.concatenate([body, tail], axis=-1)


def decimate(x: jnp.ndarray, rate: int) -> jnp.ndarray:
    """Pick every rate-th sample (reference DECIMATION path)."""
    return x[..., ::rate]


def mix_to_passband(x: jnp.ndarray, fs: float, fc: float, amp: float,
                    start_sample: int = 0) -> jnp.ndarray:
    """Real passband from complex baseband: re*cos + im*sin at carrier fc
    (reference: ofdm.cc:2294-2315)."""
    n = x.shape[-1]
    t = (start_sample + jnp.arange(n, dtype=jnp.float64 if x.dtype == jnp.complex128 else jnp.float32))
    ph = (2 * np.pi * fc / fs) * t
    return x.real * amp * jnp.cos(ph) + x.imag * amp * jnp.sin(ph)


def mix_to_baseband(pb: jnp.ndarray, fs: float, fc: float, amp: float) -> jnp.ndarray:
    """Complex IQ from real passband (reference: ofdm.cc:2330-2334).
    Note the reference uses +sin for the imaginary arm (conjugate-free mix)."""
    n = pb.shape[-1]
    t = jnp.arange(n, dtype=pb.dtype)
    ph = (2 * np.pi * fc / fs) * t
    return pb * amp * (jnp.cos(ph) + 1j * jnp.sin(ph))


def peak_clip(x: jnp.ndarray, papr_db: float) -> jnp.ndarray:
    """Clip |sample| above sqrt(mean_power * 10^(papr/10)) per batch row
    (reference: ofdm.cc:1565-1592)."""
    avg = jnp.mean(x * x, axis=-1, keepdims=True)
    peak = jnp.sqrt(avg * (10.0 ** (papr_db / 10.0)))
    return jnp.clip(x, -peak, peak)


_dft_mat_cache: dict = {}


def _karatsuba_cmm(pr, pi, qr, qi):
    """Karatsuba 3-matmul complex multiply (25% fewer matmul flops than the
    4-matmul form): re = k1-k2, im = k1+k3 with k1 = pr(qr+qi),
    k2 = (pi+pr)qi, k3 = (pi-pr)qr."""
    k1 = pr @ (qr + qi)
    k2 = (pi + pr) @ qi
    k3 = (pi - pr) @ qr
    return k1 - k2, k1 + k3


def ofdm_mod(carriers: jnp.ndarray, pad_map, nfft: int, ngi: int) -> jnp.ndarray:
    """OFDM symbol modulation, batched over [..., S, Nc] -> [..., S, Nofdm].

    zero-pad carriers into FFT bins (reference zero_padder mapping), apply the
    reference's *unnormalized* IFFT (ofdm.cc:375-376), prepend cyclic prefix.
    """
    pad_map = jnp.asarray(pad_map)
    nc = carriers.shape[-1]
    cdtype = carriers.dtype
    spec = jnp.zeros((*carriers.shape[:-1], nfft), dtype=cdtype)
    spec = spec.at[..., pad_map].set(carriers)
    td = jnp.fft.ifft(spec, axis=-1) * nfft
    return jnp.concatenate([td[..., nfft - ngi:], td], axis=-1).astype(cdtype)


def dft_mm(x: jnp.ndarray, n: int, inverse: bool = False,
           cols=None) -> jnp.ndarray:
    """Direct [.., n] @ [n, n] DFT as one Karatsuba complex-matmul triple —
    the right shape for the per-symbol OFDM (I)FFT (n = Nfft = 256 is one
    matmul-sized contraction; a radix split would only shrink it further). `cols` (host array) selects output bins, folding the
    carrier depad gather into the DFT matrix columns — the demod then reads
    [.., Nofdm] and writes [.., Nc] with nothing in between.

    Matches jnp.fft.fft(x)[..., cols] (or ifft*n with inverse=True, which is
    the reference's unnormalized IFFT — ofdm.cc:375-376)."""
    key = ("dft", n, bool(inverse),
           None if cols is None else tuple(np.asarray(cols).tolist()))
    mats = _dft_mat_cache.get(key)
    if mats is None:
        sgn = 1.0 if inverse else -1.0
        w = np.exp(sgn * 2j * np.pi
                   * np.outer(np.arange(n), np.arange(n)) / n)
        if cols is not None:
            w = w[:, np.asarray(cols)]
        mats = (np.ascontiguousarray(w.real).astype(np.float32),
                np.ascontiguousarray(w.imag).astype(np.float32))
        _dft_mat_cache[key] = mats
    wr, wi = (jnp.asarray(m) for m in mats)
    xr = jnp.real(x).astype(jnp.float32)
    xi = jnp.imag(x).astype(jnp.float32)
    cr, ci = _karatsuba_cmm(xr, xi, wr, wi)
    return jax.lax.complex(cr, ci)


def ofdm_demod(samples: jnp.ndarray, pad_map, nfft: int, ngi: int,
               use_mm: bool | None = None) -> jnp.ndarray:
    """OFDM symbol demodulation [..., S, Nofdm] -> [..., S, Nc]: strip GI,
    1/N-normalized FFT (ofdm.cc:439-442), de-pad carriers.

    use_mm=None auto-selects the fused DFT-matmul (dft_mm with the depad
    fold) on accelerators for f32 grids; CPU and float64 keep jnp.fft
    (bit-stable golden-parity path)."""
    td = samples[..., ngi:ngi + nfft]
    if use_mm is None:
        use_mm = (jax.default_backend() != "cpu"
                  and samples.dtype != jnp.complex128)
    if use_mm:
        return dft_mm(td, nfft, cols=pad_map) / nfft
    pad_map = jnp.asarray(pad_map)
    spec = jnp.fft.fft(td, axis=-1) / nfft
    return spec[..., pad_map]
