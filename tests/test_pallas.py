"""Parity of the accelerator formulations (Toeplitz and DFT matmuls) with
the direct convolution, FFT and prefix-sum references, forced on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mercury_tpu.core.geometry import build_geometry
from mercury_tpu.dsp import ops


@pytest.mark.parametrize("stride", [2, 4])
def test_fir_same_strided_mm(stride):
    """Banded-Toeplitz matmul FIR == direct strided conv."""
    g = build_geometry(0, with_pre_eq=False)
    rng = np.random.default_rng(1)
    x = jnp.asarray((rng.standard_normal((3, 9173))
                     + 1j * rng.standard_normal((3, 9173))).astype(np.complex64))
    taps = jnp.asarray(g.fir_rx_ts.astype(np.float32))
    a = ops.fir_same_strided(x, taps, stride)
    b = ops.fir_same_strided_mm(x, taps, stride)
    assert a.shape == b.shape
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_fir_decimate_mm():
    """Matmul decimating segment FIR == conv fir_decimate_segment."""
    g = build_geometry(0, with_pre_eq=False)
    rng = np.random.default_rng(2)
    seg = jnp.asarray(rng.standard_normal((3, 2311)).astype(np.float32))
    taps = jnp.asarray(g.fir_rx_data.astype(np.float32))
    a = ops.fir_decimate_segment(seg, taps, 4)
    n_out = (seg.shape[-1] - (taps.shape[0] - 1)) // 4
    b = ops.fir_decimate_mm(seg, taps, 4, n_out)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("length", [16, 144, 512])  # 512 > k_blk: gather path
def test_box_sum_valid_mm_parity(length):
    """Banded-matmul sliding box sums == cumsum-difference reference,
    real and complex, including the window-wider-than-block gather branch."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 4000))
         + 1j * rng.standard_normal((2, 4000))).astype(np.complex64)
    n_out = 4000 - length + 1
    for arr in (jnp.asarray(x.real), jnp.asarray(x)):
        a = ops.box_sum_valid(arr, length, n_out, use_mm=False)
        b = ops.box_sum_valid(arr, length, n_out, use_mm=True)
        assert a.shape == b.shape == (2, n_out)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=2e-4 * length)
    # n_out shorter than the buffer allows (rx asks for n_cand exactly)
    short = ops.box_sum_valid(jnp.asarray(x.real), length, 100, use_mm=True)
    np.testing.assert_allclose(
        np.asarray(short),
        np.asarray(ops.box_sum_valid(jnp.asarray(x.real), length, 100,
                                     use_mm=False)), atol=2e-4 * length)
    # strided candidate grid (scan=4 in the rx sync): S[j] = sum at 4j
    dense = ops.box_sum_valid(jnp.asarray(x.real), length, 801, use_mm=False)
    for mm in (False, True):
        strided = ops.box_sum_valid(jnp.asarray(x.real), length, 200,
                                    use_mm=mm, stride=4)
        np.testing.assert_allclose(np.asarray(strided),
                                   np.asarray(dense)[..., ::4][..., :200],
                                   atol=2e-4 * length)


def test_fir_same_strided_mix_mm_parity():
    """Mixer folded into complex FIR taps == explicit mix -> strided FIR."""
    g = build_geometry(0, with_pre_eq=False)
    rng = np.random.default_rng(6)
    pb = jnp.asarray(rng.standard_normal((3, 9173)).astype(np.float32))
    taps = jnp.asarray(g.fir_rx_ts.astype(np.float32))
    w = 2 * np.pi * g.fc / g.fs
    t = np.arange(9173, dtype=np.float64)
    osc = (np.sqrt(2.0) * np.exp(1j * w * t)).astype(np.complex64)
    ref = ops.fir_same_strided(pb * jnp.asarray(osc), taps, 4)
    out = ops.fir_same_strided_mix_mm(pb, taps, 4, w, float(np.sqrt(2.0)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=3e-5, rtol=1e-4)


def test_fir_decimate_mix_mm_parity():
    """Per-row mixer slice folded into complex taps + gathered output
    rotation == explicit osc-multiplied segment FIR."""
    g = build_geometry(0, with_pre_eq=False)
    rng = np.random.default_rng(7)
    seg = jnp.asarray(rng.standard_normal((3, 2311)).astype(np.float32))
    taps_np = g.fir_rx_data.astype(np.float32)
    taps = jnp.asarray(taps_np)
    w = 2 * np.pi * g.fc / g.fs
    n_out = (2311 - (len(taps_np) - 1)) // 4
    starts = np.array([0, 37, 1205], np.int32)      # per-row table offsets
    t = np.arange(4096, dtype=np.float64)
    osc = (np.sqrt(2.0) * np.exp(1j * w * t)).astype(np.complex64)
    osc_seg = jnp.asarray(np.stack([osc[s: s + 2311] for s in starts]))
    ref = ops.fir_decimate_segment(seg * osc_seg, taps, 4)
    idx = starts[:, None] + np.arange(n_out)[None] * 4
    ofac = jnp.asarray(osc[idx])
    out = ops.fir_decimate_mix_mm(seg, taps, 4, n_out, w, ofac)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref[..., :n_out]),
                               atol=3e-5, rtol=1e-4)


def test_ofdm_demod_dft_mm_parity():
    """ofdm_demod's fused DFT-matmul path (dft_mm with the carrier-depad
    fold) == the jnp.fft path, forced on CPU via use_mm."""
    g = build_geometry(9, with_pre_eq=False)
    rng = np.random.default_rng(13)
    sym = (rng.standard_normal((3, g.nsymb, g.nofdm))
           + 1j * rng.standard_normal((3, g.nsymb, g.nofdm))
           ).astype(np.complex64)
    a = ops.ofdm_demod(jnp.asarray(sym), jnp.asarray(g.pad_map),
                       g.nfft, g.ngi, use_mm=False)
    b = ops.ofdm_demod(jnp.asarray(sym), jnp.asarray(g.pad_map),
                       g.nfft, g.ngi, use_mm=True)
    assert a.shape == b.shape == (3, g.nsymb, g.nc)
    np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                               atol=2e-5, rtol=1e-4)


def test_dft_mm_matches_fft_inverse():
    """dft_mm inverse (unnormalized, the reference's IFFT convention) ==
    jnp.fft.ifft * n."""
    rng = np.random.default_rng(14)
    x = (rng.standard_normal((5, 256))
         + 1j * rng.standard_normal((5, 256))).astype(np.complex64)
    got = np.asarray(ops.dft_mm(jnp.asarray(x), 256, inverse=True))
    ref = np.fft.ifft(x, axis=-1) * 256
    np.testing.assert_allclose(got, ref.astype(np.complex64), atol=3e-4)


def test_matched_filter_bank_mm_parity():
    """Banded-matmul MF correlation == FFT correlation: same refined
    delays and near-identical scores for an alias-rotated template bank."""
    from mercury_tpu.modem import sync

    g = build_geometry(0, with_pre_eq=False)
    rng = np.random.default_rng(5)
    lp, s = 4, 136
    bank = (rng.standard_normal((3, lp, s))
            + 1j * rng.standard_normal((3, lp, s))).astype(np.complex64)
    window = 272
    seg_len = 2 * window + lp * s
    seg = (rng.standard_normal((6, seg_len))
           + 1j * rng.standard_normal((6, seg_len))).astype(np.complex64)
    # plant a copy of template row 1 at a known lag so argmax is decisive
    tmpl_cat = bank[1].reshape(-1)
    seg[3, 100: 100 + lp * s] += 6.0 * tmpl_cat
    seg_j = jnp.asarray(seg)
    start = jnp.zeros(6, jnp.int32)
    d_fft, s_fft = sync.matched_filter_refine_bank(seg_j, start, bank, window,
                                                   use_mm=False)
    d_mm, s_mm = sync.matched_filter_refine_bank(seg_j, start, bank, window,
                                                 use_mm=True)
    np.testing.assert_array_equal(np.asarray(d_fft), np.asarray(d_mm))
    np.testing.assert_allclose(np.asarray(s_fft), np.asarray(s_mm),
                               rtol=2e-4, atol=2e-4)
    assert int(np.asarray(d_mm)[3, 1]) == 100


def test_matched_filter_bank_mm_parity_low_snr():
    """The bf16 matmul scores also arbitrate the refined sync delay.
    At near-threshold SNR (template amplitude ~ noise std) the mm path must
    still pick the same lag as the f32 FFT path — a one-step disagreement
    here would shift frame slicing by mf_d samples on the decode path."""
    from mercury_tpu.modem import sync

    rng = np.random.default_rng(11)
    lp, s = 4, 136
    bank = (rng.standard_normal((3, lp, s))
            + 1j * rng.standard_normal((3, lp, s))).astype(np.complex64)
    bank /= np.sqrt(np.mean(np.abs(bank) ** 2))
    window = 272
    seg_len = 2 * window + lp * s
    n_trials = 32
    seg = (rng.standard_normal((n_trials, seg_len))
           + 1j * rng.standard_normal((n_trials, seg_len))).astype(np.complex64)
    lags = rng.integers(0, 2 * window, n_trials)
    tmpl_cat = bank[1].reshape(-1)
    for i in range(n_trials):
        # amplitude 0.55x noise std: post-correlation SNR ~ threshold
        seg[i, lags[i]: lags[i] + lp * s] += 0.55 * tmpl_cat
    seg_j = jnp.asarray(seg)
    start = jnp.zeros(n_trials, jnp.int32)
    d_fft, _ = sync.matched_filter_refine_bank(seg_j, start, bank, window,
                                               use_mm=False)
    d_mm, _ = sync.matched_filter_refine_bank(seg_j, start, bank, window,
                                              use_mm=True)
    np.testing.assert_array_equal(np.asarray(d_fft), np.asarray(d_mm))


@pytest.mark.parametrize("decim", [1, 4])
def test_schmidl_cox_mm_matches_cumsum(decim):
    """schmidl_cox_metric: the matmul box-sum route and the prefix-sum route
    compute the same metric and lag-phase CFO (decim=4 is the rx path,
    decim=1 the obs.py diagnostics path with wide windows)."""
    from mercury_tpu.channel import sim
    from mercury_tpu.modem import sync
    from mercury_tpu.modem.tx import TxChain

    g = build_geometry(0, with_pre_eq=False)
    tx = TxChain(g)
    rng = np.random.default_rng(4)
    payload = rng.integers(0, 256, (1, g.frame_bytes)).astype(np.uint8)
    frames = np.asarray(tx.transmit(payload))
    buf_len = g.nofdm * (g.nsymb + g.preamble_nsymb + 6) * g.interp
    buf = np.asarray(sim.awgn_passband(
        jax.random.key(0), jnp.asarray(frames), sim.sigma_for_esn0(10.0),
        3 * g.nofdm * g.interp, buf_len)).astype(np.float32)
    from mercury_tpu.modem.rx import RxChain
    rx = RxChain(g)
    bb = np.asarray(ops.fir_same(rx.mix(jnp.asarray(buf), 0.0), rx._fir_ts))
    bb = jnp.asarray(bb[..., ::decim])
    met_a, cfo_a = sync.schmidl_cox_metric(bb, g, decim=decim, use_mm=False)
    met_b, cfo_b = sync.schmidl_cox_metric(bb, g, decim=decim, use_mm=True)
    np.testing.assert_allclose(np.asarray(met_a), np.asarray(met_b), atol=5e-3)
    np.testing.assert_allclose(np.asarray(cfo_a), np.asarray(cfo_b), atol=0.05)
    assert (int(jnp.argmax(met_a, -1)[0]) == int(jnp.argmax(met_b, -1)[0]))
