"""Deep-acquisition scans against float64 NumPy references (modem/sync_ref):
the matched-filter score surface on each correlation route, the coherent
CFO max-combine, pilot arbitration, and pooled top-k nomination."""

import jax.numpy as jnp
import numpy as np
import pytest

from mercury_tpu.modem import sync, sync_ref

# float32 correlations of a preamble against noise keep ~1e-5 of the
# normalized scores (which lie in [0, Lp]); 1e-3 also tells f32 operands
# from bf16 ones (~1e-2)
SCORE_ATOL = 1e-3


def _bank(rng, a, lp, s):
    return (rng.standard_normal((a, lp, s))
            + 1j * rng.standard_normal((a, lp, s))).astype(np.complex64)


def _segments(rng, case, bank, window, b=4):
    """Noisy segments with template row 1 planted at a known lag on row 1,
    plus case-specific structure. Returns (seg complex64, planted lag)."""
    a, lp, s = bank.shape
    seg_len = 2 * window + lp * s
    amp = np.sqrt(np.mean(np.abs(bank) ** 2) / 2.0)
    seg = amp * (rng.standard_normal((b, seg_len))
                 + 1j * rng.standard_normal((b, seg_len)))
    lag = window // 3
    seg[1, lag: lag + lp * s] += 3.0 * bank[1].reshape(-1)
    if case == "silence":
        seg[2] = 0.0                       # a whole silent row
        seg[3, : seg_len // 2] = 0.0       # silent first half
    return seg.astype(np.complex64), lag


# "undersized": seg_len = 2**k + 1, so the transform must grow to the next
# power of two to keep every scored lag clear of the circular wrap
CASES = {"planted": (3, 4, 48, 150), "silence": (2, 4, 40, 120),
         "undersized": (2, 3, 41, 67)}
ROUTES = {"fft": dict(use_mm=False),
          "toeplitz_f32": dict(use_mm=True, mm_dtype=jnp.float32)}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_bank_scores_match_float64(route, case):
    a, lp, s, window = CASES[case]
    rng = np.random.default_rng(len(case) + 7 * len(route))
    bank = _bank(rng, a, lp, s)
    seg, lag = _segments(rng, case, bank, window)
    if case == "undersized":
        assert seg.shape[-1] == 257
    got = np.asarray(sync.bank_scores(jnp.asarray(seg), bank, window,
                                      **ROUTES[route]))
    ref = sync_ref.bank_scores(seg, bank, window)
    assert got.shape == ref.shape == (seg.shape[0], a, 2 * window + 1)
    np.testing.assert_allclose(got, ref, atol=SCORE_ATOL, rtol=0)
    assert int(got[1, 1].argmax()) == lag
    if case == "silence":
        assert not got[2].any()                      # guard, not 0/0
        n_silent = seg.shape[-1] // 2 - lp * s + 1   # lags fully silent
        assert not got[3, :, :n_silent].any()


@pytest.mark.parametrize("case", ["planted", "silence"])
def test_coherent_scan_max_matches_float64(case):
    """The CFO max-combine of the coherent scan: max score and its bank row
    per lag, against the float64 surface (single-symbol bank, as rx uses)."""
    rng = np.random.default_rng(31)
    base = _bank(rng, 1, 1, 96)[0, 0]
    t = np.arange(96)
    bank = np.stack([base * np.exp(-2j * np.pi * f * 1e-3 * t)
                     for f in range(-4, 5)])[:, None].astype(np.complex64)
    window = 200
    seg, lag = _segments(rng, case, bank, window)
    smax, sarg = sync.coherent_scan_max(jnp.asarray(seg), bank, window)
    ref = sync_ref.bank_scores(seg, bank, window)
    np.testing.assert_allclose(np.asarray(smax), ref.max(axis=1),
                               atol=SCORE_ATOL, rtol=0)
    assert np.asarray(sarg).dtype == np.int32
    # where the best row leads the runner-up clearly, the argmax must agree
    top2 = np.sort(ref, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 10 * SCORE_ATOL
    assert (np.asarray(sarg)[clear] == ref.argmax(axis=1)[clear]).all()
    assert int(np.asarray(smax)[1].argmax()) == lag
    assert int(np.asarray(sarg)[1, lag]) == 1


def test_refine_bank_nominates_planted_lag():
    """matched_filter_refine_bank: per-row argmax delays on the FFT route
    equal the float64 argmax, offset by each row's start."""
    rng = np.random.default_rng(41)
    bank = _bank(rng, 3, 4, 48)
    seg, lag = _segments(rng, "planted", bank, 150)
    start = jnp.asarray([0, 100, 200, 300], jnp.int32)
    delay, score = sync.matched_filter_refine_bank(
        jnp.asarray(seg), start, bank, 150, use_mm=False)
    ref = sync_ref.bank_scores(seg, bank, 150)
    np.testing.assert_array_equal(np.asarray(delay),
                                  ref.argmax(-1) + np.asarray(start)[:, None])
    np.testing.assert_allclose(np.asarray(score), ref.max(-1) / 4,
                               atol=SCORE_ATOL / 4, rtol=0)
    assert int(np.asarray(delay)[1, 1]) == 100 + lag


def _pilot_case(rng, silent: bool):
    b, m, f_n, nsym, s_d = 3, 7, 5, 4, 64
    mf_s, ts_dec, pre_span = 2, 4, 48
    n_ts = 4000
    bb = (rng.standard_normal((b, n_ts))
          + 1j * rng.standard_normal((b, n_ts))).astype(np.complex64)
    if silent:
        bb[1] = 0.0
    cand = (rng.integers(0, 150, (b, m)) * (mf_s * ts_dec)).astype(np.int32)
    cand[0, 0] = -10 * mf_s * ts_dec               # clamps at the start
    cand[0, 1] = n_ts * ts_dec                     # clamps at the end
    fidx = rng.integers(0, f_n, (b, m)).astype(np.int32)
    base = (rng.standard_normal((nsym, s_d))
            + 1j * rng.standard_normal((nsym, s_d))).astype(np.complex64)
    t = np.arange(s_d)
    bank = np.stack([base * np.exp(-2j * np.pi * f * 1e-3 * t)[None]
                     for f in range(f_n)]).astype(np.complex64)
    # plant candidate (2, 3)'s pilot symbols at its own start
    st = (int(cand[2, 3]) + pre_span) // (ts_dec * mf_s)
    dec = bb[2, ::mf_s].copy()
    dec[st: st + nsym * s_d] += 4.0 * bank[fidx[2, 3]].reshape(-1)
    bb[2, ::mf_s] = dec
    return bb, cand, fidx, bank, mf_s, ts_dec, pre_span


@pytest.mark.parametrize("silent", [False, True])
def test_pilot_rescore_matches_float64(silent):
    rng = np.random.default_rng(53)
    bb, cand, fidx, bank, mf_s, ts_dec, pre = _pilot_case(rng, silent)
    got = np.asarray(sync.pilot_rescore(jnp.asarray(bb), jnp.asarray(cand),
                                        jnp.asarray(fidx), bank, mf_s, ts_dec,
                                        pre))
    ref = sync_ref.pilot_rescore(bb, cand, fidx, bank, mf_s, ts_dec, pre)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    assert int(got[2].argmax()) == 3                # the planted candidate
    if silent:
        assert not got[1].any()                     # silence guard: zeros


def _topk_ref(score, topn, pool_w):
    n = score.shape[-1]
    n_pool = -(-n // pool_w)
    pad = np.full(score.shape[:-1] + (n_pool * pool_w - n,), -np.inf)
    sp = np.concatenate([score, pad], -1).reshape(*score.shape[:-1], n_pool,
                                                   pool_w)
    pooled, inner = sp.max(-1), sp.argmax(-1)
    k = min(topn, n_pool)
    order = np.argsort(-pooled, axis=-1, kind="stable")[..., :k]
    off = order * pool_w + np.take_along_axis(inner, order, -1)
    return off, np.take_along_axis(pooled, order, -1)


@pytest.mark.parametrize("shape,topn,pool_w", [((4, 64), 5, 8),
                                               ((3, 61), 4, 8),
                                               ((2, 3, 50), 6, 4),
                                               ((2, 20), 9, 8)])
def test_topk_pooled_exact(shape, topn, pool_w):
    """topk_pooled is exact (no approximate nomination): the N best pooled
    peaks, their offsets from each row's start, on every backend."""
    rng = np.random.default_rng(sum(shape) + topn)
    score = rng.permutation(int(np.prod(shape))).reshape(shape).astype(
        np.float32)                                  # distinct values
    start = np.arange(shape[0], dtype=np.int32) * 1000
    off, val = sync.topk_pooled(jnp.asarray(score), jnp.asarray(start),
                                topn, pool_w)
    ref_off, ref_val = _topk_ref(score, topn, pool_w)
    st = start.reshape((-1,) + (1,) * (score.ndim - 1))
    np.testing.assert_array_equal(np.asarray(off), ref_off + st)
    np.testing.assert_array_equal(np.asarray(val), ref_val)
