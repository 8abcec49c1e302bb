"""FEC parity tests: LDPC encode bit-exactness per rate, SPA decode
correction behaviour, interleaver/dispersal round trips."""

import jax.numpy as jnp
import numpy as np
import pytest

from mercury_tpu.core.geometry import build_geometry, interleaver_perm
from mercury_tpu.fec import ldpc
from mercury_tpu.fec.tables import load_code

CFG_RATE = {0: 1, 1: 2, 2: 3, 3: 4, 4: 5, 5: 6, 6: 8, 9: 8, 12: 14, 15: 14}


@pytest.mark.parametrize("cfg,rate", sorted(CFG_RATE.items()))
def test_ldpc_encode_bit_exact(golden, cfg, rate):
    code = load_code(rate)
    bits_in = golden(f"cfg{cfg}_ldpc_in")
    enc_ref = golden(f"cfg{cfg}_ldpc_enc")
    enc = ldpc.encode(code, jnp.asarray(bits_in)[None])[0]
    assert (np.asarray(enc) == enc_ref).all()


@pytest.mark.parametrize("rate", [1, 4, 8, 14])
def test_spa_decode_corrects_noise(rate):
    code = load_code(rate)
    rng = np.random.default_rng(7)
    u = rng.integers(0, 2, (8, code.k))
    cw = np.asarray(ldpc.encode(code, jnp.asarray(u)))
    # noise level scaled per rate: low-rate codes tolerate much more
    sigma = {1: 1.5, 4: 1.0, 8: 0.75, 14: 0.45}[rate]
    y = (1 - 2 * cw) + sigma * rng.standard_normal(cw.shape)
    llr = (2 / sigma ** 2 * y).astype(np.float32)
    bits, iters, ok = ldpc.decode(jnp.asarray(llr), rate)
    assert np.asarray(ok).all()
    assert (np.asarray(bits)[:, :code.k] == u).all()


@pytest.mark.parametrize("rate", [1, 4, 8, 14])
def test_minsum_decode_corrects_noise(rate):
    """Offset min-sum corrects the same noise levels the SPA test uses."""
    code = load_code(rate)
    rng = np.random.default_rng(7)
    u = rng.integers(0, 2, (8, code.k))
    cw = np.asarray(ldpc.encode(code, jnp.asarray(u)))
    sigma = {1: 1.5, 4: 1.0, 8: 0.75, 14: 0.45}[rate]
    y = (1 - 2 * cw) + sigma * rng.standard_normal(cw.shape)
    llr = (2 / sigma ** 2 * y).astype(np.float32)
    bits, iters, ok = ldpc.decode(jnp.asarray(llr), rate, algo="minsum")
    assert np.asarray(ok).all()
    assert (np.asarray(bits)[:, :code.k] == u).all()


def test_minsum_ber_close_to_spa():
    """At a near-threshold noise level, offset min-sum frame errors stay
    within ~2x of SPA (the documented ~0.1-0.2 dB penalty), on the same
    noise realizations."""
    code = load_code(8)
    rng = np.random.default_rng(11)
    b = 64
    u = rng.integers(0, 2, (b, code.k))
    cw = np.asarray(ldpc.encode(code, jnp.asarray(u)))
    sigma = 0.87
    y = (1 - 2 * cw) + sigma * rng.standard_normal(cw.shape)
    llr = (2 / sigma ** 2 * y).astype(np.float32)
    bits_s, _i, _ok = ldpc.decode(jnp.asarray(llr), 8)
    bits_m, _i, _ok = ldpc.decode(jnp.asarray(llr), 8, algo="minsum")
    fe_spa = int(((np.asarray(bits_s)[:, :code.k] != u).sum(-1) > 0).sum())
    fe_ms = int(((np.asarray(bits_m)[:, :code.k] != u).sum(-1) > 0).sum())
    assert 0 < fe_spa < b          # the point is genuinely near threshold
    assert fe_ms <= max(2 * fe_spa, fe_spa + 4)


def test_spa_decode_clean_zero_iters():
    code = load_code(1)
    u = np.ones((2, code.k), dtype=np.int64)
    cw = np.asarray(ldpc.encode(code, jnp.asarray(u)))
    llr = (1 - 2 * cw).astype(np.float32) * 10
    _bits, iters, ok = ldpc.decode(jnp.asarray(llr), 1)
    assert np.asarray(ok).all() and (np.asarray(iters) == 0).all()


def test_interleaver_roundtrip():
    g = build_geometry(0, with_pre_eq=False)
    x = np.arange(g.n_bits)
    inter = x[g.bit_perm]
    deinter = inter[g.bit_iperm]
    assert (deinter == x).all()
    # reference semantics: out[j*nBlocks+i] = in[i*block+j]
    block = g.bit_block
    nblocks = g.n_bits // block
    ref = np.empty_like(x)
    for i in range(nblocks):
        for j in range(block):
            ref[j * nblocks + i] = x[i * block + j]
    ref[nblocks * block:] = x[nblocks * block:]
    assert (inter == ref).all()


ALL_RATES = [1, 2, 3, 4, 5, 6, 8, 14]


def _threshold_llrs(rate, b=8, seed=7):
    """Encode random payloads and add per-rate near-capacity noise."""
    import jax.numpy as jnp

    code = load_code(rate)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (b, code.k))
    cw = np.asarray(ldpc.encode(code, jnp.asarray(u)))
    sigma = {1: 1.5, 2: 1.3, 3: 1.2, 4: 1.0, 5: 0.95, 6: 0.9,
             8: 0.75, 14: 0.45}[rate]
    y = (1 - 2 * cw) + sigma * rng.standard_normal(cw.shape)
    llr = jnp.asarray((2 / sigma ** 2 * y).astype(np.float32))
    return u, llr, code


@pytest.mark.parametrize("rate", ALL_RATES)
def test_mm_flooding_bit_parity(rate):
    """decode_mm with n_layers=1 and exact f32 matmuls IS the flooding
    schedule: hard decisions, iteration counts and convergence flags must be
    bit-identical to `decode` at every rate (the one-hot incidence matmul is
    an exact selection in f32)."""
    import jax.numpy as jnp

    _u, llr, _code = _threshold_llrs(rate)
    b_f, i_f, ok_f = ldpc.decode(llr, rate)
    b_m, i_m, ok_m = ldpc.decode_mm(llr, rate, n_layers=1,
                                    mm_dtype=jnp.float32)
    assert (np.asarray(b_f) == np.asarray(b_m)).all()
    assert (np.asarray(i_f) == np.asarray(i_m)).all()
    assert (np.asarray(ok_f) == np.asarray(ok_m)).all()


def test_mm_flooding_bit_parity_minsum():
    """Same flooding equivalence for the min-sum check update."""
    import jax.numpy as jnp

    _u, llr, _code = _threshold_llrs(8)
    b_f, i_f, ok_f = ldpc.decode(llr, 8, algo="minsum")
    b_m, i_m, ok_m = ldpc.decode_mm(llr, 8, algo="minsum", n_layers=1,
                                    mm_dtype=jnp.float32)
    assert (np.asarray(b_f) == np.asarray(b_m)).all()
    assert (np.asarray(i_f) == np.asarray(i_m)).all()
    assert (np.asarray(ok_f) == np.asarray(ok_m)).all()


@pytest.mark.parametrize("rate", ALL_RATES)
def test_mm_layered_corrects_and_converges_faster(rate):
    """The layered (variable-disjoint) schedule corrects the same noise the
    flooding tests use, in no more sweeps on average — the point of the
    schedule is ~2x fewer sweeps at threshold."""
    import jax.numpy as jnp

    u, llr, code = _threshold_llrs(rate)
    b_l, i_l, ok_l = ldpc.decode_mm(llr, rate, mm_dtype=jnp.float32)
    assert np.asarray(ok_l).all()
    assert (np.asarray(b_l)[:, :code.k] == u).all()
    _bf, i_f, _okf = ldpc.decode(llr, rate)
    assert np.asarray(i_l).mean() <= np.asarray(i_f).mean()


def test_mm_grouped_shuffled_corrects():
    """n_layers below the disjoint bound = grouped-shuffled BP: intra-layer
    conflicts only slow convergence, never break correctness."""
    import jax.numpy as jnp

    u, llr, code = _threshold_llrs(8)
    assert ldpc._default_layers(8) > 4     # 4 really is below the bound
    b_g, _i, ok_g = ldpc.decode_mm(llr, 8, n_layers=4, mm_dtype=jnp.float32)
    assert np.asarray(ok_g).all()
    assert (np.asarray(b_g)[:, :code.k] == u).all()


def test_mm_bf16_matmul_ber_close():
    """bf16 matmul operands (the production dtype: one-hot side exact, data
    side rounded per sweep) stay within ~2x of f32 layered frame errors at a
    near-threshold noise level, on the same noise realizations, and decode
    bit-exactly at a comfortable SNR."""
    import jax.numpy as jnp

    code = load_code(8)
    rng = np.random.default_rng(13)
    b = 64
    u = rng.integers(0, 2, (b, code.k))
    cw = np.asarray(ldpc.encode(code, jnp.asarray(u)))
    sigma = 0.87
    y = (1 - 2 * cw) + sigma * rng.standard_normal(cw.shape)
    llr = jnp.asarray((2 / sigma ** 2 * y).astype(np.float32))
    _b32, _i, ok32 = ldpc.decode_mm(llr, 8, mm_dtype=jnp.float32)
    _b16, _i, ok16 = ldpc.decode_mm(llr, 8, mm_dtype=jnp.bfloat16)
    fe32 = int((~np.asarray(ok32)).sum())
    fe16 = int((~np.asarray(ok16)).sum())
    assert fe16 <= max(2 * fe32, fe32 + 3), (fe32, fe16)
    y2 = (1 - 2 * cw) + 0.6 * rng.standard_normal(cw.shape)
    llr2 = jnp.asarray((2 / 0.36 * y2).astype(np.float32))
    bits, _i, ok = ldpc.decode_mm(llr2, 8)
    assert np.asarray(ok).all()
    assert (np.asarray(bits)[:, :code.k] == u).all()


def test_mm_layer_plan_covers_every_check_once():
    """The layer partition is a true partition: every check appears in
    exactly one layer and the padded incidence rows are all-zero."""
    for rate in (1, 8, 14):
        code = load_code(rate)
        plan = ldpc._layer_plan(rate, None)
        seen = []
        for l in range(plan.n_layers):
            for r in range(plan.pl):
                row = plan.c_idx[l, r]
                if (row >= 0).any():
                    seen.append(tuple(sorted(int(v) for v in row if v >= 0)))
        ref = [tuple(sorted(int(v) for v in row if v >= 0))
               for row in code.c_idx]
        assert sorted(seen) == sorted(ref)
        # disjointness within each layer (the default plan guarantees it)
        for l in range(plan.n_layers):
            vs: set = set()
            for r in range(plan.pl):
                row = set(int(v) for v in plan.c_idx[l, r] if v >= 0)
                assert not (row & vs)
                vs |= row


def test_bf16_messages_ber_close():
    """bf16 message storage (the memory-bandwidth option) stays within ~2x of
    f32 min-sum frame errors at a near-threshold noise level, on the same
    noise realizations."""
    import jax.numpy as jnp

    code = load_code(8)
    rng = np.random.default_rng(13)
    b = 64
    u = rng.integers(0, 2, (b, code.k))
    cw = np.asarray(ldpc.encode(code, jnp.asarray(u)))
    sigma = 0.87
    y = (1 - 2 * cw) + sigma * rng.standard_normal(cw.shape)
    llr = (2 / sigma ** 2 * y).astype(np.float32)
    _b32, _i, ok32 = ldpc.decode(jnp.asarray(llr), 8, algo="minsum")
    _b16, _i, ok16 = ldpc.decode(jnp.asarray(llr), 8, algo="minsum",
                                 msg_dtype=jnp.bfloat16)
    fe32 = int((~np.asarray(ok32)).sum())
    fe16 = int((~np.asarray(ok16)).sum())
    assert fe16 <= max(2 * fe32, fe32 + 3), (fe32, fe16)
    # and at a comfortable SNR it corrects everything, bit-exactly
    y2 = (1 - 2 * cw) + 0.6 * rng.standard_normal(cw.shape)
    llr2 = (2 / 0.36 * y2).astype(np.float32)
    bits, _i, ok = ldpc.decode(jnp.asarray(llr2), 8, algo="minsum",
                               msg_dtype=jnp.bfloat16)
    assert np.asarray(ok).all()
    assert (np.asarray(bits)[:, :code.k] == u).all()
