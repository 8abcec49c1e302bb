#!/usr/bin/env python
"""Convert the reference LDPC adjacency tables (dumped by tools/golden_gen as
raw binary) into mercury_tpu/data/ldpc_tables.npz, and derive the dense GF(2)
generator blocks used by the matmul encoder.

Provenance: the adjacency data originates from the reference's
source/physical_layer/mercury_normal_*.cc constant tables (IRA LDPC, N=1600).
These are *code definitions* — interoperability requires the identical parity
check matrices. Only the data is extracted; no source is copied.

Derived here:
  - V_pos [P, Cw]: for edge (check i, slot c) with variable v=C[i,c], the slot
    k such that V[v,k] == i (reference: ldpc_decoder_SPA.cc:81-104).
  - var_degree [N]: from the d run-length table.
  - G [P, K] uint8: parity = G @ info mod 2, derived by running the reference
    back-substitution encoder (ldpc.cc:111-132) over unit vectors via its
    linearity: p = cum-structure applied to A u.
"""

import json
import sys

import numpy as np

GOLDEN = "tests/golden"
RATES = ["1_16", "2_16", "3_16", "4_16", "5_16", "6_16", "8_16", "14_16"]
N = 1600


def load(meta, k):
    info = meta[k]
    return np.fromfile(f"{GOLDEN}/{k}.bin", dtype=np.int32).reshape(info["shape"])


def encode_ref(enc, K, P, u):
    """Reference back-substitution encoder (ldpc.cc:111-132), vectorized over
    batch axis of u [B, K]. Sequential over parities."""
    B = u.shape[0]
    x = np.zeros((B, K + P), dtype=np.uint8)
    x[:, :K] = u
    for i in range(P):
        acc = np.zeros(B, dtype=np.uint8)
        for j in enc[i]:
            if j != -1:
                acc ^= x[:, j]
        x[:, K + i] = acc
    return x


def main():
    meta = json.load(open(f"{GOLDEN}/meta.json"))
    out = {}
    for tag in RATES:
        dims = load(meta, f"ldpc_{tag}_dims")
        cw, vw, dw, K = (int(v) for v in dims)
        P = N - K
        C = load(meta, f"ldpc_{tag}_C")
        V = load(meta, f"ldpc_{tag}_V")
        Enc = load(meta, f"ldpc_{tag}_Enc")
        d = load(meta, f"ldpc_{tag}_d")
        assert C.shape == (P, cw) and V.shape == (N, vw)

        # variable degrees from the run-length table (pairs: count, degree)
        var_degree = np.zeros(N, dtype=np.int32)
        pos = 0
        for s in range(0, dw, 2):
            var_degree[pos:pos + d[s]] = d[s + 1]
            pos += d[s]
        assert pos == N, (tag, pos)
        # degree table must agree with the V adjacency occupancy
        v_occupancy = (V != -1).sum(axis=1)
        assert (v_occupancy == var_degree).all(), f"{tag}: d table vs V mismatch"

        # V_pos: position of check i inside V[v]
        v_pos = np.full((P, cw), -1, dtype=np.int32)
        for i in range(P):
            for c in range(cw):
                v = C[i, c]
                if v == -1:
                    continue
                k = np.nonzero(V[v] == i)[0]
                assert len(k) == 1
                v_pos[i, c] = k[0]

        # dense generator block: parity rows of encoding of unit info vectors
        u = np.eye(K, dtype=np.uint8)
        x = encode_ref(Enc, K, P, u)
        G = x[:, K:].T.copy()  # [P, K]
        # spot-check against a random info word
        rng = np.random.default_rng(0)
        w = rng.integers(0, 2, size=(1, K)).astype(np.uint8)
        ref = encode_ref(Enc, K, P, w)[0, K:]
        fast = (G @ w[0]) % 2
        assert (ref == fast).all(), f"{tag}: generator mismatch"

        out[f"{tag}_C"] = C
        out[f"{tag}_V"] = V
        out[f"{tag}_Vpos"] = v_pos
        out[f"{tag}_G"] = G.astype(np.uint8)
        out[f"{tag}_deg"] = var_degree
        out[f"{tag}_K"] = np.int32(K)
        print(f"{tag}: K={K} P={P} Cw={cw} Vw={vw} edges={int((C!=-1).sum())}")

    np.savez_compressed("mercury_tpu/data/ldpc_tables.npz", **out)
    print("wrote mercury_tpu/data/ldpc_tables.npz")


if __name__ == "__main__":
    sys.exit(main())
