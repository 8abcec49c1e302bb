"""Flowgraph blocks: the GNU Radio out-of-tree module's stand-in.

The reference ships `tests/gr-hermes_ofdm/` — its OFDM primitives
(zero_padder/depadder, gi_adder/remover, framer/deframer) wrapped as GNU
Radio blocks so channel experiments can be composed as flowgraphs
(OFDM_test.grc, Mercury_channel_test.grc). Here the same primitives are
already pure jit-able functions (`dsp/ops.py`, `core/geometry.py`), so the
flowgraph surface is a thin composition layer: Block objects with
`work(x) -> y`, chained by `Flowgraph`, each block mirroring the modem's
geometry-parameterized primitives (same pad maps, GI sizes and FFT
conventions, drawn from the ModeGeometry) in plain numpy so a notebook
flowgraph needs no device.

    python examples/flowgraph.py     # OFDM symbol chain through AWGN:
                                     # mod -> GI -> channel -> GI-strip ->
                                     # demod -> EVM report

Use it from a notebook to splice channel models (sim.watterson,
sim.awgn_passband, custom impairments) between any two stages — the
experiment the reference needed GNU Radio for.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


class Block:
    """One flowgraph stage: fn(x, **params) with a display name."""

    def __init__(self, name, fn, **params):
        self.name = name
        self.fn = fn
        self.params = params

    def work(self, x):
        return self.fn(x, **self.params)


class Flowgraph:
    def __init__(self, *blocks: Block):
        self.blocks = list(blocks)
        self.taps: dict[str, np.ndarray] = {}

    def connect(self, block: Block) -> "Flowgraph":
        self.blocks.append(block)
        return self

    def run(self, x):
        """Push one buffer through every stage, recording a tap per block
        (the flowgraph scope probe)."""
        for b in self.blocks:
            x = b.work(x)
            self.taps[b.name] = np.asarray(x)
        return x


# ---------------------------------------------------------------------------
# block library: the gr-hermes_ofdm set, bound to the modem's own tensor ops

def make_blocks(geom):
    """Blocks over one mode geometry: the reference OOT module's block set
    (gr-hermes_ofdm/lib/*.cc) parameterized by the modem's ModeGeometry."""
    pad_map = np.asarray(geom.pad_map)

    def zero_padder(carriers):                 # [..., S, Nc] -> [..., S, Nfft]
        spec = np.zeros((*carriers.shape[:-1], geom.nfft), complex)
        spec[..., pad_map] = carriers
        return spec

    def zero_depadder(spec):
        return spec[..., pad_map]

    def ifft_block(spec):                      # reference unnormalized IFFT
        return np.fft.ifft(spec, axis=-1) * geom.nfft

    def fft_block(td):                         # reference 1/N FFT
        return np.fft.fft(td, axis=-1) / geom.nfft

    def gi_adder(td):                          # [..., S, Nfft] -> [..., S, Nofdm]
        return np.concatenate([td[..., geom.nfft - geom.ngi:], td], axis=-1)

    def gi_remover(sym):
        return sym[..., geom.ngi: geom.ngi + geom.nfft]

    def framer(samples):                       # serialize symbols
        return samples.reshape(*samples.shape[:-2], -1)

    def deframer(stream):
        return stream.reshape(*stream.shape[:-1], -1, geom.nofdm)

    def awgn(x, snr_db=20.0, seed=0):
        rng = np.random.default_rng(seed)
        p = np.mean(np.abs(x) ** 2)
        sigma = np.sqrt(p / 10 ** (snr_db / 10) / 2)
        return x + sigma * (rng.standard_normal(x.shape)
                            + 1j * rng.standard_normal(x.shape))

    return {
        "zero_padder": Block("zero_padder", zero_padder),
        "zero_depadder": Block("zero_depadder", zero_depadder),
        "ifft": Block("ifft", ifft_block),
        "fft": Block("fft", fft_block),
        "gi_adder": Block("gi_adder", gi_adder),
        "gi_remover": Block("gi_remover", gi_remover),
        "framer": Block("framer", framer),
        "deframer": Block("deframer", deframer),
        "awgn": lambda snr, seed=0: Block("awgn", awgn, snr_db=snr,
                                          seed=seed),
    }


def main() -> int:
    from mercury_tpu.core.geometry import build_geometry

    g = build_geometry(9, with_pre_eq=False)
    blocks = make_blocks(g)
    rng = np.random.default_rng(1)
    qpsk = (rng.choice([-1, 1], (g.nsymb, g.nc))
            + 1j * rng.choice([-1, 1], (g.nsymb, g.nc))) / np.sqrt(2)

    fg = Flowgraph(
        blocks["zero_padder"], blocks["ifft"], blocks["gi_adder"],
        blocks["framer"],
        blocks["awgn"](25.0),
        blocks["deframer"], blocks["gi_remover"], blocks["fft"],
        blocks["zero_depadder"],
    )
    out = fg.run(qpsk)
    evm = np.sqrt(np.mean(np.abs(out - qpsk) ** 2))
    print(f"OFDM flowgraph: {len(fg.blocks)} blocks, "
          f"{qpsk.size} carriers round-tripped, EVM {20*np.log10(evm):.1f} dB")
    for name, tap in fg.taps.items():
        print(f"  tap {name:<14} {tap.shape} {tap.dtype}")
    assert evm < 0.1
    return 0


if __name__ == "__main__":
    sys.exit(main())
