"""Terminal dashboard — the headless stand-in for the reference's ImGui GUI.

Renders the same live feeds the GUI shows (gui_main.cc RenderGUI: waterfall
with jet colormap, constellation scatter, VU meters, SNR/CFO/throughput
readouts, TX/RX state) as ANSI text, so a modem running over SSH on a GPU
host has the reference's visual feedback without a display stack.

All render functions are pure string builders (testable without a tty);
`Dashboard.frame()` composes one full screen.
"""

from __future__ import annotations

import numpy as np

# 256-color approximation of the GUI's jet colormap (waterfall.cc:106-254)
_JET_256 = [17, 18, 19, 20, 21, 27, 33, 39, 45, 51, 50, 49, 48, 47, 46,
            82, 118, 154, 190, 226, 220, 214, 208, 202, 196]


def _jet(frac: float) -> int:
    i = int(np.clip(frac, 0.0, 1.0) * (len(_JET_256) - 1))
    return _JET_256[i]


def render_waterfall(spec_db: np.ndarray, width: int = 64, height: int = 12,
                     dyn_range_db: float = 60.0, color: bool = True) -> list[str]:
    """Spectrogram rows (from obs.waterfall) -> ANSI lines, newest last.
    spec_db: [frames, bins]."""
    if spec_db.size == 0:
        return [" " * width] * height
    rows = spec_db[-height:]
    if rows.shape[0] < height:
        pad = np.full((height - rows.shape[0], rows.shape[1]), -200.0)
        rows = np.concatenate([pad, rows], axis=0)
    # resample bins to width columns
    idx = np.linspace(0, rows.shape[1] - 1, width).astype(int)
    rows = rows[:, idx]
    # keep the top pinned above the numeric silence floor so an all-quiet
    # window renders dark instead of saturating the colormap
    top = max(float(np.max(rows)), -90.0)
    lo = top - dyn_range_db
    out = []
    blocks = " .:-=+*#%@"
    for r in rows:
        frac = np.clip((r - lo) / max(dyn_range_db, 1e-9), 0, 1)
        if color:
            line = "".join(f"\x1b[48;5;{_jet(f)}m " for f in frac) + "\x1b[0m"
        else:
            line = "".join(blocks[int(f * (len(blocks) - 1))] for f in frac)
        out.append(line)
    return out


def render_constellation(points: np.ndarray, size: int = 17,
                         span: float = 1.6) -> list[str]:
    """Equalized symbols -> ASCII scatter (GUI constellation panel)."""
    grid = [[" "] * size for _ in range(size)]
    mid = size // 2
    for p in np.asarray(points).ravel()[:2000]:
        x = int(round(mid + p.real / span * mid))
        y = int(round(mid - p.imag / span * mid))
        if 0 <= x < size and 0 <= y < size:
            c = grid[y][x]
            grid[y][x] = "." if c == " " else ("o" if c == "." else "@")
    axis = set([mid])
    out = []
    for y, row in enumerate(grid):
        line = "".join("+" if (y in axis and x in axis)
                       else ("|" if x in axis and row[x] == " "
                             else ("-" if y in axis and row[x] == " "
                                   else row[x]))
                       for x in range(size))
        out.append(line)
    return out


def render_vu(level_dbfs: float, width: int = 30,
              floor_db: float = -60.0) -> str:
    """VU bar (GUI VU meters): -60 dBFS .. 0 dBFS."""
    frac = float(np.clip((level_dbfs - floor_db) / -floor_db, 0, 1))
    n = int(round(frac * width))
    bar = "#" * n + "-" * (width - n)
    return f"[{bar}] {level_dbfs:6.1f} dBFS"


def level_dbfs(samples: np.ndarray) -> float:
    rms = float(np.sqrt(np.mean(np.square(np.asarray(samples, np.float64)))) + 1e-12)
    return 20 * np.log10(rms)


class Dashboard:
    """Composes one dashboard frame from modem state + recent samples."""

    def __init__(self, width: int = 64, color: bool = True):
        self.width = width
        self.color = color
        self._spec = np.zeros((0, 257))

    def update_samples(self, samples: np.ndarray, fs: float = 48000.0) -> None:
        from mercury_tpu.obs import waterfall
        spec, _ = waterfall(samples, fs)
        if len(spec):
            self._spec = np.concatenate([self._spec, spec])[-200:] \
                if self._spec.size else spec

    def frame(self, state: dict | None = None,
              constellation: np.ndarray | None = None) -> str:
        """state keys (all optional): link_status, config, snr_db, cfo_hz,
        signal_dbm, noise_floor_dbm, buffer_tx, throughput_bps,
        rx_level_dbfs, tx_level_dbfs, ptt."""
        s = state or {}
        lines = []
        hdr = (f" mercury-tpu  cfg={s.get('config', '-'):>3}  "
               f"link={s.get('link_status', '-'):<12} "
               f"{'PTT' if s.get('ptt') else '   '}")
        lines.append(hdr)
        lines.append(f" SNR {s.get('snr_db', float('nan')):6.1f} dB   "
                     f"CFO {s.get('cfo_hz', float('nan')):+7.2f} Hz   "
                     f"buf {s.get('buffer_tx', 0):>6} B   "
                     f"{s.get('throughput_bps', 0.0):7.1f} bps")
        if "signal_dbm" in s:
            nf = s.get("noise_floor_dbm")
            nf_s = f"{nf:6.1f} dBm" if nf is not None else "   --    "
            lines.append(f" SIG {s['signal_dbm']:6.1f} dBm  noise floor "
                         f"{nf_s}" + (
                             f"  (S/N {s['signal_dbm'] - nf:+5.1f} dB)"
                             if nf is not None else ""))
        if "rx_level_dbfs" in s:
            lines.append(" RX " + render_vu(s["rx_level_dbfs"]))
        if "tx_level_dbfs" in s:
            lines.append(" TX " + render_vu(s["tx_level_dbfs"]))
        lines.append(" waterfall " + "-" * (self.width - 11))
        lines.extend(render_waterfall(self._spec, self.width, 12,
                                      color=self.color))
        if constellation is not None and len(np.atleast_1d(constellation)):
            lines.append(" constellation")
            lines.extend(render_constellation(constellation))
        return "\n".join(lines)

    def clear_screen(self) -> str:
        return "\x1b[2J\x1b[H"
