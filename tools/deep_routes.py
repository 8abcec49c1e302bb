#!/usr/bin/env python
"""Time the deep-acquisition scan routes end to end on the accelerator.

For CONFIG_0 (coherent scan + pilot arbitration) and CONFIG_3 (noncoherent
scan) at a deployment batch, each candidate formulation of the scan is
swapped into RxChain.receive, compiled, timed end to end (calls alternate
between the candidates, A B B A ...), and traced: the profiler trace gives
each named stage's device time per call (the `noncoherent_scan`,
`coherent_scan` and `pilot_arbitration` scopes of modem/rx.py).

    python tools/deep_routes.py [--batch 256] [--rounds 4] [--out FILE]

Candidates (the first of each is the route the library uses):
  CONFIG_0 coherent scan: float32 FFT correlation (jnp.fft: cuFFT on the
    GPU), and the float32 banded-Toeplitz matmul at HIGHEST and at default
    precision
  CONFIG_3 noncoherent scan: float32 FFT correlation (one route left: the
    matmul FFT it was measured against is removed, see PERF.md)
Pilot arbitration has one XLA route and is read from the CONFIG_0 traces.
End-to-end times use the default compiler flags; the traced executables are
compiled without CUDA-graph command buffers so that every kernel shows.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import glob
import json
import os
import re
import shutil
import sys
import tempfile
import time
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

STAGES = ("noncoherent_scan", "coherent_scan", "pilot_arbitration")


# ---------------------------------------------------------------- routes
def _coherent(precision: str | None, **route):
    """coherent_scan_max on one correlation route (bank_scores keywords),
    optionally under a default matmul precision."""
    import jax
    import jax.numpy as jnp

    from mercury_tpu.modem import sync

    def scan(seg, bank, window):
        ctx = (contextlib.nullcontext() if precision is None
               else jax.default_matmul_precision(precision))
        with ctx:
            score = sync.bank_scores(seg, bank, window, **route)
        return (jnp.max(score, axis=1),
                jnp.argmax(score, axis=1).astype(jnp.int32))

    return mock.patch.object(sync, "coherent_scan_max", scan)


_F32 = dict(mm_dtype="float32")
CANDIDATES = {
    0: {"cufft_f32": contextlib.nullcontext,
        "toeplitz_f32_highest": functools.partial(_coherent, "highest",
                                                  use_mm=True, **_F32),
        "toeplitz_f32_default": functools.partial(_coherent, None,
                                                  use_mm=True, **_F32)},
    3: {"cufft_f32": contextlib.nullcontext},
}
# the traced executables are compiled without CUDA-graph command buffers,
# which otherwise fold a whole program into one trace event
NO_COMMAND_BUFFERS = {"xla_gpu_enable_command_buffer": ""}


# ------------------------------------------------------------ trace math
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_OPNAME_RE = re.compile(r'op_name="([^"]*)"')
_CALLS_RE = re.compile(r"(?:calls|to_apply)=%?([\w.\-]+)")


def hlo_stage_map(hlo_text: str, stages=STAGES) -> dict[str, str]:
    """Instruction name -> stage, for every instruction of a compiled HLO
    module whose own op_name, or the op_names of the computation it calls
    (a fusion's body), fall in a named stage scope. A fusion that mixes
    stages goes to the stage most of its operations belong to."""
    comps: dict[str, list[tuple[str, str | None, list[str]]]] = {}
    cur = None
    for line in hlo_text.splitlines():
        m = _COMP_RE.match(line.strip())
        if m and "=" not in line.split("{")[0].split("(")[0]:
            cur = m.group(1)
            comps[cur] = []
            continue
        if line.strip() == "}":
            cur = None
            continue
        mi = _INSTR_RE.match(line)
        if cur is None or not mi:
            continue
        mo = _OPNAME_RE.search(line)
        comps[cur].append((mi.group(1), mo.group(1) if mo else None,
                           _CALLS_RE.findall(line)))

    def stage_of(op_name):
        if op_name:
            for st in stages:
                if f"/{st}/" in op_name or op_name.endswith(f"/{st}"):
                    return st
        return None

    @functools.lru_cache(maxsize=None)
    def votes(comp: str) -> tuple:
        out: dict[str, int] = {}
        for _n, op, called in comps.get(comp, []):
            st = stage_of(op)
            if st:
                out[st] = out.get(st, 0) + 1
            for c in called:
                for k, v in votes(c):
                    out[k] = out.get(k, 0) + v
        return tuple(out.items())

    result = {}
    for instrs in comps.values():
        for name, op, called in instrs:
            tally: dict[str, int] = {}
            st = stage_of(op)
            if st:
                tally[st] = 1
            for c in called:
                for k, v in votes(c):
                    tally[k] = tally.get(k, 0) + v
            if tally:
                result[name] = max(tally, key=tally.get)
    return result


def _event_hlo_op(event) -> str | None:
    for key, val in event.stats:
        if key == "hlo_op":
            return str(val)
    for key, val in event.stats:
        if isinstance(val, str) and "hlo_op=" in val:
            return re.search(r"hlo_op=([^,#\s]+)", val).group(1)
    return None


def stage_device_times(trace_dir: str, stage_map: dict[str, str],
                       n_calls: int) -> dict:
    """Per-call device time of each stage, the device's busy time and the
    traced window, from the newest .xplane.pb under trace_dir. Device planes
    are those named /device:*; an event belongs to a stage through its
    hlo_op stat. Busy time is the union of the device events' intervals."""
    import jax

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    pd = jax.profiler.ProfileData.from_file(paths[-1])
    per_stage = {st: 0 for st in STAGES}
    other = 0
    intervals = []
    lines_seen = []
    by_op: dict[tuple, float] = {}
    # accelerator kernels live on /device:* planes; the CPU backend runs its
    # thunks on host threads, where only events with an hlo_op stat count
    device = [p for p in pd.planes if p.name.startswith("/device:")]
    for plane in device or pd.planes:
        for line in plane.lines:
            evs = list(line.events)
            lines_seen.append([plane.name, line.name, len(evs)])
            # derived summary lines repeat the kernels; count raw streams
            if line.name in ("XLA Modules", "XLA Ops", "Steps",
                             "XLA TraceMe", "Launch Stats"):
                continue
            for e in evs:
                op = _event_hlo_op(e)
                if not device and op is None:
                    continue
                dur = e.duration_ns
                intervals.append((e.start_ns, e.start_ns + dur))
                st = stage_map.get(op) if op else None
                key = (op or e.name[:60], st)
                by_op[key] = by_op.get(key, 0.0) + dur
                if st:
                    per_stage[st] += dur
                else:
                    other += dur
    busy = 0.0
    if intervals:
        intervals.sort()
        cs, ce = intervals[0]
        for s, e in intervals[1:]:
            if s > ce:
                busy += ce - cs
                cs, ce = s, e
            else:
                ce = max(ce, e)
        busy += ce - cs
        window = intervals[-1][1] - intervals[0][0]
    else:
        window = 0.0
    ms = lambda ns: round(ns / n_calls / 1e6, 4)        # noqa: E731
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:25]
    return {"stage_device_ms": {k: ms(v) for k, v in per_stage.items()},
            "unattributed_device_ms": ms(other),
            "device_busy_ms": ms(busy), "device_window_ms": ms(window),
            "device_lines": lines_seen,
            "top_ops_ms": [[op, st, ms(v)] for (op, st), v in top]}


# ----------------------------------------------------------------- run
def measure_config(cfg: int, batch: int, rounds: int, log) -> dict:
    import jax

    import chip_smoke
    from mercury_tpu.modem.rx import RxChain

    g, payload, delays, buf = chip_smoke.make_capture(
        cfg, batch, chip_smoke.phase_snr_db(cfg), seed=11)
    progs = {}
    for name, route in CANDIDATES[cfg].items():
        rx = RxChain(g)
        with route():
            t0 = time.perf_counter()
            compiled = rx._receive_jit.lower(buf).compile()
            compile_s = time.perf_counter() - t0
            traced = rx._receive_jit.lower(buf).compile(
                compiler_options=NO_COMMAND_BUFFERS)
        res = jax.block_until_ready(compiled(buf))
        chip_smoke.check_decoded(g, res, payload, delays)
        mem = compiled.memory_analysis()
        progs[name] = {"fn": compiled, "traced": traced,
                       "text": traced.as_text(),
                       "compile_s": round(compile_s, 3),
                       "temp_bytes": getattr(mem, "temp_size_in_bytes", None)}
        log(f"cfg{cfg} {name}: compiled in {compile_s:.1f}s, decode ok")
    names = list(progs)
    times = {n: [] for n in names}
    for r in range(rounds):
        order = names if r % 2 == 0 else names[::-1]
        for n in order:
            t0 = time.perf_counter()
            jax.block_until_ready(progs[n]["fn"](buf))
            times[n].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for n in names:
        tdir = tempfile.mkdtemp(prefix=f"cfg{cfg}_{n}_")
        try:
            jax.block_until_ready(progs[n]["traced"](buf))
            with jax.profiler.trace(tdir):
                for _ in range(2):
                    jax.block_until_ready(progs[n]["traced"](buf))
            stages = stage_device_times(tdir, hlo_stage_map(progs[n]["text"]),
                                        2)
        finally:
            shutil.rmtree(tdir, ignore_errors=True)
        ms = sorted(times[n])
        out[n] = {"compile_s": progs[n]["compile_s"],
                  "temp_bytes": progs[n]["temp_bytes"],
                  "e2e_ms_per_call": ms,
                  "e2e_ms_median": round(float(np.median(ms)), 4),
                  "msamples_per_s": round(buf.size / np.median(ms) / 1e3, 3),
                  **stages}
        log(f"cfg{cfg} {n}: " + json.dumps({k: v for k, v in out[n].items()
                                             if k != "device_lines"}))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--configs", type=int, nargs="*", default=[0, 3])
    ap.add_argument("--out", default="chiprun_out/deep_routes.json")
    args = ap.parse_args()

    from mercury_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    import chip_smoke

    dev = jax.devices()[0]
    card = chip_smoke.card_identity() if dev.platform == "gpu" else None
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    rec = {"platform": dev.platform, "device_kind": dev.device_kind,
           "card": card, "batch": args.batch, "configs": {}}

    def log(msg):
        print(msg, flush=True)

    log(f"{dev.platform} {dev.device_kind} card={card}")
    for cfg in args.configs:
        rec["configs"][cfg] = measure_config(cfg, args.batch, args.rounds,
                                             log)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
