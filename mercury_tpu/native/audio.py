"""Audio I/O engine — the reference's source/audioio equivalent.

Replicates the reference's three-thread architecture (audioio.c):
  - playback thread: drains the playback sample ring into the output device
    with TX gain and mono/L/R routing (radio_playback_thread, audioio.c:423)
  - capture thread: reads the input device into the capture ring with RX
    gain (radio_capture_thread, audioio.c:738)
  - capture-prep thread: shifts the native sliding window one OFDM-symbol
    period at a time under the frames_to_read/data_ready protocol
    (radio_capture_prep_thread, audioio.c:999-1069; window in runtime.cc)

Device backends replace the vendored ffaudio library (the reference ships
ALSA/Pulse/OSS/JACK/WASAPI/DSound/CoreAudio backends; the Linux target
keeps the Linux trio, each loaded lazily with no compile-time dependency):
  - AlsaDevice: libasound via ctypes
  - PulseDevice: libpulse-simple via ctypes (ffaudio/pulse.c equivalent)
  - OssDevice: /dev/dsp ioctls, zero libraries (ffaudio/oss.c equivalent)
  - LoopbackDevice: an in-process virtual cable (the VB-Audio-cable test
    topology from the reference's tooling, without the OS dependency)
All raise RuntimeError cleanly when their subsystem is absent;
open_audio_device() picks the first available backend.

On a GPU server there is usually no sound card — the
link.transport UDP/file transports carry samples instead — but radio-attached
hosts use this module unchanged.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import queue
import threading

import numpy as np

from mercury_tpu.native.runtime import SampleRing, SlidingWindow

MONO, LEFT, RIGHT = 2, 0, 1


# ----------------------------------------------------------------------
class LoopbackDevice:
    """Virtual cable: what one instance plays, its peer captures."""

    def __init__(self, rate: int = 48000, channel_fn=None):
        self.rate = rate
        self._q: queue.Queue = queue.Queue()
        self.peer: "LoopbackDevice | None" = None
        self._channel_fn = channel_fn
        self._leftover = np.zeros(0, np.float32)

    @staticmethod
    def pair(rate: int = 48000, channel_fn=None):
        a, b = LoopbackDevice(rate, channel_fn), LoopbackDevice(rate, channel_fn)
        a.peer, b.peer = b, a
        return a, b

    def write(self, frames: np.ndarray) -> int:
        dst = self.peer if self.peer is not None else self
        out = np.asarray(frames, np.float32)
        if self._channel_fn is not None:
            out = self._channel_fn(out)
        dst._q.put(out)
        return len(frames)

    def read(self, n: int, timeout: float = 0.2) -> np.ndarray:
        parts = [self._leftover]
        have = len(self._leftover)
        try:
            while have < n:
                blk = self._q.get(timeout=timeout)
                parts.append(blk)
                have += len(blk)
        except queue.Empty:
            pass
        buf = np.concatenate(parts) if len(parts) > 1 else parts[0]
        self._leftover = buf[n:]
        return buf[:n]

    def close(self) -> None:
        pass


# ----------------------------------------------------------------------
class AlsaDevice:
    """ALSA PCM device via ctypes libasound (playback or capture).

    Interleaved float32; mono devices get the samples directly, stereo
    devices route per `channel` (MONO duplicates, LEFT/RIGHT zero the other
    arm) — matching the reference's channel routing (audioio.c:520-607)."""

    SND_PCM_STREAM_PLAYBACK = 0
    SND_PCM_STREAM_CAPTURE = 1
    SND_PCM_FORMAT_FLOAT_LE = 14
    SND_PCM_ACCESS_RW_INTERLEAVED = 3

    def __init__(self, device: str = "default", capture: bool = False,
                 rate: int = 48000, channels: int = 2,
                 channel: int = MONO, latency_us: int = 100000):
        path = ctypes.util.find_library("asound")
        if path is None:
            raise RuntimeError(
                "libasound not found — ALSA audio unavailable on this host; "
                "use LoopbackDevice or a link.transport sample transport")
        self._lib = ctypes.CDLL(path)
        # Full prototypes for every entry point used: without argtypes,
        # ctypes passes buffer addresses as 32-bit C int — a pointer
        # truncation that segfaults the moment a numpy buffer lands above
        # 4 GB (found by the libasound contract stub,
        # tests/test_audio.py::test_alsa_contract_params_and_loopback).
        self._lib.snd_pcm_open.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                           ctypes.c_char_p, ctypes.c_int,
                                           ctypes.c_int]
        self._lib.snd_strerror.restype = ctypes.c_char_p
        self._lib.snd_strerror.argtypes = [ctypes.c_int]
        self._lib.snd_pcm_set_params.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
            ctypes.c_uint, ctypes.c_int, ctypes.c_uint]
        self._lib.snd_pcm_writei.restype = ctypes.c_long
        self._lib.snd_pcm_writei.argtypes = [ctypes.c_void_p,
                                             ctypes.c_void_p,
                                             ctypes.c_ulong]
        self._lib.snd_pcm_readi.restype = ctypes.c_long
        self._lib.snd_pcm_readi.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_ulong]
        self._lib.snd_pcm_recover.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_int]
        self._lib.snd_pcm_close.argtypes = [ctypes.c_void_p]
        self.rate, self.channels, self.channel = rate, channels, channel
        self.capture = capture
        self._pcm = ctypes.c_void_p()
        stream = (self.SND_PCM_STREAM_CAPTURE if capture
                  else self.SND_PCM_STREAM_PLAYBACK)
        rc = self._lib.snd_pcm_open(ctypes.byref(self._pcm), device.encode(),
                                    stream, 0)
        if rc < 0:
            raise OSError(f"snd_pcm_open({device}): "
                          f"{self._lib.snd_strerror(rc).decode()}")
        rc = self._lib.snd_pcm_set_params(
            self._pcm, self.SND_PCM_FORMAT_FLOAT_LE,
            self.SND_PCM_ACCESS_RW_INTERLEAVED, channels, rate, 1, latency_us)
        if rc < 0:
            raise OSError(f"snd_pcm_set_params: "
                          f"{self._lib.snd_strerror(rc).decode()}")

    @staticmethod
    def list_devices() -> list[str]:
        """Device hints (reference `-l` listing, audioio.c:1072)."""
        path = ctypes.util.find_library("asound")
        if path is None:
            return []
        lib = ctypes.CDLL(path)
        hints = ctypes.POINTER(ctypes.c_void_p)()
        lib.snd_device_name_hint.argtypes = [
            ctypes.c_int, ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_void_p))]
        lib.snd_device_name_get_hint.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_char_p]
        lib.snd_device_name_free_hint.argtypes = [
            ctypes.POINTER(ctypes.c_void_p)]
        if lib.snd_device_name_hint(-1, b"pcm", ctypes.byref(hints)) < 0:
            return []
        lib.snd_device_name_get_hint.restype = ctypes.c_void_p
        out, i = [], 0
        while hints[i]:
            name = lib.snd_device_name_get_hint(hints[i], b"NAME")
            if name:
                out.append(ctypes.cast(name, ctypes.c_char_p).value.decode())
            i += 1
        lib.snd_device_name_free_hint(hints)
        return out

    def write(self, samples: np.ndarray) -> int:
        mono = np.asarray(samples, np.float32)
        if self.channels == 1:
            frames = mono
        else:
            frames = np.zeros((len(mono), self.channels), np.float32)
            if self.channel == MONO:
                frames[:] = mono[:, None]
            else:
                frames[:, self.channel] = mono
        buf = np.ascontiguousarray(frames)
        n = self._lib.snd_pcm_writei(self._pcm, buf.ctypes.data, len(mono))
        if n < 0:   # xrun recovery
            self._lib.snd_pcm_recover(self._pcm, n, 1)
            n = self._lib.snd_pcm_writei(self._pcm, buf.ctypes.data, len(mono))
        return max(int(n), 0)

    def read(self, n: int, timeout: float = 0.2) -> np.ndarray:
        buf = np.empty((n, self.channels), np.float32)
        got = self._lib.snd_pcm_readi(self._pcm, buf.ctypes.data, n)
        if got < 0:
            self._lib.snd_pcm_recover(self._pcm, got, 1)
            return np.zeros(0, np.float32)
        frames = buf[: int(got)]
        if self.channels == 1:
            return frames.reshape(-1)
        if self.channel == MONO:
            return frames.mean(axis=1)
        return np.ascontiguousarray(frames[:, self.channel])

    def close(self) -> None:
        if getattr(self, "_pcm", None):
            self._lib.snd_pcm_close(self._pcm)
            self._pcm = None


# ----------------------------------------------------------------------
class PulseDevice:
    """PulseAudio device via the libpulse-simple blocking API
    (ffaudio/pulse.c equivalent; pa_simple_new/write/read/free).

    Mono float32 on the wire — Pulse does its own routing/resampling, so
    unlike ALSA there is no manual channel interleave to manage."""

    PA_STREAM_PLAYBACK = 1
    PA_STREAM_RECORD = 2
    PA_SAMPLE_FLOAT32LE = 5

    class _SampleSpec(ctypes.Structure):
        _fields_ = [("format", ctypes.c_int), ("rate", ctypes.c_uint32),
                    ("channels", ctypes.c_uint8)]

    def __init__(self, device: str | None = None, capture: bool = False,
                 rate: int = 48000, app_name: str = "mercury-tpu"):
        path = (ctypes.util.find_library("pulse-simple")
                or ctypes.util.find_library("libpulse-simple"))
        if path is None:
            raise RuntimeError(
                "libpulse-simple not found — PulseAudio unavailable on this "
                "host; use AlsaDevice/OssDevice/LoopbackDevice or a "
                "link.transport sample transport")
        self._lib = ctypes.CDLL(path)
        self._lib.pa_simple_new.restype = ctypes.c_void_p
        self._lib.pa_simple_new.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                            ctypes.c_int, ctypes.c_char_p,
                                            ctypes.c_char_p, ctypes.c_void_p,
                                            ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.POINTER(ctypes.c_int)]
        # full prototypes: ctypes passes raw buffer addresses as 32-bit C
        # int without argtypes — pointer truncation (same defect class the
        # libasound contract stub caught in AlsaDevice)
        for fn in ("pa_simple_write", "pa_simple_read"):
            getattr(self._lib, fn).argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int)]
        self._lib.pa_simple_drain.argtypes = [ctypes.c_void_p,
                                              ctypes.POINTER(ctypes.c_int)]
        self._lib.pa_simple_free.argtypes = [ctypes.c_void_p]
        self.rate, self.capture = rate, capture
        spec = self._SampleSpec(self.PA_SAMPLE_FLOAT32LE, rate, 1)
        err = ctypes.c_int(0)
        stream = self.PA_STREAM_RECORD if capture else self.PA_STREAM_PLAYBACK
        self._s = self._lib.pa_simple_new(
            None, app_name.encode(), stream,
            device.encode() if device else None,
            b"capture" if capture else b"playback",
            ctypes.byref(spec), None, None, ctypes.byref(err))
        if not self._s:
            raise OSError(f"pa_simple_new failed (pulse error {err.value}) — "
                          "is a PulseAudio/PipeWire server running?")

    def write(self, samples: np.ndarray) -> int:
        buf = np.ascontiguousarray(np.asarray(samples, np.float32))
        err = ctypes.c_int(0)
        rc = self._lib.pa_simple_write(ctypes.c_void_p(self._s),
                                       buf.ctypes.data, buf.nbytes,
                                       ctypes.byref(err))
        return len(buf) if rc == 0 else 0

    def read(self, n: int, timeout: float = 0.2) -> np.ndarray:
        del timeout  # pa_simple_read blocks until the buffer is full
        buf = np.empty(n, np.float32)
        err = ctypes.c_int(0)
        rc = self._lib.pa_simple_read(ctypes.c_void_p(self._s),
                                      buf.ctypes.data, buf.nbytes,
                                      ctypes.byref(err))
        return buf if rc == 0 else np.zeros(0, np.float32)

    def close(self) -> None:
        if getattr(self, "_s", None):
            # drain pending playback so short TX tails are not cut off
            err = ctypes.c_int(0)
            if not self.capture:
                self._lib.pa_simple_drain(ctypes.c_void_p(self._s),
                                          ctypes.byref(err))
            self._lib.pa_simple_free(ctypes.c_void_p(self._s))
            self._s = None


# ----------------------------------------------------------------------
class OssDevice:
    """OSS device (/dev/dsp) via raw ioctls — no library at all
    (ffaudio/oss.c equivalent). S16_LE on the wire, float32 at the API."""

    # linux soundcard.h ioctl numbers (each is _IOWR('P', n, int))
    SNDCTL_DSP_SPEED = 0xC0045002
    SNDCTL_DSP_SETFMT = 0xC0045005
    SNDCTL_DSP_CHANNELS = 0xC0045006
    AFMT_S16_LE = 0x10

    def __init__(self, device: str = "/dev/dsp", capture: bool = False,
                 rate: int = 48000):
        import fcntl
        import os as _os
        import struct
        if not _os.path.exists(device):
            raise RuntimeError(
                f"{device} not present — OSS audio unavailable on this host; "
                "use AlsaDevice/PulseDevice/LoopbackDevice or a "
                "link.transport sample transport")
        self.rate, self.capture = rate, capture
        self._fd = _os.open(device, _os.O_RDONLY if capture else _os.O_WRONLY)
        for req, val in ((self.SNDCTL_DSP_SETFMT, self.AFMT_S16_LE),
                         (self.SNDCTL_DSP_CHANNELS, 1),
                         (self.SNDCTL_DSP_SPEED, rate)):
            arg = bytearray(struct.pack("i", val))
            fcntl.ioctl(self._fd, req, arg)
            got = struct.unpack("i", bytes(arg))[0]
            if got != val:
                _os.close(self._fd)
                raise OSError(f"OSS ioctl 0x{req:x}: wanted {val}, got {got}")

    def write(self, samples: np.ndarray) -> int:
        import os as _os
        pcm = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
        raw = (pcm * 32767.0).astype("<i2").tobytes()
        return _os.write(self._fd, raw) // 2

    def read(self, n: int, timeout: float = 0.2) -> np.ndarray:
        import os as _os
        del timeout  # OSS blocking read
        raw = _os.read(self._fd, n * 2)
        return np.frombuffer(raw, "<i2").astype(np.float32) / 32767.0

    def close(self) -> None:
        import os as _os
        if getattr(self, "_fd", None) is not None:
            _os.close(self._fd)
            self._fd = None


_BACKENDS = {"alsa": AlsaDevice, "pulse": PulseDevice, "oss": OssDevice}


def open_audio_device(backend: str = "auto", device: str | None = None,
                      capture: bool = False, rate: int = 48000, **kw):
    """Open a named backend, or probe alsa → pulse → oss in order (the
    reference's ffaudio picks its backend at compile time; here it is a
    runtime choice). Raises RuntimeError with the per-backend reasons if
    nothing on the host can do audio."""
    if backend != "auto":
        cls = _BACKENDS[backend]
        args = {"capture": capture, "rate": rate, **kw}
        if device is not None:
            args["device"] = device
        return cls(**args)
    reasons = []
    for name, cls in _BACKENDS.items():
        try:
            args = {"capture": capture, "rate": rate, **kw}
            if device is not None:
                args["device"] = device
            return cls(**args)
        except (RuntimeError, OSError) as e:
            reasons.append(f"{name}: {e}")
    raise RuntimeError("no audio backend available — " + "; ".join(reasons))


# ----------------------------------------------------------------------
class AudioIO:
    """The three-thread audio engine around a playback + capture device."""

    def __init__(self, playback_dev, capture_dev, symbol_len: int,
                 window_nsymb: int, tx_gain_db: float = 0.0,
                 rx_gain_db: float = 0.0, block: int = 2048,
                 ring_capacity: int = 48000 * 30, use_window: bool = True,
                 fs: int = 48000):
        self.playback_dev, self.capture_dev = playback_dev, capture_dev
        self.symbol_len, self.block = symbol_len, block
        self.fs = fs
        self.tx_gain = 10 ** (tx_gain_db / 20.0)
        self.rx_gain = 10 ** (rx_gain_db / 20.0)
        # antenna-tune tone (reference audioio.c:589-594 +
        # gui_state.h:242-247: 1500 Hz sine at 0.9 amplitude replaces the
        # playback stream while active; TX gain still applies)
        self.tune_active = False
        self._tune_idx = 0
        self.playback_buffer = SampleRing(ring_capacity)
        self.capture_buffer = SampleRing(ring_capacity)
        # window mode: the capture-prep thread consumes the capture ring
        # into the sliding window (reference ARQ topology). Stream mode
        # (use_window=False) leaves the ring to drain_capture() consumers
        # like AudioBurstTransport — the two consumption modes are exclusive.
        self.use_window = use_window
        self.window = (SlidingWindow(symbol_len * window_nsymb, symbol_len)
                       if use_window else None)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def start(self) -> None:
        fns = [self._playback_thread, self._capture_thread]
        if self.use_window:
            fns.append(self._capture_prep_thread)
        for fn in fns:
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        self.playback_dev.close()
        self.capture_dev.close()

    # -- application side (reference audioio.c:1143-1168) ----------------
    def tx_transfer(self, samples: np.ndarray) -> int:
        return self.playback_buffer.write(
            np.asarray(samples, np.float32) * self.tx_gain)

    def arm(self, frames_to_read: int) -> None:
        self.window.arm(frames_to_read)

    def rx_window(self) -> tuple[np.ndarray, bool]:
        return self.window.snapshot()

    def set_tune(self, on: bool) -> None:
        """Toggle the 1500 Hz antenna-tuning tone (reference GUI tune
        button -> audioio.c:589-594)."""
        if on and not self.tune_active:
            self._tune_idx = 0
        self.tune_active = bool(on)

    # -- threads ---------------------------------------------------------
    def _playback_thread(self) -> None:
        tune_w = 2.0 * np.pi * 1500.0 / self.fs
        while not self._stop.is_set():
            if self.tune_active:
                # tone replaces the stream; keep draining the ring so queued
                # TX doesn't burst out when tuning ends (reference overwrites
                # the read buffer the same way)
                self.playback_buffer.read(self.block, timeout_ms=0)
                idx = self._tune_idx + np.arange(self.block)
                tone = (0.9 * np.sin(tune_w * idx)).astype(np.float32)
                self._tune_idx += self.block
                self.playback_dev.write(tone * self.tx_gain)
                continue
            chunk = self.playback_buffer.read(self.block, timeout_ms=100)
            if len(chunk):
                self.playback_dev.write(chunk)

    def _capture_thread(self) -> None:
        while not self._stop.is_set():
            chunk = self.capture_dev.read(self.block)
            if len(chunk):
                self.capture_buffer.write(chunk * self.rx_gain)

    def drain_capture(self) -> np.ndarray:
        """All capture samples currently buffered (bypasses the window)."""
        n = len(self.capture_buffer)
        return self.capture_buffer.read(n) if n else np.zeros(0, np.float32)

    def _capture_prep_thread(self) -> None:
        # one OFDM-symbol period at a time, like the reference's prep thread;
        # ring reads can return partial after their timeout — accumulate so
        # no samples are dropped
        buf = np.zeros(0, np.float32)
        while not self._stop.is_set():
            chunk = self.capture_buffer.read(self.symbol_len - len(buf),
                                             timeout_ms=100)
            if len(chunk):
                buf = np.concatenate([buf, chunk])
            if len(buf) >= self.symbol_len:
                self.window.push(buf[: self.symbol_len])
                buf = buf[self.symbol_len:]


# ----------------------------------------------------------------------
class AudioBurstTransport:
    """link.transport-compatible adapter over AudioIO for the ARQ service.

    The ARQ node consumes whole transmissions (bursts), but a sound card
    yields a continuous sample stream — this adapter segments the capture
    stream on energy: samples accumulate while the short-window RMS stays
    above `squelch`, and the burst is emitted once `hang_samples` of silence
    follow it (the software equivalent of the reference's signal-strength
    gating in receive(), telecom_system.cc:678/730-924)."""

    def __init__(self, io: AudioIO, squelch: float = 1e-3,
                 hang_samples: int = 4800, max_burst: int = 48000 * 60):
        if io.use_window:
            raise ValueError(
                "AudioBurstTransport needs AudioIO(use_window=False): the "
                "capture-prep thread would consume the same capture ring")
        self.io = io
        self.squelch = squelch
        self.hang = hang_samples
        self.max_burst = max_burst
        self._acc = np.zeros(0, np.float32)
        self._quiet = 0

    def transmit(self, block: np.ndarray) -> None:
        self.io.tx_transfer(block)

    def set_tune(self, on: bool) -> None:
        self.io.set_tune(on)

    def capture(self):
        chunk = self.io.drain_capture()
        if len(chunk):
            if len(self._acc) == 0:
                # drop leading silence so bursts start near the signal
                idx = np.flatnonzero(np.abs(chunk) > self.squelch)
                if len(idx) == 0:
                    return None
                chunk = chunk[max(int(idx[0]) - 256, 0):]
            self._acc = np.concatenate([self._acc, chunk])
            tail = self._acc[-self.hang:]
            rms = float(np.sqrt(np.mean(tail * tail))) if len(tail) else 0.0
            self._quiet = len(tail) if rms < self.squelch else 0
        elif len(self._acc):
            self._quiet += self.io.block
        if len(self._acc) and (self._quiet >= self.hang
                               or len(self._acc) >= self.max_burst):
            burst, self._acc = self._acc, np.zeros(0, np.float32)
            self._quiet = 0
            return burst
        return None
