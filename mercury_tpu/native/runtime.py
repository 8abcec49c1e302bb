"""ctypes bindings for the native runtime (runtime.cc)."""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
_SO = _DIR / "libmercury_rt.so"
_LIB = None


def ensure_built() -> pathlib.Path:
    """Build libmercury_rt.so from runtime.cc when it is missing or stale.
    Concurrent processes (parallel test workers) may build at once, so each
    compiles to its own file and renames it into place atomically."""
    src = _DIR / "runtime.cc"
    if not _SO.exists() or _SO.stat().st_mtime < src.stat().st_mtime:
        tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(
                ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                 str(src), "-o", str(tmp), "-lpthread", "-lrt"],
                check=True)
            os.replace(tmp, _SO)
        finally:
            tmp.unlink(missing_ok=True)
    return _SO


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(ensure_built()))
        lib.rt_ring_create.restype = ctypes.c_void_p
        lib.rt_ring_create.argtypes = [ctypes.c_size_t]
        lib.rt_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.rt_ring_write.restype = ctypes.c_size_t
        lib.rt_ring_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.rt_ring_read.restype = ctypes.c_size_t
        lib.rt_ring_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_size_t, ctypes.c_int]
        lib.rt_ring_size.restype = ctypes.c_size_t
        lib.rt_ring_size.argtypes = [ctypes.c_void_p]
        lib.rt_ring_clear.argtypes = [ctypes.c_void_p]

        lib.rt_window_create.restype = ctypes.c_void_p
        lib.rt_window_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
        lib.rt_window_destroy.argtypes = [ctypes.c_void_p]
        lib.rt_window_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.rt_window_snapshot.restype = ctypes.c_int
        lib.rt_window_snapshot.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.rt_window_arm.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rt_window_nunder.restype = ctypes.c_int
        lib.rt_window_nunder.argtypes = [ctypes.c_void_p]
        lib.rt_window_ready.restype = ctypes.c_int
        lib.rt_window_ready.argtypes = [ctypes.c_void_p]
        lib.rt_window_clear.argtypes = [ctypes.c_void_p]

        lib.rt_pool_create.restype = ctypes.c_void_p
        lib.rt_pool_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t,
                                       ctypes.c_size_t]
        lib.rt_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.rt_pool_feed.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                     ctypes.c_void_p, ctypes.c_size_t]
        lib.rt_pool_feed_block.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_size_t]
        lib.rt_pool_arm.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.c_int]
        lib.rt_pool_arm_many.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_void_p, ctypes.c_size_t]
        lib.rt_pool_ready_count.restype = ctypes.c_long
        lib.rt_pool_ready_count.argtypes = [ctypes.c_void_p]
        lib.rt_pool_gather_ready.restype = ctypes.c_long
        lib.rt_pool_gather_ready.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                             ctypes.c_void_p, ctypes.c_size_t]
        lib.rt_pool_nunder.restype = ctypes.c_int
        lib.rt_pool_nunder.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        lib.rt_pool_clear.argtypes = [ctypes.c_void_p]

        lib.rt_shm_open.restype = ctypes.c_void_p
        lib.rt_shm_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
        lib.rt_shm_close.argtypes = [ctypes.c_void_p]
        lib.rt_shm_write.restype = ctypes.c_long
        lib.rt_shm_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.rt_shm_read.restype = ctypes.c_long
        lib.rt_shm_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.rt_shm_size.restype = ctypes.c_long
        lib.rt_shm_size.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


class SampleRing:
    """Thread-safe float sample ring (native)."""

    def __init__(self, capacity: int):
        self._h = _lib().rt_ring_create(capacity)
        if not self._h:
            raise MemoryError("rt_ring_create failed")

    def write(self, samples: np.ndarray) -> int:
        s = np.ascontiguousarray(samples, dtype=np.float32)
        return _lib().rt_ring_write(self._h, s.ctypes.data, len(s))

    def read(self, n: int, timeout_ms: int = 0) -> np.ndarray:
        out = np.empty(n, dtype=np.float32)
        got = _lib().rt_ring_read(self._h, out.ctypes.data, n, timeout_ms)
        return out[:got]

    def __len__(self) -> int:
        return _lib().rt_ring_size(self._h)

    def clear(self) -> None:
        _lib().rt_ring_clear(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            _lib().rt_ring_destroy(self._h)
            self._h = None


class SlidingWindow:
    """Sliding capture window with the reference's frames_to_read/data_ready
    gating (native; reference: radio_capture_prep_thread)."""

    def __init__(self, window_len: int, symbol_len: int):
        self.window_len = window_len
        self._h = _lib().rt_window_create(window_len, symbol_len)
        if not self._h:
            raise MemoryError("rt_window_create failed")

    def push(self, samples: np.ndarray) -> None:
        s = np.ascontiguousarray(samples, dtype=np.float32)
        _lib().rt_window_push(self._h, s.ctypes.data, len(s))

    def snapshot(self) -> tuple[np.ndarray, bool]:
        out = np.empty(self.window_len, dtype=np.float32)
        ready = _lib().rt_window_snapshot(self._h, out.ctypes.data)
        return out, bool(ready)

    def arm(self, frames_to_read: int) -> None:
        _lib().rt_window_arm(self._h, frames_to_read)

    @property
    def ready(self) -> bool:
        return bool(_lib().rt_window_ready(self._h))

    @property
    def n_under(self) -> int:
        return _lib().rt_window_nunder(self._h)

    def clear(self) -> None:
        _lib().rt_window_clear(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            _lib().rt_window_destroy(self._h)
            self._h = None


class WindowPool:
    """Vectorized many-channel sliding-window pool (native; the serving-
    scale form of SlidingWindow — one contiguous [n_ch, window_len]
    circular store with bulk feed and single-call gather of every ready
    channel into contiguous rows for one batched device dispatch)."""

    def __init__(self, n_channels: int, window_len: int, symbol_len: int):
        self.n_channels = n_channels
        self.window_len = window_len
        self.symbol_len = symbol_len
        self._h = _lib().rt_pool_create(n_channels, window_len, symbol_len)
        if not self._h:
            raise MemoryError("rt_pool_create failed (window_len must be a "
                              "multiple of symbol_len)")

    def feed(self, channel: int, samples: np.ndarray) -> None:
        s = np.ascontiguousarray(samples, dtype=np.float32)
        _lib().rt_pool_feed(self._h, channel, s.ctypes.data, len(s))

    def feed_block(self, block: np.ndarray) -> None:
        """Feed all channels from one [n_channels, n] block in ONE call."""
        b = np.ascontiguousarray(block, dtype=np.float32)
        assert b.ndim == 2 and b.shape[0] == self.n_channels
        _lib().rt_pool_feed_block(self._h, b.ctypes.data, b.shape[1])

    def arm(self, channel: int, frames_to_read: int) -> None:
        _lib().rt_pool_arm(self._h, channel, frames_to_read)

    def arm_many(self, channels: np.ndarray, frames: np.ndarray) -> None:
        c = np.ascontiguousarray(channels, dtype=np.int32)
        f = np.ascontiguousarray(frames, dtype=np.int32)
        _lib().rt_pool_arm_many(self._h, c.ctypes.data, f.ctypes.data, len(c))

    @property
    def ready_count(self) -> int:
        return _lib().rt_pool_ready_count(self._h)

    def gather_ready(self, max_rows: int | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
        """(rows [R, window_len] float32, channel_ids [R] int32) for every
        ready channel, linearized in one native pass."""
        cap = self.n_channels if max_rows is None else max_rows
        out = np.empty((cap, self.window_len), np.float32)
        idx = np.empty(cap, np.int32)
        r = _lib().rt_pool_gather_ready(self._h, out.ctypes.data,
                                        idx.ctypes.data, cap)
        return out[:r], idx[:r]

    def n_under(self, channel: int) -> int:
        return _lib().rt_pool_nunder(self._h, channel)

    def clear(self) -> None:
        _lib().rt_pool_clear(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            _lib().rt_pool_destroy(self._h)
            self._h = None


class ShmPayloadRing:
    """POSIX shared-memory byte ring for external-app IPC (the reference's
    "/mercury-comm" equivalent, usable from any language)."""

    def __init__(self, name: str = "/mercury-tpu-comm", size: int = 131072,
                 create: bool = True):
        self._h = _lib().rt_shm_open(name.encode(), size, int(create))
        if not self._h:
            raise OSError(f"shm_open({name}) failed")

    def write(self, data: bytes) -> int:
        buf = (ctypes.c_char * len(data)).from_buffer_copy(data)
        return _lib().rt_shm_write(self._h, buf, len(data))

    def read(self, n: int) -> bytes:
        out = (ctypes.c_char * n)()
        got = _lib().rt_shm_read(self._h, out, n)
        return bytes(out[:got])

    def __len__(self) -> int:
        return _lib().rt_shm_size(self._h)

    def close(self) -> None:
        if getattr(self, "_h", None):
            _lib().rt_shm_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
