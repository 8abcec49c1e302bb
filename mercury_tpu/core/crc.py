"""CRC16-MODBUS-RTU outer code (reference: crc16_modbus_rtu.cc:25-46).

For the jit-compiled TX/RX paths the CRC is precompiled into an affine GF(2)
operator over the frame's bit vector (CRC is linear for fixed length):
  crc_bits(x) = A @ x ⊕ c0  (mod 2)
so appending/checking the CRC is a small matmul — no bit-serial loop.

Bit layout matches the reference's byte_to_bit (LSB first within each byte,
misc.cc:93-105); the appended 16 bits are [lsB bits, msB bits], each LSB first
(telecom_system.cc:363-373).
"""

from __future__ import annotations

import functools

import numpy as np

POLY = 0xA001


def crc16(data_bytes: np.ndarray) -> int:
    """Bit-serial reference implementation (host)."""
    crc = 0xFFFF
    for b in np.asarray(data_bytes, dtype=np.int64):
        crc ^= int(b) & 0xFF
        for _ in range(8):
            if crc & 1:
                crc = (crc >> 1) ^ POLY
            else:
                crc >>= 1
    return crc


def _crc_to_bits(crc: int) -> np.ndarray:
    """16 bits in transmit order: lsB LSB-first, then msB LSB-first."""
    ls, ms = crc & 0xFF, (crc >> 8) & 0xFF
    out = np.empty(16, dtype=np.uint8)
    for j in range(8):
        out[j] = (ls >> j) & 1
        out[8 + j] = (ms >> j) & 1
    return out


@functools.lru_cache(maxsize=None)
def crc_affine(nbytes: int) -> tuple[np.ndarray, np.ndarray]:
    """(A [16, nbytes*8], c0 [16]) with crc_bits(x) = A@x ⊕ c0 over the
    LSB-first bit vector of the frame bytes."""
    nbits = nbytes * 8
    c0 = _crc_to_bits(crc16(np.zeros(nbytes, dtype=np.int64)))
    a = np.zeros((16, nbits), dtype=np.uint8)
    for k in range(nbits):
        byts = np.zeros(nbytes, dtype=np.int64)
        byts[k // 8] = 1 << (k % 8)
        a[:, k] = _crc_to_bits(crc16(byts)) ^ c0
    return a, c0


def bytes_to_bits(data: np.ndarray) -> np.ndarray:
    """LSB-first bit expansion matching reference byte_to_bit."""
    data = np.asarray(data, dtype=np.uint8)
    return np.unpackbits(data[..., None], axis=-1, bitorder="little").reshape(
        *data.shape[:-1], -1)


def bits_to_bytes(bits: np.ndarray) -> np.ndarray:
    bits = np.asarray(bits, dtype=np.uint8)
    return np.packbits(bits.reshape(*bits.shape[:-1], -1, 8), axis=-1,
                       bitorder="little").reshape(*bits.shape[:-1], -1)
