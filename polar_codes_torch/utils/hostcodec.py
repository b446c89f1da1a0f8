"""ctypes loader of native/libhostcodec.so: host-side CRC engines, the
host polar transform and the CMAC detector's AES-128-CMAC.

The port's own loader of the library the JAX package also uses
(native/hostcodec.cpp). The library is built on first use with the
Makefile in native/ (into the gitignored native/libhostcodec.so); CMAC
drives the system libcrypto. When make, the compiler or libcrypto is
missing, every entry point takes its NumPy or pure-Python route instead
(the CRCs of models/detectors.py, the engine of utils/aes.py), with the
same results.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))
_LIB_PATH = os.path.join(_NATIVE_DIR, "libhostcodec.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(["make", "-s", "libhostcodec.so"], cwd=_NATIVE_DIR,
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    return True


def load() -> Optional[ctypes.CDLL]:
    """The library, built if needed; None where it cannot be built or
    loaded (tried once per process)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    lib.hc_crc_msb_first.argtypes = [u8p, ctypes.c_size_t, ctypes.c_uint64, ctypes.c_uint,
                                     ctypes.c_uint64]
    lib.hc_crc_msb_first.restype = ctypes.c_uint64
    lib.hc_crc32c_bytes.argtypes = [u8p, ctypes.c_size_t, ctypes.c_uint32]
    lib.hc_crc32c_bytes.restype = ctypes.c_uint32
    lib.hc_crc_rows.argtypes = [u8p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_uint64,
                                ctypes.c_uint, ctypes.c_uint64, u64p]
    lib.hc_crc_rows.restype = None
    lib.hc_butterfly_rows.argtypes = [u8p, ctypes.c_size_t, ctypes.c_size_t]
    lib.hc_butterfly_rows.restype = None
    lib.hc_cmac_available.argtypes = []
    lib.hc_cmac_available.restype = ctypes.c_int
    lib.hc_cmac_rows.argtypes = [u8p, u8p, ctypes.c_size_t, ctypes.c_size_t, u8p]
    lib.hc_cmac_rows.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    """True when the native library is loaded."""
    return load() is not None


def crc_msb_first(bits: np.ndarray, poly: int, width: int, init: int) -> int:
    """Non-reflected CRC over a 1-D {0,1} bit stream."""
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    lib = load()
    if lib is None:
        from ..models.detectors import crc_msb_first as py_crc

        return py_crc(bits, poly, width, init)
    return int(lib.hc_crc_msb_first(bits, bits.size, poly, width, init))


def crc_rows(bits: np.ndarray, poly: int, width: int, init: int) -> np.ndarray:
    """crc_msb_first of every row of a [rows, bits] array, as uint64."""
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    rows, row_bits = bits.shape
    lib = load()
    if lib is None:
        from ..models.detectors import crc_msb_first as py_crc

        return np.array([py_crc(row, poly, width, init) for row in bits], dtype=np.uint64)
    out = np.empty(rows, dtype=np.uint64)
    lib.hc_crc_rows(bits, row_bits, rows, poly, width, init, out)
    return out


def crc32c_bytes(data: bytes, init: int = 0) -> int:
    """Reflected CRC-32C over bytes, no xor-out."""
    lib = load()
    if lib is None:
        from ..models.detectors import crc32c_bytes as py_crc

        return py_crc(data, init)
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    return int(lib.hc_crc32c_bytes(np.ascontiguousarray(buf), buf.size, init))


def butterfly_rows(bits: np.ndarray) -> np.ndarray:
    """The polar transform of every row of a [rows, N] {0,1} array, into a
    new array (the input is not written)."""
    bits = np.ascontiguousarray(bits, dtype=np.uint8).copy()
    rows, n = bits.shape
    lib = load()
    if lib is None:
        s = 1
        while s < n:
            for i in range(0, n, 2 * s):
                bits[:, i : i + s] ^= bits[:, i + s : i + 2 * s]
            s *= 2
        return bits
    lib.hc_butterfly_rows(bits, n, rows)
    return bits


def cmac_available() -> bool:
    """True when the system libcrypto CMAC engine is reachable."""
    lib = load()
    return lib is not None and bool(lib.hc_cmac_available())


def cmac_rows(key: bytes, msgs: np.ndarray) -> Optional[np.ndarray]:
    """AES-128-CMAC tags [rows, 16] uint8 of [rows, msg_bytes] uint8
    messages through libcrypto, or None when that engine is unavailable."""
    if not cmac_available():
        return None
    key_arr = np.frombuffer(bytes(key), dtype=np.uint8)
    if key_arr.size != 16:
        raise ValueError("AES-128-CMAC needs a 16-byte key")
    msgs = np.ascontiguousarray(msgs, dtype=np.uint8)
    rows, msg_bytes = msgs.shape
    tags = np.empty((rows, 16), dtype=np.uint8)
    if _lib.hc_cmac_rows(np.ascontiguousarray(key_arr), msgs, msg_bytes, rows, tags):
        return None
    return tags
