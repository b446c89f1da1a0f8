"""ctypes loader of native/libhostcodec.so for the CMAC detector.

The port's own loader of the library the JAX package also uses
(native/hostcodec.cpp), bound to its two CMAC entry points only. The
library is built on first use with the Makefile in native/ (into the
gitignored native/libhostcodec.so) and drives the system libcrypto's
AES-128-CMAC. When make, the compiler or libcrypto is missing, the
callers use the pure-Python RFC 4493 engine (utils/aes.py) instead; both
give the same tags.
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
    lib.hc_cmac_available.argtypes = []
    lib.hc_cmac_available.restype = ctypes.c_int
    lib.hc_cmac_rows.argtypes = [u8p, u8p, ctypes.c_size_t, ctypes.c_size_t, u8p]
    lib.hc_cmac_rows.restype = ctypes.c_int
    _lib = lib
    return _lib


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
