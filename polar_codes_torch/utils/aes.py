"""Minimal AES-128 (encrypt-only) and AES-CMAC (RFC 4493), host-side.

A copy of polar_codes_tpu/utils/aes.py: the pure-Python engine of the CMAC
detector (models/detectors.py), which runs when the system libcrypto is
not reachable through native/libhostcodec.so (utils/hostcodec.py).
"""

from __future__ import annotations

_SBOX = None


def _build_sbox():
    global _SBOX
    if _SBOX is not None:
        return _SBOX
    # multiplicative inverse table in GF(2^8) + affine transform
    p, q = 1, 1
    inv = [0] * 256
    while True:
        # p *= 3 in GF(2^8)
        p = p ^ ((p << 1) & 0xFF) ^ (0x1B if p & 0x80 else 0)
        # q /= 3
        q ^= q << 1
        q ^= q << 2
        q ^= q << 4
        q &= 0xFF
        if q & 0x80:
            q ^= 0x09
        inv[p] = q
        if p == 1:
            break
    inv[0] = 0
    sbox = [0] * 256
    for i in range(256):
        x = inv[i] if i else 0
        s = x ^ _rotl8(x, 1) ^ _rotl8(x, 2) ^ _rotl8(x, 3) ^ _rotl8(x, 4) ^ 0x63
        sbox[i] = s
    _SBOX = sbox
    return sbox


def _rotl8(x: int, n: int) -> int:
    return ((x << n) | (x >> (8 - n))) & 0xFF


def _xtime(a: int) -> int:
    return ((a << 1) ^ 0x1B) & 0xFF if a & 0x80 else (a << 1)


def _expand_key(key: bytes):
    sbox = _build_sbox()
    w = [list(key[i : i + 4]) for i in range(0, 16, 4)]
    rcon = 1
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = t[1:] + t[:1]
            t = [sbox[b] for b in t]
            t[0] ^= rcon
            rcon = _xtime(rcon)
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return [sum(w[4 * r : 4 * r + 4], []) for r in range(11)]


def aes128_encrypt_block(key: bytes, block: bytes) -> bytes:
    sbox = _build_sbox()
    rk = _expand_key(key)
    s = [block[i] ^ rk[0][i] for i in range(16)]
    for rnd in range(1, 11):
        s = [sbox[b] for b in s]
        # ShiftRows on column-major state: byte index = 4*col + row
        s = [s[(4 * ((i // 4) + (i % 4)) + (i % 4)) % 16] for i in range(16)]
        if rnd != 10:
            ns = []
            for c in range(4):
                a = s[4 * c : 4 * c + 4]
                ns += [
                    _xtime(a[0]) ^ _xtime(a[1]) ^ a[1] ^ a[2] ^ a[3],
                    a[0] ^ _xtime(a[1]) ^ _xtime(a[2]) ^ a[2] ^ a[3],
                    a[0] ^ a[1] ^ _xtime(a[2]) ^ _xtime(a[3]) ^ a[3],
                    _xtime(a[0]) ^ a[0] ^ a[1] ^ a[2] ^ _xtime(a[3]),
                ]
            s = ns
        s = [s[i] ^ rk[rnd][i] for i in range(16)]
    return bytes(s)


def _left_shift_block(b: bytes) -> bytes:
    n = int.from_bytes(b, "big") << 1
    out = n & ((1 << 128) - 1)
    return out.to_bytes(16, "big"), bool(n >> 128)


def aes_cmac(key: bytes, message: bytes) -> bytes:
    """AES-128-CMAC tag (16 bytes) per RFC 4493."""
    L = aes128_encrypt_block(key, b"\x00" * 16)
    k1, carry = _left_shift_block(L)
    if carry:
        k1 = (int.from_bytes(k1, "big") ^ 0x87).to_bytes(16, "big")
    k2, carry = _left_shift_block(k1)
    if carry:
        k2 = (int.from_bytes(k2, "big") ^ 0x87).to_bytes(16, "big")

    n = (len(message) + 15) // 16
    if n == 0:
        n, last_complete = 1, False
    else:
        last_complete = len(message) % 16 == 0
    if last_complete:
        last = bytes(a ^ b for a, b in zip(message[16 * (n - 1) :], k1))
    else:
        pad = message[16 * (n - 1) :] + b"\x80" + b"\x00" * 16
        last = bytes(a ^ b for a, b in zip(pad[:16], k2))

    x = b"\x00" * 16
    for i in range(n - 1):
        x = aes128_encrypt_block(
            key, bytes(a ^ b for a, b in zip(x, message[16 * i : 16 * i + 16]))
        )
    return aes128_encrypt_block(key, bytes(a ^ b for a, b in zip(x, last)))
