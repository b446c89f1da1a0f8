"""Error detection: the polynomial CRC family as GF(2) affine maps.

Mirrors polar_codes_tpu/models/detectors.py. For each (detector, data
length) the host derives, from the LFSR recurrence, a generator matrix
G [tail, D] and constant g0 [tail] with tail = G.data + g0 (mod 2). On the
device, checksum generation and checking are then GF(2) products mod 2,
computed in int32 (one masked parity per tail bit), so no float matmul and
no TF32 setting can touch them.

Ported: Dummy, CRC8, CRC16 (CCITT-FALSE), CRC32 (CRC-32C, reflected,
little-endian tail), the 5G NR CRC6/11/16/24C, and AES-128-CMAC, which is
not affine: its tags are computed on the host (libcrypto through
utils/hostcodec.py, else the pure-Python engine of utils/aes.py).
"""

from __future__ import annotations

import functools
import time
from typing import Dict, Tuple

import numpy as np
import torch


def crc_msb_first(bits, poly: int, width: int, init: int) -> int:
    """Non-reflected CRC over a {0,1} bit stream (host reference)."""
    mask = (1 << width) - 1
    top = 1 << (width - 1)
    reg = init & mask
    for b in np.asarray(bits, dtype=np.uint8):
        fb = ((reg & top) != 0) ^ int(b)
        reg = (reg << 1) & mask
        if fb:
            reg ^= poly
    return reg


def crc32c_bytes(data: bytes, init: int = 0) -> int:
    """Reflected CRC-32C over bytes, init and xor-out 0 (chained
    _mm_crc32_u32; host reference)."""
    poly_ref = 0x82F63B78
    reg = init & 0xFFFFFFFF
    for byte in data:
        reg ^= byte
        for _ in range(8):
            reg = (reg >> 1) ^ (poly_ref if reg & 1 else 0)
    return reg


def _int_to_bits(value: int, width: int) -> np.ndarray:
    """MSB-first bit vector of an integer."""
    return np.array(
        [(value >> (width - 1 - i)) & 1 for i in range(width)], dtype=np.uint8
    )


def _cols_to_matrix(cols, width: int) -> np.ndarray:
    """List of int states -> [width, D] GF(2) matrix (MSB-first rows)."""
    return np.stack([_int_to_bits(c, width) for c in cols], axis=1).astype(np.uint8)


def _parity_rows(x: torch.Tensor, rows: np.ndarray) -> torch.Tensor:
    """[..., D] {0,1} and host rows [T, D] {0,1} -> [..., T] int32 parities
    of (rows @ x) mod 2, one masked sum per row."""
    xi = x.to(torch.int32)
    r = torch.as_tensor(rows.astype(np.int32), device=x.device)
    cols = [((xi & r[t]).sum(-1) & 1) for t in range(r.shape[0])]
    return torch.stack(cols, dim=-1).to(torch.int32)


class Detector:
    """Base detector: `bits` checksum value bits; `tail_bits` the bits it
    occupies at the tail of the info block (whole bytes)."""

    bits: int = 0
    tail_bits: int = 0
    name: str = "dummy"

    # ---- host reference (1-D NumPy) -----------------------------------

    def compute_np(self, data_bits: np.ndarray) -> np.ndarray:
        """Tail-layout checksum bits for a 1-D {0,1} data-bit array."""
        raise NotImplementedError

    def generate_np(self, block_bits: np.ndarray) -> np.ndarray:
        out = np.asarray(block_bits, dtype=np.uint8).copy()
        if self.tail_bits == 0:
            return out
        d = out.shape[-1] - self.tail_bits
        out[d:] = self.compute_np(out[:d])
        return out

    def check_np(self, block_bits: np.ndarray) -> bool:
        """True when a 1-D block's tail equals the checksum of its data
        bits (always, without a tail)."""
        block_bits = np.asarray(block_bits, dtype=np.uint8)
        if self.tail_bits == 0:
            return True
        d = block_bits.shape[-1] - self.tail_bits
        return bool(np.array_equal(self.compute_np(block_bits[:d]), block_bits[d:]))

    # ---- GF(2) affine map ---------------------------------------------

    def _is_linear(self) -> bool:
        return True

    def value_affine(self, data_len: int) -> Tuple[np.ndarray, np.ndarray]:
        """(M [bits, D], m0 [bits]): checksum value bits = M.data + m0."""
        raise NotImplementedError

    def _place(self, value: int) -> np.ndarray:
        """Tail bit layout of a checksum value (linear)."""
        raise NotImplementedError

    def _place_matrix(self) -> np.ndarray:
        """[tail_bits, bits] placement of value bits into the tail layout."""
        P = np.zeros((self.tail_bits, self.bits), dtype=np.uint8)
        for b in range(self.bits):
            P[:, b] = self._place(1 << (self.bits - 1 - b))
        return P

    @functools.lru_cache(maxsize=None)
    def affine_map(self, data_len: int) -> Tuple[np.ndarray, np.ndarray]:
        """(G [tail, D], g0 [tail]): tail bits = G.data + g0 (mod 2)."""
        if not self._is_linear():
            raise ValueError(f"{self.name} is not GF(2)-affine; host-side only")
        M, m0 = self.value_affine(data_len)
        P = self._place_matrix()
        return (P @ M) % 2, (P @ m0) % 2

    def check_matrix(self, data_len: int) -> Tuple[np.ndarray, np.ndarray]:
        """(A [tail, D + tail], g0): a block x checks iff A.x + g0 = 0."""
        G, g0 = self.affine_map(data_len)
        A = np.concatenate([G, np.eye(self.tail_bits, dtype=np.uint8)], axis=1)
        return A, g0

    # ---- batched tensor ops -------------------------------------------

    def generate(self, block_bits: torch.Tensor) -> torch.Tensor:
        """[..., K] {0,1} -> [..., K] with the checksum in the tail."""
        if self.tail_bits == 0:
            return block_bits
        d = block_bits.shape[-1] - self.tail_bits
        G, g0 = self.affine_map(d)
        par = _parity_rows(block_bits[..., :d], G)
        tail = par ^ torch.as_tensor(g0.astype(np.int32), device=block_bits.device)
        return torch.cat([block_bits[..., :d], tail.to(block_bits.dtype)], dim=-1)

    def check(self, block_bits: torch.Tensor) -> torch.Tensor:
        """[..., K] {0,1} -> bool [...]."""
        if self.tail_bits == 0:
            return torch.ones(block_bits.shape[:-1], dtype=torch.bool,
                              device=block_bits.device)
        A, g0 = self.check_matrix(block_bits.shape[-1] - self.tail_bits)
        syn = _parity_rows(block_bits, A) ^ torch.as_tensor(
            g0.astype(np.int32), device=block_bits.device)
        return (syn == 0).all(dim=-1)

    def __hash__(self):  # lru_cache on methods needs a hashable self
        return hash((type(self).__name__, self.bits, self.tail_bits))

    def __eq__(self, other):
        return type(self) is type(other) and self.bits == other.bits


class Dummy(Detector):
    """Always-valid detector."""

    def compute_np(self, data_bits):
        return np.zeros(0, dtype=np.uint8)


class _PolyCrc(Detector):
    """Non-reflected polynomial CRC with a byte-aligned big-endian tail."""

    poly = 0
    init = 0

    def compute_np(self, data_bits: np.ndarray) -> np.ndarray:
        return self._place(crc_msb_first(data_bits, self.poly, self.bits, self.init))

    def _place(self, value: int) -> np.ndarray:
        out = np.zeros(self.tail_bits, dtype=np.uint8)
        out[self.tail_bits - self.bits :] = _int_to_bits(value, self.bits)
        return out

    def value_affine(self, data_len: int) -> Tuple[np.ndarray, np.ndarray]:
        """One LFSR step is s' = L(s) ^ d*poly with the linear
        L(s) = (s<<1) ^ (msb(s) ? poly : 0); over D bits
        crc = L^D(init) + sum_i d_i * L^(D-1-i)(poly)."""
        w, poly, mask = self.bits, self.poly, (1 << self.bits) - 1
        top = 1 << (w - 1)

        def L(s: int) -> int:
            out = (s << 1) & mask
            if s & top:
                out ^= poly
            return out

        cols = [0] * data_len
        cur = poly & mask
        for i in range(data_len - 1, -1, -1):
            cols[i] = cur
            cur = L(cur)
        const = self.init & mask
        for _ in range(data_len):
            const = L(const)
        return _cols_to_matrix(cols, w), _int_to_bits(const, w)


class CRC8(_PolyCrc):
    """CRC-8, poly 0x07, init 0."""

    bits, tail_bits, poly, init, name = 8, 8, 0x07, 0, "crc8"


class CRC16(_PolyCrc):
    """CRC-16 CCITT-FALSE: 0x1021, init 0xFFFF."""

    bits, tail_bits, poly, init, name = 16, 16, 0x1021, 0xFFFF, "crc16"


class CRC6NR(_PolyCrc):
    """TS 38.212 gCRC6: 0x21, init 0; one tail byte."""

    bits, tail_bits, poly, init, name = 6, 8, 0x21, 0, "crc6nr"


class CRC11NR(_PolyCrc):
    """TS 38.212 gCRC11: 0x621, init 0; two tail bytes."""

    bits, tail_bits, poly, init, name = 11, 16, 0x621, 0, "crc11nr"


class CRC16NR(_PolyCrc):
    """TS 38.212 gCRC16: 0x1021, init 0."""

    bits, tail_bits, poly, init, name = 16, 16, 0x1021, 0, "crc16nr"


class CRC24NRC(_PolyCrc):
    """TS 38.212 gCRC24C: 0xB2B117, init 0; three tail bytes."""

    bits, tail_bits, poly, init, name = 24, 24, 0xB2B117, 0, "crc24nrc"


class CRC32(Detector):
    """CRC-32C over little-endian uint32 words, init 0, no xor-out, the
    checksum stored as a little-endian uint32 at the tail. The word
    traversal equals the byte-stream reflected CRC-32C, so the data length
    must be a multiple of 32 bits."""

    bits, tail_bits, name = 32, 32, "crc32"
    _POLY_REF = 0x82F63B78

    def compute_np(self, data_bits: np.ndarray) -> np.ndarray:
        data_bits = np.asarray(data_bits, dtype=np.uint8)
        if len(data_bits) % 32:
            raise ValueError("CRC32 requires a data length that is a multiple of 32 bits")
        return self._place(crc32c_bytes(np.packbits(data_bits).tobytes()))

    def _place(self, value: int) -> np.ndarray:
        """Little-endian byte order, each byte MSB-first in the bit stream."""
        out = np.zeros(32, dtype=np.uint8)
        for byte_idx in range(4):
            byte = (value >> (8 * byte_idx)) & 0xFF
            out[byte_idx * 8 : (byte_idx + 1) * 8] = _int_to_bits(byte, 8)
        return out

    def value_affine(self, data_len: int) -> Tuple[np.ndarray, np.ndarray]:
        """Reflected byte step s' = R8(s ^ byte). Bit j of the MSB-first
        stream enters byte j // 8 as 1 << (7 - j % 8), so its column is
        R8^(bytes - j // 8) of that embedding; init 0 gives no constant.
        The map needs whole bytes (the checksum itself, whole words)."""
        if data_len % 8:
            raise ValueError("the CRC32 affine map requires whole bytes")
        pr = self._POLY_REF

        def r8(s: int) -> int:
            for _ in range(8):
                s = (s >> 1) ^ (pr if s & 1 else 0)
            return s

        cols = [0] * data_len
        vecs = [r8(1 << (7 - m)) for m in range(8)]  # the last byte
        for k in range(data_len // 8 - 1, -1, -1):
            cols[k * 8 : k * 8 + 8] = vecs
            vecs = [r8(v) for v in vecs]
        return _cols_to_matrix(cols, 32), np.zeros(32, dtype=np.uint8)


class CMAC(Detector):
    """AES-128-CMAC (RFC 4493) truncated to its first `bits` bits, with the
    reference's fixed key, as in the JAX package. It is not GF(2)-affine,
    so affine_map and check_matrix raise. generate and check take tensors
    on any device: they copy the data bits to the host, compute the tags
    there and return the result on the caller's device (the JAX package
    does the same through pure_callback). `host_seconds` adds up the time
    those calls take, copies included."""

    name = "cmac"

    DEFAULT_KEY = bytes(
        [0x8E, 0x73, 0xB0, 0xF7, 0xDA, 0x0E, 0x64, 0x52,
         0xC8, 0x10, 0xF3, 0x2B, 0x80, 0x90, 0x79, 0xE5]
    )

    def __init__(self, bits: int = 32, key: bytes = DEFAULT_KEY):
        if bits not in (8, 16, 32, 64, 128):
            raise ValueError("CMAC INVALID SIZE!")
        self.bits = bits
        self.tail_bits = bits
        self._key = key
        self.host_seconds = 0.0

    def _is_linear(self) -> bool:
        return False

    @property
    def engine(self) -> str:
        """The engine that computes the tags: "libcrypto" or "python"."""
        from ..utils import hostcodec

        return "libcrypto" if hostcodec.cmac_available() else "python"

    def compute_np(self, data_bits: np.ndarray) -> np.ndarray:
        data_bits = np.asarray(data_bits, dtype=np.uint8)
        return self.tags_batch(data_bits[None, :])[0]

    def tags_batch(self, data_bits: np.ndarray) -> np.ndarray:
        """[R, D] {0,1} data bits -> [R, tail_bits] tag bits, in one
        libcrypto call for all rows, else row by row in pure Python."""
        data_bits = np.asarray(data_bits, dtype=np.uint8)
        if data_bits.shape[-1] % 8:
            raise ValueError("CMAC operates on whole bytes")
        msgs = np.packbits(data_bits, axis=-1)
        from ..utils import hostcodec

        tags = hostcodec.cmac_rows(self._key, msgs)
        if tags is None:
            from ..utils.aes import aes_cmac

            tags = np.stack([
                np.frombuffer(aes_cmac(self._key, row.tobytes()), np.uint8)
                for row in msgs
            ])
        tag_bits = np.unpackbits(tags, axis=-1)
        return tag_bits[:, : self.tail_bits].astype(np.uint8)

    def _host_rows(self, block_bits: torch.Tensor):
        """[..., K] tensor -> ([rows, K] uint8 host array, data length)."""
        flat = block_bits.detach().to("cpu", torch.uint8).reshape(-1, block_bits.shape[-1])
        return flat.numpy(), block_bits.shape[-1] - self.tail_bits

    def generate(self, block_bits: torch.Tensor) -> torch.Tensor:
        """[..., K] {0,1} -> [..., K] with the tag in the tail."""
        t0 = time.perf_counter()
        flat, d = self._host_rows(block_bits)
        out = flat.copy()
        out[:, d:] = self.tags_batch(flat[:, :d])
        res = torch.from_numpy(out).reshape(block_bits.shape).to(
            block_bits.device, block_bits.dtype)
        self.host_seconds += time.perf_counter() - t0
        return res

    def check(self, block_bits: torch.Tensor) -> torch.Tensor:
        """[..., K] {0,1} -> bool [...]: the tail equals the tag."""
        t0 = time.perf_counter()
        flat, d = self._host_rows(block_bits)
        ok = np.all(self.tags_batch(flat[:, :d]) == flat[:, d:], axis=-1)
        res = torch.from_numpy(ok).reshape(block_bits.shape[:-1]).to(block_bits.device)
        self.host_seconds += time.perf_counter() - t0
        return res

    def __hash__(self):
        return hash(("cmac", self.bits, self._key))

    def __eq__(self, other):
        return (isinstance(other, CMAC) and self.bits == other.bits
                and self._key == other._key)


_CRC_REGISTRY: Dict[int, type] = {
    0: Dummy,
    6: CRC6NR,
    8: CRC8,
    11: CRC11NR,
    16: CRC16,
    24: CRC24NRC,
    32: CRC32,
}


def make_detector(size: int = 0, kind: str = "crc") -> Detector:
    """String-keyed factory, as the JAX package's: kind contains "crc"
    ("nr" too selects the 5G variant at size 16) or "cmac"; the sizes are
    the reference's."""
    kind_l = kind.lower()
    if "crc" in kind_l:
        if size not in _CRC_REGISTRY:
            raise ValueError("CRC INVALID SIZE!")
        if size == 16 and "nr" in kind_l:
            return CRC16NR()
        return _CRC_REGISTRY[size]()
    if "cmac" in kind_l:
        return CMAC(size)
    raise ValueError("Unknown Error detector requested!")


_BY_NAME: Dict[str, type] = {
    cls.name: cls
    for cls in (Dummy, CRC8, CRC16, CRC32, CRC6NR, CRC11NR, CRC16NR, CRC24NRC)
}


def detector_by_name(name: str) -> Detector:
    """The detector whose `name` attribute is `name` (e.g. "crc16"); a
    CMAC as "cmac" (32 bits) or "cmac<bits>" (e.g. "cmac16")."""
    if name.startswith("cmac"):
        return CMAC(int(name[4:] or 32))
    if name not in _BY_NAME:
        raise ValueError(f"unknown detector {name!r}")
    return _BY_NAME[name]()
