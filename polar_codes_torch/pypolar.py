"""pypolar's Python surface over the port.

The counterpart of the JAX package's `pypolar` facade, which mirrors the
reference library's pybind11 module: `PolarEncoder`, `PolarDecoder`,
`Detector`, `Puncturer`, `frozen_bits` and `get_frozen_bit_generator`, with
the same constructor signatures, method names, packed-byte conventions
(np.packbits, MSB first), RuntimeError messages and decoder type strings
("char", "float", "mixed", "scan"), the decoder's default CRC8 and its
float fallback below two paths. Single-vector calls are the reference's
interface; every method also takes a batch as a 2-D array.

Two departures from the JAX facade:
- the decoder's fifth constructor argument `backend` becomes the keyword
  `device`, which the encoder takes too: the card by default, "cpu" for
  the plain versions. Without a card the default raises; nothing falls
  back to the CPU on its own.
- there is no jit: the facade calls the port's models and reads their
  results back into NumPy, which waits for the card before duration_ns is
  taken.

    from polar_codes_torch import pypolar
    f = pypolar.frozen_bits(1024, 512, 0.0)
    dec = pypolar.PolarDecoder(1024, 8, f, "float")   # K1 on the card
    dec.setErrorDetection(16)
    info_bytes = dec.decode_vector(llrs)              # [B, 1024] -> [B, 64]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .construction import frozen_bits as _frozen_bits
from .models import detectors as _det
from .models.adaptive import AdaptiveDecoder
from .models.encoder import PolarEncoder as _Encoder
from .models.fastssc import FastSSCDecoder
from .models.large import LargeSCDecoder, LargeSCLDecoder
from .models.puncturer import Puncturer as _Puncturer
from .models.scan import ScanDecoder
from .models.scl import SCLDecoder
from .tools.strategies import get_frozen_bit_generator
from .utils import hostcodec
from .utils.device import DEFAULT_DEVICE, resolve_device

# Above this block length PolarDecoder takes the chunked large-N decoders
# (models/large.py). The threshold is the JAX facade's, kept so that the
# decoders that both facades pick stay the same, and with them the bits.
_LARGE_N_THRESHOLD = 16384

__all__ = [
    "PolarEncoder",
    "PolarDecoder",
    "Detector",
    "Puncturer",
    "frozen_bits",
    "get_frozen_bit_generator",
]


def frozen_bits(blockLength, infoLength, designSNR, constructorType="BB"):
    """Frozen-bit positions as a sorted list of ints."""
    return [int(i) for i in
            _frozen_bits(blockLength, infoLength, designSNR, constructorType)]


def _as_1d_uint8(array):
    a = np.asarray(array, dtype=np.uint8)
    if a.ndim != 1:
        raise RuntimeError("Only ONE-dimensional vectors allowed!")
    return a


class Detector:
    """Error detection on packed bytes (the reference's ErrorDetection)."""

    def __init__(self, size, type="crc"):
        self._d = _det.make_detector(size, type)

    def getCheckBitCount(self):
        return self._d.bits

    def getType(self):
        """The family string: "CRC" for crc8/16/32, "CRCNR" for the 5G NR
        CRCs, "CMAC", "DUMMY"."""
        name = self._d.name
        if "cmac" in name:
            return "CMAC"
        if "dummy" in name:
            return "DUMMY"
        return "CRCNR" if "nr" in name else "CRC"

    def calculate(self, data, bitsize):
        """The checksum value over the first `bitsize` bits of `data`."""
        bits = np.unpackbits(np.asarray(data, dtype=np.uint8))
        if bits.size < bitsize:
            raise RuntimeError(
                "Provided number of bits is smaller than stated significant bits!")
        bits = bits[:bitsize]
        d = self._d
        if isinstance(d, _det.CRC32):
            if bitsize % 8:
                raise RuntimeError("CRC32 operates on whole bytes")
            return hostcodec.crc32c_bytes(np.packbits(bits).tobytes())
        if isinstance(d, _det.CMAC):
            return int("".join(map(str, d.compute_np(bits))), 2)
        return hostcodec.crc_msb_first(bits, d.poly, d.bits, d.init)

    def generate(self, data):
        """`data` with its checksum bytes appended."""
        data = _as_1d_uint8(data)
        out = np.concatenate([data, np.zeros((self._d.bits + 7) // 8, np.uint8)])
        return np.packbits(self._d.generate_np(np.unpackbits(out)))

    def check(self, data):
        return bool(self._d.check_np(np.unpackbits(_as_1d_uint8(data))))


class PolarEncoder:
    """Systematic packed-byte encoder; K2 on the card up to N = 2048, the
    product form of the transform above."""

    def __init__(self, blockLength, frozenBitPositions, *, device=DEFAULT_DEVICE):
        self._n = int(blockLength)
        self._frozen = sorted(int(i) for i in frozenBitPositions)
        self._device = resolve_device(device)
        self._systematic = True
        self._detector = _det.Dummy()
        self._enc = None
        self._duration_ns = 0

    # -- config --

    def blockLength(self):
        return self._n

    def infoLength(self):
        return self._n - len(self._frozen)

    def setSystematic(self, flag):
        self._systematic = bool(flag)
        self._enc = None

    def isSystematic(self):
        return self._systematic

    def frozenBits(self):
        return list(self._frozen)

    def setErrorDetection(self, size=0, type="crc"):
        self._detector = _det.make_detector(size, type)
        self._enc = None

    def getErrorDetectionMode(self):
        return self._detector.name

    # -- encoding --

    def _build(self):
        if self._enc is None:
            data = self.infoLength() - self._detector.tail_bits
            if isinstance(self._detector, _det.CRC32) and data % 32:
                # the reference's CRC32 runs over 32-bit words: any other
                # data length is refused, as the JAX facade's host routine
                # refuses it, for one vector and a batch alike
                raise ValueError("CRC32 requires a data length that is a multiple of 32 bits")
            self._enc = _Encoder(self._n, self._frozen, systematic=self._systematic,
                                 detector=self._detector, device=self._device)
        return self._enc

    def duration_ns(self):
        """Wall-clock ns of the last encode_vector call, from the packed
        input to the packed codeword read back from the device."""
        return self._duration_ns

    def encode_vector(self, info_bytes):
        """uint8[K/8] packed info -> uint8[N/8] packed codeword; also
        uint8[batch, K/8].

        With error detection on, the checksum is written back into the
        caller's info buffer where the reference's binding would have handed
        it the buffer itself (1-D or 2-D uint8, C-contiguous, writeable,
        K a multiple of 8): the reference's decoder tests depend on it."""
        enc = self._build()
        t0 = time.perf_counter_ns()
        arr = np.asarray(info_bytes, dtype=np.uint8)
        if arr.ndim == 1 and arr.size != enc.info_length // 8:
            raise RuntimeError("Input vector size != infoSize // 8!")
        bits = np.unpackbits(arr, axis=-1)[..., : enc.info_length]
        u = torch.from_numpy(np.ascontiguousarray(bits)).to(self._device)
        if self._detector.tail_bits:
            u = self._detector.generate(u)  # the checksum on the device
            if (isinstance(info_bytes, np.ndarray)
                    and info_bytes.dtype == np.uint8
                    and info_bytes.flags.c_contiguous
                    and info_bytes.flags.writeable
                    and enc.info_length % 8 == 0):
                info_bytes[...] = np.packbits(u.cpu().numpy(), axis=-1).reshape(info_bytes.shape)
        code = enc.encode(u, generate_crc=False)  # the tail already holds the checksum
        out = np.packbits(code.cpu().numpy(), axis=-1)
        self._duration_ns = time.perf_counter_ns() - t0
        return out


class PolarDecoder:
    """Decoder by type string; the routes are the JAX facade's (see _build)."""

    def __init__(self, blockLength, listSize, frozenBitPositions, decoderType, *,
                 device=DEFAULT_DEVICE):
        self._n = int(blockLength)
        self._list = int(listSize)
        self._frozen = sorted(int(i) for i in frozenBitPositions)
        t = decoderType.lower()
        if "char" in t:
            self._flag = 0
        elif "float" in t:
            self._flag = 1
        elif "mixed" in t:
            self._flag = 2
        elif "scan" in t:
            self._flag = 3
        else:
            raise RuntimeError("Unknown PolarDecoder type!")
        if self._list < 2 and self._flag != 0:
            self._flag = 1
        self._device = resolve_device(device)
        self._systematic = True
        self._detector = _det.CRC8()  # the reference factory's default
        self._dec = None
        self._duration_ns = 0

    def blockLength(self):
        return self._n

    def infoLength(self):
        return self._n - len(self._frozen)

    def listSize(self):
        return self._list

    def setSystematic(self, flag):
        self._systematic = bool(flag)
        self._dec = None

    def isSystematic(self):
        return self._systematic

    def frozenBits(self):
        return list(self._frozen)

    def setErrorDetection(self, size=0, type="crc"):
        self._detector = _det.make_detector(size, type)
        self._dec = None

    def getErrorDetectionMode(self):
        return self._detector.name

    def _build(self):
        """The port's decoder for this type string, list size and length:
        flag 0 is the reference's char family (int8), 1 float, 2 mixed
        (the adaptive decoder where a checksum exists, else float), 3 SCAN
        with L iterations."""
        if self._dec is not None:
            return self._dec
        n, frozen, lst = self._n, self._frozen, self._list
        kw = dict(systematic=self._systematic, detector=self._detector, device=self._device)
        if n > _LARGE_N_THRESHOLD:
            dtype = torch.int8 if self._flag == 0 else torch.float32
            if lst == 1:
                self._dec = LargeSCDecoder(n, frozen, dtype=dtype, **kw)
            else:
                self._dec = LargeSCLDecoder(n, frozen, list_size=lst, dtype=dtype, **kw)
        elif lst == 1:
            dtype = torch.float32 if self._flag == 1 else torch.int8
            self._dec = FastSSCDecoder(n, frozen, dtype=dtype, **kw)
        elif self._flag == 3:
            self._dec = ScanDecoder(n, frozen, iterations=lst, **kw)
        elif self._flag == 2 and self._detector.tail_bits:
            self._dec = AdaptiveDecoder(n, frozen, list_size=lst, **kw)
        else:
            dtype = torch.int8 if self._flag == 0 else torch.float32
            self._dec = SCLDecoder(n, frozen, list_size=lst, dtype=dtype, **kw)
        return self._dec

    def duration_ns(self):
        """Wall-clock ns of the last decode_vector call, from the LLRs to
        the packed info bits read back from the device."""
        return self._duration_ns

    def decode_vector(self, llrs):
        """float32/int8 [N] channel LLRs -> uint8[K/8] packed info bits;
        also [batch, N]. Positive LLR = bit 0. The char family takes
        clip(round(llr), -127, 127) as int8."""
        dec = self._build()
        t0 = time.perf_counter_ns()
        arr = np.asarray(llrs)
        if arr.shape[-1] != self._n:
            raise RuntimeError("Input vector size != blockSize!")
        if getattr(dec, "dtype", None) == torch.int8:
            arr = np.clip(np.round(arr), -127, 127).astype(np.int8)
        else:
            arr = arr.astype(np.float32)
        info, _, _ = dec.decode(torch.from_numpy(arr).to(self._device))
        out = np.packbits(info.cpu().numpy(), axis=-1)
        self._duration_ns = time.perf_counter_ns() - t0
        return out


class Puncturer:
    """Rate matcher on host arrays (the reference's Puncturer binding)."""

    def __init__(self, blockLength, frozenBitPositions):
        self._p = _Puncturer(blockLength, [int(i) for i in frozenBitPositions])

    def blockLength(self):
        return self._p.block_length

    def parentBlockLength(self):
        return self._p.parent_block_length

    def blockOutputPositions(self):
        return [int(i) for i in self._p.output_positions]

    def puncture(self, array):
        arr = np.asarray(array)
        if arr.shape[-1] != self._p.parent_block_length:
            raise RuntimeError("Input vector size != parentBlockSize!")
        return arr[..., self._p.output_positions]

    def puncturePacked(self, array):
        arr = np.asarray(array, dtype=np.uint8)
        if arr.shape[-1] != self._p.parent_block_length // 8:
            raise RuntimeError("Input vector size != parentBlockSize!")
        return self._p.puncture_packed(arr)

    def depuncture(self, array):
        arr = np.asarray(array)
        if arr.shape[-1] != self._p.block_length:
            raise RuntimeError("Input vector size != blockSize!")
        out = np.zeros(arr.shape[:-1] + (self._p.parent_block_length,), dtype=arr.dtype)
        out[..., self._p.output_positions] = arr
        return out

    def depuncturePacked(self, array):
        arr = np.asarray(array, dtype=np.uint8)
        bits = np.unpackbits(arr, axis=-1)[..., : self._p.block_length]
        return np.packbits(self.depuncture(bits), axis=-1)
