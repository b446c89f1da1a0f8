"""The port's pypolar facade (polar_codes_torch.pypolar, device="cpu")
against the JAX package's pypolar on the same NumPy inputs made from a
seed: frozen bits, the detectors, the packed-byte encoder (systematic or
not, one vector or a batch, the checksum written back into the caller's
buffer), decode_vector for every type string and list size on noisy LLRs
(packed bytes equal), the routes each type string takes, the errors and
defaults, and the puncturer. The large-N route is in
tests/test_torch_pypolar_large.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import pypolar as jp  # noqa: E402

from polar_codes_torch import pypolar as tp  # noqa: E402

SEED = 20261029
N_LEN, K_LEN = 128, 64


def _rng(*salt):
    return np.random.default_rng([SEED, *salt])


def _noisy_llrs(code_bytes, ebn0_db, salt):
    """BPSK over AWGN at Eb/N0 for rate K/N: float32 channel LLRs."""
    cw = np.unpackbits(code_bytes, axis=-1).astype(np.float64)
    sigma = np.sqrt(1.0 / (2.0 * K_LEN / N_LEN * 10.0 ** (ebn0_db / 10.0)))
    y = (1.0 - 2.0 * cw) + sigma * _rng(salt).standard_normal(cw.shape)
    return (2.0 * y / sigma ** 2).astype(np.float32)


# ---- frozen bits and strategies ----------------------------------------------

@pytest.mark.parametrize("ctor", ["BB", "BE", "GA", "5G"])
@pytest.mark.parametrize("n_len,k_len,dsnr", [(256, 100, 1.0), (128, 64, 0.0)])
def test_frozen_bits_equal_pypolar(ctor, n_len, k_len, dsnr):
    got = tp.frozen_bits(n_len, k_len, dsnr, ctor)
    assert got == jp.frozen_bits(n_len, k_len, dsnr, ctor)
    assert all(type(i) is int for i in got) and len(got) == n_len - k_len


def test_frozen_bit_generator_equals_pypolar():
    for name in ("BB", "GA"):
        ours = tp.get_frozen_bit_generator(name, 128, 64, 1.0)
        theirs = jp.get_frozen_bit_generator(name, 128, 64, 1.0)
        np.testing.assert_array_equal(ours.frozen_bit_positions(), theirs.frozen_bit_positions())


# ---- Detector ------------------------------------------------------------------

DETECTORS = [(8, "crc"), (16, "crc"), (32, "crc"), (6, "crc"), (11, "crc"), (16, "crcnr"),
             (24, "crc"), (32, "cmac"), (0, "crc")]


def _both_raise(call_ours, call_theirs):
    with pytest.raises(Exception) as ours:
        call_ours()
    with pytest.raises(Exception) as theirs:
        call_theirs()
    assert type(ours.value) is type(theirs.value) and str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("size,kind", DETECTORS)
def test_detector_equals_pypolar(size, kind):
    ours, theirs = tp.Detector(size, kind), jp.Detector(size, kind)
    assert ours.getCheckBitCount() == theirs.getCheckBitCount() == size
    assert ours.getType() == theirs.getType()
    rng = _rng(1, size, len(kind))
    data = rng.integers(0, 256, 12).astype(np.uint8)
    for bitsize in (96, 64, 61, 33, 8):
        if size == 0:
            break
        if bitsize % 8 and (kind == "cmac" or size == 32):  # whole bytes only
            _both_raise(lambda: ours.calculate(data, bitsize),
                        lambda: theirs.calculate(data, bitsize))
            continue
        value = ours.calculate(data, bitsize)
        assert isinstance(value, int) and value == theirs.calculate(data, bitsize)
    _both_raise(lambda: ours.calculate(data, 97), lambda: theirs.calculate(data, 97))
    blob = ours.generate(data[:8])
    np.testing.assert_array_equal(blob, theirs.generate(data[:8]))
    assert blob.size == 8 + (size + 7) // 8
    assert ours.check(blob) is True and theirs.check(blob) is True
    bad = blob.copy()
    bad[3] ^= 0x10
    assert ours.check(bad) is theirs.check(bad) is (size == 0)
    _both_raise(lambda: ours.check(blob[None]), lambda: theirs.check(blob[None]))


def test_detector_values_pin_the_reference():
    assert tp.Detector(8).calculate(np.frombuffer(b"123456789", np.uint8), 72) == 0xF4
    det = tp.Detector(32)
    reg = 0
    for byte in b"12345678":  # raw CRC-32C chain, init 0, no xor-out
        reg ^= byte
        for _ in range(8):
            reg = (reg >> 1) ^ (0x82F63B78 if reg & 1 else 0)
    assert det.calculate(np.frombuffer(b"12345678", np.uint8), 64) == reg


# ---- PolarEncoder ------------------------------------------------------------------

@pytest.mark.parametrize("systematic", [True, False])
@pytest.mark.parametrize("crc", [0, 8, 16, 32])
def test_encode_vector_equals_pypolar(systematic, crc):
    frozen = jp.frozen_bits(N_LEN, K_LEN, 0.0)
    ours, theirs = tp.PolarEncoder(N_LEN, frozen, device="cpu"), jp.PolarEncoder(N_LEN, frozen)
    for enc in (ours, theirs):
        enc.setSystematic(systematic)
        if crc:
            enc.setErrorDetection(crc)
    assert ours.getErrorDetectionMode() == theirs.getErrorDetectionMode()
    assert (ours.blockLength(), ours.infoLength(), ours.frozenBits(), ours.isSystematic()) == \
        (theirs.blockLength(), theirs.infoLength(), theirs.frozenBits(), theirs.isSystematic())
    info = _rng(2, crc, systematic).integers(0, 256, (6, K_LEN // 8)).astype(np.uint8)
    # one vector: the checksum goes back into the caller's buffer in both
    mine, yours = info[0].copy(), info[0].copy()
    single = ours.encode_vector(mine)
    np.testing.assert_array_equal(single, theirs.encode_vector(yours))
    np.testing.assert_array_equal(mine, yours)
    assert (not crc) == np.array_equal(mine, info[0])
    assert ours.duration_ns() > 0
    # a batch: equal to pypolar's vectors one by one, buffer written likewise
    batch = info.copy()
    out = ours.encode_vector(batch)
    rows = []
    for r in range(info.shape[0]):
        row = info[r].copy()
        rows.append(theirs.encode_vector(row))
        np.testing.assert_array_equal(batch[r], row)
    np.testing.assert_array_equal(out, np.stack(rows))
    if not systematic:
        return
    info_pos = np.setdiff1d(np.arange(N_LEN), frozen)  # systematic: info in the codeword
    np.testing.assert_array_equal(np.unpackbits(out, axis=-1)[:, info_pos],
                                  np.unpackbits(batch, axis=-1))


def test_encode_batch_with_a_checksum_departs_from_pypolar():
    """pypolar's vector routine refuses a batch when a checksum is on; the
    port encodes it (the rows equal pypolar's vectors, above)."""
    frozen = jp.frozen_bits(N_LEN, K_LEN, 0.0)
    theirs = jp.PolarEncoder(N_LEN, frozen)
    theirs.setErrorDetection(8)
    with pytest.raises(TypeError):
        theirs.encode_vector(np.zeros((2, K_LEN // 8), np.uint8))


def test_encoder_checks_and_copies_like_pypolar():
    frozen = jp.frozen_bits(N_LEN, K_LEN, 0.0)
    ours, theirs = tp.PolarEncoder(N_LEN, frozen, device="cpu"), jp.PolarEncoder(N_LEN, frozen)
    _both_raise(lambda: ours.encode_vector(np.zeros(3, np.uint8)),
                lambda: theirs.encode_vector(np.zeros(3, np.uint8)))
    for enc in (ours, theirs):
        enc.setErrorDetection(16)
    info = _rng(3).integers(0, 256, K_LEN // 8).astype(np.uint8)
    as_list = [int(v) for v in info]  # not a uint8 ndarray: nothing to write back
    np.testing.assert_array_equal(ours.encode_vector(as_list), theirs.encode_vector(as_list))
    ro = info.copy()
    ro.flags.writeable = False
    np.testing.assert_array_equal(ours.encode_vector(ro), theirs.encode_vector(ro))
    np.testing.assert_array_equal(ro, info)


@pytest.mark.parametrize("shape", [(), (3,)])
def test_crc32_refuses_a_data_length_off_32_bit_words_like_pypolar(shape):
    """K = 72 leaves 40 data bits: whole bytes, but not whole words."""
    k = 72
    frozen = jp.frozen_bits(N_LEN, k, 0.0)
    ours, theirs = tp.PolarEncoder(N_LEN, frozen, device="cpu"), jp.PolarEncoder(N_LEN, frozen)
    for enc in (ours, theirs):
        enc.setErrorDetection(32)
    info = _rng(4).integers(0, 256, shape + (k // 8,)).astype(np.uint8)
    with pytest.raises(ValueError, match="multiple of 32"):
        ours.encode_vector(info.copy())
    if not shape:  # pypolar's vector routine; it refuses a batch for another reason
        with pytest.raises(ValueError, match="multiple of 32"):
            theirs.encode_vector(info.copy())


def test_default_device_is_the_card():
    frozen = tp.frozen_bits(64, 32, 0.0)
    if torch.cuda.is_available():
        assert tp.PolarDecoder(64, 2, frozen, "float")._device.type == "cuda"
        assert tp.PolarEncoder(64, frozen)._device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.PolarDecoder(64, 2, frozen, "float")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.PolarEncoder(64, frozen)


# ---- PolarDecoder ----------------------------------------------------------------

@pytest.fixture(scope="module")
def channel():
    """(frozen, sent info bytes with their CRC8, noisy LLRs) at (128, 64),
    Eb/N0 = 1 dB: 48 blocks, some of them decoded wrong on every route."""
    frozen = jp.frozen_bits(N_LEN, K_LEN, 0.0)
    enc = tp.PolarEncoder(N_LEN, frozen, device="cpu")
    enc.setErrorDetection(8)
    info = _rng(4).integers(0, 256, (48, K_LEN // 8)).astype(np.uint8)
    code = enc.encode_vector(info)
    return frozen, info, _noisy_llrs(code, 1.0, 5)


@pytest.mark.parametrize("kind", ["float", "char", "mixed", "scan"])
@pytest.mark.parametrize("list_size", [1, 2, 8])
def test_decode_vector_equals_pypolar(channel, kind, list_size):
    frozen, sent, llr = channel
    ours = tp.PolarDecoder(N_LEN, list_size, frozen, kind, device="cpu")
    theirs = jp.PolarDecoder(N_LEN, list_size, frozen, kind)
    for dec in (ours, theirs):
        dec.setErrorDetection(8)
    got = ours.decode_vector(llr)
    assert got.dtype == np.uint8 and got.shape == (llr.shape[0], K_LEN // 8)
    np.testing.assert_array_equal(got, theirs.decode_vector(llr))
    wrong = int((got != sent).any(axis=1).sum())
    assert 0 < wrong < 3 * llr.shape[0] // 4
    np.testing.assert_array_equal(ours.decode_vector(llr[3]), got[3])  # one vector
    assert ours.duration_ns() > 0
    assert (ours.listSize(), ours.blockLength(), ours.infoLength(), ours.frozenBits(),
            ours.isSystematic()) == (theirs.listSize(), theirs.blockLength(),
                                     theirs.infoLength(), theirs.frozenBits(),
                                     theirs.isSystematic())


@pytest.mark.parametrize("kind,list_size,crc,n_len,route", [
    ("float", 8, 8, 128, "SCLDecoder"), ("char", 4, 8, 128, "SCLDecoder"),
    ("mixed", 8, 8, 128, "AdaptiveDecoder"), ("mixed", 8, 0, 128, "SCLDecoder"),
    ("scan", 4, 8, 128, "ScanDecoder"), ("float", 1, 8, 128, "FastSSCDecoder"),
    ("mixed", 1, 8, 128, "FastSSCDecoder"), ("scan", 1, 8, 128, "FastSSCDecoder"),
    ("char", 1, 8, 128, "FastSSCDecoder"), ("float", 1, 8, 1024, "LargeSCDecoder"),
    ("char", 8, 16, 1024, "LargeSCLDecoder"), ("scan", 4, 8, 1024, "LargeSCLDecoder"),
])
def test_routes_equal_pypolar(monkeypatch, kind, list_size, crc, n_len, route):
    """The decoder each type string, list size and length builds, with the
    large-N threshold lowered to 512 in both facades."""
    monkeypatch.setattr(tp, "_LARGE_N_THRESHOLD", 512)
    monkeypatch.setattr(jp, "_LARGE_N_THRESHOLD", 512)
    frozen = jp.frozen_bits(n_len, n_len // 2, 0.0)
    ours = tp.PolarDecoder(n_len, list_size, frozen, kind, device="cpu")
    theirs = jp.PolarDecoder(n_len, list_size, frozen, kind)
    for dec in (ours, theirs):
        dec.setErrorDetection(crc)
    a, b = ours._build(), theirs._build()
    assert type(a).__name__ == type(b).__name__ == route
    if hasattr(a, "dtype") and hasattr(b, "dtype"):
        assert str(a.dtype).replace("torch.", "") == str(np.dtype(b.dtype))
    assert getattr(a, "list_size", 1) == getattr(b, "list_size", 1)
    assert getattr(a, "iterations", 1) == getattr(b, "iterations", 1)
    assert a.detector.name == b.detector.name and a.systematic == b.systematic


def test_decoder_errors_and_defaults_equal_pypolar():
    frozen = jp.frozen_bits(64, 32, 0.0)
    _both_raise(lambda: tp.PolarDecoder(64, 1, [0, 1], "quantum", device="cpu"),
                lambda: jp.PolarDecoder(64, 1, [0, 1], "quantum"))
    ours = tp.PolarDecoder(64, 4, frozen, "float", device="cpu")
    assert ours.getErrorDetectionMode() == jp.PolarDecoder(64, 4, frozen, "float") \
        .getErrorDetectionMode() == "crc8"
    _both_raise(lambda: ours.decode_vector(np.zeros(63, np.float32)),
                lambda: jp.PolarDecoder(64, 4, frozen, "float").decode_vector(
                    np.zeros(63, np.float32)))
    ours.setErrorDetection(16, "crcnr")
    assert ours.getErrorDetectionMode() == "crc16nr"
    ours.setSystematic(False)
    assert not ours.isSystematic() and not ours._build().systematic


# ---- Puncturer ----------------------------------------------------------------------

@pytest.mark.parametrize("block_length,info_length", [(1000, 500), (200, 64)])
def test_puncturer_equals_pypolar(block_length, info_length):
    parent = 1 << (block_length - 1).bit_length()
    frozen = jp.frozen_bits(parent, info_length, 0.0)
    ours, theirs = tp.Puncturer(block_length, frozen), jp.Puncturer(block_length, frozen)
    assert (ours.blockLength(), ours.parentBlockLength(), ours.blockOutputPositions()) == \
        (theirs.blockLength(), theirs.parentBlockLength(), theirs.blockOutputPositions())
    rng = _rng(6, block_length)
    full = rng.standard_normal((3, parent)).astype(np.float32)
    for x in (full, full[0]):
        np.testing.assert_array_equal(ours.puncture(x), theirs.puncture(x))
    short = ours.puncture(full)
    back = ours.depuncture(short)
    np.testing.assert_array_equal(back, theirs.depuncture(short))
    assert back.dtype == short.dtype and back.shape == full.shape
    packed = rng.integers(0, 256, (3, parent // 8)).astype(np.uint8)
    got = ours.puncturePacked(packed)
    np.testing.assert_array_equal(got, theirs.puncturePacked(packed))
    np.testing.assert_array_equal(ours.depuncturePacked(got), theirs.depuncturePacked(got))
    np.testing.assert_array_equal(ours.puncturePacked(ours.depuncturePacked(got)), got)
    for call in ("puncture", "puncturePacked", "depuncture"):
        _both_raise(lambda: getattr(ours, call)(np.zeros(7, np.uint8)),
                    lambda: getattr(theirs, call)(np.zeros(7, np.uint8)))
