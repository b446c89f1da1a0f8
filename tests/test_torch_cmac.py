"""The port's CMAC detector against RFC 4493 and the JAX package: the AES-CMAC
vectors, truncated tags of every size on both engines, the detector
factories, and CA-SCL decodes whose list tail selects paths by the CMAC
check (the arm for a detector that is not affine). Tags, decisions and
flags must be equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from polar_codes_tpu.models import detectors as jdet  # noqa: E402
from polar_codes_tpu.models.scl import SCLDecoder as JaxSCLDecoder  # noqa: E402
from polar_codes_tpu.sim.cli import parse_detector as jax_parse_detector  # noqa: E402

from polar_codes_torch.construction import frozen_bits  # noqa: E402
from polar_codes_torch.models import detectors as tdet  # noqa: E402
from polar_codes_torch.models.encoder import PolarEncoder  # noqa: E402
from polar_codes_torch.models.scl import SCLDecoder  # noqa: E402
from polar_codes_torch.sim.cli import parse_detector  # noqa: E402
from polar_codes_torch.utils import hostcodec  # noqa: E402
from polar_codes_torch.utils.aes import aes_cmac  # noqa: E402

RFC_KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
RFC_MSG = bytes.fromhex(
    "6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"
    "30c81c46a35ce411e5fbc1191a0a52eff69f2445df4f9b17ad2b417be66c3710")
RFC_TAGS = {  # RFC 4493 section 4, examples 1-4
    0: "bb1d6929e95937287fa37d129b756746",
    16: "070a16b46b4d4144f79bdd9dd04a287c",
    40: "dfa66747de9ae63030ca32611497c827",
    64: "51f0bebf7e3b9d92fc49741779363cfe",
}


@pytest.mark.parametrize("length", sorted(RFC_TAGS))
def test_rfc4493_vectors(length):
    assert aes_cmac(RFC_KEY, RFC_MSG[:length]).hex() == RFC_TAGS[length]
    if hostcodec.cmac_available():
        msg = np.frombuffer(RFC_MSG[:length], np.uint8)[None, :]
        assert hostcodec.cmac_rows(RFC_KEY, msg)[0].tobytes().hex() == RFC_TAGS[length]


@pytest.mark.parametrize("engine", ["python", "libcrypto"])
@pytest.mark.parametrize("bits", [8, 16, 32, 64, 128])
def test_cmac_tags_equal_jax(bits, engine, monkeypatch):
    if engine == "python":
        monkeypatch.setattr(hostcodec, "cmac_rows", lambda key, msgs: None)
    elif not hostcodec.cmac_available():
        pytest.skip("the system libcrypto is not reachable through native/libhostcodec.so")
    rng = np.random.default_rng(bits)
    data = rng.integers(0, 2, (12, 160)).astype(np.uint8)
    got = tdet.CMAC(bits).tags_batch(data)
    np.testing.assert_array_equal(got, jdet.CMAC(bits).tags_batch(data))
    assert got.shape == (12, bits)
    block = torch.as_tensor(np.concatenate([data, np.zeros((12, bits), np.uint8)], 1))
    sent = tdet.CMAC(bits).generate(block)
    np.testing.assert_array_equal(
        sent.numpy(), np.asarray(jdet.CMAC(bits).generate(jnp.asarray(block.numpy()))))
    bad = sent.clone()
    bad[::3, 7] ^= 1
    ok = tdet.CMAC(bits).check(bad).numpy()
    np.testing.assert_array_equal(ok, np.asarray(jdet.CMAC(bits).check(jnp.asarray(bad.numpy()))))
    assert ok.tolist() == [i % 3 != 0 for i in range(12)]


def test_cmac_is_not_affine():
    det = tdet.CMAC(32)
    with pytest.raises(ValueError, match="not GF"):
        det.affine_map(64)
    with pytest.raises(ValueError, match="not GF"):
        det.check_matrix(64)
    with pytest.raises(ValueError, match="INVALID SIZE"):
        tdet.CMAC(24)
    assert tdet.detector_by_name("cmac16") == tdet.CMAC(16)
    assert tdet.detector_by_name("cmac") == tdet.CMAC(32)


SPECS = ["off", "none", "dummy", "0", "crc", "crc6nr", "crc8", "crc11nr", "crc16",
         "crc16nr", "CRC24NRC", "crc32", " crc8 ", "cmac", "cmac8", "cmac16", "cmac32",
         "cmac64", "cmac128", "crc12", "cmac24", "parity"]


def _describe(make):
    try:
        det = make()
    except ValueError as e:
        return ("ValueError", str(e))
    return (type(det).__name__, det.bits, det.tail_bits)


@pytest.mark.parametrize("spec", SPECS)
def test_parse_detector_equals_jax(spec):
    assert _describe(lambda: parse_detector(spec)) == _describe(lambda: jax_parse_detector(spec))


@pytest.mark.parametrize("size,kind", [(s, k) for s in (0, 6, 8, 11, 16, 24, 32, 64, 128)
                                       for k in ("crc", "crcnr", "CMAC", "aes")])
def test_make_detector_equals_jax(size, kind):
    assert (_describe(lambda: tdet.make_detector(size, kind))
            == _describe(lambda: jdet.make_detector(size, kind)))


@pytest.mark.parametrize("systematic", [True, False])
def test_cmac_list_decode_equals_jax(systematic):
    """CA-SCL-8 (64, 32) with CMAC16: info bits, codewords and flags equal
    to the JAX decoder's; the CMAC check moved the choice away from the
    best-metric path on some blocks, and both flags occur."""
    n_len, k_len, batch = 64, 32, 96
    frozen = frozen_bits(n_len, k_len, 0.0)
    det = tdet.CMAC(16)
    enc = PolarEncoder(n_len, frozen, systematic=systematic, detector=det, device="cpu")
    rng = np.random.default_rng(16)
    info = torch.as_tensor(rng.integers(0, 2, (batch, k_len)).astype(np.uint8))
    code = enc.encode(info)
    noise = rng.normal(0.0, 1.0, (batch, n_len)).astype(np.float32)
    llr = ((1.0 - 2.0 * code.numpy().astype(np.float32)) + 0.9 * noise) * 2.0
    dec = SCLDecoder(n_len, frozen, list_size=8, systematic=systematic, detector=det,
                     device="cpu")
    got = dec.decode(torch.as_tensor(llr))
    jdec = JaxSCLDecoder(n_len, frozen, list_size=8, systematic=systematic,
                         detector=jdet.CMAC(16))
    want = jdec.decode(jnp.asarray(llr))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ok = got[2].numpy()
    assert ok.any() and not ok.all()
    codewords, metrics, _ = dec.decode_paths(torch.as_tensor(llr))
    ml = codewords[torch.arange(batch), metrics.argmax(-1)]
    assert (ml != got[1]).any(-1).sum() > 0


def test_cmac_large_scl_decode_equals_jax():
    """LargeSCLDecoder inherits the tail: (128, 64) CA-SCL-4 with CMAC16 in
    chunks of 32, equal to the JAX decoder (its XLA arm)."""
    from polar_codes_tpu.models.large import LargeSCLDecoder as JaxLargeSCL
    from polar_codes_torch.models.large import LargeSCLDecoder

    n_len, k_len, batch = 128, 64, 32
    frozen = frozen_bits(n_len, k_len, 0.0)
    enc = PolarEncoder(n_len, frozen, detector=tdet.CMAC(16), device="cpu")
    rng = np.random.default_rng(1)
    info = torch.as_tensor(rng.integers(0, 2, (batch, k_len)).astype(np.uint8))
    noise = rng.normal(size=(batch, n_len)).astype(np.float32)
    llr = ((1.0 - 2.0 * enc.encode(info).numpy().astype(np.float32)) + 0.9 * noise) * 2.0
    got = LargeSCLDecoder(n_len, frozen, list_size=4, detector=tdet.CMAC(16), chunk=32,
                          device="cpu").decode(torch.as_tensor(llr))
    want = JaxLargeSCL(n_len, frozen, list_size=4, detector=jdet.CMAC(16), chunk=32,
                       backend="xla", unroll=1).decode(jnp.asarray(llr))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].any() and not got[2].all()
