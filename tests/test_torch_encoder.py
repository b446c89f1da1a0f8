"""The port's encoder (the plain path of kernel K2), modem and channel
against the JAX package and the C++ reference's encoded blocks."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from polar_codes_tpu.models import detectors as jdet  # noqa: E402
from polar_codes_tpu.models.encoder import PolarEncoder as JaxEncoder  # noqa: E402
from polar_codes_tpu.dsp import channel as jchannel  # noqa: E402

from polar_codes_torch.construction import frozen_bits  # noqa: E402
from polar_codes_torch.dsp import Awgn, Bpsk, add_awgn, awgn_sigma  # noqa: E402
from polar_codes_torch.models import detectors as tdet  # noqa: E402
from polar_codes_torch.models.encoder import PolarEncoder  # noqa: E402
from polar_codes_torch.ops import butterfly_kernel  # noqa: E402
from polar_codes_tpu.ops.butterfly import (  # noqa: E402
    polar_transform_mxu as jax_transform_mxu,
)
from polar_codes_torch.ops.butterfly import (  # noqa: E402
    butterfly_transform,
    butterfly_transform_bipolar,
    polar_transform_mxu,
)

DATA = os.path.join(os.path.dirname(__file__), "data")


def _generator_matrix(n_len):
    """F^{(x)n} with F = [[1,0],[1,1]], no bit reversal: x = u @ G mod 2."""
    g = np.ones((1, 1), dtype=np.int64)
    while g.shape[0] < n_len:
        g = np.kron(g, np.array([[1, 0], [1, 1]]))
    return g


@pytest.mark.parametrize("n", [2, 8, 64, 256])
def test_butterfly_is_generator_matrix(n):
    rng = np.random.default_rng(n)
    u = rng.integers(0, 2, (16, n)).astype(np.uint8)
    want = (u.astype(np.int64) @ _generator_matrix(n)) % 2
    got = butterfly_transform(torch.as_tensor(u)).numpy()
    np.testing.assert_array_equal(got, want)
    bip = butterfly_transform_bipolar(torch.as_tensor(1.0 - 2.0 * u))
    np.testing.assert_array_equal(torch.signbit(bip).numpy(), want.astype(bool))
    np.testing.assert_array_equal(butterfly_transform(torch.as_tensor(got)).numpy(), u)


@pytest.mark.parametrize("n,k,systematic,crc", [
    (64, 32, True, "CRC8"), (64, 40, False, None), (256, 128, True, "CRC16"),
    (256, 100, False, "CRC16"), (1024, 512, True, "CRC16"),
])
def test_encode_equals_jax(n, k, systematic, crc):
    frozen = frozen_bits(n, k, 0.0)
    tdetector = getattr(tdet, crc)() if crc else None
    jdetector = getattr(jdet, crc)() if crc else None
    info = np.random.default_rng(k).integers(0, 2, (2, 3, k)).astype(np.uint8)
    enc = PolarEncoder(n, frozen, systematic=systematic, detector=tdetector,
                       device="cpu")
    jenc = JaxEncoder(n, frozen, systematic=systematic, detector=jdetector)
    got = enc.encode(torch.as_tensor(info))
    assert got.dtype == torch.uint8 and got.shape == (2, 3, n)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.jit(jenc.encode)(jnp.asarray(info))))
    np.testing.assert_array_equal(
        enc.inject(torch.as_tensor(info)).numpy(),
        np.asarray(jax.jit(jenc.inject)(jnp.asarray(info))))
    if systematic:  # the systematic codeword carries the (CRC'd) info
        sent = tdetector.generate(torch.as_tensor(info)) if crc else torch.as_tensor(info)
        np.testing.assert_array_equal(enc.extract(got).numpy(), sent.numpy())


@pytest.mark.parametrize("n", [4096, 8192])
def test_polar_transform_mxu_matches_jax(n):
    """The product form is bit-equal to the JAX package's and to the
    stage-by-stage butterfly."""
    u = np.random.default_rng(n).integers(0, 2, (4, n)).astype(np.uint8)
    got = polar_transform_mxu(torch.as_tensor(u))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_transform_mxu(jnp.asarray(u))))
    np.testing.assert_array_equal(got.to(torch.uint8).numpy(),
                                  butterfly_transform(torch.as_tensor(u)).numpy())


@pytest.mark.parametrize("systematic", [True, False])
def test_encode_above_2048_equals_jax(systematic):
    """N = 4096 CRC16 takes the product-form route in both packages."""
    n, k = 4096, 2048
    frozen = frozen_bits(n, k, 0.0)
    info = np.random.default_rng(int(systematic)).integers(0, 2, (3, k)).astype(np.uint8)
    enc = PolarEncoder(n, frozen, systematic=systematic, detector=tdet.CRC16(),
                       device="cpu")
    jenc = JaxEncoder(n, frozen, systematic=systematic, detector=jdet.CRC16(),
                      backend="pallas")
    got = enc.encode(torch.as_tensor(info))
    assert got.dtype == torch.uint8 and got.shape == (3, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jenc.encode(jnp.asarray(info))))
    if systematic:
        np.testing.assert_array_equal(
            enc.extract(got).numpy(), tdet.CRC16().generate(torch.as_tensor(info)).numpy())


def test_encode_matches_cpp_reference():
    """(256, 128) CRC8 systematic, as tests/test_crosscheck.py holds JAX."""
    def bits(name, cols):
        raw = np.fromfile(os.path.join(DATA, name), dtype=np.uint8)
        return np.unpackbits(raw).reshape(64, cols)

    enc = PolarEncoder(256, frozen_bits(256, 128, 0.0, "BB"), systematic=True,
                       detector=tdet.CRC8(), device="cpu")
    got = enc.encode(torch.as_tensor(bits("cc_info.bin", 128))).numpy()
    np.testing.assert_array_equal(got, bits("cc_encoded.bin", 256))


def test_encoder_checks_inputs():
    enc = PolarEncoder(64, frozen_bits(64, 32, 0.0), device="cpu")
    with pytest.raises(ValueError, match="expected 32"):
        enc.encode(torch.zeros(4, 31, dtype=torch.uint8))
    with pytest.raises(ValueError, match="power of 2"):
        PolarEncoder(48, [0], device="cpu")


def _fake_cuda(*shapes_dtypes):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return [torch.empty(s, dtype=d, device="cuda") for s, d in shapes_dtypes]


def test_encode_kernel_never_falls_back(monkeypatch):
    """A CUDA tensor reaches the kernel or raises; it never takes the
    plain version. Here there is no card and no nvcc, so it raises."""
    u, mask = _fake_cuda(((8, 64), torch.uint8), ((64,), torch.uint8))
    called = []
    monkeypatch.setattr(butterfly_kernel, "butterfly_encode_plain",
                        lambda *a: called.append(a))
    before = butterfly_kernel.LAUNCHES
    with pytest.raises((RuntimeError, OSError)):
        butterfly_kernel.butterfly_encode(u, mask, True)
    assert not called and butterfly_kernel.LAUNCHES == before
    with pytest.raises(NotImplementedError):  # N above the kernel's range
        big, big_mask = _fake_cuda(((2, 4096), torch.uint8), ((4096,), torch.uint8))
        butterfly_kernel.butterfly_encode(big, big_mask, True)


def test_bpsk_awgn():
    bits = torch.as_tensor(np.random.default_rng(1).integers(0, 2, (64, 256)), dtype=torch.uint8)
    modem = Bpsk()
    x = modem.modulate(bits)
    np.testing.assert_array_equal(x.numpy(), 1.0 - 2.0 * bits.numpy())
    assert modem.demodulate(x).dtype == torch.float32
    for esn0_db in (-2.0, 0.0, 3.0):
        assert awgn_sigma(esn0_db) == pytest.approx(float(jchannel.awgn_sigma(esn0_db)), rel=1e-6)
    y1 = add_awgn(x, torch.Generator().manual_seed(5), esn0_db=0.0)
    y2 = Awgn(0.0).transmit(x, torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(y1.numpy(), y2.numpy())  # same generator, same noise
    noise = (y1 - x).numpy()
    assert abs(noise.std() - awgn_sigma(0.0)) < 0.02 and abs(noise.mean()) < 0.02
