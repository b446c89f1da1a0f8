"""The port's modems and channels against the reference's ASK fixtures and
the JAX package: ASK modulate/demodulate value-exact (tests/data/ask_*.bin,
bps 2 and 3, and random bits with padding at bps 3), Rayleigh and Scale
equal to the JAX formulas on the same numpy draws within 1e-6, AWGN's
float32 arithmetic bit-equal, and the generator draw order."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from polar_codes_tpu.dsp import channel as jchannel  # noqa: E402
from polar_codes_tpu.dsp import modem as jmodem  # noqa: E402

from polar_codes_torch import dsp  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bps", [2, 3])
def test_ask_matches_reference_fixtures(bps):
    bits = np.fromfile(os.path.join(DATA, "ask_bits.bin"), np.float32).astype(np.uint8)
    want = np.fromfile(os.path.join(DATA, f"ask_mod_bps{bps}.bin"), np.float32)
    got = dsp.ask_modulate(torch.as_tensor(bits), bps).numpy()
    np.testing.assert_array_equal(got, want)
    rx = np.fromfile(os.path.join(DATA, f"ask_rx_bps{bps}.bin"), np.float32)
    want = np.fromfile(os.path.join(DATA, f"ask_demod_bps{bps}.bin"), np.float32)
    got = dsp.Ask(bps).demodulate(torch.as_tensor(rx)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bps,n_bits", [(1, 64), (2, 64), (3, 64), (3, 66), (4, 64)])
@pytest.mark.parametrize("normalize", [True, False])
def test_ask_equals_jax(bps, n_bits, normalize):
    rng = np.random.default_rng(bps * 100 + n_bits)
    bits = rng.integers(0, 2, (5, n_bits)).astype(np.uint8)
    sym = dsp.ask_modulate(torch.as_tensor(bits), bps, normalize).numpy()
    np.testing.assert_array_equal(
        sym, np.asarray(jmodem.ask_modulate(jnp.asarray(bits), bps, normalize)))
    assert sym.shape == (5, -(-n_bits // bps))
    rx = (sym + 0.3 * rng.normal(size=sym.shape)).astype(np.float32)
    soft = dsp.ask_demodulate(torch.as_tensor(rx), bps, normalize).numpy()
    np.testing.assert_array_equal(
        soft, np.asarray(jmodem.ask_demodulate(jnp.asarray(rx), bps, normalize)))
    assert soft.shape == (5, sym.shape[1] * bps)  # pad metrics included


def test_ask_hard_round_trip():
    bits = torch.as_tensor(np.random.default_rng(3).integers(0, 2, (4, 96)).astype(np.uint8))
    for bps in (1, 2, 3, 4):
        soft = dsp.Ask(bps).demodulate(dsp.Ask(bps).modulate(bits))
        assert torch.equal((soft < 0).to(torch.uint8), bits)
    assert isinstance(dsp.Bpsk(), dsp.Modem) and isinstance(dsp.Ask(2), dsp.Modem)


@pytest.mark.parametrize("esn0", [0.25, 1.0, 3.7])
def test_rayleigh_equals_jax_formula(esn0):
    rng = np.random.default_rng(int(esn0 * 10))
    x = (1.0 - 2.0 * rng.integers(0, 2, (6, 40))).astype(np.float32)
    g = rng.normal(size=(6, 40, 2)).astype(np.float32)
    noise = rng.normal(size=(6, 40)).astype(np.float32)
    got = dsp.rayleigh_from(torch.as_tensor(x), torch.as_tensor(g), torch.as_tensor(noise),
                            esn0).numpy()
    fade = jnp.sqrt(jnp.sum(jnp.asarray(g) * jnp.asarray(g), axis=-1))
    sigma = 1.0 / jnp.sqrt(jnp.float32(esn0))
    want = np.asarray(jnp.asarray(x) * fade + sigma * jnp.asarray(noise))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("esn0", [0.25, 1.0, 3.7])
def test_awgn_equals_jax_bit_for_bit(esn0):
    rng = np.random.default_rng(int(esn0 * 10) + 1)
    x = (1.0 - 2.0 * rng.integers(0, 2, (6, 40))).astype(np.float32)
    noise = rng.normal(size=(6, 40)).astype(np.float32)
    got = dsp.awgn_from(torch.as_tensor(x), torch.as_tensor(noise), esn0).numpy()
    sigma = jchannel.awgn_sigma(esn0_linear=jnp.float32(esn0))
    want = np.asarray(jnp.asarray(x) + sigma * jnp.asarray(noise))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("factor", [1.0, 10.0, 0.37])
def test_scale_equals_jax(factor):
    x = np.random.default_rng(1).normal(size=(3, 17)).astype(np.float32)
    got = dsp.Scale(factor).transmit(torch.as_tensor(x)).numpy()
    want = np.asarray(jchannel.Scale(factor).transmit(None, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)


def test_channels_draw_from_the_generator_in_order():
    """apply_rayleigh draws the fade [..., 2], then the noise; add_awgn the
    noise; the Transmitter objects wrap them."""
    x = torch.ones(4, 10)
    y = dsp.apply_rayleigh(x, torch.Generator().manual_seed(9), esn0_linear=2.0)
    gen = torch.Generator().manual_seed(9)
    fade = torch.randn((4, 10, 2), generator=gen)
    noise = torch.randn((4, 10), generator=gen)
    assert torch.equal(y, dsp.rayleigh_from(x, fade, noise, 2.0))
    chan = dsp.Rayleigh()
    chan.set_esn0_linear(2.0)
    assert torch.equal(chan.transmit(x, torch.Generator().manual_seed(9)), y)
    noise = torch.randn((4, 10), generator=torch.Generator().manual_seed(4))
    assert torch.equal(dsp.add_awgn(x, torch.Generator().manual_seed(4), esn0_linear=2.0),
                       dsp.awgn_from(x, noise, 2.0))
    for cls in (dsp.Awgn, dsp.Rayleigh, dsp.Scale):
        assert issubclass(cls, dsp.Transmitter)
