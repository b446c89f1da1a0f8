"""The port's NumPy tools (polar_codes_torch/tools/) against the JAX
package's, on numpy-seeded inputs: GF(2) matrices and bit reversal, noise
calibration, the frozen-bit strategies, 5G NR rate matching and its
inverse in every mode, and the tree as text. Tolerance: none (the same
NumPy arithmetic in both)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from polar_codes_tpu import tools as jtools  # noqa: E402

from polar_codes_torch import tools  # noqa: E402
from polar_codes_torch.models.encoder import PolarEncoder  # noqa: E402
from polar_codes_torch.models.tree import build_tree  # noqa: E402


def test_code_tools_match_jax():
    for n_len in (2, 8, 64):
        np.testing.assert_array_equal(tools.polar_generator_matrix(n_len),
                                      jtools.polar_generator_matrix(n_len))
        frozen = tools.get_frozen_bit_generator("BB", n_len, n_len // 2).frozen_bit_positions()
        for name in ("frozen_indices_to_map", "info_indices_from_frozen"):
            np.testing.assert_array_equal(getattr(tools, name)(frozen, n_len),
                                          getattr(jtools, name)(frozen, n_len))
        np.testing.assert_array_equal(tools.systematic_encoder_matrix(n_len, frozen),
                                      jtools.systematic_encoder_matrix(n_len, frozen))
    for width in (1, 5, 10):
        np.testing.assert_array_equal(tools.bit_reversed_vector(width),
                                      jtools.bit_reversed_vector(width))
        assert tools.bit_reverse(3, width) == jtools.bit_reverse(3, width)


def test_systematic_matrix_is_the_port_encoder():
    n_len, k_len = 64, 40
    frozen = tools.FrozenBitPositionsBB(n_len, k_len).frozen_bit_positions()
    info = np.random.default_rng(1).integers(0, 2, (16, k_len)).astype(np.uint8)
    enc = PolarEncoder(n_len, frozen, systematic=True, device="cpu")
    want = enc.encode(torch.as_tensor(info)).numpy()
    np.testing.assert_array_equal((info @ tools.systematic_encoder_matrix(n_len, frozen)) % 2,
                                  want)


def test_channel_tools_match_jax():
    ebn0 = np.linspace(-1.0, 6.0, 8)
    for rate, order in ((0.5, 1), (0.25, 2)):
        np.testing.assert_array_equal(tools.ebn0_to_sigma(ebn0, rate, order),
                                      jtools.ebn0_to_sigma(ebn0, rate, order))
        sigma = tools.ebn0_to_sigma(ebn0, rate, order)
        np.testing.assert_array_equal(tools.sigma_to_ebn0(sigma, rate, order),
                                      jtools.sigma_to_ebn0(sigma, rate, order))
        np.testing.assert_array_equal(tools.ebn0_to_esn0_linear(ebn0, rate, order),
                                      jtools.ebn0_to_esn0_linear(ebn0, rate, order))


@pytest.mark.parametrize("kind", ["BB", "BE", "PW", "GA", "5G"])
def test_strategies_match_jax(kind):
    for n_len, k_len in ((64, 32), (256, 100)):
        got = tools.get_frozen_bit_generator(kind, n_len, k_len, 1.0)
        want = jtools.get_frozen_bit_generator(kind, n_len, k_len, 1.0)
        assert type(got).__name__ == type(want).__name__
        np.testing.assert_array_equal(got.frozen_bit_positions(), want.frozen_bit_positions())
        np.testing.assert_array_equal(got.info_bit_positions(), want.info_bit_positions())
    with pytest.raises(ValueError, match="unknown frozen-bit strategy"):
        tools.get_frozen_bit_generator("XX", 64, 32)


@pytest.mark.parametrize("n_len,e_len,mode", [
    (64, 48, "puncture"), (64, 48, "shorten"), (128, 128, "puncture"), (64, 150, "puncture"),
    (256, 200, "shorten")])
def test_nr_rate_matching_matches_jax(n_len, e_len, mode):
    rng = np.random.default_rng(n_len + e_len)
    code = rng.integers(0, 2, (3, n_len)).astype(np.uint8)
    np.testing.assert_array_equal(tools.nr_subblock_interleave(code),
                                  jtools.nr_subblock_interleave(code))
    sent = tools.nr_rate_match(code, e_len, mode)
    np.testing.assert_array_equal(sent, jtools.nr_rate_match(code, e_len, mode))
    llr = (1.0 - 2.0 * sent) * rng.uniform(0.5, 3.0, sent.shape)
    back = tools.nr_rate_recover(llr, n_len, mode)
    np.testing.assert_array_equal(back, jtools.nr_rate_recover(llr, n_len, mode))
    known = back != 0 if mode == "puncture" else back < 1e9
    np.testing.assert_array_equal((back < 0)[known], code.astype(bool)[known])
    with pytest.raises(ValueError, match="rate-match mode"):
        tools.nr_rate_match(code, n_len // 2, "other")
    with pytest.raises(ValueError, match="multiple of 32"):
        tools.nr_subblock_interleave(np.zeros(48))


def test_render_tree_text_matches_jax():
    for n_len, k_len, constructor in ((64, 32, "BB"), (128, 80, "5G")):
        text = tools.render_tree_text(n_len, k_len, 0.0, constructor)
        assert text == jtools.render_tree_text(n_len, k_len, 0.0, constructor)
        lines = text.splitlines()
        assert lines[0] == f"branch[0:{n_len}]" and len(lines) == _count(n_len, k_len, constructor)


def _count(n_len, k_len, constructor):
    from polar_codes_torch.construction import frozen_bits

    tree = build_tree(n_len, frozen_bits(n_len, k_len, 0.0, constructor))
    stack, nodes = [tree], 0
    while stack:
        node = stack.pop()
        nodes += 1
        if node.left is not None:
            stack += [node.left, node.right]
    return nodes
