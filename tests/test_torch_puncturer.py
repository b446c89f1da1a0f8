"""The port's puncturer (models/puncturer.py) against the JAX package's:
positions, puncture, depuncture with the default and another fill, and
the packed form equal for several (M, K) codes on numpy-seeded inputs;
the same ValueErrors."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from polar_codes_tpu.models.puncturer import Puncturer as JaxPuncturer  # noqa: E402
from polar_codes_tpu.models.puncturer import round_up_power_of_two as jround  # noqa: E402

from polar_codes_torch.construction import frozen_bits  # noqa: E402
from polar_codes_torch.models.puncturer import Puncturer, round_up_power_of_two  # noqa: E402

CODES = [(1000, 500), (96, 40), (200, 120), (64, 32), (1, 0)]


@pytest.mark.parametrize("m_len,k_len", CODES)
def test_puncturer_matches_jax(m_len, k_len):
    parent = round_up_power_of_two(m_len)
    assert parent == jround(m_len)
    frozen = frozen_bits(parent, k_len, 0.0, "BB")
    p, jp = Puncturer(m_len, frozen), JaxPuncturer(m_len, frozen)
    assert p.parent_block_length == jp.parent_block_length
    np.testing.assert_array_equal(p.output_positions, jp.output_positions)
    np.testing.assert_array_equal(p.punctured_positions, jp.punctured_positions)
    rng = np.random.default_rng(m_len)
    llr = rng.standard_normal((5, parent)).astype(np.float32)
    punct = p.puncture(torch.as_tensor(llr))
    np.testing.assert_array_equal(punct.numpy(), np.asarray(jp.puncture(jnp.asarray(llr))))
    assert punct.shape == (5, m_len)
    for fill in (0, 7.5):
        got = p.depuncture(punct, fill_value=fill)
        want = jp.depuncture(jnp.asarray(punct.numpy()), fill_value=fill)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.float32
    bits = torch.as_tensor(rng.integers(0, 2, (3, parent)), dtype=torch.uint8)
    back = p.depuncture(p.puncture(bits))
    assert back.dtype == torch.uint8 and torch.equal(back[:, p.output_positions],
                                                     bits[:, p.output_positions])
    if m_len % 8 == 0 and parent % 8 == 0:
        packed = rng.integers(0, 256, (4, parent // 8)).astype(np.uint8)
        np.testing.assert_array_equal(p.puncture_packed(packed), jp.puncture_packed(packed))


def test_puncturer_raises_as_jax():
    frozen = frozen_bits(1024, 1000, 0.0, "BB")  # 24 frozen, 1024 - 1000 = 24 punctured
    Puncturer(1000, frozen)
    for cls in (Puncturer, JaxPuncturer):
        with pytest.raises(ValueError, match="exceeds frozen"):
            cls(999, frozen)
    p, jp = Puncturer(1000, frozen), JaxPuncturer(1000, frozen)
    with pytest.raises(ValueError, match="expected 1000 values, got 1024"):
        p.depuncture(torch.zeros(2, 1024))
    with pytest.raises(ValueError, match="expected 1000 values, got 1024"):
        jp.depuncture(jnp.zeros((2, 1024)))
    odd, jodd = Puncturer(1001, frozen), JaxPuncturer(1001, frozen)
    for q in (odd, jodd):
        with pytest.raises(ValueError, match="byte-aligned"):
            q.puncture_packed(np.zeros(128, np.uint8))
