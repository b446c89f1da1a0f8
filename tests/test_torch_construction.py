"""The port's host-side code and elementwise rules against the JAX package:
frozen sets of every construction (BB, BE, 5G, GA, and DE through the
dispatch; tests/test_torch_density_evolution.py holds DE's grid), code
trees, f/g, and the CRC family's generate/check. Frozen sets must be
equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from polar_codes_tpu.construction import Construction as JaxConstruction  # noqa: E402
from polar_codes_tpu.construction import frozen_bits as jax_frozen_bits  # noqa: E402
from polar_codes_tpu.construction import split_frozen_bits as jax_split_frozen_bits  # noqa: E402
from polar_codes_tpu.models import detectors as jdet  # noqa: E402
from polar_codes_tpu.models.tree import build_tree as jax_build_tree  # noqa: E402
from polar_codes_tpu.ops import fg as jfg  # noqa: E402

from polar_codes_torch.construction import (  # noqa: E402
    Construction, frozen_bits, info_indices, split_frozen_bits)
from polar_codes_torch.models import detectors as tdet  # noqa: E402
from polar_codes_torch.models.tree import build_tree  # noqa: E402
from polar_codes_torch.ops import fg as tfg  # noqa: E402

GRID = [(n, k, snr) for n in (16, 64, 256, 1024) for k in (n // 4, n // 2, 3 * n // 4)
        for snr in (-1.0, 0.0, 2.5)]


@pytest.mark.parametrize("n,k,snr", GRID)
def test_bb_frozen_bits_equal(n, k, snr):
    got = frozen_bits(n, k, snr, "BB")
    np.testing.assert_array_equal(got, jax_frozen_bits(n, k, snr, "BB"))
    assert got.size == n - k
    np.testing.assert_array_equal(
        info_indices(n, got), np.setdiff1d(np.arange(n), got))


@pytest.mark.parametrize("method", ["BE", "5G", "GA"])
@pytest.mark.parametrize("n,k,snr", GRID)
def test_other_frozen_bits_equal(method, n, k, snr):
    got = frozen_bits(n, k, snr, method)
    np.testing.assert_array_equal(got, jax_frozen_bits(n, k, snr, method))
    assert got.size == n - k


@pytest.mark.parametrize("name", [
    "BB", "bb", "Bhattacharyya", "BE", "beta", "5G", "5g-nr", "GA", "gauss", "DE",
    "tv", "TalVardy", "unknown"])
def test_frozen_bits_substring_dispatch(name, monkeypatch):
    monkeypatch.delenv("AFF3CT_TV_PATH", raising=False)
    np.testing.assert_array_equal(frozen_bits(64, 40, 1.0, name),
                                  jax_frozen_bits(64, 40, 1.0, name))


def test_split_frozen_bits_and_enum_equal():
    frozen = frozen_bits(64, 32, 0.0)
    for got, want in zip(split_frozen_bits(frozen, 32), jax_split_frozen_bits(frozen, 32)):
        np.testing.assert_array_equal(got, want)
    assert [c.value for c in Construction] == [c.value for c in JaxConstruction]


def _flatten(node):
    """(kind, offset, length, frozen) per node, pre-order."""
    out = [(node.kind.value, node.offset, node.length, tuple(node.frozen.tolist()))]
    if node.left is not None:
        out += _flatten(node.left) + _flatten(node.right)
    return out


@pytest.mark.parametrize("n,k,enum_span,max_enum_k", [
    (1024, 512, 16, 4), (1024, 512, 0, 0), (256, 128, 16, 4), (256, 160, 8, 3),
    (64, 32, 8, 3), (128, 40, 16, 5),
])
def test_trees_equal(n, k, enum_span, max_enum_k):
    frozen = frozen_bits(n, k, 0.0)
    got = _flatten(build_tree(n, frozen, enum_span=enum_span, max_enum_k=max_enum_k))
    want = _flatten(jax_build_tree(n, frozen, enum_span=enum_span,
                                   max_enum_k=max_enum_k))
    assert got == want


def test_main_path_tree_meets_every_leaf_kind():
    tree = build_tree(1024, frozen_bits(1024, 512, 0.0), enum_span=16, max_enum_k=4)
    kinds = {leaf.kind.value for leaf in tree.leaves()}
    assert kinds == {"rate0", "rate1", "rep", "spc", "enum"}
    assert max(leaf.length for leaf in tree.leaves()) <= 512


def _all_pairs():
    vals = np.array([0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 2.5, -2.5, 1e-30, -1e30,
                     3.0, -3.0, 7.25], dtype=np.float32)
    a, b = np.meshgrid(vals, vals, indexing="ij")
    return a.ravel(), b.ravel()


def test_f_minsum_bits_equal_all_pairs():
    a, b = _all_pairs()
    got = tfg.f_minsum_bits(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    want = np.asarray(jfg.f_minsum_bits(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_f_minsum_equal_all_pairs_and_zero_trap():
    a, b = _all_pairs()
    got = tfg.f_minsum(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    want = np.asarray(jfg.f_minsum(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # at exact zeros jnp.sign keeps the sign of -0.0 (torch.sign does not):
    # both forms give a zero with the XOR of the inputs' sign bits
    for form in (tfg.f_minsum, tfg.f_minsum_bits):
        z = form(torch.tensor([-0.0, 0.0, -0.0]), torch.tensor([2.0, -2.0, -0.0]))
        assert torch.signbit(z).tolist() == [True, True, False]


def test_g_update_equal_all_pairs():
    a, b = _all_pairs()
    for u in (1.0, -1.0):
        uu = np.full_like(a, u)
        got = tfg.g_update(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(uu))
        want = jfg.g_update(jnp.asarray(a), jnp.asarray(b), jnp.asarray(uu))
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))


CRCS = ["CRC8", "CRC16", "CRC6NR", "CRC11NR", "CRC16NR", "CRC24NRC", "Dummy"]


@pytest.mark.parametrize("name", CRCS)
def test_crc_generate_check_equal(name):
    rng = np.random.default_rng(7)
    tdetector, jdetector = getattr(tdet, name)(), getattr(jdet, name)()
    blocks = rng.integers(0, 2, (64, 120)).astype(np.uint8)
    got = tdetector.generate(torch.as_tensor(blocks)).numpy()
    want = np.asarray(jdetector.generate(jnp.asarray(blocks)))
    np.testing.assert_array_equal(got, want)
    if tdetector.tail_bits:
        G, g0 = tdetector.affine_map(120 - tdetector.tail_bits)
        JG, jg0 = jdetector.affine_map(120 - tdetector.tail_bits)
        np.testing.assert_array_equal(G, JG)
        np.testing.assert_array_equal(g0, jg0)
        np.testing.assert_array_equal(got[3], tdetector.generate_np(blocks[3]))
    corrupt = got.copy()
    corrupt[::2, 5] ^= 1
    for x in (got, corrupt):
        np.testing.assert_array_equal(
            tdetector.check(torch.as_tensor(x)).numpy(),
            np.asarray(jdetector.check(jnp.asarray(x))))
    assert tdetector.check(torch.as_tensor(got)).all()
