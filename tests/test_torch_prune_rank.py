"""The masked-SCL chunk kernel's prune by rank (ops/large_kernel.py
prune_by_rank, the CPU twin of K7's prune) against the iterative prune of
the plain version (_Plain(L, drop=_NEG).prune), which follows the TPU
kernel's extraction order and its re-take rule.

Inputs are made with numpy from a seed: random values, forced ties
(integer values and equal metrics), -0.0 against +0.0, rows with 0, 1 and
L - 1 live paths (the others at _NEG), and the frozen-leaf deltas
{min(x, 0), _NEG}; list sizes 1 to 64, powers of two and not. Tolerance:
none; values, src and cand are equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from polar_codes_torch.ops.large_kernel import _NEG, prune_by_rank  # noqa: E402
from polar_codes_torch.ops.scl_kernel_bl import _Plain  # noqa: E402

COLS = 48  # codewords per case


def _cases(n_list, n_cand, rng):
    """(name, metrics [L, B], deltas [C, L, B]) float32 arrays."""
    shape_m, shape_d = (n_list, COLS), (n_cand, n_list, COLS)
    gauss_m = rng.standard_normal(shape_m).astype(np.float32)
    gauss_d = -np.abs(rng.standard_normal(shape_d)).astype(np.float32)
    gauss_d[0] = 0.0
    ints_m = rng.integers(-3, 1, shape_m).astype(np.float32)
    ints_d = rng.integers(-2, 1, shape_d).astype(np.float32)
    zeros_m = np.where(rng.random(shape_m) < 0.5, -0.0, 0.0).astype(np.float32)
    zeros_d = np.where(rng.random(shape_d) < 0.5, -0.0, 0.0).astype(np.float32)
    yield "random", gauss_m, gauss_d
    yield "integer ties", ints_m, ints_d
    yield "equal metrics", np.zeros(shape_m, np.float32), ints_d
    yield "signed zeros", zeros_m, zeros_d
    for live in (0, 1, n_list - 1):
        met = ints_m.copy()
        met[live:] = _NEG
        yield f"{live} live paths", met, ints_d
        yield f"{live} live paths, zero deltas", met, zeros_d
        # the same count of live paths at random slots: a dead path's
        # candidates (exactly _NEG) can then hold a smaller code
        dead = np.argsort(rng.random(shape_m), axis=0) >= live
        yield f"{live} live paths at random slots", np.where(dead, _NEG, ints_m), ints_d
    # every value below _NEG (a dead path's killed candidates), with ties
    below = (_NEG * rng.choice([1.0, 1.5, 2.0], shape_d)).astype(np.float32)
    yield "every value below _NEG", np.full(shape_m, _NEG, np.float32), below
    # a frozen leaf: keep pays min(x, 0), every other candidate is killed
    x = rng.integers(-2, 3, (n_list, COLS)).astype(np.float32)
    frozen = np.full(shape_d, _NEG, np.float32)
    frozen[0] = np.minimum(x, 0.0)
    for live in (n_list, 1, 0):
        met = ints_m.copy()
        met[live:] = _NEG
        yield f"frozen leaf, {live} live paths", met, frozen


@pytest.mark.parametrize("n_cand", [2, 4, 8])
@pytest.mark.parametrize("n_list", [1, 2, 3, 4, 8, 12, 16, 32, 64])
def test_prune_by_rank_matches_iterative_prune(n_list, n_cand):
    rng = np.random.default_rng(1000 * n_list + n_cand)
    plain = _Plain(n_list, drop=_NEG)
    for name, met, deltas in _cases(n_list, n_cand, rng):
        m_t, d_t = torch.as_tensor(met), torch.as_tensor(deltas)
        want = plain.prune(m_t, d_t)
        got = prune_by_rank(m_t, d_t, n_list)
        for what, a, b in zip(("values", "src", "cand"), got, want):
            assert a.shape == b.shape, (name, what)
            assert torch.equal(a, b), f"{name}: {what} differ"


def test_prune_by_rank_needs_more_candidates_than_paths():
    with pytest.raises(ValueError):
        prune_by_rank(torch.zeros(2, 3), torch.zeros(2, 2, 3), 4)
