"""The masked chunk kernels' CUDA sources (csrc/large_sc_chunk.cu, K6;
csrc/large_scl_chunk.cu and large_scl_lists.cu, K7), built for the CPU by ops/_emu.py (g++, one
thread per CUDA thread), against their plain versions.

Small shapes, inputs from a seed with numpy: integer LLRs in [-2, 2]
(ties, signed zeros through f) and Gaussian ones; K6 on masks with rate-0
runs, all-frozen, all-free and random chunks; K7 at every list size with
and without sub-blocks of every class (1 to 100 paths: the kernels of a
fixed list size, the run-time sizes 1 and 3, and the block kernels above
32 paths: W = 2 words at 33 (one path in the second) and 64, W = 4 at
100 (four in the last)), on rows with one live path and with 0 to L - 1
live paths at random slots, and at L = 100 and 128 on a chunk of 256
whose input stays in device memory; the block kernels' prune by merge at
L = 33, 100 and 128 on rows entering in rank order with a _NEG tail and
out of rank order with _NEG at random slots, on all-frozen and rate-0-run
masks. Tolerance: none for K6 (x and u bit-equal) and for K7's bits and
perms; K7 metrics exactly equal in char, within 1e-4 in float32 (the
card's tolerance; these integer and Gaussian inputs give equal metrics).
On the card `chip_smoke.py` holds the nvcc builds to the same rules.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from polar_codes_torch.ops import _emu  # noqa: E402
from polar_codes_torch.ops import large_kernel as lk  # noqa: E402

FAMILIES = ("float32", "char")


def _lib(name):
    try:
        return _emu.load_on_cpu(name)
    except RuntimeError as err:  # no g++ on this machine
        pytest.skip(str(err))


@pytest.fixture(scope="module")
def k6():
    return lk._bind_sc(_lib("large_sc_chunk"))


@pytest.fixture(scope="module")
def k7():
    """K7's CPU build that the wrapper would launch for (L, chunk, sub)."""
    return lambda n_list, m_len, sub: lk._bind_scl(_lib(lk.scl_library(n_list, m_len, sub)))


def _llr(rng, shape, family, kind):
    if kind == "ints":
        return rng.integers(-2, 3, shape).astype(np.float32)
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    return np.clip(np.round(x * 10.0), -127, 127).astype(np.float32) if family == "char" else x


def _rate0_mask(rng, m_len):
    mask = (rng.random(m_len) < 0.5).astype(np.uint8)
    span = 2
    while span <= m_len // 2:
        n_nodes = m_len // span
        for node in rng.choice(n_nodes, size=max(1, n_nodes // 16), replace=False):
            mask[node * span:(node + 1) * span] = 1
        span *= 2
    return mask


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("m_len", [16, 64, 256])
@pytest.mark.parametrize("family", FAMILIES)
def test_k6_source_on_cpu_matches_plain(k6, family, m_len):
    rng = np.random.default_rng(m_len + len(family))
    masks = {"rate-0 runs": _rate0_mask(rng, m_len), "all frozen": np.ones(m_len, np.uint8),
             "all free": np.zeros(m_len, np.uint8),
             "random": (rng.random(m_len) < 0.5).astype(np.uint8)}
    for kind in ("ints", "gauss"):
        llr = torch.as_tensor(_llr(rng, (2, m_len), family, kind))
        for name, mask in masks.items():
            mask_t = torch.as_tensor(mask)
            x, u = torch.empty_like(llr), torch.empty_like(llr)
            assert k6(llr.data_ptr(), mask_t.data_ptr(), x.data_ptr(), u.data_ptr(), m_len,
                      2, lk._FAMILIES[family].code, None) == 0
            px, pu = lk.masked_sc_chunk_plain(llr, mask_t, family)
            assert _same_bits(x, px) and _same_bits(u, pu), f"{kind}, {name}"


# sub-blocks of 4: rate0, rate1, rep, spc, two mixed, rep, spc
_CLASS_MASK = np.array([1, 1, 1, 1, 0, 0, 0, 0, 1, 1, 1, 0, 1, 0, 0, 0,
                        1, 0, 1, 0, 0, 1, 1, 0, 1, 1, 1, 0, 1, 0, 0, 0], np.uint8)


def _k7_call(k7, family, llr, mask_np, met, sub, what):
    """One call of K7's CPU build against its plain version."""
    from polar_codes_torch.models.large import _classify_chunks

    n_batch, n_list, m_len = llr.shape
    mask = torch.as_tensor(mask_np)
    sub_cls = (torch.as_tensor(_classify_chunks(list(mask_np.reshape(-1, sub))))
               if sub else None)
    words = lk.n_words(n_list)
    spc, none = lk._scl_consts(torch.device("cpu"))
    bits = torch.empty((n_batch, m_len) if words == 1 else (n_batch, words, m_len),
                       dtype=torch.int32)
    perm = torch.empty((n_batch, n_list), dtype=torch.int32)
    m_out = torch.empty((n_batch, n_list), dtype=torch.float32)
    assert k7(n_list, m_len, sub)(None, 0, spc.data_ptr(), llr.data_ptr(),
              mask.data_ptr(), met.data_ptr(),
              (none if sub_cls is None else sub_cls).data_ptr(), sub, bits.data_ptr(),
              perm.data_ptr(), m_out.data_ptr(), n_list, m_len, n_batch,
              lk._FAMILIES[family].code, None) == 0
    pb, pp, pm = lk.masked_scl_chunk_plain(llr, mask, met, sub_cls, family)
    assert torch.equal(bits, pb), what
    assert torch.equal(perm, pp), what
    if family == "char":
        assert torch.equal(m_out, pm), what
    else:
        torch.testing.assert_close(m_out, pm, rtol=1e-4, atol=1e-4)


def _check_k7(k7, family, n_list, mask_np, sub, n_batch, rng):
    """K7's CPU build against its plain version on one mask, integer and
    Gaussian LLRs, a row with one live path and rows with 0 to L - 1."""
    for kind in ("ints", "gauss"):
        llr = torch.as_tensor(_llr(rng, (n_batch, n_list, mask_np.size), family, kind))
        met = rng.integers(-3, 1, (n_batch, n_list)).astype(np.float32)
        met[0, 1:] = lk._NEG  # one live path
        for row in range(1, n_batch):
            met[row, rng.permutation(n_list)[rng.integers(0, n_list):]] = lk._NEG
        _k7_call(k7, family, llr, mask_np, torch.as_tensor(met), sub, kind)


# L = 1 and 3 run in the capacity-2 and -4 kernels with the list size at
# run time, L = 33 and 64 in capacity 64's block with two words a position,
# L = 100 in capacity 128's with four; the CPU runner puts a barrier at
# every warp sync and cannot show a race (chip_smoke.py phase 40 holds the
# nvcc build on the card)
@pytest.mark.parametrize("sub", [0, 4])
@pytest.mark.parametrize("n_list", lk.SCL_LISTS + (1, 3, 64, 33, 100))
@pytest.mark.parametrize("family", FAMILIES)
def test_k7_source_on_cpu_matches_plain(k7, family, n_list, sub):
    rng = np.random.default_rng(100 * n_list + sub + len(family))
    _check_k7(k7, family, n_list, _CLASS_MASK, sub, 2, rng)


# the merge's paths: a row in rank order with a _NEG tail (each bit's keep
# list taken as it is), a row out of rank order with _NEG at random slots
# (every list ranked in runs of 32 and the runs merged) and a row with one
# live path; all frozen (the re-take rule at every bit, keep lists out of
# order) or rate-0 runs (sub-blocks of every class with sub = 4)
_MERGE_MASKS = {"all frozen": np.ones(16, np.uint8),
                "rate-0 runs": np.array([1, 1, 1, 1, 0, 1, 1, 0, 0, 0, 1, 1, 1, 1, 1, 1,
                                         1, 0, 1, 0, 0, 0, 0, 0, 1, 1, 0, 1, 0, 0, 0, 0],
                                        np.uint8)}


@pytest.mark.parametrize("family,n_list,mask,sub", [
    ("float32", 128, "rate-0 runs", 4), ("char", 128, "all frozen", 0),
    ("char", 100, "rate-0 runs", 0), ("float32", 33, "all frozen", 0),
    ("char", 33, "rate-0 runs", 4)])
def test_k7_block_prune_by_merge_on_cpu(k7, family, n_list, mask, sub):
    rng = np.random.default_rng(7 * n_list + sub + len(family))
    mask_np = _MERGE_MASKS[mask]
    met = rng.integers(-6, 1, (3, n_list)).astype(np.float32)
    met[0] = -np.sort(-met[0])
    met[0, rng.integers(1, n_list):] = lk._NEG  # in rank order, then _NEG
    met[1, rng.random(n_list) < 0.3] = lk._NEG  # out of rank order
    met[2, 1:] = lk._NEG  # one live path
    llr = torch.as_tensor(_llr(rng, (3, n_list, mask_np.size), family, "ints"))
    _k7_call(k7, family, llr, mask_np, torch.as_tensor(met), sub, mask)


@pytest.mark.slow
@pytest.mark.parametrize("family,n_list,sub", [("float32", 128, 16), ("char", 100, 0)])
def test_k7_source_on_cpu_reads_level0_from_device_memory(k7, family, n_list, sub):
    """A chunk of 256 at L = 100 or 128, whose pyramid exceeds the shared
    memory K7 takes (lk.MAX_SCL_SMEM): level 0 stays where it lies (~7 s a
    case on the CPU runner; chip_smoke.py phase 40 holds it on the card)."""
    m_len = 256
    assert lk.scl_chunk_smem(n_list, m_len, sub) > lk.MAX_SCL_SMEM
    assert lk.scl_chunk_smem(n_list, m_len, sub, direct=True) <= lk.MAX_SCL_SMEM
    rng = np.random.default_rng(n_list + len(family))
    mask = np.concatenate([_CLASS_MASK] * (m_len // _CLASS_MASK.size))
    mask[:64] = rng.random(64) < 0.5  # more mixed sub-blocks
    _check_k7(k7, family, n_list, mask, sub, 1, rng)
