"""Lists above 128 paths, and list state past shared memory.

SCLDecoder at L = 160 (W = 5 packed words a position) and L = 256 (W = 8)
on (64, 32) CRC16, and int8 at L = 160, against the JAX package's XLA arm;
LargeSCLDecoder at L = 160 on (128, 64) CRC16, chunk 32, sub-blocks of 16,
on the tree schedule against the JAX tree schedule's static-mask arm and
on the scan schedule against the JAX XLA arm (slow: JAX compiles its scan
at L = 160 for ~100 s). Then the device-memory kernel's CUDA source
(csrc/scl_wide.cu), built for the CPU by ops/_emu.py, against the plain
versions: K1 at L = 129 and 160 on every leaf kind and on a branched
subtree (span <= 32, B <= 3), entered at one path and at L, a family each
case; K7 at L = 129, 160 and 256 on chunks of 32 and 64, with and
without sub-blocks of every class, all live and one live path (the _NEG
re-take rule), a family each, and its prune by merge on rows entering in
rank order with a _NEG tail and out of rank order with _NEG at random
slots, on an all-frozen chunk and on one with rate-0 runs and every
sub-block class. Plus the wrappers' routing: which shapes the
shared-memory kernels keep and which go to device memory, and the one
plan of the device-memory kernel's two entries.

Inputs from numpy seeds: CRC-coded blocks through BPSK/AWGN ("gauss"), and
the same rounded to integers in [-2, 2] ("ints": metric ties, exact zeros).
Tolerances: every path's codeword, the chosen codeword, the info bits and
the CRC flags equal; metrics within rtol = atol = 1e-4 in float32 on
Gaussian LLRs (the port sums in span order, XLA may reassociate), exactly
equal on integer LLRs and in char; the CPU builds of the kernels bit-equal
to their plain versions (bits, perms, metrics)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from polar_codes_tpu.models import detectors as jdet  # noqa: E402
from polar_codes_tpu.models import large as jlarge  # noqa: E402
from polar_codes_tpu.models.scl import SCLDecoder as JaxSCLDecoder  # noqa: E402

from polar_codes_torch.construction import frozen_bits  # noqa: E402
from polar_codes_torch.models import detectors as tdet  # noqa: E402
from polar_codes_torch.models import large  # noqa: E402
from polar_codes_torch.models.encoder import PolarEncoder  # noqa: E402
from polar_codes_torch.models.large import _classify_chunks  # noqa: E402
from polar_codes_torch.models.scl import SCLDecoder  # noqa: E402
from polar_codes_torch.models.tree import ALL_LEAF_KINDS, CodeNode, NodeKind, build_tree  # noqa: E402
from polar_codes_torch.ops import _emu  # noqa: E402
from polar_codes_torch.ops import large_kernel as lk  # noqa: E402
from polar_codes_torch.ops import scl_kernel_bl as kbl  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
NEG = -1.0e30
BATCH = 8
SCL_CODE = (64, 32)  # a JAX L = 160 decode compiles and runs in ~12 s here
LARGE_CODE = (128, 64)  # chunk 32: JAX's tree arm compiles at L = 160 in ~20 s
DTYPES = {"float32": torch.float32, "char": torch.int16, "bfloat16": torch.bfloat16}


def _channel(n, k, seed, kind, ebn0_db=0.0):
    """(frozen set, sent info with its CRC, LLRs): CRC16-coded blocks through
    BPSK + AWGN (numpy noise), float or rounded to integers in [-2, 2]."""
    det = tdet.CRC16()
    frozen = frozen_bits(n, k, 0.0, "BB")
    rng = np.random.default_rng(seed)
    info = torch.as_tensor(rng.integers(0, 2, (BATCH, k)), dtype=torch.uint8)
    code = PolarEncoder(n, frozen, detector=det, device="cpu").encode(info).numpy()
    sigma = 1.0 / np.sqrt(2.0 * 10.0 ** (ebn0_db / 10.0) * k / n)
    llr = (1.0 - 2.0 * code + rng.normal(0, sigma, code.shape)).astype(np.float32)
    if kind == "ints":
        llr = np.clip(np.round(2.0 * llr), -2, 2).astype(np.float32)
    return frozen, det.generate(info).numpy(), llr


@pytest.fixture(scope="module")
def jax_decoders():
    """One jitted JAX SCL decoder per (L, dtype), shared by the module."""
    cache = {}

    def get(n_list, dtype=jnp.float32):
        key = (n_list, jnp.dtype(dtype).name)
        if key not in cache:
            n, k = SCL_CODE
            jdec = JaxSCLDecoder(n, frozen_bits(n, k, 0.0, "BB"), list_size=n_list,
                                 detector=jdet.CRC16(), dtype=dtype)
            assert jdec.backend == "xla"
            cache[key] = jax.jit(lambda x: (jdec.decode(x), jdec.decode_paths(x)))
        return cache[key]

    return get


def _compare(dec, jfn, llr, exact):
    x = torch.as_tensor(llr)
    jdecoded, (jcw, jmet, jact) = jfn(jnp.asarray(llr))
    cw, met, act = dec.decode_paths(x)
    np.testing.assert_array_equal(cw.numpy(), np.asarray(jcw))
    np.testing.assert_array_equal(act.numpy(), np.asarray(jact))
    if exact:
        np.testing.assert_array_equal(met.numpy(), np.asarray(jmet))
    else:
        np.testing.assert_allclose(met.numpy(), np.asarray(jmet), **TOL)
    got = dec.decode(x)
    for a, b in zip(got, jdecoded):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return got


@pytest.mark.parametrize("kind", ["gauss", "ints"])
@pytest.mark.parametrize("n_list", [160, 256])
def test_scl_above_128_matches_jax_xla(jax_decoders, n_list, kind):
    n, k = SCL_CODE
    frozen, sent, llr = _channel(n, k, n_list, kind)
    dec = SCLDecoder(n, frozen, list_size=n_list, detector=tdet.CRC16(), device="cpu")
    assert dec.words == kbl.n_words(n_list) == n_list // 32
    got = _compare(dec, jax_decoders(n_list), llr, exact=kind == "ints")
    ok = got[2].numpy()
    assert not ((got[0].numpy() != sent).any(1) & ok).any()  # every CRC failure a wrong block


def test_scl_above_128_char_matches_jax_xla(jax_decoders):
    """int8 at L = 160: the int16 state of K1's char family, metrics exact."""
    n, k = SCL_CODE
    frozen, _, llr = _channel(n, k, 1600, "gauss")
    q = np.clip(np.round(llr * 10.0), -127, 127).astype(np.int8)
    dec = SCLDecoder(n, frozen, list_size=160, detector=tdet.CRC16(), dtype=torch.int8,
                     device="cpu")
    _compare(dec, jax_decoders(160, jnp.int8), q, exact=True)


@pytest.mark.parametrize("schedule", ["tree", pytest.param("scan", marks=pytest.mark.slow)])
def test_large_scl_above_128_matches_jax(schedule):
    """LargeSCLDecoder at L = 160 against the JAX XLA arm (scan, unroll 1)
    and the JAX tree schedule's static-mask arm (backend "xla")."""
    n, k = LARGE_CODE
    frozen, sent, llr = _channel(n, k, 160 + len(schedule), "gauss", ebn0_db=1.0)
    kw = dict(list_size=160, chunk=32, subblock=16, schedule=schedule)
    jdec = jlarge.LargeSCLDecoder(n, frozen, detector=jdet.CRC16(), backend="xla",
                                  **dict(kw, **({"unroll": 1} if schedule == "scan" else {})))
    dec = large.LargeSCLDecoder(n, frozen, detector=tdet.CRC16(), device="cpu", **kw)
    assert dec.words == 5
    jin, tin = jnp.asarray(llr), torch.as_tensor(llr)
    paths = dec.decode_paths(tin)
    jpaths = [np.asarray(a) for a in jdec.decode_paths(jin)]
    active = jpaths[2]
    np.testing.assert_array_equal(paths[2].numpy(), active)
    np.testing.assert_array_equal(paths[0].numpy()[active], jpaths[0][active])
    np.testing.assert_allclose(paths[1].numpy(), jpaths[1], **TOL)
    jdec.decode_paths = lambda _: tuple(jnp.asarray(a) for a in jpaths)
    got = dec.decode(tin)
    for a, b in zip(got, jdec.decode(jin)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not ((got[0].numpy() != sent).any(1) & got[2].numpy()).any()


# ---- the device-memory kernel's source on the CPU --------------------------

@pytest.fixture(scope="module")
def wide():
    try:
        return _emu.load_on_cpu("scl_wide")
    except RuntimeError as err:  # no g++ on this machine
        pytest.skip(str(err))


def _leaf(kind, span, frozen):
    return CodeNode(offset=0, length=span, frozen=np.asarray(frozen, np.int64), kind=kind)


def _k1_nodes():
    """One leaf of each kind, and a branched span-32 subtree with every
    leaf kind (ENUM span 4, k 2)."""
    frozen = [0, 1, 2, 3, 4, 5, 6, 8, 9, 12, 16, 17, 18, 20]
    return [_leaf(NodeKind.RATE0, 8, range(8)), _leaf(NodeKind.RATE1, 1, []),
            _leaf(NodeKind.RATE1, 16, []), _leaf(NodeKind.REP, 8, range(7)),
            _leaf(NodeKind.SPC, 16, [0]), _leaf(NodeKind.ENUM, 8, [0, 1, 2, 4, 5]),
            build_tree(32, frozen, allowed=ALL_LEAF_KINDS, enum_span=4, max_enum_k=2)]


def _equal(where, got, want):
    assert torch.equal(got[0], want[0]), where + ": bits"
    assert torch.equal(got[1], want[1]), where + ": perm"
    assert torch.equal(got[2].view(torch.int32), want[2].view(torch.int32)), where + ": metrics"


@pytest.mark.parametrize("n_list,family", [(129, "float32"), (160, "char"),
                                           (160, "bfloat16")])
def test_k1_wide_source_on_cpu(wide, n_list, family):
    rng = np.random.default_rng(n_list + len(family))
    dtype = DTYPES[family]
    for i, node in enumerate(_k1_nodes()):
        for w_in in (1, n_list):
            sched = kbl.build_schedule(node, w_in, n_list)
            n_batch = 1 + (i + w_in) % 3
            shape = (w_in, node.length, n_batch)
            if (i + w_in) % 2:
                llr = rng.integers(-2, 3, shape).astype(np.float32)
                met = rng.integers(-3, 1, (n_batch, w_in)).astype(np.float32)
            else:
                llr = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
                if dtype == torch.int16:
                    llr = np.clip(np.round(llr * 10.0), -127, 127)
                met = (rng.standard_normal((n_batch, w_in)) * 3.0).astype(np.float32)
            if w_in > 1:
                met[::2, 1:] = NEG  # every other row: one live path
            llr, met = torch.as_tensor(llr).to(dtype), torch.as_tensor(met)
            got = kbl.launch_wide(wide, sched, llr, met)
            want = kbl.scl_subtree_plain(sched, llr, met)
            assert got[0].shape == want[0].shape
            _equal(f"{node.kind.value} span {node.length}, w_in {w_in}", got, want)


# a chunk of 64 whose sub-blocks of 16 are rate-0, mixed, rate-1, rep, and
# one of 32 whose sub-blocks of 16 are spc and mixed
_K7_MASKS = {
    64: np.concatenate([np.ones(16), np.arange(16) % 3 == 0, np.zeros(16),
                        np.arange(16) < 15]).astype(np.uint8),
    32: np.concatenate([np.arange(16) == 0, np.arange(16) % 2 == 1]).astype(np.uint8),
}


@pytest.mark.parametrize("n_list,family", [(129, "float32"), (160, "char"), (256, "float32")])
def test_k7_wide_source_on_cpu(wide, n_list, family):
    rng = np.random.default_rng(n_list + len(family))
    for m_len, sub, how in ((64, 16, "live"), (32, 16, "one"), (32, 0, "live")):
        mask = torch.as_tensor(_K7_MASKS[m_len])
        sub_cls = None if not sub else torch.as_tensor(
            _classify_chunks(list(_K7_MASKS[m_len].astype(bool).reshape(-1, sub))))
        llr = torch.as_tensor(rng.integers(-2, 3, (1, n_list, m_len)).astype(np.float32))
        met = torch.as_tensor(rng.integers(-3, 1, (1, n_list)).astype(np.float32))
        if how == "one":  # the first call of a decode: the re-take rule fills L - 1 slots
            met[:, 1:], met[:, 0] = NEG, 0.0
        got = lk.launch_scl_wide(wide, llr, mask, met, sub_cls, family)
        want = lk.masked_scl_chunk_plain(llr, mask, met, sub_cls, family)
        _equal(f"chunk {m_len}, sub {sub}, {how}", got, want)


@pytest.mark.parametrize("n_list,family,mask", [(129, "char", "all frozen"),
                                                (256, "char", "classes")])
def test_k7_wide_prune_by_merge_on_cpu(wide, n_list, family, mask):
    """Rows entering in rank order with a _NEG tail (each bit's keep list
    taken as it is) and out of rank order with _NEG at random slots (each
    list ranked in runs of 32 paths, the runs merged); an all-frozen chunk
    (the re-take rule at every bit) or one with rate-0 runs and every
    sub-block class."""
    rng = np.random.default_rng(3 * n_list + len(mask))
    m_len = 32
    mask_np = np.ones(m_len, np.uint8) if mask == "all frozen" else _K7_MASKS[32]
    sub_cls = None if mask == "all frozen" else torch.as_tensor(
        _classify_chunks(list(mask_np.astype(bool).reshape(-1, 16))))
    met = rng.integers(-6, 1, (2, n_list)).astype(np.float32)
    met[0] = -np.sort(-met[0])
    met[0, rng.integers(1, n_list):] = NEG  # in rank order, then _NEG
    met[1, rng.random(n_list) < 0.3] = NEG  # out of rank order
    llr = torch.as_tensor(rng.integers(-2, 3, (2, n_list, m_len)).astype(np.float32))
    met = torch.as_tensor(met)
    got = lk.launch_scl_wide(wide, llr, torch.as_tensor(mask_np), met, sub_cls, family)
    _equal(mask, got, lk.masked_scl_chunk_plain(llr, torch.as_tensor(mask_np), met, sub_cls,
                                                family))


def test_wide_one_plan_for_k1_and_k7(wide):
    """K1 and K7 share one plan: every LLR level d >= 1 in the device
    scratch, the bookkeeping in shared memory, and a work array that holds
    K1's sort keys (8 bytes a candidate, to a power of two) and K7's merge
    (12 bytes a candidate). K7's char family (f32 state) plans as float32;
    there is no other plan code."""
    f32, char = kbl.WIDE_FAMILY_CODES["float32"], kbl.WIDE_FAMILY_CODES["chunk_char"]
    for n_list, m_len in ((129, 64), (256, 256), (128, 512), (64, 1024)):
        levels, n_cand = m_len.bit_length(), 8
        plan = kbl.wide_plan(wide, n_list, m_len, levels, n_cand, f32)
        assert plan == kbl.wide_plan(wide, n_list, m_len, levels, n_cand, char)
        assert plan[1] == -(-n_list * (m_len - 1) * 4 // 16) * 16  # levels only in device memory
        n_t = n_list * n_cand
        assert 16 * n_t + 4 * levels * n_list < plan[0] <= 232448 - 1024
    with pytest.raises(ValueError, match="no device-memory plan"):
        kbl.wide_plan(wide, 256, 256, 9, 8, max(kbl.WIDE_FAMILY_CODES.values()) + 1)


def test_wide_routing_and_plan(wide):
    """Which shapes leave shared memory: every L > 128, a branched span
    whose levels exceed shared memory at L <= 128, K7's (L, chunk) past
    MAX_SCL_SMEM; the device-memory kernel's plan keeps the bookkeeping in
    shared memory at the paths' shapes and spills it only far past them."""
    assert lk.scl_library(129, 64) == lk.scl_library(128, 512) == "scl_wide"
    assert lk.scl_library(64, 1024) == lk.scl_library(1, 1 << 15) == "scl_wide"
    assert lk.scl_library(128, 256) == "large_scl_lists"
    assert lk.scl_library(8, 256) == "large_scl_chunk"
    assert lk.scl_chunk_smem(160, 64) == 8 * 160 * 64 + 4 * 5 * 64 + 4 * 2
    k1_code = kbl.WIDE_FAMILY_CODES["float32"]
    smem, scratch = kbl.wide_plan(wide, 256, 128, 8, 8, k1_code)
    assert scratch == 256 * 127 * 4 and smem < 64 * 1024  # levels only in device memory
    smem, scratch = kbl.wide_plan(wide, 512, 128, 8, 16, k1_code)
    assert scratch == 512 * 127 * 4 and smem < 160 * 1024
    smem, scratch = kbl.wide_plan(wide, 4096, 128, 8, 16, k1_code)  # sort keys spill
    assert smem <= 232448 - 1024 and scratch > 4096 * 127 * 4
    with pytest.raises(ValueError, match="no device-memory plan"):
        kbl.wide_plan(wide, 0, 128, 8, 8, k1_code)
