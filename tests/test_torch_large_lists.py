"""LargeSCLDecoder at list sizes outside {2, 4, 8, 16, 32} against the JAX
package: L = 1 (one path), L = 3 and 12 (below a power of two) and L = 64
(two packed words a position), plus K7's plain version at L = 1 and 3
against JAX's K7 in interpret mode, the W-word glue helpers, and the carry.

Inputs from numpy seeds: random chunk LLRs and metrics (with inactive
slots, the first call of a decode, and all live), and CRC16-coded (512,
256) blocks through BPSK/AWGN at a noise level where some blocks fail the
CRC. The decoders run chunk 64 and sub-block 16 on the scan schedule (the
tree schedule at L = 64, int8 at L = 3); the JAX reference is its XLA arm
(backend "xla", unroll 1), whose chunk recursion tests/test_large.py holds
equal to its Pallas kernel. Tolerances: bits, perms, the active paths'
codewords, the chosen codewords, info bits and CRC flags equal; metrics
within rtol = atol = 1e-4 in float32 (the port sums in span order, XLA may
reassociate) and exactly equal in char (int8). A JAX L = 64 decode compiles
for about a minute on one CPU thread, so L = 12, L = 64 and int8 are slow,
and so is half of the interpret-mode K7 cases (7-13 s each)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import polar_codes_tpu.ops.large_kernel as jlk  # noqa: E402
from polar_codes_tpu.models import detectors as jdet  # noqa: E402
from polar_codes_tpu.models import large as jlarge  # noqa: E402

from polar_codes_torch.construction import frozen_bits  # noqa: E402
from polar_codes_torch.models import detectors as tdet  # noqa: E402
from polar_codes_torch.models import large  # noqa: E402
from polar_codes_torch.models.encoder import PolarEncoder  # noqa: E402
from polar_codes_torch.ops import large_kernel as lk  # noqa: E402
from polar_codes_torch.ops import scl_kernel_bl as kbl  # noqa: E402
from polar_codes_torch.utils.carry import from_jax_state, leaf_table  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
NEG = -1.0e30
N_LEN, K_LEN, CHUNK, SUB, BATCH = 512, 256, 64, 16, 16

# two chunks of 64 whose sub-blocks of 16 hold every class:
# {rate0, mixed, rate1, rep} and {spc, mixed, rep, mixed}
_MASKS = [
    np.concatenate([np.ones(16), np.arange(16) % 3 == 0, np.zeros(16),
                    np.arange(16) < 15]).astype(bool),
    np.concatenate([np.arange(16) == 0, np.arange(16) % 2 == 1, np.arange(16) < 15,
                    np.arange(16) < 10]).astype(bool),
]


@pytest.mark.parametrize("list_size,sub", [
    (1, None),
    (3, SUB),
    pytest.param(1, SUB, marks=pytest.mark.slow),
    pytest.param(3, None, marks=pytest.mark.slow),
])
def test_k7_plain_matches_jax_kernel(list_size, sub):
    """Call by call against the JAX kernel in interpret mode (batch tile 8,
    chunk 64), on metrics with inactive slots and on metrics all live."""
    rng = np.random.default_rng(10 * list_size + (sub or 0))
    fn = jax.jit(jlk.build_masked_scl_chunk_kernel(
        CHUNK, list_size, batch_tile=8, interpret=True, sub=sub))
    start = np.full((8, list_size), NEG, np.float32)
    start[:, 0] = 0.0
    for mask, metrics in zip(_MASKS, [start, rng.normal(-3, 2, (8, list_size))]):
        metrics = metrics.astype(np.float32)
        llr = rng.normal(0.4, 2.0, (8, list_size, CHUNK)).astype(np.float32)
        codes = jlarge._classify_chunks(list(mask.reshape(-1, SUB)))
        args = [jnp.asarray(llr), jnp.asarray(mask, jnp.float32), jnp.asarray(metrics)]
        sub_cls = None
        if sub:
            args.append(jnp.asarray(codes))
            sub_cls = torch.as_tensor(codes)
        jbits, jperm, jmet = fn(*args)
        bits, perm, met = lk.masked_scl_chunk_plain(
            torch.as_tensor(llr), torch.as_tensor(mask), torch.as_tensor(metrics), sub_cls)
        want = np.signbit(np.asarray(jbits))  # [B, L, M] bipolar -> {0,1}
        got = (bits.numpy()[:, None, :] >> np.arange(list_size)[None, :, None]) & 1
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
        np.testing.assert_allclose(met.numpy(), np.asarray(jmet), **TOL)


def _channel(ebn0_db, seed):
    """(frozen set, sent info with its CRC, LLRs) of BPSK over AWGN, numpy noise."""
    det = tdet.CRC16()
    frozen = frozen_bits(N_LEN, K_LEN, 0.0, "BB")
    rng = np.random.default_rng(seed)
    info = torch.as_tensor(rng.integers(0, 2, (BATCH, K_LEN)), dtype=torch.uint8)
    code = PolarEncoder(N_LEN, frozen, detector=det, device="cpu").encode(info).numpy()
    sigma = np.sqrt(1.0 / (2.0 * 10.0 ** (ebn0_db / 10.0) * K_LEN / N_LEN))
    y = (1.0 - 2.0 * code) + sigma * rng.standard_normal(code.shape)
    return frozen, det.generate(info).numpy(), (2.0 * y / sigma**2).astype(np.float32)


@pytest.mark.parametrize("list_size,schedule,int8", [
    (1, "scan", False),
    (3, "scan", False),
    pytest.param(12, "scan", False, marks=pytest.mark.slow),
    pytest.param(64, "scan", False, marks=pytest.mark.slow),
    pytest.param(64, "tree", False, marks=pytest.mark.slow),
    pytest.param(3, "scan", True, marks=pytest.mark.slow),
])
def test_large_scl_any_list_matches_jax(list_size, schedule, int8):
    """decode_paths and decode against the JAX XLA arm at (512, 256) CRC16."""
    frozen, sent, llr = _channel(1.0, 100 + list_size)
    if int8:
        llr = np.clip(np.round(llr), -127, 127)
    kw = dict(list_size=list_size, chunk=CHUNK, subblock=SUB, schedule=schedule)
    jkw = dict(kw, detector=jdet.CRC16(), backend="xla",
               dtype=jnp.int8 if int8 else jnp.float32, **({"unroll": 1} if schedule == "scan"
                                                           else {}))
    jdec = jlarge.LargeSCLDecoder(N_LEN, frozen, **jkw)
    dec = large.LargeSCLDecoder(N_LEN, frozen, detector=tdet.CRC16(), device="cpu",
                                dtype=torch.int8 if int8 else torch.float32, **kw)
    assert dec.words == kbl.n_words(list_size)
    jin = jnp.asarray(llr.astype(np.int8) if int8 else llr)
    tin = torch.as_tensor(llr)
    paths = dec.decode_paths(tin)
    jpaths = [np.asarray(a) for a in jdec.decode_paths(jin)]
    active = jpaths[2]
    np.testing.assert_array_equal(paths[2].numpy(), active)
    np.testing.assert_array_equal(paths[0].numpy()[active], jpaths[0][active])
    if int8:
        np.testing.assert_array_equal(paths[1].numpy(), jpaths[1])
    else:
        np.testing.assert_allclose(paths[1].numpy(), jpaths[1], **TOL)
    # the JAX selection, run on the paths it just decoded
    jdec.decode_paths = lambda _: tuple(jnp.asarray(a) for a in jpaths)
    got = dec.decode(tin)
    for a, b in zip(got, jdec.decode(jin)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ok = got[2].numpy()
    assert not ((got[0].numpy() != sent).any(1) & ok).any()
    if list_size <= 3 and not int8:
        assert (~ok).any() and ok.any()


def _glue_one_word(word, perm):
    """_planes and _take_word as written for one word a position."""
    planes = (word.unsqueeze(-2) >> perm.unsqueeze(-1)) & 1
    lanes = torch.arange(perm.shape[-1])[:, None]
    return planes, (planes << lanes).sum(-2).to(torch.int32)


@pytest.mark.parametrize("n_list", [1, 5, 32, 33, 64, 100, 128])
def test_glue_word_helpers(n_list):
    """At one word the glue's helpers give their single-word results (bit
    31 too); above it plane l of the gathered words is input plane perm[l],
    in bit l % 32 of word l // 32, with leading dims (the join's [B, T])."""
    rng = np.random.default_rng(n_list)
    words = kbl.n_words(n_list)
    lead, span = (3, 2), 8
    b01 = torch.as_tensor(rng.integers(0, 2, lead + (n_list, span)).astype(np.int32))
    word = kbl.pack_planes(b01.movedim(-2, 0), words).movedim(0, -2)  # [..., W, S]
    if words == 1:
        word = word.squeeze(-2)
        assert torch.equal(word, _glue_one_word(word, torch.arange(n_list).expand(
            lead + (n_list,)))[1])
    perm = torch.as_tensor(rng.integers(0, n_list, lead + (n_list,)))
    planes = large._planes(word, perm, words)
    want = torch.gather(b01, -2, perm[..., None].expand(-1, -1, -1, span))
    assert torch.equal(planes, want)
    taken = large._take_word(word, perm, words)
    assert taken.shape == word.shape
    assert torch.equal(large._planes(taken, torch.arange(n_list).expand_as(perm), words), want)
    if words == 1:
        one_planes, one_taken = _glue_one_word(word, perm)
        assert torch.equal(planes, one_planes) and torch.equal(taken, one_taken)


@pytest.mark.parametrize("schedule", ["scan", "tree"])
@pytest.mark.parametrize("list_size", [3, 64])
def test_carry_large_scl_any_list(list_size, schedule):
    """utils.carry: a JAX LargeSCLDecoder's state at L = 3 or 64, on either
    schedule, builds the port's, with ceil(L / 32) packed words a
    position."""
    frozen = frozen_bits(1024, 512, 0.0, "BB")
    det = jdet.CRC16()
    jdec = jlarge.LargeSCLDecoder(1024, frozen, list_size=list_size, detector=det,
                                  chunk=64, backend="xla", schedule=schedule)
    G, g0 = det.affine_map(jdec.info_length - det.tail_bits)
    state = dict(family="large_scl", frozen=jdec.frozen, info_pos=jdec.info_pos,
                 systematic=True, detector="crc16", affine_G=np.asarray(G),
                 affine_g0=np.asarray(g0), mask_chunks=jdec._mask_chunks,
                 classes=jlarge._classify_chunks(jdec._mask_chunks), chunk=64,
                 fast_chunks=True, subblock=16, list_size=list_size, schedule=schedule,
                 sub_classes=jdec._sub_classes)
    if schedule == "tree":
        state["leaves"] = leaf_table(jlarge.build_tree(1024, jdec.frozen))
    _, dec = from_jax_state(state, device="cpu")
    assert type(dec) is large.LargeSCLDecoder and dec.schedule == schedule
    assert dec.list_size == list_size and dec.words == kbl.n_words(list_size)
    with pytest.raises(ValueError, match="sub_classes"):
        from_jax_state(dict(state, sub_classes=np.zeros_like(state["sub_classes"])),
                       device="cpu")


def test_list_size_limits():
    """L = 1, 128 and 129 construct, and L = 0 is a ValueError, on both
    schedules; a chunk whose state does not fit shared memory even with
    its input in device memory (L = 128, chunk 512; L = 129 at any chunk)
    reaches the device-memory kernel's launch (csrc/scl_wide.cu), which
    here, without a card, raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        llr = torch.empty((2, 128, 512), device="cuda")
        met = torch.empty((2, 128), device="cuda")
        mask = torch.empty(512, dtype=torch.uint8, device="cuda")
    assert lk.scl_library(128, 512) == lk.scl_library(129, 64) == "scl_wide"
    with pytest.raises((RuntimeError, OSError)):  # the device-memory kernel's launch
        lk.masked_scl_chunk(llr, mask, met)
    assert lk.scl_library(128, 256) == lk.scl_library(3, 64) == "large_scl_lists"
    assert lk.scl_library(8, 256) == "large_scl_chunk"
    assert lk.scl_library(32, 1024) == "large_scl_lists"  # its pyramid does not fit
    frozen = frozen_bits(256, 128, 0.0, "BB")
    for schedule in ("scan", "tree"):
        for n_list in (1, 128, 129):
            dec = large.LargeSCLDecoder(256, frozen, list_size=n_list, chunk=64,
                                        schedule=schedule, device="cpu")
            assert dec.words == kbl.n_words(n_list)
        with pytest.raises(ValueError, match="at least one path"):
            large.LargeSCLDecoder(256, frozen, list_size=0, schedule=schedule, device="cpu")
