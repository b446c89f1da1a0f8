"""The port's large-N decoders and the plain versions of their chunk kernels
(K6 masked SC, K7 masked SCL) against the JAX package's Pallas arm, with
its kernels in interpret mode, plus the host data, the carry and the
wrappers' dispatch.

The JAX reference is the Pallas arm, whose kernels the port's chunk
kernels replace. The JAX decoders run with unroll=1, which
does not change the result (tests/test_large.py
test_unroll_invariance_many_chunks) and keeps their compile short.

Tolerances: decision bits, perms, codewords, info bits and CRC flags must
be equal; path metrics agree within rtol = atol = 1e-4, because the port
sums the REP/SPC/rate-0 terms in span order and XLA may reassociate."""

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
from polar_codes_torch.models.tree import NodeKind  # noqa: E402
from polar_codes_torch.ops import large_kernel as lk  # noqa: E402
from polar_codes_torch.utils.carry import from_jax_state, leaf_table  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
NEG = -1.0e30


@pytest.fixture
def interpret(monkeypatch):
    """Force the JAX chunk kernels into interpret mode on small tiles."""
    for name in ("build_masked_sc_chunk_kernel", "build_masked_scl_chunk_kernel"):
        orig = getattr(jlk, name)
        monkeypatch.setattr(jlk, name, lambda *a, _o=orig, **kw: _o(
            *a, **{**kw, "interpret": True, "batch_tile": 8}))


def _channel(n_len, k_len, detector, ebn0_db, batch, seed):
    """(sent info with its CRC, LLRs) of BPSK over AWGN, made with numpy."""
    frozen = frozen_bits(n_len, k_len, 0.0, "BB")
    rng = np.random.default_rng(seed)
    info = torch.as_tensor(rng.integers(0, 2, (batch, k_len)), dtype=torch.uint8)
    enc = PolarEncoder(n_len, frozen, detector=detector, device="cpu")
    code = enc.encode(info).numpy()
    sigma = np.sqrt(1.0 / (2.0 * 10.0 ** (ebn0_db / 10.0) * k_len / n_len))
    y = (1.0 - 2.0 * code) + sigma * rng.standard_normal(code.shape)
    sent = detector.generate(info) if detector is not None else info
    return frozen, sent.numpy(), (2.0 * y / sigma**2).astype(np.float32)


# ---- host data -------------------------------------------------------------

def test_chunk_masks_and_classes_match_jax():
    """Masks, classes and sub-block classes equal the JAX package's, and the
    production shapes give the mixed-chunk counts of the kernel paths."""
    for n_len, chunk in ((1024, 64), (131072, 2048), (32768, 256)):
        frozen = frozen_bits(n_len, n_len // 2, 0.0, "BB")
        masks = large._frozen_mask_chunks(n_len, frozen, chunk)
        np.testing.assert_array_equal(masks, jlarge._frozen_mask_chunks(n_len, frozen, chunk))
        np.testing.assert_array_equal(large._classify_chunks(masks),
                                      jlarge._classify_chunks(masks))
    sc = large.LargeSCDecoder(131072, frozen_bits(131072, 65536, 0.0, "BB"), device="cpu")
    assert sc.chunk == 2048 and int((sc.classes == large._MIXED).sum()) == 47
    scl = large.LargeSCLDecoder(32768, frozen_bits(32768, 16384, 0.0, "BB"), device="cpu")
    mixed = scl.classes == large._MIXED
    assert int(mixed.sum()) == 70 and scl.subblock == 16
    assert int((scl.sub_classes[mixed] == large._MIXED).sum()) == 287
    jscl = jlarge.LargeSCLDecoder(32768, scl.frozen, backend="xla")
    np.testing.assert_array_equal(scl.sub_classes, jscl._sub_classes)


# ---- K6 --------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "every_class"])
def test_k6_plain_matches_jax_kernel(kind):
    chunk = 64
    rng = np.random.default_rng(6)
    if kind == "random":
        mask = rng.random(chunk) < 0.5
    else:  # rate0, rate1, rep and spc spans of 8 beside mixed ones
        mask = np.zeros(chunk, bool)
        mask[:8] = True
        mask[16:23] = True
        mask[24] = True
        mask[40:44] = True
        mask[48:51] = True
    llr = rng.normal(0.3, 2.0, (12, chunk)).astype(np.float32)
    fn = jlk.build_masked_sc_chunk_kernel(chunk, batch_tile=8, interpret=True)
    jx, ju = fn(jnp.asarray(llr), jnp.asarray(mask, jnp.float32))
    x, u = lk.masked_sc_chunk_plain(torch.as_tensor(llr), torch.as_tensor(mask))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))


# ---- K7 --------------------------------------------------------------------

# two masks of 64 whose sub-blocks of 16 cover every class:
# {rate0, mixed, rate1, rep} and {spc, mixed, rep, mixed}
_K7_MASKS = [
    np.concatenate([np.ones(16), np.arange(16) % 3 == 0, np.zeros(16),
                    np.arange(16) < 15]).astype(bool),
    np.concatenate([np.arange(16) == 0, np.arange(16) % 2 == 1, np.arange(16) < 15,
                    np.arange(16) < 10]).astype(bool),
]


@pytest.mark.parametrize("list_size,sub", [
    (4, 16),
    pytest.param(8, 16, marks=pytest.mark.slow),
    pytest.param(4, None, marks=pytest.mark.slow),
    pytest.param(8, None, marks=pytest.mark.slow),
])
def test_k7_plain_matches_jax_kernel(list_size, sub):
    """Call by call against the JAX kernel, on metrics with inactive slots
    (the first call of a decode) and on metrics that are all live."""
    chunk, batch = 64, 8
    rng = np.random.default_rng(list_size)
    fn = jax.jit(jlk.build_masked_scl_chunk_kernel(
        chunk, list_size, batch_tile=batch, interpret=True, sub=sub))
    start = np.full((batch, list_size), NEG, np.float32)
    start[:, 0] = 0.0
    for mask, metrics in zip(_K7_MASKS, [start, rng.normal(-3, 2, (batch, list_size))]):
        metrics = metrics.astype(np.float32)
        llr = rng.normal(0.4, 2.0, (batch, list_size, chunk)).astype(np.float32)
        codes = jlarge._classify_chunks(list(mask.reshape(-1, 16)))
        args = [jnp.asarray(llr), jnp.asarray(mask, jnp.float32), jnp.asarray(metrics)]
        sub_cls = None
        if sub:
            assert len(set(codes.tolist())) >= 3
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
    all_codes = set(jlarge._classify_chunks(
        [b for m in _K7_MASKS for b in m.reshape(-1, 16)]).tolist())
    assert all_codes == set(range(5))


def test_k7_schedule_walks_the_chunk():
    """The kernel's op list: a post-order walk whose SUB rows skip exactly
    the per-bit recursion of their sub-block."""
    ops = lk.scl_chunk_schedule(64, 16)
    subs = np.flatnonzero(ops[:, 0] == lk.OP_SUB)
    assert len(subs) == 4 and (ops[subs, 2] == 16).all()
    for at in subs:
        inner = ops[at + 1 : at + 1 + ops[at, 4]]
        assert (inner[:, 0] == lk.OP_BIT).sum() == 16
        assert inner[-1, 0] == lk.OP_COMBINE and inner[-1, 2] == 16
    plain = lk.scl_chunk_schedule(64, 0)
    assert (plain[:, 0] == lk.OP_BIT).sum() == 64 and not (plain[:, 0] == lk.OP_SUB).any()
    assert plain[-1].tolist() == [lk.OP_COMBINE, 0, 64, 0, 0]


# ---- decoders ----------------------------------------------------------------

@pytest.mark.parametrize("fast", [True, False])
def test_large_sc_decode_matches_jax(fast, interpret):
    n_len = 1024
    det = tdet.CRC8()
    frozen, sent, llr = _channel(n_len, 512, det, 1.5, 16, 11)
    jdec = jlarge.LargeSCDecoder(n_len, frozen, detector=jdet.CRC8(), chunk=128,
                                 fast_chunks=fast, backend="pallas")
    dec = large.LargeSCDecoder(n_len, frozen, detector=det, chunk=128, fast_chunks=fast,
                               device="cpu")
    if fast:
        assert set(dec.classes.tolist()) > {large._MIXED}
    got = dec.decode(torch.as_tensor(llr))
    want = jdec.decode(jnp.asarray(llr))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (~got[2].numpy()).any() and got[2].numpy().any()
    assert not ((got[0].numpy() != sent).any(1) & got[2].numpy()).any()


@pytest.mark.parametrize("carry", [
    None, pytest.param(torch.bfloat16, marks=pytest.mark.slow)])
def test_large_scl_decode_matches_jax(carry, interpret):
    """(1024, 512) CA-SCL-8 CRC16, chunk 64, sub-block 16, at a noise level
    where some blocks fail the CRC: decode_paths and decode."""
    n_len = 1024
    det = tdet.CRC16()
    frozen, sent, llr = _channel(n_len, 512, det, 1.0, 16, 12)
    jdec = jlarge.LargeSCLDecoder(
        n_len, frozen, list_size=8, detector=jdet.CRC16(), chunk=64, backend="pallas",
        unroll=1, carry_dtype=None if carry is None else jnp.bfloat16)
    dec = large.LargeSCLDecoder(n_len, frozen, list_size=8, detector=det, chunk=64,
                                carry_dtype=carry, device="cpu")
    assert set(dec.classes.tolist()) == set(range(5))
    paths = dec.decode_paths(torch.as_tensor(llr))
    jpaths = [np.asarray(a) for a in jdec.decode_paths(jnp.asarray(llr))]
    np.testing.assert_array_equal(paths[0].numpy(), jpaths[0])
    np.testing.assert_allclose(paths[1].numpy(), jpaths[1], **TOL)
    np.testing.assert_array_equal(paths[2].numpy(), jpaths[2])
    # the JAX selection, run on the paths it just decoded
    jdec.decode_paths = lambda _: tuple(jnp.asarray(a) for a in jpaths)
    got = dec.decode(torch.as_tensor(llr))
    for a, b in zip(got, jdec.decode(jnp.asarray(llr))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ok = got[2].numpy()
    assert (~ok).any() and ok.any()
    assert not ((got[0].numpy() != sent).any(1) & ok).any()


@pytest.mark.parametrize("n_len,chunk,list_size", [(512, 64, 4), (1024, 128, 8)])
def test_large_scl_tree_matches_jax(n_len, chunk, list_size):
    """schedule="tree" against the JAX package's tree schedule at JAX's own
    case (512, chunk 64, L = 4) and at (1024, chunk 128, L = 8), sub-block
    16, CRC16, at a noise level where some blocks fail the CRC and some
    pass on a path other than the best-metric one: the active paths'
    codewords, flags and info bits equal, metrics within 1e-4. The JAX
    reference runs its static-mask chunk recursion (backend "xla"), which
    tests/test_large.py holds bit-equal to its Pallas chunk kernel on the
    tree schedule; it is the faster of the two in interpret mode."""
    det = tdet.CRC16()
    frozen, sent, llr = _channel(n_len, n_len // 2, det, 1.25, 24, n_len + list_size)
    kw = dict(list_size=list_size, detector=det, chunk=chunk)
    jdec = jlarge.LargeSCLDecoder(n_len, frozen, backend="xla", schedule="tree",
                                  **dict(kw, detector=jdet.CRC16()))
    dec = large.LargeSCLDecoder(n_len, frozen, schedule="tree", device="cpu", **kw)
    walked = {leaf.kind for leaf in dec.sched_tree.leaves() if leaf.length >= chunk}
    assert NodeKind.RATE0 in walked and len(walked) >= 2  # rate-0 and a forking leaf
    paths = dec.decode_paths(torch.as_tensor(llr))
    jpaths = [np.asarray(a) for a in jdec.decode_paths(jnp.asarray(llr))]
    active = jpaths[2]
    np.testing.assert_array_equal(paths[2].numpy(), active)
    np.testing.assert_array_equal(paths[0].numpy()[active], jpaths[0][active])
    np.testing.assert_allclose(paths[1].numpy(), jpaths[1], **TOL)
    jdec.decode_paths = lambda _: tuple(jnp.asarray(a) for a in jpaths)
    got = dec.decode(torch.as_tensor(llr))
    for a, b in zip(got, jdec.decode(jnp.asarray(llr))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ok = got[2].numpy()
    assert (~ok).any() and ok.any()
    assert not ((got[0].numpy() != sent).any(1) & ok).any()
    best = paths[0].numpy()[np.arange(len(ok)), paths[1].numpy().argmax(1)]
    assert (ok & (best != got[1].numpy()).any(1)).any()


def test_one_chunk_and_noiseless_round_trip():
    """N equal to the chunk (no outer stages), and encode -> noiseless BPSK
    -> decode returning the info bits for every class of chunk."""
    n_len = 256
    det = tdet.CRC8()
    frozen, sent, _ = _channel(n_len, 128, det, 1.0, 4, 3)
    enc = PolarEncoder(n_len, frozen, detector=det, device="cpu")
    clean = 2.0 * (1.0 - 2.0 * enc.encode(torch.as_tensor(sent)).to(torch.float32))
    for chunk in (256, 32):
        sc = large.LargeSCDecoder(n_len, frozen, detector=det, chunk=chunk, device="cpu")
        scl = large.LargeSCLDecoder(n_len, frozen, list_size=4, detector=det, chunk=chunk,
                                    device="cpu")
        for dec in (sc, scl):
            info, _, ok = dec.decode(clean)
            np.testing.assert_array_equal(info.numpy(), sent)
            assert ok.all()
    one = large.LargeSCLDecoder(n_len, frozen, list_size=4, detector=det, chunk=n_len,
                                device="cpu")
    llr = torch.as_tensor(np.random.default_rng(5).normal(0.5, 2, (4, n_len)),
                          dtype=torch.float32)
    word, metrics = one.decode_packed(llr)
    start = torch.full((4, 4), NEG)
    start[:, 0] = 0.0
    bits, _, met = lk.masked_scl_chunk_plain(
        llr[:, None, :].expand(4, 4, n_len).contiguous(), one._masks_t[0], start,
        one._subs_t[0])
    assert torch.equal(word, bits.T) and torch.equal(metrics, met)


# ---- carry and dispatch ------------------------------------------------------

@pytest.mark.parametrize("family", ["large_sc", "large_scl", "large_scl_tree"])
def test_carry_large_families(family):
    n_len = 1024
    frozen = frozen_bits(n_len, 512, 0.0, "BB")
    det = jdet.CRC16()
    if family == "large_sc":
        jdec = jlarge.LargeSCDecoder(n_len, frozen, detector=det, chunk=128,
                                     backend="xla")
        extra = dict(chunk=128, fast_chunks=True)
    elif family == "large_scl":
        jdec = jlarge.LargeSCLDecoder(n_len, frozen, list_size=8, detector=det,
                                      chunk=64, backend="xla", carry_dtype=jnp.bfloat16)
        extra = dict(chunk=64, fast_chunks=True, subblock=16, carry_dtype="bfloat16",
                     list_size=8, sub_classes=jdec._sub_classes)
    else:  # the tree schedule: its leaves are those of the JAX tree schedule's tree
        jdec = jlarge.LargeSCLDecoder(n_len, frozen, list_size=8, detector=det,
                                      chunk=64, backend="xla", schedule="tree")
        family = "large_scl"
        extra = dict(chunk=64, fast_chunks=True, subblock=16, list_size=8,
                     schedule="tree", leaves=leaf_table(jlarge.build_tree(n_len, jdec.frozen)))
    G, g0 = det.affine_map(jdec.info_length - det.tail_bits)
    state = dict(family=family, frozen=jdec.frozen, info_pos=jdec.info_pos,
                 systematic=True, detector="crc16", affine_G=np.asarray(G),
                 affine_g0=np.asarray(g0), mask_chunks=jdec._mask_chunks,
                 classes=jlarge._classify_chunks(jdec._mask_chunks), **extra)
    enc, dec = from_jax_state(state, device="cpu")
    assert type(dec) is (large.LargeSCDecoder if family == "large_sc"
                         else large.LargeSCLDecoder)
    if "leaves" in extra:
        assert dec.schedule == "tree"
        with pytest.raises(ValueError, match="leaves"):
            from_jax_state(dict(state, leaves=extra["leaves"][1:]), device="cpu")
    elif family == "large_scl":
        assert dec.carry_dtype == torch.bfloat16 and dec.subblock == 16
    tampered = state["mask_chunks"].copy()
    tampered[3, 5] = ~tampered[3, 5]
    with pytest.raises(ValueError, match="mask_chunks"):
        from_jax_state(dict(state, mask_chunks=tampered), device="cpu")
    with pytest.raises(ValueError, match="classes"):
        from_jax_state(dict(state, classes=np.zeros_like(state["classes"])), device="cpu")


def _fake_cuda(*shapes_dtypes):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return [torch.empty(s, dtype=d, device="cuda") for s, d in shapes_dtypes]


def test_chunk_kernels_never_fall_back(monkeypatch):
    """A CUDA tensor reaches the kernel or raises; it never takes the plain
    version. Here there is no card and no nvcc, so every launch raises: L =
    3 reaches K7's launch like L = 4, and so does L = 129, which the
    device-memory kernel (csrc/scl_wide.cu) takes."""
    called = []
    monkeypatch.setattr(lk, "masked_sc_chunk_plain", lambda *a: called.append(a))
    monkeypatch.setattr(lk, "masked_scl_chunk_plain", lambda *a: called.append(a))
    before = dict(lk.LAUNCHES)
    llr, mask = _fake_cuda(((8, 64), torch.float32), ((64,), torch.uint8))
    with pytest.raises((RuntimeError, OSError)):
        lk.masked_sc_chunk(llr, mask)
    llr, met, sub = _fake_cuda(((8, 4, 64), torch.float32), ((8, 4), torch.float32),
                               ((4,), torch.int32))
    with pytest.raises((RuntimeError, OSError)):
        lk.masked_scl_chunk(llr, mask, met, sub)
    llr3, met3 = _fake_cuda(((8, 3, 64), torch.float32), ((8, 3), torch.float32))
    with pytest.raises((RuntimeError, OSError)):  # a list size below its capacity
        lk.masked_scl_chunk(llr3, mask, met3)
    llr129, met129 = _fake_cuda(((8, 129, 64), torch.float32), ((8, 129), torch.float32))
    assert lk.scl_library(129, 64) == "scl_wide"
    with pytest.raises((RuntimeError, OSError)):  # above the shared-memory kernels' lists
        lk.masked_scl_chunk(llr129, mask, met129)
    assert not called and lk.LAUNCHES == before


def test_unported_arms_raise():
    """schedule="tree" with int8 or with fast_chunks=False raises
    ValueError, as in the JAX package, which qualifies int8 on the scan
    schedule only and whose tree leaves are the SSCL fast-leaf rules."""
    frozen = frozen_bits(1024, 512, 0.0)
    with pytest.raises(ValueError, match="fast_chunks=False"):
        large.LargeSCLDecoder(1024, frozen, schedule="tree", fast_chunks=False,
                              device="cpu")
    with pytest.raises(ValueError, match="fast_chunks=False"):
        jlarge.LargeSCLDecoder(1024, frozen, schedule="tree", fast_chunks=False)
    with pytest.raises(ValueError, match="int8"):
        large.LargeSCLDecoder(1024, frozen, schedule="tree", dtype=torch.int8,
                              device="cpu")
    with pytest.raises(ValueError, match="int8"):
        jlarge.LargeSCLDecoder(1024, frozen, schedule="tree", dtype=jnp.int8)
    with pytest.raises(ValueError, match="float32 or int8"):
        large.LargeSCDecoder(1024, frozen, dtype=torch.bfloat16, device="cpu")
    with pytest.raises(ValueError, match="power of 2"):
        large.LargeSCDecoder(1024, frozen, chunk=100, device="cpu")
