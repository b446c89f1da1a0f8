"""SCLDecoder at list sizes other than 2, 4, 8, 16 and 32 against the JAX
package's XLA arm: L = 3, 6 and 12 at (256, 128) CRC16, and L = 64 at
(128, 64) CRC16 (and at (64, 32) in char), where the decision bits take
two packed words; plus the packed-word helpers at one word against their
single-word form, and the carry of a JAX CA-SCL-64 decoder.

Inputs from a seed with numpy: CRC-coded blocks through BPSK/AWGN as
float LLRs ("gauss"), and the same LLRs rounded and clipped to integers in
[-2, 2] ("ints": metric ties, exact zeros). Tolerances: every path's
codeword, the chosen codeword, the info bits and the CRC flags equal;
metrics within rtol = atol = 1e-4 in float32 (the port sums in span
order, XLA may reassociate) and exactly equal in char (int8)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from polar_codes_tpu.models import detectors as jdet  # noqa: E402
from polar_codes_tpu.models.scl import SCLDecoder as JaxSCLDecoder  # noqa: E402
from polar_codes_tpu.ops import scl_kernel_bl as jkbl  # noqa: E402

from polar_codes_torch.construction import frozen_bits  # noqa: E402
from polar_codes_torch.models import detectors as tdet  # noqa: E402
from polar_codes_torch.models.encoder import PolarEncoder  # noqa: E402
from polar_codes_torch.models.scl import SCLDecoder  # noqa: E402
from polar_codes_torch.ops import scl_kernel_bl as kbl  # noqa: E402
from polar_codes_torch.utils.carry import from_jax_state, leaf_table  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
BATCH = 16
# list size -> (N, K)
CODES = {3: (256, 128), 6: (256, 128), 12: (256, 128), 64: (128, 64)}
CHAR64 = (64, 32)  # the char L = 64 case: a shorter code compiles faster in JAX


def _channel(n, k, seed, kind, ebn0_db=0.5):
    """CRC16-coded blocks through BPSK + AWGN (numpy noise), as float
    LLRs or rounded to integers in [-2, 2]."""
    frozen = frozen_bits(n, k, 0.0)
    enc = PolarEncoder(n, frozen, detector=tdet.CRC16(), device="cpu")
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (BATCH, k)).astype(np.uint8)
    code = enc.encode(torch.as_tensor(info)).numpy()
    sigma = 1.0 / np.sqrt(2.0 * 10.0 ** (ebn0_db / 10.0) * k / n)
    llr = (1.0 - 2.0 * code + rng.normal(0, sigma, code.shape)).astype(np.float32)
    if kind == "ints":
        llr = np.clip(np.round(2.0 * llr), -2, 2).astype(np.float32)
    return frozen, llr


@pytest.fixture(scope="module")
def jax_decoders():
    """One jitted JAX decoder per (L, dtype), shared by the module's tests
    (a JAX L = 64 decode compiles in ~10 s)."""
    cache = {}

    def get(n_list, dtype=jnp.float32, code=None):
        n, k = code or CODES[n_list]
        key = (n_list, jnp.dtype(dtype).name, n)
        if key not in cache:
            jdec = JaxSCLDecoder(n, frozen_bits(n, k, 0.0), list_size=n_list,
                                 detector=jdet.CRC16(), dtype=dtype)
            assert jdec.backend == "xla"
            # one program for both: the tree decode compiles once
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
    return got[2].numpy()


@pytest.mark.parametrize("kind", ["gauss", "ints"])
@pytest.mark.parametrize("n_list", [3, 6, 12, 64])
def test_scl_list_matches_jax_xla(jax_decoders, n_list, kind):
    n, k = CODES[n_list]
    frozen, llr = _channel(n, k, n_list, kind)
    dec = SCLDecoder(n, frozen, list_size=n_list, detector=tdet.CRC16(), device="cpu")
    assert dec.words == kbl.n_words(n_list) == (2 if n_list == 64 else 1)
    ok = _compare(dec, jax_decoders(n_list), llr, exact=kind == "ints")
    assert ok.any() and (~ok).any()  # CRCs that hold and CRCs that fail


def test_scl_list64_char_matches_jax_xla(jax_decoders):
    """int8 at L = 64: the int16 state of K1's char family, metrics exact."""
    n, k = CHAR64
    frozen, llr = _channel(n, k, 640, "gauss")
    q = np.clip(np.round(llr * 10.0), -127, 127).astype(np.int8)
    dec = SCLDecoder(n, frozen, list_size=64, detector=tdet.CRC16(), dtype=torch.int8,
                     device="cpu")
    ok = _compare(dec, jax_decoders(64, jnp.int8, CHAR64), q, exact=True)
    assert ok.any()


def test_scl_list64_subtree_words(jax_decoders):
    """L = 64 at (128, 64): the subtree calls return two packed words,
    [2, span, B], and the widths JAX's schedule gives."""
    n, k = CODES[64]
    frozen, llr = _channel(n, k, 64, "gauss")
    calls = []

    def record(sched, x, met):
        out = kbl.scl_subtree_plain(sched, x, met)
        calls.append((sched, out[0].shape))
        return out

    dec = SCLDecoder(n, frozen, list_size=64, kernel_span=32, subtree_fn=record, device="cpu")
    dec.decode_packed(torch.as_tensor(llr))
    jdec = JaxSCLDecoder(n, frozen, list_size=64)
    assert len(calls) > 2
    for sched, shape in calls:
        assert shape == (2, sched.span, BATCH)
    assert max(s.w_out for s, _ in calls) == 64
    for node in (dec.tree.left, dec.tree.right):
        jnode = jdec.tree.left if node is dec.tree.left else jdec.tree.right
        for w_in in (1, 8, 64):
            assert kbl.static_width(node, w_in, 64) == jkbl._static_width(jdec, jnode, w_in)


def _pack01_one_word(b01):  # the single-word helpers as they were before words
    acc = b01[0].to(torch.int32)
    for l in range(1, b01.shape[0]):
        acc = acc | (b01[l].to(torch.int32) << l)
    return acc


def _take_packed_one_word(word, src, w_out):
    acc = (word >> src[0][None, :]) & 1
    for l in range(1, w_out):
        acc = acc | (((word >> src[l][None, :]) & 1) << l)
    return acc


@pytest.mark.parametrize("w", [1, 5, 32])
def test_one_word_helpers_unchanged(w):
    """At one word the helpers give the single-word results (bit 31 too),
    and the JAX emitter's; at two words plane l lands in word l // 32."""
    rng = np.random.default_rng(w)
    span, n_b = 16, 8
    b01 = torch.as_tensor(rng.integers(0, 2, (w, span, n_b)).astype(np.int32))
    word = kbl.pack01(b01)
    assert torch.equal(word, _pack01_one_word(b01))
    np.testing.assert_array_equal(
        word.numpy(), np.asarray(jkbl._BlEmitter._pack01(jnp.asarray(b01.numpy()))))
    src = torch.as_tensor(rng.integers(0, w, (w, n_b)).astype(np.int32))
    assert torch.equal(kbl.take_packed(word, src, w), _take_packed_one_word(word, src, w))
    np.testing.assert_array_equal(kbl.packed_bipolar(word, w).numpy(), 1.0 - 2.0 * b01.numpy())
    sel = src[0]
    assert torch.equal(kbl.plane(word, sel), (word >> sel[None, :]) & 1)

    wide = torch.as_tensor(rng.integers(0, 2, (32 + w, span, n_b)).astype(np.int32))
    words = kbl.pack01(wide, 2)
    assert words.shape == (2, span, n_b)
    assert torch.equal(words[0], _pack01_one_word(wide[:32]))
    assert torch.equal(words[1], _pack01_one_word(wide[32:]))
    assert torch.equal(kbl.unpack(words, 32 + w, 2), wide)
    src = torch.as_tensor(rng.integers(0, 32 + w, (32 + w, n_b)).astype(np.int64))
    forked = kbl.take_packed(words, src, 32 + w, 2)
    want = torch.gather(wide, 0, src[:, None, :].expand(-1, span, -1))
    assert torch.equal(kbl.unpack(forked, 32 + w, 2), want)


def test_carry_scl_list64():
    """utils.carry: a JAX CA-SCL-64 decoder's state builds the port's, with
    two packed words a position."""
    n, k = CODES[64]
    jdec = JaxSCLDecoder(n, frozen_bits(n, k, 0.0), list_size=64, detector=jdet.CRC16())
    det = jdec.detector
    G, g0 = det.affine_map(jdec.info_length - det.tail_bits)
    state = dict(frozen=np.asarray(jdec.frozen), info_pos=np.asarray(jdec.info_pos),
                 list_size=64, enum_span=jdec.enum_span, max_enum_k=jdec.max_enum_k,
                 systematic=True, detector=det.name, affine_G=G, affine_g0=g0,
                 leaves=leaf_table(jdec.tree))
    _, dec = from_jax_state(state, device="cpu")
    assert isinstance(dec, SCLDecoder) and dec.list_size == 64 and dec.words == 2
