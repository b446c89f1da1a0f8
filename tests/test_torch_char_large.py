"""The char (int8) families of the large-N decoders against the JAX
package: K6 and K7 in their char family (saturating g, decisions llr < 0,
f unclipped) beside the JAX kernels in interpret mode, and
LargeSCDecoder / LargeSCLDecoder(dtype=int8) end to end. Integer LLRs make
every sum exact, so decisions, perms and metrics must be equal (atol 0)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import polar_codes_tpu.ops.large_kernel as jlk  # noqa: E402
from polar_codes_tpu.models import detectors as jdet  # noqa: E402
from polar_codes_tpu.models import large as jlarge  # noqa: E402

from polar_codes_torch.models import detectors as tdet  # noqa: E402
from polar_codes_torch.models import large  # noqa: E402
from polar_codes_torch.ops import large_kernel as lk  # noqa: E402

from test_torch_char import NEG, N_LEN, K_LEN, _quantised  # noqa: E402


# ---- K6 char and LargeSCDecoder(dtype=int8) --------------------------------------

@pytest.fixture
def interpret(monkeypatch):
    """Force the JAX chunk kernels into interpret mode on small tiles."""
    for name in ("build_masked_sc_chunk_kernel", "build_masked_scl_chunk_kernel"):
        orig = getattr(jlk, name)
        monkeypatch.setattr(jlk, name, lambda *a, _o=orig, **kw: _o(
            *a, **{**kw, "interpret": True, "batch_tile": 8}))


def test_k6_char_plain_matches_jax_kernel():
    """Integer LLRs with zeros, +-127 and -128, a random mask."""
    chunk = 64
    rng = np.random.default_rng(26)
    mask = rng.random(chunk) < 0.5
    llr = rng.integers(-128, 128, (12, chunk)).astype(np.float32)
    llr[:, ::7] = 0.0
    llr[:4, 1::9] = -128.0
    fn = jlk.build_masked_sc_chunk_kernel(chunk, int8=True, batch_tile=8, interpret=True)
    jx, ju = fn(jnp.asarray(llr), jnp.asarray(mask, jnp.float32))
    x, u = lk.masked_sc_chunk_plain(torch.as_tensor(llr), torch.as_tensor(mask), "char")
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))


def test_large_sc_int8_decode_matches_jax(interpret):
    det = tdet.CRC8()
    frozen, sent, q = _quantised(N_LEN, K_LEN, det, 1.0, 16, 27)
    jdec = jlarge.LargeSCDecoder(N_LEN, frozen, detector=jdet.CRC8(), dtype=jnp.int8,
                                 chunk=64, backend="pallas")
    dec = large.LargeSCDecoder(N_LEN, frozen, detector=det, dtype=torch.int8, chunk=64,
                               device="cpu")
    assert (dec.classes == large._MIXED).all() and dec.family == "char"
    got = dec.decode(torch.as_tensor(q))
    for a, b in zip(got, jdec.decode(jnp.asarray(q))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not ((got[0].numpy() != sent).any(1) & got[2].numpy()).any()


# ---- K7 char and LargeSCLDecoder(dtype=int8) ---------------------------------------

@pytest.mark.parametrize("sub", [16, pytest.param(None, marks=pytest.mark.slow)])
def test_k7_char_plain_matches_jax_kernel(sub):
    """Call by call against the JAX int8 kernel, with and without sub-block
    classes, on integer LLRs with zeros and -128, metrics with inactive
    slots and all live."""
    chunk, batch, n_list = 64, 8, 4
    rng = np.random.default_rng(28)
    fn = jax.jit(jlk.build_masked_scl_chunk_kernel(
        chunk, n_list, int8=True, batch_tile=batch, interpret=True, sub=sub))
    mask = np.concatenate([np.arange(16) == 0, np.arange(16) % 2 == 1,
                           np.arange(16) < 15, np.zeros(16)]).astype(bool)
    codes = jlarge._classify_chunks(list(mask.reshape(-1, 16)))
    start = np.full((batch, n_list), NEG, np.float32)
    start[:, 0] = 0.0
    for metrics in (start, rng.integers(-40, 0, (batch, n_list)).astype(np.float32)):
        llr = rng.integers(-128, 128, (batch, n_list, chunk)).astype(np.float32)
        llr[..., ::5] = 0.0
        args = [jnp.asarray(llr), jnp.asarray(mask, jnp.float32), jnp.asarray(metrics)]
        if sub:
            args.append(jnp.asarray(codes))
        jbits, jperm, jmet = fn(*args)
        bits, perm, met = lk.masked_scl_chunk_plain(
            torch.as_tensor(llr), torch.as_tensor(mask), torch.as_tensor(metrics),
            torch.as_tensor(codes) if sub else None, "char")
        want = np.asarray(jbits) < 0  # [B, L, M] bipolar -> {0,1}
        got = (bits.numpy()[:, None, :] >> np.arange(n_list)[None, :, None]) & 1
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
        np.testing.assert_array_equal(met.numpy(), np.asarray(jmet))


def test_large_scl_int8_decode_matches_jax(interpret):
    """(128, 64) CA-SCL-4 CRC8, chunk 32, sub-block 16 asked for (int8
    turns it off, as in JAX): decode_paths and decode equal, metrics
    exactly."""
    det = tdet.CRC8()
    frozen, sent, q = _quantised(128, 64, det, 0.5, 8, 29)
    jdec = jlarge.LargeSCLDecoder(128, frozen, list_size=4, detector=jdet.CRC8(),
                                  dtype=jnp.int8, chunk=32, backend="pallas", unroll=1,
                                  carry_dtype=jnp.bfloat16)
    dec = large.LargeSCLDecoder(128, frozen, list_size=4, detector=det,
                                dtype=torch.int8, chunk=32, subblock=16,
                                carry_dtype=torch.bfloat16, device="cpu")
    assert dec.subblock is None and jdec.subblock is None
    assert (dec.classes == large._MIXED).all()
    paths = dec.decode_paths(torch.as_tensor(q))
    jpaths = [np.asarray(a) for a in jdec.decode_paths(jnp.asarray(q))]
    for a, b in zip(paths, jpaths):
        np.testing.assert_array_equal(a.numpy(), b)
    jdec.decode_paths = lambda _: tuple(jnp.asarray(a) for a in jpaths)
    got = dec.decode(torch.as_tensor(q))
    for a, b in zip(got, jdec.decode(jnp.asarray(q))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[2].numpy().any() and (~got[2].numpy()).any()
    assert not ((got[0].numpy() != sent).any(1) & got[2].numpy()).any()
