"""The port's char (int8) and bf16 families against the JAX package: the
signed-zero repair of the product-form f, K1's char and bf16 families
under SCLDecoder(dtype=...), the carry's dtype key and the family
wrappers' dispatch (the large-N decoders' char families are in
test_torch_char_large.py). The JAX kernels run in interpret mode.

Tolerances: the char family holds integer LLRs, so every sum is exact and
decisions, perms and metrics must be equal (atol 0). The bf16 family cannot
be pinned to the JAX package bit for bit on the CPU (XLA keeps part of the
f/g chain above bf16 precision), so it is held with the tolerances of
tests/test_scl_pallas.py test_bf16_state_matches_xla_bf16: metrics rtol 0.02
/ atol 0.25, the ML slot rtol 0.005 / atol 0.06, under 2% of codeword bits
differing."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from polar_codes_tpu.models import detectors as jdet  # noqa: E402
from polar_codes_tpu.models import large as jlarge  # noqa: E402
from polar_codes_tpu.models.scl import SCLDecoder as JaxSCLDecoder  # noqa: E402
from polar_codes_tpu.ops import fg as jfg  # noqa: E402
from polar_codes_tpu.ops import scl_kernel_bl as jkbl  # noqa: E402

from polar_codes_torch.construction import frozen_bits  # noqa: E402
from polar_codes_torch.models import detectors as tdet  # noqa: E402
from polar_codes_torch.models import large  # noqa: E402
from polar_codes_torch.models.encoder import PolarEncoder  # noqa: E402
from polar_codes_torch.models.scl import SCLDecoder  # noqa: E402
from polar_codes_torch.ops import fg as tfg  # noqa: E402
from polar_codes_torch.ops import large_kernel as lk  # noqa: E402
from polar_codes_torch.ops import scl_kernel_bl as kbl  # noqa: E402
from polar_codes_torch.utils.carry import from_jax_state  # noqa: E402

NEG = -1.0e30
N_LEN, K_LEN, SPAN, BATCH = 256, 128, 64, 16


def _quantised(n_len, k_len, detector, ebn0_db, batch, seed):
    """(frozen, sent info with its CRC, int8 LLRs) of BPSK over AWGN made
    with numpy and quantised as the simulator does (x10, round, clip to
    [-127, 127]); one LLR of the first block is set to -128."""
    frozen = frozen_bits(n_len, k_len, 0.0, "BB")
    rng = np.random.default_rng(seed)
    info = torch.as_tensor(rng.integers(0, 2, (batch, k_len)), dtype=torch.uint8)
    code = PolarEncoder(n_len, frozen, detector=detector, device="cpu").encode(info).numpy()
    sigma = np.sqrt(1.0 / (2.0 * 10.0 ** (ebn0_db / 10.0) * k_len / n_len))
    y = (1.0 - 2.0 * code) + sigma * rng.standard_normal(code.shape)
    q = np.clip(np.round(10.0 * 2.0 * y / sigma**2), -127, 127).astype(np.int8)
    q[0, n_len // 2] = -128
    sent = detector.generate(info) if detector is not None else info
    return frozen, sent.numpy(), q


# ---- the repair: signed zeros in the product-form f ------------------------

def test_signed_zero_f_matches_jax_bits():
    """f_minsum and f_minsum_sat give JAX's bits at every input, signed zeros
    included (torch.sign maps -0.0 to +0.0, jnp.sign keeps it)."""
    vals = np.array([0.0, -0.0, 1.0, -1.0, 3.0, -127.0, 127.0, -128.0], np.float32)
    a, b = (v.ravel() for v in np.meshgrid(vals, vals, indexing="ij"))
    for tf, jf in ((tfg.f_minsum, jfg.f_minsum), (tfg.f_minsum_sat, jfg.f_minsum_sat)):
        got = tf(torch.as_tensor(a), torch.as_tensor(b)).numpy()
        want = np.asarray(jf(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    got = tfg.f_minsum_sat(torch.as_tensor(a, dtype=torch.bfloat16),
                           torch.as_tensor(b, dtype=torch.bfloat16))
    want = jfg.f_minsum_sat(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def test_large_sc_signed_zero_regression():
    """(256, 128) LargeSCDecoder(chunk=64, fast_chunks=False) on integer
    LLRs in [-2, 2]: zeros meet f at every level. With torch.sign's zero,
    25 of these 64 codewords differed from the JAX package."""
    frozen = frozen_bits(N_LEN, K_LEN, 0.0, "BB")
    llr = np.random.default_rng(0).integers(-2, 3, (64, N_LEN)).astype(np.float32)
    jdec = jlarge.LargeSCDecoder(N_LEN, frozen, chunk=64, fast_chunks=False, backend="xla")
    dec = large.LargeSCDecoder(N_LEN, frozen, chunk=64, fast_chunks=False, device="cpu")
    np.testing.assert_array_equal(dec.decode_to_codeword(torch.as_tensor(llr)).numpy(),
                                  np.asarray(jdec.decode_to_codeword(jnp.asarray(llr))))


# ---- K1 char and SCLDecoder(dtype=int8) ----------------------------------------

# tests/test_scl_pallas.py test_all_leaf_kinds: every leaf kind below span 32
ALL_KINDS_FROZEN = sorted(set(
    list(range(16)) + [16, 17, 18, 20, 24] + [32, 33, 34, 35, 36, 37, 38] + [48]))


@pytest.mark.parametrize("n_len", [64, pytest.param(N_LEN, marks=pytest.mark.slow)])
def test_k1_char_calls_match_jax_kernel(n_len):
    """Every K1 call of an int8 decode (int16 state) against the JAX
    interpret kernel of that subtree (bf16 state, char rules): bits, perms
    and metrics equal; the input holds -128. N = 64 is the all-leaf-kinds
    code at span 32, ENUM span 8 (k 3); N = 256 the (256, 128) code at
    span 64."""
    if n_len == 64:
        frozen, span, tree = ALL_KINDS_FROZEN, 32, dict(enum_span=8, max_enum_k=3)
        q = np.random.default_rng(21).integers(-40, 60, (8, n_len)).astype(np.int8)
        q[0, 40] = -128
    else:
        frozen, _, q = _quantised(n_len, K_LEN, tdet.CRC16(), 1.0, BATCH, 21)
        span, tree = SPAN, {}
    batch = q.shape[0]
    jdec = JaxSCLDecoder(n_len, frozen, list_size=8, dtype=jnp.int8, **tree)
    run = jkbl.build_bl_hybrid_decode_paths(jdec, batch_tile=batch, kernel_span=span,
                                            interpret=True, state_dtype=jnp.bfloat16)
    jax.eval_shape(run.raw_packed, jax.ShapeDtypeStruct((batch, n_len), jnp.int8))
    jcalls = {(n.offset, n.length, w_in): (w_out, call)
              for n, w_in, w_out, call in run.subtree_info}
    calls = []

    def record(sched, llr, metrics):
        out = kbl.scl_subtree_plain(sched, llr, metrics)
        calls.append((sched, llr, metrics, out))
        return out

    dec = SCLDecoder(n_len, frozen, list_size=8, dtype=torch.int8, kernel_span=span,
                     subtree_fn=record, device="cpu", **tree)
    dec.decode_packed(torch.as_tensor(q))
    assert len(calls) == len(jcalls) >= 2
    assert {c[1].dtype for c in calls} == {torch.int16}
    assert {c[0].w_in for c in calls} == {1, 8}  # a widening call and steady ones
    assert min(int(c[1].min()) for c in calls) <= -127  # -128 reached the kernels
    for sched, x, m, (bits, perm, met) in calls:
        w_out, jcall = jcalls[(sched.node.offset, sched.node.length, sched.w_in)]
        assert sched.w_out == w_out
        jbits, jperm, jmet = jcall(jnp.asarray(x.numpy(), jnp.float32),
                                   jnp.asarray(m.numpy()))
        np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
        np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
        np.testing.assert_array_equal(met.numpy(), np.asarray(jmet))


@pytest.mark.parametrize("arm", ["xla", pytest.param("interpret", marks=pytest.mark.slow)])
def test_scl_int8_decode_matches_jax_xla_and_interpret(arm):
    """The case of tests/test_scl_pallas.py test_int8_char_matches_xla_int8
    on channel LLRs: decode_paths and decode equal to the JAX int8 XLA path,
    or to its Pallas arm in interpret mode (bf16 state, as the JAX package
    builds it), metrics exactly equal."""
    det = tdet.CRC16()
    batch = BATCH
    frozen, sent, q = _quantised(N_LEN, K_LEN, det, 1.0, batch, 22)
    if arm == "xla":
        jdec = JaxSCLDecoder(N_LEN, frozen, list_size=8, detector=jdet.CRC16(),
                             dtype=jnp.int8)
    else:
        jdec = JaxSCLDecoder(N_LEN, frozen, list_size=8, detector=jdet.CRC16(),
                             dtype=jnp.int8, backend="pallas")
        jdec._PALLAS_TILE = batch
        jdec._pallas_fn = jkbl.build_bl_hybrid_decode_paths(
            jdec, batch_tile=batch, kernel_span=SPAN, interpret=True,
            state_dtype=jnp.bfloat16)
    dec = SCLDecoder(N_LEN, frozen, list_size=8, detector=det, dtype=torch.int8,
                     kernel_span=SPAN, device="cpu")
    for got, want in zip(dec.decode_paths(torch.as_tensor(q)),
                         jdec.decode_paths(jnp.asarray(q))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    info, _, ok = got = dec.decode(torch.as_tensor(q))
    for a, b in zip(got, jdec.decode(jnp.asarray(q))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ok.numpy().any() and (~ok.numpy()).any()
    assert not ((info.numpy() != sent).any(1) & ok.numpy()).any()


def test_scl_int8_list_one_is_fastssc_char():
    """L = 1 decodes through the int8 Fast-SSC decoder, as in JAX."""
    det = tdet.CRC8()
    frozen, _, q = _quantised(64, 40, det, 2.0, 8, 23)
    dec = SCLDecoder(64, frozen, list_size=1, detector=det, dtype=torch.int8,
                     device="cpu")
    assert dec._sc.dtype == torch.int8
    jdec = JaxSCLDecoder(64, frozen, list_size=1, detector=jdet.CRC8(), dtype=jnp.int8)
    for got, want in zip(dec.decode_paths(torch.as_tensor(q)),
                         jdec.decode_paths(jnp.asarray(q))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bf16 = SCLDecoder(64, frozen, list_size=1, dtype=torch.bfloat16, device="cpu")
    assert bf16._sc.dtype == torch.bfloat16  # K3's bf16 family


# ---- SCLDecoder(dtype=bfloat16) ----------------------------------------------

def test_scl_bf16_decode_matches_jax_within_bf16():
    """bf16 state against the JAX XLA bf16 path, with the tolerances of
    tests/test_scl_pallas.py; the widening call runs in float32 state and
    the steady calls in bf16."""
    frozen = frozen_bits(N_LEN, K_LEN, 0.0, "BB")
    llr = np.random.default_rng(24).normal(0, 2, (32, N_LEN)).astype(np.float32)
    dtypes = []

    def record(sched, x, m):
        dtypes.append((sched.w_in < sched.w_out, x.dtype))
        return kbl.scl_subtree_plain(sched, x, m)

    dec = SCLDecoder(N_LEN, frozen, list_size=8, detector=tdet.CRC16(),
                     dtype=torch.bfloat16, kernel_span=SPAN, subtree_fn=record,
                     device="cpu")
    jdec = JaxSCLDecoder(N_LEN, frozen, list_size=8, detector=jdet.CRC16(),
                         dtype=jnp.bfloat16)
    cw, m, _ = dec.decode_paths(torch.as_tensor(llr))
    cw_ref, m_ref, _ = jdec.decode_paths(jnp.asarray(llr).astype(jnp.bfloat16))
    m, m_ref = m.numpy(), np.asarray(m_ref)
    np.testing.assert_allclose(m, m_ref, rtol=0.02, atol=0.25)
    mismatch = np.mean(cw.numpy() != np.asarray(cw_ref))
    assert mismatch < 0.02, f"codeword bit mismatch {mismatch:.4f}"
    np.testing.assert_allclose(m[:, 0], m_ref[:, 0], rtol=0.005, atol=0.06)
    assert set(dtypes) == {(True, torch.float32), (False, torch.bfloat16)}


def test_k1_bf16_plain_rounds_once_per_store():
    """The bf16 plain version's f and g equal the float32 arithmetic
    rounded to bf16 once: f exact (one input's magnitude), g = b -+ a."""
    rng = np.random.default_rng(25)
    a = torch.as_tensor(rng.normal(0, 4, 4096), dtype=torch.bfloat16)
    b = torch.as_tensor(rng.normal(0, 4, 4096), dtype=torch.bfloat16)
    u = torch.as_tensor(rng.choice([-1.0, 1.0], 4096), dtype=torch.float32)
    fam = kbl.family(torch.bfloat16)
    a32, b32 = a.float(), b.float()
    assert torch.equal(fam.f(a, b).float(), tfg.f_minsum_bits(a32, b32))
    assert torch.equal(fam.g(a, b, u), (b32 + u * a32).to(torch.bfloat16))
    assert kbl.family(torch.int16) is not fam and kbl.family(torch.float32) is not fam


# ---- carry and dispatch ------------------------------------------------------------

@pytest.mark.parametrize("family,dtype", [("scl", "int8"), ("scl", "bfloat16"),
                                          ("large_sc", "int8"), ("large_scl", "int8")])
def test_carry_dtype(family, dtype):
    n_len = 256
    frozen = frozen_bits(n_len, 128, 0.0, "BB")
    det = jdet.CRC16()
    jdec = JaxSCLDecoder(n_len, frozen, list_size=8, detector=det)
    G, g0 = det.affine_map(jdec.info_length - det.tail_bits)
    state = dict(family=family, frozen=jdec.frozen, info_pos=jdec.info_pos,
                 systematic=True, detector="crc16", affine_G=np.asarray(G),
                 affine_g0=np.asarray(g0), dtype=dtype, list_size=8, enum_span=16,
                 max_enum_k=4, chunk=64, fast_chunks=True, subblock=16)
    _, dec = from_jax_state(state, device="cpu")
    assert dec.dtype == getattr(torch, dtype)
    if family == "large_scl":
        assert dec.subblock is None and (dec.classes == large._MIXED).all()


def _fake_cuda(*shapes_dtypes):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return [torch.empty(s, dtype=d, device="cuda") for s, d in shapes_dtypes]


def test_family_wrappers_never_fall_back(monkeypatch):
    """K1 takes int16 (char) and bf16 LLRs and K6/K7 the char family: a CUDA
    tensor reaches the kernel or raises, never the plain version; a dtype
    or family no kernel has raises ValueError."""
    called = []
    for mod, name in ((kbl, "scl_subtree_plain"), (lk, "masked_sc_chunk_plain"),
                      (lk, "masked_scl_chunk_plain")):
        monkeypatch.setattr(mod, name, lambda *a: called.append(a))
    before = (dict(kbl.LAUNCHES), dict(lk.LAUNCHES))
    dec = SCLDecoder(64, frozen_bits(64, 32, 0.0), list_size=8, kernel_span=32,
                     device="cpu")
    sched = dec.schedule(dec.tree.right, 8)
    for dtype in (torch.int16, torch.bfloat16):
        llr, met = _fake_cuda(((8, 32, 16), dtype), ((16, 8), torch.float32))
        with pytest.raises(RuntimeError, match="nvcc"):
            kbl.scl_subtree(sched, llr, met)
    llr, met = _fake_cuda(((8, 32, 16), torch.int8), ((16, 8), torch.float32))
    with pytest.raises(ValueError, match="int16"):
        kbl.scl_subtree(sched, llr, met)
    x, mask = _fake_cuda(((8, 64), torch.float32), ((64,), torch.uint8))
    with pytest.raises((RuntimeError, OSError)):
        lk.masked_sc_chunk(x, mask, "char")
    x3, met3 = _fake_cuda(((8, 4, 64), torch.float32), ((8, 4), torch.float32))
    with pytest.raises((RuntimeError, OSError)):
        lk.masked_scl_chunk(x3, mask, met3, None, "char")
    with pytest.raises(ValueError, match="families"):
        lk.masked_sc_chunk(x, mask, "bfloat16")
    assert not called and (dict(kbl.LAUNCHES), dict(lk.LAUNCHES)) == before
