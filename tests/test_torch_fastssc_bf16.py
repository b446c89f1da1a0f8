"""The bf16 Fast-SSC family against the JAX package's bf16 Pallas arm (the
TPU kernel K3 with state_dtype=bfloat16, run in interpret mode): the
FastSSCDecoder at (256, 128) with kernel_span 256 (one root call) and 64
(bf16 glue above, bipolar state below), SCLDecoder(list_size=1) in bf16
with its telescoped metric, and AdaptiveDecoder(fast_dtype=bfloat16) with
the list schedule (3, 12); and the carry of a bf16 adaptive decoder.

Inputs from a seed with numpy: Gaussian LLRs, and CRC-coded blocks
through BPSK/AWGN. Tolerances: codewords, info bits and CRC flags equal;
the L = 1 metric, a float sum in another order, within rtol = atol =
1e-4. The JAX package's bf16 XLA arm is not the reference: it sums a REP
leaf in bf16 and decides with jnp.sign, so a few codewords differ from
its Pallas arm (`test_jax_bf16_arms_disagree` pins that)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from polar_codes_tpu.models import detectors as jdet  # noqa: E402
from polar_codes_tpu.models.adaptive import AdaptiveDecoder as JaxAdaptive  # noqa: E402
from polar_codes_tpu.models.fastssc import FastSSCDecoder as JaxFastSSC  # noqa: E402
from polar_codes_tpu.models.scl import SCLDecoder as JaxSCLDecoder  # noqa: E402
from polar_codes_tpu.ops import fg as jfg  # noqa: E402
from polar_codes_tpu.ops.fastssc_kernel import build_fs_hybrid_decode  # noqa: E402

from polar_codes_torch.construction import frozen_bits  # noqa: E402
from polar_codes_torch.models import detectors as tdet  # noqa: E402
from polar_codes_torch.models.adaptive import AdaptiveDecoder  # noqa: E402
from polar_codes_torch.models.encoder import PolarEncoder  # noqa: E402
from polar_codes_torch.models.fastssc import FastSSCDecoder  # noqa: E402
from polar_codes_torch.models.scl import SCLDecoder  # noqa: E402
from polar_codes_torch.models.tree import NodeKind, build_tree  # noqa: E402
from polar_codes_torch.ops import fastssc_kernel as fk  # noqa: E402
from polar_codes_torch.utils.carry import from_jax_state, leaf_table  # noqa: E402

N_LEN, K_LEN = 256, 128
BATCH = 37
TOL = dict(rtol=1e-4, atol=1e-4)


def _pallas(jdec, span, batch):
    """The JAX bf16 Pallas arm of a Fast-SSC decoder, in interpret mode."""
    return build_fs_hybrid_decode(jdec, batch_tile=batch, kernel_span=span, interpret=True,
                                  state_dtype=jnp.bfloat16)


@pytest.fixture(scope="module")
def frozen():
    return frozen_bits(N_LEN, K_LEN, 0.0)


@pytest.fixture(scope="module")
def gauss():
    return np.random.default_rng(0).normal(0, 2, (BATCH, N_LEN)).astype(np.float32)


def _channel(detector, batch, ebn0_db, seed):
    """CRC-coded blocks through BPSK + AWGN (numpy noise)."""
    frozen = frozen_bits(N_LEN, K_LEN, 0.0)
    enc = PolarEncoder(N_LEN, frozen, detector=detector, device="cpu")
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (batch, K_LEN)).astype(np.uint8)
    code = enc.encode(torch.as_tensor(info)).numpy()
    sigma = 1.0 / np.sqrt(2.0 * 10.0 ** (ebn0_db / 10.0) * K_LEN / N_LEN)
    return (1.0 - 2.0 * code + rng.normal(0, sigma, code.shape)).astype(np.float32)


@pytest.mark.parametrize("span", [256, 64])
def test_fastssc_bf16_matches_jax_pallas(frozen, gauss, span):
    jdec = JaxFastSSC(N_LEN, frozen, dtype=jnp.bfloat16, backend="pallas")
    want = np.asarray(_pallas(jdec, span, BATCH)(jnp.asarray(gauss)))
    calls = []

    def record(sched, llr, root):
        calls.append((root, llr.dtype))
        return fk.fastssc_subtree_plain(sched, llr, root)

    dec = FastSSCDecoder(N_LEN, frozen, dtype=torch.bfloat16, kernel_span=span, device="cpu",
                         subtree_fn=record)
    got = dec.decode_to_codeword(torch.as_tensor(gauss)).numpy()
    np.testing.assert_array_equal(got, want)
    assert {c[1] for c in calls} == {torch.bfloat16}
    assert [c[0] for c in calls] == [True] if span == N_LEN else (
        len(calls) > 2 and not any(c[0] for c in calls))


def test_jax_bf16_arms_disagree(frozen, gauss):
    """The reference's two bf16 arms: the port equals the Pallas arm, and
    the XLA arm differs from it on a few of these 37 codewords (2 at this
    seed), so the XLA arm cannot be the reference."""
    jdec = JaxFastSSC(N_LEN, frozen, dtype=jnp.bfloat16, backend="pallas")
    pallas = np.asarray(_pallas(jdec, N_LEN, BATCH)(jnp.asarray(gauss)))
    xla = np.asarray(JaxFastSSC(N_LEN, frozen, dtype=jnp.bfloat16).decode_to_codeword(
        jnp.asarray(gauss)))
    differ = int((pallas != xla).any(axis=1).sum())
    assert 0 < differ < BATCH // 4
    got = FastSSCDecoder(N_LEN, frozen, dtype=torch.bfloat16, device="cpu").decode_to_codeword(
        torch.as_tensor(gauss)).numpy()
    np.testing.assert_array_equal(got, pallas)


def test_bf16_family_rules():
    """f is the product form (exact), g and ZeroR round once to bf16, REP
    sums the stored values in f32 in span order, -0.0 decides 1."""
    rng = np.random.default_rng(5)
    a = torch.as_tensor(rng.normal(0, 4, 4096)).to(torch.bfloat16)
    b = torch.as_tensor(rng.normal(0, 4, 4096)).to(torch.bfloat16)
    u = torch.as_tensor(rng.choice([-1.0, 1.0], 4096)).to(torch.bfloat16)
    fam = fk.family(torch.bfloat16)
    ja, jb = (jnp.asarray(v.float().numpy(), jnp.bfloat16) for v in (a, b))
    np.testing.assert_array_equal(fam.f(a, b).float().numpy(),
                                  np.asarray(jfg.f_minsum(ja, jb), np.float32))
    assert torch.equal(fam.g(a, b, u), (b.float() + u.float() * a.float()).to(torch.bfloat16))
    assert torch.equal(fam.zero_r(a, b), (b.float() + a.float()).to(torch.bfloat16))
    rep = build_tree(4, [0, 1, 2])
    assert rep.kind == NodeKind.REP
    x = torch.tensor([[1e8], [1.0], [-1e8], [-0.5]]).to(torch.bfloat16)  # f32 in order: -0.5
    assert fk.fastssc_subtree_plain(fk.build_schedule(rep), x, True)[:, 0].tolist() == [1] * 4
    rate1 = fk.build_schedule(build_tree(4, []))
    x = torch.tensor([[-0.0], [0.0], [-1.0], [2.0]]).to(torch.bfloat16)
    assert fk.fastssc_subtree_plain(rate1, x, True)[:, 0].tolist() == [1, 0, 1, 0]


def test_scl_list1_bf16_matches_jax_pallas(frozen):
    """SCLDecoder(list_size=1, bf16) decodes through the bf16 Fast-SSC
    decoder, as the JAX package's does, and recovers its metric."""
    det = tdet.CRC16()
    llr = _channel(det, BATCH, 1.5, 2)
    jdec = JaxSCLDecoder(N_LEN, frozen, list_size=1, detector=jdet.CRC16(),
                         dtype=jnp.bfloat16, backend="pallas")
    jdec._sc._pallas_fn = _pallas(jdec._sc, N_LEN, BATCH)
    dec = SCLDecoder(N_LEN, frozen, list_size=1, detector=det, dtype=torch.bfloat16,
                     device="cpu")
    assert dec._sc.dtype == torch.bfloat16 and dec.enum_span == 0
    x = torch.as_tensor(llr)
    cw, m, act = dec.decode_paths(x)
    jcw, jm, jact = jdec.decode_paths(jnp.asarray(llr))
    np.testing.assert_array_equal(cw.numpy(), np.asarray(jcw))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_array_equal(act.numpy(), np.asarray(jact))
    got = dec.decode(x)
    for a, b in zip(got, jdec.decode(jnp.asarray(llr))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[2].numpy().any() and (~got[2].numpy()).any()


def test_adaptive_bf16_matches_jax(frozen):
    """AdaptiveDecoder(fast_dtype=bfloat16, list_schedule=(3, 12)): the
    bf16 Fast-SSC pass against JAX's Pallas arm, then CA-SCL-3 and -12 on
    the CRC32 failures against its list stages."""
    llr = _channel(tdet.CRC32(), BATCH, 1.0, 3)
    jdec = JaxAdaptive(N_LEN, frozen, fast_dtype=jnp.bfloat16, list_schedule=(3, 12))
    jdec.fast.backend = "pallas"
    jdec.fast._pallas_fn = _pallas(jdec.fast, N_LEN, BATCH)
    dec = AdaptiveDecoder(N_LEN, frozen, fast_dtype=torch.bfloat16, list_schedule=(3, 12),
                          device="cpu")
    got = dec.decode(torch.as_tensor(llr))
    want = jdec.decode(jnp.asarray(llr))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert dec.rerun_rows[0] > dec.rerun_rows[-1] > 0  # both stages re-decoded rows


def test_carry_bf16_adaptive_any_lists(frozen):
    """utils.carry: a JAX adaptive decoder with a bf16 fast pass and the
    list schedule (3, 64) carries into the port's, every array checked."""
    jdec = JaxAdaptive(N_LEN, frozen, fast_dtype=jnp.bfloat16, list_schedule=(3, 64))
    det = jdec.detector
    G, g0 = det.affine_map(jdec.info_length - det.tail_bits)
    state = dict(family="adaptive", frozen=np.asarray(jdec.fast.frozen),
                 info_pos=np.asarray(jdec.fast.info_pos), systematic=True,
                 detector=det.name, affine_G=G, affine_g0=g0, fast_dtype="bfloat16",
                 list_size=jdec.list_size, list_schedule=list(jdec.list_schedule),
                 leaves=leaf_table(jdec.fast.tree))
    _, dec = from_jax_state(state, device="cpu")
    assert dec.fast.dtype == torch.bfloat16 and dec.list_schedule == (3, 64)
    assert [s.words for s in dec.stages] == [1, 2]
