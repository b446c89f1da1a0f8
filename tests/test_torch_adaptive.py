"""CRC32 and the adaptive decoder (Fast-SSC, then CA-SCL on CRC failures)
against the JAX package on shared LLRs made with numpy: float32 and int8
fast passes, schedules (8,) and (2, 8), decode() and decode_fused(). The
list stages then see integer-valued LLRs, where metric ties are common:
the SCL kernel's plain version is held against the JAX interpret kernel
on such LLRs call by call. Decisions and CRC flags must be equal; the
integer metrics are exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from polar_codes_tpu.models import detectors as jdet  # noqa: E402
from polar_codes_tpu.models.adaptive import AdaptiveDecoder as JaxAdaptive  # noqa: E402
from polar_codes_tpu.models.scl import SCLDecoder as JaxSCLDecoder  # noqa: E402
from polar_codes_tpu.ops import scl_kernel_bl as jkbl  # noqa: E402

from polar_codes_torch.construction import frozen_bits  # noqa: E402
from polar_codes_torch.models import detectors as tdet  # noqa: E402
from polar_codes_torch.models.adaptive import AdaptiveDecoder  # noqa: E402
from polar_codes_torch.models.encoder import PolarEncoder  # noqa: E402
from polar_codes_torch.models.scl import SCLDecoder  # noqa: E402
from polar_codes_torch.ops import scl_kernel_bl as kbl  # noqa: E402

N_LEN, K_LEN = 128, 64  # K - 32 = 32: CRC32 covers whole words


@pytest.mark.parametrize("data_len", [32, 96, 480])
def test_crc32_equals_jax(data_len, rng):
    G, g0 = tdet.CRC32().affine_map(data_len)
    JG, Jg0 = jdet.CRC32().affine_map(data_len)
    np.testing.assert_array_equal(G, JG)
    np.testing.assert_array_equal(g0, Jg0)
    block = rng.integers(0, 2, (16, data_len + 32)).astype(np.uint8)
    got = tdet.CRC32().generate(torch.as_tensor(block)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdet.CRC32().generate(jnp.asarray(block))))
    for row in got[:4]:
        np.testing.assert_array_equal(row, jdet.CRC32().generate_np(row))
    data = np.packbits(block[0, :data_len]).tobytes()
    assert tdet.crc32c_bytes(data) == jdet.crc32c_bytes(data)
    got[1:, 5] ^= 1  # corrupt every block but the first
    ok = tdet.CRC32().check(torch.as_tensor(got)).numpy()
    np.testing.assert_array_equal(ok, np.asarray(jdet.CRC32().check(jnp.asarray(got))))
    assert ok[0] and not ok[1:].any()
    assert tdet.detector_by_name("crc32") == tdet.CRC32()


def _channel(batch, ebn0_db, seed):
    """CRC32 codewords through BPSK + AWGN (numpy noise): float LLRs and
    the simulator's int8 quantisation of them (x10, round half to even,
    clip to [-127, 127])."""
    frozen = frozen_bits(N_LEN, K_LEN, 0.0)
    enc = PolarEncoder(N_LEN, frozen, detector=tdet.CRC32(), device="cpu")
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (batch, K_LEN)).astype(np.uint8)
    code = enc.encode(torch.as_tensor(info)).numpy()
    sigma = 1.0 / np.sqrt(2.0 * 10.0 ** (ebn0_db / 10.0) * K_LEN / N_LEN)
    llr = (1.0 - 2.0 * code + rng.normal(0, sigma, code.shape)).astype(np.float32)
    quant = torch.clamp(torch.round(torch.as_tensor(llr) * 10), -127, 127).to(torch.int8)
    return frozen, llr, quant.numpy()


@pytest.mark.parametrize("schedule", [(8,), (2, 8)])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_adaptive_matches_jax(dtype, schedule):
    frozen, llr, quant = _channel(48, 1.5, 1)
    x = quant if dtype == "int8" else llr
    tdt, jdt = {"float32": (torch.float32, jnp.float32), "int8": (torch.int8, jnp.int8)}[dtype]
    dec = AdaptiveDecoder(N_LEN, frozen, fast_dtype=tdt, list_schedule=schedule, device="cpu")
    jdec = JaxAdaptive(N_LEN, frozen, fast_dtype=jdt, list_schedule=schedule)
    assert dec.detector.name == "crc32" and len(dec.stages) == len(schedule)
    got = dec.decode(torch.as_tensor(x))
    assert dec.rerun_rows[0] > 0  # some rows did escalate
    for a, b in zip(got, jdec.decode(jnp.asarray(x))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    fused = dec.decode_fused(torch.as_tensor(x))
    for a, b, c in zip(fused, jax.jit(jdec.decode_fused)(jnp.asarray(x)), got):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), c.numpy())


def test_adaptive_single_block_and_detector_rule():
    frozen, llr, _ = _channel(4, 3.0, 2)
    dec = AdaptiveDecoder(N_LEN, frozen, device="cpu")
    info, cw, ok = dec.decode(torch.as_tensor(llr[0]))
    assert info.shape == (K_LEN,) and cw.shape == (N_LEN,) and ok.shape == ()
    batch = dec.decode(torch.as_tensor(llr))
    np.testing.assert_array_equal(info.numpy(), batch[0][0].numpy())
    with pytest.raises(ValueError, match="tail bits"):
        AdaptiveDecoder(N_LEN, frozen, detector=tdet.Dummy(), device="cpu")


def test_scl_on_quantised_llrs_matches_jax_call_by_call():
    """The rerun stages decode integer-valued LLRs (their decisions are
    held above): here each K1 call's plain version against the JAX
    interpret kernel (bitplane, its bitonic merge prune at L = 8) on such
    LLRs, (64, 32) at span 32, where tied metrics are common."""
    frozen = frozen_bits(64, 32, 0.0)
    rng = np.random.default_rng(3)
    llr = np.clip(np.round(rng.normal(4, 12, (16, 64))), -127, 127).astype(np.float32)
    jdec = JaxSCLDecoder(64, frozen, list_size=8)
    run = jkbl.build_bl_hybrid_decode_paths(
        jdec, batch_tile=16, kernel_span=32, interpret=True, bitplane=True)
    jax.eval_shape(run.raw_packed, jax.ShapeDtypeStruct((16, 64), jnp.float32))
    jcalls = {(n.offset, n.length, w_in): call for n, w_in, _, call in run.subtree_info}
    calls = []

    def record(sched, x, m):
        out = kbl.scl_subtree_plain(sched, x, m)
        calls.append((sched, x, m, out))
        return out

    dec = SCLDecoder(64, frozen, list_size=8, kernel_span=32, device="cpu",
                     subtree_fn=record)
    dec.decode(torch.as_tensor(llr))
    assert len(calls) == len(jcalls) >= 2
    ties = 0
    for sched, x, m, (bits, perm, met) in calls:
        jbits, jperm, jmet = jcalls[(sched.node.offset, sched.span, sched.w_in)](
            jnp.asarray(x.numpy()), jnp.asarray(m.numpy()))
        np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
        np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
        np.testing.assert_array_equal(met.numpy(), np.asarray(jmet))
        srt = np.sort(met.numpy(), axis=1)
        ties += int((srt[:, 1:] == srt[:, :-1]).sum())
    assert ties > 0
