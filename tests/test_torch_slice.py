"""The port's slice end to end against the JAX package: encode -> BPSK ->
AWGN -> CA-SCL decode on shared LLRs (made with numpy), plus the C++
reference's decisions, the state carry, and the port's independence from
JAX. Decisions (info bits, codewords, CRC flags) must be equal; path
metrics agree within rtol = atol = 1e-4."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from polar_codes_tpu.models import detectors as jdet  # noqa: E402
from polar_codes_tpu.models.adaptive import AdaptiveDecoder as JaxAdaptive  # noqa: E402
from polar_codes_tpu.models.depthfirst import DepthFirstDecoder as JaxDepthFirst  # noqa: E402
from polar_codes_tpu.models.encoder import PolarEncoder as JaxEncoder  # noqa: E402
from polar_codes_tpu.models.errorlocator import ErrorLocator as JaxErrorLocator  # noqa: E402
from polar_codes_tpu.models.fastssc import FastSSCDecoder as JaxFastSSC  # noqa: E402
from polar_codes_tpu.models.puncturer import Puncturer as JaxPuncturer  # noqa: E402
from polar_codes_tpu.models.scan import FastSScanDecoder as JaxFastSScan  # noqa: E402
from polar_codes_tpu.models.scan import ScanDecoder as JaxScan  # noqa: E402
from polar_codes_tpu.models.scl import SCLDecoder as JaxSCLDecoder  # noqa: E402

from polar_codes_torch.construction import frozen_bits  # noqa: E402
from polar_codes_torch.dsp import bpsk_modulate  # noqa: E402
from polar_codes_torch.models import detectors as tdet  # noqa: E402
from polar_codes_torch.models.adaptive import AdaptiveDecoder  # noqa: E402
from polar_codes_torch.models.depthfirst import DepthFirstDecoder  # noqa: E402
from polar_codes_torch.models.encoder import PolarEncoder  # noqa: E402
from polar_codes_torch.models.errorlocator import ErrorLocator  # noqa: E402
from polar_codes_torch.models.fastssc import FastSSCDecoder  # noqa: E402
from polar_codes_torch.models.large import LargeSCDecoder, LargeSCLDecoder  # noqa: E402
from polar_codes_torch.models.scan import FastSScanDecoder, ScanDecoder  # noqa: E402
from polar_codes_torch.models.scl import SCLDecoder  # noqa: E402
from polar_codes_torch.ops import _build  # noqa: E402
from polar_codes_torch.utils.carry import from_jax_state, leaf_table  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
ALL_KINDS_FROZEN = sorted(set(
    list(range(16)) + [16, 17, 18, 20, 24] + [32, 33, 34, 35, 36, 37, 38] + [48]))


def _channel(code, ebn0_db, rate, seed):
    """BPSK + AWGN with numpy noise, so both packages see the same LLRs."""
    esn0 = 10.0 ** (ebn0_db / 10.0) * rate
    sigma = 1.0 / np.sqrt(2.0 * esn0)
    noise = np.random.default_rng(seed).normal(0.0, sigma, code.shape)
    return (bpsk_modulate(torch.as_tensor(code)).numpy() + noise).astype(np.float32)


def _assert_same_decode(dec, jdec, llr):
    info, cw, ok = dec.decode(torch.as_tensor(llr))
    jinfo, jcw, jok = jax.jit(jdec.decode)(jnp.asarray(llr))
    np.testing.assert_array_equal(info.numpy(), np.asarray(jinfo))
    np.testing.assert_array_equal(cw.numpy(), np.asarray(jcw))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    return info.numpy(), ok.numpy()


def _slice(n_len, k_len, batch, ebn0_db, seed):
    frozen = frozen_bits(n_len, k_len, 0.0)
    enc = PolarEncoder(n_len, frozen, detector=tdet.CRC16(), device="cpu")
    dec = SCLDecoder(n_len, frozen, list_size=8, detector=tdet.CRC16(), device="cpu")
    jenc = JaxEncoder(n_len, frozen, detector=jdet.CRC16())
    jdec = JaxSCLDecoder(n_len, frozen, list_size=8, detector=jdet.CRC16())
    info = np.random.default_rng(seed).integers(0, 2, (batch, k_len)).astype(np.uint8)
    code = enc.encode(torch.as_tensor(info)).numpy()
    np.testing.assert_array_equal(code, np.asarray(jax.jit(jenc.encode)(jnp.asarray(info))))
    llr = _channel(code, ebn0_db, k_len / n_len, seed + 1)
    got, ok = _assert_same_decode(dec, jdec, llr)
    sent = enc.detector.generate(torch.as_tensor(info)).numpy()
    wrong = (got != sent).any(axis=1)
    assert not (wrong == 0)[~ok].any()  # a failed CRC is never a right block
    return wrong


def test_slice_n256_matches_jax():
    wrong = _slice(256, 128, 32, 1.5, 0)
    assert wrong.mean() < 0.5


@pytest.mark.slow
def test_slice_full_width_matches_jax():
    """The main path's (1024, 512) CA-SCL-8 CRC16 at its full width."""
    wrong = _slice(1024, 512, 32, 2.0, 4)
    assert wrong.mean() < 0.25


def test_decode_paths_match_jax():
    frozen = ALL_KINDS_FROZEN
    dec = SCLDecoder(64, frozen, list_size=4, enum_span=8, max_enum_k=3, device="cpu")
    jdec = JaxSCLDecoder(64, frozen, list_size=4, enum_span=8, max_enum_k=3)
    llr = np.random.default_rng(9).normal(0, 2, (24, 64)).astype(np.float32)
    cw, m, act = dec.decode_paths(torch.as_tensor(llr))
    jcw, jm, jact = jax.jit(jdec.decode_paths)(jnp.asarray(llr))
    np.testing.assert_array_equal(cw.numpy(), np.asarray(jcw))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(act.numpy(), np.asarray(jact))


def test_leaf_longer_than_kernel_span():
    """Leaves of 16 above an 8-wide kernel span go to the subtree function
    as one-leaf subtrees (JAX widens to full L there instead); slot order
    may differ inside, decode() outputs may not."""
    dec = SCLDecoder(64, ALL_KINDS_FROZEN, list_size=4, kernel_span=8,
                     detector=tdet.CRC8(), device="cpu")
    assert any(leaf.length > 8 for leaf in dec.tree.leaves())
    jdec = JaxSCLDecoder(64, ALL_KINDS_FROZEN, list_size=4, detector=jdet.CRC8())
    llr = np.random.default_rng(5).normal(0.5, 1.5, (32, 64)).astype(np.float32)
    _assert_same_decode(dec, jdec, llr)
    wide = SCLDecoder(64, ALL_KINDS_FROZEN, list_size=4, detector=tdet.CRC8(),
                      device="cpu")
    for a, b in zip(dec.decode(torch.as_tensor(llr)), wide.decode(torch.as_tensor(llr))):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_non_systematic_matches_jax():
    frozen = frozen_bits(64, 40, 0.0)
    dec = SCLDecoder(64, frozen, list_size=4, systematic=False, detector=tdet.CRC8(),
                     device="cpu")
    jdec = JaxSCLDecoder(64, frozen, list_size=4, systematic=False, detector=jdet.CRC8())
    llr = np.random.default_rng(6).normal(0.8, 1.2, (16, 64)).astype(np.float32)
    _assert_same_decode(dec, jdec, llr)


def test_ca_scl8_matches_cpp_reference_decisions():
    """tests/test_crosscheck.py's C++ SclAvxFloat L=8 decisions, with the
    reference's leaf structure (enum_span=0), on every block."""
    llr = np.fromfile(os.path.join(DATA, "cc_llr.bin"), dtype=np.float32).reshape(64, 256)
    want = np.unpackbits(np.fromfile(os.path.join(DATA, "cc_scl_out.bin"), np.uint8))
    dec = SCLDecoder(256, frozen_bits(256, 128, 0.0, "BB"), list_size=8,
                     detector=tdet.CRC8(), enum_span=0, device="cpu")
    got, _, _ = dec.decode(torch.as_tensor(llr))
    np.testing.assert_array_equal(got.numpy(), want.reshape(64, 128))


def _jax_state(jdec):
    det = jdec.detector
    state = {
        "frozen": np.asarray(jdec.frozen), "info_pos": np.asarray(jdec.info_pos),
        "list_size": jdec.list_size, "enum_span": jdec.enum_span,
        "max_enum_k": jdec.max_enum_k, "systematic": jdec.systematic,
        "detector": det.name, "leaves": leaf_table(jdec.tree),
    }
    if det.tail_bits:
        G, g0 = det.affine_map(jdec.info_length - det.tail_bits)
        state.update(affine_G=G, affine_g0=g0)
    return state


def _jax_family_state(family, frozen):
    """The carried state of a JAX decoder of another family, read off it."""
    det = jdet.CRC32()
    if family == "fastssc":
        jdec = JaxFastSSC(128, frozen, detector=det, dtype=jnp.int8)
        tree, extra = jdec.tree, {"fast_dtype": "int8"}
    elif family == "adaptive":
        jdec = JaxAdaptive(128, frozen, fast_dtype=jnp.int8, list_schedule=(2, 8))
        tree = jdec.fast.tree
        extra = {"fast_dtype": "int8", "list_size": jdec.list_size,
                 "list_schedule": list(jdec.list_schedule)}
        jdec.frozen, jdec.info_pos = jdec.fast.frozen, jdec.fast.info_pos
    elif family == "depthfirst":
        jdec = JaxDepthFirst(128, frozen, detector=det, trial_limit=5)
        tree, extra = jdec.tree, {"trial_limit": jdec.trial_limit}
    elif family == "errorlocator":
        jdec = JaxErrorLocator(128, frozen)
        jdec.info_pos = np.setdiff1d(np.arange(128), jdec.frozen)
        jdec.info_length = jdec.info_pos.size
        jpunct = JaxPuncturer(120, frozen)
        tree, extra = None, {"punctured_length": jpunct.block_length,
                             "output_positions": jpunct.output_positions}
    else:
        cls = JaxScan if family == "scan" else JaxFastSScan
        jdec = cls(128, frozen, detector=det, iterations=3)
        tree, extra = jdec.tree, {"iterations": jdec.iterations}
    G, g0 = det.affine_map(jdec.info_length - det.tail_bits)
    if tree is not None:
        extra["leaves"] = leaf_table(tree)
    return dict(family=family, frozen=np.asarray(jdec.frozen),
                info_pos=np.asarray(jdec.info_pos), systematic=True,
                detector=det.name, affine_G=G, affine_g0=g0, **extra)


@pytest.mark.parametrize("family,cls", [
    ("fastssc", FastSSCDecoder), ("adaptive", AdaptiveDecoder),
    ("scan", ScanDecoder), ("fastsscan", FastSScanDecoder),
    ("depthfirst", DepthFirstDecoder), ("errorlocator", ErrorLocator)])
def test_carry_each_family(family, cls):
    frozen = frozen_bits(128, 64, 0.0)
    state = _jax_family_state(family, frozen)
    enc, dec = from_jax_state(state, device="cpu")
    assert type(dec) is cls and enc.detector.name == "crc32"
    if family == "errorlocator":  # the puncturer's positions, checked beside it
        bad = state["output_positions"].copy()
        bad[0] = 127
        with pytest.raises(ValueError, match="output_positions"):
            from_jax_state(dict(state, output_positions=bad), device="cpu")
    else:
        assert dec.detector.name == "crc32"
        np.testing.assert_array_equal(leaf_table(dec.tree), state["leaves"])
    if family == "adaptive":
        assert dec.list_schedule == (2, 8) and dec.fast.dtype == torch.int8
    if family == "depthfirst":
        assert dec.trial_limit == 5
    if family in ("scan", "fastsscan"):
        assert dec.iterations == 3
    if family in ("scan", "fastsscan", "depthfirst"):
        # the Fast-SSC tree's leaves are not the SCAN or RATE0-only tree's
        fast = _jax_family_state("fastssc", frozen)["leaves"]
        with pytest.raises(ValueError, match="leaves"):
            from_jax_state(dict(state, leaves=fast), device="cpu")
    with pytest.raises(ValueError, match="affine_G"):
        from_jax_state(dict(state, affine_G=1 - state["affine_G"]), device="cpu")


@pytest.mark.parametrize("make", [
    lambda f: PolarEncoder(64, f),
    lambda f: SCLDecoder(64, f, list_size=8),
    lambda f: SCLDecoder(64, f, list_size=1),
    lambda f: FastSSCDecoder(64, f),
    lambda f: AdaptiveDecoder(64, f, detector=tdet.CRC8()),
    lambda f: ScanDecoder(64, f),
    lambda f: FastSScanDecoder(64, f),
    lambda f: LargeSCDecoder(64, f, chunk=16),
    lambda f: LargeSCLDecoder(64, f, chunk=16),
    lambda f: LargeSCLDecoder(64, f, chunk=16, schedule="tree"),
    lambda f: DepthFirstDecoder(64, f),
    lambda f: ErrorLocator(64, f),
], ids=["encoder", "scl", "scl1", "fastssc", "adaptive", "scan", "fastsscan",
        "large_sc", "large_scl", "large_scl_tree", "depthfirst", "errorlocator"])
def test_entry_points_default_to_the_card(make):
    """Without device=, every entry point lives on the card; with no card
    it raises and never drops to the CPU quietly."""
    if torch.cuda.is_available():
        assert make(frozen_bits(64, 32, 0.0)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(frozen_bits(64, 32, 0.0))


def test_every_kernel_source_carries_its_notes():
    """Each kernel the build knows has a source that names the TPU kernel
    it replaces and what bounds it on the card."""
    assert set(_build.KERNELS) == {
        "butterfly_encode", "scl_subtree", "fastssc_subtree", "scan_sweep",
        "large_sc_chunk", "large_scl_chunk", "large_scl_lists", "scl_wide"}
    for name in _build.KERNELS:
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert "Replaces" in text and "bounds it on an H100" in text, name


def test_carry_round_trips_and_catches_tampering():
    frozen = frozen_bits(256, 128, 0.0)
    jdec = JaxSCLDecoder(256, frozen, list_size=8, detector=jdet.CRC16())
    state = _jax_state(jdec)
    enc, dec = from_jax_state(state, device="cpu")
    assert dec.list_size == 8 and dec.detector.name == "crc16"
    np.testing.assert_array_equal(enc.info_pos, state["info_pos"])
    np.testing.assert_array_equal(leaf_table(dec.tree), state["leaves"])
    tampered = dict(state, frozen=np.where(frozen == frozen[0], 255, frozen))
    with pytest.raises(ValueError, match="info_pos"):
        from_jax_state(tampered, device="cpu")
    bad_crc = dict(state, affine_g0=1 - state["affine_g0"])
    with pytest.raises(ValueError, match="affine_g0"):
        from_jax_state(bad_crc, device="cpu")


def test_port_imports_without_jax():
    """The port never imports JAX or the JAX package: import every module
    of it with both made unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['polar_codes_tpu'] = None\n"
        "import polar_codes_torch.models.scl, polar_codes_torch.models.encoder\n"
        "import polar_codes_torch.models.fastssc, polar_codes_torch.models.adaptive\n"
        "import polar_codes_torch.models.scan, polar_codes_torch.ops.fastssc_kernel\n"
        "import polar_codes_torch.ops.scan_kernel, polar_codes_torch.ops.scl_kernel_bl\n"
        "import polar_codes_torch.ops.butterfly_kernel, polar_codes_torch.utils.device\n"
        "import polar_codes_torch.dsp, polar_codes_torch.utils.carry\n"
        "import polar_codes_torch.utils.timing, polar_codes_torch.ops._build\n"
        "import polar_codes_torch.models.depthfirst, polar_codes_torch.models.puncturer\n"
        "import polar_codes_torch.models.errorlocator, polar_codes_torch.tools\n"
        "import polar_codes_torch.sim.errorlocator_app, polar_codes_torch.sim.cli\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'polar_codes_tpu'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
