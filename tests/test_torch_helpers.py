"""The port's public helpers against the JAX package's, on the same NumPy
inputs: the bit conventions (utils/bits.py), the f/g glue helpers
(ops/fg.py), PolarEncoder.transform, CodeNode.node_count,
Detector.check_np, the host codec (utils/hostcodec.py) through the native
library and through its NumPy routes, and host_aggregate alone and in a
two-process gloo group. Last, an AST walk over both packages: every public
name of the JAX package has a counterpart in the port, but for the Pallas
builders (the CUDA wrappers stand for them) and the benchmark's modules."""

import ast
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from polar_codes_tpu.construction import frozen_bits as jfrozen_bits  # noqa: E402
from polar_codes_tpu.models import detectors as jdet  # noqa: E402
from polar_codes_tpu.models.encoder import PolarEncoder as JEncoder  # noqa: E402
from polar_codes_tpu.models.tree import build_tree as jbuild_tree  # noqa: E402
from polar_codes_tpu.ops import fg as jfg  # noqa: E402
from polar_codes_tpu.parallel import mesh as jmesh  # noqa: E402
from polar_codes_tpu.utils import bits as jbits  # noqa: E402
from polar_codes_tpu.utils import hostcodec as jhc  # noqa: E402
from polar_codes_torch.construction import frozen_bits  # noqa: E402
from polar_codes_torch.models import detectors as tdet  # noqa: E402
from polar_codes_torch.models.encoder import PolarEncoder  # noqa: E402
from polar_codes_torch.models.tree import build_tree  # noqa: E402
from polar_codes_torch.ops import fg  # noqa: E402
from polar_codes_torch.parallel import mesh  # noqa: E402
from polar_codes_torch.utils import bits  # noqa: E402
from polar_codes_torch.utils import hostcodec  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261028


def _rng(*salt):
    return np.random.default_rng([SEED, *salt])


# ---- utils/bits.py ---------------------------------------------------------

@pytest.mark.parametrize("shape,axis", [((40,), -1), ((3, 5, 16), -1), ((24, 3), 0),
                                        ((2, 8, 3), 1)])
def test_packbits_unpackbits_equal_jax(shape, axis):
    b = _rng(1, len(shape)).integers(0, 2, shape).astype(np.uint8)
    packed = bits.packbits(torch.from_numpy(b), axis=axis)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jbits.packbits(b, axis=axis)))
    np.testing.assert_array_equal(packed.numpy(), np.packbits(b, axis=axis))
    back = bits.unpackbits(packed, axis=axis)
    assert back.dtype == torch.uint8
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jbits.unpackbits(np.packbits(b, axis=axis), axis=axis)))
    np.testing.assert_array_equal(back.numpy(), b)


def test_packbits_refuses_a_partial_byte():
    with pytest.raises(ValueError, match="multiple of 8"):
        bits.packbits(torch.zeros(12, dtype=torch.uint8))


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_hard_decisions_and_bits_from_bipolar_equal_jax(dtype):
    x = (_rng(2).standard_normal(64) * 50).astype(dtype)
    if dtype == np.float32:
        x[:4] = [0.0, -0.0, 1.0, -1.0]
    else:
        x[:4] = [0, -127, 127, -1]
    for port_fn, jax_fn in ((bits.hard_decisions, jbits.hard_decisions),
                            (bits.bits_from_bipolar, jbits.bits_from_bipolar)):
        got = port_fn(torch.from_numpy(x))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_fn(x)))


@pytest.mark.parametrize("n", [0, 1, 3, 6])
def test_polar_generator_matrix_equals_jax(n):
    np.testing.assert_array_equal(bits.polar_generator_matrix(n),
                                  jbits.polar_generator_matrix(n))


# ---- ops/fg.py --------------------------------------------------------------

def test_combine_split_merge_equal_jax():
    rng = _rng(3)
    left = np.where(rng.integers(0, 2, (5, 16)) == 1, -1.0, 1.0).astype(np.float32)
    right = np.where(rng.integers(0, 2, (5, 16)) == 1, -1.0, 1.0).astype(np.float32)
    llr = rng.standard_normal((5, 32)).astype(np.float32)
    tl, tr = torch.from_numpy(left), torch.from_numpy(right)
    np.testing.assert_array_equal(fg.combine_bipolar(tl, tr).numpy(),
                                  np.asarray(jfg.combine_bipolar(left, right)))
    np.testing.assert_array_equal(fg.merge_bits(tl, tr).numpy(),
                                  np.asarray(jfg.merge_bits(jnp.asarray(left), jnp.asarray(right))))
    for got, want in zip(fg.split_llr(torch.from_numpy(llr)), jfg.split_llr(llr)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- PolarEncoder.transform, CodeNode.node_count, Detector.check_np --------

@pytest.mark.parametrize("n_len,k_len", [(16, 8), (256, 128), (1024, 700)])
def test_transform_and_node_count_equal_jax(n_len, k_len):
    fz = frozen_bits(n_len, k_len, 0.0)
    np.testing.assert_array_equal(fz, jfrozen_bits(n_len, k_len, 0.0))
    u = _rng(4, n_len).integers(0, 2, (6, n_len)).astype(np.uint8)
    got = PolarEncoder(n_len, fz, device="cpu").transform(torch.from_numpy(u))
    want = JEncoder(n_len, fz).transform(jnp.asarray(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), hostcodec.butterfly_rows(u))
    for kw in ({}, {"enum_span": 16, "max_enum_k": 4}):
        assert build_tree(n_len, fz, **kw).node_count() == jbuild_tree(n_len, fz, **kw).node_count()


@pytest.mark.parametrize("name", ["dummy", "crc8", "crc16", "crc32", "crc6nr", "crc11nr",
                                  "crc16nr", "crc24nrc", "cmac32", "cmac16"])
def test_check_np_equals_jax(name):
    det = tdet.detector_by_name(name)
    jd = jdet.make_detector(int(name[4:] or 32), "cmac") if name.startswith("cmac") else \
        {c.name: c for c in (jdet.Dummy, jdet.CRC8, jdet.CRC16, jdet.CRC32, jdet.CRC6NR,
                             jdet.CRC11NR, jdet.CRC16NR, jdet.CRC24NRC)}[name]()
    rng = _rng(5, len(name))
    for trial in range(4):
        block = det.generate_np(rng.integers(0, 2, 64 + det.tail_bits).astype(np.uint8))
        if trial % 2:
            block[rng.integers(0, block.size)] ^= 1  # one flipped bit
        got = det.check_np(block)
        assert isinstance(got, bool)
        assert got == jd.check_np(block)
        assert got == bool(det.check(torch.from_numpy(block)))
        if not trial % 2:
            assert got


# ---- utils/hostcodec.py ------------------------------------------------------

@pytest.fixture(params=["native", "numpy"])
def route(request, monkeypatch):
    """The host codec through the native library, or with it hidden (the
    loaders of both packages answer None), where every entry point takes
    its NumPy route."""
    if request.param == "native":
        if not hostcodec.available():
            pytest.skip("native/libhostcodec.so cannot be built here (no make or g++)")
    else:
        monkeypatch.setattr(hostcodec, "load", lambda: None)
        monkeypatch.setattr(jhc, "load", lambda: None)
        assert not hostcodec.available()
    return request.param


@pytest.mark.parametrize("poly,width,init", [(0x07, 8, 0), (0x1021, 16, 0xFFFF), (0x21, 6, 0),
                                             (0x621, 11, 0), (0xB2B117, 24, 0)])
def test_hostcodec_crcs_equal_jax(route, poly, width, init):
    rng = _rng(6, width)
    stream = rng.integers(0, 2, 123).astype(np.uint8)
    value = hostcodec.crc_msb_first(stream, poly, width, init)
    assert isinstance(value, int)
    assert value == jhc.crc_msb_first(stream, poly, width, init)
    assert value == tdet.crc_msb_first(stream, poly, width, init)
    rows = rng.integers(0, 2, (7, 61)).astype(np.uint8)
    got = hostcodec.crc_rows(rows, poly, width, init)
    want = jhc.crc_rows(rows, poly, width, init)
    assert got.dtype == np.uint64 == want.dtype
    np.testing.assert_array_equal(got, want)


def test_hostcodec_crc32c_and_butterfly_equal_jax(route):
    rng = _rng(7)
    for data in (b"", b"123456789", rng.integers(0, 256, 77).astype(np.uint8).tobytes()):
        for init in (0, 0xDEADBEEF):
            value = hostcodec.crc32c_bytes(data, init)
            assert isinstance(value, int)
            assert value == jhc.crc32c_bytes(data, init) == tdet.crc32c_bytes(data, init)
    u = rng.integers(0, 2, (5, 64)).astype(np.uint8)
    before = u.copy()
    np.testing.assert_array_equal(hostcodec.butterfly_rows(u), jhc.butterfly_rows(u))
    np.testing.assert_array_equal(u, before)  # the input is not written
    assert hostcodec.available() == jhc.available() == (route == "native")


# ---- parallel/mesh.py host_aggregate -----------------------------------------

def test_host_aggregate_without_a_group_equals_jax():
    rng = _rng(8)
    a = rng.standard_normal((2, 3)).astype(np.float32)
    tree = {"runs": torch.tensor(5), "curve": [torch.from_numpy(a), 3, (1.5, None)],
            "ok": np.array([True, False])}
    jtree = {"runs": jnp.asarray(5), "curve": [jnp.asarray(a), 3, (1.5, None)],
             "ok": np.array([True, False])}
    got, want = mesh.host_aggregate(tree), jmesh.host_aggregate(jtree)
    assert got.keys() == want.keys() and got["curve"][2][1] is None
    flat_got = [got["runs"], *got["curve"][:2], got["curve"][2][0], got["ok"]]
    flat_want = [want["runs"], *want["curve"][:2], want["curve"][2][0], want["ok"]]
    for g, w in zip(flat_got, flat_want):
        assert isinstance(g, np.ndarray)
        np.testing.assert_array_equal(g, w)
        assert g.dtype.kind == np.asarray(w).dtype.kind  # JAX holds ints in 32 bits


_AGG_WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from polar_codes_torch.parallel.mesh import host_aggregate, init_distributed, sharded_counter_step

rank, port = int(sys.argv[1]), sys.argv[2]
init_distributed(f"tcp://localhost:{port}", world_size=2, rank=rank, device="cpu")
step = sharded_counter_step(lambda n: {"runs": torch.tensor(n), "errors": torch.tensor(2 * n)})
summed = step(10 + rank)
local = {"mine": torch.tensor([rank, 7 * rank]), "scalar": 0.5 * rank}
# values the caller made from the summed counters are still the group's sums
moved = {"cpu": summed["runs"].cpu(), "clone": summed["runs"].clone(),
         "ratio": summed["errors"] / summed["runs"],
         "stack": torch.stack([summed["runs"], summed["errors"]])}
out = host_aggregate({"summed": summed, "local": local, "pair": (summed["runs"], rank),
                      "moved": moved, "item": summed["runs"].item()})
print("AGG " + json.dumps({"runs": out["summed"]["runs"].tolist(),
                           "errors": out["summed"]["errors"].tolist(),
                           "mine": out["local"]["mine"].tolist(),
                           "scalar": out["local"]["scalar"].tolist(),
                           "pair": [out["pair"][0].tolist(), out["pair"][1].tolist()],
                           "moved": {k: v.tolist() for k, v in out["moved"].items()},
                           "item": out["item"].tolist()}), flush=True)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_host_aggregate_in_a_two_process_group(tmp_path):
    """Counters that sharded_counter_step summed, and tensors computed from
    them, are read locally (the same on both ranks); every other value is
    gathered, stacked by rank."""
    script = tmp_path / "worker.py"
    script.write_text(_AGG_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(script), str(rank), port], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        finally:
            p.kill()
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.split("AGG ", 1)[1]))
    want = {"runs": 21, "errors": 42, "mine": [[0, 0], [1, 7]], "scalar": [0.0, 0.5],
            "pair": [21, [0, 1]],
            "moved": {"cpu": 21, "clone": 21, "ratio": 2.0, "stack": [21, 42]},
            "item": [21, 21]}  # a Python number is a rank's own value: gathered
    assert outs == [want, want]


# ---- the public names of both packages -----------------------------------------

# JAX names the port stands in for otherwise: the Pallas kernel builders (the
# CUDA wrappers in the same modules replace them), and utils/backend.py.
NOT_PORTED = {
    "ops/butterfly_kernel.py": {"build_encode_kernel"},
    "ops/fastssc_kernel.py": {"build_fs_hybrid_decode"},
    "ops/large_kernel.py": {"build_masked_sc_chunk_kernel", "build_masked_scl_chunk_kernel"},
    "ops/scan_kernel.py": {"build_scan_kernel", "build_scan_step_kernel"},
    "ops/scl_kernel_bl.py": {"build_bl_hybrid_decode_paths"},
    # on_tpu and resolve_backend pick XLA or Pallas from envelopes measured on
    # the TPU; the port's route is the tensor's device (utils/device.py), and
    # the plain versions are not a route on the card
    "utils/backend.py": None,
}


def _public_names(path):
    """Top-level public functions and classes of a module, and each public
    class's public methods as "Class.method"."""
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names.update(f"{node.name}.{sub.name}" for sub in node.body
                             if isinstance(sub, ast.FunctionDef) and not sub.name.startswith("_"))
    return names


def _has(module, name):
    """The port's module has the name, a method inherited from a base class
    included."""
    obj = module
    for part in name.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def _modules(package):
    root = os.path.join(REPO, package)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, f), root).replace(os.sep, "/")


def test_every_public_name_of_the_jax_package_is_ported():
    import importlib

    pairs = [(os.path.join(REPO, "polar_codes_tpu", rel), rel) for rel in _modules("polar_codes_tpu")]
    pairs.append((os.path.join(REPO, "pypolar", "__init__.py"), "pypolar.py"))
    missing = {}
    for path, rel in pairs:
        skip = NOT_PORTED.get(rel, set())
        if skip is None:
            continue
        port_path = os.path.join(REPO, "polar_codes_torch", rel)
        if not os.path.exists(port_path):
            missing[rel] = "module"
            continue
        mod_name = "polar_codes_torch." + rel[:-3].replace("/", ".").replace(".__init__", "")
        module = importlib.import_module(mod_name)
        lost = sorted(n for n in _public_names(path) - skip if not _has(module, n))
        if lost:
            missing[rel] = lost
    assert missing == {}
    for rel, names in NOT_PORTED.items():  # each exemption still names something in JAX
        path = os.path.join(REPO, "polar_codes_tpu", rel)
        assert os.path.exists(path)
        if names:
            assert names <= _public_names(path)
