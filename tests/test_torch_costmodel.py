"""The port's cost model (utils/costmodel.py), roofline (utils/profiling.py)
and time_device_fn (utils/timing.py) on the CPU: the counts do not move
with the route (kernel_span, chunk, kernel or plain version); their
operations equal the JAX package's where its formula does not depend on
its arm; their bytes, the least a call must move, are at most the JAX
package's on either arm plus the info bits and CRC flags it leaves out; a
hand count at N = 8; the H100's peak for the H100 only."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from polar_codes_tpu.models import detectors as jdet  # noqa: E402
from polar_codes_tpu.models import encoder as jenc  # noqa: E402
from polar_codes_tpu.models import fastssc as jfast  # noqa: E402
from polar_codes_tpu.models import large as jlarge  # noqa: E402
from polar_codes_tpu.models import scan as jscan  # noqa: E402
from polar_codes_tpu.models import scl as jscl  # noqa: E402
from polar_codes_tpu.utils import costmodel as jcost  # noqa: E402
from polar_codes_torch.construction import frozen_bits  # noqa: E402
from polar_codes_torch.models import detectors  # noqa: E402
from polar_codes_torch.models.adaptive import AdaptiveDecoder  # noqa: E402
from polar_codes_torch.models.encoder import PolarEncoder  # noqa: E402
from polar_codes_torch.models.fastssc import FastSSCDecoder  # noqa: E402
from polar_codes_torch.models.large import LargeSCDecoder, LargeSCLDecoder  # noqa: E402
from polar_codes_torch.models.scan import FastSScanDecoder, ScanDecoder  # noqa: E402
from polar_codes_torch.models.scl import SCLDecoder  # noqa: E402
from polar_codes_torch.ops.fastssc_kernel import fastssc_subtree_plain  # noqa: E402
from polar_codes_torch.ops.large_kernel import (  # noqa: E402
    masked_sc_chunk_plain, masked_scl_chunk_plain)
from polar_codes_torch.ops.scl_kernel_bl import scl_subtree_plain  # noqa: E402
from polar_codes_torch.utils import costmodel, profiling  # noqa: E402
from polar_codes_torch.utils.timing import time_device_fn  # noqa: E402

B = 5
CPU = dict(device="cpu")
H100 = "NVIDIA H100 80GB HBM3"


def _frozen(n, k=None):
    return frozen_bits(n, n // 2 if k is None else k, 0.0, "BB")


def _crc(bits):
    return detectors.make_detector(bits, "crc") if bits else None


def _jcrc(bits):
    return jdet.make_detector(bits, "crc") if bits else None


# ---- route-free ---------------------------------------------------------------

def _routes(family):
    """Models of one configuration that differ only in how they run."""
    f = _frozen(256)
    if family == "scl":
        return [SCLDecoder(256, f, list_size=8, detector=_crc(16), kernel_span=span,
                           subtree_fn=fn, **CPU)
                for span in (64, 256) for fn in (None, scl_subtree_plain)]
    if family == "scl_l1":
        return [SCLDecoder(256, f, list_size=1, kernel_span=span, subtree_fn=fn, **CPU)
                for span in (64, 256) for fn in (None, fastssc_subtree_plain)]
    if family == "fastssc":
        return [FastSSCDecoder(256, f, dtype=torch.int8, kernel_span=span, subtree_fn=fn,
                               **CPU)
                for span in (64, 256) for fn in (None, fastssc_subtree_plain)]
    f = _frozen(1024)
    if family == "large_sc":
        return [LargeSCDecoder(1024, f, chunk=chunk, chunk_fn=fn, **CPU)
                for chunk in (64, 512) for fn in (None, masked_sc_chunk_plain)]
    return [LargeSCLDecoder(1024, f, list_size=4, detector=_crc(16), chunk=chunk,
                            schedule=schedule, chunk_fn=fn, **CPU)
            for chunk in (64, 256) for schedule in ("scan", "tree")
            for fn in (None, masked_scl_chunk_plain)]


@pytest.mark.parametrize("family", ["scl", "scl_l1", "fastssc", "large_sc", "large_scl"])
def test_counts_are_route_free(family):
    counts = [profiling.analytic_costs(m, B) for m in _routes(family)]
    assert counts[0]["flops"] > 0 and counts[0]["bytes_accessed"] > 0
    assert all(c == counts[0] for c in counts)


# ---- against the JAX package's counts ------------------------------------------

def _pairs(family, backend):
    """[(port model, JAX model)] of one family on one JAX arm."""
    out = []
    if family == "fastssc":
        for n in (64, 256, 1024):
            for dt, jdt in ((torch.float32, np.float32), (torch.int8, np.int8)):
                out.append((FastSSCDecoder(n, _frozen(n), dtype=dt, **CPU),
                            jfast.FastSSCDecoder(n, _frozen(n), dtype=jdt, backend=backend)))
    elif family == "scan":
        for n in (64, 256):
            for cls, jcls in ((ScanDecoder, jscan.ScanDecoder),
                              (FastSScanDecoder, jscan.FastSScanDecoder)):
                port = cls(n, _frozen(n), iterations=4, **CPU)
                ref = jcls(n, _frozen(n), iterations=4)
                ref.backend = backend  # the JAX count reads only this attribute
                out.append((port, ref))
    elif family == "encode":
        for n in (64, 256, 2048):
            for crc in (0, 16):
                for systematic in (True, False):
                    out.append((
                        PolarEncoder(n, _frozen(n), systematic=systematic, detector=_crc(crc),
                                     **CPU),
                        jenc.PolarEncoder(n, _frozen(n), systematic=systematic,
                                          detector=_jcrc(crc), backend=backend)))
    elif family == "large":
        for n in (1024, 4096):
            out.append((LargeSCDecoder(n, _frozen(n), **CPU),
                        jlarge.LargeSCDecoder(n, _frozen(n), backend=backend)))
            for L in (2, 8):
                out.append((LargeSCLDecoder(n, _frozen(n), list_size=L, detector=_crc(16),
                                            **CPU),
                            jlarge.LargeSCLDecoder(n, _frozen(n), list_size=L,
                                                   detector=_jcrc(16), backend=backend)))
    else:  # scl
        for n in (256, 1024):
            for L in (2, 8, 32):
                for crc in (0, 16):
                    for dt, jdt in ((torch.float32, np.float32), (torch.int8, np.int8)):
                        out.append((
                            SCLDecoder(n, _frozen(n), list_size=L, detector=_crc(crc),
                                       dtype=dt, **CPU),
                            jscl.SCLDecoder(n, _frozen(n), list_size=L, detector=_jcrc(crc),
                                            dtype=jdt, backend=backend)))
    return out


_JAX_COSTS = {
    "SCLDecoder": jcost.scl_costs, "FastSSCDecoder": jcost.fastssc_costs,
    "PolarEncoder": jcost.encode_costs, "ScanDecoder": jcost.scan_costs,
    "FastSScanDecoder": jcost.scan_costs, "LargeSCDecoder": jcost.large_costs,
    "LargeSCLDecoder": jcost.large_costs,
}


def _jax_costs(ref, batch):
    return _JAX_COSTS[type(ref).__name__](ref, batch)


@pytest.mark.parametrize("family", ["fastssc", "scan", "encode", "large"])
def test_flops_equal_jax_where_its_formula_is_arm_free(family):
    """Fast-SSC, SCAN and the large-N decoders on either arm (the large-N
    decoders at JAX's default chunk, 256 for SCL, where its prune term
    counts chunks); the encoder up to N = 2048 on JAX's XLA arm."""
    for backend in (("xla",) if family == "encode" else ("xla", "pallas")):
        for port, ref in _pairs(family, backend):
            assert profiling.analytic_costs(port, B)["flops"] == _jax_costs(ref, B)["flops"]


@pytest.mark.parametrize("family", ["scl", "fastssc", "scan", "encode", "large"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_bytes_at_most_jax_plus_info_and_flags(family, backend):
    """The least bytes of a call, against JAX's count on each arm plus the
    B x K info bytes and B flag bytes that JAX's count leaves out (JAX's
    SCAN Pallas count, 5 N a row, is exactly the LLRs and the codeword)."""
    for port, ref in _pairs(family, backend):
        got = profiling.analytic_costs(port, B)["bytes_accessed"]
        assert got <= _jax_costs(ref, B)["bytes_accessed"] + B * port.info_length + B


def test_hand_count_at_n8():
    """(8, 4) with frozen {0, 1, 2, 4}: a REP and an SPC leaf of 4 under one
    branch (SCL without ENUM leaves; with them the root is one ENUM leaf of
    16 candidates)."""
    f = [0, 1, 2, 4]
    llr_bytes = 8 * 4 + 4 + 8 + 1  # LLRs f32, info, codeword, flag
    # Fast-SSC: branch 4 x (4 + 2 + 1), leaves 3 per position
    assert costmodel.fastssc_costs(FastSSCDecoder(8, f, **CPU), 3) == {
        "flops": 3 * (28 + 12 + 12), "bytes_accessed": 3 * llr_bytes}
    # SCL-4: REP 1 -> 2 paths: 16 + 4 + 16; SPC 2 -> 4 paths (16 candidates
    # > 4: extraction 4 x 8 x 2 x 4): 32 + 32 + 256 + 32; the branch: f 1 x
    # 4 x 4, g and combine 4 x 4 x 3, gathers 2 x (4 x 8 + 4 x 4); the pick 4 x 4
    dec = SCLDecoder(8, f, list_size=4, enum_span=0, **CPU)
    assert costmodel.scl_costs(dec, 3) == {
        "flops": 3 * (36 + 352 + (16 + 48 + 96) + 16), "bytes_accessed": 3 * llr_bytes}
    # the ENUM tree: 1 x 8 x 4 + 16 x 2 + 4 x 16 x 4 + 4 x 8 x 2, the pick 16
    enum = SCLDecoder(8, f, list_size=4, **CPU)
    assert costmodel.scl_costs(enum, 1)["flops"] == 32 + 32 + 256 + 64 + 16
    assert costmodel.encode_costs(PolarEncoder(8, f, **CPU), 3) == {
        "flops": 3 * 2 * 8 * 3, "bytes_accessed": 3 * (4 + 8)}
    assert costmodel.scan_costs(ScanDecoder(8, f, iterations=2, **CPU), 3) == {
        "flops": 3 * 2 * 8 * 3 * 7, "bytes_accessed": 3 * llr_bytes}
    assert costmodel.large_costs(LargeSCDecoder(8, f, **CPU), 3) == {
        "flops": 3 * 8 * 3 * 7, "bytes_accessed": 3 * llr_bytes}
    # L = 4: per-bit work of 4 paths and one chunk's prune, 4 x 8 x 4
    large = LargeSCLDecoder(8, f, list_size=4, dtype=torch.int8, **CPU)
    assert costmodel.large_costs(large, 3) == {
        "flops": 3 * (4 * 8 * 3 * 7 + 128), "bytes_accessed": 3 * (8 + 4 + 8 + 1)}
    # a CRC adds its syndrome (2 x L x N x tail) to a decode, 2 x K x tail to an encode
    f16 = _frozen(64, 32)
    plain = costmodel.scl_costs(SCLDecoder(64, f16, list_size=4, **CPU), 1)["flops"]
    crc = costmodel.scl_costs(SCLDecoder(64, f16, list_size=4, detector=_crc(8), **CPU),
                              1)["flops"]
    assert crc - plain == 2 * 4 * 64 * 8
    assert (costmodel.encode_costs(PolarEncoder(64, f16, detector=_crc(8), **CPU), 1)["flops"]
            - costmodel.encode_costs(PolarEncoder(64, f16, **CPU), 1)["flops"]) == 2 * 32 * 8


# ---- the roofline ----------------------------------------------------------------

def test_derive_roofline_has_a_peak_for_the_named_card_only(monkeypatch):
    flops, nbytes, secs = 6.7e9, 3.35e8, 1e-3
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: H100)
    got = profiling.derive_roofline(flops, nbytes, secs, device="cuda:0")
    assert got["mfu"] == pytest.approx(flops / secs / 67e12)
    assert got["hbm_util"] == pytest.approx(nbytes / secs / 3.35e12)
    assert got["bound"] == "dataflow"  # 0.1 of either roof
    # ten times the bytes: below the ridge, and at the bytes roof
    assert profiling.derive_roofline(flops, 10 * nbytes, secs, device="cuda")["bound"] == "memory"
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA A100-SXM4-80GB")
    for device in ("cuda:0", "cpu"):
        other = profiling.derive_roofline(flops, nbytes, secs, device=device)
        assert not {"mfu", "hbm_util", "bound"} & set(other)
        assert other["achieved_flops_per_s"] == pytest.approx(flops / secs)


def test_roofline_takes_the_analytic_count_on_the_cpu():
    n = 64
    dec = SCLDecoder(n, _frozen(n), list_size=4, detector=_crc(8), **CPU)
    llr = torch.randn(B, n)
    got = profiling.roofline(dec.decode, llr, seconds=1e-3, model=dec, batch=B)
    want = costmodel.scl_costs(dec, B)
    assert got["cost_model"] == "analytic"
    assert (got["flops"], got["bytes_accessed"]) == (want["flops"], want["bytes_accessed"])
    assert "mfu" not in got and "hbm_util" not in got  # the CPU has no peak
    # no formula for the class: the flop counter, which sees no matmul here
    ad = AdaptiveDecoder(n, _frozen(n), list_size=4, detector=_crc(8), **CPU)
    assert profiling.roofline(ad.decode, llr, model=ad, batch=B)["cost_model"] == "flop_counter"
    # a formula that raises is recorded, and the flop counter counts the matmul
    broken = type("SCLDecoder", (), {})()
    mat = torch.ones(4, 4)
    got = profiling.roofline(lambda a: a @ a, mat, model=broken, batch=B)
    assert got["cost_model"] == "flop_counter" and got["flops"] == 2 * 4 * 4 * 4
    assert got["cost_model_fallback_reason"].startswith("AttributeError")
    assert profiling.cost_analysis(lambda a: a + 1, mat) == {}


def test_time_device_fn_on_the_cpu_is_positive():
    seen = []

    def perturb(x, out):
        seen.append(out)
        return x + 1e-12 * out

    x = torch.randn(256)
    assert time_device_fn(torch.sin, x, reps=4, tries=3) > 0
    assert time_device_fn(torch.sin, x, reps=4, tries=3, perturb=perturb) > 0
    assert len(seen) == 12
