"""The SCAN kernels' plain versions (K4 fused, K5 stepped) against the JAX
Pallas kernels in interpret mode, and the port's ScanDecoder and
FastSScanDecoder against the JAX decoders, on shared LLRs made with numpy.
The sweep is elementwise, so betas (+inf included) and the node memory
must be bit-equal, and decisions equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from polar_codes_tpu.models import detectors as jdet  # noqa: E402
from polar_codes_tpu.models.scan import FastSScanDecoder as JaxFastSScan  # noqa: E402
from polar_codes_tpu.models.scan import ScanDecoder as JaxScan  # noqa: E402
from polar_codes_tpu.ops import scan_kernel as jsk  # noqa: E402

from polar_codes_torch.construction import frozen_bits  # noqa: E402
from polar_codes_torch.models import detectors as tdet  # noqa: E402
from polar_codes_torch.models.scan import FastSScanDecoder, ScanDecoder  # noqa: E402
from polar_codes_torch.models.tree import NodeKind  # noqa: E402
from polar_codes_torch.ops import scan_kernel as sk  # noqa: E402

BATCH = 12


def _llr(n, seed, mean=0.5, std=1.5):
    return np.random.default_rng(seed).normal(mean, std, (BATCH, n)).astype(np.float32)


def _kernel_layout(llr):
    return torch.as_tensor(np.ascontiguousarray(llr.T))


@pytest.mark.parametrize("n,k,sweeps", [(64, 40, 1), (128, 64, 3)])
def test_fused_plain_matches_jax_kernel(n, k, sweeps):
    frozen = frozen_bits(n, k, 0.0)
    jdec = JaxScan(n, frozen, iterations=sweeps)
    run = jsk.build_scan_kernel(jdec, sweeps, batch_tile=16, interpret=True)
    dec = ScanDecoder(n, frozen, iterations=sweeps, device="cpu")
    llr = _llr(n, n + sweeps)
    got = sk.scan_fused_plain(dec.sched, _kernel_layout(llr), sweeps)
    np.testing.assert_array_equal(got.numpy().T, np.asarray(run(jnp.asarray(llr))))


def test_step_plain_matches_jax_kernel_sweep_by_sweep():
    n = 64
    frozen = frozen_bits(n, 40, 0.0)
    jdec = JaxScan(n, frozen)
    step = jsk.build_scan_step_kernel(jdec, batch_tile=16, interpret=True)
    dec = ScanDecoder(n, frozen, device="cpu")
    assert dec.sched.mem_rows == step.mem_rows
    llr = _llr(n, 7)
    jmem, mem = None, torch.zeros((dec.sched.mem_rows, BATCH))
    for _ in range(3):
        jbeta, jmem = step(jnp.asarray(llr), jmem)
        beta, mem = sk.scan_step_plain(dec.sched, _kernel_layout(llr), mem)
        np.testing.assert_array_equal(beta.numpy().T, np.asarray(jbeta))
        np.testing.assert_array_equal(mem.numpy(), np.asarray(jmem)[:, :BATCH])
    fused = sk.scan_fused_plain(dec.sched, _kernel_layout(llr), 3)
    np.testing.assert_array_equal(fused.numpy(), beta.numpy())


def test_mem_layout_and_schedule_match_jax():
    frozen = frozen_bits(256, 128, 0.0)
    jdec = JaxScan(256, frozen)
    dec = ScanDecoder(256, frozen, device="cpu")
    joffsets, jrows = jsk._mem_layout(jdec.tree)

    def branches(node, out):
        if node.left is not None:
            branches(node.left, out)
            branches(node.right, out)
            out.append(node)
        return out

    ours = [dec.sched.mem_offsets[n] for n in branches(dec.tree, [])]
    theirs = [joffsets[id(n)] for n in branches(jdec.tree, [])]
    assert ours == theirs and dec.sched.mem_rows == jrows
    assert {leaf.kind for leaf in dec.tree.leaves()} == {NodeKind.RATE0, NodeKind.RATE1}
    ops = dec.sched.ops
    assert (ops[:, 0] == sk.OP_LEAF).sum() == len(dec.tree.leaves())
    assert (ops[:, 0] == sk.OP_COMBINE).sum() == len(ours)


@pytest.mark.parametrize("systematic", [True, False])
def test_scan_decoder_matches_jax(systematic):
    n, k = 128, 64
    frozen = frozen_bits(n, k, 0.0)
    dec = ScanDecoder(n, frozen, systematic=systematic, detector=tdet.CRC8(),
                      iterations=2, device="cpu")
    jdec = JaxScan(n, frozen, systematic=systematic, detector=jdet.CRC8(), iterations=2)
    llr = _llr(n, 11, mean=1.0)
    total, beta = dec.decode_soft(torch.as_tensor(llr))
    jtotal, jbeta = jax.jit(jdec.decode_soft)(jnp.asarray(llr))
    np.testing.assert_array_equal(beta.numpy(), np.asarray(jbeta))
    np.testing.assert_array_equal(total.numpy(), np.asarray(jtotal))
    for a, b in zip(dec.decode(torch.as_tensor(llr)), jax.jit(jdec.decode)(jnp.asarray(llr))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fastsscan_matches_jax():
    """CRC8, 3 iterations: some rows pass at the first sweep, some later,
    some never (those keep the last sweep's estimate)."""
    n, k = 128, 72
    frozen = frozen_bits(n, k, 0.0)
    dec = FastSScanDecoder(n, frozen, detector=tdet.CRC8(), iterations=3, device="cpu")
    jdec = JaxFastSScan(n, frozen, detector=jdet.CRC8(), iterations=3)
    llr = np.random.default_rng(5).normal(1.0, 1.1, (40, n)).astype(np.float32)
    got = dec.decode(torch.as_tensor(llr))
    for a, b in zip(got, jdec.decode(jnp.asarray(llr))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ok = got[2].numpy()
    assert 0 < ok.mean() < 1


def test_inf_betas_and_single_leaf_trees():
    """A rate-0 right child puts +inf betas into the node memory; no NaN
    may appear. A tree that is one leaf has no sweep: +inf or 0."""
    frozen = [0, 4, 5, 6, 7]  # the right half is all frozen
    dec = ScanDecoder(8, frozen, iterations=2, device="cpu")
    jdec = JaxScan(8, frozen, iterations=2)
    assert dec.tree.right.kind == NodeKind.RATE0
    llr = _llr(8, 3)
    total, beta = dec.decode_soft(torch.as_tensor(llr))
    np.testing.assert_array_equal(beta.numpy(), np.asarray(jdec.decode_soft(jnp.asarray(llr))[1]))
    _, mem = sk.scan_step_plain(dec.sched, _kernel_layout(llr),
                                torch.zeros((dec.sched.mem_rows, BATCH)))
    assert torch.isinf(mem).any() and not torch.isnan(mem).any()
    assert torch.isinf(beta).any() and not torch.isnan(total).any()
    for frozen in (list(range(8)), []):
        dec = FastSScanDecoder(8, frozen, iterations=2, device="cpu")
        jdec = JaxFastSScan(8, frozen, iterations=2)
        assert dec.sched is None
        np.testing.assert_array_equal(
            dec.decode_soft(torch.as_tensor(llr))[1].numpy(),
            np.asarray(jdec.decode_soft(jnp.asarray(llr))[1]))
        for a, b in zip(dec.decode(torch.as_tensor(llr)), jdec.decode(jnp.asarray(llr))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_scan_kernels_never_fall_back(monkeypatch):
    """A CUDA tensor reaches the kernel or raises; it never takes the plain
    version. Here there is no card and no nvcc, so it raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    dec = ScanDecoder(64, frozen_bits(64, 32, 0.0), device="cpu")
    rows = dec.sched.mem_rows
    with FakeTensorMode():
        llr = torch.empty((64, 16), device="cuda")
        mem = torch.empty((rows, 16), device="cuda")
        short = torch.empty((rows - 1, 16), device="cuda")
    called = []
    monkeypatch.setattr(sk, "scan_fused_plain", lambda *a: called.append(a))
    monkeypatch.setattr(sk, "scan_step_plain", lambda *a: called.append(a))
    before = dict(sk.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        sk.scan_fused(dec.sched, llr, 2)
    with pytest.raises(RuntimeError, match="nvcc"):
        sk.scan_step(dec.sched, llr, mem)
    with pytest.raises(ValueError, match="expects mem"):
        sk.scan_step(dec.sched, llr, short)
    assert not called and sk.LAUNCHES == before
