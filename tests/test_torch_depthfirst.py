"""The port's SC-Flip decoder (models/depthfirst.py) against the JAX
package's DepthFirstDecoder.

Inputs from a seed with numpy: CRC8 codewords of (64, 40) and (128, 80),
systematic and not, over BPSK/AWGN at an Eb/N0 where a share of the
first passes fails, as Gaussian LLRs and as integers in [-2, 2] (ties in
the reliabilities, and zeros of both signs); trial limits 1, 4 and 16.
Tolerance: none. Info bits, codewords and flags are equal.

The JAX reference runs its SC pass under jax.jit (one compile per code,
shared by the systematic and non-systematic decoders and the trial
limits, since the pass depends on the frozen set alone; its min-sum f and
g = b +- a round the same compiled or not), computed once per module.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from polar_codes_tpu.models import detectors as jdet  # noqa: E402
from polar_codes_tpu.models.depthfirst import DepthFirstDecoder as JaxDepthFirst  # noqa: E402

from polar_codes_torch.construction import frozen_bits  # noqa: E402
from polar_codes_torch.models import detectors as tdet  # noqa: E402
from polar_codes_torch.models.depthfirst import DepthFirstDecoder  # noqa: E402
from polar_codes_torch.models.encoder import PolarEncoder  # noqa: E402
from polar_codes_torch.models.tree import NodeKind  # noqa: E402

CODES = [(64, 40), (128, 80)]
TRIALS = (1, 4, 16)
BATCH = 96  # half Gaussian, half integer rows
EBN0_DB = 1.5


def _llrs(n_len, k_len, systematic, seed):
    """(frozen, sent info with its CRC, LLRs [BATCH, N] float32): the first
    half Gaussian, the second rounded to integers in [-2, 2] with the sign
    of every zero drawn at random."""
    frozen = frozen_bits(n_len, k_len, 0.0, "BB")
    rng = np.random.default_rng(seed)
    det = tdet.CRC8()
    enc = PolarEncoder(n_len, frozen, systematic=systematic, detector=det, device="cpu")
    info = torch.as_tensor(rng.integers(0, 2, (BATCH, k_len)), dtype=torch.uint8)
    code = enc.encode(info).numpy()
    sigma = np.sqrt(1.0 / (2.0 * 10.0 ** (EBN0_DB / 10.0) * k_len / n_len))
    y = (1.0 - 2.0 * code) + sigma * rng.standard_normal(code.shape)
    llr = (2.0 * y / sigma**2).astype(np.float32)
    half = BATCH // 2
    ints = np.clip(np.round(llr[half:] / 3.0), -2, 2)
    zeros_neg = (ints == 0) & (rng.random(ints.shape) < 0.5)
    llr[half:] = np.where(zeros_neg, -0.0, ints)
    return frozen, det.generate(info).numpy(), llr


@pytest.fixture(scope="module")
def reference():
    """(n, k, systematic) -> (frozen, sent, llr, {trial_limit: JAX result});
    n -> the jitted JAX pass of that code."""
    out = {}
    for n_len, k_len in CODES:
        for systematic in (True, False):
            frozen, sent, llr = _llrs(n_len, k_len, systematic, seed=n_len + systematic)
            jdec = JaxDepthFirst(n_len, frozen, systematic=systematic,
                                 detector=jdet.CRC8())
            jdec._pass = out.setdefault(n_len, jax.jit(jdec._pass))
            results = {}
            for trials in TRIALS:
                jdec.trial_limit = trials
                results[trials] = [np.asarray(a) for a in jdec.decode(jnp.asarray(llr))]
            out[n_len, k_len, systematic] = (frozen, sent, llr, results)
    return out


@pytest.mark.parametrize("trials", TRIALS)
@pytest.mark.parametrize("systematic", [True, False])
@pytest.mark.parametrize("code", CODES)
def test_decode_matches_jax(reference, code, systematic, trials):
    frozen, sent, llr, results = reference[code + (systematic,)]
    dec = DepthFirstDecoder(code[0], frozen, systematic=systematic, detector=tdet.CRC8(),
                            trial_limit=trials, device="cpu")
    got = dec.decode(torch.as_tensor(llr))
    for name, a, b in zip(("info", "codeword", "ok"), got, results[trials]):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    if trials == 16:  # the flips were driven: some rows fail the first pass and pass later
        first_ok = results[1][2]
        assert (~first_ok & results[16][2]).any() and (~results[16][2]).any()
        assert (got[0].numpy() == sent).all(1).sum() > (results[1][0] == sent).all(1).sum()


def test_noiseless_round_trip_and_leaves():
    n_len, k_len = 128, 80
    frozen = frozen_bits(n_len, k_len, 0.0, "BB")
    det = tdet.CRC8()
    enc = PolarEncoder(n_len, frozen, detector=det, device="cpu")
    info = torch.as_tensor(np.random.default_rng(3).integers(0, 2, (16, k_len)),
                           dtype=torch.uint8)
    code = enc.encode(info)
    dec = DepthFirstDecoder(n_len, frozen, detector=det, device="cpu")
    got, cw, ok = dec.decode(4.0 * (1.0 - 2.0 * code.to(torch.float32)))
    assert torch.equal(got, det.generate(info)) and torch.equal(cw, code) and ok.all()
    leaves = dec.tree.leaves()
    assert all(l.kind == NodeKind.RATE0 or l.length == 1 for l in leaves)
    assert sum(l.kind != NodeKind.RATE0 for l in leaves) == k_len


def test_dummy_detector_runs_one_pass(reference):
    """Without a check there are no trials: one SC pass, ok everywhere,
    equal to JAX's."""
    n_len, k_len = CODES[0]
    frozen, _, llr = _llrs(n_len, k_len, True, seed=9)
    llr = llr[:8]
    dec = DepthFirstDecoder(n_len, frozen, trial_limit=8, device="cpu")
    jdec = JaxDepthFirst(n_len, frozen, trial_limit=8)
    jdec._pass = reference[n_len]
    got = dec.decode(torch.as_tensor(llr))
    want = jdec.decode(jnp.asarray(llr))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[2].all() and dec.detector.tail_bits == 0
    assert got[0].shape == (8, k_len) and dec.decode(torch.as_tensor(llr[0]))[1].shape == (n_len,)
