"""The port's genie error locator (models/errorlocator.py) and its app
(sim/errorlocator_app.py) against the JAX package's.

- `locate` at N = 64 and 256 on numpy-seeded inputs: Gaussian LLRs, and
  integers in [-2, 2] with zeros of both signs (f meets signed zeros at
  every level, decisions are llr < 0): `first` and the error mask equal.
- The level-wise genie pass equal, bit for bit, to a direct transcription
  of the JAX recursion in torch.
- The app at N = 64 on the CPU: the CSV's header and column count equal to
  the JAX app's, and the share of frames with a genie error per SNR point
  within 5 binomial sigma of the JAX app's (the two draw different random
  numbers).
"""

import csv
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from polar_codes_tpu.models.errorlocator import ErrorLocator as JaxErrorLocator  # noqa: E402
from polar_codes_tpu.sim import errorlocator_app as japp  # noqa: E402

from polar_codes_torch.construction import frozen_bits  # noqa: E402
from polar_codes_torch.models.encoder import PolarEncoder  # noqa: E402
from polar_codes_torch.models.errorlocator import ErrorLocator, genie_llrs  # noqa: E402
from polar_codes_torch.ops.fg import f_minsum, g_update  # noqa: E402
from polar_codes_torch.sim import errorlocator_app as tapp  # noqa: E402


def _inputs(n_len, kind, seed, batch=64):
    """(frozen, LLRs [batch, N] float32, codewords [batch, N] uint8)."""
    k_len = n_len // 2
    frozen = frozen_bits(n_len, k_len, 0.0, "BB")
    rng = np.random.default_rng(seed)
    enc = PolarEncoder(n_len, frozen, systematic=False, device="cpu")
    code = enc.encode(torch.as_tensor(rng.integers(0, 2, (batch, k_len)),
                                      dtype=torch.uint8)).numpy()
    if kind == "gauss":
        llr = (1.0 - 2.0 * code) + 0.9 * rng.standard_normal(code.shape)
    else:
        llr = rng.integers(-2, 3, code.shape).astype(np.float64)
        llr = np.where((llr == 0) & (rng.random(code.shape) < 0.5), -0.0, llr)
    return frozen, llr.astype(np.float32), code


def _recursion(llr, x):
    """The JAX package's _genie_llrs, transcribed."""
    span = llr.shape[-1]
    if span == 1:
        return llr
    half = span // 2
    a, b = llr[..., :half], llr[..., half:]
    xl, xr = x[..., :half], x[..., half:]
    return torch.cat([_recursion(f_minsum(a, b), xl * xr),
                      _recursion(g_update(a, b, xl * xr), xr)], dim=-1)


@pytest.mark.parametrize("kind", ["gauss", "ints"])
@pytest.mark.parametrize("n_len", [64, 256])
def test_locate_matches_jax(n_len, kind):
    frozen, llr, code = _inputs(n_len, kind, seed=n_len + len(kind))
    loc = ErrorLocator(n_len, frozen, device="cpu")
    first, err = loc.locate(torch.as_tensor(llr), torch.as_tensor(code))
    jfirst, jerr = jax.jit(JaxErrorLocator(n_len, frozen).locate)(jnp.asarray(llr),
                                                                  jnp.asarray(code))
    np.testing.assert_array_equal(first.numpy(), np.asarray(jfirst))
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
    if kind == "gauss":  # frames with a genie error and frames without
        assert (first.numpy() < n_len).any() and (first.numpy() == n_len).any()
    assert not err.numpy()[:, frozen].any()
    f1, e1 = loc.locate(torch.as_tensor(llr[0]), torch.as_tensor(code[0]))
    assert f1.shape == () and int(f1) == int(first[0]) and torch.equal(e1, err[0])


@pytest.mark.parametrize("kind", ["gauss", "ints"])
def test_level_wise_pass_equals_recursion(kind):
    _, llr, code = _inputs(256, kind, seed=7)
    x = 1.0 - 2.0 * torch.as_tensor(code).to(torch.float32)
    got = genie_llrs(torch.as_tensor(llr), x)
    want = _recursion(torch.as_tensor(llr), x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_app_matches_jax(tmp_path, capsys):
    args = ["-n", "64", "-r", "0.5", "--snr-min", "0", "--snr-max", "2", "--snr-count", "3",
            "-w", str(64 * 4096), "--batch", "1024", "--platform", "cpu"]
    assert japp.main(args + ["-o", str(tmp_path / "j")]) == 0
    jout = capsys.readouterr().out
    assert tapp.main(args + ["-o", str(tmp_path / "t")]) == 0
    tout = capsys.readouterr().out
    jlines = open(tmp_path / "j_firsterror.csv").read().splitlines()
    tlines = open(tmp_path / "t_firsterror.csv").read().splitlines()
    assert tlines[0] == jlines[0]
    assert {len(line.split(",")) for line in tlines} == {7}
    rows = list(csv.DictReader(tlines))
    frames = 4 * 1024
    for snr, jl, tl in zip(("0.00", "1.00", "2.00"), jout.splitlines(), tout.splitlines()):
        assert jl.startswith(f"EbN0={snr}:") and tl.startswith(f"EbN0={snr}:")
        pj = int(jl.split()[1].split("/")[0]) / frames
        pt = int(tl.split()[1].split("/")[0]) / frames
        assert int(tl.split()[1].split("/")[1]) == frames
        p = (pj + pt) / 2
        assert 0.005 < p < 0.995
        assert abs(pj - pt) <= 5 * math.sqrt(2 * p * (1 - p) / frames)
        # the per-position first errors add up to the frames with an error
        first = sum(int(r["first_errors"]) for r in rows if float(r["Eb/N0"]) == float(snr))
        assert first == round(pt * frames)
