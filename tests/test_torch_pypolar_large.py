"""The pypolar facade's large-N route against the JAX package's pypolar:
with `_LARGE_N_THRESHOLD` lowered to 512 in both facades, (1024, 512) CRC16
decodes go through LargeSCDecoder (L = 1) and LargeSCLDecoder (L = 4) in
both packages, and the packed bytes must be equal on noisy LLRs.

A file of its own: JAX compiles these two decoders for ~40 s on the CPU.
To keep that down, its LargeSCLDecoder runs with unroll=1 (how many scan
steps one compiled step unrolls) and its LargeSCDecoder with chunk=256 (its
own default there is 512; the port's is the whole block); neither changes a
decision on tie-free inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import polar_codes_tpu.models.large as jlarge  # noqa: E402
import pypolar as jp  # noqa: E402

from polar_codes_torch import pypolar as tp  # noqa: E402

SEED = 20261030
N_LEN, K_LEN, BATCH, EBN0_DB = 1024, 512, 16, 1.5


class _SCL(jlarge.LargeSCLDecoder):
    def __init__(self, *args, **kw):
        super().__init__(*args, unroll=1, **kw)


class _SC(jlarge.LargeSCDecoder):
    def __init__(self, *args, **kw):
        super().__init__(*args, chunk=256, **kw)


@pytest.fixture(scope="module")
def channel():
    rng = np.random.default_rng(SEED)
    frozen = jp.frozen_bits(N_LEN, K_LEN, 0.0)
    enc = tp.PolarEncoder(N_LEN, frozen, device="cpu")
    enc.setErrorDetection(16)
    info = rng.integers(0, 256, (BATCH, K_LEN // 8)).astype(np.uint8)
    cw = np.unpackbits(enc.encode_vector(info), axis=-1).astype(np.float64)
    sigma = np.sqrt(1.0 / (2.0 * K_LEN / N_LEN * 10.0 ** (EBN0_DB / 10.0)))
    y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape)
    return frozen, info, (2.0 * y / sigma ** 2).astype(np.float32)


@pytest.mark.parametrize("list_size,route", [(1, "LargeSCDecoder"), (4, "LargeSCLDecoder")])
def test_large_route_equals_pypolar(monkeypatch, channel, list_size, route):
    monkeypatch.setattr(tp, "_LARGE_N_THRESHOLD", 512)
    monkeypatch.setattr(jp, "_LARGE_N_THRESHOLD", 512)
    monkeypatch.setattr(jlarge, "LargeSCLDecoder", _SCL)
    monkeypatch.setattr(jlarge, "LargeSCDecoder", _SC)
    frozen, sent, llr = channel
    ours = tp.PolarDecoder(N_LEN, list_size, frozen, "float", device="cpu")
    theirs = jp.PolarDecoder(N_LEN, list_size, frozen, "float")
    for dec in (ours, theirs):
        dec.setErrorDetection(16)
    got = ours.decode_vector(llr)
    assert type(ours._dec).__name__ == route
    assert isinstance(theirs._build(), {"LargeSCDecoder": _SC, "LargeSCLDecoder": _SCL}[route])
    assert ours._dec.chunk == min(256 if list_size > 1 else 2048, N_LEN)
    np.testing.assert_array_equal(got, theirs.decode_vector(llr))
    wrong = int((got != sent).any(axis=1).sum())
    assert 0 < wrong < BATCH // 2
    np.testing.assert_array_equal(ours.decode_vector(llr[5]), got[5])
