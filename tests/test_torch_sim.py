"""The port's simulator (sim/) against the JAX package's.

- The chain: `MonteCarlo._llr_from` (generate, encode, modulate, channel,
  demodulate, amplify, int8 quantisation) and the decode and count, equal
  to the same chain built from the JAX modules on the same numpy info and
  noise: LLRs bit-equal (float32 and int8), decisions and counters equal,
  over AWGN and Rayleigh with the adaptive, SCL-8, Fast-SSC and SCAN
  decoders at N = 64.
- `write_csv` character for character the JAX writer's, zero rates too.
- Checkpoint/resume: a resumed job equals an uninterrupted one, and a
  checkpoint file reads in both packages.
- The CLI's job list (N, K, dSNR, C, L, Eb/N0, BPS, Runs, Amplification of
  every CSV row) equal to the JAX CLI's for every simtype. The JAX run
  stubs its per-chunk step (the rows do not depend on it); the port's runs
  for real. A small depthfirst job writes the JAX writer's columns.
- One statistical check: `-l 1 -p 32` at (128, 64), 4096 blocks at 1 dB in
  each package, BLERs within 5 binomial sigma.
- ASK with N not a multiple of --bps fails in both packages.
"""

import csv
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from polar_codes_tpu.dsp import modem as jmodem  # noqa: E402
from polar_codes_tpu.models import detectors as jdet  # noqa: E402
from polar_codes_tpu.models.adaptive import AdaptiveDecoder as JaxAdaptive  # noqa: E402
from polar_codes_tpu.models.encoder import PolarEncoder as JaxEncoder  # noqa: E402
from polar_codes_tpu.models.fastssc import FastSSCDecoder as JaxFastSSC  # noqa: E402
from polar_codes_tpu.models.scan import ScanDecoder as JaxScan  # noqa: E402
from polar_codes_tpu.models.scl import SCLDecoder as JaxSCL  # noqa: E402
from polar_codes_tpu.sim import checkpoint as jckpt  # noqa: E402
from polar_codes_tpu.sim import cli as jcli  # noqa: E402
from polar_codes_tpu.sim import montecarlo as jmc  # noqa: E402

from polar_codes_torch.construction import frozen_bits  # noqa: E402
from polar_codes_torch.models import detectors as tdet  # noqa: E402
from polar_codes_torch.models.adaptive import AdaptiveDecoder  # noqa: E402
from polar_codes_torch.models.encoder import PolarEncoder  # noqa: E402
from polar_codes_torch.models.fastssc import FastSSCDecoder  # noqa: E402
from polar_codes_torch.models.scan import ScanDecoder  # noqa: E402
from polar_codes_torch.models.scl import SCLDecoder  # noqa: E402
from polar_codes_torch.sim import checkpoint as tckpt  # noqa: E402
from polar_codes_torch.sim import cli as tcli  # noqa: E402
from polar_codes_torch.sim import montecarlo as tmc  # noqa: E402

N_LEN, K_LEN, BATCH = 64, 40, 48

# decoder name -> (port decoder, JAX decoder, amplification); CRC8
CHAINS = {
    "adaptive_int8": (lambda f, d: AdaptiveDecoder(N_LEN, f, list_size=8, detector=d,
                                                   fast_dtype=torch.int8, device="cpu"),
                      lambda f, d: JaxAdaptive(N_LEN, f, list_size=8, detector=d,
                                               fast_dtype=jnp.int8), 10.0),
    "scl8_float32": (lambda f, d: SCLDecoder(N_LEN, f, list_size=8, detector=d, device="cpu"),
                     lambda f, d: JaxSCL(N_LEN, f, list_size=8, detector=d), 1.0),
    "fastssc_float32": (lambda f, d: FastSSCDecoder(N_LEN, f, detector=d, device="cpu"),
                        lambda f, d: JaxFastSSC(N_LEN, f, detector=d), 1.0),
    "fastssc_int8": (lambda f, d: FastSSCDecoder(N_LEN, f, detector=d, dtype=torch.int8,
                                                 device="cpu"),
                     lambda f, d: JaxFastSSC(N_LEN, f, detector=d, dtype=jnp.int8), 10.0),
    "scan4": (lambda f, d: ScanDecoder(N_LEN, f, detector=d, iterations=4, device="cpu"),
              lambda f, d: JaxScan(N_LEN, f, detector=d, iterations=4), 1.0),
}


def _jax_chain(jenc, jdec, info, noise, fade, esn0, amp):
    """The simulator's chain from the JAX modules, on numpy draws."""
    x = jdet.CRC8().generate(jnp.asarray(info))
    code = jenc.encode(x, generate_crc=False)
    tx = jmodem.bpsk_modulate(code)
    es = jnp.float32(esn0)
    if fade is None:
        rx = tx + (1.0 / jnp.sqrt(2.0 * es)) * jnp.asarray(noise)
    else:
        g = jnp.asarray(fade)
        rx = tx * jnp.sqrt(jnp.sum(g * g, axis=-1)) + (1.0 / jnp.sqrt(es)) * jnp.asarray(noise)
    llr = jmodem.bpsk_demodulate(rx) * amp
    if getattr(jdec, "dtype", jnp.float32) == jnp.int8:
        llr = jnp.clip(jnp.round(llr), -127, 127).astype(jnp.int8)
    decoded, _, ok = jdec.decode(llr)
    return np.asarray(x), np.asarray(llr), np.asarray(decoded), np.asarray(ok)


@pytest.mark.parametrize("name,channel", [
    ("adaptive_int8", "awgn"), ("adaptive_int8", "rayleigh"), ("scl8_float32", "awgn"),
    ("scl8_float32", "rayleigh"), ("fastssc_float32", "rayleigh"), ("fastssc_int8", "awgn"),
    ("scan4", "awgn")])
def test_chain_equals_jax(name, channel):
    make, make_jax, amp = CHAINS[name]
    frozen = frozen_bits(N_LEN, K_LEN, 0.0)
    enc = PolarEncoder(N_LEN, frozen, detector=tdet.CRC8(), device="cpu")
    mc = tmc.MonteCarlo(enc, make(frozen, tdet.CRC8()), batch=BATCH, amplification=amp,
                        channel=channel)
    esn0 = mc.esn0_linear(1.5)
    rng = np.random.default_rng(len(name) * 7 + len(channel))
    info = rng.integers(0, 2, (BATCH, K_LEN)).astype(np.uint8)
    noise = rng.normal(size=(BATCH, N_LEN)).astype(np.float32)
    fade = rng.normal(size=(BATCH, N_LEN, 2)).astype(np.float32) if channel == "rayleigh" else None
    sent, llr = mc._llr_from(torch.as_tensor(info), torch.as_tensor(noise),
                             None if fade is None else torch.as_tensor(fade), esn0)
    decoded, _, ok = mc.decoder.decode(llr)
    counts = {k: int(v) for k, v in mc._count(sent, decoded, ok).items()}

    jenc = JaxEncoder(N_LEN, frozen, detector=jdet.CRC8())
    jsent, jllr, jdecoded, jok = _jax_chain(jenc, make_jax(frozen, jdet.CRC8()), info, noise,
                                            fade, esn0, amp)
    np.testing.assert_array_equal(sent.numpy(), jsent)
    assert llr.dtype == (torch.int8 if amp == 10.0 else torch.float32)
    np.testing.assert_array_equal(llr.numpy(), jllr)  # bit-equal LLRs
    np.testing.assert_array_equal(decoded.numpy(), jdecoded)
    np.testing.assert_array_equal(ok.numpy(), jok)
    err = jdecoded != jsent
    assert counts == {"runs": BATCH, "biterrors": int(err.sum()),
                      "errors": int(err.any(-1).sum()), "reported": int((~jok).sum())}
    assert 0 < counts["errors"] < BATCH  # the point sees both outcomes


@pytest.mark.parametrize("systematic", [True, False])
def test_int8_quantisation_rounds_half_to_even(systematic):
    """Noiseless BPSK gives LLRs of +-amplification: at x.5 the quantiser
    rounds half to even (jnp.round and torch.round), then clips to 127."""
    frozen = frozen_bits(N_LEN, K_LEN, 0.0)
    enc = PolarEncoder(N_LEN, frozen, systematic=systematic, device="cpu")
    dec = FastSSCDecoder(N_LEN, frozen, dtype=torch.int8, device="cpu")
    info = torch.as_tensor(np.random.default_rng(5).integers(0, 2, (4, K_LEN)).astype(np.uint8))
    noise = torch.zeros((4, N_LEN))
    for amp in (0.5, 1.5, 2.5, 3.5, 126.5, 127.5, 300.0):
        mc = tmc.MonteCarlo(enc, dec, batch=4, amplification=amp)
        _, llr = mc._llr_from(info, noise, None, 1.0)
        soft = (1.0 - 2.0 * enc.encode(info).numpy().astype(np.float32)) * np.float32(amp)
        want = np.asarray(jnp.clip(jnp.round(jnp.asarray(soft)), -127, 127).astype(jnp.int8))
        np.testing.assert_array_equal(llr.numpy(), want)
        assert set(np.abs(llr.numpy()).ravel().tolist()) == {min(round(amp), 127)}


def _results(mod):
    rows = [dict(N=1024, K=512, designSNR=0.0, errorDetection=32, L=8, EbN0=2.0,
                 bitsPerSymbol=1, BLER=0.0123, BER=1.5e-4, RER=0.0123, runs=8192,
                 errors=101, biterrors=789, reportedErrors=101, time=0.0123456789,
                 blps=663552.1, cbps=6.79e8, pbps=3.1e8, effectiveRate=3.0e8,
                 ebps=1.2e10, amplification=10.0, time_min=1.23e-6, time_max=4.5e-6,
                 time_mean=2.2e-6, time_dev=3.3e-7),
            dict(N=64, K=32, designSNR=-1.59174539, errorDetection=0, L=1,
                 EbN0=-1.59174539, bitsPerSymbol=2)]  # zero rates: the 1e-99 floor
    return [mod.JobResult(**r) for r in rows]


def test_write_csv_equals_jax(tmp_path):
    tmc.write_csv(str(tmp_path / "t.csv"), _results(tmc))
    jmc.write_csv(str(tmp_path / "j.csv"), _results(jmc))
    text = (tmp_path / "t.csv").read_text()
    assert text == (tmp_path / "j.csv").read_text()
    assert text.count("1e-99") == 3 and len(text.splitlines()[0].split(",")) == 23
    assert [f.name for f in dataclasses.fields(tmc.JobResult)] == \
        [f.name for f in dataclasses.fields(jmc.JobResult)]


def _small_mc(channel="awgn"):
    frozen = frozen_bits(N_LEN, K_LEN, 0.0)
    enc = PolarEncoder(N_LEN, frozen, detector=tdet.CRC8(), device="cpu")
    dec = FastSSCDecoder(N_LEN, frozen, detector=tdet.CRC8(), device="cpu")
    return tmc.MonteCarlo(enc, dec, batch=32, channel=channel)


def test_checkpoint_resume_equals_uninterrupted(tmp_path):
    mc = _small_mc("rayleigh")
    ref = mc.run_job(0.5, 32 * 4, seed=3, warmup=False)
    path = str(tmp_path / "ckpt.npz")
    cp1 = tckpt.SweepCheckpoint(path)
    mc.run_job(0.5, 32 * 2, seed=3, warmup=False, checkpoint=cp1, job_id="job")
    st = cp1.job_state("job")
    assert st["chunks_done"] == 2
    st.pop("complete")  # a stop after chunk 2 of the 4-chunk job
    st.pop("result")
    cp1.update("job", st)
    # the file reads in the JAX package as well
    assert jckpt.SweepCheckpoint(path).job_state("job")["chunks_done"] == 2
    got = mc.run_job(0.5, 32 * 4, seed=3, warmup=False,
                     checkpoint=tckpt.SweepCheckpoint(path), job_id="job")
    for field in ("runs", "errors", "biterrors", "reportedErrors", "BLER", "BER"):
        assert getattr(got, field) == getattr(ref, field)
    assert ref.runs == 128 and 0 < ref.errors < 128
    done = jckpt.SweepCheckpoint(path).completed("job")
    assert jmc.JobResult(**done).errors == ref.errors


def test_chunk_seeds_and_rebuilt_chunk():
    """Chunk i is seeded from (job seed, i) with SeedSequence; one chunk
    rebuilt by hand gives the job's counters."""
    assert tmc.chunk_seed(5, 2) == int(np.random.SeedSequence([5, 2]).generate_state(
        1, np.uint64)[0])
    assert len({tmc.chunk_seed(s, i) for s in range(3) for i in range(3)}) == 9
    mc = _small_mc()
    r = mc.run_job(1.0, 32, seed=7, warmup=False)
    gen = torch.Generator().manual_seed(tmc.chunk_seed(7, 0))
    info, llr = mc._make_llr(gen, mc.esn0_linear(1.0))
    decoded, _, ok = mc.decoder.decode(llr)
    counts = {k: int(v) for k, v in mc._count(info, decoded, ok).items()}
    assert counts == {"runs": r.runs, "errors": r.errors, "biterrors": r.biterrors,
                      "reported": r.reportedErrors}


def test_snr_sweep_seeds_each_point():
    mc = _small_mc()
    sweep = mc.run_snr_sweep([1.0, 2.0], 32, seed=2)
    assert [r.EbN0 for r in sweep] == [1.0, 2.0]
    again = mc.run_job(2.0, 32, seed=tmc.chunk_seed(2, 10 ** 6 + 1), warmup=False)
    assert (sweep[1].runs, sweep[1].errors, sweep[1].biterrors) == \
        (again.runs, again.errors, again.biterrors)


# ---- the CLI -----------------------------------------------------------------

TINY = ["-n", "64", "-r", "0.5", "-e", "crc8", "-w", "64", "--batch", "8",
        "--snr-min", "1", "--snr-max", "2", "--snr-count", "2", "--n-min", "32",
        "--n-max", "64", "--l-max", "4", "--r-min", "0.5", "--r-max", "0.75",
        "--r-count", "2", "--dsnr-min", "0", "--dsnr-max", "1", "--dsnr-count", "2",
        "--platform", "cpu"]
JOB_COLUMNS = ["N", "K", "dSNR", "C", "L", "Eb/N0", "BPS", "Runs", "Amplification"]


def _stub_jax_step(monkeypatch):
    """The JAX MonteCarlo with a step that counts `batch` runs and no error."""
    def build(self):
        self._gen = lambda key, esn0: (None, None)
        self._dec = lambda llr: (None, None)
        self._cnt = lambda info, decoded, ok: {"runs": self.batch, "biterrors": 0,
                                                "errors": 0, "reported": 0}

    monkeypatch.setattr(jmc.MonteCarlo, "_build", build)
    monkeypatch.setattr(jmc.MonteCarlo, "_measure_encoder_rate", lambda self: 1.0)


def _rows(path):
    with open(path) as f:
        return [[row[c] for c in JOB_COLUMNS] for row in csv.DictReader(f)]


SIMTYPES = ["single", "codelength", "designsnr", "listlength", "rate", "amplification",
            "fixed", "depthfirst", "scan", "fastsscan", "ask", "compareall"]


@pytest.mark.parametrize("simtype", SIMTYPES)
def test_cli_job_list_equals_jax(simtype, tmp_path, monkeypatch):
    _stub_jax_step(monkeypatch)
    assert jcli.main([simtype, *TINY, "-o", str(tmp_path / "j")]) == 0
    assert tcli.main([simtype, *TINY, "-o", str(tmp_path / "t")]) == 0
    name = f"{simtype}.csv"
    got, want = _rows(tmp_path / f"t_{name}"), _rows(tmp_path / f"j_{name}")
    assert got == want and len(got) >= 2


def test_cli_getcode_equals_jax(capsys):
    for construction in ("BB", "5G", "GA"):
        args = ["getcode", "-n", "128", "-r", "0.25", "--construction", construction]
        jcli.main(args)
        want = capsys.readouterr().out
        tcli.main(args)
        assert capsys.readouterr().out == want


def test_depthfirst_cli_writes_jax_columns(tmp_path):
    """pcsim-torch depthfirst: SC-Flip with -l trials, CRC8, 2 x 64 blocks
    at 2 dB; the CSV has the JAX writer's header and 23 columns, and the
    counters add up."""
    args = ["depthfirst", "-n", "64", "-r", "0.5", "-e", "crc8", "-l", "4", "-p", "32",
            "-w", str(128 * 64), "--batch", "64", "--snr-count", "1", "--snr-max", "2",
            "--platform", "cpu"]
    assert tcli.main(args + ["-o", str(tmp_path / "t")]) == 0
    lines = open(tmp_path / "t_depthfirst.csv").read().splitlines()
    assert lines[0] == jmc.CSV_HEADER
    assert {len(line.split(",")) for line in lines} == {23}
    (row,) = csv.DictReader(lines)
    assert int(row["Runs"]) == 128 and int(row["Errors"]) <= 128
    assert float(row["RER"]) <= float(row["BLER"]) < 1.0


def test_ask_with_padding_fails_in_both(tmp_path):
    args = ["ask", "--bps", "3", "-n", "64", "-l", "1", "-e", "crc8", "-w", "64",
            "--batch", "8", "--snr-count", "1", "--platform", "cpu"]
    with pytest.raises(TypeError):  # a shape error in the JAX decoder
        jcli.main(args + ["-o", str(tmp_path / "j")])
    with pytest.raises(ValueError, match="bits per symbol do not divide"):
        tcli.main(args + ["-o", str(tmp_path / "t")])


def test_bler_statistically_equal_to_jax(tmp_path):
    """-l 1 -p 32 at (128, 64), CRC32, 4096 blocks at 1 dB in each package:
    BLERs within 5 binomial sigma of each other."""
    args = ["single", "-n", "128", "-r", "0.5", "-l", "1", "-p", "32", "--snr-count", "1",
            "--snr-max", "1", "-w", str(4096 * 128), "--platform", "cpu"]
    jcli.main(args + ["-o", str(tmp_path / "j")])
    tcli.main(args + ["-o", str(tmp_path / "t")])
    (j,), (t,) = (list(csv.DictReader(open(tmp_path / f"{p}_single.csv"))) for p in "jt")
    assert int(j["Runs"]) == int(t["Runs"]) == 4096
    pj, pt = int(j["Errors"]) / 4096, int(t["Errors"]) / 4096
    p = (pj + pt) / 2
    assert 0.01 < p < 0.9
    assert abs(pj - pt) <= 5 * math.sqrt(2 * p * (1 - p) / 4096)
