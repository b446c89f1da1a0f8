"""Batched Monte-Carlo BER/BLER simulator.

The port of polar_codes_tpu/sim/montecarlo.py: per job (N, K, L, Eb/N0)
it generates random payloads, encodes, modulates, sends them through the
channel, demodulates, decodes and counts bit, block and reported errors,
with per-block decode-time statistics; results carry pcsim's 23-column CSV
schema, including the 1e-99 floor of zero error rates.

A job runs in chunks of `batch` codewords ([batch, N] tensors on the
encoder's device). Chunk i draws from a torch.Generator seeded with
numpy's SeedSequence([job seed, i]) (`chunk_seed`, the analogue of
jax.random.fold_in), so a job resumed from a checkpoint draws exactly what
an uninterrupted one draws. The draws come first (`_make_llr`: info bits,
then the Rayleigh fade, then the noise), and a pure function of them
(`_llr_from`) computes the channel LLRs.

On one device the decode alone is timed (synchronise, then the host clock
around decoder.decode), as pcsim times it. With a mesh (parallel/mesh.py:
one process per device) every rank runs the step on its own batch from
its own generator and the counters are all-reduced; the whole step is
timed then.
"""

from __future__ import annotations

import math
import time
from dataclasses import asdict, dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..dsp.channel import awgn_from, rayleigh_from
from ..dsp.modem import Bpsk, Modem
from ..parallel.mesh import distribute_keys, sharded_counter_step
from ..utils.timing import time_on

WARMUP_CHUNK = 0xDEAD  # the warm-up step's chunk index, as in the JAX package


def chunk_seed(job_seed: int, index: int) -> int:
    """The generator seed of chunk `index` of the job seeded `job_seed`."""
    return int(np.random.SeedSequence([int(job_seed), int(index)])
               .generate_state(1, np.uint64)[0])


class Statistics:
    """min/max/mean/dev accumulator (the reference's statistics.h)."""

    def __init__(self):
        self.values: List[float] = []

    def insert(self, value: float):
        self.values.append(float(value))

    @property
    def min(self) -> float:
        return min(self.values) if self.values else 0.0

    @property
    def max(self) -> float:
        return max(self.values) if self.values else 0.0

    @property
    def mean(self) -> float:
        return float(np.mean(self.values)) if self.values else 0.0

    @property
    def dev(self) -> float:
        # sample deviation sqrt(sum/(size-1)); 0.0 with fewer than 2 samples
        if len(self.values) < 2:
            return 0.0
        return float(np.std(self.values, ddof=1))

    @property
    def sum(self) -> float:
        return float(np.sum(self.values)) if self.values else 0.0


@dataclass
class JobResult:
    """One CSV row; the fields are the JAX package's (pcsim's DataPoint)."""

    N: int
    K: int
    designSNR: float
    errorDetection: int
    L: int
    EbN0: float
    bitsPerSymbol: int = 1
    BLER: float = 0.0
    BER: float = 0.0
    RER: float = 0.0
    runs: int = 0
    errors: int = 0
    biterrors: int = 0
    reportedErrors: int = 0
    time: float = 0.0
    blps: float = 0.0
    cbps: float = 0.0
    pbps: float = 0.0
    effectiveRate: float = 0.0
    ebps: float = 0.0
    amplification: float = 1.0
    time_min: float = 0.0
    time_max: float = 0.0
    time_mean: float = 0.0
    time_dev: float = 0.0


CSV_HEADER = (
    '"N","K","dSNR","C","L","Eb/N0","BPS","BLER","BER","RER","Runs","Errors",'
    '"Time","Blockspeed","Coded Bitrate","Payload Bitrate",'
    '"Effective Payload Bitrate","Encoder Bitrate","Amplification",'
    '"time min","time max","time mean","time deviation"'
)


def _rate_or_floor(x: float) -> str:
    """pcsim writes 1e-99 for zero rates, so log plots never hit 0."""
    return repr(x) if x > 0.0 else "1e-99"


def write_csv(path: str, jobs: Sequence[JobResult]):
    """pcsim-schema CSV, character for character the JAX package's."""
    with open(path, "w") as f:
        f.write(CSV_HEADER + "\n")
        for j in jobs:
            row = [
                j.N, j.K, j.designSNR, j.errorDetection, j.L, j.EbN0,
                j.bitsPerSymbol,
                _rate_or_floor(j.BLER), _rate_or_floor(j.BER),
                _rate_or_floor(j.RER),
                j.runs, j.errors, j.time, j.blps, j.cbps, j.pbps,
                j.effectiveRate, j.ebps, j.amplification,
                int(j.time_min * 1e9), int(j.time_max * 1e9),
                int(j.time_mean * 1e9), int(j.time_dev * 1e9),
            ]
            f.write(",".join(str(v) for v in row) + "\n")


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_host(stats) -> dict:
    """Counters as Python ints (a read that waits for the device)."""
    return {k: int(v) for k, v in stats.items()}


class MonteCarlo:
    """Monte-Carlo runner for one (encoder, decoder, modem) chain.

    `encoder` and `decoder` are this package's codec objects for the same
    code on the same device, sharing the detector. `batch` is the number
    of codewords per step on each device. `mesh` is parallel.mesh's
    default_mesh (None: one device, no collective).
    """

    def __init__(
        self,
        encoder,
        decoder,
        modem: Optional[Modem] = None,
        batch: int = 1024,
        amplification: float = 1.0,
        mesh=None,
        design_snr: float = 0.0,
        channel: str = "awgn",
    ):
        self.encoder = encoder
        self.decoder = decoder
        self.modem = modem if modem is not None else Bpsk()
        self.batch = int(batch)
        self.amplification = float(amplification)
        self.mesh = mesh
        self.design_snr = float(design_snr)
        if channel not in ("awgn", "rayleigh"):
            raise ValueError(f"unknown channel {channel}")
        self.channel = channel
        self.detector = encoder.detector
        self.device = encoder.device
        if decoder.device != self.device:
            raise ValueError(f"encoder on {self.device}, decoder on {decoder.device}")
        bps = self.modem.bits_per_symbol
        if encoder.block_length % bps:
            # the JAX package fails here too, later: the ASK demodulator
            # returns the pad bits' metrics and no caller slices them off
            raise ValueError(
                f"{bps} bits per symbol do not divide N = {encoder.block_length}: "
                f"the demodulator would return {-(-encoder.block_length // bps) * bps} "
                "metrics a block (the reference pads to whole symbols)")
        self._step = (sharded_counter_step(self._local_step) if mesh is not None
                      else self._local_step)

    # -- one chunk ------------------------------------------------------------

    def _generator(self, seed: int) -> torch.Generator:
        """This rank's generator of the step seeded `seed`."""
        return torch.Generator(device=self.device).manual_seed(distribute_keys(seed))

    def _make_llr(self, gen: torch.Generator, esn0_linear: float):
        """Draw the info bits, then (Rayleigh) the fade, then the noise from
        `gen`; return _llr_from of them."""
        n_len = self.encoder.block_length
        n_sym = -(-n_len // self.modem.bits_per_symbol)
        info = torch.randint(0, 2, (self.batch, self.encoder.info_length),
                             generator=gen, device=self.device, dtype=torch.uint8)
        fade = None
        if self.channel == "rayleigh":
            fade = torch.randn((self.batch, n_sym, 2), generator=gen, device=self.device)
        noise = torch.randn((self.batch, n_sym), generator=gen, device=self.device)
        return self._llr_from(info, noise, fade, esn0_linear)

    def _llr_from(self, info: torch.Tensor, noise: torch.Tensor,
                  fade: Optional[torch.Tensor], esn0_linear: float):
        """(info with its checksum [B, K], channel LLRs [B, N]) of the draws:
        generate, encode, modulate, channel, demodulate, amplify, and for
        an int8 decoder clamp(round(.), -127, 127) (round half to even)."""
        if self.detector.tail_bits:
            info = self.detector.generate(info)
        code = self.encoder.encode(info, generate_crc=False)
        tx = self.modem.modulate(code)
        if self.channel == "rayleigh":
            rx = rayleigh_from(tx, fade, noise, esn0_linear)
        else:
            rx = awgn_from(tx, noise, esn0_linear)
        llr = self.modem.demodulate(rx) * self.amplification
        if getattr(self.decoder, "dtype", torch.float32) == torch.int8:
            llr = torch.clamp(torch.round(llr), -127, 127).to(torch.int8)
        return info, llr

    def _count(self, info: torch.Tensor, decoded: torch.Tensor, ok: torch.Tensor):
        """Scalar int64 counters of one batch, left on the device."""
        err = decoded != info
        return {
            "runs": torch.tensor(self.batch, dtype=torch.int64, device=info.device),
            "biterrors": err.sum(),
            "errors": err.any(dim=-1).sum(),
            "reported": (~ok).sum(),
        }

    def _local_step(self, seed: int, esn0_linear: float):
        info, llr = self._make_llr(self._generator(seed), esn0_linear)
        decoded, _, ok = self.decoder.decode(llr)
        return self._count(info, decoded, ok)

    # -- job loop -------------------------------------------------------------

    def esn0_linear(self, ebn0_db: float) -> float:
        """Eb/N0 -> Es/N0 with the code rate and the bits per symbol."""
        rate = self.encoder.info_length / self.encoder.block_length
        return 10.0 ** (ebn0_db / 10.0) * rate * self.modem.bits_per_symbol

    def run_job(
        self,
        ebn0_db: float,
        blocks: int,
        seed: int = 0,
        warmup: bool = True,
        checkpoint=None,
        job_id: Optional[str] = None,
    ) -> JobResult:
        """Simulate >= `blocks` codewords at one Eb/N0 point.

        With `checkpoint` (sim.checkpoint.SweepCheckpoint) the counters
        persist after every chunk, and a restarted job resumes at its first
        unfinished chunk with the same draws."""
        if checkpoint is not None and job_id is None:
            enc = self.encoder
            job_id = (
                f"n{enc.block_length}_k{enc.info_length}_"
                f"l{getattr(self.decoder, 'list_size', 1)}_snr{ebn0_db:.4f}"
            )
        esn0 = self.esn0_linear(ebn0_db)
        chunks = max(1, math.ceil(blocks / self._global_batch()))
        stats = {"runs": 0, "biterrors": 0, "errors": 0, "reported": 0}
        tstat = Statistics()
        first_chunk = 0
        if checkpoint is not None:
            done = checkpoint.completed(job_id)
            if done is not None:
                return JobResult(**done)
            st = checkpoint.job_state(job_id)
            first_chunk = st["chunks_done"]
            for k in stats:
                stats[k] = st.get(k, 0)
            tstat.values = list(st["times"])

        if warmup:  # kernel builds and caches, not counted
            _to_host(self._step(chunk_seed(seed, WARMUP_CHUNK), esn0))

        for i in range(first_chunk, chunks):
            s = chunk_seed(seed, i)
            if self.mesh is not None:
                _sync(self.device)
                t0 = time.perf_counter()
                out = _to_host(self._step(s, esn0))
                dt = time.perf_counter() - t0
            else:
                info, llr = self._make_llr(self._generator(s), esn0)
                _sync(self.device)
                t0 = time.perf_counter()
                decoded, _, ok = self.decoder.decode(llr)
                _sync(self.device)
                dt = time.perf_counter() - t0
                out = _to_host(self._count(info, decoded, ok))
            tstat.insert(dt / self._global_batch())  # per-block decode time
            for k in stats:
                stats[k] += out[k]
            if checkpoint is not None:
                checkpoint.update(
                    job_id, {"chunks_done": i + 1, "times": tstat.values, **stats})

        enc = self.encoder
        k_len, n_len = enc.info_length, enc.block_length
        c_bits = self.detector.tail_bits
        r = JobResult(
            N=n_len, K=k_len, designSNR=self.design_snr,
            errorDetection=c_bits,
            L=getattr(self.decoder, "list_size", 1), EbN0=float(ebn0_db),
            bitsPerSymbol=self.modem.bits_per_symbol,
            runs=stats["runs"], errors=stats["errors"],
            biterrors=stats["biterrors"], reportedErrors=stats["reported"],
            amplification=self.amplification,
        )
        runs = max(r.runs, 1)
        r.BLER = r.errors / runs
        r.BER = r.biterrors / (runs * k_len)
        r.RER = r.reportedErrors / runs
        total_time = tstat.sum * self._global_batch()  # sum of per-block times
        r.time = total_time
        r.blps = runs / total_time if total_time else 0.0
        r.cbps = runs * n_len / total_time if total_time else 0.0
        r.pbps = runs * (k_len - c_bits) / total_time if total_time else 0.0
        r.effectiveRate = (
            (runs - r.errors) * (k_len - c_bits) / total_time if total_time else 0.0
        )
        r.ebps = self._measure_encoder_rate() * n_len
        r.time_min, r.time_max = tstat.min, tstat.max
        r.time_mean, r.time_dev = tstat.mean, tstat.dev
        if checkpoint is not None:
            checkpoint.mark_complete(job_id, asdict(r))
        return r

    def run_snr_sweep(self, ebn0_db_list: Sequence[float], blocks: int,
                      seed: int = 0) -> List[JobResult]:
        return [self.run_job(snr, blocks, seed=chunk_seed(seed, 10 ** 6 + i))
                for i, snr in enumerate(ebn0_db_list)]

    # -- helpers --------------------------------------------------------------

    def _global_batch(self) -> int:
        return self.batch * (len(self.mesh) if self.mesh is not None else 1)

    def _measure_encoder_rate(self) -> float:
        """Encoded blocks/s of the encoder (the reference's ebps), timed on
        the device the chain runs on."""
        info = torch.zeros((self.batch, self.encoder.info_length), dtype=torch.uint8,
                           device=self.device)
        ms = time_on(self.device, lambda: self.encoder.encode(info, generate_crc=False))
        return self.batch / (ms / 1e3) if ms > 0 else 0.0
