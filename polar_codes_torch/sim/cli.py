"""pcsim-equivalent command-line simulator, the port of
polar_codes_tpu/sim/cli.py. Run as:

    python -m polar_codes_torch.sim.cli single -n 1024 -r 0.5 -l 8 \
        --snr-min 1 --snr-max 3 --snr-count 3 -w 2e7

It runs on the CUDA card (`--platform cpu` runs the kernels' plain versions
on the CPU) and writes pcsim's 23-column CSV to <output>_<simtype>.csv.
The options are the JAX package's, letter for letter, but for --backend:
the port has one backend, the card's kernels. `--threads` is accepted and
ignored; parallelism comes from the batch (`--batch`) and from one process
per card (`--devices n` under `torchrun --nproc-per-node n`, the counters
all-reduced over the process group). `--precision` {8, 32, 832} picks the
decoder, 832 being the adaptive int8-fast + float32-list decoder, the
reference's default.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List

import numpy as np
import torch

SIM_TYPES = [
    "single", "codelength", "designsnr", "listlength", "rate",
    "amplification", "fixed", "depthfirst", "scan", "fastsscan", "ask",
    "compareall", "getcode",
]

SNR_MIN_DEFAULT = -1.59174539  # Shannon limit of the rate-1/2 code (pcsim's setup)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pcsim-torch", description=__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("simtype", nargs="?", default="single", choices=SIM_TYPES)
    p.add_argument("-w", "--workload", type=float, default=1e9,
                   help="bits per simulation job")
    p.add_argument("--snr-min", type=float, default=SNR_MIN_DEFAULT)
    p.add_argument("--snr-max", type=float, default=4.0)
    p.add_argument("--snr-count", type=int, default=16)
    p.add_argument("-d", "--design-snr", type=float, default=0.0)
    p.add_argument("--dsnr-min", type=float, default=SNR_MIN_DEFAULT)
    p.add_argument("--dsnr-max", type=float, default=6.0)
    p.add_argument("--dsnr-count", type=int, default=6)
    p.add_argument("-n", "--blocklength", type=int, default=1024)
    p.add_argument("--n-min", type=int, default=128)
    p.add_argument("--n-max", type=int, default=32768)
    p.add_argument("-r", "--rate", type=float, default=0.5)
    p.add_argument("--r-min", type=float, default=0.25)
    p.add_argument("--r-max", type=float, default=0.9)
    p.add_argument("--r-count", type=int, default=5)
    p.add_argument("-l", "--pathlimit", type=int, default=8)
    p.add_argument("--l-min", type=int, default=1)
    p.add_argument("--l-max", type=int, default=16)
    p.add_argument("-e", "--error-detection", default="crc32",
                   help="off|crc6nr|crc8|crc11nr|crc16|crc16nr|crc24nrc|"
                        "crc32|cmac8..cmac128")
    p.add_argument("--non-systematic", action="store_true")
    p.add_argument("-p", "--precision", type=int, default=832,
                   choices=[8, 32, 832])
    p.add_argument("-a", "--amplification", type=float, default=10.0)
    p.add_argument("--bps", type=int, default=1,
                   help="bits per ASK symbol (ask simtype)")
    p.add_argument("--construction", default="BB", help="BB|BE|5G|GA")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="accepted for pcsim compatibility; ignored")
    p.add_argument("-o", "--output", default="simulation")
    p.add_argument("--batch", type=int, default=1024,
                   help="codewords per device step")
    p.add_argument("--devices", type=int, default=0,
                   help="number of devices, one process each (torchrun); must "
                        "equal the process group's size; 0 = one device, no group")
    p.add_argument("--channel", default="awgn", choices=["awgn", "rayleigh"],
                   help="channel model (the reference's Rayleigh transmitter, "
                        "as a simtype-independent option)")
    p.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                   help="auto = the CUDA card (an error without one); cpu = "
                        "the kernels' plain versions on the CPU")
    p.add_argument("--checkpoint", default="",
                   help="npz path for chunk-level checkpoint/resume")
    return p


def parse_detector(spec: str):
    from ..models.detectors import make_detector

    s = spec.strip().lower()
    if s in ("off", "none", "dummy", "0"):
        return make_detector(0, "crc")
    for prefix, kind in (("crc", "crc"), ("cmac", "cmac")):
        if s.startswith(prefix):
            rest = s[len(prefix):]
            nr = rest.endswith("nr") or rest.endswith("nrc")
            digits = "".join(c for c in rest if c.isdigit())
            size = int(digits) if digits else 32
            return make_detector(size, prefix + ("nr" if nr else ""))
    raise ValueError(f"unknown error-detection spec: {spec}")


def _device(args) -> str:
    return "cpu" if args.platform == "cpu" else "cuda"


def make_coders(n_len, k_len, args, detector):
    """Construction, encoder and decoder of one job, on the device that
    --platform names."""
    from ..construction import frozen_bits
    from ..models.adaptive import AdaptiveDecoder
    from ..models.encoder import PolarEncoder
    from ..models.fastssc import FastSSCDecoder
    from ..models.scl import SCLDecoder

    device = _device(args)
    frozen = frozen_bits(n_len, k_len, args.design_snr, args.construction)
    systematic = not args.non_systematic
    enc = PolarEncoder(n_len, frozen, systematic=systematic, detector=detector,
                       device=device)
    list_size = args.pathlimit
    simtype = args.simtype
    if simtype in ("scan", "fastsscan"):
        from ..models.scan import FastSScanDecoder, ScanDecoder

        cls = ScanDecoder if simtype == "scan" else FastSScanDecoder
        dec = cls(n_len, frozen, systematic=systematic, detector=detector,
                  iterations=list_size, device=device)
        return enc, dec
    if simtype == "depthfirst":
        from ..models.depthfirst import DepthFirstDecoder

        dec = DepthFirstDecoder(n_len, frozen, systematic=systematic,
                                detector=detector, trial_limit=list_size,
                                device=device)
        return enc, dec
    dtype = torch.int8 if args.precision == 8 else torch.float32
    if list_size <= 1:
        dec = FastSSCDecoder(n_len, frozen, systematic=systematic,
                             detector=detector, dtype=dtype, device=device)
    elif args.precision == 832 and detector.tail_bits:
        dec = AdaptiveDecoder(n_len, frozen, list_size=list_size,
                              systematic=systematic, detector=detector,
                              fast_dtype=torch.int8, device=device)
    else:
        dec = SCLDecoder(n_len, frozen, list_size=list_size,
                         systematic=systematic, detector=detector,
                         dtype=dtype, device=device)
    return enc, dec


def snr_points(args) -> List[float]:
    if args.snr_count <= 1:
        return [args.snr_max]
    step = (args.snr_max - args.snr_min) / (args.snr_count - 1)
    return [args.snr_min + i * step for i in range(args.snr_count)]


def _is_main_rank() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def run_jobs(args, job_params, write=True):
    """job_params: list of (N, K, L override or None, bps). Runs every job
    at every SNR point and writes the CSV (from rank 0 under a group)."""
    from ..dsp.modem import Ask, Bpsk
    from ..models.detectors import CMAC
    from ..parallel.mesh import default_mesh
    from .montecarlo import MonteCarlo, write_csv

    mesh = default_mesh(args.devices, _device(args)) if args.devices else None
    checkpoint = None
    if getattr(args, "checkpoint", ""):
        from .checkpoint import SweepCheckpoint

        checkpoint = SweepCheckpoint(args.checkpoint)
    main_rank = _is_main_rank()
    results = []
    for n_len, k_len, l_override, bps in job_params:
        local = argparse.Namespace(**vars(args))
        if l_override is not None:
            local.pathlimit = l_override
        detector = parse_detector(args.error_detection)
        if detector.tail_bits >= k_len:
            print(f"skip N={n_len} K={k_len}: CRC larger than payload")
            continue
        cmac = isinstance(detector, CMAC)
        if main_rank and cmac:
            print(f"CMAC engine: {detector.engine}")
        enc, dec = make_coders(n_len, k_len, local, detector)
        modem = Ask(bps) if bps > 1 else Bpsk()
        amplification = (
            args.amplification if args.precision in (8, 832) else 1.0
        )
        mc = MonteCarlo(enc, dec, modem=modem, batch=args.batch,
                        amplification=amplification, mesh=mesh,
                        design_snr=args.design_snr,
                        channel=getattr(args, "channel", "awgn"))
        blocks = max(1, int(args.workload // n_len))
        for i, snr in enumerate(snr_points(args)):
            if main_rank:
                print(f"[job] N={n_len} K={k_len} L={local.pathlimit} "
                      f"dSNR={args.design_snr} det={args.error_detection} "
                      f"EbN0={snr:.3f}")
            host0 = detector.host_seconds if cmac else 0.0
            t0 = time.perf_counter()
            r = mc.run_job(snr, blocks, seed=i, checkpoint=checkpoint)
            wall = time.perf_counter() - t0
            if main_rank:
                print(f"  BLER={r.BLER:.4g} BER={r.BER:.4g} RER={r.RER:.4g} "
                      f"throughput={r.cbps / 1e6:.1f}Mbps "
                      f"delay[us]=[{r.time_min * 1e6:.1f};{r.time_max * 1e6:.1f}]"
                      f"({r.time_mean * 1e6:.1f})")
                cmac_share = (detector.host_seconds - host0) / wall if cmac else None
                print(f"  wall={wall:.4f}s decode_share={r.time / wall:.4f}"
                      + (f" cmac_share={cmac_share:.4f}" if cmac else ""))
            results.append(r)
    if write and main_rank:
        out = f"{args.output}_{args.simtype}.csv"
        write_csv(out, results)
        print(f"results written to {out}")
    return results


def _write_all(args, name, results):
    from .montecarlo import write_csv

    if _is_main_rank():
        write_csv(f"{args.output}_{name}.csv", results)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.devices:
        from ..parallel.mesh import init_distributed

        init_distributed(device=_device(args))

    n_len, rate = args.blocklength, args.rate
    if args.simtype == "getcode":
        from ..construction import frozen_bits

        frozen = frozen_bits(n_len, int(n_len * rate), args.design_snr,
                             args.construction)
        print(" ".join(str(i) for i in frozen))
        return 0

    if args.simtype in ("single", "depthfirst", "scan", "fastsscan", "fixed"):
        jobs = [(n_len, int(n_len * rate), None, 1)]
    elif args.simtype == "codelength":
        jobs = []
        n = args.n_min
        while n <= args.n_max:
            jobs.append((n, int(n * rate), None, 1))
            n *= 2
    elif args.simtype == "listlength":
        jobs, l = [], args.l_min
        while l <= args.l_max:
            jobs.append((n_len, int(n_len * rate), l, 1))
            l *= 2
    elif args.simtype == "rate":
        jobs = []
        for i in range(args.r_count):
            r = args.r_min + i * (args.r_max - args.r_min) / max(
                args.r_count - 1, 1
            )
            jobs.append((n_len, int(n_len * r), None, 1))
    elif args.simtype == "designsnr":
        jobs = [(n_len, int(n_len * rate), None, 1)]
        # design-SNR sweep: one run per dSNR value
        results = []
        for i in range(args.dsnr_count):
            d = args.dsnr_min + i * (args.dsnr_max - args.dsnr_min) / max(
                args.dsnr_count - 1, 1
            )
            sub = argparse.Namespace(**vars(args))
            sub.design_snr = d
            results += run_jobs(sub, jobs, write=False)
        _write_all(args, args.simtype, results)
        return 0
    elif args.simtype == "ask":
        jobs = [(n_len, int(n_len * rate), None, max(args.bps, 2))]
    elif args.simtype == "amplification":
        results = []
        for amp in np.linspace(1.0, 128.0, 6):
            sub = argparse.Namespace(**vars(args))
            sub.amplification = float(amp)
            results += run_jobs(sub, [(n_len, int(n_len * rate), None, 1)],
                                write=False)
        _write_all(args, args.simtype, results)
        return 0
    elif args.simtype == "compareall":
        # the reference's preset: decoder family shoot-out
        results = []
        for prec, l in ((32, 1), (8, 1), (32, 8), (832, 8)):
            sub = argparse.Namespace(**vars(args))
            sub.precision, sub.pathlimit = prec, l
            results += run_jobs(sub, [(n_len, int(n_len * rate), None, 1)],
                                write=False)
        for st in ("scan", "fastsscan", "depthfirst"):
            sub = argparse.Namespace(**vars(args))
            sub.simtype = st
            results += run_jobs(sub, [(n_len, int(n_len * rate), None, 1)],
                                write=False)
        _write_all(args, "compareall", results)
        return 0
    else:
        raise NotImplementedError(f"simtype {args.simtype}")

    run_jobs(args, jobs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
