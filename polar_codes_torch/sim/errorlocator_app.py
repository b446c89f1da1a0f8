"""Error-locator simulation app: first-error-position histograms, the port
of polar_codes_tpu/sim/errorlocator_app.py.

Runs the encode -> BPSK -> AWGN -> genie-aided SC chain and writes a CSV
histogram of first-error u-channel positions plus per-channel error
counts, the empirical bit-channel reliabilities:

    python -m polar_codes_torch.sim.errorlocator_app -n 256 -r 0.5 \
        --snr-min 1 --snr-max 3 --snr-count 3 -w 1000000 -o errorlocator

It runs on the CUDA card (an error without one); `--platform cpu` runs on
the CPU. Chunk i of SNR point s draws its info bits, then its noise, from
a torch.Generator seeded chunk_seed(s, i) (sim/montecarlo.py). The
histograms are summed on the device and read once per SNR point.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="errorlocator-torch", description=__doc__)
    p.add_argument("-n", "--blocklength", type=int, default=1024)
    p.add_argument("-r", "--rate", type=float, default=0.5)
    p.add_argument("-d", "--design-snr", type=float, default=0.0)
    p.add_argument("--construction", default="BB")
    p.add_argument("--snr-min", type=float, default=0.0)
    p.add_argument("--snr-max", type=float, default=4.0)
    p.add_argument("--snr-count", type=int, default=5)
    p.add_argument("-w", "--workload", type=float, default=1e7)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("-o", "--output", default="errorlocator")
    p.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                   help="auto = the CUDA card (an error without one); cpu = the CPU")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..construction import frozen_bits
    from ..dsp import add_awgn, bpsk_modulate
    from ..models.encoder import PolarEncoder
    from ..models.errorlocator import ErrorLocator
    from ..utils.device import resolve_device
    from .montecarlo import chunk_seed

    device = resolve_device("cpu" if args.platform == "cpu" else "cuda")
    n_len = args.blocklength
    k_len = int(n_len * args.rate)
    frozen = frozen_bits(n_len, k_len, args.design_snr, args.construction)
    enc = PolarEncoder(n_len, frozen, systematic=False, device=device)
    loc = ErrorLocator(n_len, frozen, device=device)
    blocks = max(1, int(args.workload // n_len))
    chunks = max(1, blocks // args.batch)
    snrs = (np.linspace(args.snr_min, args.snr_max, args.snr_count)
            if args.snr_count > 1 else [args.snr_max])
    rows = []
    for s_i, snr in enumerate(snrs):
        esn0 = 10 ** (snr / 10) * k_len / n_len
        first_hist = torch.zeros(n_len + 1, dtype=torch.int64, device=device)
        err_counts = torch.zeros(n_len, dtype=torch.int64, device=device)
        for i in range(chunks):
            gen = torch.Generator(device=device).manual_seed(chunk_seed(s_i, i))
            info = torch.randint(0, 2, (args.batch, k_len), generator=gen, device=device,
                                 dtype=torch.uint8)
            code = enc.encode(info)
            llr = add_awgn(bpsk_modulate(code), gen, esn0_linear=esn0)
            first, err = loc.locate(llr, code)
            first_hist += torch.bincount(first, minlength=n_len + 1)
            err_counts += err.sum(dim=0)
        first_hist, err_counts = first_hist.cpu().numpy(), err_counts.cpu().numpy()
        total = chunks * args.batch
        print(f"EbN0={snr:.2f}: {total - first_hist[n_len]}/{total} frames "
              f"with >=1 genie error")
        for pos in range(n_len):
            if first_hist[pos] or err_counts[pos]:
                rows.append((n_len, k_len, snr, pos, first_hist[pos], err_counts[pos], total))

    out = f"{args.output}_firsterror.csv"
    with open(out, "w") as f:
        f.write('"N","K","Eb/N0","position","first_errors","errors","frames"\n')
        for row in rows:
            f.write(",".join(str(v) for v in row) + "\n")
    print(f"results written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
