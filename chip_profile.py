#!/usr/bin/env python3
"""Where the device time goes on the port's slice-2 paths, on one CUDA card.

Traces a few warm calls of each path with torch.profiler (CPU and CUDA
activities) and prints, per path, one JSON line: host wall time per call
(synchronised host clock around the traced window, profiler overhead
included), device busy time per call (the union of the device events'
intervals), the busy share, the number of device kernels per call, and
the device time of the heaviest kernels by name.

Paths, at (1024, 512), Bhattacharyya at 0 dB, CRC32, Eb/N0 = 2 dB,
B = 2048, LLRs x10 (the simulator's defaults):
  adaptive    AdaptiveDecoder(int8 fast pass, L = 8).decode on int8 LLRs
  fast_int8   its Fast-SSC pass alone (K3 int8 + the CRC32 check)
  rerun_scl8  its list stage on the rows whose fast CRC failed
  scan4       ScanDecoder(4 sweeps).decode (K4)
  fastsscan4  FastSScanDecoder(CRC32, 4 iterations).decode (K5)

    python3 chip_profile.py

Exits non-zero without a CUDA device, or if a window shows no device time.
"""

import json
import subprocess
import sys
import time

N_LEN, K_LEN, LIST, EBN0_DB, BATCH, AMPL = 1024, 512, 8, 2.0, 2048, 10.0
CALLS = 10
TOP = 6


def device_events(prof, torch):
    """(name, start_us, end_us) of every event that ran on the device."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == cuda]


def busy_us(events):
    """Length of the union of the events' intervals."""
    total, end = 0.0, None
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile(name, fn, calls, card, torch):
    from torch.profiler import ProfilerActivity, profile as tprofile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    events = device_events(prof, torch)
    if not events:
        raise SystemExit(f"{name}: the profiler recorded no device time")
    by_name = {}
    for n, s, e in events:
        ms, count = by_name.get(n, (0.0, 0))
        by_name[n] = (ms + (e - s) / 1e3, count + 1)
    busy_ms = busy_us(events) / 1e3 / calls
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    print(json.dumps({
        "path": name, "batch": BATCH, "wall_ms_per_call": wall_ms,
        "device_busy_ms_per_call": busy_ms, "busy_share": busy_ms / wall_ms,
        "device_events_per_call": len(events) / calls,
        "top": [{"name": n[:90], "ms_per_call": ms / calls, "per_call": c / calls}
                for n, (ms, c) in top],
        "card": card}), flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_profile.py: no CUDA device; nothing was run")
    from polar_codes_torch.construction import frozen_bits
    from polar_codes_torch.dsp import Awgn, Bpsk
    from polar_codes_torch.models.adaptive import AdaptiveDecoder
    from polar_codes_torch.models.detectors import CRC32
    from polar_codes_torch.models.encoder import PolarEncoder
    from polar_codes_torch.models.scan import FastSScanDecoder, ScanDecoder
    from polar_codes_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    _build.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    det = CRC32()
    frozen = frozen_bits(N_LEN, K_LEN, 0.0, "BB")
    enc = PolarEncoder(N_LEN, frozen, detector=det, device=dev)
    chan = Awgn()
    chan.set_esn0_linear(10.0 ** (EBN0_DB / 10.0) * K_LEN / N_LEN)
    info = torch.randint(0, 2, (BATCH, K_LEN), generator=gen, device=dev, dtype=torch.uint8)
    llr = Bpsk().demodulate(chan.transmit(Bpsk().modulate(enc.encode(info)), gen)) * AMPL
    quant = torch.clamp(torch.round(llr), -127, 127).to(torch.int8)

    ad = AdaptiveDecoder(N_LEN, frozen, list_size=LIST, detector=det,
                         fast_dtype=torch.int8, device=dev)
    failed = torch.nonzero(~ad.fast.decode(quant)[2]).flatten()
    sub = quant.index_select(0, failed).to(torch.float32)
    scan = ScanDecoder(N_LEN, frozen, detector=det, iterations=4, device=dev)
    fss = FastSScanDecoder(N_LEN, frozen, detector=det, iterations=4, device=dev)
    print(json.dumps({"rerun_rows": int(failed.numel()), "batch": BATCH}))
    for name, fn in (("adaptive", lambda: ad.decode(quant)),
                     ("fast_int8", lambda: ad.fast.decode(quant)),
                     ("rerun_scl8", lambda: ad.list.decode(sub)),
                     ("scan4", lambda: scan.decode(llr)),
                     ("fastsscan4", lambda: fss.decode(llr))):
        profile(name, fn, CALLS, card, torch)


if __name__ == "__main__":
    main()
    sys.exit(0)
