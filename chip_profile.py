#!/usr/bin/env python3
"""Where the device time goes on the port's slice-2, slice-3 and slice-4
paths, on one CUDA card.

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
  scl8_int8   pcsim -p 8: SCLDecoder(L = 8, dtype=int8).decode on the int8
              LLRs (K1 char)
  scl8_bf16   SCLDecoder(L = 8, CRC16, dtype=bfloat16).decode on the float
              LLRs (K1 float32 on the widening call, K1 bf16)

and the large-N paths, Bhattacharyya at 0 dB, B = 128, 2 dB:
  large_sc         (131072, 65536) LargeSCDecoder(chunk=2048).decode (K6)
  large_scl        (32768, 16384) CRC16 LargeSCLDecoder(L = 8, chunk 256,
                   sub-block 16, bf16 carry).decode (K7, K1)
  large_sc_int8    the first with dtype=int8 on LLRs x10 quantised to int8
                   (K6 char on every chunk)
  large_scl_int8   the second likewise (K7 char on every chunk, no
                   sub-blocks)
  large_scl_tree   the second with schedule="tree" (part `tree`): K7 on the
                   mixed chunk-span subtrees, K1 on the pure leaves at their
                   maximal span, f/g glue above
and (part `depthfirst`) DepthFirstDecoder (SC-Flip, 8 trials, CRC16) at
(1024, 512), B = 1024, 2 dB: a decode, and one SC pass alone (kernels
per pass).
For the SCL and large-N paths it also prints a per-layer split, each layer
timed alone with CUDA events (median of CALLS) on the inputs it saw in one
decode: the kernels (SCL: every K1 call; large-N: every mixed-chunk call),
the pure-chunk rules (every pure chunk), the final join (large SCL: chunk
gathers and top butterfly stages; large SC: the codeword transform), the
tail (SCL: CRC-aided selection after decode_packed; SC: info extraction),
and the glue above the kernels as the rest of the decode, with the kernel
launches per decode. Then K1's cycles per codeword by op kind and leaf
phase, from a build of its source with clock64 probes (-DK1_PROFILE).
Last, `scan_ops`: K4 (4 sweeps) and K5 (one sweep) timed at B = 181 and
2048 on the scan4 path's inputs (K4 in both node-memory placements, both
at 1 and 2 codewords a warp), then their cycles per chain by op kind,
from a build of csrc/scan_sweep.cu with clock64 probes (-DSCAN_PROFILE).
Last, `k3_ops`: K3 (both families, the adaptive fast pass's root call)
at B = 181 and 2048 and K2 at B = 1024, each a call alone, within a
burst and its device time under the profiler; then K3's cycles per op
kind from a build of csrc/fastssc_subtree.cu with clock64 probes
(-DK3_PROFILE), where the source has them.
Last, `lists`: the (1024, 512) CRC16 CA-SCL decode at L in LISTS (float32,
2 dB; B = 2048 up to L = 32, 1024 above), each profiled, with its K1 calls
timed alone (CUDA events) per decode; then K3's root call of the (1024,
512) code at B = 2048 in each family, alone and within a burst; a list
size or family the tree refuses is printed as refused, so a copy of this
script times an older tree too.
Last, `k1_ab SRC.cu ...`: K1 built from each named source file (the same
C interface: an older tree's `csrc/scl_subtree.cu`, or a variant) and
timed in one process on the same calls, in rounds that alternate the
order: the two calls of a float32 CA-SCL-8 decode at B = 2048 and 181 and
the eight of a CA-SCL-32 decode at B = 2048, each call within a burst of
BURST; with each build's registers and spills for L = 8 and 32.

Last, `large_lists`: (32768, 16384) CRC16 CA-SCL-64 (chunk 256,
sub-block 16, B = 128, 2 dB) on both schedules, each profiled and split
into K7 calls, K1 calls, glue and tail (CUDA events, per decode).
Last, `k7_ab SRC.cu ...`: K7 built from each named source (this tree's
csrc/large_scl_chunk.cu, or an older tree's) and timed in one process on
the K7 calls of a (32768, 16384) CA-SCL-8 decode at B = 128, float32 (with
sub-blocks) and int8, a decode's calls within a burst, in rounds of
alternating order.

    python3 chip_profile.py [paths] [scl] [large] [k1_ops] [scan_ops] [k3_ops] [tree]
                            [depthfirst] [lists] [large_lists] [k1_ab SRC.cu ...]
                            [k7_ab SRC.cu ...]

runs the named parts (all without arguments).

Exits non-zero without a CUDA device, or if a window shows no device time.
"""

import json
import subprocess
import sys
import time

N_LEN, K_LEN, LIST, EBN0_DB, BATCH, AMPL = 1024, 512, 8, 2.0, 2048, 10.0
CALLS = 10
TOP = 6
B_LARGE = 128
LARGE_SC = (131072, 65536, 2048)  # N, K, chunk
LARGE_SCL = (32768, 16384, 256)


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


def profile(name, fn, calls, card, torch, batch=None):
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
        "path": name, "batch": batch or BATCH, "wall_ms_per_call": wall_ms,
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
    sources = [a for a in sys.argv[1:] if a.endswith(".cu")]
    parts = {a for a in sys.argv[1:] if not a.endswith(".cu")} or {
        "paths", "scl", "large", "k1_ops", "scan_ops", "k3_ops", "tree", "depthfirst", "lists",
        "large_lists"}
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
    if "paths" in parts:
        for name, fn in (("adaptive", lambda: ad.decode(quant)),
                         ("fast_int8", lambda: ad.fast.decode(quant)),
                         ("rerun_scl8", lambda: ad.list.decode(sub)),
                         ("scan4", lambda: scan.decode(llr)),
                         ("fastsscan4", lambda: fss.decode(llr))):
            profile(name, fn, CALLS, card, torch)
    if "scl" in parts:
        scl_paths(card, torch, dev, gen, frozen, quant, llr / AMPL)
    if "large" in parts:
        large_paths(card, torch, dev, gen)
    if "k1_ops" in parts:
        k1_ops(card, torch, dev, frozen, llr / AMPL)
    if "scan_ops" in parts:
        scan_ops(card, torch, scan, llr)
    if "k3_ops" in parts:
        k3_ops(card, torch, dev, gen, ad, enc, llr, quant)
    if "tree" in parts:
        tree_path(card, torch, dev, gen)
    if "depthfirst" in parts:
        depthfirst_path(card, torch, dev, gen, frozen)
    if "lists" in parts:
        list_sizes(card, torch, dev, frozen, llr / AMPL)
    if "k1_ab" in parts:
        k1_ab(card, torch, dev, frozen, llr / AMPL, sources)
    if "large_lists" in parts:
        large_lists(card, torch, dev, gen)
    if "k7_ab" in parts:
        k7_ab(card, torch, dev, gen, sources)


def kernel_launches():
    """Launches of every kernel family since the last reset, then reset."""
    from polar_codes_torch.ops import large_kernel as lk
    from polar_codes_torch.ops import scl_kernel_bl

    counts = {**{f"scl_subtree[{k}]": v for k, v in scl_kernel_bl.LAUNCHES.items()},
              **{f"chunk[{k}]": v for k, v in lk.LAUNCHES.items()}}
    for table in (scl_kernel_bl.LAUNCHES, lk.LAUNCHES):
        table.update(dict.fromkeys(table, 0))
    return {k: v for k, v in counts.items() if v}


def scl_paths(card, torch, dev, gen, frozen, quant, llr):
    """The pcsim -p 8 decode (int8, CRC32) and the bf16 decode (CRC16) of
    (1024, 512) CA-SCL-8, each profiled and split into K1 calls, glue and
    tail."""
    from polar_codes_torch.models.detectors import CRC16, CRC32
    from polar_codes_torch.models.scl import SCLDecoder
    from polar_codes_torch.ops import scl_kernel_bl
    from polar_codes_torch.utils.timing import time_cuda

    for name, det, dtype, x in (("scl8_int8", CRC32(), torch.int8, quant),
                                ("scl8_bf16", CRC16(), torch.bfloat16, llr)):
        dec = SCLDecoder(N_LEN, frozen, list_size=LIST, detector=det, dtype=dtype, device=dev)
        profile(name, lambda: dec.decode(x), CALLS, card, torch)
        calls = []
        dec.subtree_fn = lambda *a: calls.append(a) or scl_kernel_bl.scl_subtree(*a)
        kernel_launches()
        dec.decode(x)
        launches = kernel_launches()
        dec.subtree_fn = scl_kernel_bl.scl_subtree
        total_ms = time_cuda(lambda: dec.decode(x), reps=CALLS)
        packed_ms = time_cuda(lambda: dec.decode_packed(x), reps=CALLS)
        k1 = [time_cuda(lambda c=c: scl_kernel_bl.scl_subtree(*c), reps=CALLS) for c in calls]
        print(json.dumps({"path": name, "batch": BATCH, "decode_ms": total_ms,
                          "kernels_ms": sum(k1), "k1_calls_ms": k1,
                          "k1_dtypes": [str(c[1].dtype) for c in calls],
                          "glue_ms": packed_ms - sum(k1), "tail_ms": total_ms - packed_ms,
                          "launches_per_decode": launches, "card": card}), flush=True)


LISTS = (8, 3, 12, 32, 64)


def list_sizes(card, torch, dev, frozen, llr):
    """The float32 CRC16 CA-SCL decode at each L in LISTS: profiled (host
    wall, device busy per decode), then its K1 calls timed alone."""
    from polar_codes_torch.models.detectors import CRC16
    from polar_codes_torch.models.scl import SCLDecoder
    from polar_codes_torch.models.tree import build_tree
    from polar_codes_torch.ops import fastssc_kernel as fk
    from polar_codes_torch.ops import scl_kernel_bl
    from polar_codes_torch.utils.timing import time_cuda

    for n_list in LISTS:
        x = llr if n_list <= 32 else llr[: BATCH // 2]
        try:
            dec = SCLDecoder(N_LEN, frozen, list_size=n_list, detector=CRC16(), device=dev)
            dec.decode(x)
        except NotImplementedError as err:
            print(json.dumps({"path": f"scl{n_list}", "refused": str(err), "card": card}))
            continue
        profile(f"scl{n_list}", lambda: dec.decode(x), CALLS, card, torch, batch=x.shape[0])
        calls = []
        dec.subtree_fn = lambda *a: calls.append(a) or scl_kernel_bl.scl_subtree(*a)
        dec.decode_packed(x)
        dec.subtree_fn = scl_kernel_bl.scl_subtree
        k1 = [time_cuda(lambda c=c: scl_kernel_bl.scl_subtree(*c), reps=CALLS) for c in calls]
        print(json.dumps({"path": f"scl{n_list}", "batch": x.shape[0],
                          "decode_ms": time_cuda(lambda: dec.decode(x), reps=CALLS),
                          "k1_ms_per_decode": sum(k1), "k1_calls_ms": k1,
                          "spans": [c[0].span for c in calls], "card": card}), flush=True)
    root = fk.build_schedule(build_tree(N_LEN, frozen))
    for dtype in (torch.float32, torch.int8, torch.bfloat16):
        x = (llr * AMPL).clamp(-127, 127).round().T.contiguous().to(dtype)
        fn = lambda: fk.fastssc_subtree(root, x, True)  # noqa: E731
        try:
            fn()
        except ValueError as err:
            print(json.dumps({"kernel": f"fastssc_subtree[{dtype}]", "refused": str(err)}))
            continue
        print(json.dumps({"kernel": f"fastssc_subtree[{dtype}]", "batch": BATCH,
                          "ms": time_cuda(fn, reps=CALLS),
                          "burst_ms": time_cuda(lambda: [fn() for _ in range(BURST)],
                                                reps=CALLS) / BURST, "card": card}), flush=True)


def k1_ab(card, torch, dev, frozen, llr, sources, rounds=4):
    """K1 from each source in `sources`, timed on the same calls in rounds
    of alternating order; every build's outputs equal the first's."""
    import ctypes
    import hashlib
    import re
    from pathlib import Path

    from polar_codes_torch.models.detectors import CRC16
    from polar_codes_torch.models.scl import SCLDecoder
    from polar_codes_torch.ops import _build, scl_kernel_bl
    from polar_codes_torch.utils.timing import time_cuda

    nvcc = _build.nvcc_path()
    flags = (*_build.NVCC_FLAGS, "-Xptxas", "-v")
    builds = []
    for src in sources:
        path = Path(src).resolve()
        key = hashlib.sha256(path.read_bytes() + repr((flags, nvcc)).encode()).hexdigest()[:16]
        out = _build.BUILD / f"libscl_subtree_ab-{key}.so"
        proc = subprocess.Popen([nvcc, *flags, "-o", str(out), str(path)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        builds.append((src, out, proc))
    libs = []
    for src, out, proc in builds:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {src}:\n{log}")
        report = {}
        for entry in log.split("Compiling entry function")[1:]:
            kind = re.search(r"scl_subtree_kernelILi(\d+)ENS_\d+(\w+?)FamilyE", entry)
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", entry)
            if kind and kind.group(1) in ("8", "32") and regs and spill:
                report[f"L{kind.group(1)} {kind.group(2)}"] = (int(regs.group(1)),
                                                            int(spill.group(1)),
                                                            int(spill.group(2)))
        print(json.dumps({"k1_ab_source": src, "ptxas": report}), flush=True)
        libs.append(ctypes.CDLL(str(out)))

    def calls_of(n_list, n_batch):
        calls = []
        dec = SCLDecoder(N_LEN, frozen, list_size=n_list, detector=CRC16(), device=dev,
                         subtree_fn=lambda *a: calls.append(a) or scl_kernel_bl.scl_subtree(*a))
        dec.decode_packed(llr[:n_batch])
        return calls

    sets = {"L8_b2048": calls_of(8, BATCH), "L8_b181": calls_of(8, 181),
            "L32_b2048": calls_of(32, BATCH)}
    for name, calls in sets.items():
        want = [scl_kernel_bl.launch(libs[0], *c) for c in calls]
        for lib, (src, _, _) in zip(libs[1:], builds[1:]):
            for c, w in zip(calls, want):
                got = scl_kernel_bl.launch(lib, *c)
                if not all(torch.equal(a, b) for a, b in zip(got, w)):
                    raise SystemExit(f"k1_ab: {src} differs from {sources[0]} on {name}")
    times = {src: {name: [] for name in sets} for src in sources}
    for rnd in range(rounds):
        order = list(zip(sources, libs))
        for src, lib in (order if rnd % 2 == 0 else order[::-1]):
            for name, calls in sets.items():
                ms = time_cuda(lambda: [scl_kernel_bl.launch(lib, *c)
                                        for _ in range(BURST) for c in calls], reps=CALLS)
                times[src][name].append(ms / BURST)
    for src in sources:
        print(json.dumps({"k1_ab": src, "ms_per_decode_in_burst": times[src],
                          "card": card}), flush=True)


def k7_ab(card, torch, dev, gen, sources, rounds=4):
    """K7 from each source in `sources` (csrc/large_scl_chunk.cu of this
    tree or an older one: the same C interface), timed in one process on
    the K7 calls of a (32768, 16384) CA-SCL-8 decode at B = 128 (float32
    with sub-blocks of 16 and the bf16 carry, phase 17's path; and int8,
    phase 23's), a decode's calls within a burst of BURST, in rounds of
    alternating order; every build's outputs equal the first's."""
    import ctypes
    import hashlib
    from pathlib import Path

    from polar_codes_torch.construction import frozen_bits
    from polar_codes_torch.dsp import Awgn, Bpsk
    from polar_codes_torch.models.detectors import CRC16
    from polar_codes_torch.models.encoder import PolarEncoder
    from polar_codes_torch.models.large import LargeSCLDecoder
    from polar_codes_torch.ops import _build
    from polar_codes_torch.ops import large_kernel as lk
    from polar_codes_torch.utils.timing import time_cuda

    nvcc = _build.nvcc_path()
    builds = []
    for src in sources:
        path = Path(src).resolve()
        key = hashlib.sha256(path.read_bytes() + repr((_build.NVCC_FLAGS, nvcc)).encode())
        out = _build.BUILD / f"liblarge_scl_chunk_ab-{key.hexdigest()[:16]}.so"
        proc = subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", str(out), str(path)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        builds.append((src, out, proc))
    libs = []
    for src, out, proc in builds:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {src}:\n{log}")
        libs.append(ctypes.CDLL(str(out)))
    n_len, k_len, chunk = LARGE_SCL
    frozen = frozen_bits(n_len, k_len, 0.0, "BB")
    det = CRC16()
    enc = PolarEncoder(n_len, frozen, detector=det, device=dev)
    chan = Awgn()
    chan.set_esn0_linear(10.0 ** (EBN0_DB / 10.0) * k_len / n_len)
    info = torch.randint(0, 2, (B_LARGE, k_len), generator=gen, device=dev, dtype=torch.uint8)
    llr = Bpsk().demodulate(chan.transmit(Bpsk().modulate(enc.encode(info)), gen))
    sets = {}
    for name, dtype, x in (("float32", torch.float32, llr), ("char", torch.int8, torch.clamp(
            torch.round(llr * AMPL), -127, 127).to(torch.int8))):
        calls = []
        LargeSCLDecoder(n_len, frozen, list_size=8, detector=det, dtype=dtype, chunk=chunk,
                        subblock=16, carry_dtype=torch.bfloat16, device=dev,
                        chunk_fn=lambda *a, _c=calls, **kw: _c.append((a, kw)) or
                        lk.masked_scl_chunk(*a, **kw)).decode_packed(x)
        sets[name] = calls
    for name, calls in sets.items():
        want = [lk.launch_scl(libs[0], *a, **kw) for a, kw in calls]
        for lib, (src, _, _) in zip(libs[1:], builds[1:]):
            for (a, kw), w in zip(calls, want):
                if not all(torch.equal(g, v) for g, v in zip(lk.launch_scl(lib, *a, **kw), w)):
                    raise SystemExit(f"k7_ab: {src} differs from {sources[0]} on {name}")
    times = {src: {name: [] for name in sets} for src in sources}
    for rnd in range(rounds):
        order = list(zip(sources, libs))
        for src, lib in (order if rnd % 2 == 0 else order[::-1]):
            for name, calls in sets.items():
                ms = time_cuda(lambda: [lk.launch_scl(lib, *a, **kw)
                                        for _ in range(BURST) for a, kw in calls], reps=CALLS)
                times[src][name].append(ms / BURST / len(calls))
    for src in sources:
        print(json.dumps({"k7_ab": src, "ms_per_call_in_burst": times[src],
                          "calls": {name: len(c) for name, c in sets.items()},
                          "card": card}), flush=True)


def large_paths(card, torch, dev, gen):
    """Profile the large-N decodes, float32 and int8, and split each into
    its layers."""
    from polar_codes_torch.construction import frozen_bits
    from polar_codes_torch.dsp import Awgn, Bpsk
    from polar_codes_torch.models.detectors import CRC16
    from polar_codes_torch.models.encoder import PolarEncoder
    from polar_codes_torch.models.large import LargeSCDecoder, LargeSCLDecoder
    from polar_codes_torch.ops import large_kernel as lk
    from polar_codes_torch.ops import scl_kernel_bl
    from polar_codes_torch.ops.butterfly import butterfly_transform
    from polar_codes_torch.utils.timing import time_cuda

    def channel(enc, dtype):
        chan = Awgn()
        chan.set_esn0_linear(10.0 ** (EBN0_DB / 10.0) * enc.info_length / enc.block_length)
        info = torch.randint(0, 2, (B_LARGE, enc.info_length), generator=gen, device=dev,
                             dtype=torch.uint8)
        llr = Bpsk().demodulate(chan.transmit(Bpsk().modulate(enc.encode(info)), gen))
        if dtype == torch.int8:  # the simulator's quantiser
            return torch.clamp(torch.round(llr * AMPL), -127, 127).to(torch.int8)
        return llr

    def timed(fn):
        return time_cuda(fn, reps=CALLS)

    def layers(name, total_ms, parts, launches):
        print(json.dumps({"path": name, "batch": B_LARGE, "decode_ms": total_ms,
                          **{k + "_ms": v for k, v in parts.items()},
                          "outer_glue_ms": total_ms - sum(parts.values()),
                          "launches_per_decode": launches, "card": card}),
              flush=True)

    for dtype, suffix in ((torch.float32, ""), (torch.int8, "_int8")):
        n_len, k_len, chunk = LARGE_SC
        frozen = frozen_bits(n_len, k_len, 0.0, "BB")
        sc = LargeSCDecoder(n_len, frozen, dtype=dtype, chunk=chunk, device=dev)
        llr = channel(PolarEncoder(n_len, frozen, device=dev), dtype)
        profile("large_sc" + suffix, lambda: sc.decode(llr), CALLS, card, torch, B_LARGE)
        mixed, pure = [], []

        def record_chunk(t, x, _sc=sc, _orig=sc._chunk):
            (mixed if _sc.classes[t] == 0 else pure).append((t, x))
            return _orig(t, x)

        sc._chunk = record_chunk
        kernel_launches()
        u = sc._decode_u(sc._check_input(llr))
        launches = kernel_launches()
        del sc._chunk
        u01 = torch.signbit(u).to(torch.uint8)
        codeword = butterfly_transform(u01)
        layers("large_sc" + suffix, timed(lambda: sc.decode(llr)), {
            "chunk_kernels": sum(timed(lambda c=c: sc._chunk(*c)) for c in mixed),
            "pure_chunk_rules": sum(timed(lambda c=c: sc._chunk(*c)) for c in pure),
            "final_join": timed(lambda: butterfly_transform(u01)),
            "tail": timed(lambda: codeword.index_select(-1, sc._info_pos_t)),
        }, launches)

        n_len, k_len, chunk = LARGE_SCL
        frozen = frozen_bits(n_len, k_len, 0.0, "BB")
        det = CRC16()
        scl = LargeSCLDecoder(n_len, frozen, list_size=8, detector=det, dtype=dtype,
                              chunk=chunk, subblock=16, carry_dtype=torch.bfloat16,
                              device=dev)
        llr = channel(PolarEncoder(n_len, frozen, detector=det, device=dev), dtype)
        profile("large_scl" + suffix, lambda: scl.decode(llr), CALLS, card, torch, B_LARGE)
        k7_calls, k1_calls, joins = [], [], []
        scl.chunk_fn = lambda *a, **kw: (k7_calls.append((a, kw))
                                         or lk.masked_scl_chunk(*a, **kw))
        scl.subtree_fn = lambda *a: k1_calls.append(a) or scl_kernel_bl.scl_subtree(*a)
        scl._join_chunks = lambda *a, _s=scl: (joins.append(a)
                                               or LargeSCLDecoder._join_chunks(_s, *a))
        kernel_launches()
        scl.decode(llr)
        launches = kernel_launches()
        scl.chunk_fn, scl.subtree_fn = lk.masked_scl_chunk, scl_kernel_bl.scl_subtree
        del scl._join_chunks
        packed_ms = timed(lambda: scl.decode_packed(llr))
        total_ms = timed(lambda: scl.decode(llr))
        layers("large_scl" + suffix, total_ms, {
            "chunk_kernels": sum(timed(lambda c=c: lk.masked_scl_chunk(*c[0], **c[1]))
                                 for c in k7_calls),
            "pure_chunk_rules": sum(timed(lambda c=c: scl_kernel_bl.scl_subtree(*c))
                                    for c in k1_calls),
            "final_join": timed(lambda: scl._join_chunks(*joins[0])),
            "tail": total_ms - packed_ms,
        }, launches)


def tree_path(card, torch, dev, gen):
    """The large-N tree schedule: (32768, 16384) CRC16 LargeSCLDecoder(L = 8,
    chunk 256, sub-block 16, schedule="tree") at B = 128, profiled, then
    split into K7 calls, K1 calls, the tail (CRC-aided selection) and the
    glue (the rest of decode_packed: f, g, the perm gathers and joins)."""
    from polar_codes_torch.construction import frozen_bits
    from polar_codes_torch.dsp import Awgn, Bpsk
    from polar_codes_torch.models.detectors import CRC16
    from polar_codes_torch.models.encoder import PolarEncoder
    from polar_codes_torch.models.large import LargeSCLDecoder
    from polar_codes_torch.ops import large_kernel as lk
    from polar_codes_torch.ops import scl_kernel_bl
    from polar_codes_torch.utils.timing import time_cuda

    n_len, k_len, chunk = LARGE_SCL
    frozen = frozen_bits(n_len, k_len, 0.0, "BB")
    det = CRC16()
    enc = PolarEncoder(n_len, frozen, detector=det, device=dev)
    chan = Awgn()
    chan.set_esn0_linear(10.0 ** (EBN0_DB / 10.0) * k_len / n_len)
    info = torch.randint(0, 2, (B_LARGE, k_len), generator=gen, device=dev, dtype=torch.uint8)
    llr = Bpsk().demodulate(chan.transmit(Bpsk().modulate(enc.encode(info)), gen))
    tree = LargeSCLDecoder(n_len, frozen, list_size=8, detector=det, chunk=chunk, subblock=16,
                           schedule="tree", device=dev)
    profile("large_scl_tree", lambda: tree.decode(llr), CALLS, card, torch, B_LARGE)
    k7_calls, k1_calls = [], []
    tree.chunk_fn = lambda *a, **kw: k7_calls.append((a, kw)) or lk.masked_scl_chunk(*a, **kw)
    tree.subtree_fn = lambda *a: k1_calls.append(a) or scl_kernel_bl.scl_subtree(*a)
    kernel_launches()
    tree.decode(llr)
    launches = kernel_launches()
    tree.chunk_fn, tree.subtree_fn = lk.masked_scl_chunk, scl_kernel_bl.scl_subtree
    total_ms = time_cuda(lambda: tree.decode(llr), reps=CALLS)
    packed_ms = time_cuda(lambda: tree.decode_packed(llr), reps=CALLS)
    k7 = sum(time_cuda(lambda c=c: lk.masked_scl_chunk(*c[0], **c[1]), reps=CALLS)
             for c in k7_calls)
    k1 = [time_cuda(lambda c=c: scl_kernel_bl.scl_subtree(*c), reps=CALLS) for c in k1_calls]
    by_span = {}
    for ms, c in zip(k1, k1_calls):
        by_span[c[0].span] = by_span.get(c[0].span, 0.0) + ms
    # the longest leaf at L = 32, whose input K1 reads from device memory
    longest = max((c[0].node for c in k1_calls), key=lambda n: n.length)
    sched = scl_kernel_bl.build_schedule(longest, 32, 32)
    x = torch.randn((32, longest.length, B_LARGE), generator=gen, device=dev)
    m = torch.randn((B_LARGE, 32), generator=gen, device=dev)
    l32_ms = time_cuda(lambda: scl_kernel_bl.scl_subtree(sched, x, m), reps=CALLS)
    print(json.dumps({"path": "large_scl_tree", "batch": B_LARGE, "decode_ms": total_ms,
                      "chunk_kernels_ms": k7, "leaf_kernels_ms": sum(k1),
                      "leaf_ms_by_span": by_span,
                      f"k1_l32_{longest.kind.value}_span{longest.length}_ms": l32_ms,
                      "glue_ms": packed_ms - k7 - sum(k1), "tail_ms": total_ms - packed_ms,
                      "launches_per_decode": launches, "card": card}), flush=True)


def large_lists(card, torch, dev, gen, n_list=64):
    """CA-SCL-64 at (32768, 16384) CRC16, chunk 256, sub-block 16, B = 128,
    2 dB, on both schedules: each decode profiled (device ms, busy share),
    then split into K7 calls, K1 calls (pure chunks or the tree's pure
    leaves), the tail (CRC-aided selection over W words) and the glue (the
    rest of decode_packed), each layer timed alone with CUDA events on the
    inputs it saw in one decode."""
    from polar_codes_torch.construction import frozen_bits
    from polar_codes_torch.dsp import Awgn, Bpsk
    from polar_codes_torch.models.detectors import CRC16
    from polar_codes_torch.models.encoder import PolarEncoder
    from polar_codes_torch.models.large import LargeSCLDecoder
    from polar_codes_torch.ops import large_kernel as lk
    from polar_codes_torch.ops import scl_kernel_bl
    from polar_codes_torch.utils.timing import time_cuda

    n_len, k_len, chunk = LARGE_SCL
    frozen = frozen_bits(n_len, k_len, 0.0, "BB")
    det = CRC16()
    enc = PolarEncoder(n_len, frozen, detector=det, device=dev)
    chan = Awgn()
    chan.set_esn0_linear(10.0 ** (EBN0_DB / 10.0) * k_len / n_len)
    info = torch.randint(0, 2, (B_LARGE, k_len), generator=gen, device=dev, dtype=torch.uint8)
    llr = Bpsk().demodulate(chan.transmit(Bpsk().modulate(enc.encode(info)), gen))
    for schedule in ("scan", "tree"):
        dec = LargeSCLDecoder(n_len, frozen, list_size=n_list, detector=det, chunk=chunk,
                              subblock=16, schedule=schedule, device=dev)
        name = f"large_scl{n_list}_{schedule}"
        profile(name, lambda: dec.decode(llr), 3, card, torch, B_LARGE)
        k7_calls, k1_calls = [], []
        dec.chunk_fn = lambda *a, **kw: k7_calls.append((a, kw)) or lk.masked_scl_chunk(*a, **kw)
        dec.subtree_fn = lambda *a: k1_calls.append(a) or scl_kernel_bl.scl_subtree(*a)
        kernel_launches()
        dec.decode(llr)
        launches = kernel_launches()
        dec.chunk_fn, dec.subtree_fn = lk.masked_scl_chunk, scl_kernel_bl.scl_subtree
        total_ms = time_cuda(lambda: dec.decode(llr), warmup=1, reps=3)
        packed_ms = time_cuda(lambda: dec.decode_packed(llr), warmup=1, reps=3)
        k7 = sum(time_cuda(lambda c=c: lk.masked_scl_chunk(*c[0], **c[1]), reps=3)
                 for c in k7_calls)
        k1 = sum(time_cuda(lambda c=c: scl_kernel_bl.scl_subtree(*c), reps=3) for c in k1_calls)
        print(json.dumps({"path": name, "batch": B_LARGE, "list_size": n_list,
                          "decode_ms": total_ms, "chunk_kernels_ms": k7, "leaf_kernels_ms": k1,
                          "glue_ms": packed_ms - k7 - k1, "tail_ms": total_ms - packed_ms,
                          "k7_calls": len(k7_calls), "k1_calls": len(k1_calls),
                          "launches_per_decode": launches, "card": card}), flush=True)


def depthfirst_path(card, torch, dev, gen, frozen):
    """DepthFirstDecoder (SC-Flip, 8 trials, CRC16) at (1024, 512), B = 1024,
    2 dB: a decode and one SC pass alone under the profiler, and the
    rows whose first pass failed."""
    from polar_codes_torch.dsp import Awgn, Bpsk
    from polar_codes_torch.models.depthfirst import DepthFirstDecoder
    from polar_codes_torch.models.detectors import CRC16
    from polar_codes_torch.models.encoder import PolarEncoder

    det = CRC16()
    enc = PolarEncoder(N_LEN, frozen, detector=det, device=dev)
    chan = Awgn()
    chan.set_esn0_linear(10.0 ** (EBN0_DB / 10.0) * K_LEN / N_LEN)
    info = torch.randint(0, 2, (1024, K_LEN), generator=gen, device=dev, dtype=torch.uint8)
    llr = Bpsk().demodulate(chan.transmit(Bpsk().modulate(enc.encode(info)), gen))
    df = DepthFirstDecoder(N_LEN, frozen, detector=det, trial_limit=8, device=dev)
    ones = torch.ones((1024, df.info_length), device=dev)
    profile("depthfirst_pass", lambda: df._pass(llr, ones), 2, card, torch, 1024)
    profile("depthfirst_decode", lambda: df.decode(llr), 2, card, torch, 1024)
    first_ok = det.check(df._extract(df._pass(llr, ones)[0]))

    def nodes(n):
        return 1 if n.left is None else 1 + nodes(n.left) + nodes(n.right)

    print(json.dumps({"path": "depthfirst", "batch": 1024, "trials": 8,
                      "first_pass_failures": int((~first_ok).sum()),
                      "tree_nodes": nodes(df.tree), "info_leaves": df.info_length,
                      "card": card}), flush=True)


K1_SLOTS = {0: "F", 1: "G", 2: "combine", 3: "leaf rate0", 4: "leaf rate1", 5: "leaf rep",
            6: "leaf spc", 7: "leaf enum", 8: "leaf: weakest", 9: "leaf: candidates",
            10: "leaf: prune", 11: "leaf: decision bits", 12: "schedule", 13: "F at level 0",
            14: "G at level 0"}


def profile_build(name, macro):
    """csrc/<name>.cu built with -D<macro> (its clock64 probes) into
    build/lib<name>_profile-<hash>.so, loaded."""
    import ctypes
    import hashlib

    from polar_codes_torch.ops import _build

    nvcc = _build.nvcc_path()
    src = _build.CSRC / f"{name}.cu"
    flags = (*_build.NVCC_FLAGS, f"-D{macro}")
    key = hashlib.sha256(src.read_bytes() + repr((flags, nvcc)).encode()).hexdigest()[:16]
    out = _build.BUILD / f"lib{name}_profile-{key}.so"
    if not out.exists():
        _build.BUILD.mkdir(parents=True, exist_ok=True)
        run = subprocess.run([nvcc, *flags, "-o", str(out), str(src)], capture_output=True,
                             text=True)
        if run.returncode:
            raise SystemExit(f"nvcc -D{macro} failed:\n{run.stdout}{run.stderr}")
    return ctypes.CDLL(str(out))


def k1_ops(card, torch, dev, frozen, llr):
    """Where a K1 call's time goes, per codeword: K1 built with -DK1_PROFILE
    (clock64 probes, summed by lane 0 of every warp; csrc/scl_subtree.cu)
    on the two calls of one float32 CA-SCL-8 decode at B = 181 and 2048,
    and on the large-N pure chunks' one-leaf span-256 schedules at B = 128.
    Prints cycles and ops per codeword by op kind and leaf phase ("F" and
    "G" include their level-0 calls, the leaf kinds include their
    phases, "schedule" is the whole call after the launch)."""
    import ctypes

    from polar_codes_torch.models.detectors import CRC16
    from polar_codes_torch.models.scl import SCLDecoder
    from polar_codes_torch.models.tree import NodeKind
    from polar_codes_torch.ops import scl_kernel_bl
    from polar_codes_torch.ops.large_kernel import _sub_leaf

    lib = profile_build("scl_subtree", "K1_PROFILE")
    lib.scl_subtree_profile.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 64)()

    calls = []
    dec = SCLDecoder(N_LEN, frozen, list_size=LIST, detector=CRC16(), device=dev,
                     subtree_fn=lambda *a: calls.append(a) or scl_kernel_bl.scl_subtree(*a))
    dec.decode_packed(llr)
    runs = [(f"N={N_LEN} CA-SCL-8 call {i}, w {s.w_in}->{s.w_out}", s, x[..., :b].contiguous(),
             m[:b].contiguous()) for b in (181, BATCH) for i, (s, x, m) in enumerate(calls)]
    gen = torch.Generator(device=dev).manual_seed(11)
    for kind in (NodeKind.RATE0, NodeKind.RATE1, NodeKind.REP, NodeKind.SPC):
        sched = scl_kernel_bl.build_schedule(_sub_leaf(kind, 256), LIST, LIST)
        x = torch.randn((LIST, 256, B_LARGE), generator=gen, device=dev) * 2.0 + 1.0
        m = torch.randn((B_LARGE, LIST), generator=gen, device=dev) * 10.0
        runs.append((f"one leaf {kind.value} span 256", sched, x, m))
    for name, sched, x, m in runs:
        scl_kernel_bl.launch(lib, sched, x, m)
        torch.cuda.synchronize()
        lib.scl_subtree_profile(buf)
        scl_kernel_bl.launch(lib, sched, x, m)
        torch.cuda.synchronize()
        lib.scl_subtree_profile(buf)
        n_batch = x.shape[-1]
        print(json.dumps({
            "k1_ops": name, "batch": n_batch,
            "cycles_per_codeword": {v: buf[k] / n_batch for k, v in K1_SLOTS.items()
                                    if buf[k + 32]},
            "ops_per_codeword": {v: buf[k + 32] / n_batch for k, v in K1_SLOTS.items()
                                 if buf[k + 32]},
            "card": card}), flush=True)


SCAN_SLOTS = {0: "F", 1: "G", 2: "combine", 3: "long op", 7: "subtree op", 4: "stage-in",
              5: "stage-out", 6: "sweeps"}
SCAN_BATCHES = (181, BATCH)
SWEEPS = 4
BURST = 10


def scan_ops(card, torch, scan, llr):
    """K4 and K5 on the scan4 path's schedule and LLRs (N = 1024, 2 dB):
    CUDA-event medians of a call within BURST back-to-back calls (the
    device's time, where one call alone also shows the host's launch) of
    K4 (4 sweeps) and K5 (one sweep, on the memory of a first sweep) at
    B = 181 and 2048, K4 also with its node memory forced on and off
    chip, and both at 1 and 2 codewords a warp (the layout arguments of
    ops/scan_kernel.py launch_fused and launch_step); then each call once
    through a -DSCAN_PROFILE build (clock64 probes summed by lane 0 of
    each warp, a chain of codewords_per_chain codewords), as cycles and
    ops per chain: F, G and COMBINE of at most 32 items (half-length x
    codewords a warp), "long op" every op of more, "subtree op" the sweep
    of a length-8 subtree, "stage-in" the prologue up to the first op,
    "sweeps" every op of every sweep, "stage-out" the betas' store. The
    probes add ~90 cycles an op."""
    import ctypes

    from polar_codes_torch.ops import _build
    from polar_codes_torch.ops import scan_kernel as sk
    from polar_codes_torch.utils.timing import time_cuda

    def timed(fn):
        return time_cuda(lambda: [fn() for _ in range(BURST)], reps=CALLS) / BURST

    sched = scan.sched
    flat = scan._flat(llr)
    lib = _build.load("scan_sweep")
    inputs = {}
    for n_batch in SCAN_BATCHES:
        x = flat[:, :n_batch].contiguous()
        _, mem = sk.scan_step(sched, x, torch.zeros((sched.mem_rows, n_batch), device=x.device))
        inputs[n_batch] = (x, mem)
    for n_batch, (x, mem) in inputs.items():
        row = {"scan_ops_times": f"N={sched.block_length}", "batch": n_batch,
               "mem_on_chip_default": sk.mem_on_chip(sched),
               "k4_ms": timed(lambda: sk.scan_fused(sched, x, SWEEPS)),
               "k5_ms": timed(lambda: sk.scan_step(sched, x, mem))}
        on_chip = sk.mem_on_chip(sched)
        for chip in (True, False):
            row[f"k4_ms_mem_{'on' if chip else 'off'}_chip"] = timed(
                lambda: sk.launch_fused(lib, sched, x, SWEEPS, chip))
        for per_warp in (1, 2):
            row[f"k4_ms_{per_warp}_a_warp"] = timed(
                lambda: sk.launch_fused(lib, sched, x, SWEEPS, on_chip, per_warp=per_warp))
            row[f"k5_ms_{per_warp}_a_warp"] = timed(
                lambda: sk.launch_step(lib, sched, x, mem, per_warp=per_warp))
        row["card"] = card
        print(json.dumps(row), flush=True)

    lib = profile_build("scan_sweep", "SCAN_PROFILE")
    lib.scan_sweep_profile.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 64)()
    _build._LIBS["scan_sweep"] = lib  # the wrappers launch the probed build
    try:
        for n_batch, (x, mem) in inputs.items():
            for name, fn in (("K4, 4 sweeps", lambda: sk.scan_fused(sched, x, SWEEPS)),
                             ("K5, one sweep", lambda: sk.scan_step(sched, x, mem))):
                fn()
                torch.cuda.synchronize()
                lib.scan_sweep_profile(buf)
                fn()
                torch.cuda.synchronize()
                lib.scan_sweep_profile(buf)
                chains = buf[4 + 32]
                print(json.dumps({
                    "scan_ops": name, "batch": n_batch, "codewords_per_chain": n_batch / chains,
                    "cycles_per_chain": {v: buf[k] / chains for k, v in SCAN_SLOTS.items()
                                         if buf[k + 32]},
                    "ops_per_chain": {v: buf[k + 32] / chains for k, v in SCAN_SLOTS.items()
                                      if buf[k + 32]},
                    "cycles_per_op": {v: buf[k] / buf[k + 32] for k, v in SCAN_SLOTS.items()
                                      if buf[k + 32] and k in (0, 1, 2, 3, 7)},
                    "card": card}), flush=True)
    finally:
        del _build._LIBS["scan_sweep"]


K3_SLOTS = {0: "F", 1: "G", 2: "ZERO_R", 3: "COMBINE", 4: "RATE0", 5: "RATE1", 6: "REP",
            7: "SPC"}
K3_BATCHES = (181, BATCH)
K2_BATCH = 1024


def device_ms(fn, torch, tries=3):
    """Device time of one call of fn: the summed durations of the device
    events in a profiled window of CALLS calls, over CALLS. A window in
    which the profiler recorded no device event (it happens now and then
    after many profiler sessions in one process) is taken again, up to
    `tries` windows."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof, torch)
        if events:
            return sum(e - s for _, s, e in events) / 1e3 / CALLS, len(events) / CALLS
    raise SystemExit(f"k3_ops: the profiler recorded no device time in {tries} windows")


def k3_ops(card, torch, dev, gen, ad, enc, llr, quant):
    """K3's root call of the adaptive fast pass (N = 1024, the path's int8
    LLRs; float32: the LLRs x10 unquantised) at B = 181 and 2048, and K2 on
    the encoder's u-domain rows at B = 1024: milliseconds of a call alone
    (CUDA events around one call, the host's wrapper and launch included),
    within BURST back-to-back calls, and on the device (torch.profiler).
    Then, where csrc/fastssc_subtree.cu has its clock64 probes, one call of
    each K3 shape through a -DK3_PROFILE build: cycles and ops per codeword
    by op kind, each from the op before it, in registers (every node of up
    to 1024 positions; at 64 and more F, G and ZeroR run inside the lane)
    or "shared" (nodes of 2048, not at these shapes); "op loop" the loop's
    own work between register subtrees (fetches, loading a subtree's LLRs
    is in its first op), "chain" the whole schedule, "stage-in" the
    prologue, "stage-out" the barrier and the store. The probes add their
    clock reads and two device-memory atomics to every op."""
    import ctypes

    from polar_codes_torch.ops import _build, butterfly_kernel
    from polar_codes_torch.ops import fastssc_kernel as fk
    from polar_codes_torch.utils.timing import time_cuda

    def burst(fn):
        return time_cuda(lambda: [fn() for _ in range(BURST)], reps=CALLS) / BURST

    sched = ad.fast.schedule(ad.fast.tree)
    inputs = {}
    for n_batch in K3_BATCHES:
        inputs[("float32", n_batch)] = llr[:n_batch].T.contiguous()
        inputs[("int8", n_batch)] = quant[:n_batch].T.contiguous()
    for (family, n_batch), x in inputs.items():
        fn = lambda x=x: fk.fastssc_subtree(sched, x, True)  # noqa: E731
        dev_ms, kernels = device_ms(fn, torch)
        print(json.dumps({"k3_times": f"fastssc_subtree[{family}]", "span": sched.span,
                          "batch": n_batch, "alone_ms": time_cuda(fn, reps=CALLS),
                          "burst_ms": burst(fn), "device_ms": dev_ms,
                          "device_kernels_per_call": kernels, "card": card}), flush=True)
    info = torch.randint(0, 2, (K2_BATCH, enc.info_length), generator=gen, device=dev,
                         dtype=torch.uint8)
    u = enc.inject(enc.detector.generate(info)).contiguous()
    mask = enc._mask_t
    fn = lambda: butterfly_kernel.butterfly_encode(u, mask, True)  # noqa: E731
    dev_ms, kernels = device_ms(fn, torch)
    print(json.dumps({"k3_times": "butterfly_encode", "n": enc.block_length,
                      "batch": K2_BATCH, "alone_ms": time_cuda(fn, reps=CALLS),
                      "burst_ms": burst(fn), "device_ms": dev_ms,
                      "device_kernels_per_call": kernels, "card": card}), flush=True)

    lib = profile_build("fastssc_subtree", "K3_PROFILE")
    if not hasattr(lib, "fastssc_subtree_profile"):
        print(json.dumps({"k3_ops": "this source has no probes"}), flush=True)
        return
    lib.fastssc_subtree_profile.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 64)()
    names = {**K3_SLOTS, **{k + 8: f"shared {v}" for k, v in K3_SLOTS.items()},
             16: "stage-in", 17: "chain", 18: "stage-out", 19: "op loop"}
    for (family, n_batch), x in inputs.items():
        for _ in range(2):  # the second call's counts
            lib.fastssc_subtree_profile(buf)
            fk.launch(lib, sched, x, True)
            torch.cuda.synchronize()
        lib.fastssc_subtree_profile(buf)
        chains = buf[17 + 32]
        print(json.dumps({
            "k3_ops": f"fastssc_subtree[{family}]", "batch": n_batch, "chains": chains,
            "cycles_per_codeword": {v: buf[k] / chains for k, v in names.items()
                                    if buf[k + 32]},
            "ops_per_codeword": {v: buf[k + 32] / chains for k, v in names.items()
                                 if buf[k + 32] and k != 17},
            "cycles_per_op": {v: buf[k] / buf[k + 32] for k, v in names.items()
                              if buf[k + 32] and k < 16},
            "card": card}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
