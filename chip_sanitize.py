#!/usr/bin/env python3
"""Run a few SCL subtree kernel (K1) calls under compute-sanitizer's race
and barrier checkers, on one CUDA card.

    python3 chip_sanitize.py          # racecheck, then synccheck
    python3 chip_sanitize.py calls    # the K1 calls alone

The calls: every subtree call of a (1024, 512) CA-SCL-8 decode in each
family (float32, int8 held as int16, bfloat16) on integer LLRs in [-2, 2],
at B = 5 with 2 codewords a block (a block half empty), each held against
its plain version. Prints one JSON line per tool: its exit code, the
lines of its own report ("Device not supported" where the tool cannot
attach to the card) and the last two lines of the run. Exits non-zero
without a CUDA device, or if a call differs from its plain version.
"""

import json
import os
import shutil
import subprocess
import sys


def calls():
    import torch

    from polar_codes_torch.construction import frozen_bits
    from polar_codes_torch.models.scl import SCLDecoder
    from polar_codes_torch.ops import scl_kernel_bl as kbl

    frozen = frozen_bits(1024, 512, 0.0, "BB")
    gen = torch.Generator(device="cuda").manual_seed(6)
    kbl.PER_BLOCK = 2
    for dtype in (torch.float32, torch.int8, torch.bfloat16):
        recorded = []

        def record(sched, x, m):
            recorded.append((sched, x, m))
            return kbl.scl_subtree(sched, x, m)

        x = torch.randint(-2, 3, (5, 1024), generator=gen, device="cuda").to(dtype)
        SCLDecoder(1024, frozen, list_size=8, dtype=dtype, device="cuda",
                   subtree_fn=record).decode_packed(x)
        for sched, llr, met in recorded:
            got = kbl.scl_subtree(sched, llr, met)
            want = kbl.scl_subtree_plain(sched, llr, met)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"K1 {llr.dtype} differs from its plain version")
    torch.cuda.synchronize()
    print(f"K1: {len(recorded)} calls a family equal to the plain version", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_sanitize.py: no CUDA device; nothing was run")
    if sys.argv[1:] == ["calls"]:
        calls()
        return
    tool = shutil.which("compute-sanitizer") or "/usr/local/cuda/bin/compute-sanitizer"
    if not os.path.exists(tool):
        print(json.dumps({"sanitizer": None, "verdict": "compute-sanitizer not found"}))
        return
    for check in ("racecheck", "synccheck"):
        try:
            run = subprocess.run([tool, "--tool", check, sys.executable, __file__, "calls"],
                                 capture_output=True, text=True, timeout=600)
            lines = (run.stdout + run.stderr).splitlines()
            report = [ln for ln in lines if ln.startswith("=========")] + lines[-2:]
            print(json.dumps({"sanitizer": check, "rc": run.returncode, "report": report}),
                  flush=True)
        except subprocess.TimeoutExpired:
            print(json.dumps({"sanitizer": check, "rc": None, "report": ["timed out"]}),
                  flush=True)


if __name__ == "__main__":
    main()
