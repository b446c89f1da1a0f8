#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and hold its kernels
against their plain versions.

The main path: (1024, 512) systematic CA-SCL-8 with CRC16, Bhattacharyya
construction at a 0 dB design SNR, BPSK over AWGN at Eb/N0 = 2 dB, through
PolarEncoder.encode (kernel K2, csrc/butterfly_encode.cu) and
SCLDecoder.decode (kernel K1, csrc/scl_subtree.cu, under the torch glue and
the packed CRC tail).

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is 0 only if all held):
  1. the card's name and power limit, torch and CUDA versions
  2. build both kernels from csrc/ with nvcc
  3. K2 against its plain version on 4096 CRC'd blocks: bit-equal
  4. K1 against its plain version, call by call, on the subtree calls of
     one 1024-block decode: bits and perms equal, metrics within 1e-4
  5. 16 x 1024 blocks end to end, decoded by the kernels and again by the
     plain versions on the card: equal decisions, BLER in [1e-4, 5e-2],
     every CRC failure a wrong block; 64 blocks also equal to a CPU decode
  6. both kernels launched during the phase-5 kernel run
  7. CUDA-event times (median of >= 10 after warm-up), one JSON line each
  8. {"kernels": [...]}
  9. {"ok": true, "device": {...}}
Without a CUDA device it exits non-zero before printing any result.
"""

import json
import subprocess
import sys
import time

DEVICE = "cuda"
N_LEN, K_LEN, LIST, EBN0_DB = 1024, 512, 8, 2.0
BATCH, BATCHES, K2_BATCH = 1024, 16, 4096
TOL = 1e-4  # metric tolerance: sums taken in another order elsewhere
REPS = 10


def emit(obj):
    print(json.dumps(obj), flush=True)


def phase(name):
    print(f"# {name}", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; nothing was run")
    from polar_codes_torch.construction import frozen_bits
    from polar_codes_torch.dsp import Awgn, Bpsk
    from polar_codes_torch.models.detectors import CRC16
    from polar_codes_torch.models.encoder import PolarEncoder
    from polar_codes_torch.models.scl import SCLDecoder
    from polar_codes_torch.ops import _build, butterfly_kernel, scl_kernel_bl
    from polar_codes_torch.utils.timing import time_cuda

    dev = torch.device(DEVICE)

    # 1 -------------------------------------------------------------------
    phase("1 device")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2 -------------------------------------------------------------------
    phase("2 build")
    t0 = time.perf_counter()
    built = _build.build(verbose=True)
    emit({"build_s": time.perf_counter() - t0, "per_kernel_s": built})

    frozen = frozen_bits(N_LEN, K_LEN, 0.0, "BB")
    det = CRC16()
    enc = PolarEncoder(N_LEN, frozen, systematic=True, detector=det, device=dev)
    dec = SCLDecoder(N_LEN, frozen, list_size=LIST, systematic=True,
                     detector=det, device=dev)
    dec_plain = SCLDecoder(N_LEN, frozen, list_size=LIST, systematic=True,
                           detector=det, device=dev,
                           subtree_fn=scl_kernel_bl.scl_subtree_plain)
    gen = torch.Generator(device=dev).manual_seed(20261016)
    modem, chan = Bpsk(), Awgn()
    chan.set_esn0_linear(10.0 ** (EBN0_DB / 10.0) * K_LEN / N_LEN)

    def blocks(n):
        info = torch.randint(0, 2, (n, K_LEN), generator=gen, device=dev,
                             dtype=torch.uint8)
        code = enc.encode(info)
        llr = modem.demodulate(chan.transmit(modem.modulate(code), gen))
        return info, code, llr

    # 3 -------------------------------------------------------------------
    phase("3 K2 butterfly_encode vs plain")
    info = torch.randint(0, 2, (K2_BATCH, K_LEN), generator=gen, device=dev,
                         dtype=torch.uint8)
    u = enc.inject(det.generate(info)).contiguous()
    mask = enc._mask_t
    k2 = butterfly_kernel.butterfly_encode(u, mask, True)
    k2_plain = butterfly_kernel.butterfly_encode_plain(u, mask, True)
    torch.cuda.synchronize()
    k2_err = int((k2.int() - k2_plain.int()).abs().max())
    if k2_err or k2.shape != (K2_BATCH, N_LEN):
        raise AssertionError(f"K2 differs from its plain version (max |d| {k2_err})")
    if not torch.equal(enc.extract(k2), det.generate(info)):
        raise AssertionError("K2 codewords do not carry their info bits")
    print(f"K2 bit-equal on {K2_BATCH} blocks")

    # 4 -------------------------------------------------------------------
    phase("4 K1 scl_subtree vs plain, call by call")
    _, _, llr = blocks(BATCH)
    calls = []

    def record(sched, x, m):
        out = scl_kernel_bl.scl_subtree(sched, x, m)
        calls.append((sched, x, m, out))
        return out

    dec_rec = SCLDecoder(N_LEN, frozen, list_size=LIST, detector=det,
                         device=dev, subtree_fn=record)
    dec_rec.decode_packed(llr)
    torch.cuda.synchronize()
    k1_err = 0.0
    for sched, x, m, (bits, perm, met) in calls:
        pb, pp, pm = scl_kernel_bl.scl_subtree_plain(sched, x, m)
        if not (torch.equal(bits, pb) and torch.equal(perm, pp)):
            bad = (bits != pb).any(0) | (perm != pp).any(1)
            raise AssertionError(
                f"K1 call (offset {sched.node.offset}, span {sched.span}, "
                f"w_in {sched.w_in}): bits/perm differ on "
                f"{int(bad.sum())} codewords")
        if not torch.isfinite(met).all() or met.shape != (BATCH, sched.w_out):
            raise AssertionError("K1 metrics not finite or of the wrong shape")
        torch.testing.assert_close(met, pm, rtol=TOL, atol=TOL)
        k1_err = max(k1_err, float((met - pm).abs().max()))
        print(f"K1 call offset {sched.node.offset} span {sched.span} "
              f"w {sched.w_in}->{sched.w_out}: equal, max |d metric| "
              f"{float((met - pm).abs().max())}")
    if len(calls) < 2:
        raise AssertionError(f"expected >= 2 subtree calls, got {len(calls)}")

    # 5 -------------------------------------------------------------------
    phase("5 end to end, kernels then plain versions")
    sent, llrs, outs = [], [], []
    butterfly_kernel.LAUNCHES = 0
    scl_kernel_bl.LAUNCHES = 0
    for _ in range(BATCHES):
        info, _, llr = blocks(BATCH)
        sent.append(det.generate(info))
        llrs.append(llr)
        outs.append(dec.decode(llr))
    torch.cuda.synchronize()
    launches = {"butterfly_encode": butterfly_kernel.LAUNCHES,
                "scl_subtree": scl_kernel_bl.LAUNCHES}  # phase 6 reads these
    wrong_total = crc_fail_total = 0
    for i, llr in enumerate(llrs):
        got, want = outs[i], dec_plain.decode(llr)
        same = [torch.equal(a, b) for a, b in zip(got, want)]
        if not all(same):
            diff = ((got[0] != want[0]).any(1) | (got[1] != want[1]).any(1)
                    | (got[2] != want[2]))
            for blk in torch.nonzero(diff).flatten().tolist():
                _check_tie(dec, dec_plain, llr[blk : blk + 1], i, blk)
        wrong = (got[0] != sent[i]).any(1)
        if (~got[2] & ~wrong).any():
            raise AssertionError("a block with a failed CRC decoded right")
        wrong_total += int(wrong.sum())
        crc_fail_total += int((~got[2]).sum())
    n_blocks = BATCH * BATCHES
    bler = wrong_total / n_blocks
    emit({"metric": "bler", "value": bler, "blocks": n_blocks,
          "block_errors": wrong_total, "crc_failures": crc_fail_total,
          "ebn0_db": EBN0_DB})
    if not 1e-4 <= bler <= 5e-2:
        raise AssertionError(f"BLER {bler} outside [1e-4, 5e-2]")
    cpu = SCLDecoder(N_LEN, frozen, list_size=LIST, detector=det)
    ref = cpu.decode(llrs[0][:64].cpu())
    for a, b in zip(outs[0], ref):
        if not torch.equal(a[:64].cpu(), b):
            raise AssertionError("card decode differs from the CPU decode")
    print("kernel decode == plain decode on the card; first 64 == CPU decode")

    # 6 -------------------------------------------------------------------
    phase("6 launch counts")
    emit({"launches": launches})
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} never launched on the main path")

    # 7 -------------------------------------------------------------------
    phase("7 times (CUDA events, median)")
    llr = llrs[0]
    info = sent[0]
    payload = BATCH * (K_LEN - det.tail_bits)
    dec_ms = time_cuda(lambda: dec.decode(llr), reps=REPS)
    dec_plain_ms = time_cuda(lambda: dec_plain.decode(llr), warmup=1, reps=REPS)
    enc_ms = time_cuda(lambda: enc.encode(info), reps=REPS)
    emit({"metric": "decode_payload_throughput", "value": payload / dec_ms / 1e3,
          "unit": "Mbit/s", "batch": BATCH, "ms": dec_ms,
          "plain_subtree_ms": dec_plain_ms, "card": card})
    emit({"metric": "encode_payload_throughput", "value": payload / enc_ms / 1e3,
          "unit": "Mbit/s", "batch": BATCH, "ms": enc_ms, "card": card})
    u = enc.inject(info).contiguous()
    k2_ms = time_cuda(lambda: butterfly_kernel.butterfly_encode(u, mask, True), reps=REPS)
    k2_plain_ms = time_cuda(
        lambda: butterfly_kernel.butterfly_encode_plain(u, mask, True), reps=REPS)
    emit({"kernel": "butterfly_encode", "batch": BATCH, "ms": k2_ms,
          "plain_ms": k2_plain_ms, "card": card})
    k1_ms = k1_plain_ms = 0.0
    for sched, x, m, _ in calls:
        kt = time_cuda(lambda: scl_kernel_bl.scl_subtree(sched, x, m), reps=REPS)
        pt = time_cuda(lambda: scl_kernel_bl.scl_subtree_plain(sched, x, m),
                       warmup=1, reps=REPS)
        k1_ms += kt
        k1_plain_ms += pt
        emit({"kernel": "scl_subtree", "span": sched.span, "w_in": sched.w_in,
              "w_out": sched.w_out, "batch": BATCH, "ms": kt, "plain_ms": pt,
              "card": card})

    # 8 -------------------------------------------------------------------
    emit({"kernels": [
        {"name": "butterfly_encode", "route": "cuda",
         "source": "polar_codes_torch/csrc/butterfly_encode.cu",
         "replaces": "polar_codes_tpu/ops/butterfly_kernel.py:61",
         "launches": launches["butterfly_encode"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
        {"name": "scl_subtree", "route": "cuda",
         "source": "polar_codes_torch/csrc/scl_subtree.cu",
         "replaces": "polar_codes_tpu/ops/scl_kernel_bl.py:876",
         "launches": launches["scl_subtree"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
    ]})
    # 9 -------------------------------------------------------------------
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def _check_tie(dec, dec_plain, llr, batch_idx, blk):
    """A block whose decisions differ between the kernel and plain decodes
    is admitted only if the two winning paths tie within TOL: the same
    final metric, so the difference is a float tie broken in another order."""
    import torch

    _, mk, _ = dec.decode_paths(llr)
    _, mp, _ = dec_plain.decode_paths(llr)
    print(f"block {batch_idx}:{blk} differs; kernel metrics {mk.tolist()} "
          f"plain metrics {mp.tolist()}")
    if not torch.allclose(mk.sort(-1).values, mp.sort(-1).values,
                          rtol=TOL, atol=TOL):
        raise AssertionError(
            f"block {batch_idx}:{blk}: kernel and plain decodes differ beyond a "
            f"float tie within {TOL}")


if __name__ == "__main__":
    main()
    sys.exit(0)
