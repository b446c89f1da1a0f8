#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and hold its kernels
against their plain versions.

Slice 1's main path: (1024, 512) systematic CA-SCL-8 with CRC16,
Bhattacharyya construction at a 0 dB design SNR, BPSK over AWGN at
Eb/N0 = 2 dB, through PolarEncoder.encode (kernel K2,
csrc/butterfly_encode.cu) and SCLDecoder.decode (kernel K1,
csrc/scl_subtree.cu, under the torch glue and the packed CRC tail).

Slice 2's path, the simulator's defaults (pcsim -n 1024 -r 0.5 -l 8
-e crc32 -p 832 -a 10): CRC32, LLRs x10 quantised to int8, and
AdaptiveDecoder with an int8 Fast-SSC pass (kernel K3,
csrc/fastssc_subtree.cu) and CA-SCL-8 (K1) on the blocks whose CRC fails;
beside it the float fast pass (SCLDecoder(list_size=1), K3 in float32)
and the SCAN decoders (kernels K4 and K5, csrc/scan_sweep.cu).

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is 0 only if all held):
  1. the card's name and power limit, torch and CUDA versions
  2. build every kernel from csrc/ with nvcc
  3. K2 against its plain version on 4096 CRC'd blocks: bit-equal
  4. K1 against its plain version, call by call, on the subtree calls of
     one 1024-block decode: bits and perms equal, metrics within 1e-4
  5. 8 x 1024 blocks end to end, decoded by the kernels and again by the
     plain versions on the card: equal decisions, BLER in [1e-4, 5e-2],
     every CRC failure a wrong block; 64 blocks also equal to a CPU decode
  6. both kernels launched during the phase-5 kernel run
  7. CUDA-event times (median of >= 10 after warm-up), one JSON line each
  8. K3 against its plain version: one root call at B = 2048, N = 1024 in
     float32 and in int8, and N = 2048 decodes (glue above span 1024,
     state out of each call): bits and state equal
  9. the pcsim default path, 8 x 2048 blocks, kernels then plain versions:
     equal decisions, BLER in [1e-4, 5e-2], every CRC failure a wrong
     block, adaptive != always-SCL-8 only where the fast CRC passed, 64
     blocks equal to a CPU decode; the float fast pass (L = 1) likewise
 10. SCAN, 4 sweeps, and FastSSCAN, CRC32, 4 iterations, at (1024, 512):
     K4 and K5 (sweep by sweep, betas and memory) bit-equal to their plain
     versions, equal decisions, BLER < 0.5
 11. K1, K3 (float32 and int8), K4 and K5 launched on those paths
 12. CUDA-event times of K3, K4, K5 and the adaptive decode

Slice 3's paths, the large-N decoders at the JAX benchmark grid's extremes,
Bhattacharyya at 0 dB, BPSK over AWGN, B = 128: (131072, 65536) systematic
SC through PolarEncoder.encode (the product-form transform above N = 2048)
and LargeSCDecoder(chunk=2048) (kernel K6, csrc/large_sc_chunk.cu), and
(32768, 16384) CRC16 CA-SCL-8 through LargeSCLDecoder(chunk=256,
subblock=16, bf16 stage carry) (kernel K7, csrc/large_scl_chunk.cu, and K1
for the pure chunks).
 13. K6 against its plain version, call by call, on >= 8 mixed-chunk calls
     spread over one decode: x and u bit-equal
 14. K7 likewise, the calls including a chunk with every sub-block class:
     bits and perms equal, metrics within 1e-4; then K7 at L = 2, 4, 16,
     32 with and without sub-blocks, and K6 at chunks 64, 1024 and 8192;
     then the branches of the redesigned kernels: K6 on masks with rate-0 runs
     at every span, all-frozen and all-free chunks (64, 2048, 8192), K7 at
     L = 2..32 with and without sub-blocks on integer LLRs in [-2, 2]
     (ties, signed zeros), half the rows with one live path
 15. both paths end to end, 4 x 128 blocks each (SCL at 2 dB and at a
     lower Eb/N0 where blocks fail): BLER, CRC failures (every one a wrong
     block), decisions equal to a decode by the plain versions on the card
     (one batch of each), and noiseless N = 131072 round trips exact
 16. launch counts of K6, K7 and K1 per decode on those paths: one per
     mixed (K6, K7) or pure (K1) chunk, as the decoders' classes say
 17. CUDA-event times of K6 and K7 per call, each decode per batch, the
     N = 131072 encode, and the chunk kernels' bounds

Slice 4's paths, the char (int8) and bf16 families: the simulator's
`pcsim -n 1024 -r 0.5 -l 8 -e crc32 -p 8 -a 10` (CRC32, LLRs x10 quantised
to int8, SCLDecoder(dtype=int8): K1 char), the same code under
SCLDecoder(dtype=bfloat16) with CRC16 (K1 float32 on the widening call,
K1 bf16), and both large-N decoders with dtype=int8 on quantised LLRs
(K6 char; K7 char with no sub-blocks and no pure chunks).
 18. K1 char against its plain version on every subtree call of one int8
     decode (B = 2048), K1 float32 and bf16 on every call of one bf16
     decode: bits and perms equal, metrics exactly equal
 19. the int8 and bf16 paths, 8 x 2048 blocks each, kernels then plain
     versions: equal decisions, BLER in [1e-4, 5e-2], every CRC failure a
     wrong block, 64 blocks equal to a CPU decode
 20. K6 char and K7 char against their plain versions on >= 8 calls spread
     over one full-width int8 decode each: K6 bit-equal, K7 bits and perms
     equal and metrics exactly equal; K6 (both families), K4 and K5
     bit-equal on integer LLRs in [-2, 2], where f meets signed zeros;
     the char families on phase 14's rate-0 masks and ties
 21. both int8 large-N paths end to end, 4 x 128 blocks each at 2 dB:
     BLER, CRC failures (every one a wrong block), decisions equal to a
     plain decode of one batch
 22. launch counts per decode: K1 char on the int8 path, K1 float32 and
     bf16 on the bf16 path, K6 char on every chunk of the int8 SC path, K7
     char on every chunk of the int8 SCL path and K1 none
 23. CUDA-event times of each new family per call and each new decode per
     batch, with bounds

Slice 6, the SCL subtree kernel K1 redesigned (a warp per codeword, its
list state in shared memory), in every family:
 24. K1 against its plain version on every subtree call of N = 1024
     CA-SCL decodes at L = 2, 4, 8, 16, 32 and B = 1, 181, 2048 on integer
     LLRs in [-2, 2], on those subtrees entered at w_in = L / 2, and on
     one-leaf schedules of every leaf kind: bits, perms and metrics
     equal; K1's two N = 1024 CA-SCL-8 calls timed at B = 181 and 2048
     (and at 1, 2, 4 codewords a block), and the one-leaf span-256 calls
     of the large-N pure chunks

Slice 7, the SCAN sweep kernels K4 and K5 redesigned (a warp per one or
two codewords, no block barrier):
 25. K4 and K5 against their plain versions at N in (4, 64, 1024, 2048,
     4096) (Bhattacharyya, rate 1/2), B in (1, 3, 181, 2048), on Gaussian
     and integer LLRs: K4 over 1, 2, 4 and 8 sweeps with its node memory
     on chip and in device memory (where each fits), K5 over 8 chained
     sweeps, betas and memory bit-equal (+inf, signed zeros); B = 3 and
     181 also at 1 and 2 codewords a warp, 8 a block (idle warps,
     codewords past the batch); SCAN and FastSSCAN decodes at (1024,
     512), CRC32, 2 dB equal to decodes by the plain versions, BLER <
     0.5; K4 and K5 timed at B = 181 and 2048,
     a call alone and within a burst (K4 in both placements), and the
     scan4 and fastsscan4 decodes

Slice 8, the Fast-SSC subtree kernel K3 (both families) and the butterfly
encoder K2 redesigned (K3: a warp per codeword, nodes of up to 1024
positions in registers; K2: packed bits in registers, shuffles across
lanes):
 26. K3 against its plain version at N = 2, 4, ..., 2048 (Bhattacharyya,
     rate 1/2), B in (1, 3, 181, 2048), Gaussian and integer LLRs (in
     char with -128 and +-127), both families and both output forms;
     K2 at N = 2, 4, ..., 2048, B in (1, 3, 1024, 4096), systematic or
     not, on random bits (frozen positions too); all bit-equal; K3's
     root call timed at B = 181 and 2048 and K2 at B = 1024, a call
     alone and within a burst

Slice 9, the simulator (`python -m polar_codes_torch.sim.cli`, pcsim's
options and 23-column CSV) on the card, through sim.cli.main:
 29. the default job, `single -n 1024 -r 0.5 -l 8` (CRC32, -p 832, -a 10,
     BB at 0 dB), Eb/N0 1, 2, 3 dB, 4 chunks of 2048 blocks each: 23
     columns, 3 rows, BLER not rising with Eb/N0 and in [1e-4, 5e-2] at
     2 dB, no more reported than block errors; K2, K3 char and K1 launched
     in the job; each job's wall time and decode share; a job stopped after
     2 of 4 chunks has checkpointed the counters of those 2 chunks rebuilt
     by hand from their seeds (where every failed check is a wrong block),
     and resumed, it equals the uninterrupted job
 30. one 2 dB job of 2 x 1024 blocks for each new option: `-e cmac32 -p 32`
     (the CA-SCL tail checking CMAC on every path; its engine and host
     share printed), `ask --bps 2`, `--channel rayleigh`, `-p 8`,
     `--construction GA` and `5G`; each job's first chunk rebuilt, its first
     64 blocks decoded on the card equal to a CPU decode
 31. the same job with `--devices 1` in a one-rank NCCL process group
     (env://): its counters, all-reduced once a step, equal the job's alone

Slice 10, the rest of the decoders: LargeSCLDecoder(schedule="tree")
(K7 on the mixed chunk-span subtrees, K1 on the pure leaves at their
maximal span, torch f/g glue above), DepthFirstDecoder (SC-Flip, torch
only), ErrorLocator and its app, the Puncturer:
 32. K1 one-leaf schedules of every kind at spans 512-8192, L 2-32, B in
     (1, 181, 1024), every family, on integer and Gaussian LLRs with rows
     of one live path: staged in shared memory where the input fits, else
     read from device memory; bits, perms and metrics equal
 33. the tree arm at (32768, 16384) CA-SCL-8 CRC16, chunk 256, sub-block
     16, 4 x 128 blocks at 2 and 0.8 dB: K7 and K1 launches per decode as
     the tree says, every CRC failure a wrong block, BLER <= 5e-2 at 2 dB
     and CRC failures at 0.8 dB, one batch of each equal to the route
     through the plain versions (bits equal, metrics within 1e-4), a
     noiseless round trip; decode times beside the scan arm's; an L = 32
     decode of 8 blocks whose longest leaves read device memory
 34. DepthFirstDecoder at (1024, 512) CRC16, 8 trials, 1024 blocks at 2
     dB: the first 64 equal to a CPU decode, no more wrong blocks than
     float32 Fast-SSC on the same LLRs, ms per decode; `sim.cli depthfirst
     -n 1024 -r 0.5 -l 8`, one SNR point, two chunks of 1024
 35. ErrorLocator at N = 1024, B = 1024, 1, 2 and 3 dB: `first` and the
     mask equal to the CPU's; `python -m polar_codes_torch.sim.
     errorlocator_app -n 1024 -r 0.5 --snr-min 1 --snr-max 3 --snr-count
     3`, 4 chunks of 1024 a point: its 7-column CSV, K2 once a chunk, ms
     per chunk; a Puncturer (M = 1000 of N = 1024) round trip on the card
     equal to the CPU's

Slice 11, every list size and the bf16 Fast-SSC family: K1 at any L (a
list size below a power of two in that capacity's instantiation; above 32
paths W = L / 32 packed words), SCLDecoder at L = 64 and 128, the
simulator's `listlength`, AdaptiveDecoder(list_schedule=(3, 12)); K3's bf16
family under FastSSCDecoder(dtype=bfloat16) and
AdaptiveDecoder(fast_dtype=bfloat16):
 36. K1 against its plain version at L = 3, 5, 12, 24, 64, 128, B in (1,
     181, 2048), every family: every subtree call of an N = 1024 CA-SCL
     decode on integer LLRs in [-2, 2], and one-leaf schedules of every
     kind with rows of one live path; bits, perms and metrics equal; K1's
     calls at L = 3 and 12 timed at B = 2048
 37. (1024, 512) CA-SCL-64 CRC16 at B = 1024, 1.5 dB, in float32, int8 and
     bf16, and CA-SCL-128 at B = 256: decisions and packed words equal to
     the plain route, metrics within 1e-4, every CRC failure a wrong
     block, CA-SCL-64 no more wrong blocks than CA-SCL-8 plus 2; decode ms,
     K1 ms and launches per decode
 38. `sim.cli listlength -n 1024 --l-min 16 --l-max 64`, one point of 1024
     blocks a list size: 3 rows, K1 launched at L = 64;
     AdaptiveDecoder(list_schedule=(3, 12)) at B = 2048 equal to its plain
     route, K1 launched at L = 3 and 12
 39. K3 bf16 against its plain version at N = 2 .. 2048, B in (1, 3, 181,
     2048), Gaussian, integer (zeros of either sign) and order-sensitive
     LLRs, both output forms, bit-equal; FastSSCDecoder(bf16) at (1024,
     512), B = 2048 and (2048, 1024), AdaptiveDecoder(fast_dtype=bf16) at
     B = 2048, each equal to its plain route; K3 bf16 timed

Slice 12, LargeSCLDecoder at every list size from 1 to 128: K7 at any L
(L = 2, 4, 8, 16, 32 keep their kernels; every other size runs in the
kernel of its capacity, 32, 64 or 128, csrc/large_scl_lists.cu, with W =
ceil(L / 32) packed words above 32 paths and level 0 in device memory
where the pyramid does not fit), the large-N glue on W words, and K1's
one-leaf schedules at L = 1:
 40. K7 against its plain version at L in (1, 3, 5, 12, 24, 33, 48, 64,
     100, 128), both families, 6 calls each: chunks of 64 and 256, B in
     (1, 181, 128), with and without sub-blocks of every class, metrics of
     a first call, all live and 0 to L - 1 live, integer LLRs in [-2, 2],
     masks with rate-0 runs and all frozen (the re-take rule), L = 100 and
     128 at chunk 256 with level 0 in device memory; K1 on one-leaf
     schedules of every kind at L = 1 (spans 256-2048) and from device
     memory at L = 64 and 128 (W = 2, 4); bits, perms, metrics equal
 41. (32768, 16384) CRC16 CA-SCL-64 and CA-SCL-128 on both schedules,
     CA-SCL-3 and CA-SCL-1 on the scan schedule, CA-SCL-64 with the bf16
     carry, and int8 CA-SCL-3 and -64 at (8192, 4096) (N = 32768 fails every
     int8 block), B = 64 at 2 dB: K7 and K1 launches per decode at that L
     as the classes say, every CRC failure a wrong block; but for L = 1
     (held call by call in phase 40), packed words and metrics exactly
     equal to the plain route and equal decisions, at (8192, 4096) (the
     plain routes at N = 32768 took ~75 s together)
 42. K7 per call at L = 1, 3, 64, 128 (float32) and 3, 64 (char) beside
     its bound and its plain version, K1 at L = 1 per decode, launches per
     decode by list size, the CA-SCL-64 decode at B = 128 on both
     schedules (ms, device busy share under torch.profiler), and phase
     17's K7 call at L = 8 timed again

Slice 13, lists above 128 paths: where one codeword's list state does not
fit shared memory (every L > 128; L <= 128 at a large kernel_span or
chunk), K1 and K7 run csrc/scl_wide.cu, a block a codeword with the LLR
levels in a device-memory scratch:
 43. K1 from device memory against its plain version at L = 129, 160,
     256, 512, every family, B in (1, 181, 256) (each L at every batch):
     every subtree call of an N = 1024 CA-SCL decode on integer LLRs in
     [-2, 2]; L = 128 at kernel_span 512 and L = 64 at 1024; bits, perms,
     metrics equal, every call through the device-memory kernel
 44. K7 from device memory against its plain version at L = 129, 160,
     256, both families, chunks 64 and 256, with and without sub-blocks
     of every class, rows with 1 and L - 1 live paths; L = 128 at chunk
     512 and L = 64 at 1024; bits, perms, metrics equal
 45. (1024, 512) CRC16 CA-SCL-256 at 1.5 dB, B = 256, in float32, int8 and
     bf16, CA-SCL-512 at B = 64, CA-SCL-128 at kernel_span 512: kernel
     route == plain route (words exact, metrics within 1e-4, decisions
     equal), every CRC failure a wrong block, no more wrong blocks than
     CA-SCL-64 on the same blocks + 2, K1 from device memory at that L;
     sim.cli listlength --l-min 64 --l-max 256; (32768, 16384) CA-SCL-256,
     chunk 256, sub-block 16, 2 dB, B = 32, on both schedules (K7 and K1
     from device memory; against CA-SCL-64); the plain routes at (8192,
     4096): CA-SCL-256 on both schedules and in int8, CA-SCL-128 at chunk
     512 (the plain route at N = 32768 and L = 256 would take minutes)
 46. K1 per decode at L = 256 (every family), 512 and 128 at span 512, K7
     per call at L = 256 (float32 on the path, char) and 128 at chunk 512,
     beside bounds and plain versions; CA-SCL-256 decode ms and device
     busy share at N = 1024 and 32768

Slice 14, the pypolar facade (polar_codes_torch.pypolar: PolarEncoder,
PolarDecoder, Detector, Puncturer, as the reference library's Python
module), which adds no kernel but reaches each of them by its type string
and block length:
 47. the main path through the facade: frozen_bits(1024, 512, 0.0),
     encode_vector with CRC16 on 4 batches of [1024, 64] bytes (K2), BPSK
     and AWGN at 2 dB on the card, decode_vector of PolarDecoder(1024, 8,
     f, "float") (K1 float32): bytes equal to np.packbits of the direct
     SCLDecoder's decode, BLER in [1e-4, 5e-2], Detector(16).check true
     on every correct block, one vector equal to its batch of one; then
     "char" L = 8 (K1 char), "mixed" with CRC32 at B = 2048 (K3 float32,
     K1 on the failed rows), "scan" L = 4 (K4), L = 1 "float" and "char"
     (K3 float32, int8), (32768, 16384) "float" and "char" L = 8 at B = 32
     (K7, K1 on pure chunks) and (131072, 65536) L = 1 at B = 16 (K6):
     each equal to the port's model called directly, each kernel of the
     route launched during its facade call; Puncturer(1000, f) round trips
     on values and packed bytes
 48. the facade's duration_ns on the main path (median of 10 after
     warm-up) beside the direct decode's CUDA-event time, its synchronised
     wall time and the facade's device busy share (the profiler's device
     time over the median duration_ns); the encoder's duration_ns beside
     the direct encode's, checksum and K2, by CUDA events

Slice 15, the benchmark grid (`python -m polar_codes_torch.sim.benchmark`,
the port of the JAX package's `polar-bench`), device timing
(utils.timing.time_device_fn) and the route-free cost model
(utils.costmodel, utils.profiling.roofline), which add no kernel:
 49. the grid through sim.benchmark.main: `--quick --fresh` (17 rows), then
     `--filter` each of adaptive_float_n1024_l8, depthfirst_n1024_t8,
     fastsscan_n1024_i4, sc_scan_float_n32768 and cascl_scan_float_n32768_l8
     (with its bf16-carry row), into one JSON-lines file: every row printed,
     no `error` row, each with the card's name and power limit and an
     `mfu` and `hbm_util` in [0, 1]; K1-K7 launched; the same commands again
     (the resume) run no row
 50. on the main path, (1024, 512) CA-SCL-8 CRC16 at B = 1024, and its
     encode: time_device_fn against time_cuda (both positive, within 2x of
     each other) and roofline with the analytic counts beside both times

Then the kernels line, {"kernels": [...], "facade": {route: launches}}:
every family of all seven TPU kernels, K1 at L = 3, 12, 64 (every family),
128 and 1, and K7 at L = 1, 3, 64, 128 (float32) and 3, 64 (char); K1 from
device memory at L = 256 (every family), 512 and 128 at span 512, K7 at L =
256 (both families) and 128 at chunk 512; each entry's launches_by_path
holds the facade's routes too. The last line is {"ok": true, "device":
{...}}. Without a CUDA device it exits non-zero before printing any result.
"""

import json
import os
import subprocess
import sys
import time

DEVICE = "cuda"
N_LEN, K_LEN, LIST, EBN0_DB = 1024, 512, 8, 2.0
BATCH, BATCHES, K2_BATCH = 1024, 8, 4096
TOL = 1e-4  # metric tolerance: sums taken in another order elsewhere
REPS = 10


def emit(obj):
    print(json.dumps(obj), flush=True)


_T0 = time.perf_counter()


def phase(name):
    print(f"# {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


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
    scl_kernel_bl.LAUNCHES.update(float32=0, char=0, bfloat16=0)
    for _ in range(BATCHES):
        info, _, llr = blocks(BATCH)
        sent.append(det.generate(info))
        llrs.append(llr)
        outs.append(dec.decode(llr))
    torch.cuda.synchronize()
    launches = {"butterfly_encode": butterfly_kernel.LAUNCHES,
                "scl_subtree": scl_kernel_bl.LAUNCHES["float32"]}  # phase 6 reads these
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
    cpu = SCLDecoder(N_LEN, frozen, list_size=LIST, detector=det, device="cpu")
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

    # 8-12 ----------------------------------------------------------------
    slice2 = run_slice2(card)

    # 13-17 ---------------------------------------------------------------
    slice3 = run_slice3(card)

    # 18-23 ---------------------------------------------------------------
    slice4 = run_slice4(card)

    # 24 ------------------------------------------------------------------
    phase("24 K1 at every list size, on ties, w_in < L, B in (1, 181, 2048), one-leaf "
          "schedules")
    k1_shapes_err = run_k1_shapes(card)

    # 25 ------------------------------------------------------------------
    phase("25 K4 and K5 at N in (4 .. 4096), B in (1, 3, 181, 2048), 1-8 sweeps, "
          "both memory placements")
    scan_shapes = run_scan_shapes(card)

    # 26 ------------------------------------------------------------------
    phase("26 K3 and K2 at N in (2 .. 2048), B in (1, 3, 181, 2048) and (1, 3, 1024, 4096)")
    k3k2 = run_k3_k2_shapes(card)

    # 29-31 ---------------------------------------------------------------
    sim = run_slice9(card)

    # 32 ------------------------------------------------------------------
    phase("32 K1 one-leaf schedules at spans 512-8192, L 2-32, B in (1, 181, 1024), every "
          "family, staged and from device memory")
    k1_long_err = run_k1_long(card)

    # 33-35 ---------------------------------------------------------------
    s10 = run_slice10(card)

    # 36 ------------------------------------------------------------------
    phase("36 K1 at L in (3, 5, 12, 24, 64, 128), B in (1, 181, 2048), every family, on "
          "ties and rows of one live path")
    k1_lists = run_k1_lists(card)

    # 37-39 ---------------------------------------------------------------
    s11 = run_slice11(card)

    # 40 ------------------------------------------------------------------
    phase(f"40 K7 at L in {K7_NEW_LISTS}, both families, chunks 64 and 256, B in "
          f"{K7_BATCHES}; K1 at L = 1 and from device memory at W = 2, 4")
    k7_lists = run_k7_lists(card)

    # 41-42 ---------------------------------------------------------------
    s12 = run_slice12(card, slice3["k7_l8"], k7_lists)

    # 43 ------------------------------------------------------------------
    phase("43 K1 from device memory at L in (129, 160, 256, 512), every family, B in (1, 181, "
          "256); L = 128 at kernel_span 512 and L = 64 at 1024")
    k1_wide = run_k1_wide(card)

    # 44 ------------------------------------------------------------------
    phase("44 K7 from device memory at L in (129, 160, 256), both families, chunks 64 and "
          "256; L = 128 at chunk 512 and L = 64 at 1024")
    k7_wide = run_k7_wide(card)

    # 45-46 ---------------------------------------------------------------
    s13 = run_slice13(card, k1_wide, k7_wide)

    # 47-48 ---------------------------------------------------------------
    s14 = run_slice14(card)

    # 49-50 ---------------------------------------------------------------
    run_slice15(card)

    # the kernels line ------------------------------------------------------
    for entry in slice2["kernels"]:  # K3: phase 26's calls and bursts too
        if entry["name"] in k3k2["err"]:
            entry["max_abs_err"] = max(entry["max_abs_err"], k3k2["err"][entry["name"]])
            entry["burst_ms"] = k3k2["burst_ms"][entry["name"]]
            entry["redesigned"] = K3_DESIGN
    for entry in slice2["kernels"]:  # K4 and K5: phase 25's calls too
        if entry["name"] in scan_shapes:
            entry["max_abs_err"] = max(entry["max_abs_err"], scan_shapes[entry["name"]])
            entry["redesigned"] = SCAN_DESIGN
    for entry in slice4["kernels"]:  # K1 char and bf16: phases 24 and 32's calls too
        if entry["name"].startswith("scl_subtree["):
            fam = entry["name"][len("scl_subtree["):-1]
            entry["max_abs_err"] = max(entry["max_abs_err"], k1_shapes_err[fam],
                                       k1_long_err[fam])
    for entry in slice3["kernels"]:  # K7: the tree arm's chunk-span subtrees
        if entry["name"] == "masked_scl_chunk[float32]":
            entry["launches_by_path"] = {
                "large_scl": entry["launches"],
                "large_scl_tree": s10["tree"]["masked_scl_chunk[float32]"]}
    for entry in slice2["kernels"] + slice4["kernels"]:  # the simulator's jobs
        by_path = {path: job[entry["name"]] for path, job in
                   [("pcsim_cli_default", sim["default"]), *sim["options"].items()]
                   if job.get(entry["name"])}
        if by_path:
            entry.setdefault("launches_by_path", {}).update(by_path)
    k1_bytes = k1_ops = 0
    for sched, *_ in calls:
        nb, no = k1_work(sched, BATCH)
        k1_bytes += nb
        k1_ops += no
    k2_bytes = 2 * BATCH * N_LEN + N_LEN  # u and codeword u8, the mask
    k2_ops = 2 * BATCH * (N_LEN // 2) * (N_LEN.bit_length() - 1)  # two passes of XORs
    entries = [
        {"name": "butterfly_encode", "route": "cuda",
         "source": "polar_codes_torch/csrc/butterfly_encode.cu",
         "replaces": "polar_codes_tpu/ops/butterfly_kernel.py:61",
         "launches": launches["butterfly_encode"],
         "launches_by_path": {"crc16_scl8": launches["butterfly_encode"],
                              "pcsim_adaptive": slice2["launches"]["butterfly_encode"],
                              "pcsim_cli_default": sim["default"]["butterfly_encode"],
                              "errorlocator_app": s10["errorlocator_app"]["butterfly_encode"],
                              "pcsim_cli_depthfirst": s10["depthfirst_cli"]["butterfly_encode"]},
         "max_abs_err": max(k2_err, k3k2["err"]["butterfly_encode"]), "ms": k2_ms,
         "burst_ms": k3k2["burst_ms"]["butterfly_encode"], "redesigned": K2_DESIGN,
         "plain_ms": k2_plain_ms, **bound(k2_bytes, k2_ops), "library_ms": None},
        {"name": "scl_subtree[float32]", "route": "cuda",
         "source": "polar_codes_torch/csrc/scl_subtree.cu",
         "redesigned": K1_DESIGN,
         "replaces": "polar_codes_tpu/ops/scl_kernel_bl.py:876",
         "launches": launches["scl_subtree"],
         "launches_by_path": {"crc16_scl8": launches["scl_subtree"],
                              "pcsim_adaptive": slice2["launches"]["scl_subtree"],
                              "large_scl": slice3["launches"]["scl_subtree"],
                              "scl8_bf16_widening": slice4["launches"]["scl_subtree[float32]"],
                              "pcsim_cli_default": sim["default"]["scl_subtree[float32]"],
                              "pcsim_cli_cmac32": sim["options"]["cmac32_scl8_float32"][
                                  "scl_subtree[float32]"],
                              "large_scl_tree": s10["tree"]["scl_subtree[float32]"]},
         "tree_leaf_ms": s10["tree_leaf_ms"],
         "max_abs_err": max(k1_err, k1_shapes_err["float32"], k1_long_err["float32"]),
         "ms": k1_ms,
         "plain_ms": k1_plain_ms, **bound(k1_bytes, k1_ops), "library_ms": None},
    ] + slice2["kernels"] + slice3["kernels"] + slice4["kernels"] + s11["entries"] + [
        {"name": f"scl_subtree[float32,L={n_list}]", "route": "cuda",
         "source": "polar_codes_torch/csrc/scl_subtree.cu", "redesigned": K1_NEW_DESIGN,
         "replaces": "polar_codes_tpu/ops/scl_kernel_bl.py:876",
         "launches": s11["ad_counts"]["scl_subtree_by_list"][n_list],
         "launches_by_path": {"adaptive_l3_l12": s11["ad_counts"]["scl_subtree_by_list"][n_list]},
         "max_abs_err": k1_lists["err"]["float32"], "ms": k1_lists["timed"][n_list][0],
         "plain_ms": k1_lists["timed"][n_list][1], **bound(*k1_lists["timed"][n_list][2:]),
         "library_ms": None}
        for n_list in (3, 12)] + [s11["k3"]] + s12["entries"] + s13["entries"]
    for entry in entries:  # the facade's routes (phase 47)
        if entry["name"] in s14["by_kernel"]:
            entry.setdefault("launches_by_path", {}).update(s14["by_kernel"][entry["name"]])
    emit({"kernels": entries, "facade": s14["routes"]})
    # the last line ---------------------------------------------------------
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


# ---- bounds: the least time the card could take for a call's work --------

# the card's roofs, one definition with the benchmark's roofline
from polar_codes_torch.utils.profiling import HBM_BYTES_PER_S, SCALAR_OPS_PER_S  # noqa: E402


def bound(n_bytes, n_ops):
    """bound_ms and bound_by of a call that must move n_bytes (each input
    read once, each output written once) and do n_ops elementwise
    operations (one per element that each op of the schedule writes; the
    decoders' f/g/min/add arithmetic is scalar, so it runs at the float32
    rate outside the tensor cores)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / SCALAR_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "bytes_ms": t_bytes * 1e3,
            "operations": n_ops, "operations_ms": t_ops * 1e3}


def k1_work(sched, n_batch, llr_bytes=4):
    """(bytes, operations) of one K1 call: llr [w_in, span, B] (llr_bytes
    each: 4 for float32, 2 for the int16 char and bf16 states) and metrics
    [B, w_in] f32 in; bits [W, span, B] i32 (W = ceil(L / 32) words), perm
    and metrics [B, w_out] out. Operations: w x h per F/G/COMBINE at the
    list width of that point of the schedule, w x span x candidates per
    leaf."""
    from polar_codes_torch.ops.scl_kernel_bl import n_words

    words = n_words(sched.list_size)
    n_bytes = n_batch * (llr_bytes * sched.w_in * sched.span
                         + 4 * (sched.w_in + words * sched.span + 2 * sched.w_out))
    n_ops, w = 0, sched.w_in
    for op, _, length, _, _, _, ncand, _ in sched.ops.tolist():
        if op == 3:  # LEAF
            n_ops += w * length * max(ncand, 1)
            w = min(w * ncand, sched.list_size) if ncand else w
        else:
            n_ops += w * (length // 2)
    return n_bytes, n_ops * n_batch


def k3_work(sched, n_batch, in_bytes, out_bytes):
    """(bytes, operations) of one K3 call: llr [span, B] in, [span, B] out;
    one operation per position each op writes."""
    n_ops = sum(length if op == 4 else length // 2
                for op, _, length, _, _ in sched.ops.tolist())
    return sched.span * n_batch * (in_bytes + out_bytes), n_ops * n_batch


def scan_work(sched, n_batch, sweeps, step):
    """(bytes, operations) of a K4 call (sweeps fused, memory on chip) or a
    K5 call (one sweep, memory [M, B] read and written): llr and beta
    [N, B] f32. Operations per sweep: 2 per position of F and G, 4 of
    COMBINE (two f, two adds), 1 per leaf position."""
    per = {0: 2, 1: 2, 2: 4}
    n_ops = sum(length if op == 3 else per[op] * (length // 2)
                for op, _, length, _, _ in sched.ops.tolist())
    n_bytes = 4 * n_batch * (2 * sched.block_length + (2 * sched.mem_rows if step else 0))
    return n_bytes, n_ops * n_batch * sweeps


def max_err(got, want):
    """Largest |got - want| over the elements that differ (0 if equal;
    +inf against a finite value counts as inf)."""
    got, want = got.double(), want.double()
    diff = got != want
    return float((got - want).abs()[diff].max()) if diff.any() else 0.0


# ---- slice 2: the pcsim default path, the fast pass, SCAN -----------------

B2, BATCHES2, AMPL, SWEEPS, SEED2 = 2048, 8, 10.0, 4, 20261017


def _equal(what, got, want):
    err = max_err(got, want)
    if err or got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(
            f"{what}: kernel differs from its plain version (max |d| {err}, "
            f"shapes {tuple(got.shape)} {tuple(want.shape)})")
    return err


def _same_decisions(what, got, want):
    import torch

    for a, b in zip(got, want):
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{what}: kernel and plain decodes differ")


def run_slice2(card):
    """Phases 8-12. Returns {"kernels": [...], "launches": {...}} for the
    kernels line."""
    import torch

    from polar_codes_torch.construction import frozen_bits
    from polar_codes_torch.dsp import Awgn, Bpsk
    from polar_codes_torch.models.adaptive import AdaptiveDecoder
    from polar_codes_torch.models.detectors import CRC32
    from polar_codes_torch.models.encoder import PolarEncoder
    from polar_codes_torch.models.fastssc import FastSSCDecoder
    from polar_codes_torch.models.scan import FastSScanDecoder, ScanDecoder
    from polar_codes_torch.models.scl import SCLDecoder
    from polar_codes_torch.ops import butterfly_kernel, scl_kernel_bl
    from polar_codes_torch.ops import fastssc_kernel as fk
    from polar_codes_torch.ops import scan_kernel as sk
    from polar_codes_torch.utils.timing import time_cuda

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED2)
    det = CRC32()
    frozen = frozen_bits(N_LEN, K_LEN, 0.0, "BB")
    enc = PolarEncoder(N_LEN, frozen, systematic=True, detector=det, device=dev)
    modem, chan = Bpsk(), Awgn()
    chan.set_esn0_linear(10.0 ** (EBN0_DB / 10.0) * K_LEN / N_LEN)
    payload = B2 * (K_LEN - det.tail_bits)

    def channel(encoder, n_blocks):
        """(sent info with its CRC, channel LLRs) of n random blocks."""
        info = torch.randint(0, 2, (n_blocks, encoder.info_length), generator=gen,
                             device=dev, dtype=torch.uint8)
        code = encoder.encode(info)
        return det.generate(info), modem.demodulate(chan.transmit(modem.modulate(code), gen))

    def quantise(llr):
        """The simulator's int8 LLRs: x10, round half to even, clip."""
        return torch.clamp(torch.round(llr * AMPL), -127, 127).to(torch.int8)

    def reset_counts():
        butterfly_kernel.LAUNCHES = 0
        scl_kernel_bl.LAUNCHES.update(float32=0, char=0, bfloat16=0)
        fk.LAUNCHES.update(float32=0, int8=0)
        sk.LAUNCHES.update(fused=0, step=0)

    def counts():
        torch.cuda.synchronize()
        return {"butterfly_encode": butterfly_kernel.LAUNCHES,
                "scl_subtree": scl_kernel_bl.LAUNCHES["float32"],
                "fastssc_subtree[float32]": fk.LAUNCHES["float32"],
                "fastssc_subtree[int8]": fk.LAUNCHES["int8"],
                "scan_fused": sk.LAUNCHES["fused"], "scan_step": sk.LAUNCHES["step"]}

    # 8 -------------------------------------------------------------------
    phase("8 K3 fastssc_subtree vs plain")
    _, llr = channel(enc, B2)
    fast = FastSSCDecoder(N_LEN, frozen, detector=det, device=dev)
    root = fast.schedule(fast.tree)
    k3_in = {"float32": (llr * AMPL).T.contiguous(), "int8": quantise(llr).T.contiguous()}
    k3_in["int8"][:4, :64] = -128  # outside the quantiser's range: f saturates alike
    k3_err = {}
    for name, x in k3_in.items():
        got = fk.fastssc_subtree(root, x, True)
        want = fk.fastssc_subtree_plain(root, x, True)
        torch.cuda.synchronize()
        k3_err[name] = _equal(f"K3 {name} root call", got, want)
        print(f"K3 {name}: root call bit-equal on {B2} blocks")
    frozen2 = frozen_bits(2 * N_LEN, 2 * K_LEN, 0.0, "BB")
    enc2 = PolarEncoder(2 * N_LEN, frozen2, detector=det, device=dev)
    _, llr2 = channel(enc2, B2)
    for name, x2 in (("float32", llr2 * AMPL), ("int8", quantise(llr2))):
        calls = []

        def record(sched, xs, is_root):
            out = fk.fastssc_subtree(sched, xs, is_root)
            calls.append((sched, xs, is_root, out))
            return out

        dec2 = FastSSCDecoder(2 * N_LEN, frozen2, dtype=x2.dtype, device=dev,
                              subtree_fn=record)
        plain2 = FastSSCDecoder(2 * N_LEN, frozen2, dtype=x2.dtype, device=dev,
                                subtree_fn=fk.fastssc_subtree_plain)
        cw = dec2.decode_to_codeword(x2)
        if len(calls) < 2 or any(c[2] for c in calls):
            raise AssertionError(f"expected >= 2 calls below the glue, got {len(calls)}")
        for sched, xs, is_root, out in calls:
            want = fk.fastssc_subtree_plain(sched, xs, is_root)
            k3_err[name] = max(k3_err[name], _equal(
                f"K3 {name} state, span {sched.span} at {sched.node.offset}", out, want))
        _equal(f"K3 {name} N=2048 decode", cw, plain2.decode_to_codeword(x2))
        print(f"K3 {name}: N=2048, {len(calls)} calls below the glue, state and bits equal")

    # 9 -------------------------------------------------------------------
    phase("9 pcsim default path: adaptive int8 Fast-SSC -> CA-SCL-8, CRC32")
    ad = AdaptiveDecoder(N_LEN, frozen, list_size=LIST, detector=det,
                         fast_dtype=torch.int8, device=dev)
    ad_plain = AdaptiveDecoder(N_LEN, frozen, list_size=LIST, detector=det,
                               fast_dtype=torch.int8, device=dev,
                               fast_subtree_fn=fk.fastssc_subtree_plain,
                               list_subtree_fn=scl_kernel_bl.scl_subtree_plain)
    sent, amp, quant, outs, reruns = [], [], [], [], []
    reset_counts()
    for _ in range(BATCHES2):
        info, llr = channel(enc, B2)
        q = quantise(llr)
        outs.append(ad.decode(q))
        reruns.append(ad.rerun_rows[0])
        sent.append(info)
        amp.append(llr * AMPL)
        quant.append(q)
    launches = counts()
    wrong_total = fail_total = differ_total = 0
    for i, q in enumerate(quant):
        got = outs[i]
        _same_decisions(f"adaptive batch {i}", got, ad_plain.decode(q))
        wrong = (got[0] != sent[i]).any(1)
        if (~got[2] & ~wrong).any():
            raise AssertionError("a block with a failed CRC decoded right")
        fast_ok = ad.fast.decode(q)[2]
        always = ad.list.decode(q.to(torch.float32))
        differ = ((got[0] != always[0]).any(1) | (got[1] != always[1]).any(1)
                  | (got[2] != always[2]))
        if (differ & ~fast_ok).any():
            raise AssertionError("adaptive differs from always-SCL-8 on a block "
                                 "whose fast pass failed its CRC")
        wrong_total += int(wrong.sum())
        fail_total += int((~got[2]).sum())
        differ_total += int(differ.sum())
    n_blocks = B2 * BATCHES2
    bler = wrong_total / n_blocks
    emit({"metric": "bler", "path": "pcsim_adaptive", "value": bler, "blocks": n_blocks,
          "block_errors": wrong_total, "crc_failures": fail_total,
          "escalated_share": sum(reruns) / n_blocks,
          "differs_from_always_scl8": differ_total, "ebn0_db": EBN0_DB})
    if not 1e-4 <= bler <= 5e-2:
        raise AssertionError(f"adaptive BLER {bler} outside [1e-4, 5e-2]")
    cpu = AdaptiveDecoder(N_LEN, frozen, list_size=LIST, detector=det,
                          fast_dtype=torch.int8, device="cpu")
    for a, b in zip(outs[0], cpu.decode(quant[0][:64].cpu())):
        if not torch.equal(a[:64].cpu(), b):
            raise AssertionError("card adaptive decode differs from the CPU decode")
    print("adaptive: kernel == plain on the card; first 64 == CPU decode")

    sc1 = SCLDecoder(N_LEN, frozen, list_size=1, detector=det, device=dev)
    sc1_plain = SCLDecoder(N_LEN, frozen, list_size=1, detector=det, device=dev,
                           subtree_fn=fk.fastssc_subtree_plain)
    reset_counts()
    sc1_outs = [sc1.decode(x) for x in amp]
    launches_l1 = counts()
    sc1_wrong = 0
    for i, a in enumerate(amp):
        _same_decisions(f"SCL L=1 batch {i}", sc1_outs[i], sc1_plain.decode(a))
        sc1_wrong += int((sc1_outs[i][0] != sent[i]).any(1).sum())
    emit({"metric": "bler", "path": "fast_pass_l1_float32", "value": sc1_wrong / n_blocks,
          "blocks": n_blocks, "block_errors": sc1_wrong, "ebn0_db": EBN0_DB})

    # 10 ------------------------------------------------------------------
    phase("10 SCAN (K4) and FastSSCAN (K5), 4 sweeps")
    scan = ScanDecoder(N_LEN, frozen, detector=det, iterations=SWEEPS, device=dev)
    fss = FastSScanDecoder(N_LEN, frozen, detector=det, iterations=SWEEPS, device=dev)
    fss_plain = FastSScanDecoder(N_LEN, frozen, detector=det, iterations=SWEEPS,
                                 device=dev, step_fn=sk.scan_step_plain)
    sched = scan.sched
    scan_x = scan._flat(amp[0])
    k4_err = _equal("K4 betas", sk.scan_fused(sched, scan_x, SWEEPS),
                    sk.scan_fused_plain(sched, scan_x, SWEEPS))
    mem_k = mem_p = torch.zeros((sched.mem_rows, B2), device=dev)
    k5_err = 0.0
    for sweep in range(SWEEPS):
        beta_k, mem_k = sk.scan_step(sched, scan_x, mem_k)
        beta_p, mem_p = sk.scan_step_plain(sched, scan_x, mem_p)
        k5_err = max(k5_err, _equal(f"K5 sweep {sweep} betas", beta_k, beta_p),
                     _equal(f"K5 sweep {sweep} memory", mem_k, mem_p))
    print(f"K4 ({SWEEPS} sweeps) and K5 (each sweep, betas and memory) bit-equal, "
          f"memory on chip: {sk.mem_on_chip(sched)}")
    # N = 4096: the node memory no longer fits on chip, K4 uses the scratch
    frozen4 = frozen_bits(4 * N_LEN, 4 * K_LEN, 0.0, "BB")
    big = ScanDecoder(4 * N_LEN, frozen4, iterations=2, device=dev)
    x4 = torch.randn((4 * N_LEN, 256), generator=gen, device=dev) * 2.0 + 1.0
    if sk.mem_on_chip(big.sched):
        raise AssertionError("expected the N=4096 node memory off chip")
    k4_err = max(k4_err, _equal("K4 betas, N=4096, memory in device memory",
                                sk.scan_fused(big.sched, x4, 2),
                                sk.scan_fused_plain(big.sched, x4, 2)))
    print("K4 at N=4096 (node memory in device memory) bit-equal")
    scan_batches = amp[:2]
    reset_counts()
    scan_outs = [scan.decode(b) for b in scan_batches]
    launches_scan = counts()
    reset_counts()
    fss_outs = [fss.decode(b) for b in scan_batches]
    launches_fss = counts()
    blers = {}
    for name, outs_ in (("scan4", scan_outs), ("fastsscan4", fss_outs)):
        wrong = sum(int((o[0] != sent[i]).any(1).sum()) for i, o in enumerate(outs_))
        blers[name] = wrong / (B2 * len(scan_batches))
    for i, b in enumerate(scan_batches):
        _same_decisions(f"FastSSCAN batch {i}", fss_outs[i], fss_plain.decode(b))
    emit({"metric": "bler", "path": "scan", "value": blers, "blocks": B2 * len(scan_batches),
          "ebn0_db": EBN0_DB})
    if not all(v < 0.5 for v in blers.values()):
        raise AssertionError(f"SCAN BLER not below 0.5: {blers}")

    # 11 ------------------------------------------------------------------
    phase("11 launch counts, per path")
    by_path = {"pcsim_adaptive": launches, "fast_pass_l1_float32": launches_l1,
               "scan4": launches_scan, "fastsscan4": launches_fss}
    emit({"launches": by_path})
    need = {"pcsim_adaptive": ("butterfly_encode", "fastssc_subtree[int8]", "scl_subtree"),
            "fast_pass_l1_float32": ("fastssc_subtree[float32]",),
            "scan4": ("scan_fused",), "fastsscan4": ("scan_step",)}
    for path, names in need.items():
        for name in names:
            if by_path[path][name] <= 0:
                raise AssertionError(f"{name} never launched on the {path} path")

    # 12 ------------------------------------------------------------------
    phase("12 times (CUDA events, median)")
    times = {}
    for name, xin in k3_in.items():
        kt = time_cuda(lambda: fk.fastssc_subtree(root, xin, True), reps=REPS)
        pt = time_cuda(lambda: fk.fastssc_subtree_plain(root, xin, True), warmup=1, reps=REPS)
        times[f"fastssc_subtree[{name}]"] = (kt, pt)
        emit({"kernel": f"fastssc_subtree[{name}]", "batch": B2, "span": N_LEN,
              "ms": kt, "plain_ms": pt, "card": card})
    mem0 = torch.zeros((sched.mem_rows, B2), device=dev)
    for name, fn, plain in (
            ("scan_fused", lambda: sk.scan_fused(sched, scan_x, SWEEPS),
             lambda: sk.scan_fused_plain(sched, scan_x, SWEEPS)),
            ("scan_step", lambda: sk.scan_step(sched, scan_x, mem0),
             lambda: sk.scan_step_plain(sched, scan_x, mem0))):
        kt = time_cuda(fn, reps=REPS)
        pt = time_cuda(plain, warmup=1, reps=REPS)
        times[name] = (kt, pt)
        emit({"kernel": name, "batch": B2, "sweeps": SWEEPS if name == "scan_fused" else 1,
              "ms": kt, "plain_ms": pt, "card": card})
    q = quant[0]
    failed = torch.nonzero(~ad.fast.decode(q)[2]).flatten()
    sub = q.index_select(0, failed).to(torch.float32)
    whole_ms = time_cuda(lambda: ad.decode(q), reps=REPS)
    fast_ms = time_cuda(lambda: ad.fast.decode(q), reps=REPS)
    rerun_ms = time_cuda(lambda: ad.list.decode(sub), reps=REPS)
    always_ms = time_cuda(lambda: ad.list.decode(q.to(torch.float32)), reps=REPS)
    sc1_ms = time_cuda(lambda: sc1.decode(amp[0]), reps=REPS)
    emit({"metric": "adaptive_decode_payload_throughput", "value": payload / whole_ms / 1e3,
          "unit": "Mbit/s", "batch": B2, "ms": whole_ms, "fast_pass_ms": fast_ms,
          "fast_pass_mbps": payload / fast_ms / 1e3, "rerun_rows": int(failed.numel()),
          "rerun_ms": rerun_ms,
          "rerun_mbps": failed.numel() * (K_LEN - det.tail_bits) / rerun_ms / 1e3,
          "always_scl8_ms": always_ms,
          "always_scl8_mbps": payload / always_ms / 1e3, "card": card})
    emit({"metric": "fast_pass_l1_float32_payload_throughput",
          "value": payload / sc1_ms / 1e3, "unit": "Mbit/s", "batch": B2, "ms": sc1_ms,
          "card": card})

    k3 = [{"name": f"fastssc_subtree[{name}]", "route": "cuda",
           "source": "polar_codes_torch/csrc/fastssc_subtree.cu",
           "replaces": "polar_codes_tpu/ops/fastssc_kernel.py:147",
           "launches": by_path["pcsim_adaptive" if name == "int8" else
                               "fast_pass_l1_float32"][f"fastssc_subtree[{name}]"],
           "max_abs_err": k3_err[name], "ms": times[f"fastssc_subtree[{name}]"][0],
           "plain_ms": times[f"fastssc_subtree[{name}]"][1],
           **bound(*k3_work(root, B2, 1 if name == "int8" else 4, 1)), "library_ms": None}
          for name in ("float32", "int8")]
    scan_k = [
        {"name": "scan_fused", "route": "cuda", "source": "polar_codes_torch/csrc/scan_sweep.cu",
         "replaces": "polar_codes_tpu/ops/scan_kernel.py:87",
         "launches": launches_scan["scan_fused"], "max_abs_err": k4_err,
         "ms": times["scan_fused"][0], "plain_ms": times["scan_fused"][1],
         **bound(*scan_work(sched, B2, SWEEPS, False)), "library_ms": None},
        {"name": "scan_step", "route": "cuda", "source": "polar_codes_torch/csrc/scan_sweep.cu",
         "replaces": "polar_codes_tpu/ops/scan_kernel.py:139",
         "launches": launches_fss["scan_step"], "max_abs_err": k5_err,
         "ms": times["scan_step"][0], "plain_ms": times["scan_step"][1],
         **bound(*scan_work(sched, B2, 1, True)), "library_ms": None},
    ]
    return {"kernels": k3 + scan_k, "launches": launches}


# ---- slice 3: the large-N decoders ----------------------------------------

N_SC, K_SC, CHUNK_SC = 131072, 65536, 2048
N_SCL, K_SCL, CHUNK_SCL, SUB = 32768, 16384, 256, 16
B3, BATCHES3, EBN0_SC, EBN0_LOW, SEED3 = 128, 4, 2.0, 0.8, 20261018
CALLS3 = 8  # chunk calls held against the plain versions, per kernel
B_SHAPES = 32  # batch of the extra-shape checks
NEG = -1.0e30  # metric of an inactive list slot


def spread(calls, need):
    """CALLS3 calls spread over a decode, with the indices `need` among them."""
    picks = {round(i * (len(calls) - 1) / (CALLS3 - 1)) for i in range(CALLS3)}
    return [calls[i] for i in sorted(picks | set(need))]


def k6_work(m_len, n_batch):
    """(bytes, operations) of one K6 call: llr [B, M] f32 and the mask in,
    x and u [B, M] f32 out. Operations per codeword: M per tree level of
    f/g, M/2 per level of combines, one per leaf."""
    levels = m_len.bit_length() - 1
    n_ops = m_len * levels + (m_len // 2) * levels + m_len
    return 12 * n_batch * m_len + m_len, n_ops * n_batch


def k7_work(sched, codes, n_list, n_batch):
    """(bytes, operations) of one K7 call on this chunk's sub-block classes:
    llr [B, L, M] f32, mask, metrics [B, L] and class codes in; bits [B, M]
    i32 ([B, W, M], W = ceil(L / 32) words, above 32 paths), perm and
    metrics [B, L] out. Operations as k1_work counts them: L x h per
    F/G/COMBINE, L x span x candidates per leaf (2 per bit), the skipped
    recursion of a pure sub-block not counted."""
    m_len = int(sched[0][2])
    words = (n_list + 31) // 32
    n_bytes = (n_batch * (4 * n_list * m_len + 12 * n_list + 4 * words * m_len) + m_len
               + 4 * len(codes))
    cand = {1: 1, 2: 4, 3: 2, 4: 8}
    n_ops, k = 0, 0
    while k < len(sched):
        op, _, length, off, skip = (int(v) for v in sched[k])
        if op == 4:  # SUB
            code = codes[off // length]
            if code:
                n_ops += n_list * length * cand[code]
                k += skip
        elif op == 3:  # BIT
            n_ops += n_list * 2
        else:
            n_ops += n_list * (length // 2)
        k += 1
    return n_bytes, n_ops * n_batch


def rate0_mask(m_len, gen, dev):
    """A random mask with all-frozen (rate-0) runs at every aligned span
    from 2 to M/2, which K6 skips whole."""
    import torch

    mask = (torch.rand(m_len, generator=gen, device=dev) < 0.5).to(torch.uint8)
    span = 2
    while span <= m_len // 2:
        n_nodes = m_len // span
        pick = torch.randperm(n_nodes, generator=gen, device=dev)[: max(1, n_nodes // 16)]
        mask.view(n_nodes, span)[pick] = 1
        span *= 2
    return mask


def rate0_shares(calls):
    """Per K6 call (llr, mask, ...): the share of the chunk's leaves inside
    all-frozen aligned nodes of span 32 (K6 skips them with no f/g and no
    register leaf) and of span 2 (every rate-0 subtree it skips at some
    level)."""
    def share(mask, span):
        return float(mask.reshape(-1, span).bool().all(1).float().mean())

    return {"rate0_leaf_share_span32": [share(c[1], 32) for c in calls],
            "rate0_leaf_share_span2": [share(c[1], 2) for c in calls]}


def check_k6_masks(family, gen, dev):
    """K6 of `family` against its plain version at chunks 64, 2048 and
    8192, on a mask with rate-0 runs at every span, an all-frozen and an
    all-free chunk. Returns the largest |difference| (0)."""
    import torch

    from polar_codes_torch.ops import large_kernel as lk

    err = 0.0
    for m_len in (64, CHUNK_SC, 4 * CHUNK_SC):
        x = torch.randn((B_SHAPES, m_len), generator=gen, device=dev) * 2.0 + 0.5
        if family == "char":
            x = torch.clamp(torch.round(x * AMPL), -127, 127)
        masks = {"rate-0 runs": rate0_mask(m_len, gen, dev),
                 "all frozen": torch.ones(m_len, dtype=torch.uint8, device=dev),
                 "all free": torch.zeros(m_len, dtype=torch.uint8, device=dev)}
        for name, mask in masks.items():
            for got, want in zip(lk.masked_sc_chunk(x, mask, family),
                                 lk.masked_sc_chunk_plain(x, mask, family)):
                err = max(err, _equal(f"K6 {family}, chunk {m_len}, {name}", got, want))
    return err


def check_k7_ties(family, mask, sub_cls, gen, dev):
    """K7 of `family` against its plain version at L = 2..32, with and
    without sub-blocks, on integer LLRs in [-2, 2] (ties, signed zeros)
    and integer metrics, half the rows with one live path and the others
    with 0 to L - 1 at random slots. Returns the largest metric
    |difference|."""
    import torch

    from polar_codes_torch.ops import large_kernel as lk

    err = 0.0
    m_len = mask.numel()
    for n_list in lk.SCL_LISTS:
        for cls in (sub_cls, None):
            x = torch.randint(-2, 3, (B_SHAPES, n_list, m_len), generator=gen,
                              device=dev).to(torch.float32)
            met = torch.randint(-3, 1, (B_SHAPES, n_list), generator=gen,
                                device=dev).to(torch.float32)
            met[::2, 1:] = NEG  # half the rows start with one live path
            met[::2, 0] = 0.0
            # the other half: 0 to L - 1 live paths at random slots
            n_live = torch.randint(0, n_list, (B_SHAPES, 1), generator=gen, device=dev)
            slot = torch.rand((B_SHAPES, n_list), generator=gen, device=dev).argsort(1)
            met[1::2] = torch.where((slot >= n_live)[1::2], NEG, met[1::2])
            where = f"K7 {family} on ties, L={n_list}, sub-blocks {cls is not None}"
            bits, perm, m_out = lk.masked_scl_chunk(x, mask, met, cls, family)
            pb, pp, pm = lk.masked_scl_chunk_plain(x, mask, met, cls, family)
            _equal(where + " bits", bits, pb)
            _equal(where + " perm", perm, pp)
            if family == "char":
                err = max(err, _equal(where + " metrics", m_out, pm))
            else:
                torch.testing.assert_close(m_out, pm, rtol=TOL, atol=TOL)
                err = max(err, max_err(m_out, pm))
    return err


def run_slice3(card):
    """Phases 13-17. Returns {"kernels": [...], "launches": {...}}."""
    import torch

    from polar_codes_torch.construction import frozen_bits
    from polar_codes_torch.dsp import Awgn, Bpsk
    from polar_codes_torch.models.detectors import CRC16
    from polar_codes_torch.models.encoder import PolarEncoder
    from polar_codes_torch.models.large import _MIXED, LargeSCDecoder, LargeSCLDecoder
    from polar_codes_torch.ops import large_kernel as lk
    from polar_codes_torch.ops import scl_kernel_bl
    from polar_codes_torch.utils.timing import time_cuda

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED3)
    modem = Bpsk()

    def channel(encoder, ebn0_db, n_blocks):
        """(sent info with its CRC, channel LLRs) of n random blocks."""
        k_len = encoder.info_length
        info = torch.randint(0, 2, (n_blocks, k_len), generator=gen, device=dev,
                             dtype=torch.uint8)
        chan = Awgn()
        chan.set_esn0_linear(10.0 ** (ebn0_db / 10.0) * k_len / encoder.block_length)
        llr = modem.demodulate(chan.transmit(modem.modulate(encoder.encode(info)), gen))
        sent = encoder.detector.generate(info) if encoder.detector.tail_bits else info
        return sent, llr

    def reset_counts():
        lk.LAUNCHES.update(sc=0, scl=0)
        scl_kernel_bl.LAUNCHES.update(float32=0, char=0, bfloat16=0)

    def counts():
        torch.cuda.synchronize()
        return {"masked_sc_chunk": lk.LAUNCHES["sc"], "masked_scl_chunk": lk.LAUNCHES["scl"],
                "scl_subtree": scl_kernel_bl.LAUNCHES["float32"]}

    f_sc = frozen_bits(N_SC, K_SC, 0.0, "BB")
    enc_sc = PolarEncoder(N_SC, f_sc, systematic=True, device=dev)
    sc = LargeSCDecoder(N_SC, f_sc, chunk=CHUNK_SC, device=dev)
    sc_plain = LargeSCDecoder(N_SC, f_sc, chunk=CHUNK_SC, device=dev,
                              chunk_fn=lk.masked_sc_chunk_plain)
    det = CRC16()
    f_scl = frozen_bits(N_SCL, K_SCL, 0.0, "BB")
    enc_scl = PolarEncoder(N_SCL, f_scl, systematic=True, detector=det, device=dev)
    scl_kw = dict(list_size=LIST, detector=det, chunk=CHUNK_SCL, subblock=SUB,
                  carry_dtype=torch.bfloat16, device=dev)
    scl = LargeSCLDecoder(N_SCL, f_scl, **scl_kw)
    scl_plain = LargeSCLDecoder(N_SCL, f_scl, chunk_fn=lk.masked_scl_chunk_plain,
                                subtree_fn=scl_kernel_bl.scl_subtree_plain, **scl_kw)
    mixed_sc = int((sc.classes == _MIXED).sum())
    mixed_scl = int((scl.classes == _MIXED).sum())
    pure_scl = scl.n_chunks - mixed_scl

    # 13 ------------------------------------------------------------------
    phase("13 K6 masked_sc_chunk vs plain, call by call")
    sent_sc, llr_sc = channel(enc_sc, EBN0_SC, B3)
    k6_calls = []

    def record6(x, mask, family):
        out = lk.masked_sc_chunk(x, mask, family)
        k6_calls.append((x, mask, out))
        return out

    LargeSCDecoder(N_SC, f_sc, chunk=CHUNK_SC, device=dev, chunk_fn=record6).decode(llr_sc)
    torch.cuda.synchronize()
    if len(k6_calls) != mixed_sc:
        raise AssertionError(f"expected {mixed_sc} K6 calls, got {len(k6_calls)}")
    k6_err = 0.0
    k6_held = spread(k6_calls, [])
    for x, mask, (kx, ku) in k6_held:
        px, pu = lk.masked_sc_chunk_plain(x, mask)
        k6_err = max(k6_err, _equal("K6 x", kx, px), _equal("K6 u", ku, pu))
    print(f"K6: {len(k6_held)} of {len(k6_calls)} calls bit-equal (x and u)")

    # 14 ------------------------------------------------------------------
    phase("14 K7 masked_scl_chunk vs plain, call by call")
    sent_scl, llr_scl = channel(enc_scl, EBN0_DB, B3)
    k7_calls = []

    def record7(x, mask, metrics, sub_cls, family):
        out = lk.masked_scl_chunk(x, mask, metrics, sub_cls, family)
        k7_calls.append((x, mask, metrics, sub_cls, out))
        return out

    LargeSCLDecoder(N_SCL, f_scl, chunk_fn=record7, **scl_kw).decode(llr_scl)
    torch.cuda.synchronize()
    if len(k7_calls) != mixed_scl:
        raise AssertionError(f"expected {mixed_scl} K7 calls, got {len(k7_calls)}")
    every = [i for i, c in enumerate(k7_calls) if len(set(c[3].tolist())) == 5]
    if CHUNK_SCL // SUB >= 5 and not every:
        raise AssertionError("no K7 call has every sub-block class")
    k7_held = spread(k7_calls, every[:1])
    k7_err = 0.0
    for x, mask, metrics, sub_cls, (bits, perm, met) in k7_held:
        pb, pp, pm = lk.masked_scl_chunk_plain(x, mask, metrics, sub_cls)
        _equal("K7 bits", bits, pb)
        _equal("K7 perm", perm, pp)
        if not torch.isfinite(met).all():
            raise AssertionError("K7 metrics not finite")
        torch.testing.assert_close(met, pm, rtol=TOL, atol=TOL)
        k7_err = max(k7_err, max_err(met, pm))
    print(f"K7: {len(k7_held)} of {len(k7_calls)} calls equal (bits, perms; metrics "
          f"max |d| {k7_err}), {len(every)} calls with every sub-block class")
    # the shapes the main path does not give: other list sizes, the per-bit
    # walk without sub-blocks, other chunk spans of K6
    _, mask7, _, sub7, _ = k7_calls[every[0] if every else 0]
    for n_list in (2, 4, 16, 32):
        for sub_cls in (sub7, None):
            x = torch.randn((B_SHAPES, n_list, CHUNK_SCL), generator=gen, device=dev) + 0.5
            met = torch.randn((B_SHAPES, n_list), generator=gen, device=dev)
            met[::2, 1:] = NEG  # half the rows start with one live path
            met[::2, 0] = 0.0
            bits, perm, m_out = lk.masked_scl_chunk(x, mask7, met, sub_cls)
            pb, pp, pm = lk.masked_scl_chunk_plain(x, mask7, met, sub_cls)
            _equal(f"K7 bits, L={n_list}", bits, pb)
            _equal(f"K7 perm, L={n_list}", perm, pp)
            torch.testing.assert_close(m_out, pm, rtol=TOL, atol=TOL)
            k7_err = max(k7_err, max_err(m_out, pm))
    for m_len in (64, CHUNK_SC // 2, 4 * CHUNK_SC):
        x = torch.randn((B_SHAPES, m_len), generator=gen, device=dev) * 2.0 + 0.5
        mask = (torch.rand(m_len, generator=gen, device=dev) < 0.5).to(torch.uint8)
        kx, ku = lk.masked_sc_chunk(x, mask)
        px, pu = lk.masked_sc_chunk_plain(x, mask)
        k6_err = max(k6_err, _equal(f"K6 x, chunk {m_len}", kx, px),
                     _equal(f"K6 u, chunk {m_len}", ku, pu))
    print(f"K7 at L in (2, 4, 16, 32), with and without sub-blocks, and K6 at chunks "
          f"64, {CHUNK_SC // 2}, {4 * CHUNK_SC}: equal to their plain versions")
    # the redesign's branches: K6's rate-0 skips, K7's rank prune on ties
    # and its re-take rule on rows with one live path
    k6_err = max(k6_err, check_k6_masks("float32", gen, dev))
    k7_err = max(k7_err, check_k7_ties("float32", mask7, sub7, gen, dev))
    print("K6 float32 on rate-0 runs, all-frozen and all-free chunks; K7 float32 on "
          "integer LLRs at L in (2, 4, 8, 16, 32): equal to their plain versions")

    # 15, 16 --------------------------------------------------------------
    phase("15 large-N paths end to end; 16 launch counts")
    reset_counts()
    sc_batches = [(sent_sc, llr_sc)] + [channel(enc_sc, EBN0_SC, B3)
                                        for _ in range(BATCHES3 - 1)]
    sc_outs = [sc.decode(llr) for _, llr in sc_batches]
    launches_sc = counts()
    sc_wrong = sum(int((o[0] != s_).any(1).sum()) for o, (s_, _) in zip(sc_outs, sc_batches))
    _same_decisions("large SC batch 0", sc_outs[0], sc_plain.decode(sc_batches[0][1]))
    clean = 4.0 * modem.modulate(enc_sc.encode(sent_sc))
    if not torch.equal(sc.decode(clean)[0], sent_sc):
        raise AssertionError(f"N={N_SC} noiseless round trip lost info bits")
    emit({"metric": "bler", "path": f"large_sc_n{N_SC}", "value": sc_wrong / (B3 * BATCHES3),
          "blocks": B3 * BATCHES3, "block_errors": sc_wrong, "ebn0_db": EBN0_SC})
    reset_counts()
    scl_res = {}
    scl_batches = {}
    for ebn0 in (EBN0_DB, EBN0_LOW):
        batches = ([(sent_scl, llr_scl)] if ebn0 == EBN0_DB else []) + [
            channel(enc_scl, ebn0, B3) for _ in range(BATCHES3 - (ebn0 == EBN0_DB))]
        scl_batches[ebn0] = batches
        scl_res[ebn0] = [scl.decode(llr) for _, llr in batches]
    launches_scl = counts()
    for ebn0, batches in scl_batches.items():
        outs = scl_res[ebn0]
        wrong = fails = 0
        for (s_, _), o in zip(batches, outs):
            bad = (o[0] != s_).any(1)
            if (~o[2] & ~bad).any():
                raise AssertionError("a block with a failed CRC decoded right")
            wrong += int(bad.sum())
            fails += int((~o[2]).sum())
        emit({"metric": "bler", "path": f"large_cascl8_n{N_SCL}", "value": wrong / (B3 * BATCHES3),
              "blocks": B3 * BATCHES3, "block_errors": wrong, "crc_failures": fails,
              "ebn0_db": ebn0})
        if ebn0 == EBN0_LOW and fails == 0:
            raise AssertionError(f"no CRC failure at {EBN0_LOW} dB: the fallback is not driven")
        got, want = outs[0], scl_plain.decode(batches[0][1])
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            diff = ((got[0] != want[0]).any(1) | (got[1] != want[1]).any(1) | (got[2] != want[2]))
            for blk in torch.nonzero(diff).flatten().tolist():
                _check_tie(scl, scl_plain, batches[0][1][blk : blk + 1], ebn0, blk)
    clean = 4.0 * modem.modulate(enc_scl.encode(sent_scl))
    if not torch.equal(scl.decode(clean)[0], sent_scl):
        raise AssertionError(f"N={N_SCL} noiseless round trip lost info bits")
    print("large SC and CA-SCL-8: kernel decodes == plain decodes on one batch each; "
          "noiseless round trips exact")
    n_sc, n_scl = BATCHES3, 2 * BATCHES3
    by_path = {"large_sc": launches_sc, "large_scl": launches_scl}
    emit({"launches": by_path, "decodes": {"large_sc": n_sc, "large_scl": n_scl},
          "per_decode_expected": {"masked_sc_chunk": mixed_sc, "masked_scl_chunk": mixed_scl,
                                  "scl_subtree": pure_scl}})
    for name, count, want in (("masked_sc_chunk", launches_sc["masked_sc_chunk"], n_sc * mixed_sc),
                              ("masked_scl_chunk", launches_scl["masked_scl_chunk"],
                               n_scl * mixed_scl),
                              ("scl_subtree", launches_scl["scl_subtree"], n_scl * pure_scl)):
        if count != want or count <= 0:
            raise AssertionError(f"{name}: {count} launches, expected {want}")

    # 17 ------------------------------------------------------------------
    phase("17 times (CUDA events, median)")
    k6_ms = [time_cuda(lambda c=c: lk.masked_sc_chunk(c[0], c[1]), reps=REPS) for c in k6_held]
    x0, m0, _ = k6_held[0]
    k6_plain_ms = time_cuda(lambda: lk.masked_sc_chunk_plain(x0, m0), warmup=1, reps=REPS)
    k7_ms = [time_cuda(lambda c=c: lk.masked_scl_chunk(*c[:4]), reps=REPS) for c in k7_held]
    c7 = k7_held[0]
    k7_plain_ms = time_cuda(lambda: lk.masked_scl_chunk_plain(*c7[:4]), warmup=1, reps=REPS)
    sc_ms = time_cuda(lambda: sc.decode(llr_sc), reps=REPS)
    scl_ms = time_cuda(lambda: scl.decode(llr_scl), reps=REPS)
    info_sc = sent_sc
    enc_ms = time_cuda(lambda: enc_sc.encode(info_sc), reps=REPS)
    med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    k6_bytes, k6_ops = k6_work(CHUNK_SC, B3)
    sched7 = lk.scl_chunk_schedule(CHUNK_SCL, SUB).tolist()
    k7_work_all = [k7_work(sched7, c[3].tolist(), LIST, B3) for c in k7_held]
    i7 = k7_ms.index(med(k7_ms))
    emit({"kernel": "masked_sc_chunk", "batch": B3, "chunk": CHUNK_SC,
          "ms_per_call": k6_ms, "plain_ms": k6_plain_ms, **rate0_shares(k6_held), "card": card})
    emit({"kernel": "masked_scl_chunk", "batch": B3, "chunk": CHUNK_SCL, "list": LIST,
          "ms_per_call": k7_ms, "plain_ms": k7_plain_ms, "card": card})
    emit({"metric": "large_sc_decode", "n": N_SC, "batch": B3, "ms": sc_ms,
          "coded_mbps": B3 * N_SC / sc_ms / 1e3, "info_mbps": B3 * K_SC / sc_ms / 1e3,
          "k6_ms_per_decode": med(k6_ms) * mixed_sc, "card": card})
    emit({"metric": "large_cascl8_decode", "n": N_SCL, "batch": B3, "ms": scl_ms,
          "payload_mbps": B3 * (K_SCL - det.tail_bits) / scl_ms / 1e3,
          "k7_ms_per_decode": med(k7_ms) * mixed_scl, "card": card})
    emit({"metric": f"encode_n{N_SC}", "batch": B3, "ms": enc_ms,
          "coded_mbps": B3 * N_SC / enc_ms / 1e3, "card": card})
    kernels = [
        {"name": "masked_sc_chunk[float32]", "route": "cuda",
         "source": "polar_codes_torch/csrc/large_sc_chunk.cu",
         "redesigned": "rate-0 skipping, span-32 nodes in registers",
         "replaces": "polar_codes_tpu/ops/large_kernel.py:253",
         "launches": launches_sc["masked_sc_chunk"], "launches_per_decode": mixed_sc,
         "max_abs_err": k6_err, "ms": med(k6_ms), "plain_ms": k6_plain_ms,
         **bound(k6_bytes, k6_ops), "library_ms": None},
        {"name": "masked_scl_chunk[float32]", "route": "cuda",
         "source": "polar_codes_torch/csrc/large_scl_chunk.cu",
         "redesigned": "warp-synchronous walk, prune by rank",
         "replaces": "polar_codes_tpu/ops/large_kernel.py:149",
         "launches": launches_scl["masked_scl_chunk"], "launches_per_decode": mixed_scl,
         "max_abs_err": k7_err, "ms": k7_ms[i7], "plain_ms": k7_plain_ms,
         **bound(*k7_work_all[i7]), "library_ms": None},
    ]
    return {"kernels": kernels, "launches": launches_scl,
            "k7_l8": (k7_held[i7][:4], k7_ms[i7])}  # phase 42 times this call again


# ---- slice 4: the char (int8) and bf16 families ---------------------------

SEED4 = 20261019


def run_slice4(card):
    """Phases 18-23. Returns {"kernels": [...], "launches": {...}}."""
    import torch

    from polar_codes_torch.construction import frozen_bits
    from polar_codes_torch.dsp import Awgn, Bpsk
    from polar_codes_torch.models.detectors import CRC16, CRC32
    from polar_codes_torch.models.encoder import PolarEncoder
    from polar_codes_torch.models.large import (
        _MIXED, LargeSCDecoder, LargeSCLDecoder, _classify_chunks)
    from polar_codes_torch.models.scan import ScanDecoder
    from polar_codes_torch.models.scl import SCLDecoder
    from polar_codes_torch.ops import large_kernel as lk
    from polar_codes_torch.ops import scan_kernel as sk
    from polar_codes_torch.ops import scl_kernel_bl as kbl
    from polar_codes_torch.utils.timing import time_cuda

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED4)
    modem = Bpsk()

    def channel(encoder, n_blocks):
        """(sent info with its CRC, channel LLRs) of n random blocks at 2 dB."""
        k_len = encoder.info_length
        info = torch.randint(0, 2, (n_blocks, k_len), generator=gen, device=dev,
                             dtype=torch.uint8)
        chan = Awgn()
        chan.set_esn0_linear(10.0 ** (EBN0_DB / 10.0) * k_len / encoder.block_length)
        llr = modem.demodulate(chan.transmit(modem.modulate(encoder.encode(info)), gen))
        det = encoder.detector
        return (det.generate(info) if det.tail_bits else info), llr

    def quantise(llr):
        """The simulator's int8 LLRs: x10, round half to even, clip."""
        return torch.clamp(torch.round(llr * AMPL), -127, 127).to(torch.int8)

    def reset_counts():
        kbl.LAUNCHES.update(float32=0, char=0, bfloat16=0)
        lk.LAUNCHES.update(sc=0, scl=0, sc_char=0, scl_char=0)

    def counts():
        torch.cuda.synchronize()
        return {**{f"scl_subtree[{k}]": v for k, v in kbl.LAUNCHES.items()},
                "masked_sc_chunk[float32]": lk.LAUNCHES["sc"],
                "masked_sc_chunk[char]": lk.LAUNCHES["sc_char"],
                "masked_scl_chunk[float32]": lk.LAUNCHES["scl"],
                "masked_scl_chunk[char]": lk.LAUNCHES["scl_char"]}

    frozen = frozen_bits(N_LEN, K_LEN, 0.0, "BB")
    paths = {  # name: (detector, decoder dtype, channel LLRs -> decoder input)
        "pcsim_p8_int8": (CRC32(), torch.int8, quantise),
        "scl8_bf16": (CRC16(), torch.bfloat16, lambda llr: llr),
    }
    encs, decs, plains = {}, {}, {}
    for name, (det, dtype, _) in paths.items():
        encs[name] = PolarEncoder(N_LEN, frozen, systematic=True, detector=det, device=dev)
        kw = dict(list_size=LIST, detector=det, dtype=dtype, device=dev)
        decs[name] = SCLDecoder(N_LEN, frozen, **kw)
        plains[name] = SCLDecoder(N_LEN, frozen, subtree_fn=kbl.scl_subtree_plain, **kw)

    # 18 ------------------------------------------------------------------
    phase("18 K1 char and bf16 vs plain, call by call")
    k1_calls, k1_err = {}, {"float32": 0.0, "char": 0.0, "bfloat16": 0.0}
    for name, (det, dtype, prep) in paths.items():
        calls = []

        def record(sched, x, m):
            out = kbl.scl_subtree(sched, x, m)
            calls.append((sched, x, m, out))
            return out

        SCLDecoder(N_LEN, frozen, list_size=LIST, detector=det, dtype=dtype, device=dev,
                   subtree_fn=record).decode_packed(prep(channel(encs[name], B2)[1]))
        torch.cuda.synchronize()
        for sched, x, m, (bits, perm, met) in calls:
            fam = kbl.family(x.dtype).name
            pb, pp, pm = kbl.scl_subtree_plain(sched, x, m)
            where = f"K1 {fam} call (offset {sched.node.offset}, w {sched.w_in}->{sched.w_out})"
            _equal(where + " bits", bits, pb)
            _equal(where + " perm", perm, pp)
            if not torch.isfinite(met).all() or met.shape != (B2, sched.w_out):
                raise AssertionError(where + ": metrics not finite or of the wrong shape")
            k1_err[fam] = max(k1_err[fam], _equal(where + " metrics", met, pm))
            print(where + ": bits, perms and metrics equal")
        fams = sorted(kbl.family(c[1].dtype).name for c in calls)
        want = (["char"] * len(calls) if dtype == torch.int8 else
                ["bfloat16"] * (len(calls) - 1) + ["float32"])
        if fams != sorted(want) or len(calls) < 2:
            raise AssertionError(f"{name}: K1 families {fams}, expected {sorted(want)}")
        k1_calls[name] = calls

    # 19 ------------------------------------------------------------------
    phase("19 pcsim -p 8 (int8) and bf16 paths end to end, kernels then plain")
    launches, first = {}, {}
    for name, (det, dtype, prep) in paths.items():
        sent, xs, outs = [], [], []
        reset_counts()
        for _ in range(BATCHES2):
            info, llr = channel(encs[name], B2)
            xs.append(prep(llr))
            sent.append(info)
            outs.append(decs[name].decode(xs[-1]))
        launches[name] = counts()
        wrong_total = fail_total = 0
        for i, x in enumerate(xs):
            _same_decisions(f"{name} batch {i}", outs[i], plains[name].decode(x))
            wrong = (outs[i][0] != sent[i]).any(1)
            if (~outs[i][2] & ~wrong).any():
                raise AssertionError(f"{name}: a block with a failed CRC decoded right")
            wrong_total += int(wrong.sum())
            fail_total += int((~outs[i][2]).sum())
        n_blocks = B2 * BATCHES2
        bler = wrong_total / n_blocks
        emit({"metric": "bler", "path": name, "value": bler, "blocks": n_blocks,
              "block_errors": wrong_total, "crc_failures": fail_total, "ebn0_db": EBN0_DB})
        if not 1e-4 <= bler <= 5e-2:
            raise AssertionError(f"{name}: BLER {bler} outside [1e-4, 5e-2]")
        cpu = SCLDecoder(N_LEN, frozen, list_size=LIST, detector=det, dtype=dtype,
                         device="cpu")
        for a, b in zip(outs[0], cpu.decode(xs[0][:64].cpu())):
            if not torch.equal(a[:64].cpu(), b):
                raise AssertionError(f"{name}: card decode differs from the CPU decode")
        first[name] = xs[0]
        print(f"{name}: kernel decodes == plain decodes on all {BATCHES2} batches; "
              "first 64 == CPU decode")

    # 20 ------------------------------------------------------------------
    phase("20 K6 char and K7 char vs plain, call by call")
    f_sc = frozen_bits(N_SC, K_SC, 0.0, "BB")
    enc_sc = PolarEncoder(N_SC, f_sc, systematic=True, device=dev)
    sc_kw = dict(dtype=torch.int8, chunk=CHUNK_SC, device=dev)
    sc = LargeSCDecoder(N_SC, f_sc, **sc_kw)
    sc_plain = LargeSCDecoder(N_SC, f_sc, chunk_fn=lk.masked_sc_chunk_plain, **sc_kw)
    det = CRC16()
    f_scl = frozen_bits(N_SCL, K_SCL, 0.0, "BB")
    enc_scl = PolarEncoder(N_SCL, f_scl, systematic=True, detector=det, device=dev)
    scl_kw = dict(list_size=LIST, detector=det, dtype=torch.int8, chunk=CHUNK_SCL,
                  subblock=SUB, carry_dtype=torch.bfloat16, device=dev)
    scl = LargeSCLDecoder(N_SCL, f_scl, **scl_kw)
    scl_plain = LargeSCLDecoder(N_SCL, f_scl, chunk_fn=lk.masked_scl_chunk_plain,
                                subtree_fn=kbl.scl_subtree_plain, **scl_kw)
    if scl.subblock is not None or (scl.classes != _MIXED).any() or (sc.classes != _MIXED).any():
        raise AssertionError("int8 large-N decoders must run every chunk mixed, no sub-blocks")
    sent_sc, llr_sc = channel(enc_sc, B3)
    q_sc = quantise(llr_sc)
    k6_calls, k7_calls = [], []

    def record6(x, mask, family):
        out = lk.masked_sc_chunk(x, mask, family)
        k6_calls.append((x, mask, family, out))
        return out

    def record7(x, mask, metrics, sub_cls, family):
        out = lk.masked_scl_chunk(x, mask, metrics, sub_cls, family)
        k7_calls.append((x, mask, metrics, sub_cls, family, out))
        return out

    LargeSCDecoder(N_SC, f_sc, chunk_fn=record6, **sc_kw).decode(q_sc)
    sent_scl, llr_scl = channel(enc_scl, B3)
    q_scl = quantise(llr_scl)
    LargeSCLDecoder(N_SCL, f_scl, chunk_fn=record7, **scl_kw).decode(q_scl)
    torch.cuda.synchronize()
    if len(k6_calls) != sc.n_chunks or len(k7_calls) != scl.n_chunks:
        raise AssertionError(f"expected {sc.n_chunks} K6 and {scl.n_chunks} K7 calls, got "
                             f"{len(k6_calls)} and {len(k7_calls)}")
    k6_held, k7_held = spread(k6_calls, []), spread(k7_calls, [])
    k6_err = k7_err = 0.0
    for x, mask, fam, (kx, ku) in k6_held:
        px, pu = lk.masked_sc_chunk_plain(x, mask, fam)
        k6_err = max(k6_err, _equal("K6 char x", kx, px), _equal("K6 char u", ku, pu))
    for x, mask, met, sub_cls, fam, (bits, perm, m_out) in k7_held:
        pb, pp, pm = lk.masked_scl_chunk_plain(x, mask, met, sub_cls, fam)
        _equal("K7 char bits", bits, pb)
        _equal("K7 char perm", perm, pp)
        if not torch.isfinite(m_out).all():
            raise AssertionError("K7 char metrics not finite")
        k7_err = max(k7_err, _equal("K7 char metrics", m_out, pm))
    print(f"K6 char: {len(k6_held)} of {len(k6_calls)} calls bit-equal; K7 char: "
          f"{len(k7_held)} of {len(k7_calls)} calls equal (bits, perms, metrics exactly)")
    # the signed-zero rule of the product-form f (K6, K4, K5): integer LLRs
    # in [-2, 2] put zeros into f at every level
    ints = torch.randint(-2, 3, (B3, CHUNK_SC), generator=gen, device=dev).to(torch.float32)
    for fam in ("float32", "char"):
        for got, want in zip(lk.masked_sc_chunk(ints, k6_calls[0][1], fam),
                             lk.masked_sc_chunk_plain(ints, k6_calls[0][1], fam)):
            k6_err = max(k6_err, _equal(f"K6 {fam} on zeros", got, want))
    scan = ScanDecoder(N_LEN, frozen, iterations=2, device=dev)
    xz = torch.randint(-2, 3, (N_LEN, 256), generator=gen, device=dev).to(torch.float32)
    mem0 = torch.zeros((scan.sched.mem_rows, 256), device=dev)
    _equal("K4 betas on zeros", sk.scan_fused(scan.sched, xz, 2),
           sk.scan_fused_plain(scan.sched, xz, 2))
    for got, want in zip(sk.scan_step(scan.sched, xz, mem0),
                         sk.scan_step_plain(scan.sched, xz, mem0)):
        _equal("K5 betas and memory on zeros", got, want)
    print("K6 (both families), K4 and K5 bit-equal on LLRs in [-2, 2]")
    k6_err = max(k6_err, check_k6_masks("char", gen, dev))
    # the chunk whose sub-blocks of SUB have the most classes
    codes, mask7 = max(((_classify_chunks(list(c[1].cpu().numpy().reshape(-1, SUB))), c[1])
                        for c in k7_calls), key=lambda cm: len(set(cm[0].tolist())))
    sub7 = torch.as_tensor(codes, dtype=torch.int32, device=dev)
    k7_err = max(k7_err, check_k7_ties("char", mask7, sub7, gen, dev))
    print("K6 char on rate-0 runs, all-frozen and all-free chunks; K7 char on integer "
          "LLRs at L in (2, 4, 8, 16, 32), with and without sub-blocks: equal to their "
          "plain versions")

    # 21, 22 --------------------------------------------------------------
    phase("21 int8 large-N paths end to end; 22 launch counts")
    for name, dec, dec_plain, enc, first_batch in (
            ("large_sc_int8", sc, sc_plain, enc_sc, (sent_sc, q_sc)),
            ("large_scl_int8", scl, scl_plain, enc_scl, (sent_scl, q_scl))):
        batches = [first_batch] + [(s_, quantise(l_)) for s_, l_ in
                                   (channel(enc, B3) for _ in range(BATCHES3 - 1))]
        reset_counts()
        outs = [dec.decode(q) for _, q in batches]
        launches[name] = counts()
        wrong = fails = 0
        for (s_, _), o in zip(batches, outs):
            bad = (o[0] != s_).any(1)
            if (~o[2] & ~bad).any():
                raise AssertionError(f"{name}: a block with a failed CRC decoded right")
            wrong += int(bad.sum())
            fails += int((~o[2]).sum())
        _same_decisions(f"{name} batch 0", outs[0], dec_plain.decode(batches[0][1]))
        bler = wrong / (B3 * BATCHES3)
        emit({"metric": "bler", "path": name, "value": bler, "blocks": B3 * BATCHES3,
              "block_errors": wrong, "crc_failures": fails, "ebn0_db": EBN0_DB})
        # int8 SC decodes at 2 dB; int8 CA-SCL-8 at N = 32768 does not: its
        # saturating g loses the path metrics' margin (the JAX package's
        # int8 arm gives the same decisions), so only its CRC flags are held
        if name == "large_sc_int8" and bler >= 0.5:
            raise AssertionError(f"{name}: BLER {bler} at {EBN0_DB} dB")
        print(f"{name}: kernel decode == plain decode on one batch")
    emit({"launches": launches, "decodes": {"pcsim_p8_int8": BATCHES2, "scl8_bf16": BATCHES2,
                                            "large_sc_int8": BATCHES3,
                                            "large_scl_int8": BATCHES3}})
    n_bf16 = len(k1_calls["scl8_bf16"])
    want = {  # path: {kernel: launches per decode}; the other counts are 0
        "pcsim_p8_int8": {"scl_subtree[char]": len(k1_calls["pcsim_p8_int8"])},
        "scl8_bf16": {"scl_subtree[float32]": 1, "scl_subtree[bfloat16]": n_bf16 - 1},
        "large_sc_int8": {"masked_sc_chunk[char]": sc.n_chunks},
        "large_scl_int8": {"masked_scl_chunk[char]": scl.n_chunks},
    }
    for name, per in want.items():
        n_dec = BATCHES2 if name in paths else BATCHES3
        for kernel, count in launches[name].items():
            if count != per.get(kernel, 0) * n_dec:
                raise AssertionError(f"{name}: {kernel} launched {count} times, expected "
                                     f"{per.get(kernel, 0) * n_dec}")

    # 23 ------------------------------------------------------------------
    phase("23 times (CUDA events, median)")
    k1_times = {}
    for name, calls in k1_calls.items():
        for sched, x, m, _ in calls:
            fam = kbl.family(x.dtype).name
            kt = time_cuda(lambda: kbl.scl_subtree(sched, x, m), reps=REPS)
            pt = time_cuda(lambda: kbl.scl_subtree_plain(sched, x, m), warmup=1, reps=REPS)
            nb, no = k1_work(sched, B2, x.element_size())
            acc = k1_times.setdefault(fam, [0.0, 0.0, 0, 0])
            if fam != "float32":
                acc[:] = [acc[0] + kt, acc[1] + pt, acc[2] + nb, acc[3] + no]
            emit({"kernel": f"scl_subtree[{fam}]", "path": name, "span": sched.span,
                  "w_in": sched.w_in, "w_out": sched.w_out, "batch": B2, "ms": kt,
                  "plain_ms": pt, "card": card})
    k6_ms = [time_cuda(lambda c=c: lk.masked_sc_chunk(*c[:3]), reps=REPS) for c in k6_held]
    k6_plain_ms = time_cuda(lambda: lk.masked_sc_chunk_plain(*k6_held[0][:3]), warmup=1,
                            reps=REPS)
    k7_ms = [time_cuda(lambda c=c: lk.masked_scl_chunk(*c[:5]), reps=REPS) for c in k7_held]
    k7_plain_ms = time_cuda(lambda: lk.masked_scl_chunk_plain(*k7_held[0][:5]), warmup=1,
                            reps=REPS)
    med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    emit({"kernel": "masked_sc_chunk[char]", "batch": B3, "chunk": CHUNK_SC,
          "ms_per_call": k6_ms, "plain_ms": k6_plain_ms, **rate0_shares(k6_held), "card": card})
    emit({"kernel": "masked_scl_chunk[char]", "batch": B3, "chunk": CHUNK_SCL, "list": LIST,
          "ms_per_call": k7_ms, "plain_ms": k7_plain_ms, "card": card})
    for name, (path_det, _, _) in paths.items():
        ms = time_cuda(lambda: decs[name].decode(first[name]), reps=REPS)
        emit({"metric": f"{name}_decode", "batch": B2, "ms": ms,
              "payload_mbps": B2 * (K_LEN - path_det.tail_bits) / ms / 1e3,
              "k1_ms_per_decode": sum(time_cuda(lambda c=c: kbl.scl_subtree(*c[:3]), reps=REPS)
                                      for c in k1_calls[name]), "card": card})
    sc_ms = time_cuda(lambda: sc.decode(q_sc), reps=REPS)
    scl_ms = time_cuda(lambda: scl.decode(q_scl), reps=REPS)
    emit({"metric": "large_sc_int8_decode", "n": N_SC, "batch": B3, "ms": sc_ms,
          "info_mbps": B3 * K_SC / sc_ms / 1e3, "k6_ms_per_decode": med(k6_ms) * sc.n_chunks,
          "card": card})
    emit({"metric": "large_scl_int8_decode", "n": N_SCL, "batch": B3, "ms": scl_ms,
          "payload_mbps": B3 * (K_SCL - det.tail_bits) / scl_ms / 1e3,
          "k7_ms_per_decode": med(k7_ms) * scl.n_chunks, "card": card})

    i7 = k7_ms.index(med(k7_ms))
    sched7 = lk.scl_chunk_schedule(CHUNK_SCL, 0).tolist()
    kernels = [
        {"name": f"scl_subtree[{fam}]", "route": "cuda",
         "source": "polar_codes_torch/csrc/scl_subtree.cu", "redesigned": K1_DESIGN,
         "replaces": "polar_codes_tpu/ops/scl_kernel_bl.py:876",
         "launches": launches[path][f"scl_subtree[{fam}]"],
         "launches_per_decode": want[path][f"scl_subtree[{fam}]"],
         "max_abs_err": k1_err[fam], "ms": k1_times[fam][0], "plain_ms": k1_times[fam][1],
         **bound(k1_times[fam][2], k1_times[fam][3]), "library_ms": None}
        for fam, path in (("char", "pcsim_p8_int8"), ("bfloat16", "scl8_bf16"))]
    kernels += [
        {"name": "masked_sc_chunk[char]", "route": "cuda",
         "source": "polar_codes_torch/csrc/large_sc_chunk.cu",
         "redesigned": "rate-0 skipping, span-32 nodes in registers",
         "replaces": "polar_codes_tpu/ops/large_kernel.py:253",
         "launches": launches["large_sc_int8"]["masked_sc_chunk[char]"],
         "launches_per_decode": sc.n_chunks, "max_abs_err": k6_err, "ms": med(k6_ms),
         "plain_ms": k6_plain_ms, **bound(*k6_work(CHUNK_SC, B3)), "library_ms": None},
        {"name": "masked_scl_chunk[char]", "route": "cuda",
         "source": "polar_codes_torch/csrc/large_scl_chunk.cu",
         "redesigned": "warp-synchronous walk, prune by rank",
         "replaces": "polar_codes_tpu/ops/large_kernel.py:149",
         "launches": launches["large_scl_int8"]["masked_scl_chunk[char]"],
         "launches_per_decode": scl.n_chunks, "max_abs_err": k7_err, "ms": k7_ms[i7],
         "plain_ms": k7_plain_ms, **bound(*k7_work(sched7, [], LIST, B3)), "library_ms": None},
    ]
    return {"kernels": kernels, "launches": launches["scl8_bf16"]}


# ---- the warp-per-codeword K1: every list size, ties, small batches ------

SEED6 = 20261020
K1_DESIGN = "a warp per codeword, list state in shared memory"
K1_BATCHES = (1, 181, 2048)  # one codeword, the adaptive rerun's rows, the paths' batch
K1_LISTS = (2, 4, 8, 16, 32)


def run_k1_shapes(card):
    """Phase 24. K1 in every family against its plain version: every
    subtree call of N = 1024 CA-SCL decodes at L in K1_LISTS and B in
    K1_BATCHES on integer LLRs in [-2, 2] (ties, signed zeros), those calls'
    subtrees entered at w_in = L / 2, and one-leaf schedules of every leaf
    kind (rate-0, rate-1, rep, SPC at span 256 with rows of one live path,
    as the large-N pure chunks; ENUM at span 8; rate-1 at span 1); bits,
    perms and metrics equal. Then K1's two N = 1024 CA-SCL-8 calls timed at
    B = 181 and B = 2048, and at B = 2048 with 1, 2 and 4 codewords a block,
    and the one-leaf span-256 schedules of the large-N pure chunks at B3.
    Returns the largest metric difference per family (0)."""
    import numpy as np
    import torch

    from polar_codes_torch.construction import frozen_bits
    from polar_codes_torch.models.detectors import CRC16
    from polar_codes_torch.models.scl import SCLDecoder
    from polar_codes_torch.models.tree import CodeNode, NodeKind
    from polar_codes_torch.ops import scl_kernel_bl as kbl
    from polar_codes_torch.ops.large_kernel import _sub_leaf
    from polar_codes_torch.utils.timing import time_cuda

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED6)
    frozen = frozen_bits(N_LEN, K_LEN, 0.0, "BB")
    err = {"float32": 0.0, "char": 0.0, "bfloat16": 0.0}
    checked = 0

    def hold(where, sched, x, m):
        nonlocal checked
        got = kbl.scl_subtree(sched, x, m)
        want = kbl.scl_subtree_plain(sched, x, m)
        fam = kbl.family(x.dtype).name
        _equal(where + " bits", got[0], want[0])
        _equal(where + " perm", got[1], want[1])
        if not torch.isfinite(got[2]).all():
            raise AssertionError(where + ": metrics not finite")
        err[fam] = max(err[fam], _equal(where + " metrics", got[2], want[2]))
        checked += 1

    def ints(shape, dtype):
        return torch.randint(-2, 3, shape, generator=gen, device=dev).to(dtype)

    states = {torch.float32: torch.float32, torch.int8: torch.int16,
              torch.bfloat16: torch.bfloat16}
    for n_list in K1_LISTS:
        for dtype, state in states.items():
            for n_batch in K1_BATCHES:
                calls = []

                def record(sched, x, m):
                    calls.append((sched, x, m))
                    return kbl.scl_subtree_plain(sched, x, m)

                SCLDecoder(N_LEN, frozen, list_size=n_list, detector=CRC16(), dtype=dtype,
                           device=dev, subtree_fn=record).decode_packed(
                    ints((n_batch, N_LEN), dtype))
                for sched, x, m in calls:
                    hold(f"K1 {kbl.family(x.dtype).name} L={n_list} B={n_batch} span "
                         f"{sched.span} at {sched.node.offset}, w {sched.w_in}", sched, x, m)
                if n_batch != 181:
                    continue
                for sched, x, m in calls[:2]:  # entered at w_in = L / 2
                    half = kbl.build_schedule(sched.node, max(1, n_list // 2), n_list)
                    mh = torch.randint(-3, 1, (n_batch, half.w_in), generator=gen,
                                       device=dev).to(torch.float32)
                    hold(f"K1 L={n_list} w_in {half.w_in}", half,
                         ints((half.w_in, half.span, n_batch), state), mh)
                leaves = [_sub_leaf(k, 256) for k in
                          (NodeKind.RATE0, NodeKind.RATE1, NodeKind.REP, NodeKind.SPC)]
                leaves += [CodeNode(0, 8, np.array([0, 1, 2, 4, 5]), NodeKind.ENUM),
                           CodeNode(0, 1, np.zeros(0, np.int64), NodeKind.RATE1)]
                for node in leaves:
                    one = kbl.build_schedule(node, n_list, n_list)
                    m1 = torch.randint(-3, 1, (n_batch, n_list), generator=gen,
                                       device=dev).to(torch.float32)
                    m1[::2, 1:] = NEG  # every other row: one live path
                    hold(f"K1 L={n_list} one leaf {node.kind.value} span {node.length}", one,
                         ints((n_list, node.length, n_batch), state), m1)
    torch.cuda.synchronize()
    emit({"k1_checked_calls": checked, "max_abs_err": err})
    print(f"K1: {checked} calls equal to the plain version (bits, perms, metrics) at L in "
          f"{K1_LISTS}, B in {K1_BATCHES}, every family and leaf kind")

    # K1's two calls of one N = 1024 CA-SCL-8 decode, at B = 181 and 2048
    calls = []

    def record8(sched, x, m):
        calls.append((sched, x, m))
        return kbl.scl_subtree(sched, x, m)

    llr = torch.randn((B2, N_LEN), generator=gen, device=dev) * 1.5 + 1.0
    SCLDecoder(N_LEN, frozen, list_size=LIST, detector=CRC16(), device=dev,
               subtree_fn=record8).decode_packed(llr)
    rows = {}
    for n_batch in (181, B2):
        part = [(s, x[..., :n_batch].contiguous(), m[:n_batch].contiguous())
                for s, x, m in calls]
        rows[n_batch] = [time_cuda(lambda c=c: kbl.scl_subtree(*c), reps=REPS) for c in part]
    one_leaf = {}  # the large-N pure chunks: one leaf of span 256 at B = 128, L = 8
    for kind in (NodeKind.RATE0, NodeKind.RATE1, NodeKind.REP, NodeKind.SPC):
        sched = kbl.build_schedule(_sub_leaf(kind, 256), LIST, LIST)
        x = torch.randn((LIST, 256, B3), generator=gen, device=dev) * 2.0 + 1.0
        m = torch.randn((B3, LIST), generator=gen, device=dev) * 10.0
        one_leaf[kind.value] = time_cuda(lambda: kbl.scl_subtree(sched, x, m), reps=REPS)
    per_block = {}
    for pb in (1, 2, 4):
        kbl.PER_BLOCK = pb
        per_block[pb] = [time_cuda(lambda c=c: kbl.scl_subtree(*c), reps=REPS) for c in calls]
    kbl.PER_BLOCK = 0
    emit({"kernel": "scl_subtree[float32]", "path": "N=1024 CA-SCL-8, both calls",
          "spans": [c[0].span for c in calls], "w": [[c[0].w_in, c[0].w_out] for c in calls],
          "ms_b181": rows[181], "ms_b2048": rows[B2],
          "ratio_b181_b2048": sum(rows[181]) / sum(rows[B2]),
          "ms_b2048_by_codewords_per_block": per_block,
          f"one_leaf_span256_b{B3}_ms": one_leaf, "card": card})
    return err


# ---- the redesigned K4 and K5: lengths, batches, sweeps, layouts --------

SEED7 = 20261021
SCAN_DESIGN = "a warp per one or two codewords, no block barrier, leaf ops folded away"
SCAN_LENGTHS = (4, 64, 1024, 2048, 4096)
SCAN_BATCHES = (1, 3, 181, 2048)
SCAN_SWEEPS = (1, 2, 4, 8)
SCAN_LAYOUTS = ((8, 1), (4, 2))  # (warps a block, codewords a warp)
BURST = 10  # back-to-back calls a timed sample


def run_scan_shapes(card):
    """Phase 25. K4 and K5 against their plain versions on Bhattacharyya
    codes at rate 1/2 of every length in SCAN_LENGTHS, B in SCAN_BATCHES,
    Gaussian and integer LLRs (ties, signed zeros). The reference is the
    plain K5 chained over 8 sweeps from zero memory: after s steps its
    betas are scan_fused_plain's over s sweeps (the same per-element
    operations; tests/test_torch_scan.py), so K4 at each of SCAN_SWEEPS in
    each memory placement that fits and K5 step by step (on its own
    memory) are held to it, betas and memory bit for bit. B = 3 and 181
    again at each of SCAN_LAYOUTS (8 codewords a block: idle warps, and
    lanes of codewords past the batch). Then SCAN and FastSSCAN decodes
    against decodes by the plain versions, and the times. Returns the
    largest difference per kernel name (0)."""
    import torch

    from polar_codes_torch.construction import frozen_bits
    from polar_codes_torch.dsp import Awgn, Bpsk
    from polar_codes_torch.models.detectors import CRC32
    from polar_codes_torch.models.encoder import PolarEncoder
    from polar_codes_torch.models.scan import FastSScanDecoder, ScanDecoder
    from polar_codes_torch.ops import _build
    from polar_codes_torch.ops import scan_kernel as sk
    from polar_codes_torch.utils.timing import time_cuda

    dev = torch.device(DEVICE)
    lib = _build.load("scan_sweep")
    gen = torch.Generator(device=dev).manual_seed(SEED7)
    err = {"scan_fused": 0.0, "scan_step": 0.0}
    checked = {"scan_fused": 0, "scan_step": 0}
    placements = {}

    def hold(name, where, got, want):
        err[name] = max(err[name], _equal(f"{name} {where}", got, want))
        checked[name] += 1

    def fused(sched, x, sweeps, on_chip, **layout):
        return sk.launch_fused(lib, sched, x, sweeps, on_chip, **layout)

    def fitting(sched, **layout):
        """The node-memory placements whose state fits a block at the
        layout; device memory must fit every length, and on chip every
        length where it is the kernel's default."""
        fits = []
        for on_chip in (True, False):
            try:
                fused(sched, torch.zeros((sched.block_length, 1), device=dev), 1, on_chip,
                      **layout)
                fits.append(on_chip)
            except NotImplementedError:
                pass
        want = [True, False] if sk.mem_on_chip(sched) else [False]
        if not set(want) <= set(fits):
            raise AssertionError(f"K4 at N = {sched.block_length}, {layout or 'default layout'}: "
                                 f"placements {fits} lack one of {want}")
        return fits

    for n_len in SCAN_LENGTHS:
        sched = ScanDecoder(n_len, frozen_bits(n_len, n_len // 2, 0.0, "BB"), device=dev).sched
        fits = placements[n_len] = fitting(sched)
        for n_batch in SCAN_BATCHES:
            for kind in ("gauss", "ints"):
                if kind == "ints":
                    x = torch.randint(-2, 3, (n_len, n_batch), generator=gen,
                                      device=dev).to(torch.float32)
                else:
                    x = torch.randn((n_len, n_batch), generator=gen, device=dev) * 1.5 + 0.5
                mem_p = mem_k = torch.zeros((sched.mem_rows, n_batch), device=dev)
                ref = {}
                for step in range(1, max(SCAN_SWEEPS) + 1):
                    mem_in = mem_p
                    beta_p, mem_p = sk.scan_step_plain(sched, x, mem_p)
                    ref[step] = beta_p
                    where = f"N={n_len} B={n_batch} {kind} step {step}"
                    beta_k, mem_k = sk.scan_step(sched, x, mem_k)
                    hold("scan_step", where + " betas", beta_k, beta_p)
                    hold("scan_step", where + " memory", mem_k, mem_p)
                    if step == 2 and n_batch in (3, 181):  # idle warps, lanes past B
                        for per_block, per_warp in SCAN_LAYOUTS:
                            layout = {"per_block": per_block, "per_warp": per_warp}
                            at = f" at {per_warp} a warp, {per_block} warps a block"
                            got = sk.launch_step(lib, sched, x, mem_in, **layout)
                            hold("scan_step", where + at + ", betas", got[0], beta_p)
                            hold("scan_step", where + at + ", memory", got[1], mem_p)
                            for on_chip in fitting(sched, **layout):
                                hold("scan_fused", where + at + f", on chip {on_chip}",
                                     fused(sched, x, step, on_chip, **layout), beta_p)
                for sweeps in SCAN_SWEEPS:
                    for on_chip in fits:
                        hold("scan_fused", f"N={n_len} B={n_batch} {kind} {sweeps} sweeps, "
                             f"memory on chip {on_chip}", fused(sched, x, sweeps, on_chip),
                             ref[sweeps])
    torch.cuda.synchronize()
    emit({"scan_checked_calls": checked, "max_abs_err": err,
          "k4_placements": {n: ["on chip" if p else "device memory" for p in fits]
                            for n, fits in placements.items()},
          "k4_default_on_chip": {n: sk.mem_on_chip(ScanDecoder(
              n, frozen_bits(n, n // 2, 0.0, "BB"), device=dev).sched) for n in SCAN_LENGTHS}})
    print(f"K4 and K5: {checked} calls bit-equal to the plain versions at N in "
          f"{SCAN_LENGTHS}, B in {SCAN_BATCHES}, sweeps {SCAN_SWEEPS}")

    det = CRC32()
    frozen = frozen_bits(N_LEN, K_LEN, 0.0, "BB")
    enc = PolarEncoder(N_LEN, frozen, systematic=True, detector=det, device=dev)
    chan = Awgn()
    chan.set_esn0_linear(10.0 ** (EBN0_DB / 10.0) * K_LEN / N_LEN)
    info = torch.randint(0, 2, (B2, K_LEN), generator=gen, device=dev, dtype=torch.uint8)
    sent = det.generate(info)
    llr = Bpsk().demodulate(chan.transmit(Bpsk().modulate(enc.encode(info)), gen))
    scan = ScanDecoder(N_LEN, frozen, detector=det, iterations=SWEEPS, device=dev)
    fss = FastSScanDecoder(N_LEN, frozen, detector=det, iterations=SWEEPS, device=dev)
    blers = {}
    for name, dec, plain in (
            ("scan4", scan, ScanDecoder(N_LEN, frozen, detector=det, iterations=SWEEPS,
                                        device=dev, fused_fn=sk.scan_fused_plain)),
            ("fastsscan4", fss, FastSScanDecoder(N_LEN, frozen, detector=det,
                                                 iterations=SWEEPS, device=dev,
                                                 step_fn=sk.scan_step_plain))):
        got = dec.decode(llr)
        _same_decisions(f"{name} decode", got, plain.decode(llr))
        blers[name] = float((got[0] != sent).any(1).float().mean())
    emit({"metric": "bler", "path": "scan_phase25", "value": blers, "blocks": B2,
          "ebn0_db": EBN0_DB})
    if not all(v < 0.5 for v in blers.values()):
        raise AssertionError(f"SCAN BLER not below 0.5: {blers}")
    print("SCAN and FastSSCAN decodes equal to decodes by the plain versions")

    def burst(fn):
        """Milliseconds a call of fn within BURST back-to-back calls: the
        device time, where one call alone also shows the host's launch."""
        return time_cuda(lambda: [fn() for _ in range(BURST)], reps=REPS) / BURST

    sched = scan.sched
    flat = scan._flat(llr)
    times = {}
    for n_batch in (181, B2):
        x = flat[:, :n_batch].contiguous()
        mem = sk.scan_step(sched, x, torch.zeros((sched.mem_rows, n_batch), device=dev))[1]
        for name, fn in (("scan_step", lambda: sk.scan_step(sched, x, mem)),
                         ("scan_fused", lambda: sk.scan_fused(sched, x, SWEEPS))):
            times[f"{name}_b{n_batch}_ms"] = time_cuda(fn, reps=REPS)
            times[f"{name}_b{n_batch}_burst_ms"] = burst(fn)
        for on_chip in placements[N_LEN]:
            where = "on_chip" if on_chip else "device_memory"
            times[f"scan_fused_b{n_batch}_mem_{where}_burst_ms"] = burst(
                lambda: fused(sched, x, SWEEPS, on_chip))
    times["scan4_decode_ms"] = time_cuda(lambda: scan.decode(llr), reps=REPS)
    times["fastsscan4_decode_ms"] = time_cuda(lambda: fss.decode(llr), reps=REPS)
    emit({"kernel": "scan_fused, scan_step", "n": N_LEN, "sweeps_fused": SWEEPS,
          "k4_default_on_chip": sk.mem_on_chip(sched), **times, "card": card})
    return err


SEED8 = 20261022
K3_DESIGN = "a warp per codeword, nodes of up to 1024 positions in registers"
K2_DESIGN = "packed bits in registers, shuffles across lanes"
K3_LENGTHS = tuple(2 ** i for i in range(1, 12))  # 2 .. 2048
K3_BATCHES = (1, 3, 181, 2048)
K2_BATCHES = (1, 3, 1024, 4096)


def run_k3_k2_shapes(card):
    """Phase 26. K3 against its plain version on the Bhattacharyya code of
    rate 1/2 at every length in K3_LENGTHS (its whole tree as one call),
    B in K3_BATCHES, Gaussian and integer LLRs in [-2, 2] (REP sums of 0,
    SPC ties, f at zeros; in float32 also values of magnitude 1e8 and 1,
    whose REP sums depend on the order; in char -128 and +-127), both families,
    both output forms; K2 at the same lengths, B in K2_BATCHES, systematic
    or not, on random bits with the frozen positions set too; all bit for
    bit. The kernel takes one layout (a warp per codeword, 8 a block), so
    every shape runs it. Then K3's root call of the (1024, 512) code at
    B = 181 and 2048 and K2 at B = 1024, alone and within a burst. Returns
    {"err": largest difference per kernel name (0), "burst_ms": per
    kernel name at the paths' batch}."""
    import torch

    from polar_codes_torch.construction import frozen_bits
    from polar_codes_torch.models.tree import build_tree
    from polar_codes_torch.ops import butterfly_kernel as bk
    from polar_codes_torch.ops import fastssc_kernel as fk
    from polar_codes_torch.utils.timing import time_cuda

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED8)
    names = {torch.float32: "fastssc_subtree[float32]", torch.int8: "fastssc_subtree[int8]"}
    err = dict.fromkeys([*names.values(), "butterfly_encode"], 0.0)
    checked = dict.fromkeys(err, 0)

    def hold(name, where, got, want):
        err[name] = max(err[name], _equal(f"{name} {where}", got, want))
        checked[name] += 1

    def llrs(n_len, n_batch, dtype):
        gauss = torch.randn((n_len, n_batch), generator=gen, device=dev) * 2.0 + 0.5
        ints = torch.randint(-2, 3, (n_len, n_batch), generator=gen, device=dev)
        if dtype == torch.float32:
            sign = torch.randint(0, 2, (n_len, n_batch), generator=gen, device=dev) * 2 - 1
            far = torch.tensor([1e8, -1e8, 1.0, -0.5, 0.25, -3.0], device=dev)
            order = far[torch.randint(0, 6, (n_len, n_batch), generator=gen, device=dev)]
            for col, pattern in enumerate(([1e8, 1.0, -1e8, -0.5],  # -0.5 in order
                                           [1e8] + [1.0] * 31 + [-1e8, -0.5] + [0.0] * 30)):
                if col < n_batch:  # the second: +31 with its halves of 32 swapped
                    order[:, col] = torch.tensor(pattern, device=dev).repeat(n_len)[:n_len]
            return {"gauss": gauss * 10.0, "ints": ints.to(dtype) * sign,  # +-0.0
                    "order": order}  # REP sums that round to another sign in another order
        wide = torch.clamp(torch.round(gauss * 20.0), -128, 127)
        for value, share in ((127, 0.1), (-127, 0.1), (-128, 0.05)):
            wide[torch.rand((n_len, n_batch), generator=gen, device=dev) < share] = value
        return {"gauss": wide.to(dtype), "ints": ints.to(dtype)}

    scheds = {}
    for n_len in K3_LENGTHS:
        frozen = frozen_bits(n_len, n_len // 2, 0.0, "BB")
        sched = scheds[n_len] = fk.build_schedule(build_tree(n_len, frozen))
        for n_batch in K3_BATCHES:
            for dtype, name in names.items():
                for kind, x in llrs(n_len, n_batch, dtype).items():
                    for root in (True, False):
                        hold(name, f"N={n_len} B={n_batch} {kind} root={root}",
                             fk.fastssc_subtree(sched, x, root),
                             fk.fastssc_subtree_plain(sched, x, root))
        mask = torch.zeros(n_len, dtype=torch.uint8, device=dev)
        mask[list(frozen)] = 1
        for n_batch in K2_BATCHES:
            u = torch.randint(0, 2, (n_batch, n_len), generator=gen, device=dev,
                              dtype=torch.uint8)
            for systematic in (True, False):
                hold("butterfly_encode", f"N={n_len} B={n_batch} systematic={systematic}",
                     bk.butterfly_encode(u, mask, systematic),
                     bk.butterfly_encode_plain(u, mask, systematic))
    torch.cuda.synchronize()
    emit({"k3_k2_checked_calls": checked, "max_abs_err": err})
    print(f"K3 and K2: {checked} calls bit-equal to the plain versions at N in "
          f"{K3_LENGTHS[0]}..{K3_LENGTHS[-1]}")

    def burst(fn):
        """Milliseconds a call of fn within BURST back-to-back calls."""
        return time_cuda(lambda: [fn() for _ in range(BURST)], reps=REPS) / BURST

    sched = scheds[N_LEN]
    times, bursts = {}, {}
    for n_batch in (181, B2):
        for dtype, name in names.items():
            x = llrs(N_LEN, n_batch, dtype)["gauss"]
            fn = lambda x=x: fk.fastssc_subtree(sched, x, True)  # noqa: E731
            times[f"{name}_b{n_batch}_ms"] = time_cuda(fn, reps=REPS)
            times[f"{name}_b{n_batch}_burst_ms"] = burst(fn)
            if n_batch == B2:
                bursts[name] = times[f"{name}_b{n_batch}_burst_ms"]
    mask = torch.zeros(N_LEN, dtype=torch.uint8, device=dev)
    mask[list(frozen_bits(N_LEN, K_LEN, 0.0, "BB"))] = 1
    u = torch.randint(0, 2, (BATCH, N_LEN), generator=gen, device=dev, dtype=torch.uint8)
    fn = lambda: bk.butterfly_encode(u, mask, True)  # noqa: E731
    times[f"butterfly_encode_b{BATCH}_ms"] = time_cuda(fn, reps=REPS)
    times[f"butterfly_encode_b{BATCH}_burst_ms"] = bursts["butterfly_encode"] = burst(fn)
    emit({"kernel": "fastssc_subtree, butterfly_encode", "n": N_LEN, **times, "card": card})
    return {"err": err, "burst_ms": bursts}


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


# ---- slice 9: the simulator ------------------------------------------------

B9, CHUNKS9, B9_OPT, CHUNKS9_OPT = 2048, 4, 1024, 2
SIM_COLUMNS = 23


def _sim(argv):
    """Run the port's CLI (sim.cli.main) with argv on this script's device;
    returns (its standard output, its CSV rows)."""
    import contextlib
    import csv
    import io

    from polar_codes_torch.sim import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + _platform())
    out = buf.getvalue()
    print(out, end="", flush=True)
    if rc != 0:
        raise AssertionError(f"sim.cli.main({argv}) returned {rc}")
    path = argv[argv.index("-o") + 1] + f"_{argv[0]}.csv"
    with open(path) as f:
        lines = f.read().splitlines()
    if any(len(line.split(",")) != SIM_COLUMNS for line in lines):
        raise AssertionError(f"{path}: a line without {SIM_COLUMNS} columns")
    return out, list(csv.DictReader(lines))


def _platform():
    return ["--platform", "cpu"] if DEVICE == "cpu" else []


def _job_shares(out):
    """[(wall s, decode share, CMAC share or None)] per job from the CLI's lines."""
    import re

    return [(float(m.group(1)), float(m.group(2)),
             float(m.group(3)) if m.group(3) else None)
            for m in re.finditer(r"wall=([\d.]+)s decode_share=([\d.]+)"
                                 r"(?: cmac_share=([\d.]+))?", out)]


def _counters(row):
    return {k: row[k] for k in ("Runs", "Errors", "BLER", "BER", "RER")}


def run_slice9(card):
    """Phases 29-31: the simulator's CLI on the card. Returns the launch
    counts of its default job for the kernels line."""
    import shutil
    import tempfile

    import torch

    from polar_codes_torch.dsp import Ask
    from polar_codes_torch.ops import butterfly_kernel, scl_kernel_bl
    from polar_codes_torch.ops import fastssc_kernel as fk
    from polar_codes_torch.sim import cli
    from polar_codes_torch.sim.checkpoint import SweepCheckpoint
    from polar_codes_torch.sim.montecarlo import MonteCarlo, chunk_seed

    dev = torch.device(DEVICE)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sim_")
    try:
        def reset_counts():
            butterfly_kernel.LAUNCHES = 0
            scl_kernel_bl.LAUNCHES.update(float32=0, char=0, bfloat16=0)
            fk.LAUNCHES.update(float32=0, int8=0)

        def counts():
            torch.cuda.synchronize()
            return {"butterfly_encode": butterfly_kernel.LAUNCHES,
                    "fastssc_subtree[int8]": fk.LAUNCHES["int8"],
                    "fastssc_subtree[float32]": fk.LAUNCHES["float32"],
                    "scl_subtree[float32]": scl_kernel_bl.LAUNCHES["float32"],
                    "scl_subtree[char]": scl_kernel_bl.LAUNCHES["char"]}

        def coders(argv):
            args = cli.build_parser().parse_args(argv + _platform())
            det = cli.parse_detector(args.error_detection)
            return args, det, cli.make_coders(N_LEN, K_LEN, args, det)

        def rebuild(mc, job_seed, chunk, ebn0):
            """One chunk of a job, drawn by hand from its seed and decoded:
            (info, llr, decoded, ok, counters)."""
            info, llr = mc._make_llr(mc._generator(chunk_seed(job_seed, chunk)),
                                     mc.esn0_linear(ebn0))
            decoded, _, ok = mc.decoder.decode(llr)
            wrong = (decoded != info).any(-1)
            if (~ok & ~wrong).any():
                raise AssertionError("a block whose check failed decoded right")
            c = {k: int(v) for k, v in mc._count(info, decoded, ok).items()}
            return info, llr, decoded, ok, c

        # 29 --------------------------------------------------------------
        phase("29 the simulator's default job: sim.cli single -n 1024 -r 0.5 -l 8, "
              "CRC32, -p 832, -a 10, 1-3 dB")
        base = ["single", "-n", str(N_LEN), "-r", "0.5", "-l", str(LIST)]
        argv = base + ["--snr-min", "1", "--snr-max", "3", "--snr-count", "3",
                       "-w", str(B9 * CHUNKS9 * N_LEN), "--batch", str(B9),
                       "-o", f"{tmp}/sim"]
        reset_counts()
        t0 = time.perf_counter()
        out, rows = _sim(argv)
        wall = time.perf_counter() - t0
        launches = counts()
        shares = _job_shares(out)
        emit({"path": "pcsim_cli_default", "wall_s": wall, "launches": launches,
              "jobs": [{"ebn0_db": float(r["Eb/N0"]), "bler": float(r["BLER"]),
                        "wall_s": w, "decode_share": d, "decode_s": float(r["Time"])}
                       for r, (w, d, _) in zip(rows, shares)], "card": card})
        if len(rows) != 3 or len(shares) != 3:
            raise AssertionError(f"expected 3 CSV rows and job lines, got {len(rows)}")
        blers = [float(r["BLER"]) for r in rows]
        if any(b > a for a, b in zip(blers, blers[1:])):
            raise AssertionError(f"BLER rises with Eb/N0: {blers}")
        if not 1e-4 <= blers[1] <= 5e-2:
            raise AssertionError(f"BLER {blers[1]} at 2 dB outside [1e-4, 5e-2]")
        for r in rows:
            if int(r["Runs"]) != B9 * CHUNKS9 or float(r["RER"]) > float(r["BLER"]):
                raise AssertionError(f"bad row: {r}")
        for name in ("butterfly_encode", "fastssc_subtree[int8]", "scl_subtree[float32]"):
            if launches[name] <= 0:
                raise AssertionError(f"{name} never launched during the simulator's job")

        # a job stopped after 2 of 4 chunks, chunks rebuilt by hand, resumed
        one = base + ["--snr-count", "1", "--snr-max", str(EBN0_DB), "--batch", str(B9)]
        ckpt = f"{tmp}/ckpt.npz"
        _sim(one + ["-w", str(B9 * 2 * N_LEN), "--checkpoint", ckpt, "-o", f"{tmp}/half"])
        cp = SweepCheckpoint(ckpt)
        (job_id,) = cp.state
        st = cp.job_state(job_id)
        args, det, (enc, dec) = coders(one)
        mc = MonteCarlo(enc, dec, batch=B9, amplification=args.amplification)
        by_hand = {"runs": 0, "errors": 0, "biterrors": 0, "reported": 0}
        for chunk in range(2):
            c = rebuild(mc, 0, chunk, EBN0_DB)[4]
            by_hand = {k: by_hand[k] + c[k] for k in by_hand}
        if st["chunks_done"] != 2 or {k: st[k] for k in by_hand} != by_hand:
            raise AssertionError(f"checkpoint {st} differs from the rebuilt chunks {by_hand}")
        print(f"chunks 0-1 rebuilt by hand from their seeds: {by_hand}, as checkpointed")
        stages = {"generate_ms": [], "decode_ms": [], "count_ms": []}
        for chunk in range(2, 2 + REPS):  # one chunk's stages, host clock after a sync
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            info, llr = mc._make_llr(mc._generator(chunk_seed(0, chunk)),
                                     mc.esn0_linear(EBN0_DB))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            decoded, _, ok = dec.decode(llr)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            {k: int(v) for k, v in mc._count(info, decoded, ok).items()}
            t3 = time.perf_counter()
            for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
                stages[key].append(dt * 1e3)
        emit({"chunk_stages": {k: sorted(v)[len(v) // 2] for k, v in stages.items()},
              "chunk_stages_all": stages, "batch": B9, "card": card})
        st.pop("complete")
        st.pop("result")
        cp.update(job_id, st)
        _, (resumed,) = _sim(one + ["-w", str(B9 * 4 * N_LEN), "--checkpoint", ckpt,
                                    "-o", f"{tmp}/resumed"])
        _, (whole,) = _sim(one + ["-w", str(B9 * 4 * N_LEN), "-o", f"{tmp}/whole"])
        if _counters(resumed) != _counters(whole):
            raise AssertionError(f"resumed {_counters(resumed)} != whole {_counters(whole)}")
        emit({"check": "resume", "resumed": _counters(resumed), "uninterrupted":
              _counters(whole)})

        # 30 --------------------------------------------------------------
        phase("30 the new options on the card: cmac32, ask --bps 2, rayleigh, -p 8, "
              "GA and 5G construction")
        opt = ["--snr-count", "1", "--snr-max", str(EBN0_DB), "--batch", str(B9_OPT),
               "-w", str(B9_OPT * CHUNKS9_OPT * N_LEN)]
        jobs = {
            "cmac32_scl8_float32": base + ["-e", "cmac32", "-p", "32"],
            "ask_bps2": ["ask", "-n", str(N_LEN), "-r", "0.5", "-l", str(LIST), "--bps", "2"],
            "rayleigh": base + ["--channel", "rayleigh"],
            "p8_scl8_char": base + ["-p", "8"],
            "construction_ga": base + ["--construction", "GA"],
            "construction_5g": base + ["--construction", "5G"],
        }
        opt_launches = {}
        for name, job in jobs.items():
            reset_counts()
            t0 = time.perf_counter()
            out, (row,) = _sim(job + opt + ["-o", f"{tmp}/{name}"])
            wall = time.perf_counter() - t0
            opt_launches[name] = counts()
            (w, d, cm), = _job_shares(out)
            args, det, (enc, dec) = coders(job + opt)
            mc = MonteCarlo(enc, dec, batch=B9_OPT,
                            amplification=args.amplification if args.precision != 32 else 1.0,
                            channel=args.channel,
                            modem=Ask(2) if args.simtype == "ask" else None)
            _, llr, decoded, ok, _ = rebuild(mc, 0, 0, EBN0_DB)
            args_cpu, det_cpu, (_, dec_cpu) = coders(job + opt + ["--platform", "cpu"])
            got = dec.decode(llr[:64])
            want = dec_cpu.decode(llr[:64].cpu())
            for a, b in zip(got, want):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError(f"{name}: card decode differs from the CPU decode")
            if int(row["Runs"]) != B9_OPT * CHUNKS9_OPT or float(row["RER"]) > float(row["BLER"]):
                raise AssertionError(f"{name}: bad row {row}")
            rec = {"path": name, "bler": float(row["BLER"]), "rer": float(row["RER"]),
                   "wall_s": wall, "job_wall_s": w, "decode_share": d,
                   "launches": opt_launches[name], "card": card}
            if cm is not None:
                rec.update(cmac_share=cm, cmac_engine=det.engine)
            emit(rec)
        need = {"cmac32_scl8_float32": "scl_subtree[float32]", "p8_scl8_char": "scl_subtree[char]",
                "ask_bps2": "fastssc_subtree[int8]", "rayleigh": "fastssc_subtree[int8]",
                "construction_ga": "fastssc_subtree[int8]",
                "construction_5g": "fastssc_subtree[int8]"}
        for name, kernel in need.items():
            if opt_launches[name][kernel] <= 0 or opt_launches[name]["butterfly_encode"] <= 0:
                raise AssertionError(f"{name}: {kernel} or butterfly_encode never launched")
        print("each option's first 64 blocks: card decode == CPU decode")

        # 31 --------------------------------------------------------------
        phase("31 the counter all-reduce in a one-rank process group")
        import socket

        import torch.distributed as dist

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "WORLD_SIZE": "1",
               "RANK": "0", "LOCAL_RANK": "0"}
        os.environ.update(env)
        reduces = []
        all_reduce = dist.all_reduce

        def counted(tensor, *a, **k):
            reduces.append(tensor.device)
            return all_reduce(tensor, *a, **k)

        dist.all_reduce = counted
        try:
            _, (grouped,) = _sim(one + ["-w", str(B9 * 2 * N_LEN), "--devices", "1",
                                        "-o", f"{tmp}/grouped"])
            backend = dist.get_backend()
            dist.destroy_process_group()
        finally:
            dist.all_reduce = all_reduce
            for k in env:
                os.environ.pop(k)
        _, (alone,) = _sim(one + ["-w", str(B9 * 2 * N_LEN), "-o", f"{tmp}/alone"])
        emit({"check": "all_reduce", "backend": backend, "all_reduces": len(reduces),
              "grouped": _counters(grouped), "alone": _counters(alone)})
        if _counters(grouped) != _counters(alone):
            raise AssertionError("the one-rank group's counters differ from the job alone")
        if len(reduces) != 3 or backend != ("nccl" if dev.type == "cuda" else "gloo"):
            raise AssertionError(f"expected 3 {backend} all-reduces (warm-up, 2 chunks), "
                                 f"got {len(reduces)}")
        return {"default": launches, "options": opt_launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- slice 10: the rest of the decoders ------------------------------------

SEED10 = 20261024
K1_LONG_SPANS = (512, 1024, 2048, 4096, 8192)
K1_LONG_BATCHES = (1, 181, 1024)
B10, BATCHES10, B10_L32 = 128, 4, 8  # the tree arm's batch and batches; its L = 32 decode
N_DF, K_DF, TRIALS_DF, B_DF = 1024, 512, 8, 1024
EL_CHUNKS = 4  # chunks per SNR point of the error-locator app


def _chunk_branches(node, chunk):
    """Branch nodes of span `chunk` that the tree schedule reaches (K7's calls)."""
    from polar_codes_torch.models.tree import NodeKind

    if node.kind != NodeKind.BRANCH:
        return 0
    if node.length == chunk:
        return 1
    return _chunk_branches(node.left, chunk) + _chunk_branches(node.right, chunk)


def run_k1_long(card):
    """Phase 32. K1 one-leaf schedules of every kind a large-N tree walks
    (rate-0, rate-1, rep, SPC) at spans K1_LONG_SPANS, L in K1_LISTS, B in
    K1_LONG_BATCHES by turns, in every family, entered at w_in = L with
    every other row one live path, on integer LLRs in [-2, 2] and Gaussian
    ones by turns: bits, perms and metrics equal to the plain version. The
    schedules whose input does not fit in shared memory beside the list
    state read it from device memory; the phase fails unless both kinds ran
    in every family. Returns the largest metric difference per family (0)."""
    import torch

    from polar_codes_torch.models.tree import NodeKind
    from polar_codes_torch.ops import _build
    from polar_codes_torch.ops import scl_kernel_bl as kbl
    from polar_codes_torch.ops.large_kernel import _sub_leaf

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED10)
    lib = _build.load("scl_subtree")
    kbl._bind(lib)
    err = {"float32": 0.0, "char": 0.0, "bfloat16": 0.0}
    placed = {(fam, kind): 0 for fam in err for kind in ("staged", "device memory")}
    kinds = (NodeKind.RATE0, NodeKind.RATE1, NodeKind.REP, NodeKind.SPC)
    n = 0
    for state in (torch.float32, torch.int16, torch.bfloat16):
        fam = kbl.family(state)
        for n_list in K1_LISTS:
            for span in K1_LONG_SPANS:
                direct = (lib.scl_subtree_smem(n_list, span, fam.code, 1)
                          < n_list * span * state.itemsize)
                where = "device memory" if direct else "staged"
                for kind in kinds:
                    n_batch = K1_LONG_BATCHES[n % len(K1_LONG_BATCHES)]
                    sched = kbl.build_schedule(_sub_leaf(kind, span), n_list, n_list)
                    shape = (n_list, span, n_batch)
                    if n % 2:
                        x = torch.randint(-2, 3, shape, generator=gen, device=dev)
                    else:
                        x = torch.randn(shape, generator=gen, device=dev) * 2.0 + 0.5
                        x = torch.round(x * 10.0) if state == torch.int16 else x
                    x = x.to(state)
                    m = torch.randint(-3, 1, (n_batch, n_list), generator=gen,
                                      device=dev).to(torch.float32)
                    m[::2, 1:] = NEG
                    got = kbl.scl_subtree(sched, x, m)
                    want = kbl.scl_subtree_plain(sched, x, m)
                    what = f"K1 {fam.name} one {kind.value} leaf, L={n_list}, span {span}, " \
                           f"B={n_batch}, {where}"
                    _equal(what + " bits", got[0], want[0])
                    _equal(what + " perm", got[1], want[1])
                    err[fam.name] = max(err[fam.name], _equal(what + " metrics", got[2], want[2]))
                    placed[fam.name, where] += 1
                    n += 1
    torch.cuda.synchronize()
    emit({"k1_one_leaf_calls": n, "by_family_and_placement":
          {f"{f}/{w}": c for (f, w), c in placed.items()}, "max_abs_err": err, "card": card})
    if not all(placed.values()):
        raise AssertionError(f"a family ran no staged or no device-memory leaf: {placed}")
    print(f"K1: {n} one-leaf calls at spans {K1_LONG_SPANS} equal to the plain version")
    return err


def run_slice10(card):
    """Phases 33-35. Returns {"tree": launches of the tree arm's run,
    "depthfirst_cli": and "errorlocator_app": those of the jobs, and
    "tree_leaf_ms": K1's time on the tree arm's longest leaf}."""
    import contextlib
    import csv
    import io
    import shutil
    import tempfile

    import torch

    from polar_codes_torch.construction import frozen_bits
    from polar_codes_torch.dsp import Awgn, Bpsk, add_awgn, bpsk_modulate
    from polar_codes_torch.models.depthfirst import DepthFirstDecoder
    from polar_codes_torch.models.detectors import CRC16
    from polar_codes_torch.models.encoder import PolarEncoder
    from polar_codes_torch.models.errorlocator import ErrorLocator
    from polar_codes_torch.models.fastssc import FastSSCDecoder
    from polar_codes_torch.models.large import LargeSCLDecoder
    from polar_codes_torch.models.puncturer import Puncturer
    from polar_codes_torch.models.tree import NodeKind
    from polar_codes_torch.ops import _build, butterfly_kernel
    from polar_codes_torch.ops import large_kernel as lk
    from polar_codes_torch.ops import scl_kernel_bl as kbl
    from polar_codes_torch.sim import errorlocator_app
    from polar_codes_torch.utils.timing import time_cuda

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED10 + 1)
    modem = Bpsk()
    out = {}

    def channel(encoder, ebn0_db, n_blocks):
        k_len = encoder.info_length
        info = torch.randint(0, 2, (n_blocks, k_len), generator=gen, device=dev,
                             dtype=torch.uint8)
        chan = Awgn()
        chan.set_esn0_linear(10.0 ** (ebn0_db / 10.0) * k_len / encoder.block_length)
        llr = modem.demodulate(chan.transmit(modem.modulate(encoder.encode(info)), gen))
        return encoder.detector.generate(info), llr

    def reset_counts():
        butterfly_kernel.LAUNCHES = 0
        kbl.LAUNCHES.update(float32=0, char=0, bfloat16=0)
        lk.LAUNCHES.update(sc=0, scl=0, sc_char=0, scl_char=0)

    def counts():
        torch.cuda.synchronize()
        return {"butterfly_encode": butterfly_kernel.LAUNCHES,
                "scl_subtree[float32]": kbl.LAUNCHES["float32"],
                "masked_scl_chunk[float32]": lk.LAUNCHES["scl"]}

    # 33 ------------------------------------------------------------------
    phase("33 LargeSCLDecoder(schedule='tree'): (32768, 16384) CA-SCL-8 CRC16, chunk 256, "
          "sub-block 16, B = 128, 2 dB and 0.8 dB; L = 32 from device memory")
    det = CRC16()
    f_scl = frozen_bits(N_SCL, K_SCL, 0.0, "BB")
    enc = PolarEncoder(N_SCL, f_scl, systematic=True, detector=det, device=dev)
    kw = dict(list_size=LIST, detector=det, chunk=CHUNK_SCL, subblock=SUB, device=dev)
    tree = LargeSCLDecoder(N_SCL, f_scl, schedule="tree", **kw)
    tree_plain = LargeSCLDecoder(N_SCL, f_scl, schedule="tree",
                                 chunk_fn=lk.masked_scl_chunk_plain,
                                 subtree_fn=kbl.scl_subtree_plain, **kw)
    scan = LargeSCLDecoder(N_SCL, f_scl, carry_dtype=torch.bfloat16, **kw)
    scan_f32 = LargeSCLDecoder(N_SCL, f_scl, **kw)
    walked = [leaf for leaf in tree.sched_tree.leaves() if leaf.length >= CHUNK_SCL]
    n_k1 = len(walked)
    n_k7 = _chunk_branches(tree.sched_tree, CHUNK_SCL)
    if n_k7 != int((tree.classes == 0).sum()):
        raise AssertionError(f"{n_k7} chunk-span branch nodes, but "
                             f"{int((tree.classes == 0).sum())} mixed chunks")
    emit({"tree_leaves": {f"{k.value}": sorted(l.length for l in walked if l.kind == k)
                          for k in (NodeKind.RATE0, NodeKind.RATE1, NodeKind.REP,
                                    NodeKind.SPC)},
          "k1_per_decode": n_k1, "k7_per_decode": n_k7})
    batches = {e: [channel(enc, e, B10) for _ in range(BATCHES10)] for e in (EBN0_DB, EBN0_LOW)}
    reset_counts()
    outs = {e: [tree.decode(llr) for _, llr in b] for e, b in batches.items()}
    launches = counts()
    out["tree"] = launches
    n_dec = 2 * BATCHES10
    if (launches["masked_scl_chunk[float32]"] != n_dec * n_k7
            or launches["scl_subtree[float32]"] != n_dec * n_k1):
        raise AssertionError(f"tree arm launches {launches}, expected {n_k7} K7 and {n_k1} K1 "
                             f"a decode over {n_dec} decodes")
    for ebn0, b in batches.items():
        wrong = fails = 0
        scan_wrong = 0
        for (sent, llr), o in zip(b, outs[ebn0]):
            bad = (o[0] != sent).any(1)
            if (~o[2] & ~bad).any():
                raise AssertionError("tree arm: a block with a failed CRC decoded right")
            wrong += int(bad.sum())
            fails += int((~o[2]).sum())
            scan_wrong += int((scan.decode(llr)[0] != sent).any(1).sum())
        bler = wrong / (B10 * BATCHES10)
        emit({"metric": "bler", "path": f"large_cascl8_tree_n{N_SCL}", "value": bler,
              "blocks": B10 * BATCHES10, "block_errors": wrong, "crc_failures": fails,
              "scan_arm_block_errors": scan_wrong, "ebn0_db": ebn0})
        if ebn0 == EBN0_DB and bler > 5e-2:
            raise AssertionError(f"tree arm BLER {bler} above 5e-2 at {EBN0_DB} dB")
        if ebn0 == EBN0_LOW and fails == 0:
            raise AssertionError(f"no CRC failure at {EBN0_LOW} dB: the fallback is not driven")
        llr = b[0][1]  # the kernels' route against the plain versions' route
        got, want = tree.decode_packed(llr), tree_plain.decode_packed(llr)
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"tree arm at {ebn0} dB: kernel and plain routes' bits differ")
        torch.testing.assert_close(got[1], want[1], rtol=TOL, atol=TOL)
        tree_plain.decode_packed = lambda _, w=want: w  # its decisions from the words it made
        plain_out = tree_plain.decode(llr)
        del tree_plain.decode_packed
        _same_decisions(f"tree arm at {ebn0} dB", outs[ebn0][0], plain_out)
    clean = 4.0 * modem.modulate(enc.encode(batches[EBN0_DB][0][0]))
    if not torch.equal(tree.decode(clean)[0], batches[EBN0_DB][0][0]):
        raise AssertionError("tree arm: noiseless round trip lost info bits")
    llr = batches[EBN0_DB][0][1]
    times = {"tree_ms": time_cuda(lambda: tree.decode(llr), reps=REPS),
             "scan_bf16_carry_ms": time_cuda(lambda: scan.decode(llr), reps=REPS),
             "scan_f32_carry_ms": time_cuda(lambda: scan_f32.decode(llr), reps=REPS)}
    longest = max(walked, key=lambda l: l.length)
    sched = kbl.build_schedule(longest, LIST, LIST)
    x = torch.randn((LIST, longest.length, B10), generator=gen, device=dev) * 2.0 + 1.0
    m = torch.randn((B10, LIST), generator=gen, device=dev) * 10.0
    out["tree_leaf_ms"] = time_cuda(lambda: kbl.scl_subtree(sched, x, m), reps=REPS)
    emit({"metric": "large_cascl8_tree_decode", "n": N_SCL, "batch": B10, **times,
          "payload_mbps": B10 * (K_SCL - det.tail_bits) / times["tree_ms"] / 1e3,
          "launches_per_decode": {"masked_scl_chunk": n_k7, "scl_subtree": n_k1},
          f"k1_{longest.kind.value}_span{longest.length}_ms": out["tree_leaf_ms"],
          "card": card})
    # L = 32: the longest leaves exceed shared memory beside the list state
    lib = _build.load("scl_subtree")
    kbl._bind(lib)
    if lib.scl_subtree_smem(32, longest.length, 0, 1) >= 32 * longest.length * 4:
        raise AssertionError(f"the span-{longest.length} leaf fits staged at L = 32")
    t32 = LargeSCLDecoder(N_SCL, f_scl, schedule="tree", **dict(kw, list_size=32))
    sent, llr = batches[EBN0_LOW][0][0][:B10_L32], batches[EBN0_LOW][0][1][:B10_L32]
    reset_counts()
    t0 = time.perf_counter()
    got = t32.decode(llr)
    torch.cuda.synchronize()
    ms32 = (time.perf_counter() - t0) * 1e3
    launches32 = counts()
    bad32 = (got[0] != sent).any(1)
    if (~got[2] & ~bad32).any() or launches32["scl_subtree[float32]"] != n_k1:
        raise AssertionError(f"tree arm L = 32: a failed check on a right block, or "
                             f"launches {launches32}")
    clean = 4.0 * modem.modulate(enc.encode(sent))
    if not torch.equal(t32.decode(clean)[0], sent):
        raise AssertionError("tree arm L = 32: noiseless round trip lost info bits")
    emit({"path": "large_cascl32_tree", "batch": B10_L32, "ebn0_db": EBN0_LOW,
          "block_errors": int(bad32.sum()),
          "l8_block_errors": int((outs[EBN0_LOW][0][0][:B10_L32] != sent).any(1).sum()),
          "first_decode_ms": ms32, "card": card})
    print(f"tree arm: {n_k7} K7 and {n_k1} K1 calls a decode; kernel route == plain route; "
          f"L = 32 decoded, its span-{longest.length} leaves from device memory")

    # 34 ------------------------------------------------------------------
    phase("34 DepthFirstDecoder (SC-Flip): (1024, 512) CRC16, 8 trials, B = 1024, 2 dB; "
          "sim.cli depthfirst")
    f_df = frozen_bits(N_DF, K_DF, 0.0, "BB")
    enc_df = PolarEncoder(N_DF, f_df, systematic=True, detector=det, device=dev)
    df = DepthFirstDecoder(N_DF, f_df, detector=det, trial_limit=TRIALS_DF, device=dev)
    sc = FastSSCDecoder(N_DF, f_df, detector=det, device=dev)
    sent, llr = channel(enc_df, EBN0_DB, B_DF)
    t0 = time.perf_counter()
    got = df.decode(llr)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    df_cpu = DepthFirstDecoder(N_DF, f_df, detector=CRC16(), trial_limit=TRIALS_DF,
                               device="cpu")
    for a, b in zip(got, df_cpu.decode(llr[:64].cpu())):
        if not torch.equal(a[:64].cpu(), b):
            raise AssertionError("DepthFirst: card decode differs from the CPU decode")
    df_wrong = int((got[0] != sent).any(1).sum())
    sc_out = sc.decode(llr)
    sc_wrong = int((sc_out[0] != sent).any(1).sum())
    first_fail = int((~sc_out[2]).sum())
    if df_wrong > sc_wrong or (~got[2] & ~(got[0] != sent).any(1)).any():
        raise AssertionError(f"DepthFirst: {df_wrong} wrong blocks, Fast-SSC {sc_wrong}, or a "
                             "failed check on a right block")
    df_ms = time_cuda(lambda: df.decode(llr), warmup=1, reps=3)
    emit({"path": "depthfirst_scflip", "n": N_DF, "batch": B_DF, "trials": TRIALS_DF,
          "ebn0_db": EBN0_DB, "block_errors": df_wrong, "fastssc_block_errors": sc_wrong,
          "fastssc_crc_failures": first_fail, "decode_ms": df_ms, "first_decode_ms": first_ms,
          "card": card})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_s10_")
    try:
        reset_counts()
        argv = ["depthfirst", "-n", str(N_DF), "-r", "0.5", "-l", str(TRIALS_DF),
                "--snr-count", "1", "--snr-max", str(EBN0_DB), "--batch", str(B_DF),
                "-w", str(2 * B_DF * N_DF), "-o", f"{tmp}/df"]
        t0 = time.perf_counter()
        text, (row,) = _sim(argv)
        wall = time.perf_counter() - t0
        out["depthfirst_cli"] = counts()
        (w, d, _), = _job_shares(text)
        emit({"path": "pcsim_cli_depthfirst", "bler": float(row["BLER"]), "runs": int(row["Runs"]),
              "wall_s": wall, "job_wall_s": w, "decode_share": d,
              "launches": out["depthfirst_cli"], "card": card})
        if int(row["Runs"]) != 2 * B_DF or out["depthfirst_cli"]["butterfly_encode"] <= 0:
            raise AssertionError(f"depthfirst job: {row}, launches {out['depthfirst_cli']}")

        # 35 --------------------------------------------------------------
        phase("35 ErrorLocator at N = 1024, B = 1024, 1-3 dB; the errorlocator app; "
              "a Puncturer round trip")
        enc_nonsys = PolarEncoder(N_DF, f_df, systematic=False, device=dev)
        loc = ErrorLocator(N_DF, f_df, device=dev)
        loc_cpu = ErrorLocator(N_DF, f_df, device="cpu")
        located = {}
        for ebn0 in (1.0, 2.0, 3.0):
            info = torch.randint(0, 2, (B_DF, K_DF), generator=gen, device=dev,
                                 dtype=torch.uint8)
            code = enc_nonsys.encode(info)
            y = add_awgn(bpsk_modulate(code), gen, esn0_linear=10 ** (ebn0 / 10) * K_DF / N_DF)
            first, mask = loc.locate(y, code)
            first_c, mask_c = loc_cpu.locate(y.cpu(), code.cpu())
            if not (torch.equal(first.cpu(), first_c) and torch.equal(mask.cpu(), mask_c)):
                raise AssertionError(f"ErrorLocator at {ebn0} dB: card differs from the CPU")
            located[ebn0] = int((first < N_DF).sum())
        loc_ms = time_cuda(lambda: loc.locate(y, code), reps=REPS)
        reset_counts()
        app = ["-n", str(N_DF), "-r", "0.5", "--snr-min", "1", "--snr-max", "3",
               "--snr-count", "3", "-w", str(EL_CHUNKS * B_DF * N_DF), "--batch", str(B_DF),
               "-o", f"{tmp}/el"] + _platform()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = errorlocator_app.main(app)
        torch.cuda.synchronize()
        app_s = time.perf_counter() - t0
        print(buf.getvalue(), end="")
        out["errorlocator_app"] = counts()
        with open(f"{tmp}/el_firsterror.csv") as f:
            lines = f.read().splitlines()
        rows = list(csv.DictReader(lines))
        if (rc != 0 or any(len(line.split(",")) != 7 for line in lines)
                or {r["frames"] for r in rows} != {str(EL_CHUNKS * B_DF)}
                or out["errorlocator_app"]["butterfly_encode"] != 3 * EL_CHUNKS):
            raise AssertionError(f"errorlocator app: rc {rc}, {len(rows)} rows, "
                                 f"launches {out['errorlocator_app']}")
        punct = Puncturer(1000, f_df)
        x = torch.randn((B_DF, N_DF), generator=gen, device=dev)
        back = punct.depuncture(punct.puncture(x))
        if not torch.equal(back.cpu(), punct.depuncture(punct.puncture(x.cpu()))):
            raise AssertionError("Puncturer: card round trip differs from the CPU")
        emit({"path": "errorlocator", "frames_with_genie_error": located, "batch": B_DF,
              "locate_ms": loc_ms, "app_s": app_s, "app_ms_per_chunk": app_s * 1e3 / (3 * EL_CHUNKS),
              "app_csv_rows": len(rows), "launches": out["errorlocator_app"], "card": card})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("ErrorLocator and Puncturer on the card == on the CPU")
    return out


# ---- slice 11: every list size, K3 bf16 -----------------------------------

SEED11 = 20261025
K1_NEW_LISTS = (3, 5, 12, 24, 64, 128)
K1_NEW_DESIGN = ("the capacity's instantiation at any list size below it; above 32 paths "
                 "W packed words, a lane per path, the prune in passes")
B11, B11_L128, EBN0_11 = 1024, 256, 1.5  # the CA-SCL-64 paths' batch; L = 128's; Eb/N0
LL_LISTS = (16, 64)  # sim.cli listlength --l-min, --l-max


def _fams():
    import torch

    # the decoder's dtype -> the LLR state K1 sees
    return {torch.float32: torch.float32, torch.int8: torch.int16,
            torch.bfloat16: torch.bfloat16}


def run_k1_lists(card):
    """Phase 36. K1 against its plain version at L in K1_NEW_LISTS (odd
    sizes in a power-of-two instantiation; 64 and 128 with two and four
    packed words), B in K1_BATCHES, every family: every subtree call of
    an N = 1024 CA-SCL decode on integer LLRs in [-2, 2] (ties, signed
    zeros), and at B = 181 one-leaf schedules of every kind entered at
    w_in = L with every other row holding one live path; bits, perms and
    metrics equal. Then K1's calls of the float32 decodes at L = 3 and 12
    timed at B = 2048, beside their plain versions. Returns {"err": the
    largest difference per family (0), "calls": number held, "timed": {L:
    (ms, plain ms, bytes, operations) per decode}}."""
    import numpy as np
    import torch

    from polar_codes_torch.construction import frozen_bits
    from polar_codes_torch.models.detectors import CRC16
    from polar_codes_torch.models.scl import SCLDecoder
    from polar_codes_torch.models.tree import CodeNode, NodeKind
    from polar_codes_torch.ops import scl_kernel_bl as kbl
    from polar_codes_torch.ops.large_kernel import _sub_leaf

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED11)
    frozen = frozen_bits(N_LEN, K_LEN, 0.0, "BB")
    err = {"float32": 0.0, "char": 0.0, "bfloat16": 0.0}
    checked = 0

    def hold(where, sched, x, m, want):
        nonlocal checked
        got = kbl.scl_subtree(sched, x, m)
        _equal(where + " bits", got[0], want[0])
        _equal(where + " perm", got[1], want[1])
        if not torch.isfinite(got[2]).all():
            raise AssertionError(where + ": metrics not finite")
        fam = kbl.family(x.dtype).name
        err[fam] = max(err[fam], _equal(where + " metrics", got[2], want[2]))
        checked += 1

    def ints(shape, dtype):
        return torch.randint(-2, 3, shape, generator=gen, device=dev).to(dtype)

    timed = {}
    for n_list in K1_NEW_LISTS:
        for dtype, state in _fams().items():
            for n_batch in K1_BATCHES:
                calls = []

                def record(sched, x, m):
                    out = kbl.scl_subtree_plain(sched, x, m)
                    calls.append((sched, x, m, out))
                    return out

                SCLDecoder(N_LEN, frozen, list_size=n_list, detector=CRC16(), dtype=dtype,
                           device=dev, subtree_fn=record).decode_packed(
                    ints((n_batch, N_LEN), dtype))
                for sched, x, m, want in calls:
                    hold(f"K1 {kbl.family(x.dtype).name} L={n_list} B={n_batch} span "
                         f"{sched.span} at {sched.node.offset}, w {sched.w_in}", sched, x, m,
                         want)
                if n_batch == B2 and dtype == torch.float32 and n_list in (3, 12):
                    timed[n_list] = _time_k1(calls, n_batch)
                if n_batch != 181:
                    continue
                leaves = [_sub_leaf(k, 128) for k in
                          (NodeKind.RATE0, NodeKind.RATE1, NodeKind.REP, NodeKind.SPC)]
                leaves += [CodeNode(0, 8, np.array([0, 1, 2, 4, 5]), NodeKind.ENUM),
                           CodeNode(0, 1, np.zeros(0, np.int64), NodeKind.RATE1)]
                for node in leaves:
                    one = kbl.build_schedule(node, n_list, n_list)
                    m1 = torch.randint(-3, 1, (n_batch, n_list), generator=gen,
                                       device=dev).to(torch.float32)
                    m1[::2, 1:] = NEG  # every other row: one live path
                    x1 = ints((n_list, node.length, n_batch), state)
                    hold(f"K1 L={n_list} one leaf {node.kind.value} span {node.length}", one,
                         x1, m1, kbl.scl_subtree_plain(one, x1, m1))
    torch.cuda.synchronize()
    emit({"k1_lists_checked_calls": checked, "lists": K1_NEW_LISTS, "max_abs_err": err,
          "timed_b2048": {str(k): v[:2] for k, v in timed.items()}, "card": card})
    print(f"K1: {checked} calls equal to the plain version at L in {K1_NEW_LISTS}, "
          f"B in {K1_BATCHES}, every family")
    return {"err": err, "calls": checked, "timed": timed}


def _time_k1(calls, n_batch):
    """(kernel ms, plain ms, bytes, operations) of a decode's K1 calls
    [(sched, x, m, ...)], each timed alone (CUDA events, median)."""
    from polar_codes_torch.ops import scl_kernel_bl as kbl
    from polar_codes_torch.utils.timing import time_cuda

    ms = plain = n_bytes = n_ops = 0
    for sched, x, m, *_ in calls:
        ms += time_cuda(lambda: kbl.scl_subtree(sched, x, m), reps=REPS)
        plain += time_cuda(lambda: kbl.scl_subtree_plain(sched, x, m), warmup=1, reps=3)
        nb, no = k1_work(sched, n_batch, x.element_size())
        n_bytes += nb
        n_ops += no
    return ms, plain, n_bytes, n_ops


def run_slice11(card):
    """Phases 37-39. Returns {"entries": the new kernels-line entries}."""
    import shutil
    import tempfile

    import torch

    from polar_codes_torch.construction import frozen_bits
    from polar_codes_torch.dsp import Awgn, Bpsk
    from polar_codes_torch.models.adaptive import AdaptiveDecoder
    from polar_codes_torch.models.detectors import CRC16, CRC32
    from polar_codes_torch.models.encoder import PolarEncoder
    from polar_codes_torch.models.fastssc import FastSSCDecoder
    from polar_codes_torch.models.scl import SCLDecoder
    from polar_codes_torch.models.tree import build_tree
    from polar_codes_torch.ops import butterfly_kernel
    from polar_codes_torch.ops import fastssc_kernel as fk
    from polar_codes_torch.ops import scl_kernel_bl as kbl
    from polar_codes_torch.utils.timing import time_cuda

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED11 + 1)
    frozen = frozen_bits(N_LEN, K_LEN, 0.0, "BB")
    modem = Bpsk()
    entries = []

    def channel(det, n_blocks, ebn0_db=EBN0_11, n_len=N_LEN, k_len=K_LEN):
        fz = frozen if n_len == N_LEN else frozen_bits(n_len, k_len, 0.0, "BB")
        enc = PolarEncoder(n_len, fz, systematic=True, detector=det, device=dev)
        info = torch.randint(0, 2, (n_blocks, k_len), generator=gen, device=dev,
                             dtype=torch.uint8)
        chan = Awgn()
        chan.set_esn0_linear(10.0 ** (ebn0_db / 10.0) * k_len / n_len)
        llr = modem.demodulate(chan.transmit(modem.modulate(enc.encode(info)), gen))
        return det.generate(info), llr

    def reset_counts():
        butterfly_kernel.LAUNCHES = 0
        kbl.LAUNCHES.update(float32=0, char=0, bfloat16=0)
        kbl.LIST_LAUNCHES.clear()
        fk.LAUNCHES.update(float32=0, int8=0, bfloat16=0)

    def counts():
        torch.cuda.synchronize()
        return {"scl_subtree": dict(kbl.LAUNCHES),
                "scl_subtree_by_list": dict(sorted(kbl.LIST_LAUNCHES.items())),
                "fastssc_subtree": dict(fk.LAUNCHES)}

    def wrong_and_checked(what, out, sent):
        wrong = (out[0] != sent).any(1)
        if (~out[2] & ~wrong).any():
            raise AssertionError(f"{what}: a block with a failed CRC decoded right")
        return int(wrong.sum()), int((~out[2]).sum())

    # 37 ------------------------------------------------------------------
    phase("37 (1024, 512) CA-SCL-64 CRC16 end to end at B = 1024, 1.5 dB, float32, int8 and "
          "bf16; CA-SCL-128 at B = 256; kernel route == plain route")
    det = CRC16()
    sent, llr = channel(det, B11)
    quant = torch.clamp(torch.round(llr * 10.0), -127, 127).to(torch.int8)
    dec8 = SCLDecoder(N_LEN, frozen, list_size=LIST, detector=det, device=dev)
    wrong8, _ = wrong_and_checked("CA-SCL-8", dec8.decode(llr), sent)
    runs = {}
    for n_list, dtype, n_batch in ((64, torch.float32, B11), (64, torch.int8, B11),
                                   (64, torch.bfloat16, B11), (128, torch.float32, B11_L128)):
        fam = kbl.family(_fams()[dtype]).name
        name = f"scl_subtree[{fam},L={n_list}]"
        x = (quant if dtype == torch.int8 else llr)[:n_batch]
        dec = SCLDecoder(N_LEN, frozen, list_size=n_list, detector=det, dtype=dtype,
                         device=dev)
        plain = SCLDecoder(N_LEN, frozen, list_size=n_list, detector=det, dtype=dtype,
                           device=dev, subtree_fn=kbl.scl_subtree_plain)
        reset_counts()
        out = dec.decode(x)
        launched = counts()
        if not (launched["scl_subtree_by_list"].get(n_list) and launched["scl_subtree"][fam]):
            raise AssertionError(f"{name}: K1 never launched at L = {n_list}: {launched}")
        _same_decisions(name, out, plain.decode(x))
        word, met = dec.decode_packed(x)
        pword, pmet = plain.decode_packed(x)
        _equal(f"{name} packed words", word, pword)
        if word.shape != (kbl.n_words(n_list), N_LEN, n_batch):
            raise AssertionError(f"{name}: words of shape {tuple(word.shape)}")
        torch.testing.assert_close(met, pmet, rtol=TOL, atol=TOL)
        wrong, failed = wrong_and_checked(name, out, sent[:n_batch])
        if n_batch == B11 and dtype == torch.float32 and wrong > wrong8 + 2:
            raise AssertionError(f"CA-SCL-64: {wrong} wrong blocks, CA-SCL-8 {wrong8}")
        calls = []

        def record(sched, xx, m):
            calls.append((sched, xx, m))
            return kbl.scl_subtree(sched, xx, m)

        SCLDecoder(N_LEN, frozen, list_size=n_list, detector=det, dtype=dtype, device=dev,
                   subtree_fn=record).decode_packed(x)
        k1 = _time_k1(calls, n_batch)
        dec_ms = time_cuda(lambda: dec.decode(x), warmup=1, reps=3)
        runs[name] = {"launches": launched["scl_subtree"][fam], "calls": len(calls),
                      "err": max_err(met, pmet), "k1": k1}
        emit({"path": f"ca_scl{n_list}_{dtype}".replace("torch.", ""), "n": N_LEN,
              "batch": n_batch, "ebn0_db": EBN0_11, "block_errors": wrong,
              "crc_failures": failed, "scl8_block_errors": wrong8 if n_batch == B11 else None,
              "decode_ms": dec_ms, "k1_ms_per_decode": k1[0], "k1_plain_ms_per_decode": k1[1],
              "k1_launches_per_decode": len(calls), "launches": launched,
              "max_abs_metric_err": runs[name]["err"], "card": card})
    print("CA-SCL-64 (float32, int8, bf16) and CA-SCL-128: kernel route == plain route")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_s11_")
    try:
        # 38 --------------------------------------------------------------
        phase("38 sim.cli listlength -n 1024 --l-min 16 --l-max 64, one point; "
              "AdaptiveDecoder(list_schedule=(3, 12)) at B = 2048")
        reset_counts()
        argv = ["listlength", "-n", str(N_LEN), "-r", "0.5", "--l-min", str(LL_LISTS[0]),
                "--l-max", str(LL_LISTS[1]), "--snr-count", "1", "--snr-min", str(EBN0_11),
                "--snr-max", str(EBN0_11), "--batch", str(B11), "-w", str(B11 * N_LEN),
                "-o", f"{tmp}/ll"]
        t0 = time.perf_counter()
        text, rows = _sim(argv)
        wall = time.perf_counter() - t0
        ll_counts = counts()
        lists = [int(r["L"]) for r in rows]
        if (lists != [16, 32, 64] or any(int(r["Runs"]) != B11 for r in rows)
                or not ll_counts["scl_subtree_by_list"].get(64)):
            raise AssertionError(f"listlength: lists {lists}, rows {rows}, {ll_counts}")
        emit({"path": "pcsim_cli_listlength", "lists": lists,
              "bler": [float(r["BLER"]) for r in rows], "wall_s": wall,
              "jobs": _job_shares(text), "launches": ll_counts, "card": card})

        sent32, llr32 = channel(CRC32(), B2)
        ad = AdaptiveDecoder(N_LEN, frozen, list_schedule=(3, 12), device=dev)
        ad_plain = AdaptiveDecoder(N_LEN, frozen, list_schedule=(3, 12), device=dev,
                                   fast_subtree_fn=fk.fastssc_subtree_plain,
                                   list_subtree_fn=kbl.scl_subtree_plain)
        reset_counts()
        out = ad.decode(llr32)
        ad_counts = counts()
        rerun = list(ad.rerun_rows)
        _same_decisions("adaptive (3, 12)", out, ad_plain.decode(llr32))
        wrong, failed = wrong_and_checked("adaptive (3, 12)", out, sent32)
        by_list = ad_counts["scl_subtree_by_list"]
        if not (by_list.get(3) and by_list.get(12)):
            raise AssertionError(f"adaptive (3, 12): K1 launches {by_list}, reruns {rerun}")
        ad_ms = time_cuda(lambda: ad.decode(llr32), warmup=1, reps=5)
        emit({"path": "adaptive_l3_l12", "batch": B2, "ebn0_db": EBN0_11, "rerun_rows": rerun,
              "block_errors": wrong, "crc_failures": failed, "decode_ms": ad_ms,
              "launches": ad_counts, "card": card})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("listlength and adaptive (3, 12) ran on K1 at L = 3, 12, 16, 32, 64")

    # 39 ------------------------------------------------------------------
    phase("39 K3 bf16 at N in (2 .. 2048), B in (1, 3, 181, 2048); FastSSCDecoder(bf16) and "
          "AdaptiveDecoder(fast_dtype=bf16) at B = 2048, kernel route == plain route")
    k3_err = 0.0
    k3_checked = 0
    for n_len in K3_LENGTHS:
        sched = fk.build_schedule(
            build_tree(n_len, frozen_bits(n_len, n_len // 2, 0.0, "BB")))
        for n_batch in K3_BATCHES:
            gauss = torch.randn((n_len, n_batch), generator=gen, device=dev) * 2.0 + 0.5
            ints = torch.randint(-2, 3, (n_len, n_batch), generator=gen, device=dev).float()
            ints = ints * (torch.randint(0, 2, ints.shape, generator=gen, device=dev) * 2 - 1)
            far = torch.tensor([1e8, -1e8, 1.0, -0.5, 0.25, -3.0], device=dev)
            order = far[torch.randint(0, 6, (n_len, n_batch), generator=gen, device=dev)]
            order[:, 0] = torch.tensor([1e8, 1.0, -1e8, -0.5], device=dev).repeat(n_len)[:n_len]
            for kind, x in (("gauss", gauss), ("ints", ints), ("order", order)):
                x = x.to(torch.bfloat16)
                for root in (True, False):
                    k3_err = max(k3_err, _equal(
                        f"K3 bf16 N={n_len} B={n_batch} {kind} root={root}",
                        fk.fastssc_subtree(sched, x, root),
                        fk.fastssc_subtree_plain(sched, x, root)))
                    k3_checked += 1
    print(f"K3 bf16: {k3_checked} calls bit-equal to the plain version")

    sent32, llr32 = channel(CRC32(), B2)
    fs = FastSSCDecoder(N_LEN, frozen, detector=CRC32(), dtype=torch.bfloat16, device=dev)
    fs_plain = FastSSCDecoder(N_LEN, frozen, detector=CRC32(), dtype=torch.bfloat16,
                              device=dev, subtree_fn=fk.fastssc_subtree_plain)
    reset_counts()
    out = fs.decode(llr32)
    fs_counts = counts()
    if fs_counts["fastssc_subtree"]["bfloat16"] != 1:
        raise AssertionError(f"FastSSC bf16: K3 launches {fs_counts}")
    _same_decisions("FastSSC bf16", out, fs_plain.decode(llr32))
    fs_wrong, fs_failed = wrong_and_checked("FastSSC bf16", out, sent32)
    sent2k, llr2k = channel(CRC32(), B2 // 4, EBN0_11, 2048, 1024)  # bf16 glue above 1024
    fs2k = FastSSCDecoder(2048, frozen_bits(2048, 1024, 0.0, "BB"), detector=CRC32(),
                          dtype=torch.bfloat16, device=dev)
    fs2k_plain = FastSSCDecoder(2048, frozen_bits(2048, 1024, 0.0, "BB"), detector=CRC32(),
                                dtype=torch.bfloat16, device=dev,
                                subtree_fn=fk.fastssc_subtree_plain)
    _same_decisions("FastSSC bf16 N = 2048", fs2k.decode(llr2k), fs2k_plain.decode(llr2k))
    ad = AdaptiveDecoder(N_LEN, frozen, fast_dtype=torch.bfloat16, device=dev)
    ad_plain = AdaptiveDecoder(N_LEN, frozen, fast_dtype=torch.bfloat16, device=dev,
                               fast_subtree_fn=fk.fastssc_subtree_plain,
                               list_subtree_fn=kbl.scl_subtree_plain)
    reset_counts()
    out = ad.decode(llr32)
    adb_counts = counts()
    _same_decisions("adaptive bf16", out, ad_plain.decode(llr32))
    adb_wrong, adb_failed = wrong_and_checked("adaptive bf16", out, sent32)
    if not (adb_counts["fastssc_subtree"]["bfloat16"] and adb_counts["scl_subtree"]["float32"]):
        raise AssertionError(f"adaptive bf16: launches {adb_counts}")
    x = llr32.T.contiguous().to(torch.bfloat16)
    root = fs.schedule(fs.tree)  # the (1024, 512) code's one root call
    k3_ms = time_cuda(lambda: fk.fastssc_subtree(root, x, True), reps=REPS)
    k3_plain_ms = time_cuda(lambda: fk.fastssc_subtree_plain(root, x, True), warmup=1, reps=3)
    k3_burst = time_cuda(lambda: [fk.fastssc_subtree(root, x, True) for _ in range(BURST)],
                         reps=REPS) / BURST
    fs_ms = time_cuda(lambda: fs.decode(llr32), reps=REPS)
    adb_ms = time_cuda(lambda: ad.decode(llr32), reps=REPS)
    emit({"path": "fastssc_bf16", "batch": B2, "ebn0_db": EBN0_11, "block_errors": fs_wrong,
          "crc_failures": fs_failed, "decode_ms": fs_ms, "k3_ms": k3_ms,
          "k3_burst_ms": k3_burst, "k3_plain_ms": k3_plain_ms, "launches": fs_counts,
          "card": card})
    emit({"path": "adaptive_bf16", "batch": B2, "ebn0_db": EBN0_11, "block_errors": adb_wrong,
          "crc_failures": adb_failed, "decode_ms": adb_ms, "rerun_rows": list(ad.rerun_rows),
          "launches": adb_counts, "card": card})
    print("FastSSC bf16 (N = 1024, 2048) and adaptive bf16: kernel route == plain route")

    src = "polar_codes_torch/csrc/scl_subtree.cu"
    for name, run in runs.items():
        n_list = int(name.split("L=")[1][:-1])
        by_path = {"ca_scl": run["launches"]}
        if name == "scl_subtree[float32,L=64]":
            by_path["pcsim_cli_listlength"] = ll_counts["scl_subtree_by_list"][64]
        entries.append({
            "name": name, "route": "cuda", "source": src, "redesigned": K1_NEW_DESIGN,
            "replaces": "polar_codes_tpu/ops/scl_kernel_bl.py:876",
            "launches": run["launches"], "launches_by_path": by_path,
            "launches_per_decode": run["calls"], "list_size": n_list,
            "max_abs_err": run["err"], "ms": run["k1"][0], "plain_ms": run["k1"][1],
            **bound(run["k1"][2], run["k1"][3]), "library_ms": None})
    return {"entries": entries, "ad_counts": ad_counts, "ll_counts": ll_counts,
            "k3": {"name": "fastssc_subtree[bfloat16]", "route": "cuda",
                   "source": "polar_codes_torch/csrc/fastssc_subtree.cu",
                   "redesigned": K3_DESIGN,
                   "replaces": "polar_codes_tpu/ops/fastssc_kernel.py:147",
                   "launches": fs_counts["fastssc_subtree"]["bfloat16"],
                   "launches_by_path": {
                       "fastssc_bf16": fs_counts["fastssc_subtree"]["bfloat16"],
                       "adaptive_bf16": adb_counts["fastssc_subtree"]["bfloat16"]},
                   "max_abs_err": k3_err, "ms": k3_ms, "burst_ms": k3_burst,
                   "plain_ms": k3_plain_ms, **bound(*k3_work(root, B2, 2, 1)),
                   "library_ms": None}}


# ---- slice 12: LargeSCLDecoder at every list size -------------------------

SEED12 = 20261026
K7_NEW_LISTS = (1, 3, 5, 12, 24, 33, 48, 64, 65, 100, 127, 128)
K7_BATCHES = (1, 181, 128)
K7_NEW_DESIGN = ("the kernel of the list's capacity (32, 64 or 128) with the list size at "
                 "run time; above 32 paths a block of 2 x capacity threads a codeword, W "
                 "packed words, every level in shared memory, the prune a merge of lists "
                 "in rank order; level 0 read from device memory where the pyramid does "
                 "not fit")
K1_ONE_PATH_SPANS = (256, 512, 1024, 2048)  # a pure chunk's span and the tree's leaves
K1_WIDE_LEAVES = ((64, 1024), (64, 2048), (128, 512), (128, 2048))  # (L, span), device memory
K1_WIDE_BATCHES = (1, 128)
B12, B12_TIME = 64, 128  # phase 41's batch; phase 42's decodes
N_I8, K_I8 = 8192, 4096  # the int8 paths' depth: N = 32768 fails every block in int8
# phase 41's paths: (name, L, schedule, int8, bf16 carry, timed in phase 42,
# held against the plain route: L = 1's K7 and K1 calls are held in phase 40)
PATHS12 = (("cascl64_scan", 64, "scan", False, False, True, True),
           ("cascl64_tree", 64, "tree", False, False, False, True),
           ("cascl128_scan", 128, "scan", False, False, True, True),
           ("cascl128_tree", 128, "tree", False, False, False, True),
           ("cascl3_scan", 3, "scan", False, False, True, True),
           ("cascl1_scan", 1, "scan", False, False, True, False),
           ("cascl64_scan_bf16_carry", 64, "scan", False, True, False, True),
           ("cascl3_int8", 3, "scan", True, False, True, True),
           ("cascl64_int8", 64, "scan", True, False, True, True))


def _class_mask64():
    """A chunk of 64 whose sub-blocks of 16 are rate-0, mixed, rate-1, rep."""
    import numpy as np

    return np.concatenate([np.ones(16), np.arange(16) % 3 == 0, np.zeros(16),
                           np.arange(16) < 15]).astype(np.uint8)


def run_k7_lists(card):
    """Phase 40. K7 against its plain version at L in K7_NEW_LISTS, both
    families, on integer LLRs in [-2, 2] (ties, signed zeros): chunks of 64
    and 256, B in K7_BATCHES, with and without sub-blocks (masks with every
    sub-block class), metrics of a decode's first call (one live path), all
    live out of rank order, mixed (0 to L - 1 live at random slots, out of
    rank order), or in rank order with a _NEG tail (what a decode hands on:
    the merge's path), masks with rate-0 runs and all frozen (the re-take
    rule); at L = 100, 127 and 128 on chunks of 256 the chunk's input stays
    in device memory. Then K1 on the one-leaf
    schedules of the large-N decoders at L = 1 (spans 256-2048, every leaf
    kind, B in K7_BATCHES) and from device memory at W = 2 and 4 words (L
    = 64 and 128 at spans 512-2048). Bits, perms and metrics equal.
    Returns {"err": largest metric difference per family (0), "k1_err":
    K1's, "calls": K7 calls held, "direct": of which level 0 in device
    memory, "k1_calls": K1 calls held}."""
    import numpy as np
    import torch

    from polar_codes_torch.construction import frozen_bits
    from polar_codes_torch.models.large import _classify_chunks, _frozen_mask_chunks
    from polar_codes_torch.models.tree import NodeKind
    from polar_codes_torch.ops import _build
    from polar_codes_torch.ops import large_kernel as lk
    from polar_codes_torch.ops import scl_kernel_bl as kbl

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED12)
    err = {"float32": 0.0, "char": 0.0}
    checked = direct = 0

    def ints(shape):
        return torch.randint(-2, 3, shape, generator=gen, device=dev).to(torch.float32)

    def metrics(n_batch, n_list, how):
        met = torch.randint(-3, 1, (n_batch, n_list), generator=gen, device=dev).to(torch.float32)
        if how in ("first", "mixed"):  # every row (first) or every other row: one live path
            rows = slice(None) if how == "first" else slice(None, None, 2)
            met[rows, 1:] = NEG
            met[rows, 0] = 0.0
        if how == "mixed":  # the other rows: 0 to L - 1 live paths at random slots
            n_live = torch.randint(0, n_list, (n_batch, 1), generator=gen, device=dev)
            slot = torch.rand((n_batch, n_list), generator=gen, device=dev).argsort(1)
            met[1::2] = torch.where((slot >= n_live)[1::2], NEG, met[1::2])
        if how == "ranked":  # in rank order, 1 to L live, then _NEG
            n_live = torch.randint(1, n_list + 1, (n_batch, 1), generator=gen, device=dev)
            rank = torch.arange(n_list, device=dev)[None]
            met = torch.where(rank < n_live, met.sort(1, descending=True).values, NEG)
        return met

    # the chunk of the (32768, 16384) code whose sub-blocks hold the most
    # classes (every class at full size)
    chunks = _frozen_mask_chunks(N_SCL, frozen_bits(N_SCL, K_SCL, 0.0, "BB"), CHUNK_SCL)
    every = max(chunks, key=lambda m: len(set(_classify_chunks(list(m.reshape(-1, SUB))))))
    masks = {("classes", 64): _class_mask64(), ("classes", CHUNK_SCL): every.astype(np.uint8)}
    # (chunk, batch, sub-blocks, metrics, mask)
    cases = ((64, 181, True, "live", "classes"),
             (64, 128, False, "mixed", "frozen"), (CHUNK_SCL, 128, True, "mixed", "classes"),
             (CHUNK_SCL, 128, False, "first", "frozen"), (64, 181, False, "live", "rate-0 runs"),
             (CHUNK_SCL, 1, True, "first", "classes"), (CHUNK_SCL, 128, True, "ranked", "classes"),
             (64, 181, False, "ranked", "rate-0 runs"))
    for n_list in K7_NEW_LISTS:
        for family in ("float32", "char"):
            for m_len, n_batch, with_sub, how, kind in cases:
                if kind == "frozen":
                    mask = torch.ones(m_len, dtype=torch.uint8, device=dev)
                elif kind == "rate-0 runs":
                    mask = rate0_mask(m_len, gen, dev)
                else:
                    mask = torch.as_tensor(masks[kind, m_len], device=dev)
                sub_cls = None
                if with_sub:
                    codes = _classify_chunks(list(mask.cpu().numpy().astype(bool).reshape(-1, SUB)))
                    sub_cls = torch.as_tensor(codes, device=dev)
                x, met = ints((n_batch, n_list, m_len)), metrics(n_batch, n_list, how)
                where = (f"K7 {family} L={n_list} chunk {m_len} B={n_batch} sub-blocks "
                         f"{with_sub}, {how} metrics, {kind} mask")
                got = lk.masked_scl_chunk(x, mask, met, sub_cls, family)
                want = lk.masked_scl_chunk_plain(x, mask, met, sub_cls, family)
                _equal(where + ": bits", got[0], want[0])
                _equal(where + ": perm", got[1], want[1])
                err[family] = max(err[family], _equal(where + ": metrics", got[2], want[2]))
                direct += lk.scl_chunk_smem(n_list, m_len, SUB if with_sub else 0) > \
                    lk.MAX_SCL_SMEM
                checked += 1
    if not direct and lk.scl_chunk_smem(max(K7_NEW_LISTS), CHUNK_SCL) > lk.MAX_SCL_SMEM:
        raise AssertionError("no K7 call read level 0 from device memory")
    print(f"K7: {checked} calls at L in {K7_NEW_LISTS}, both families, bit-equal to the "
          f"plain version ({direct} with level 0 in device memory)")

    lib = _build.load("scl_subtree")
    kbl._bind(lib)
    k1_err, k1_calls = 0.0, 0
    kinds = (NodeKind.RATE0, NodeKind.RATE1, NodeKind.REP, NodeKind.SPC)
    shapes = [(1, span, n_batch) for span in K1_ONE_PATH_SPANS for n_batch in K7_BATCHES]
    shapes += [(n_list, span, n_batch) for n_list, span in K1_WIDE_LEAVES
               for n_batch in K1_WIDE_BATCHES]
    for n_list, span, n_batch in shapes:
        if n_list > 32 and lib.scl_subtree_smem(n_list, span, 0, 1) >= 4 * n_list * span:
            raise AssertionError(f"K1 L={n_list} span {span}: the leaf fits staged")
        for kind in kinds:
            sched = kbl.build_schedule(lk._sub_leaf(kind, span), n_list, n_list)
            x = ints((n_list, span, n_batch))
            m = metrics(n_batch, n_list, "mixed" if n_list > 1 else "live")
            where = f"K1 L={n_list} one leaf {kind.value} span {span} B={n_batch}"
            got = kbl.scl_subtree(sched, x, m)
            want = kbl.scl_subtree_plain(sched, x, m)
            _equal(where + ": bits", got[0], want[0])
            _equal(where + ": perm", got[1], want[1])
            k1_err = max(k1_err, _equal(where + ": metrics", got[2], want[2]))
            k1_calls += 1
    torch.cuda.synchronize()
    emit({"k7_lists_checked_calls": checked, "k7_level0_in_device_memory": direct,
          "lists": K7_NEW_LISTS, "max_abs_err": err, "k1_checked_calls": k1_calls,
          "k1_max_abs_err": k1_err, "card": card})
    print(f"K1: {k1_calls} one-leaf calls at L = 1 and from device memory at L = 64, 128 "
          "bit-equal to the plain version")
    return {"err": err, "k1_err": k1_err, "calls": checked, "direct": direct,
            "k1_calls": k1_calls}


def busy_share(fn, calls=3):
    """(wall ms, device busy ms) per call of fn under torch.profiler, device
    activity only: the synchronised host clock around the window, and the
    union of the device events' intervals."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == cuda)
    if not spans:
        raise AssertionError("the profiler recorded no device time")
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy, end = busy + e - s, e
        elif e > end:
            busy, end = busy + e - end, e
    return wall, busy / 1e3 / calls


def run_slice12(card, k7_l8, held):
    """Phases 41-42. k7_l8: phase 17's timed K7 call (args, ms), timed
    again here; held: phase 40's result. Returns {"entries": the new
    kernels-line entries}."""
    import torch

    from polar_codes_torch.construction import frozen_bits
    from polar_codes_torch.dsp import Awgn, Bpsk
    from polar_codes_torch.models.detectors import CRC16
    from polar_codes_torch.models.encoder import PolarEncoder
    from polar_codes_torch.models.large import LargeSCLDecoder
    from polar_codes_torch.ops import _build
    from polar_codes_torch.ops import large_kernel as lk
    from polar_codes_torch.ops import scl_kernel_bl as kbl
    from polar_codes_torch.utils.timing import time_cuda

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED12 + 1)
    modem = Bpsk()
    det = CRC16()
    codes = {n: (frozen_bits(n, k, 0.0, "BB"), PolarEncoder(
        n, frozen_bits(n, k, 0.0, "BB"), systematic=True, detector=det, device=dev))
        for n, k in ((N_SCL, K_SCL), (N_I8, K_I8))}

    def channel(n_len, n_blocks, int8):
        enc = codes[n_len][1]
        info = torch.randint(0, 2, (n_blocks, enc.info_length), generator=gen, device=dev,
                             dtype=torch.uint8)
        chan = Awgn()
        chan.set_esn0_linear(10.0 ** (EBN0_DB / 10.0) * enc.info_length / n_len)
        llr = modem.demodulate(chan.transmit(modem.modulate(enc.encode(info)), gen))
        if int8:  # the simulator's quantiser
            llr = torch.clamp(torch.round(llr * AMPL), -127, 127).to(torch.int8)
        return det.generate(info), llr

    def reset_counts():
        lk.LAUNCHES.update(dict.fromkeys(lk.LAUNCHES, 0))
        lk.SCL_LIST_LAUNCHES.clear()
        kbl.LAUNCHES.update(dict.fromkeys(kbl.LAUNCHES, 0))
        kbl.LIST_LAUNCHES.clear()

    def counts():
        torch.cuda.synchronize()
        return {"masked_scl_chunk": {f"{f},L={n}": c for (f, n), c in
                                     sorted(lk.SCL_LIST_LAUNCHES.items())},
                "scl_subtree": {f"float32,L={n}": c for n, c in
                                sorted(kbl.LIST_LAUNCHES.items())}}

    # 41 ------------------------------------------------------------------
    phase(f"41 LargeSCLDecoder at L = 64 and 128 on both schedules, L = 3 and 1, the bf16 "
          f"carry, int8 at L = 3 and 64: ({N_SCL}, {K_SCL}) CRC16 (int8 ({N_I8}, {K_I8})), "
          f"B = {B12}, {EBN0_DB} dB; kernel route == plain route")
    runs, recorded = {}, {}
    for name, n_list, schedule, int8, bf16, timed, held_plain in PATHS12:
        n_len = N_I8 if int8 else N_SCL
        family = "char" if int8 else "float32"
        kw = dict(list_size=n_list, detector=det, chunk=CHUNK_SCL, subblock=SUB,
                  schedule=schedule, dtype=torch.int8 if int8 else torch.float32,
                  carry_dtype=torch.bfloat16 if bf16 else None, device=dev)
        dec = LargeSCLDecoder(n_len, codes[n_len][0], **kw)
        # the plain route runs at (N_I8, K_I8): at N = 32768 it took ~10 s a path
        plain = LargeSCLDecoder(N_I8, codes[N_I8][0], chunk_fn=lk.masked_scl_chunk_plain,
                                subtree_fn=kbl.scl_subtree_plain, **kw)
        if schedule == "tree":
            n_k1 = len(dec._tree_scheds)
            n_k7 = _chunk_branches(dec.sched_tree, CHUNK_SCL)
        else:
            n_k7 = int((dec.classes == 0).sum())
            n_k1 = dec.n_chunks - n_k7
        sent, llr = channel(n_len, B12, int8)
        reset_counts()
        out = dec.decode(llr)
        launched = counts()
        k7_key, k1_key = f"{family},L={n_list}", f"float32,L={n_list}"
        if (launched["masked_scl_chunk"].get(k7_key) != n_k7
                or launched["scl_subtree"].get(k1_key, 0) != n_k1):
            raise AssertionError(f"{name}: launches {launched}, expected {n_k7} K7 "
                                 f"({k7_key}) and {n_k1} K1 a decode")
        k7_calls, k1_calls = [], []  # this decode's calls, timed in phase 42

        def record7(*a, _c=k7_calls, **k):
            _c.append((a, k))
            return lk.masked_scl_chunk(*a, **k)

        def record1(*a, _c=k1_calls):
            _c.append(a)
            return kbl.scl_subtree(*a)

        dec.chunk_fn, dec.subtree_fn = record7, record1
        word, met = dec.decode_packed(llr)
        if timed:
            recorded[(family, n_list)] = (k7_calls, k1_calls, name)
        words = kbl.n_words(n_list)
        if word.shape != ((n_len, B12) if words == 1 else (words, n_len, B12)):
            raise AssertionError(f"{name}: packed words of shape {tuple(word.shape)}")
        if held_plain:
            x_eq, out_eq, word_eq, met_eq = llr, out, word, met
            if n_len != N_I8:
                eq = LargeSCLDecoder(N_I8, codes[N_I8][0], **kw)
                x_eq = channel(N_I8, B12, int8)[1]
                out_eq = eq.decode(x_eq)
                word_eq, met_eq = eq.decode_packed(x_eq)
            pword, pmet = plain.decode_packed(x_eq)
            _equal(f"{name} packed words", word_eq, pword)
            _equal(f"{name} metrics", met_eq, pmet)
            plain.decode_packed = lambda _, w=(pword, pmet): w  # its decisions from its words
            _same_decisions(name, out_eq, plain.decode(x_eq))
        wrong = (out[0] != sent).any(1)
        if (~out[2] & ~wrong).any():
            raise AssertionError(f"{name}: a block with a failed CRC decoded right")
        runs[name] = {"launches": launched, "k7": n_k7, "k1": n_k1,
                      "block_errors": int(wrong.sum()), "crc_failures": int((~out[2]).sum())}
        emit({"path": name, "n": n_len, "list_size": n_list, "schedule": schedule,
              "batch": B12, "ebn0_db": EBN0_DB, "held_against_plain_route": held_plain,
              "plain_route_n": N_I8,
              **runs[name], "card": card})
    print("K7 and K1 at L = 3, 64, 128 (float32, both schedules, bf16 carry) and K7 char "
          "at L = 3, 64: kernel routes == plain routes, words and metrics exactly; L = 1 "
          "decoded")

    # 42 ------------------------------------------------------------------
    phase("42 times: K7 per call at L = 1, 3, 64, 128 beside its bound and the device-memory "
          "kernel's on the same calls at L = 64, 128, K1 at L = 1, launches per decode, "
          "CA-SCL-64 decode ms and busy share, phase 17's K7 at L = 8")
    entries = []
    sched7 = {sub: lk.scl_chunk_schedule(CHUNK_SCL, sub).tolist() for sub in (0, SUB)}
    med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    for (family, n_list), (k7_calls, k1_calls, name) in recorded.items():
        picks = spread(k7_calls, [])
        ms = [time_cuda(lambda c=c: lk.masked_scl_chunk(*c[0], **c[1]), reps=REPS)
              for c in picks]
        i = ms.index(med(ms))
        args, kw = picks[i]
        plain_ms = time_cuda(lambda: lk.masked_scl_chunk_plain(*args, **kw), warmup=0, reps=1)
        wide_ms = None  # the device-memory kernel on the same call, side by side
        if n_list > 32:
            wide = _build.load("scl_wide")
            if not all(torch.equal(a, b) for a, b in zip(
                    lk.launch_scl_wide(wide, *args, **kw), lk.masked_scl_chunk(*args, **kw))):
                raise AssertionError(f"K7 L={n_list}: the two kernels differ")
            wide_ms = [time_cuda(lambda c=c: lk.launch_scl_wide(wide, *c[0], **c[1]), reps=REPS)
                       for c in picks]
        sub_cls = args[3]
        work = k7_work(sched7[SUB if sub_cls is not None else 0],
                       [] if sub_cls is None else sub_cls.tolist(), n_list, args[0].shape[0])
        launches = sum(r["launches"]["masked_scl_chunk"].get(f"{family},L={n_list}", 0)
                       for r in runs.values())
        entry = {"name": f"masked_scl_chunk[{family},L={n_list}]", "route": "cuda",
                 "source": "polar_codes_torch/csrc/large_scl_lists.cu",
                 "redesigned": K7_NEW_DESIGN,
                 "replaces": "polar_codes_tpu/ops/large_kernel.py:149",
                 "launches": launches,
                 "launches_by_path": {p: r["launches"]["masked_scl_chunk"][f"{family},L={n_list}"]
                                      for p, r in runs.items()
                                      if f"{family},L={n_list}" in r["launches"]["masked_scl_chunk"]},
                 "launches_per_decode": len(k7_calls), "list_size": n_list,
                 "max_abs_err": held["err"][family], "ms": ms[i], "ms_per_call": ms, "plain_ms": plain_ms,
                 **bound(*work), "library_ms": None}
        if wide_ms is not None:
            entry["scl_wide_ms_per_call"] = wide_ms
        entries.append(entry)
        emit({"kernel": entry["name"], "batch": B12, "chunk": CHUNK_SCL, "ms_per_call": ms,
              "scl_wide_ms_per_call": wide_ms, "plain_ms": plain_ms,
              "bound_ms": entry["bound_ms"], "card": card})
        if n_list == 1:  # K1 at one path on the pure chunks
            k1 = _time_k1(k1_calls, B12)
            k1_launches = sum(r["launches"]["scl_subtree"].get("float32,L=1", 0)
                              for r in runs.values())
            entries.append({
                "name": "scl_subtree[float32,L=1]", "route": "cuda",
                "source": "polar_codes_torch/csrc/scl_subtree.cu", "redesigned": K1_NEW_DESIGN,
                "replaces": "polar_codes_tpu/ops/scl_kernel_bl.py:876",
                "launches": k1_launches, "launches_by_path": {name: k1_launches},
                "launches_per_decode": len(k1_calls), "list_size": 1,
                "max_abs_err": held["k1_err"],
                "ms": k1[0], "plain_ms": k1[1], **bound(k1[2], k1[3]), "library_ms": None})
    emit({"launches_per_decode": {name: r["launches"] for name, r in runs.items()},
          "card": card})
    times = {}
    for schedule in ("scan", "tree"):
        dec = LargeSCLDecoder(N_SCL, codes[N_SCL][0], list_size=64, detector=det,
                              chunk=CHUNK_SCL, subblock=SUB, schedule=schedule, device=dev)
        _, llr = channel(N_SCL, B12_TIME, False)
        ms = time_cuda(lambda: dec.decode(llr), warmup=1, reps=3)
        wall, busy = busy_share(lambda: dec.decode(llr), calls=1)
        times[schedule] = {"decode_ms": ms, "profiled_wall_ms": wall, "device_busy_ms": busy,
                           "busy_share": busy / wall,
                           "payload_mbps": B12_TIME * (K_SCL - det.tail_bits) / ms / 1e3}
    emit({"metric": "large_cascl64_decode", "n": N_SCL, "batch": B12_TIME, **times,
          "card": card})
    (args8, ms17) = k7_l8
    ms8 = time_cuda(lambda: lk.masked_scl_chunk(*args8), reps=REPS)
    emit({"kernel": "masked_scl_chunk[float32,L=8]", "batch": B3, "phase17_ms": ms17,
          "phase42_ms": ms8, "card": card})
    print(f"CA-SCL-64 decode at B = {B12_TIME}: scan {times['scan']['decode_ms']:.1f} ms, tree "
          f"{times['tree']['decode_ms']:.1f} ms; K7 at L = 8 {ms8:.4f} ms (phase 17 "
          f"{ms17:.4f})")
    return {"entries": entries}


# ---- slice 13: lists above 128 paths, list state in device memory --------

SEED13 = 20261027
WIDE_DESIGN = ("a block of 256 threads a codeword, the LLR levels in a device-memory "
               "scratch, the bookkeeping in shared memory, the prune a bitonic sort")
WIDE_K7_DESIGN = ("a block of 1024 threads a codeword, the LLR levels in a device-memory "
                  "scratch, the bookkeeping in shared memory, the prune a merge of lists "
                  "in rank order")
WIDE_SRC = "polar_codes_torch/csrc/scl_wide.cu"
K1_WIDE_LISTS = (129, 160, 256, 512)
K1_WIDE_BATCHES = (1, 181, 256)  # rotated over (L, family): every L sees every batch
K1_PAST_SMEM = ((128, 512), (64, 1024))  # (L, kernel_span): branched spans past shared memory
K7_WIDE_LISTS = (129, 160, 256)
K7_PAST_SMEM = ((128, 512), (64, 1024))  # (L, chunk) past shared memory at L <= 128
K7_WIDE_BATCHES = (1, 33)
B13, B13_L512, B13_LARGE, EBN0_13 = 256, 64, 32, 1.5
N_EQ13, K_EQ13 = 8192, 4096  # the large-N plain-route checks (N = 32768 at L = 256: slow)
# phase 45's N = 1024 paths: (name, L, dtype, batch, kernel_span)
PATHS13 = (("cascl256_float32", 256, "float32", B13, None),
           ("cascl256_int8", 256, "int8", B13, None),
           ("cascl256_bfloat16", 256, "bfloat16", B13, None),
           ("cascl512_float32", 512, "float32", B13_L512, None),
           ("cascl128_span512", 128, "float32", B13, 512))


def _wide_count():
    from polar_codes_torch.ops import large_kernel as lk
    from polar_codes_torch.ops import scl_kernel_bl as kbl

    return sum(kbl.WIDE_LAUNCHES.values()) + sum(lk.SCL_WIDE_LAUNCHES.values())


def run_k1_wide(card):
    """Phase 43. K1 against its plain version at L in K1_WIDE_LISTS, every
    family, B rotating through K1_WIDE_BATCHES (each L at every batch):
    every subtree call of an N = 1024 CA-SCL decode on integer LLRs in
    [-2, 2] (ties, signed zeros; the widening calls at one path and the
    calls at L); then L = 128 at kernel_span 512 and L = 64 at kernel_span
    1024, whose branched state exceeds shared memory, at B = 181. Every
    call goes through the device-memory kernel; bits, perms and metrics
    equal. Returns {"err": the largest metric difference per family (0),
    "calls": the number held}."""
    import torch

    from polar_codes_torch.construction import frozen_bits
    from polar_codes_torch.models.detectors import CRC16
    from polar_codes_torch.models.scl import SCLDecoder
    from polar_codes_torch.ops import scl_kernel_bl as kbl

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED13)
    frozen = frozen_bits(N_LEN, K_LEN, 0.0, "BB")
    err = {"float32": 0.0, "char": 0.0, "bfloat16": 0.0}
    fams = list(_fams())
    cases = [(n_list, dtype, K1_WIDE_BATCHES[(i + j) % 3], None)
             for i, n_list in enumerate(K1_WIDE_LISTS) for j, dtype in enumerate(fams)]
    cases += [(n_list, torch.float32, 181, span) for n_list, span in K1_PAST_SMEM]
    checked = 0
    for n_list, dtype, n_batch, span in cases:
        calls = []

        def record(sched, x, m):
            out = kbl.scl_subtree_plain(sched, x, m)
            calls.append((sched, x, m, out))
            return out

        x0 = torch.randint(-2, 3, (n_batch, N_LEN), generator=gen, device=dev).to(dtype)
        SCLDecoder(N_LEN, frozen, list_size=n_list, detector=CRC16(), dtype=dtype,
                   kernel_span=span, device=dev, subtree_fn=record).decode_packed(x0)
        wide = _wide_count()
        for sched, x, m, want in calls:
            where = (f"K1 {kbl.family(x.dtype).name} L={n_list} B={n_batch} span "
                     f"{sched.span} at {sched.node.offset}, w {sched.w_in}->{sched.w_out}")
            got = kbl.scl_subtree(sched, x, m)
            _equal(where + " bits", got[0], want[0])
            _equal(where + " perm", got[1], want[1])
            if not torch.isfinite(got[2]).all():
                raise AssertionError(where + ": metrics not finite")
            fam = kbl.family(x.dtype).name
            err[fam] = max(err[fam], _equal(where + " metrics", got[2], want[2]))
            checked += 1
        torch.cuda.synchronize()
        if _wide_count() - wide != len(calls) or not calls:
            raise AssertionError(f"K1 L={n_list} span {span}: {len(calls)} calls, "
                                 f"{_wide_count() - wide} through the device-memory kernel")
    emit({"k1_wide_checked_calls": checked, "lists": K1_WIDE_LISTS,
          "past_shared_memory": K1_PAST_SMEM, "max_abs_err": err, "card": card})
    print(f"K1: {checked} calls from device memory at L in {K1_WIDE_LISTS} (every family) "
          f"and {K1_PAST_SMEM} (L, span), bit-equal to the plain version")
    return {"err": err, "calls": checked}


def run_k7_wide(card):
    """Phase 44. K7 against its plain version at L in K7_WIDE_LISTS, both
    families, chunks of 64 and 256, B in K7_WIDE_BATCHES, with and without
    sub-blocks of every class, on integer LLRs in [-2, 2]: rows with one
    live path and rows with L - 1 (every other row each; the re-take
    rule), all rows live (out of rank order), rows in rank order with a
    _NEG tail on an all-frozen chunk of 256, and rows out of rank order
    with _NEG at random slots; then L = 128 at chunk 512 and L = 64 at
    chunk 1024. Every call through the device-memory kernel; bits, perms
    and metrics equal. Returns {"err": per family, "calls": n, "timed": {name:
    (args, family)} of the calls phase 46 times}."""
    import numpy as np
    import torch

    from polar_codes_torch.models.large import _classify_chunks
    from polar_codes_torch.ops import large_kernel as lk

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED13 + 1)
    # sub-blocks of 16: rate-0, mixed, rate-1, rep, spc
    head = torch.as_tensor(np.concatenate([_class_mask64(), np.arange(16) == 0]),
                           dtype=torch.uint8, device=dev)
    err = {"float32": 0.0, "char": 0.0}
    checked = 0
    timed = {}

    def metrics(n_batch, n_list, how):
        met = torch.randint(-3, 1, (n_batch, n_list), generator=gen, device=dev).to(torch.float32)
        if how == "1 and L-1 live":
            met[0::2, 1:] = NEG  # one live path
            met[1::2, -1] = NEG  # L - 1 live paths
        elif how == "ranked":  # in rank order, 1 to L live, then _NEG
            n_live = torch.randint(1, n_list + 1, (n_batch, 1), generator=gen, device=dev)
            rank = torch.arange(n_list, device=dev)[None]
            met = torch.where(rank < n_live, met.sort(1, descending=True).values, NEG)
        elif how == "_NEG at random slots":  # out of rank order
            met[torch.rand((n_batch, n_list), generator=gen, device=dev) < 0.3] = NEG
        return met

    def mask_of(m_len, how):  # every sub-block class, then rate-0 runs at every span
        if how == "ranked":
            return torch.ones(m_len, dtype=torch.uint8, device=dev)
        mask = rate0_mask(m_len, gen, dev)
        cls = head if m_len > head.numel() else head[16:]
        mask[: cls.numel()] = cls
        return mask

    cases = [(n_list, m_len, n_batch, sub, how)
             for n_list in K7_WIDE_LISTS for m_len in (64, CHUNK_SCL)
             for n_batch, sub, how in ((K7_WIDE_BATCHES[1], True, "1 and L-1 live"),
                                       (K7_WIDE_BATCHES[0], False, "live"))]
    cases += [(n_list, m_len, K7_WIDE_BATCHES[1], sub, how) for n_list in K7_WIDE_LISTS
              for m_len, sub, how in ((CHUNK_SCL, False, "ranked"),
                                      (64, True, "_NEG at random slots"))]
    cases += [(n_list, m_len, K7_WIDE_BATCHES[1], True, "1 and L-1 live")
              for n_list, m_len in K7_PAST_SMEM]
    for n_list, m_len, n_batch, with_sub, how in cases:
        if lk.scl_library(n_list, m_len, SUB if with_sub else 0) != "scl_wide":
            raise AssertionError(f"K7 L={n_list} chunk {m_len}: not the device-memory kernel")
        mask = mask_of(m_len, how)
        sub_cls = None
        if with_sub:
            codes = _classify_chunks(list(mask.cpu().numpy().astype(bool).reshape(-1, SUB)))
            sub_cls = torch.as_tensor(codes, device=dev)
        x = torch.randint(-2, 3, (n_batch, n_list, m_len), generator=gen, device=dev).float()
        met = metrics(n_batch, n_list, how)
        for family in ("float32", "char"):
            where = (f"K7 {family} L={n_list} chunk {m_len} B={n_batch} sub-blocks "
                     f"{with_sub}, {how}" + (", all frozen" if how == "ranked" else ""))
            got = lk.masked_scl_chunk(x, mask, met, sub_cls, family)
            want = lk.masked_scl_chunk_plain(x, mask, met, sub_cls, family)
            _equal(where + ": bits", got[0], want[0])
            _equal(where + ": perm", got[1], want[1])
            err[family] = max(err[family], _equal(where + ": metrics", got[2], want[2]))
            checked += 1
            # phase 46 times the shapes a phase-45 path runs
            if with_sub and (n_list == 256 and m_len == CHUNK_SCL and family == "char"
                             or (n_list, m_len) == (128, 512) and family == "float32"):
                timed[f"masked_scl_chunk[{family},L={n_list},chunk={m_len}]"] = (
                    (x, mask, met, sub_cls), family)
    torch.cuda.synchronize()
    emit({"k7_wide_checked_calls": checked, "lists": K7_WIDE_LISTS,
          "past_shared_memory": K7_PAST_SMEM, "max_abs_err": err, "card": card})
    print(f"K7: {checked} calls from device memory at L in {K7_WIDE_LISTS} and (L, chunk) in "
          f"{K7_PAST_SMEM}, both families, bit-equal to the plain version")
    return {"err": err, "calls": checked, "timed": timed}


def run_slice13(card, k1_held, k7_held):
    """Phases 45-46. k1_held, k7_held: phases 43 and 44's results. Returns
    {"entries": the new kernels-line entries}."""
    import shutil
    import tempfile

    import torch

    from polar_codes_torch.construction import frozen_bits
    from polar_codes_torch.dsp import Awgn, Bpsk
    from polar_codes_torch.models.detectors import CRC16
    from polar_codes_torch.models.encoder import PolarEncoder
    from polar_codes_torch.models.large import LargeSCLDecoder
    from polar_codes_torch.models.scl import SCLDecoder
    from polar_codes_torch.ops import large_kernel as lk
    from polar_codes_torch.ops import scl_kernel_bl as kbl
    from polar_codes_torch.utils.timing import time_cuda

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED13 + 2)
    det = CRC16()
    modem = Bpsk()
    dtypes = {"float32": torch.float32, "int8": torch.int8, "bfloat16": torch.bfloat16}
    frozen_of = {}

    def channel(n_len, k_len, n_blocks, ebn0_db):
        if n_len not in frozen_of:
            fz = frozen_bits(n_len, k_len, 0.0, "BB")
            frozen_of[n_len] = (fz, PolarEncoder(n_len, fz, systematic=True, detector=det,
                                                 device=dev))
        info = torch.randint(0, 2, (n_blocks, k_len), generator=gen, device=dev,
                             dtype=torch.uint8)
        chan = Awgn()
        chan.set_esn0_linear(10.0 ** (ebn0_db / 10.0) * k_len / n_len)
        code = frozen_of[n_len][1].encode(info)
        return det.generate(info), modem.demodulate(chan.transmit(modem.modulate(code), gen))

    def reset_counts():
        kbl.LAUNCHES.update(dict.fromkeys(kbl.LAUNCHES, 0))
        kbl.WIDE_LAUNCHES.update(dict.fromkeys(kbl.WIDE_LAUNCHES, 0))
        kbl.LIST_LAUNCHES.clear()
        lk.LAUNCHES.update(dict.fromkeys(lk.LAUNCHES, 0))
        lk.SCL_WIDE_LAUNCHES.update(dict.fromkeys(lk.SCL_WIDE_LAUNCHES, 0))
        lk.SCL_LIST_LAUNCHES.clear()

    def counts():
        torch.cuda.synchronize()
        return {"scl_subtree": dict(kbl.LAUNCHES), "scl_subtree_wide": dict(kbl.WIDE_LAUNCHES),
                "scl_subtree_by_list": dict(sorted(kbl.LIST_LAUNCHES.items())),
                "masked_scl_chunk_wide": dict(lk.SCL_WIDE_LAUNCHES),
                "masked_scl_chunk_by_list": {f"{f},L={n}": c for (f, n), c in
                                             sorted(lk.SCL_LIST_LAUNCHES.items())}}

    def wrong_and_checked(what, out, sent):
        wrong = (out[0] != sent).any(1)
        if (~out[2] & ~wrong).any():
            raise AssertionError(f"{what}: a block with a failed CRC decoded right")
        return int(wrong.sum()), int((~out[2]).sum())

    def held(name, dec, plain, x):
        """dec's route == plain's: packed words exact, metrics within TOL,
        decisions equal. Returns the largest metric difference."""
        word, met = dec.decode_packed(x)
        pword, pmet = plain.decode_packed(x)
        _equal(f"{name} packed words", word, pword)
        torch.testing.assert_close(met, pmet, rtol=TOL, atol=TOL)
        plain.decode_packed = lambda _, w=(pword, pmet): w  # its decisions from its words
        _same_decisions(name, dec.decode(x), plain.decode(x))
        return max_err(met, pmet)

    # 45 ------------------------------------------------------------------
    phase(f"45 ({N_LEN}, {K_LEN}) CRC16 CA-SCL-256 (float32, int8, bf16) at B = {B13}, "
          f"CA-SCL-512 at B = {B13_L512}, CA-SCL-128 at kernel_span 512, {EBN0_13} dB; "
          f"listlength --l-min 64 --l-max 256; ({N_SCL}, {K_SCL}) CA-SCL-256 on both "
          f"schedules at B = {B13_LARGE}; kernel route == plain route")
    runs, k1_calls = {}, {}
    sent, llr = channel(N_LEN, K_LEN, B13, EBN0_13)
    quant = torch.clamp(torch.round(llr * AMPL), -127, 127).to(torch.int8)
    inputs = {"float32": llr, "int8": quant, "bfloat16": llr}
    ref64 = {}
    for kind, dtype in dtypes.items():
        out = SCLDecoder(N_LEN, frozen_of[N_LEN][0], list_size=64, detector=det, dtype=dtype,
                         device=dev).decode(inputs[kind])
        ref64[kind] = wrong_and_checked(f"CA-SCL-64 {kind}", out, sent)[0]
    for name, n_list, kind, n_batch, span in PATHS13:
        dtype, x = dtypes[kind], inputs[kind][:n_batch]
        kw = dict(list_size=n_list, detector=det, dtype=dtype, kernel_span=span, device=dev)
        dec = SCLDecoder(N_LEN, frozen_of[N_LEN][0], **kw)
        plain = SCLDecoder(N_LEN, frozen_of[N_LEN][0], subtree_fn=kbl.scl_subtree_plain, **kw)
        reset_counts()
        out = dec.decode(x)
        launched = counts()
        fam = kbl.family(_fams()[dtype]).name
        if not (launched["scl_subtree_by_list"].get(n_list)
                and launched["scl_subtree_wide"][fam]):
            raise AssertionError(f"{name}: K1 from device memory never launched at L = "
                                 f"{n_list}: {launched}")
        wrong, failed = wrong_and_checked(name, out, sent[:n_batch])
        wrong64 = ref64[kind]
        if n_batch != B13:  # CA-SCL-64 on the same blocks
            wrong64 = wrong_and_checked(f"CA-SCL-64 {kind} B={n_batch}", SCLDecoder(
                N_LEN, frozen_of[N_LEN][0], list_size=64, detector=det, dtype=dtype,
                device=dev).decode(x), sent[:n_batch])[0]
        if wrong > wrong64 + 2:
            raise AssertionError(f"{name}: {wrong} wrong blocks, CA-SCL-64 {wrong64}")
        err = held(name, dec, plain, x)
        calls = []

        def record(sched, xx, m, _c=calls):
            _c.append((sched, xx, m))
            return kbl.scl_subtree(sched, xx, m)

        SCLDecoder(N_LEN, frozen_of[N_LEN][0], subtree_fn=record, **kw).decode_packed(x)
        k1_calls[name] = (calls, n_batch)
        runs[name] = {"launches": launched, "block_errors": wrong, "crc_failures": failed,
                      "scl64_block_errors": wrong64, "max_abs_metric_err": err,
                      "k1_launches_per_decode": len(calls)}
        emit({"path": name, "n": N_LEN, "list_size": n_list, "dtype": kind,
              "kernel_span": dec.kernel_span, "batch": n_batch, "ebn0_db": EBN0_13,
              **runs[name], "card": card})

    tmp = tempfile.mkdtemp(prefix="chip_smoke_s13_")
    try:
        reset_counts()
        argv = ["listlength", "-n", str(N_LEN), "-r", "0.5", "--l-min", "64", "--l-max", "256",
                "--snr-count", "1", "--snr-min", str(EBN0_13), "--snr-max", str(EBN0_13),
                "--batch", str(B13), "-w", str(B13 * N_LEN), "-o", f"{tmp}/ll"]
        t0 = time.perf_counter()
        text, rows = _sim(argv)
        wall = time.perf_counter() - t0
        ll_counts = counts()
        lists = [int(r["L"]) for r in rows]
        if (lists != [64, 128, 256] or any(int(r["Runs"]) != B13 for r in rows)
                or not ll_counts["scl_subtree_by_list"].get(256)
                or not ll_counts["scl_subtree_wide"]["float32"]):
            raise AssertionError(f"listlength: lists {lists}, rows {rows}, {ll_counts}")
        runs["pcsim_cli_listlength"] = {"launches": ll_counts}
        emit({"path": "pcsim_cli_listlength", "lists": lists,
              "bler": [float(r["BLER"]) for r in rows], "wall_s": wall,
              "jobs": _job_shares(text), "launches": ll_counts, "card": card})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    k7_calls, tree_calls = [], []
    sent_l, llr_l = channel(N_SCL, K_SCL, B13_LARGE, EBN0_DB)
    large_kw = dict(detector=det, chunk=CHUNK_SCL, subblock=SUB, device=dev)
    wrong64_l = wrong_and_checked("large CA-SCL-64", LargeSCLDecoder(
        N_SCL, frozen_of[N_SCL][0], list_size=64, **large_kw).decode(llr_l), sent_l)[0]
    for schedule in ("scan", "tree"):
        name = f"large_cascl256_{schedule}"
        dec = LargeSCLDecoder(N_SCL, frozen_of[N_SCL][0], list_size=256, schedule=schedule,
                              **large_kw)
        reset_counts()
        out = dec.decode(llr_l)
        launched = counts()
        if not (launched["masked_scl_chunk_by_list"].get("float32,L=256")
                and launched["masked_scl_chunk_wide"]["float32"]
                and launched["scl_subtree_by_list"].get(256)
                and launched["scl_subtree_wide"]["float32"]):
            raise AssertionError(f"{name}: K7 and K1 from device memory at L = 256: {launched}")
        wrong, failed = wrong_and_checked(name, out, sent_l)
        if wrong > wrong64_l + 2:
            raise AssertionError(f"{name}: {wrong} wrong blocks, CA-SCL-64 {wrong64_l}")
        if schedule == "scan":
            def record7(*a, **k):
                k7_calls.append((a, k))
                return lk.masked_scl_chunk(*a, **k)

            dec.chunk_fn = record7
        else:
            def record1(*a):
                tree_calls.append(a)
                return kbl.scl_subtree(*a)

            dec.subtree_fn = record1
        dec.decode_packed(llr_l)
        runs[name] = {"launches": launched, "block_errors": wrong, "crc_failures": failed,
                      "scl64_block_errors": wrong64_l}
        emit({"path": name, "n": N_SCL, "list_size": 256, "batch": B13_LARGE,
              "ebn0_db": EBN0_DB, **runs[name], "card": card})

    sent_e, llr_e = channel(N_EQ13, K_EQ13, B13_LARGE, EBN0_DB)
    quant_e = torch.clamp(torch.round(llr_e * AMPL), -127, 127).to(torch.int8)
    for name, n_list, chunk, schedule, int8 in (
            ("large_eq_cascl256_scan", 256, CHUNK_SCL, "scan", False),
            ("large_eq_cascl256_tree", 256, CHUNK_SCL, "tree", False),
            ("large_eq_cascl256_int8", 256, CHUNK_SCL, "scan", True),
            ("large_eq_cascl128_chunk512", 128, 512, "scan", False)):
        family = "char" if int8 else "float32"
        kw = dict(list_size=n_list, detector=det, chunk=chunk, subblock=SUB,
                  schedule=schedule, dtype=torch.int8 if int8 else torch.float32, device=dev)
        dec = LargeSCLDecoder(N_EQ13, frozen_of[N_EQ13][0], **kw)
        plain = LargeSCLDecoder(N_EQ13, frozen_of[N_EQ13][0], **kw,
                                chunk_fn=lk.masked_scl_chunk_plain,
                                subtree_fn=kbl.scl_subtree_plain)
        x = quant_e if int8 else llr_e
        reset_counts()
        out = dec.decode(x)
        launched = counts()
        if not launched["masked_scl_chunk_wide"][family]:
            raise AssertionError(f"{name}: K7 from device memory never launched: {launched}")
        wrong, failed = wrong_and_checked(name, out, sent_e)
        t0 = time.perf_counter()
        err = held(name, dec, plain, x)
        runs[name] = {"launches": launched, "block_errors": wrong, "crc_failures": failed,
                      "max_abs_metric_err": err,
                      "plain_route_s": time.perf_counter() - t0}
        emit({"path": name, "n": N_EQ13, "list_size": n_list, "chunk": chunk,
              "schedule": schedule, "batch": B13_LARGE, "ebn0_db": EBN0_DB, **runs[name],
              "card": card})
    print("CA-SCL-256/512 at N = 1024 and N = 32768 decoded through the device-memory "
          "kernels; kernel routes == plain routes at N = 1024 and 8192")

    # 46 ------------------------------------------------------------------
    phase("46 times: K1 per decode at L = 256 (every family), 512 and 128 at span 512, K7 per "
          "call at L = 256 and 128 at chunk 512, decode ms and device busy share")
    entries = []

    def k1_times(calls, n_batch):
        """(ms per call, their sum, plain ms of all (~2-4 s a decode: timed
        once), bytes, operations) of a decode's K1 calls."""
        per_call = [time_cuda(lambda c=c: kbl.scl_subtree(*c[:3]), reps=3) for c in calls]
        plain_ms = sum(time_cuda(lambda c=c: kbl.scl_subtree_plain(*c[:3]), warmup=0, reps=1)
                       for c in calls)
        n_bytes = n_ops = 0
        for sched, x, *_ in calls:
            nb, no = k1_work(sched, n_batch, x.element_size())
            n_bytes, n_ops = n_bytes + nb, n_ops + no
        return per_call, sum(per_call), plain_ms, n_bytes, n_ops

    for name, (calls, n_batch) in k1_calls.items():
        n_list = dict((p[0], p[1]) for p in PATHS13)[name]
        kind = dict((p[0], p[2]) for p in PATHS13)[name]
        fam = kbl.family(_fams()[dtypes[kind]]).name
        per_call, ms, plain_ms, n_bytes, n_ops = k1_times(calls, n_batch)
        span = dict((p[0], p[4]) for p in PATHS13)[name]
        label = f"scl_subtree[{fam},L={n_list}" + (f",span={span}]" if span else "]")
        by_path = {name: runs[name]["launches"]["scl_subtree_wide"][fam]}
        if name == "cascl256_float32":
            by_path["pcsim_cli_listlength"] = runs["pcsim_cli_listlength"]["launches"][
                "scl_subtree_by_list"][256]
            by_path["large_cascl256_tree"] = runs["large_cascl256_tree"]["launches"][
                "scl_subtree_wide"]["float32"]
            by_path["large_cascl256_scan"] = runs["large_cascl256_scan"]["launches"][
                "scl_subtree_wide"]["float32"]
        entries.append({
            "name": label, "route": "cuda", "source": WIDE_SRC, "redesigned": WIDE_DESIGN,
            "replaces": "polar_codes_tpu/ops/scl_kernel_bl.py:876",
            "launches": by_path[name], "launches_by_path": by_path,
            "launches_per_decode": len(calls), "list_size": n_list, "batch": n_batch,
            "max_abs_err": max(k1_held["err"][fam], runs[name]["max_abs_metric_err"]),
            "ms": ms, "ms_per_call": per_call, "plain_ms": plain_ms,
            **bound(n_bytes, n_ops), "library_ms": None})
        emit({"kernel": label, "batch": n_batch, "ms_per_decode": ms, "ms_per_call": per_call,
              "plain_ms": plain_ms, "bound_ms": entries[-1]["bound_ms"], "card": card})
    if tree_calls:  # the tree schedule's pure leaves at L = 256, from device memory
        leaf = k1_times(tree_calls, B13_LARGE)
        emit({"kernel": "scl_subtree[float32,L=256] tree leaves", "batch": B13_LARGE,
              "ms_per_decode": leaf[1], "plain_ms": leaf[2], "calls": len(tree_calls),
              **bound(leaf[3], leaf[4]), "card": card})
    sched7 = {sub: lk.scl_chunk_schedule(CHUNK_SCL, sub).tolist() for sub in (0, SUB)}
    picks = spread(k7_calls, [])
    ms = [time_cuda(lambda c=c: lk.masked_scl_chunk(*c[0], **c[1]), reps=3) for c in picks]
    med = sorted(ms)[len(ms) // 2]
    args, kw = picks[ms.index(med)]
    plain_ms = time_cuda(lambda: lk.masked_scl_chunk_plain(*args, **kw), warmup=0, reps=1)
    work = k7_work(sched7[SUB if args[3] is not None else 0],
                   [] if args[3] is None else args[3].tolist(), 256, B13_LARGE)
    k7_paths = {p: r["launches"]["masked_scl_chunk_by_list"]["float32,L=256"]
                for p, r in runs.items()
                if r["launches"]["masked_scl_chunk_by_list"].get("float32,L=256")}
    entries.append({
        "name": "masked_scl_chunk[float32,L=256]", "route": "cuda", "source": WIDE_SRC,
        "redesigned": WIDE_K7_DESIGN, "replaces": "polar_codes_tpu/ops/large_kernel.py:149",
        "launches": runs["large_cascl256_scan"]["launches"]["masked_scl_chunk_wide"]["float32"],
        "launches_by_path": k7_paths, "launches_per_decode": len(k7_calls), "list_size": 256,
        "batch": B13_LARGE, "max_abs_err": k7_held["err"]["float32"], "ms": med,
        "ms_per_call": ms, "plain_ms": plain_ms, **bound(*work), "library_ms": None})
    emit({"kernel": "masked_scl_chunk[float32,L=256]", "batch": B13_LARGE, "ms_per_call": ms,
          "plain_ms": plain_ms, "bound_ms": entries[-1]["bound_ms"], "card": card})
    for label, ((x, mask, met, sub_cls), family) in k7_held["timed"].items():
        kms = time_cuda(lambda: lk.masked_scl_chunk(x, mask, met, sub_cls, family), reps=3)
        pms = time_cuda(lambda: lk.masked_scl_chunk_plain(x, mask, met, sub_cls, family),
                        warmup=0, reps=1)
        m_len, n_list = x.shape[2], x.shape[1]
        work = k7_work(lk.scl_chunk_schedule(m_len, SUB).tolist(), sub_cls.tolist(), n_list,
                       x.shape[0])
        path = "large_eq_cascl128_chunk512" if family == "float32" else "large_eq_cascl256_int8"
        launches = runs[path]["launches"]["masked_scl_chunk_wide"][family]
        entries.append({
            "name": label, "route": "cuda", "source": WIDE_SRC, "redesigned": WIDE_K7_DESIGN,
            "replaces": "polar_codes_tpu/ops/large_kernel.py:149", "launches": launches,
            "launches_by_path": {path: launches}, "list_size": n_list,
            "batch": x.shape[0], "max_abs_err": k7_held["err"][family], "ms": kms,
            "plain_ms": pms, **bound(*work), "library_ms": None})
        emit({"kernel": label, "batch": x.shape[0], "ms": kms, "plain_ms": pms,
              "bound_ms": entries[-1]["bound_ms"], "card": card})
    times = {}
    dec = SCLDecoder(N_LEN, frozen_of[N_LEN][0], list_size=256, detector=det, device=dev)
    ms = time_cuda(lambda: dec.decode(llr), warmup=1, reps=3)
    wall, busy = busy_share(lambda: dec.decode(llr), calls=1)
    times["cascl256_n1024"] = {"batch": B13, "decode_ms": ms, "profiled_wall_ms": wall,
                               "device_busy_ms": busy, "busy_share": busy / wall,
                               "payload_mbps": B13 * (K_LEN - det.tail_bits) / ms / 1e3}
    for schedule in ("scan", "tree"):
        dec = LargeSCLDecoder(N_SCL, frozen_of[N_SCL][0], list_size=256, schedule=schedule,
                              **large_kw)
        ms = time_cuda(lambda: dec.decode(llr_l), warmup=1, reps=2)
        wall, busy = busy_share(lambda: dec.decode(llr_l), calls=1)
        times[f"large_cascl256_{schedule}"] = {
            "batch": B13_LARGE, "decode_ms": ms, "profiled_wall_ms": wall,
            "device_busy_ms": busy, "busy_share": busy / wall,
            "payload_mbps": B13_LARGE * (K_SCL - det.tail_bits) / ms / 1e3}
    emit({"metric": "cascl256_decode", **times, "card": card})
    print(f"CA-SCL-256: N = 1024 {times['cascl256_n1024']['decode_ms']:.1f} ms at B = {B13}; "
          f"N = {N_SCL} scan {times['large_cascl256_scan']['decode_ms']:.1f} ms, tree "
          f"{times['large_cascl256_tree']['decode_ms']:.1f} ms at B = {B13_LARGE}")
    return {"entries": entries, "times": times}


# ---- slice 14: the pypolar facade ------------------------------------------

SEED14 = 20261028
B14, BATCHES14 = 1024, 4  # the main path's batch and calls: ~15 block errors at 2 dB
B14_ADAPTIVE, B14_SCL_LARGE, B14_SC_LARGE = 2048, 32, 16
N_SC14, K_SC14 = 131072, 65536
FACADE_REPS = 10
# (route, N, K, list size, type string, CRC bits, batch): each route's facade
# decode equals the port's model called directly; KERNELS14 names the
# launch counts that must be non-zero after it
ROUTES14 = (
    ("char_l8", N_LEN, K_LEN, 8, "char", 16, B14),
    ("mixed_l8_crc32", N_LEN, K_LEN, 8, "mixed", 32, B14_ADAPTIVE),
    ("scan_l4", N_LEN, K_LEN, 4, "scan", 16, B14),
    ("float_l1", N_LEN, K_LEN, 1, "float", 16, B14),
    ("char_l1", N_LEN, K_LEN, 1, "char", 16, B14),
    ("large_float_l8", N_SCL, K_SCL, 8, "float", 16, B14_SCL_LARGE),
    ("large_char_l8", N_SCL, K_SCL, 8, "char", 16, B14_SCL_LARGE),
    ("large_float_l1", N_SC14, K_SC14, 1, "float", 16, B14_SC_LARGE),
)
KERNELS14 = {
    "encode": ("butterfly_encode",),
    "float_l8": ("scl_subtree[float32]",),
    "float_l8_one_vector": ("scl_subtree[float32]",),
    "char_l8": ("scl_subtree[char]",),
    "mixed_l8_crc32": ("fastssc_subtree[float32]", "scl_subtree[float32]"),
    "scan_l4": ("scan_fused",),
    "float_l1": ("fastssc_subtree[float32]",),
    "char_l1": ("fastssc_subtree[int8]",),
    "large_float_l8": ("masked_scl_chunk[float32]", "scl_subtree[float32]"),
    "large_char_l8": ("masked_scl_chunk[char]",),
    "large_float_l1": ("masked_sc_chunk[float32]",),
}


def _reset_all_counts():
    from polar_codes_torch.ops import butterfly_kernel as bk
    from polar_codes_torch.ops import fastssc_kernel as fk
    from polar_codes_torch.ops import large_kernel as lk
    from polar_codes_torch.ops import scan_kernel as sk
    from polar_codes_torch.ops import scl_kernel_bl as kbl

    bk.LAUNCHES = 0
    for counts in (kbl.LAUNCHES, kbl.WIDE_LAUNCHES, fk.LAUNCHES, sk.LAUNCHES, lk.LAUNCHES,
                   lk.SCL_WIDE_LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))
    kbl.LIST_LAUNCHES.clear()
    lk.SCL_LIST_LAUNCHES.clear()


def _all_counts():
    """Every kernel's launch count since the last reset, by the kernels
    line's names; zeros left out."""
    import torch

    from polar_codes_torch.ops import butterfly_kernel as bk
    from polar_codes_torch.ops import fastssc_kernel as fk
    from polar_codes_torch.ops import large_kernel as lk
    from polar_codes_torch.ops import scan_kernel as sk
    from polar_codes_torch.ops import scl_kernel_bl as kbl

    torch.cuda.synchronize()
    counts = {"butterfly_encode": bk.LAUNCHES,
              **{f"scl_subtree[{f}]": c for f, c in kbl.LAUNCHES.items()},
              **{f"fastssc_subtree[{f}]": c for f, c in fk.LAUNCHES.items()},
              "scan_fused": sk.LAUNCHES["fused"], "scan_step": sk.LAUNCHES["step"],
              "masked_sc_chunk[float32]": lk.LAUNCHES["sc"],
              "masked_sc_chunk[char]": lk.LAUNCHES["sc_char"],
              "masked_scl_chunk[float32]": lk.LAUNCHES["scl"],
              "masked_scl_chunk[char]": lk.LAUNCHES["scl_char"]}
    return {k: v for k, v in counts.items() if v}


def run_slice14(card):
    """Phases 47-48: the pypolar facade (polar_codes_torch.pypolar) on the
    card, every route against the port's model called directly, and its
    times. Returns {"routes": launches by route, "by_kernel": {kernel:
    {path: launches}}, "times": phase 48's numbers}."""
    import statistics

    import numpy as np
    import torch

    from polar_codes_torch import pypolar
    from polar_codes_torch.dsp import Awgn, Bpsk
    from polar_codes_torch.models.adaptive import AdaptiveDecoder
    from polar_codes_torch.models.detectors import make_detector
    from polar_codes_torch.models.encoder import PolarEncoder
    from polar_codes_torch.models.fastssc import FastSSCDecoder
    from polar_codes_torch.models.large import LargeSCDecoder, LargeSCLDecoder
    from polar_codes_torch.models.scan import ScanDecoder
    from polar_codes_torch.models.scl import SCLDecoder
    from polar_codes_torch.utils.timing import time_cuda

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED14)
    rng = np.random.default_rng(SEED14)
    modem = Bpsk()
    frozen_of, encoders = {}, {}

    def channel(n_len, k_len, crc, n_blocks):
        """(info bytes with their checksum, as encode_vector wrote them back;
        float32 LLRs [n_blocks, n_len]) through the facade's encoder, BPSK
        and AWGN at EBN0_DB on the card."""
        if n_len not in frozen_of:
            frozen_of[n_len] = pypolar.frozen_bits(n_len, k_len, 0.0)
        if (n_len, crc) not in encoders:
            enc = pypolar.PolarEncoder(n_len, frozen_of[n_len], device=DEVICE)
            enc.setErrorDetection(crc)
            encoders[n_len, crc] = enc
        info = rng.integers(0, 256, (n_blocks, k_len // 8), dtype=np.uint8)
        code = encoders[n_len, crc].encode_vector(info)
        bits = torch.from_numpy(np.unpackbits(code, axis=-1)).to(dev)
        chan = Awgn()
        chan.set_esn0_linear(10.0 ** (EBN0_DB / 10.0) * k_len / n_len)
        llr = modem.demodulate(chan.transmit(modem.modulate(bits), gen))
        return info, llr.cpu().numpy()

    def direct_model(n_len, list_size, kind, crc):
        """The port's model that the facade's route must equal."""
        f, det = frozen_of[n_len], make_detector(crc)
        dtype = torch.int8 if kind == "char" else torch.float32
        kw = dict(detector=det, device=dev)
        if n_len > pypolar._LARGE_N_THRESHOLD:
            if list_size == 1:
                return LargeSCDecoder(n_len, f, dtype=dtype, **kw)
            return LargeSCLDecoder(n_len, f, list_size=list_size, dtype=dtype, **kw)
        if list_size == 1:
            return FastSSCDecoder(n_len, f, dtype=dtype, **kw)
        if kind == "scan":
            return ScanDecoder(n_len, f, iterations=list_size, **kw)
        if kind == "mixed":
            return AdaptiveDecoder(n_len, f, list_size=list_size, **kw)
        return SCLDecoder(n_len, f, list_size=list_size, dtype=dtype, **kw)

    def facade_input(llr, kind):
        if kind == "char":
            return np.clip(np.round(llr), -127, 127).astype(np.int8)
        return llr

    def held(route, got, direct, x):
        """The facade's packed bytes equal the direct model's decode."""
        info, _, _ = direct.decode(torch.from_numpy(x).to(dev))
        want = np.packbits(info.cpu().numpy(), axis=-1)
        if got.shape != want.shape or not np.array_equal(got, want):
            bad = int((got != want).reshape(got.shape[0], -1).any(-1).sum()) \
                if got.shape == want.shape else "all"
            raise AssertionError(f"facade route {route}: packed bytes differ from the direct "
                                 f"model's on {bad} blocks")

    def launched(route, counts):
        need = [k for k in KERNELS14[route] if not counts.get(k)]
        if need:
            raise AssertionError(f"facade route {route}: {need} never launched: {counts}")
        return counts

    routes, outcomes = {}, {}

    # 47 ------------------------------------------------------------------
    phase(f"47 pypolar facade on the card: ({N_LEN}, {K_LEN}) \"float\" L = {LIST} CRC16, "
          f"{BATCHES14} x {B14} blocks at {EBN0_DB} dB, and every other route against the "
          f"port's model called directly")
    dec = pypolar.PolarDecoder(N_LEN, LIST, pypolar.frozen_bits(N_LEN, K_LEN, 0.0), "float",
                               device=DEVICE)
    dec.setErrorDetection(16)
    check16 = pypolar.Detector(16)
    wrong = failed_check = 0
    main_in = direct = None
    for i in range(BATCHES14):
        _reset_all_counts()
        sent, llr = channel(N_LEN, K_LEN, 16, B14)
        enc_counts = launched("encode", _all_counts())
        _reset_all_counts()
        out = dec.decode_vector(llr)
        counts = launched("float_l8", _all_counts())
        if i == 0:
            routes["encode"], routes["float_l8"] = enc_counts, counts
            main_in = (sent, llr)
            direct = direct_model(N_LEN, LIST, "float", 16)
        if out.shape != (B14, K_LEN // 8) or out.dtype != np.uint8:
            raise AssertionError(f"facade main path: output {out.shape} {out.dtype}")
        held("float_l8", out, direct, llr)
        bad = (out != sent).any(axis=1)
        wrong += int(bad.sum())
        for blk in np.flatnonzero(~bad):
            if not check16.check(out[blk]):
                raise AssertionError(f"Detector(16).check fails on correct block {blk}")
        failed_check += sum(not check16.check(out[blk]) for blk in np.flatnonzero(bad))
    bler = wrong / (BATCHES14 * B14)
    outcomes["float_l8"] = {"blocks": BATCHES14 * B14, "block_errors": wrong, "bler": bler,
                            "crc_failures_among_errors": int(failed_check)}
    emit({"path": "pypolar_float_l8", "n": N_LEN, "list_size": LIST, "ebn0_db": EBN0_DB,
          **outcomes["float_l8"], "launches": routes["float_l8"],
          "encode_launches": routes["encode"], "card": card})
    if not 1e-4 <= bler <= 5e-2:
        raise AssertionError(f"facade main path BLER {bler} outside [1e-4, 5e-2]")
    sent, llr = main_in
    one = sent[0].copy()
    code_one = encoders[N_LEN, 16].encode_vector(one)
    if not np.array_equal(one, sent[0]):
        raise AssertionError("encode_vector of one vector changed a block that held its CRC")
    direct_enc = PolarEncoder(N_LEN, frozen_of[N_LEN], detector=make_detector(16), device=dev)
    want_code = direct_enc.encode(torch.from_numpy(np.unpackbits(one)).to(dev))
    if not np.array_equal(code_one, np.packbits(want_code.cpu().numpy())):
        raise AssertionError("encode_vector of one vector differs from PolarEncoder.encode")
    _reset_all_counts()
    got_one = dec.decode_vector(llr[0])
    routes["float_l8_one_vector"] = launched("float_l8_one_vector", _all_counts())
    if not np.array_equal(got_one, dec.decode_vector(llr[:1])[0]):
        raise AssertionError("decode_vector of one vector differs from its batch of one")
    held("float_l8_one_vector", got_one[None], direct, llr[:1])

    for route, n_len, k_len, list_size, kind, crc, n_blocks in ROUTES14:
        sent, llr = channel(n_len, k_len, crc, n_blocks)
        rdec = pypolar.PolarDecoder(n_len, list_size, frozen_of[n_len], kind, device=DEVICE)
        rdec.setErrorDetection(crc)
        _reset_all_counts()
        t0 = time.perf_counter()
        out = rdec.decode_vector(llr)
        wall = time.perf_counter() - t0
        routes[route] = launched(route, _all_counts())
        held(route, out, direct_model(n_len, list_size, kind, crc), facade_input(llr, kind))
        errors = int((out != sent).any(axis=1).sum())
        outcomes[route] = {"decoder": type(rdec._dec).__name__, "blocks": n_blocks,
                           "block_errors": errors, "first_call_s": wall}
        emit({"path": f"pypolar_{route}", "n": n_len, "list_size": list_size, "type": kind,
              "crc": crc, "ebn0_db": EBN0_DB, **outcomes[route], "launches": routes[route],
              "card": card})

    f_p = pypolar.frozen_bits(N_LEN, K_LEN, 0.0)
    punct = pypolar.Puncturer(1000, f_p)
    full = rng.standard_normal((B14, N_LEN)).astype(np.float32)
    short = punct.puncture(full)
    back = punct.depuncture(short)
    keep = np.asarray(punct.blockOutputPositions())
    dropped = np.setdiff1d(np.arange(N_LEN), keep)
    packed = rng.integers(0, 256, (B14, N_LEN // 8), dtype=np.uint8)
    short_p = punct.puncturePacked(packed)
    if (punct.blockLength(), punct.parentBlockLength(), short.shape, short_p.shape) != \
            (1000, N_LEN, (B14, 1000), (B14, 125)) \
            or not np.array_equal(back[:, keep], full[:, keep]) or back[:, dropped].any() \
            or not np.array_equal(punct.puncturePacked(punct.depuncturePacked(short_p)), short_p) \
            or not np.array_equal(np.unpackbits(short_p, axis=-1),
                                  np.unpackbits(packed, axis=-1)[:, keep]):
        raise AssertionError("Puncturer(1000) round trip failed")
    print(f"facade: {len(routes)} routes equal to the direct models; main path BLER {bler} "
          f"({wrong} of {BATCHES14 * B14}); Puncturer(1000) round trips, packed and unpacked")

    # 48 ------------------------------------------------------------------
    phase(f"48 times: the facade's duration_ns on the main path (median of {FACADE_REPS}) "
          "beside the direct call's CUDA-event time")
    sent, llr = main_in
    x = torch.from_numpy(llr).to(dev)

    def facade_ms(call, duration):
        for _ in range(3):
            call()
        samples = []
        for _ in range(FACADE_REPS):
            call()
            samples.append(duration() / 1e6)
        return statistics.median(samples), samples

    dec_ms, dec_samples = facade_ms(lambda: dec.decode_vector(llr), dec.duration_ns)
    direct_ms = time_cuda(lambda: direct.decode(x), reps=FACADE_REPS)

    def direct_wall():
        t0 = time.perf_counter()
        direct.decode(x)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    direct_wall()
    direct_wall_ms = statistics.median(direct_wall() * 1e3 for _ in range(FACADE_REPS))
    # the profiler's device time over the facade's own unprofiled duration_ns;
    # the wall under the profiler holds the profiler's cost too
    wall, busy = busy_share(lambda: dec.decode_vector(llr))
    enc = encoders[N_LEN, 16]
    enc_ms, _ = facade_ms(lambda: enc.encode_vector(sent.copy()), enc.duration_ns)
    u = torch.from_numpy(np.unpackbits(sent, axis=-1)).to(dev)
    # the checksum and K2, the device work that encode_vector does
    direct_enc_ms = time_cuda(lambda: direct_enc.encode(u, generate_crc=True), reps=FACADE_REPS)
    times = {"batch": B14, "decode_facade_ms": dec_ms, "decode_facade_samples_ms": dec_samples,
             "decode_direct_cuda_event_ms": direct_ms,
             "decode_direct_synced_wall_ms": direct_wall_ms,
             "decode_host_cost_ms": dec_ms - direct_ms,
             "decode_facade_device_busy_ms": busy,
             "decode_facade_busy_share": busy / dec_ms,
             "decode_facade_profiled_wall_ms": wall,
             "decode_facade_busy_share_under_profiler": busy / wall,
             "encode_facade_ms": enc_ms, "encode_direct_cuda_event_ms": direct_enc_ms,
             "encode_host_cost_ms": enc_ms - direct_enc_ms}
    emit({"metric": "pypolar_facade_times", "path": f"({N_LEN}, {K_LEN}) float L = {LIST} "
          "CRC16", **times, "card": card})
    print(f"facade decode {dec_ms:.3f} ms (duration_ns) vs direct {direct_ms:.3f} ms (CUDA "
          f"events) at B = {B14} on {card}; encode {enc_ms:.3f} vs {direct_enc_ms:.3f} ms")

    by_kernel = {}
    for route, counts in routes.items():
        for name, count in counts.items():
            by_kernel.setdefault(name, {})[f"pypolar_{route}"] = count
    return {"routes": routes, "outcomes": outcomes, "by_kernel": by_kernel, "times": times}


# ---- slice 15: the benchmark grid, device timing and the roofline --------

# the full grid's rows of each kind that the quick grid lacks; with it they
# launch K1-K7 (cascl_scan_float_n32768_l8 also names its bf16-carry row)
GRID_FILTERS = ("adaptive_float_n1024_l8", "depthfirst_n1024_t8", "fastsscan_n1024_i4",
                "sc_scan_float_n32768", "cascl_scan_float_n32768_l8")
GRID_BATCH_BITS = 1 << 21  # the CLI's default: ~2 Mbit of code a timed call
GRID_KERNELS = ("butterfly_encode", "scl_subtree[float32]", "scl_subtree[char]",
                "fastssc_subtree[float32]", "fastssc_subtree[int8]", "scan_fused",
                "scan_step", "masked_sc_chunk[float32]", "masked_scl_chunk[float32]")


def run_slice15(card):
    """Phases 49-50: the port's benchmark grid (python -m
    polar_codes_torch.sim.benchmark) on the card through its main(), its
    resume, and time_device_fn and roofline on the main path. Returns
    {"rows": the grid's records, "launches": the grid's launches by kernel,
    "times": phase 50's numbers}."""
    import shutil
    import tempfile

    import torch

    from polar_codes_torch.construction import frozen_bits
    from polar_codes_torch.dsp import Awgn, Bpsk
    from polar_codes_torch.models.detectors import CRC16
    from polar_codes_torch.models.encoder import PolarEncoder
    from polar_codes_torch.models.scl import SCLDecoder
    from polar_codes_torch.sim import benchmark
    from polar_codes_torch.utils.profiling import roofline
    from polar_codes_torch.utils.timing import time_cuda, time_device_fn

    # 49 ------------------------------------------------------------------
    phase(f"49 the benchmark grid on the card: --quick, then {', '.join(GRID_FILTERS)}; "
          "then the same commands again (the resume)")
    tmp = tempfile.mkdtemp(prefix="polar_bench_")
    out = os.path.join(tmp, "grid.jsonl")
    commands = [["--quick"]] + [["--filter", f] for f in GRID_FILTERS]
    commands = [argv + ["-o", out, "--batch-bits", str(GRID_BATCH_BITS)] for argv in commands]
    t0 = time.perf_counter()
    try:
        _reset_all_counts()
        for i, argv in enumerate(commands):
            if benchmark.main(argv + (["--fresh"] if i == 0 else [])) != 0:
                raise AssertionError(f"sim.benchmark.main({argv}) returned non-zero")
        launches = _all_counts()
        grid_s = time.perf_counter() - t0
        with open(out) as fh:
            rows = [json.loads(line) for line in fh]
        for argv in commands:  # the resume: every row is in the file
            benchmark.main(argv)
        with open(out) as fh:
            again = sum(1 for _ in fh)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want = [r["bench"] for r in benchmark.enumerate_rows(True)] + [
        r["bench"] for f in GRID_FILTERS for r in benchmark.enumerate_rows(False)
        if f in r["bench"]]
    names = [r["bench"] for r in rows]
    if names != want:
        raise AssertionError(f"grid rows {names} != the commands' rows {want}")
    if any("error" in r for r in rows):
        raise AssertionError(f"grid rows failed: {[r for r in rows if 'error' in r]}")
    for r in rows:
        if not r.get("device_name") or r.get("power_limit_w") is None:
            raise AssertionError(f"{r['bench']}: no card name or power limit: {r}")
        for key in ("mfu", "hbm_util"):
            if key not in r or not 0.0 <= r[key] <= 1.0:
                raise AssertionError(f"{r['bench']}: {key} missing or outside [0, 1]: {r}")
    if again != len(rows):
        raise AssertionError(f"the resume ran {again - len(rows)} rows; it should run none")
    emit({"grid_rows": len(rows), "grid_s": grid_s, "launches": launches, "card": card})
    missing = [k for k in GRID_KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"the grid never launched {missing}: {launches}")
    print(f"grid: {len(rows)} rows, no error, {grid_s:.1f} s; the resume ran none")

    # 50 ------------------------------------------------------------------
    phase(f"50 time_device_fn against time_cuda and the roofline on the main path, "
          f"({N_LEN}, {K_LEN}) CA-SCL-{LIST} CRC16, B = {BATCH}")
    dev = torch.device(DEVICE)
    frozen = frozen_bits(N_LEN, K_LEN, 0.0, "BB")
    det = CRC16()
    enc = PolarEncoder(N_LEN, frozen, systematic=True, detector=det, device=dev)
    dec = SCLDecoder(N_LEN, frozen, list_size=LIST, systematic=True, detector=det,
                     device=dev)
    gen = torch.Generator(device=dev).manual_seed(20261029)
    info = torch.randint(0, 2, (BATCH, K_LEN), generator=gen, device=dev, dtype=torch.uint8)
    chan = Awgn()
    chan.set_esn0_linear(10.0 ** (EBN0_DB / 10.0) * K_LEN / N_LEN)
    modem = Bpsk()
    llr = modem.demodulate(chan.transmit(modem.modulate(enc.encode(info)), gen))
    times = {}
    for call, fn, x, model in (("decode", dec.decode, llr, dec),
                               ("encode", enc.encode, info, enc)):
        fn_ms = time_device_fn(fn, x, reps=REPS) * 1e3
        event_ms = time_cuda(lambda: fn(x), reps=REPS)
        roof = roofline(fn, x, seconds=fn_ms / 1e3, model=model, batch=BATCH)
        times[call] = {"time_device_fn_ms": fn_ms, "time_cuda_ms": event_ms, **roof}
        emit({"metric": f"{call}_roofline", "batch": BATCH, **times[call], "card": card})
        if fn_ms <= 0 or event_ms <= 0 or max(fn_ms, event_ms) > 2 * min(fn_ms, event_ms):
            raise AssertionError(f"{call}: time_device_fn {fn_ms} ms and time_cuda "
                                 f"{event_ms} ms are not both positive within 2x")
        if roof["cost_model"] != "analytic" or not 0.0 < roof["mfu"] <= 1.0 \
                or not 0.0 < roof["hbm_util"] <= 1.0:
            raise AssertionError(f"{call}: roofline {roof}")
    print(f"decode {times['decode']['time_device_fn_ms']:.3f} ms (time_device_fn) vs "
          f"{times['decode']['time_cuda_ms']:.3f} (time_cuda), mfu "
          f"{times['decode']['mfu']:.2e}, hbm_util {times['decode']['hbm_util']:.2e} on {card}")
    return {"rows": rows, "launches": launches, "times": times}


if __name__ == "__main__":
    main()
    sys.exit(0)
