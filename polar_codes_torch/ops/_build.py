"""Builds the CUDA sources under csrc/ into shared libraries, at first use.

Each `csrc/<name>.cu` has a plain C interface and is compiled on its own
by `nvcc` for sm_90a, into `build/lib<name>-<hash>.so` under the package;
the hash covers the source, the flags and the compiler path, so an edited
source is rebuilt and an unchanged one is reused. The library is loaded
with ctypes. Nothing here runs when the package is imported, so a machine
without nvcc can import and test the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

# --fmad=false keeps every a*b+c as two roundings, as in the plain torch
# versions, so kernel and plain results can be compared bit for bit.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)
KERNELS = ("butterfly_encode", "scl_subtree", "fastssc_subtree", "scan_sweep",
           "large_sc_chunk", "large_scl_chunk", "large_scl_lists", "scl_wide")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The nvcc to build with: $CUDA_HOME/bin, /usr/local/cuda/bin, $PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built at "
            "their first launch and need the CUDA toolkit"
        )
    return found


def library_path(name: str, nvcc: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + repr((NVCC_FLAGS, nvcc)).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}-{key}.so"


def build(names: Iterable[str] = KERNELS, verbose: bool = False) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, one nvcc process
    per source, all started together. Returns seconds per kernel built;
    raises with nvcc's output if any build fails. verbose adds
    `-Xptxas -v` (registers, shared memory, spills) and prints its report."""
    nvcc = nvcc_path()
    extra = ("-Xptxas", "-v") if verbose else ()  # a report, same binary
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name, nvcc)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out, time.perf_counter())
    logs, seconds = {}, {}

    def finish(name, proc, t0):  # each build's own seconds, whatever order they end in
        logs[name] = proc.communicate()[0]
        seconds[name] = time.perf_counter() - t0

    waits = [threading.Thread(target=finish, args=(name, proc, t0))
             for name, (proc, _, _, t0) in procs.items()]
    for wait in waits:
        wait.start()
    for wait in waits:
        wait.join()
    failed = []
    for name, (proc, tmp, out, _) in procs.items():
        log = logs[name]
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        if verbose and log:
            print(f"[{name}.cu]\n{log}", file=sys.stderr)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name, nvcc_path())))
        _LIBS[name] = lib
    return lib

