"""Builds a CUDA source under csrc/ for the CPU, so that the tests of a
machine without nvcc or a card can run a kernel's own code.

The source is rewritten as C++ for csrc/emu/cuda_on_cpu.h (each launch
`kernel<<<grid, block, smem, stream>>>(args)` becomes a call of
emu_launch, an `extern __shared__` array the block's dynamic buffer) and
compiled by g++ with FMA contraction off, as nvcc builds it, into
`build/emu-lib<name>-<hash>.so`, which keeps the source's C interface.
Every CUDA thread is a CPU thread, so it is slow: small shapes only. The
decoders never use it; the wrappers launch the nvcc build on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from typing import Dict

from ._build import BUILD, CSRC

HEADER = CSRC / "emu" / "cuda_on_cpu.h"
CXX_FLAGS = ("-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-shared", "-fPIC", "-w")

_LIBS: Dict[str, ctypes.CDLL] = {}


def translate(source: str) -> str:
    """A CUDA source as C++ for cuda_on_cpu.h."""
    text = re.sub(r"#include <(?:cuda_runtime|cuda_bf16|math_constants)\.h>\n", "", source)
    text = re.sub(r"extern __shared__ [^;]*?(\w+)\[\];", r"unsigned char* \1 = emu_smem();",
                  text)

    def launch(match):
        cfg = [c.strip() for c in match.group(2).split(",")]
        cfg += ["0", "nullptr"][len(cfg) - 2:]  # default shared memory and stream
        return f"emu_launch({', '.join(cfg)}, {match.group(1)}, "

    return re.sub(r"(\w+(?:<[^<>;]*>)?)<<<([^>]*)>>>\(", launch, text)


def load_on_cpu(name: str) -> ctypes.CDLL:
    """The CPU build of kernel `name` (csrc/<name>.cu), built first if
    needed. Raises RuntimeError without g++."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the CPU build of a kernel needs it")
    text = translate((CSRC / f"{name}.cu").read_text())
    key = hashlib.sha256((text + HEADER.read_text() + repr((CXX_FLAGS, cxx))).encode())
    out = BUILD / f"emu-lib{name}-{key.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        src = out.with_suffix(f".{os.getpid()}.cpp")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        src.write_text(text)
        try:
            run = subprocess.run([cxx, *CXX_FLAGS, "-include", str(HEADER), "-o", str(tmp),
                                  str(src)], capture_output=True, text=True)
            if run.returncode != 0:
                raise RuntimeError(f"g++ failed on {name}.cu:\n{run.stdout}{run.stderr}")
            os.replace(tmp, out)
        finally:
            src.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    return lib
